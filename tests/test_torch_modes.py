"""The port's DEBUG (both debug textures) and deferred frames against the
JAX package's render_frame run op by op, with the golden criterion, as
tests/test_torch_frame.py holds the other configurations."""

import pytest

from test_torch_frame import check_mode, scenes  # noqa: F401  (fixture)


@pytest.mark.parametrize("name", ["debug_depth", "debug_shadow",
                                  "deferred"])
def test_mode_matches_reference(scenes, monkeypatch, name):  # noqa: F811
    check_mode(scenes, monkeypatch, name)
