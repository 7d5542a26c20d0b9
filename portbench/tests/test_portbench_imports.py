"""What the benchmark's modules import, by the whole top-level name: no
JAX and no JAX package anywhere under portbench/, and nothing of the
program in the reference."""

import ast

import pytest

from portbench.tests.conftest import ROOT

JAX = {"jax", "jaxlib", "flax", "kanirenderer_tpu"}
SOURCES = sorted(p for p in ROOT.rglob("*.py") if "cache" not in p.parts)


def top_level_imports(path) -> set:
    tree = ast.parse(path.read_text(), str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    assert not top_level_imports(path) & JAX


@pytest.mark.parametrize("path", sorted((ROOT / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert "kanirenderer_tpu_torch" not in names
    assert names <= {"__future__", "dataclasses", "enum", "typing", "numpy",
                     "torch", "struct", "zlib", "portbench"}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module \
                and node.module.startswith("portbench"):
            assert node.module.startswith("portbench.reference")


def test_the_check_tells_the_port_from_the_jax_package():
    assert "kanirenderer_tpu_torch".split(".")[0] not in JAX
