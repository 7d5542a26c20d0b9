"""Instance animation helpers (counterpart of
``kanirenderer_tpu/models/animation.py``).

The reference ships a test-only animation path that random-walks instance
positions every frame and re-uploads the instance buffers (reference
src/lib.rs:1394-1689, src/model.rs:86-92).  Here it is a pure update of the
per-object transforms: a new (O, 4, 4) tensor for the next ``render_frame``.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def random_walk_objects(object_model: Tensor, generator: torch.Generator,
                        dt: float, speed: float = 100.0) -> Tensor:
    """Jitter every object's translation by a uniform random step: each
    axis moves by U(−1, 1) · speed · dt per call, as ``test_move_model_vec3``
    (reference src/model.rs:86-92).  The draws come from ``generator``,
    which must live on the device of ``object_model``; the same seed gives
    the same walk.  Returns the updated model matrices; the rotation block
    is untouched."""
    o = object_model.shape[0]
    step = (torch.rand((o, 3), generator=generator, dtype=torch.float32,
                       device=object_model.device) * 2.0 - 1.0) * speed * dt
    out = object_model.clone()
    out[:, :3, 3] += step
    return out
