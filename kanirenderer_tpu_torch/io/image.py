"""Image helpers scene packing needs (counterpart of the numpy parts of
``kanirenderer_tpu/io/image.py``; file decoding is not ported yet)."""

from __future__ import annotations

import numpy as np


def default_normal_image(size: int = 4) -> np.ndarray:
    """Flat tangent-space normal map RGB (128, 128, 255), the fallback for
    every missing texture, diffuse included (reference
    src/resources.rs:51-61)."""
    img = np.zeros((size, size, 4), np.uint8)
    img[..., 0] = 128
    img[..., 1] = 128
    img[..., 2] = 255
    img[..., 3] = 255
    return img
