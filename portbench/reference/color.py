"""Frozen copy of ``kanirenderer_tpu_torch/core/color.py`` (commit 1e399aa), the
benchmark's plain reference; only its imports were changed.

Colour transfer functions and tonemap operators (PyTorch counterpart of
``kanirenderer_tpu/core/color.py``)."""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def reinhard_tonemap(c: Tensor) -> Tensor:
    """``c / (c + 1)`` (reference src/shader.wgsl:120-123)."""
    return c / (c + 1.0)


def aces_tonemap(c: Tensor) -> Tensor:
    """ACES filmic approximation (reference src/shader_hdr.wgsl:254-265)."""
    a, b, cc, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((c * (a * c + b)) / (c * (cc * c + d) + e), 0.0, 1.0)


def srgb_to_linear(c: Tensor) -> Tensor:
    """IEC 61966-2-1 sRGB EOTF."""
    return torch.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(c: Tensor) -> Tensor:
    """Inverse sRGB transfer (presenting to an sRGB surface)."""
    c = torch.clamp(c, 0.0, 1.0)
    return torch.where(c <= 0.0031308, c * 12.92,
                       1.055 * c ** (1.0 / 2.4) - 0.055)
