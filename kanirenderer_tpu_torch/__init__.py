"""kanirenderer_tpu_torch — the renderer of ``kanirenderer_tpu`` on PyTorch
and CUDA.

The port renders the LIT_SHADOW frame (fresh 2048² shadow map, Blinn-Phong
with 3×3 PCF, sRGB surface) through two hand-written CUDA kernels for
Hopper (csrc/): the depth-only shadow raster and the fused visibility
raster + interpolation.  Everything else is plain PyTorch.  The JAX
package stays the reference; ``core.types.from_reference`` carries its
scenes and states across for the tests.

Entry points: ``passes.frame.render_frame`` and ``flythrough.fly``.
"""

from kanirenderer_tpu_torch.core.types import (  # noqa: F401
    CHUNK_SIZE,
    CameraState,
    DirectionalLight,
    FrameState,
    Lights,
    MovableLight,
    PointLights,
    RenderConfig,
    RenderMode,
    Scene,
    camera_state,
    default_camera,
    default_lights,
    frame_state,
    from_reference,
)

__version__ = "0.1.0"
