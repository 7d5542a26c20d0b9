"""kanirenderer_tpu_torch — the renderer of ``kanirenderer_tpu`` on PyTorch
and CUDA.

The port loads OBJ/MTL scenes with their PNG and JPEG textures and
renders every mode of the JAX package's ``render_frame`` — UNLIT, LIT,
LIT_SHADOW (3×3 PCF; the shadow map fresh in every frame or kept while the
sun stands still), WIREFRAME, DEBUG, with HDR, the deferred path and
``present_scale`` — through hand-written CUDA kernels for Hopper (csrc/):
the depth-only shadow raster, the fused visibility raster + interpolation
with its wireframe variant, and the visibility-buffer raster.  Everything
else is plain PyTorch.  The JAX package stays the reference;
``core.types.from_reference`` carries its scenes and states across for the
tests.

Entry points: ``python -m kanirenderer_tpu_torch`` (``cli.main``),
``api.run`` and ``api.load_model_or_default``, ``runtime.loop.run_loop``,
``passes.frame.render_frame``, ``flythrough.fly`` and
``ops.raster_cuda.rasterize``.  They build on the CUDA device unless given
``device="cpu"`` (``--device cpu``).
"""

from kanirenderer_tpu_torch.core.types import (  # noqa: F401
    CHUNK_SIZE,
    CameraState,
    DebugTexture,
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
    spawn_point_lights,
)

__version__ = "0.1.0"
