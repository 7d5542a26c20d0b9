"""render_band / render_frame — the frame pipeline of every render mode
(PyTorch counterpart of ``render_band``/``render_frame`` in
``kanirenderer_tpu/passes/frame.py``).

Per frame, as the reference renders it (src/lib.rs:1707-1914):

  1. vertex stage: corner-major where the scene carries corner planes,
     vertex-major otherwise;
  2. LIT_SHADOW and DEBUG: the shadow map.  Fresh by default: light-space
     triangle setup, binning, the K1 shadow raster
     (ops/raster_cuda.rasterize_depth).  The caller may instead hand in
     what does not depend on the camera and so survives from frame to
     frame: the light-space setup and bins (``shadow_geom``, the map is
     still rasterized), the map (``shadow_map``) or the PCF table built
     from it (``shadow_table``).  ``render_shadow_geometry`` and
     ``render_shadow_map`` produce them.  The other modes emit an all-ones
     map;
  3. camera triangle setup (no back-face culling in WIREFRAME), triangle
     records, binning;
  4. the fused raster + interpolation, K2 (ops/raster_cuda.rasterize_pixels)
     or its wireframe variant K2w;
  5. shading by mode: ``shade_unlit``, ``shade_wireframe``, ``shade_lit``
     (LIT without, LIT_SHADOW and DEBUG with the PCF table; Reinhard, or
     ACES with ``hdr``), or the deferred G-buffer path (``deferred``);
  6. clear-colour compose; DEBUG composites the depth/shadow quad and the
     frame-time graph; the surface encode (sRGB, or clamp for HDR), the
     ``present_scale`` box downscale and the ``output_u8`` store (u8 for
     LDR, float16 for HDR).

After a window resize the view is smaller than the raster: ``view_wh``
gives the view's width and height, which set the projection's aspect and
the extent the triangle setup clamps to, while the kernels keep the
``cfg.width × cfg.height`` grid and the caller crops (runtime/loop.py).

All work runs on the scene's device except the uniform math, which runs
on the host (``frame_uniforms_host``).  ``frame_uniforms`` reads the pose
back from the device for it; a caller that holds the pose on the host
computes the matrices itself and passes them as ``uniforms``.  That read
and the binning calls are the frame's own device-to-host synchronisations.
``linearize_depth`` (depth picking) lives with the overlays that share it.

Occlusion (``cfg.occ_scope``, ops/raster_cuda.occ_on): where a raster
takes the skip, its setup's ``depth_bound`` goes to the binning, whose
lists then come nearest first and carry the chunks' bounds to the kernel
(the light-space grid under the default scope "shadow", the main grid
too under "1"); every scope renders the same pixels.

Row bands (``render_band``; parallel/mesh.py drives it): a band is
``band_h`` screen rows from ``y0``, contiguous or, with ``band_stride`` n,
tile rows k, k + n, … (y0 = k·tile_h).  The body is split into stage
functions at its collectives: the geometry (``frame_geometry``) runs once
for the frame; a fresh shadow map is rasterized in ``shadow_bands`` row
bands (``shadow_band_map``, K1) and assembled, as its PCF table
(``shadow_table_band``) or as the map, by one collective
(``banded_shadow``); then each band's raster (``band_bins``,
``band_pixels``: K2/K2w), shade (``band_shade``) and surface
(``band_surface``).  The collectives are concatenations when this
process holds every band (``comm`` None) and ``comm.all_gather`` when it
holds one band of a group, so one process and n ranks run the same
functions.  A band's
pixels are the full frame's bit for bit: the kernels evaluate every plane
at the global pixel centre, the PCF table's rows come out the same from a
band and its halo, and the overlays mask in global rows.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from kanirenderer_tpu_torch.core import math3d
from kanirenderer_tpu_torch.core.color import linear_to_srgb
from kanirenderer_tpu_torch.core.types import (DebugTexture, FrameState,
                                               RenderConfig, RenderMode,
                                               Scene)
from kanirenderer_tpu_torch.ops import raster_cuda
from kanirenderer_tpu_torch.ops.binning import (ChunkBins, bin_tiles,
                                                depth_bound, interleave_bins)
from kanirenderer_tpu_torch.ops.interpolate import (PixelBuffer,
                                                    build_tri_records,
                                                    build_tri_records_corners)
from kanirenderer_tpu_torch.ops.sampling import (build_shadow_table,
                                                 build_shadow_table_band)
from kanirenderer_tpu_torch.ops.vertex import (CornerOutputs, TriangleSetup,
                                               VertexOutputs,
                                               run_vertex_stage,
                                               run_vertex_stage_corners,
                                               triangle_setup,
                                               triangle_setup_corners)
from kanirenderer_tpu_torch.passes import overlay
from kanirenderer_tpu_torch.passes.overlay import linearize_depth  # noqa: F401
from kanirenderer_tpu_torch.shade import deferred, forward

Tensor = torch.Tensor

SHADOW_MODES = (RenderMode.LIT_SHADOW, RenderMode.DEBUG)


class FrameOutputs(NamedTuple):
    image: Tensor   # (H/p, W/p, 3) encoded: f32, or u8 / f16 (output_u8)
    depth: Tensor   # (H, W) f32 scene depth
    shadow: Tensor  # (shadow_dim, shadow_dim) f32 map of this frame: all
    #   ones without a pass, zeros when ``use_cached_shadow`` reused the
    #   caller's; (1, 1) zeros when the caller supplied the map or table
    raster_overflow: Tensor  # () i32 chunks dropped by the frame's binnings


class ShadowGeometry(NamedTuple):
    """The light-space triangle setup and its bins: what K1 reads.  It
    depends on the sun and the geometry, not on the camera."""

    setup: TriangleSetup
    bins: ChunkBins


class Geometry(NamedTuple):
    """Per-frame geometry: the kernels' inputs and the light transform.
    The shadow fields are None where the frame builds no light-space
    setup."""

    light_vp: Tensor
    vout: CornerOutputs | VertexOutputs
    shadow_setup: TriangleSetup | None
    shadow_bins: ChunkBins | None
    setup: TriangleSetup
    records: Tensor      # (T, 76) triangle records
    bins: ChunkBins | None  # the main grid's; None where no stage reads them
    occ_bound: Tensor | None = None  # (T,) the main grid's depth_bound
    #   where its rasters take the occlusion skip


def frame_uniforms_host(position, yaw, pitch, sun_direction, sun_distance,
                        shadow_scene_size, cfg: RenderConfig,
                        aspect: float | None = None) -> Tensor:
    """(2, 4, 4) [view_proj, light_vp] on the CPU from host values: the
    per-frame uniform math (≈ State::update, src/lib.rs:1382-1704),
    computed on the host as the reference computes its uniforms.  Every
    device then rasterizes from the same matrix bits: computed on the card,
    trigonometry and the 4×4 products round differently in the last place,
    which flips the winner of near-coplanar surfaces."""
    def f32(x):
        return torch.from_numpy(np.array(x, dtype=np.float32))

    fovy = torch.deg2rad(torch.tensor(cfg.fovy_deg, dtype=torch.float32))
    proj = math3d.perspective(fovy, cfg.aspect if aspect is None else aspect,
                              cfg.znear, cfg.zfar)
    view_proj = proj @ math3d.camera_view_matrix(f32(position), f32(yaw),
                                                 f32(pitch))
    light_vp = math3d.directional_light_view_projection(
        f32(sun_direction), f32(sun_distance), f32(shadow_scene_size))
    return torch.stack([view_proj, light_vp])


def frame_uniforms(state: FrameState, cfg: RenderConfig,
                   device: torch.device,
                   aspect: float | None = None) -> tuple[Tensor, Tensor]:
    """(view_proj, light_vp) on ``device`` from a state on any device: one
    copy of the camera pose and the sun to the host,
    ``frame_uniforms_host``, one copy back."""
    cam, sun = state.camera, state.lights.directional
    host = torch.cat([t.reshape(-1) for t in (
        cam.position, cam.yaw, cam.pitch, sun.direction, sun.distance,
        sun.shadow_scene_size)]).cpu().numpy()
    both = frame_uniforms_host(host[0:3], host[3], host[4], host[5:8],
                               host[8], host[9], cfg, aspect).to(device)
    return both[0], both[1]


def view_extent(cfg: RenderConfig, view_wh):
    """(view width, view height, aspect): the raster's own, or the
    caller's smaller view with its aspect as a float32 quotient."""
    if view_wh is None:
        return cfg.width, cfg.height, None
    vw, vh = float(view_wh[0]), float(view_wh[1])
    return vw, vh, float(np.float32(vw) / np.float32(vh))


def _vertex_stage(scene: Scene, state: FrameState, view_proj: Tensor,
                  light_vp: Tensor):
    stage = run_vertex_stage_corners if scene.corner_pos.shape[0] > 0 \
        else run_vertex_stage
    return stage(scene, state.object_model, state.object_normal, view_proj,
                 light_vp)


def _setup(scene: Scene, clip: Tensor, width, height, cull_backfaces: bool,
           bias_constant: float = 0.0, bias_slope: float = 0.0):
    """(TriangleSetup, planes) from either form of clip coordinates."""
    if clip.dim() == 3:     # corner-major (3, 4, T)
        return triangle_setup_corners(clip, scene.tri_valid, width, height,
                                      cull_backfaces, bias_constant,
                                      bias_slope)
    return triangle_setup(clip, scene.tri_idx, scene.tri_valid, width,
                          height, cull_backfaces, bias_constant, bias_slope)


def _occ_bound(st: TriangleSetup, cfg: RenderConfig, tile_h: int,
               depth_only: bool) -> Tensor | None:
    """The setup's depth_bound where the scope turns the skip on for this
    raster, else None."""
    if not raster_cuda.occ_on(cfg.occ_scope, depth_only):
        return None
    return depth_bound(st.setup, st.bbox, cfg.tile_w, tile_h)


def _shadow_geometry(scene: Scene, light_clip: Tensor,
                     cfg: RenderConfig) -> ShadowGeometry:
    D = cfg.shadow_dim
    st, _ = _setup(scene, light_clip, D, D, False, cfg.shadow_bias_constant,
                   cfg.shadow_bias_slope)
    bound = _occ_bound(st, cfg, cfg.shadow_tile_h, depth_only=True)
    return ShadowGeometry(st, bin_tiles(st.bbox, D, D, cfg.tile_w,
                                        cfg.shadow_tile_h,
                                        cfg.shadow_chunks_per_tile,
                                        occ_bound=bound))


def render_shadow_geometry(scene: Scene, state: FrameState,
                           config: RenderConfig,
                           light_vp: Tensor | None = None) -> ShadowGeometry:
    """The light-space setup and bins of the shadow pass, for
    ``render_frame(shadow_geom=·)``: the map is still rasterized in every
    frame, but the light vertex transform, setup and binning drop out.

    It takes the path the frame itself takes for this scene (corner-major
    where the scene has corner planes), through the same functions, so the
    rows are the frame's own bit for bit.  ``light_vp``: the light's
    view-projection on the scene's device, where the caller has it;
    otherwise it is computed from ``state``."""
    if light_vp is None:
        light_vp = frame_uniforms(state, config, scene.device)[1]
    eye = torch.eye(4, dtype=torch.float32, device=scene.device)
    vout = _vertex_stage(scene, state, eye, light_vp)
    return _shadow_geometry(scene, vout.light_clip, config)


def render_shadow_map(scene: Scene, state: FrameState, config: RenderConfig,
                      light_vp: Tensor | None = None) -> Tensor:
    """Standalone shadow-map pass (reference src/lib.rs:1721-1751), so that
    a host loop can keep the map while the sun and the geometry stand
    still: the camera does not affect it.  The map equals the one a fresh
    frame of the same state rasterizes, bit for bit."""
    geom = render_shadow_geometry(scene, state, config, light_vp)
    return raster_cuda.rasterize_depth(geom.setup.setup, geom.setup.bbox,
                                       geom.bins, config.shadow_dim)


def frame_geometry(scene: Scene, state: FrameState, cfg: RenderConfig,
                   view_wh=None, uniforms=None,
                   light_space: bool | None = None,
                   main_bins: bool = True) -> Geometry:
    """Stages 1-3 without the rasters: uniforms, vertex stage, the setups
    and bins.  ``light_space``: whether to build the light-space setup and
    bins; by default where the mode has a shadow pass.  ``main_bins``:
    whether to bin the whole main grid (contiguous row bands bin their
    own)."""
    vw, vh, aspect = view_extent(cfg, view_wh)
    view_proj, light_vp = uniforms if uniforms is not None \
        else frame_uniforms(state, cfg, scene.device, aspect)
    vout = _vertex_stage(scene, state, view_proj, light_vp)
    if light_space is None:
        light_space = cfg.mode in SHADOW_MODES
    sh = _shadow_geometry(scene, vout.light_clip, cfg) if light_space \
        else ShadowGeometry(None, None)
    st, planes = _setup(scene, vout.clip, vw, vh,
                        cull_backfaces=cfg.mode != RenderMode.WIREFRAME)
    if isinstance(vout, CornerOutputs):
        records = build_tri_records_corners(vout.varyings, planes,
                                            scene.tri_extra)
    else:
        records = build_tri_records(
            scene.tri_idx, scene.tri_mat, vout.varyings, scene.mat_blk_base,
            scene.mat_blk_w, scene.mat_tex_size, setup=st.setup,
            extra=scene.tri_extra)
    bound = _occ_bound(st, cfg, cfg.tile_h, depth_only=False)
    bins = bin_tiles(st.bbox, cfg.width, cfg.height, cfg.tile_w, cfg.tile_h,
                     cfg.max_chunks_per_tile, occ_bound=bound) \
        if main_bins else None
    return Geometry(light_vp=light_vp, vout=vout, shadow_setup=sh.setup,
                    shadow_bins=sh.bins, setup=st, records=records,
                    bins=bins, occ_bound=bound)


def _shade(scene: Scene, state: FrameState, cfg: RenderConfig,
           pix: PixelBuffer, table: Tensor | None, light_vp: Tensor) -> Tensor:
    """(3, H, W) linear colour of the mode (JAX render_band :391-422);
    ``table`` is the PCF table of the shadow modes, None in the others."""
    mode, D = cfg.mode, cfg.shadow_dim
    cam_pos = state.camera.position
    if mode == RenderMode.UNLIT:
        return forward.shade_unlit(scene, pix)
    if mode == RenderMode.WIREFRAME:
        return forward.shade_wireframe(pix)
    if cfg.deferred:
        gbuf = deferred.write_gbuffer(scene, pix, cam_pos, light_vp)
        return deferred.deferred_lighting(gbuf, state.lights, table, cfg.hdr,
                                          D)
    return forward.shade_lit(scene, pix, state.lights, table, cfg.hdr, D,
                             camera_pos=cam_pos, light_vp=light_vp)


def band_shade(scene: Scene, state: FrameState, cfg: RenderConfig,
               pix: PixelBuffer, table: Tensor | None,
               light_vp: Tensor) -> Tensor:
    """The shade stage of a band: the mode's colour (``_shade``) where a
    triangle covers, the clear colour elsewhere; (3, rows, W) linear."""
    clear = torch.tensor(cfg.clear_color, dtype=torch.float32,
                         device=pix.z.device)[:, None, None]
    return torch.where(pix.mask[None],
                       _shade(scene, state, cfg, pix, table, light_vp), clear)


def band_surface(image: Tensor, state: FrameState, cfg: RenderConfig,
                 depth: Tensor, shadow_map: Tensor, row0: int = 0) -> Tensor:
    """The surface stage of a band: planar (3, H, W) linear image → the
    (H/p, W/p, 3) surface (JAX render_band :427-488): sRGB encode for the
    LDR surface, clamp for the HDR one; DEBUG overlays composite before
    the encode, as the reference's overlay pipelines draw linear colours
    onto the surface, at global rows from ``row0`` (the first row of a
    contiguous band)."""
    p = cfg.present_scale

    def encode(img):
        return torch.clamp(img, 0.0, 1.0) if cfg.hdr else linear_to_srgb(img)

    def downscale(img):  # channel-last box average by p
        if p <= 1:
            return img
        H, W = img.shape[0] // p * p, img.shape[1] // p * p
        return img[:H, :W].reshape(H // p, p, W // p, p, 3).mean((1, 3))

    def quantize(img):  # Rgba8 (== runtime/display.to_uint8) or Rgba16Float
        if not cfg.output_u8:
            return img
        if cfg.hdr:
            return img.to(torch.float16)
        return torch.clamp(img * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)

    if cfg.mode == RenderMode.DEBUG:
        image = image.permute(1, 2, 0)
        tex = shadow_map if cfg.debug_texture == DebugTexture.SHADOW_MAP \
            else depth
        image = overlay.debug_texture_quad_band(image, row0, cfg.height, tex,
                                                cfg.znear, cfg.zfar)
        image = overlay.frame_time_graph_band(image, row0, cfg.height,
                                              state.frame_times_ms)
        return quantize(downscale(encode(image))).contiguous()
    # Encode while planar, elementwise, so it commutes with the transpose.
    image = encode(image).permute(1, 2, 0)
    return quantize(downscale(image)).contiguous()


def band_bins(g: Geometry, cfg: RenderConfig, y0: int, band_h: int,
              band_stride: int = 1) -> ChunkBins:
    """The main-grid bins of a row band: the band's own grid for a
    contiguous band, its tile rows of the full grid's ``g.bins`` for an
    interleaved one, ``g.bins`` for the whole frame."""
    if (y0, band_h, band_stride) == (0, cfg.height, 1) and g.bins is not None:
        return g.bins
    if band_stride > 1:
        return interleave_bins(g.bins, y0 // cfg.tile_h, band_stride)
    return bin_tiles(g.setup.bbox, cfg.width, band_h, cfg.tile_w, cfg.tile_h,
                     cfg.max_chunks_per_tile, y0=y0, occ_bound=g.occ_bound)


def band_pixels(g: Geometry, cfg: RenderConfig, bins: ChunkBins, y0: int,
                band_h: int, band_stride: int = 1) -> PixelBuffer:
    """The raster stage of a band after its binning (``band_bins``): K2,
    or K2w in WIREFRAME, on the band's rows."""
    return raster_cuda.rasterize_pixels(
        g.records, g.setup.setup, g.setup.bbox, bins, cfg.width, cfg.height,
        wireframe=cfg.mode == RenderMode.WIREFRAME,
        wire_thresh=cfg.wire_thresh_px, y0=y0, y_stride=band_stride,
        band_h=band_h)


def _gather(parts: list, comm) -> Tensor:
    """The bands' tensors of every band, concatenated in band order: the
    local ones, or one per rank through ``comm``."""
    return torch.cat(parts) if comm is None else comm.all_gather(parts[0])


def shadow_band_runs(sh: ShadowGeometry, cfg: RenderConfig, ks,
                     bands: int) -> list:
    """For each map band k of ``ks`` (of ``bands`` row bands), its run of
    the full map's bin entries (``raster_cuda.band_entries``; one
    read-back for all)."""
    D = cfg.shadow_dim
    if D % bands:
        raise ValueError(f"{bands} shadow bands do not divide {D} rows")
    sb_h = D // bands
    return raster_cuda.band_entries(sh.bins, [(k * sb_h, sb_h) for k in ks])


def shadow_band_map(sh: ShadowGeometry, cfg: RenderConfig, k: int,
                    bands: int, run: tuple) -> Tensor:
    """The shadow stage of map band k of ``bands``: K1 on its run of the
    full map's bins → its (D / bands, D) rows of the map."""
    D = cfg.shadow_dim
    sb_h = D // bands
    return raster_cuda.rasterize_depth(sh.setup.setup, sh.setup.bbox,
                                       sh.bins, D, k * sb_h, sb_h, run)


def band_edges(part: Tensor) -> Tensor:
    """A map band's first two and last row, (3, D): what its neighbours'
    halos take."""
    return torch.cat([part[:2], part[-1:]])


def shadow_table_band(part: Tensor, edges: Tensor, k: int,
                      bands: int) -> Tensor:
    """The table stage of map band k: its PCF table rows from the band and
    a halo of one map row above and two below, taken from ``edges`` (every
    band's ``band_edges``, (bands, 3, D)); the first and last band clamp
    to their own rows (JAX render_band :310-342)."""
    D = part.shape[1]
    top1 = edges[k - 1, 2:] if k > 0 else part[:1]
    bot2 = edges[k + 1, :2] if k < bands - 1 else part[-1:].expand(2, D)
    return build_shadow_table_band(part, top1, bot2, D)


def banded_shadow(sh: ShadowGeometry, cfg: RenderConfig, bands: int,
                  comm=None) -> tuple:
    """A fresh shadow pass in ``bands`` row bands of the map
    (``shadow_band_map``) → (map, None), or for LIT_SHADOW with bands of
    whole 8-row blocks (None, PCF table) (``shadow_table_band``), each
    assembled by one collective."""
    ks = range(bands) if comm is None else [comm.rank]
    runs = shadow_band_runs(sh, cfg, ks, bands)
    parts = [shadow_band_map(sh, cfg, k, bands, run)
             for k, run in zip(ks, runs)]
    if cfg.mode != RenderMode.LIT_SHADOW or (cfg.shadow_dim // bands) % 8:
        return _gather(parts, comm), None
    edges = _gather([band_edges(p) for p in parts], comm).reshape(
        bands, 3, cfg.shadow_dim)
    return None, _gather([shadow_table_band(p, edges, k, bands)
                          for k, p in zip(ks, parts)], comm)


def render_band(scene: Scene, state: FrameState, config: RenderConfig,
                shadow_map: Tensor | None = None,
                use_cached_shadow: bool | None = None, *,
                shadow_table: Tensor | None = None,
                shadow_geom: ShadowGeometry | None = None,
                view_wh=None, uniforms=None, band_h: int | None = None,
                y0=0, band_stride: int = 1, shadow_bands: int = 1,
                comm=None) -> FrameOutputs:
    """Render one frame of ``config.mode``, or row bands of it.

    The shadow map of LIT_SHADOW and DEBUG is rasterized in the frame
    unless the caller supplies it: ``shadow_map`` (from
    ``render_shadow_map``), or for LIT_SHADOW ``shadow_table``
    (``build_shadow_table`` of it), which also spares the table's rebuild.
    ``use_cached_shadow`` (with ``shadow_map``) chooses per call: True
    reuses the given map, False rasterizes a fresh one and emits it.
    ``shadow_geom`` (from ``render_shadow_geometry``) feeds the fresh
    raster its cached inputs.  ``view_wh``: the (width, height) of a view
    smaller than the raster.  ``uniforms``: (view_proj, light_vp) on the
    scene's device, computed by the caller with ``frame_uniforms_host``
    for this state and view; without them the frame reads the pose back
    from the device.

    Row bands (JAX render_band :185-498): ``band_h`` rows from each first
    row in ``y0`` (an int or a sequence, one per band this call renders),
    interleaved tile rows with ``band_stride`` > 1.  A fresh map is
    rasterized in ``shadow_bands`` bands and assembled (``banded_shadow``).
    ``comm``: None when this call renders every band (the collectives are
    concatenations), else an object with ``rank``, ``size`` and
    ``all_gather(t)`` (``t`` of every rank concatenated along dim 0, rank
    order; parallel/mesh.Collectives) for a call that renders band
    ``comm.rank`` of ``comm.size``.  image and depth hold the bands'
    rows, band after band; DEBUG's depth quad shows the depth of every
    band (gathered).  The reference's rules hold: no DEBUG in interleaved
    bands, ``shadow_geom`` only for a whole map, and the table path only
    for LIT_SHADOW bands of whole 8-row blocks; ``view_wh`` and bands
    exclude each other.  ``raster_overflow`` sums the bands' binnings and,
    once (band 0 or rank 0), the shadow binning's."""
    cfg = config
    if cfg.present_scale < 1:
        raise ValueError("present_scale must be at least 1")
    mode, D, dev = cfg.mode, cfg.shadow_dim, scene.device
    banded = band_h is not None
    band_h = cfg.height if band_h is None else band_h
    y0s = [y0] if isinstance(y0, int) else list(y0)
    if banded:
        if band_stride > 1 and mode == RenderMode.DEBUG:
            raise ValueError("DEBUG overlays are contiguous-band only")
        if band_stride > 1 and (band_h % cfg.tile_h
                                or any(y % cfg.tile_h for y in y0s)):
            raise ValueError("interleaved bands take whole tile rows")
        if view_wh is not None:
            raise ValueError("view_wh is for whole frames only")
        unit = cfg.tile_h if band_stride > 1 else band_h
        if unit % cfg.present_scale:
            raise ValueError("present_scale must divide the band's rows")
    if shadow_geom is not None and shadow_bands > 1:
        raise ValueError("shadow_geom is full-map only")
    if comm is not None and (len(y0s) != 1
                             or shadow_bands not in (1, comm.size)):
        raise ValueError("a rank renders one band of comm.size")
    needs_shadow = mode in SHADOW_MODES
    if shadow_table is not None and (
            mode != RenderMode.LIT_SHADOW or shadow_map is not None
            or use_cached_shadow is not None):
        raise ValueError(
            "shadow_table is only valid for LIT_SHADOW without a raw map")
    if use_cached_shadow is not None and shadow_map is None:
        raise ValueError("use_cached_shadow requires a shadow_map")
    fresh = needs_shadow and shadow_table is None and (
        shadow_map is None or use_cached_shadow is False)

    g = frame_geometry(scene, state, cfg, view_wh, uniforms,
                       light_space=fresh and shadow_geom is None,
                       main_bins=not banded or band_stride > 1)
    overflow = torch.zeros((), dtype=torch.int32, device=dev)

    # shadow pass (src/lib.rs:1721-1751)
    small = torch.zeros((1, 1), dtype=torch.float32, device=dev)
    table = shadow_table
    if not needs_shadow:
        shadow_map = shadow_out = torch.ones((D, D), dtype=torch.float32,
                                             device=dev)
    elif fresh:
        sh = shadow_geom if shadow_geom is not None \
            else ShadowGeometry(g.shadow_setup, g.shadow_bins)
        if shadow_bands > 1:
            shadow_map, table = banded_shadow(sh, cfg, shadow_bands, comm)
            shadow_out = small if shadow_map is None else shadow_map
        else:
            shadow_map = shadow_out = raster_cuda.rasterize_depth(
                sh.setup.setup, sh.setup.bbox, sh.bins, D)
        if comm is None or comm.rank == 0:
            overflow = overflow + sh.bins.overflow
    elif use_cached_shadow:
        shadow_out = torch.zeros((D, D), dtype=torch.float32, device=dev)
    else:
        shadow_out = small   # the caller holds the map or table it gave
    if needs_shadow and table is None:
        table = build_shadow_table(shadow_map)

    # main raster + varying interpolation, band by band
    pixs = []
    for b0 in y0s:
        bins = band_bins(g, cfg, b0, band_h, band_stride)
        pixs.append(band_pixels(g, cfg, bins, b0, band_h, band_stride))
        overflow = overflow + bins.overflow

    depth_tex = None
    if banded and mode == RenderMode.DEBUG \
            and cfg.debug_texture == DebugTexture.SCENE_DEPTH:
        depth_tex = _gather([pix.z for pix in pixs], comm)
    images = [band_surface(
        band_shade(scene, state, cfg, pix, table, g.light_vp), state, cfg,
        pix.z if depth_tex is None else depth_tex, shadow_map, b0)
        for b0, pix in zip(y0s, pixs)]
    depth = [pix.z for pix in pixs]
    return FrameOutputs(
        image=images[0] if len(images) == 1 else torch.cat(images),
        depth=depth[0] if len(depth) == 1 else torch.cat(depth),
        shadow=shadow_out, raster_overflow=overflow)


def render_frame(scene: Scene, state: FrameState, config: RenderConfig,
                 shadow_map: Tensor | None = None,
                 use_cached_shadow: bool | None = None,
                 shadow_table: Tensor | None = None,
                 shadow_geom: ShadowGeometry | None = None,
                 view_wh=None, uniforms=None) -> FrameOutputs:
    """Render one whole frame: ``render_band`` with one band of every
    row (see there for the arguments)."""
    return render_band(scene, state, config, shadow_map, use_cached_shadow,
                       shadow_table=shadow_table, shadow_geom=shadow_geom,
                       view_wh=view_wh, uniforms=uniforms)
