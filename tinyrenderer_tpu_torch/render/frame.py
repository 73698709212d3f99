"""One frame (port of render/frame.py: the fused deferred frame, the
unfused deferred chain, the scaled frame and the forward-only frame).

The deferred frame (``_render_frame_fused``) runs, in order: geometry
(vertex transform), triangle setup + the resolve table (slim on flat-only
scenes, full on textured ones), the main view's binning and raster, on
textured scenes the mip level and the block-compacted material sample
(K7 taps), the shadow atlas (K1 per view, cached by the engine), the
refined shadow gates, the 1/8-rate sky + bilinear upsample, fused shading
(K3) and tone mapping; with forward triangles (light billboards, gizmos)
the overlay pass (K1 over dense bins, the compacted tile resolve, K7
sprite taps) composites before tone mapping. The main view takes, as the
reference does, the CSR stream (stream binning, K4, K5) for pools above
4096 triangles under ``cfg.stream_raster``, and otherwise dense or scatter
bins, K1 and K2.

Every other deferred configuration (SSR, ``texture_scale > 1``,
``fused_shading`` off, shadows off, no lights, ``fused_resolve``,
``use_pallas`` off) takes the unfused chain: raster + resolve
(:func:`_raster_resolve`), the GBuffer assembly, the shadow gates,
``shading.shade_deferred``, the sky behind, the forward overlay, SSR and
tone mapping. ``render_scale_pct != 100`` renders either frame at the
reduced size and resizes it (HDR bilinear, pick ids and depth nearest).

The forward-only frame (``cfg.forward_only``, ``render_frame_forward``)
rasterizes and resolves the deferred triangles, samples the material, and
shades N-dot-L with an ambient floor.

Raster + resolve follows the reference's branches: the fused raster +
resolve kernel K6 under ``fused_resolve``, else K1 (or K4 on the stream)
and select + eval. ``use_pallas=False`` selects the reference's kernel-free
*branch*: the full table, no stream, the tiled resolve. It does not select
plain versions: a CUDA tensor still launches the kernels, whose plain
versions equal the reference's jnp paths.

Branches of the reference not ported yet raise ``NotImplementedError``
naming their ROADMAP.md queue-1 item (:func:`check_ported`).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch

from .. import config
from ..ops import compact, post, raster, resolve, sampling, shading, shadows
from ..ops import env as envops
from ..ops.fp import fma
from .scene_gpu import LightsGPU, SceneGPU

F32 = torch.float32
I32 = torch.int32

# GlobalParams vector layout (the reference's GlobalGPUParams)
PARAM_EXPOSURE = 0
PARAM_TONE_TYPE = 1       # 0..3
PARAM_SSR_THICKNESS = 2
PARAM_SSR_STRENGTH = 3
PARAM_SHADOW_BIAS = 4     # NDC units; + biases the compare toward lit
NUM_PARAMS = 5


def default_params(device) -> torch.Tensor:
    return torch.tensor([1.0, 1.0, 0.25, 0.0, 0.0], dtype=F32, device=device)


@dataclass
class EnvGPU:
    env_cube: torch.Tensor        # (6, E, E, 3) environment cubemap
    irradiance: torch.Tensor      # (6, I, I, 3) diffuse irradiance
    irradiance_sh: torch.Tensor   # (9, 3) SH projection used by shading
    sky_rgbe: Optional[torch.Tensor] = None  # (6, E, E, 16) u8 display cube


@dataclass
class FrameOutput:
    sdr: torch.Tensor             # (H, W, 3) u8 tone-mapped
    pick_id: torch.Tensor         # (H, W) i32 object id (0 = none)
    depth: torch.Tensor           # (H, W) f32 reverse-Z
    hdr: torch.Tensor             # (H, W, 3) f32 pre-tonemap
    bin_overflow: torch.Tensor    # () i32 max main-raster bin occupancy
    shadow_overflow: torch.Tensor  # () i32 max shadow bin occupancy (0 when
    #   the atlas was precomputed: the engine monitors it at atlas time)
    tex_overflow: torch.Tensor    # (2,) i32 [material blocks, overlay tiles]
    #   wanted (the tex_block_capacity / fwd_tile_capacity monitors)
    big_overflow: torch.Tensor    # () i32 max big-triangle count across
    #   rasters (0 on dense bins)
    shadow_blocks: torch.Tensor   # () i32 shadow-boundary blocks wanted
    stream_overflow: torch.Tensor  # () i32 stream pairs wanted (0 off the
    #   stream path)
    sky_blocks: torch.Tensor      # () i32 background blocks wanted (0)


def _unpack_camera(camera_raw: torch.Tensor) -> dict:
    return dict(view_proj=camera_raw[0:16].reshape(4, 4),
                view=camera_raw[16:32].reshape(4, 4),
                view_inv=camera_raw[32:48].reshape(4, 4),
                proj=camera_raw[48:64].reshape(4, 4),
                proj_inv=camera_raw[64:80].reshape(4, 4),
                position=camera_raw[80:83])


def _sovf(bins) -> torch.Tensor:
    """The stream-capacity monitor of either bins flavour."""
    so = getattr(bins, "stream_overflow", None)
    return so if so is not None else torch.zeros((), dtype=I32,
                                                 device=bins.counts.device)


def geometry_stage(scene: SceneGPU, view_proj: torch.Tensor,
                   need_tbn: bool = True):
    """Expand the instance-shared vertex pool and transform it: (world (V,
    3), clip (V, 4), VertexAttrs with world-space normals [and tangents])."""
    data = scene.vert_data[scene.vert_src.long()]                 # (V, 14)
    world, clip = raster.transform_vertices(
        data[:, 0:3], scene.vert_instance, scene.inst_model, view_proj)
    nm = scene.inst_normal_mat.reshape(-1, 9)[scene.vert_instance.long()]

    def nm_apply(vec):
        vx, vy, vz = vec[:, 0], vec[:, 1], vec[:, 2]
        return torch.stack([raster.affine3(nm[:, 3 * i], vx, nm[:, 3 * i + 1],
                                           vy, nm[:, 3 * i + 2], vz)
                            for i in range(3)], dim=1)

    n_w = nm_apply(data[:, 5:8])
    t_w, b_w = ((nm_apply(data[:, 8:11]), nm_apply(data[:, 11:14]))
                if need_tbn else (n_w, n_w))
    attrs = resolve.VertexAttrs(world=world, uv=data[:, 3:5], normal=n_w,
                                tangent=t_w, bitangent=b_w)
    return world, clip, attrs


def world_positions(scene: SceneGPU) -> torch.Tensor:
    """(V, 3) world-space flattened vertex positions (shadow bake input)."""
    data = scene.vert_data[scene.vert_src.long()]
    world, _ = raster.transform_vertices(
        data[:, 0:3], scene.vert_instance, scene.inst_model,
        torch.eye(4, dtype=F32, device=data.device))
    return world


def render_shadow_atlas(scene: SceneGPU, lights: LightsGPU,
                        cfg: config.RenderConfig):
    """Windowed shadow atlas (6P + D, S, S, 4) (bf16 under
    ``cfg.shadow_bf16``) + () i32 shadow-bin overflow + () i32 big-triangle
    overflow. Camera-independent: the engine caches it across frames."""
    world = world_positions(scene)
    wh = torch.cat([world, torch.ones_like(world[:, :1])], dim=1)
    clip_views = torch.einsum("vj,sij->svi", wh, lights.shadow_viewprojs)
    atlas, overflow, big = shadows.render_shadow_views(
        clip_views, scene.tri_vidx, scene.tri_shadow, cfg.shadow_size,
        cfg.shadow_tile, cfg.shadow_bin_capacity, cfg.bin_big_capacity)
    win = shadows.window_depth_maps(atlas)
    if cfg.shadow_bf16:
        win = win.to(torch.bfloat16)
    return win, overflow, big


def use_fused_shading(cfg: config.RenderConfig) -> bool:
    """The reference's dispatch to its fused shading path."""
    return (cfg.fused_shading and cfg.use_pallas and not cfg.fused_resolve
            and not cfg.enable_ssr and cfg.texture_scale == 1
            and cfg.enable_shadows
            and (cfg.num_point_lights + cfg.num_directional_lights) > 0)


def scaled_config(cfg: config.RenderConfig) -> config.RenderConfig:
    """The configuration of the frame actually rendered under
    ``render_scale_pct``: the reduced size (at least one tile), same aspect
    and camera."""
    pct = cfg.render_scale_pct
    return replace(cfg, render_scale_pct=100,
                   width=max(cfg.tile_w, (cfg.width * pct) // 100),
                   height=max(cfg.tile_h, (cfg.height * pct) // 100))


def check_ported(cfg: config.RenderConfig) -> None:
    """Raise NotImplementedError for a configuration this port cannot run
    yet, naming the ROADMAP.md queue-1 item that ports it."""
    def refuse(what: str, item: str):
        raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md "
                                  f"queue 1 item {item})")

    if cfg.native_texture_pool:
        refuse("the native-size texture pool (native_texture_pool)", "14")
    if cfg.render_scale_pct != 100 and not cfg.forward_only:
        cfg = scaled_config(cfg)
    s = cfg.sky_scale
    if s > 1 and (cfg.padded_height % s or cfg.padded_width % s):
        refuse("a non-integer sky upsample", "14")
    if cfg.forward_only:
        return
    if cfg.sky_block_capacity > 0:
        refuse("the block-compacted exact sky (sky_block_capacity > 0)", "14")
    if s > 1 and cfg.sky_upsample != "bilinear":
        refuse("a cubic sky upsample", "14")


def render_frame(scene: SceneGPU, pool: sampling.TexturePoolGPU,
                 lights: LightsGPU, camera_raw: torch.Tensor,
                 params: torch.Tensor, env: Optional[EnvGPU],
                 cfg: config.RenderConfig,
                 atlas: Optional[torch.Tensor] = None) -> FrameOutput:
    """One camera frame. ``pool``: the material texture pool
    (``ScenePacker.pool_for``); ``atlas``: a cached
    :func:`render_shadow_atlas` result, None renders it inline.
    Configurations not ported yet raise (:func:`check_ported`)."""
    check_ported(cfg)
    # the plane and shadow matrix products must stay full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cfg.forward_only:
        return render_frame_forward(scene, pool, lights, camera_raw, params,
                                    env, cfg)
    if cfg.render_scale_pct != 100:
        return _render_frame_scaled(scene, pool, lights, camera_raw, params,
                                    env, cfg, atlas)
    if use_fused_shading(cfg):
        return _render_frame_fused(scene, pool, lights, camera_raw, params,
                                   env, cfg, atlas)
    return _render_frame_unfused(scene, pool, lights, camera_raw, params,
                                 env, cfg, atlas)


def _upsample_bilinear(img: torch.Tensor, height: int,
                       width: int) -> torch.Tensor:
    """(h, w, C) -> (height, width, C) bilinear: the exact phase-wise form
    for integer factors, the interpolating resize otherwise."""
    h, w = img.shape[:2]
    if height % h == 0 and width % w == 0:
        return post.upsample_bilinear_int(img, height // h, width // w)
    return post.resize_bilinear(img, height, width)


def _render_frame_scaled(scene, pool, lights, camera_raw, params, env, cfg,
                         atlas) -> FrameOutput:
    """Reduced internal resolution: the whole deferred frame at
    :func:`scaled_config`'s size, then the HDR upsampled bilinearly and
    tone-mapped at full size; pick ids and depth resized nearest, so ids
    stay exact."""
    out = render_frame(scene, pool, lights, camera_raw, params, env,
                       scaled_config(cfg), atlas)
    H, W = cfg.height, cfg.width
    hdr = _upsample_bilinear(out.hdr, H, W)
    sdr = post.tone_map(hdr, params[PARAM_TONE_TYPE], params[PARAM_EXPOSURE])
    return replace(out, sdr=sdr, hdr=hdr,
                   pick_id=post.resize_nearest(out.pick_id, H, W),
                   depth=post.resize_nearest(out.depth, H, W))


def _sky_cf(env: EnvGPU, cam: dict, cfg: config.RenderConfig
            ) -> torch.Tensor:
    """(3, PH, PW) sky: the cube sampled at 1/sky_scale rate, channel-first,
    bilinear integer upsample."""
    s = cfg.sky_scale
    PW, PH = cfg.padded_width, cfg.padded_height
    sky = envops.skybox_colors(
        env.env_cube, cam["proj_inv"], cam["view_inv"][:3, :3], PW // s,
        PH // s, rgbe_win=env.sky_rgbe if cfg.sky_rgbe else None)
    sky_c = sky.permute(2, 0, 1)
    return post.upsample_bilinear_int_cf(sky_c, s, s) if s > 1 else sky_c


def _slim_table(cfg: config.RenderConfig) -> bool:
    """The reference resolves the slim 28-column table only for a flat-only
    scene on the select + eval paths (``use_pallas`` on, no K6)."""
    return not cfg.any_textured and cfg.use_pallas and not cfg.fused_resolve


def _raster_resolve(clip: torch.Tensor, tri_vidx: torch.Tensor,
                    tri_mask: torch.Tensor, tri_instance: torch.Tensor,
                    vattrs: resolve.VertexAttrs, scene: SceneGPU,
                    cfg: config.RenderConfig, cull: str):
    """Raster + resolve -> (tri_id, depth, ResolvedAttrs, bins), by the
    reference's branches: the fused raster + resolve kernel (K6) under
    ``fused_resolve``; else the CSR stream (K4 + K5) for pools above 4096
    under ``cfg.stream_raster``; else dense or scatter bins, K1 and select +
    eval (K2). The slim table only where the reference takes it (a
    flat-only scene on the select + eval paths); ``use_pallas`` off keeps
    the full table, skips the stream and resolves in float32, as the
    reference's tiled fallback does."""
    PW, PH = cfg.padded_width, cfg.padded_height
    th, tw = cfg.tile_h, cfg.tile_w
    fused = cfg.use_pallas and cfg.fused_resolve
    setup = raster.triangle_setup(clip, tri_vidx, tri_mask, PW, PH, cull)
    table = resolve.build_gbuffer_table(
        setup, tri_vidx, vattrs, tri_instance, scene.inst_object_id,
        scene.inst_material, scene.mat_record, scene.mat_flat,
        slim=_slim_table(cfg))
    if (cfg.use_pallas and not fused and cfg.stream_raster
            and raster.stream_pays_off(tri_vidx.shape[0])):
        bins = raster.bin_triangles_stream(setup, PW, PH, th, tw,
                                           cfg.stream_capacity,
                                           cfg.bin_big_capacity)
        ty, tx = bins.counts.shape
        tri_id, depth = raster.rasterize_stream(bins, ty, tx, th, tw,
                                                cfg.bin_capacity)
        r = resolve.resolve_attrs_stream(tri_id, bins, table, th, tw,
                                         cfg.bin_capacity, bf16=cfg.bf16_attrs)
        return tri_id, depth, r, bins
    bins = raster.bin_triangles(setup, PW, PH, th, tw, cfg.bin_capacity,
                                cfg.bin_big_capacity)
    if fused:
        tri_id, depth, sel = raster.rasterize_resolve_binned(bins, table, th,
                                                             tw)
        return tri_id, depth, resolve.resolve_attrs_from_sel(tri_id, sel), bins
    tri_id, depth = raster.rasterize_binned(bins, th, tw)
    r = resolve.resolve_attrs_pallas(tri_id, table,
                                     bf16=cfg.bf16_attrs and cfg.use_pallas)
    return tri_id, depth, r, bins


def render_frame_forward(scene: SceneGPU, pool: sampling.TexturePoolGPU,
                         lights: LightsGPU, camera_raw: torch.Tensor,
                         params: torch.Tensor, env: Optional[EnvGPU],
                         cfg: config.RenderConfig) -> FrameOutput:
    """Forward-only frame: one visibility raster over the deferred
    triangles, flat or sampled albedo, Lambert N-dot-L per directional
    light over a 0.1 ambient floor, the sky behind, tone map. No shadows,
    IBL or overlay."""
    cam = _unpack_camera(camera_raw)
    W, H = cfg.width, cfg.height
    dev = camera_raw.device
    zero = torch.zeros((), dtype=I32, device=dev)
    _, clip, attrs = geometry_stage(scene, cam["view_proj"], need_tbn=False)
    tri_id, depth, r, bins = _raster_resolve(
        clip, scene.tri_vidx, scene.tri_deferred, scene.tri_instance, attrs,
        scene, cfg, "back")
    valid, normal, flat = r.valid, r.normal, r.flat
    use_tex = flat[..., 5] > 0.5
    lvl = sampling.mip_level_from_uv(r.uv, pool.level_sizes[0])
    tex, tex_needed = compact.sample_pool_compacted(
        pool, r.record, r.uv, lvl, use_tex & valid, cfg.tex_block_capacity,
        filter=cfg.texture_filter)
    albedo = torch.where(use_tex[..., None], tex[..., :3], flat[..., 0:3])
    shade = torch.full(normal.shape[:2] + (1,), 0.1, device=dev)
    nx, ny, nz = normal[..., 0], normal[..., 1], normal[..., 2]
    for i in range(cfg.num_directional_lights):
        d = lights.dir_direction[i]
        ndotl = (-fma(nz, d[2], fma(ny, d[1], nx * d[0]))).clamp(min=0.0)
        shade = fma(ndotl[..., None], lights.dir_color[i], shade)
    hdr = albedo * shade * valid[..., None].to(F32)
    if env is not None:
        hdr = torch.where(valid[..., None], hdr,
                          _sky_cf(env, cam, cfg).permute(1, 2, 0))
    sdr = post.tone_map(hdr, params[PARAM_TONE_TYPE], params[PARAM_EXPOSURE])
    return FrameOutput(sdr=sdr[:H, :W], pick_id=r.object_id[:H, :W],
                       depth=depth[:H, :W], hdr=hdr[:H, :W],
                       bin_overflow=bins.overflow, shadow_overflow=zero,
                       tex_overflow=torch.stack([tex_needed, zero]),
                       big_overflow=bins.big_overflow, shadow_blocks=zero,
                       stream_overflow=_sovf(bins), sky_blocks=zero)


def _forward_overlay(scene: SceneGPU, clip: torch.Tensor,
                     attrs: resolve.VertexAttrs,
                     pool: sampling.TexturePoolGPU, hdr: torch.Tensor,
                     pick: torch.Tensor, overflow: torch.Tensor,
                     big_overflow: torch.Tensor, cfg: config.RenderConfig):
    """The forward overlay (light billboards, gizmos: depth Always, drawn on
    top) when the scene has forward triangles: their own setup, dense bins
    and K1, the tile-compacted resolve with its sprite at 1/max(texture
    scale, 2) rate, composited into hdr and pick. Returns (hdr, pick,
    overflow, big_overflow, () i32 overlay tiles wanted)."""
    if not cfg.has_forward:
        return hdr, pick, overflow, big_overflow, torch.zeros_like(overflow)
    PW, PH = cfg.padded_width, cfg.padded_height
    th, tw = cfg.tile_h, cfg.tile_w
    f_setup = raster.triangle_setup(clip, scene.fwd_tri_vidx,
                                    scene.fwd_tri_mask, PW, PH, "none")
    f_bins = raster.bin_triangles(f_setup, PW, PH, th, tw, cfg.bin_capacity,
                                  cfg.bin_big_capacity)
    f_id, _ = raster.rasterize_binned(f_bins, th, tw)
    f_table = resolve.build_gbuffer_table(
        f_setup, scene.fwd_tri_vidx, attrs, scene.fwd_tri_instance,
        scene.inst_object_id, scene.inst_material, scene.mat_record,
        scene.mat_flat)
    hdr, pick, needed = resolve.forward_overlay_compose(
        hdr, pick, f_id, f_bins, f_table, pool, th, tw,
        cfg.fwd_tile_capacity, texture_filter=cfg.texture_filter,
        fs=max(cfg.texture_scale, 2))
    return (hdr, pick, torch.maximum(overflow, f_bins.overflow),
            torch.maximum(big_overflow, f_bins.big_overflow), needed)


def _render_frame_unfused(scene: SceneGPU, pool: sampling.TexturePoolGPU,
                          lights: LightsGPU, camera_raw: torch.Tensor,
                          params: torch.Tensor, env: Optional[EnvGPU],
                          cfg: config.RenderConfig,
                          atlas: Optional[torch.Tensor]) -> FrameOutput:
    """The unfused deferred chain (the reference's ``render_frame`` body):
    raster + resolve, GBuffer, shadow gates, ``shade_deferred``, the sky
    behind, the forward overlay, SSR, tone map."""
    cam = _unpack_camera(camera_raw)
    W, H = cfg.width, cfg.height
    P, D = cfg.num_point_lights, cfg.num_directional_lights
    zero = torch.zeros((), dtype=I32, device=camera_raw.device)
    _, clip, attrs = geometry_stage(
        scene, cam["view_proj"],
        need_tbn=not _slim_table(cfg) or cfg.has_forward)
    tri_id, depth, r_main, m_bins = _raster_resolve(
        clip, scene.tri_vidx, scene.tri_deferred, scene.tri_instance, attrs,
        scene, cfg, "back")
    g, tex_needed = resolve.resolve_gbuffer_from_attrs(
        r_main, tri_id, depth, pool, texture_filter=cfg.texture_filter,
        texture_scale=cfg.texture_scale,
        tex_block_capacity=cfg.tex_block_capacity,
        sample_textures=cfg.any_textured)
    overflow, big_overflow = m_bins.overflow, m_bins.big_overflow

    # ---- shadow gates (the atlas is cached across frames by the engine) --
    shadow_overflow = shadow_blocks = zero
    gates = None
    if cfg.enable_shadows and P + D > 0:
        if atlas is None:
            atlas, shadow_overflow, s_big = render_shadow_atlas(scene, lights,
                                                                cfg)
            big_overflow = torch.maximum(big_overflow, s_big)
        vis_all, vis_slot = shadows.gate_fns(
            lights.point_position[:P],
            lights.dir_viewproj[:D] if D > 0 else None, atlas,
            bias=params[PARAM_SHADOW_BIAS])
        gates, shadow_blocks = shadows.gate_refined_visibility(
            vis_all, vis_slot, g.position, cfg.shadow_lookup_scale,
            cfg.shadow_block_capacity,
            block_dims=(cfg.gate_block_h, cfg.gate_block_w))

    # ---- deferred shading, the sky behind ----
    slights = shading.ShadingLights(
        point_position=lights.point_position, point_color=lights.point_color,
        dir_direction=lights.dir_direction, dir_color=lights.dir_color,
        dir_viewproj=lights.dir_viewproj)
    irradiance = (env.irradiance_sh
                  if (env is not None and cfg.enable_ibl) else None)
    hdr = shading.shade_deferred(g, cam["position"], slights, P, D,
                                 irradiance, gates)
    if env is not None:
        hdr = torch.where(g.mask[..., None], hdr,
                          _sky_cf(env, cam, cfg).permute(1, 2, 0))

    hdr, pick, overflow, big_overflow, fwd_needed = _forward_overlay(
        scene, clip, attrs, pool, hdr, g.object_id, overflow, big_overflow,
        cfg)

    # ---- SSR (the reference ships strength 0: a pass-through) ----
    if cfg.enable_ssr:
        hdr = post.screen_space_reflections(
            hdr, depth, g.position, g.normal, cam["view_proj"],
            cam["position"], params[PARAM_SSR_THICKNESS],
            params[PARAM_SSR_STRENGTH], mask=g.mask,
            roughness=g.rough_metal_ao[..., 0])

    sdr = post.tone_map(hdr, params[PARAM_TONE_TYPE], params[PARAM_EXPOSURE])
    return FrameOutput(sdr=sdr[:H, :W], pick_id=pick[:H, :W],
                       depth=depth[:H, :W], hdr=hdr[:H, :W],
                       bin_overflow=overflow, shadow_overflow=shadow_overflow,
                       tex_overflow=torch.stack([tex_needed, fwd_needed]),
                       big_overflow=big_overflow, shadow_blocks=shadow_blocks,
                       stream_overflow=_sovf(m_bins), sky_blocks=zero)


def _render_frame_fused(scene: SceneGPU, pool: sampling.TexturePoolGPU,
                        lights: LightsGPU, camera_raw: torch.Tensor,
                        params: torch.Tensor, env: Optional[EnvGPU],
                        cfg: config.RenderConfig,
                        atlas: Optional[torch.Tensor]) -> FrameOutput:
    """The deferred frame through the fused shading kernel, then the
    forward overlay."""
    cam = _unpack_camera(camera_raw)
    W, H = cfg.width, cfg.height
    PW, PH = cfg.padded_width, cfg.padded_height
    th, tw = cfg.tile_h, cfg.tile_w
    P, D = cfg.num_point_lights, cfg.num_directional_lights
    dev = camera_raw.device
    zero = torch.zeros((), dtype=I32, device=dev)
    # statically flat-only scenes resolve the slim 28-column table: uv,
    # the tangent frame and the record are never read
    slim = not cfg.any_textured

    # ---- main visibility raster + channel-first select + eval ----
    _, clip, attrs = geometry_stage(scene, cam["view_proj"],
                                    need_tbn=not slim or cfg.has_forward)
    setup = raster.triangle_setup(clip, scene.tri_vidx, scene.tri_deferred,
                                  PW, PH, "back")
    table = resolve.build_gbuffer_table(
        setup, scene.tri_vidx, attrs, scene.tri_instance,
        scene.inst_object_id, scene.inst_material, scene.mat_record,
        scene.mat_flat, slim=slim)
    if cfg.stream_raster and raster.stream_pays_off(scene.tri_vidx.shape[0]):
        m_bins = raster.bin_triangles_stream(
            setup, PW, PH, th, tw, cfg.stream_capacity, cfg.bin_big_capacity)
        ty, tx = m_bins.counts.shape
        tri_id, depth = raster.rasterize_stream(m_bins, ty, tx, th, tw,
                                                cfg.bin_capacity)
        outf_c, outh_c = resolve.select_eval_stream(
            tri_id, m_bins, table, th, tw, cfg.bin_capacity,
            bf16=cfg.bf16_attrs)
    else:
        m_bins = raster.bin_triangles(setup, PW, PH, th, tw,
                                      cfg.bin_capacity, cfg.bin_big_capacity)
        tri_id, depth = raster.rasterize_binned(m_bins, th, tw)
        outf_c, outh_c = resolve.select_eval(tri_id, table,
                                             bf16=cfg.bf16_attrs)
    overflow, big_overflow = m_bins.overflow, m_bins.big_overflow
    valid = tri_id >= 0
    g_pos = torch.where(valid[..., None], outf_c[0:3].permute(1, 2, 0),
                        torch.zeros((), device=dev))
    pick = torch.where(valid, torch.round(outf_c[3 if slim else 6]).to(I32),
                       zero)

    # ---- material sample (block-compacted), full layout only ----
    rec_c, tex_needed = None, zero
    if not slim:
        uv = outf_c[3:5].permute(1, 2, 0)
        record = torch.round(outf_c[5]).to(I32)
        use_tex = outh_c[14].to(F32) > 0.5           # flat[5]
        lvl = sampling.mip_level_from_uv(uv, pool.level_sizes[0])
        rec, tex_needed = compact.sample_pool_compacted(
            pool, record, uv, lvl, use_tex & valid, cfg.tex_block_capacity,
            filter=cfg.texture_filter)                # (H, W, 9)
        rec_c = rec.permute(2, 0, 1).contiguous()

    # ---- shadow atlas + channel-first gates ----
    shadow_overflow = zero
    if atlas is None:
        atlas, shadow_overflow, s_big = render_shadow_atlas(scene, lights, cfg)
        big_overflow = torch.maximum(big_overflow, s_big)
    vis_all, vis_slot = shadows.gate_fns(
        lights.point_position[:P], lights.dir_viewproj[:D] if D > 0 else None,
        atlas, bias=params[PARAM_SHADOW_BIAS])
    gates_c, shadow_blocks = shadows.gate_refined_visibility(
        vis_all, vis_slot, g_pos, cfg.shadow_lookup_scale,
        cfg.shadow_block_capacity,
        block_dims=(cfg.gate_block_h, cfg.gate_block_w))

    # ---- fused shading (K3) over the sky ----
    sky_c = _sky_cf(env, cam, cfg) if env is not None else None
    slights = shading.ShadingLights(
        point_position=lights.point_position, point_color=lights.point_color,
        dir_direction=lights.dir_direction, dir_color=lights.dir_color,
        dir_viewproj=lights.dir_viewproj)
    irradiance = (env.irradiance_sh
                  if (env is not None and cfg.enable_ibl) else None)
    hdr = shading.shade_deferred_fused(
        tri_id, outf_c, outh_c, rec_c, gates_c, sky_c, cam["position"],
        slights, P, D, irradiance).permute(1, 2, 0)

    hdr, pick, overflow, big_overflow, fwd_needed = _forward_overlay(
        scene, clip, attrs, pool, hdr, pick, overflow, big_overflow, cfg)

    sdr = post.tone_map(hdr, params[PARAM_TONE_TYPE], params[PARAM_EXPOSURE])
    return FrameOutput(sdr=sdr[:H, :W], pick_id=pick[:H, :W],
                       depth=depth[:H, :W], hdr=hdr[:H, :W],
                       bin_overflow=overflow, shadow_overflow=shadow_overflow,
                       tex_overflow=torch.stack([tex_needed, fwd_needed]),
                       big_overflow=big_overflow, shadow_blocks=shadow_blocks,
                       stream_overflow=_sovf(m_bins), sky_blocks=zero)
