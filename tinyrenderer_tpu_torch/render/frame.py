"""One deferred frame (port of render/frame.py, the fused path).

``render_frame`` runs, in order: geometry (vertex transform), triangle
setup + the slim resolve table, dense binning, the visibility raster (K1),
select + eval (K2), the shadow atlas (K1 per view, cached by the engine),
the refined shadow gates, the 1/8-rate sky + bilinear upsample, fused
shading (K3) and tone mapping, then crops the padded frame.

This slice ports the fused frame of a flat-only scene without forward
(overlay) triangles under the default configuration. Every other branch
of the reference's ``render_frame`` raises ``NotImplementedError`` naming
its ROADMAP.md queue-1 item.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..ops import env as envops
from ..ops import post, raster, resolve, shading, shadows
from ..shared import config
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
    tex_overflow: torch.Tensor    # (2,) i32 textured-block counts (0 here)
    big_overflow: torch.Tensor    # () i32 big-triangle count (0, dense)
    shadow_blocks: torch.Tensor   # () i32 shadow-boundary blocks wanted
    stream_overflow: torch.Tensor  # () i32 stream pairs wanted (0, dense)
    sky_blocks: torch.Tensor      # () i32 background blocks wanted (0)


def _unpack_camera(camera_raw: torch.Tensor) -> dict:
    return dict(view_proj=camera_raw[0:16].reshape(4, 4),
                view=camera_raw[16:32].reshape(4, 4),
                view_inv=camera_raw[32:48].reshape(4, 4),
                proj=camera_raw[48:64].reshape(4, 4),
                proj_inv=camera_raw[64:80].reshape(4, 4),
                position=camera_raw[80:83])


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
        cfg.shadow_tile, cfg.shadow_bin_capacity)
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


def check_ported(cfg: config.RenderConfig, n_triangles: int) -> None:
    """Raise NotImplementedError for a configuration this port cannot run
    yet, naming the ROADMAP.md queue-1 item that ports it."""
    def refuse(what: str, item: str):
        raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md "
                                  f"queue 1 item {item})")

    if cfg.forward_only:
        refuse("the forward-only frame (render_frame_forward)", "10")
    if cfg.render_scale_pct != 100:
        refuse("render_scale_pct != 100 (the unfused chain)", "12")
    if not use_fused_shading(cfg):
        refuse("the unfused deferred chain (fused_shading off, SSR, "
               "texture_scale > 1, shadows off or no lights)", "12")
    if cfg.any_textured:
        refuse("textured materials (the texture pool, K3's material plane)",
               "11")
    if cfg.has_forward:
        refuse("the forward overlay (light billboards, gizmos)", "10")
    if n_triangles > raster._SCATTER_MIN_T:
        refuse(f"binning a pool of {n_triangles} > {raster._SCATTER_MIN_T} "
               "triangles (scatter/stream binners, kernels K4/K5)", "13")
    if cfg.sky_block_capacity > 0:
        refuse("the block-compacted exact sky (sky_block_capacity > 0)", "14")
    s = cfg.sky_scale
    if s > 1 and (cfg.sky_upsample != "bilinear"
                  or cfg.padded_height % s or cfg.padded_width % s):
        refuse("a cubic or non-integer sky upsample", "14")


def render_frame(scene: SceneGPU, lights: LightsGPU,
                 camera_raw: torch.Tensor, params: torch.Tensor,
                 env: Optional[EnvGPU], cfg: config.RenderConfig,
                 atlas: Optional[torch.Tensor] = None) -> FrameOutput:
    """One camera frame. ``atlas``: a cached :func:`render_shadow_atlas`
    result; None renders it inline. Only the reference's fused path is
    ported; other configurations raise (:func:`check_ported`)."""
    check_ported(cfg, scene.tri_vidx.shape[0])
    # the plane and shadow matrix products must stay full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return _render_frame_fused(scene, lights, camera_raw, params, env, cfg,
                               atlas)


def _render_frame_fused(scene: SceneGPU, lights: LightsGPU,
                        camera_raw: torch.Tensor, params: torch.Tensor,
                        env: Optional[EnvGPU], cfg: config.RenderConfig,
                        atlas: Optional[torch.Tensor]) -> FrameOutput:
    """The deferred frame through the fused shading kernel, for a dense,
    flat-only scene without forward triangles."""
    cam = _unpack_camera(camera_raw)
    W, H = cfg.width, cfg.height
    PW, PH = cfg.padded_width, cfg.padded_height
    P, D = cfg.num_point_lights, cfg.num_directional_lights
    dev = camera_raw.device
    zero = torch.zeros((), dtype=I32, device=dev)

    # ---- main visibility raster + channel-first select + eval (slim) ----
    _, clip, attrs = geometry_stage(scene, cam["view_proj"],
                                    need_tbn=False)
    setup = raster.triangle_setup(clip, scene.tri_vidx, scene.tri_deferred,
                                  PW, PH, "back")
    table = resolve.build_gbuffer_table(
        setup, scene.tri_vidx, attrs, scene.tri_instance,
        scene.inst_object_id, scene.inst_material, scene.mat_record,
        scene.mat_flat, slim=True)
    m_bins = raster.bin_triangles(setup, PW, PH, cfg.tile_h, cfg.tile_w,
                                  cfg.bin_capacity)
    tri_id, depth = raster.rasterize_binned(m_bins, cfg.tile_h, cfg.tile_w)
    outf_c, outh_c = resolve.select_eval(tri_id, table, bf16=cfg.bf16_attrs)
    valid = tri_id >= 0
    g_pos = torch.where(valid[..., None], outf_c[0:3].permute(1, 2, 0),
                        torch.zeros((), device=dev))
    pick = torch.where(valid, torch.round(outf_c[3]).to(I32), zero)

    # ---- shadow atlas + channel-first gates ----
    shadow_overflow, big_overflow = zero, m_bins.big_overflow
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

    # ---- sky at 1/sky_scale rate, channel-first, bilinear upsample ----
    sky_c = None
    if env is not None:
        s = cfg.sky_scale
        sky = envops.skybox_colors(
            env.env_cube, cam["proj_inv"], cam["view_inv"][:3, :3],
            PW // s, PH // s, rgbe_win=env.sky_rgbe if cfg.sky_rgbe else None)
        sky_c = sky.permute(2, 0, 1)
        if s > 1:
            sky_c = post.upsample_bilinear_int_cf(sky_c, s, s)

    # ---- fused shading (K3) ----
    slights = shading.ShadingLights(
        point_position=lights.point_position, point_color=lights.point_color,
        dir_direction=lights.dir_direction, dir_color=lights.dir_color,
        dir_viewproj=lights.dir_viewproj)
    irradiance = (env.irradiance_sh
                  if (env is not None and cfg.enable_ibl) else None)
    hdr_c = shading.shade_deferred_fused(
        tri_id, outf_c, outh_c, gates_c, sky_c, cam["position"], slights,
        P, D, irradiance)
    hdr = hdr_c.permute(1, 2, 0)

    sdr = post.tone_map(hdr, params[PARAM_TONE_TYPE], params[PARAM_EXPOSURE])
    return FrameOutput(sdr=sdr[:H, :W], pick_id=pick[:H, :W],
                       depth=depth[:H, :W], hdr=hdr[:H, :W],
                       bin_overflow=m_bins.overflow,
                       shadow_overflow=shadow_overflow,
                       tex_overflow=torch.zeros(2, dtype=I32, device=dev),
                       big_overflow=big_overflow, shadow_blocks=shadow_blocks,
                       stream_overflow=zero, sky_blocks=zero)
