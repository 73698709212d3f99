"""The multi-device frame (port of parallel/sharded.py): a batch of views
rendered over a (dp, sp) grid of ranks of ``torch.distributed``.

- ``dp`` carries the camera batch: each row of the grid renders its share
  of the cameras, with no cross-talk.
- ``sp`` carries horizontal image bands of whole tile rows, one band a
  rank. The triangle setup is computed for the whole frame by every rank
  and translated into its band (``raster.translate_setup_y``), so the
  raster, the resolve and the shading touch only the band's rows.
- The shadow views are shared out round-robin over all ranks and gathered
  by every rank.

Every rank runs this module's functions together, as one program: the
collectives below are called by all ranks of their group, in the same
order, and nothing that decides whether one is called differs between
ranks. They are, with the reference's collective each replaces:

- the shadow views, an all-gather over the world (``all_gather`` over
  ``("dp", "sp")``);
- each band's first and last coarse shadow-gate rows, an all-gather over
  the band's ``sp`` group, from which a band takes its neighbours' rows
  (``ppermute`` over ``sp``);
- SSR's tap buffers, the frame's depth and pre-SSR HDR, an all-gather over
  the ``sp`` group (``all_gather`` over ``sp``);
- the capacity monitors, an all-reduce of their maxima over the world
  (``pmax``);
- the frame, assembled from bands and batch by an all-gather over the
  world, so that every rank returns the whole ``(B, H, W, ...)`` frame
  (``out_specs P("dp", "sp")``).

Each takes the rank's device tensors: gloo, whose CUDA support covers only
some collectives, takes CUDA tensors in all of these (probed on an H100 with
``tools/probe_collectives.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import config
from ..ops import compact, post, raster, resolve, sampling, shading, shadows
from ..ops import env as envops
from ..render import frame as framelib
from ..render.scene_gpu import LightsGPU, SceneGPU

F32 = torch.float32
I32 = torch.int32
U8 = torch.uint8
BACKENDS = ("gloo", "nccl")


@dataclass(frozen=True)
class Mesh:
    """This rank's place in the (dp, sp) grid, its groups and its device.

    Rank ``flat = dp_i * sp + sp_i`` of the world renders band ``sp_i`` of
    the cameras of batch row ``dp_i``; ``sp_group`` holds the ``sp`` ranks
    of its row, in band order."""

    dp: int
    sp: int
    dp_i: int
    sp_i: int
    device: torch.device
    backend: str
    world: Any        # the world's process group
    sp_group: Any     # this rank's row of the grid

    @property
    def flat(self) -> int:
        return self.dp_i * self.sp + self.sp_i


def make_mesh(dp: int, sp: int, device, backend: str) -> Mesh:
    """This rank's :class:`Mesh` in an initialized process group of
    ``dp * sp`` ranks on ``backend`` ("nccl": one card a rank; "gloo":
    ranks may share a card, or run on the CPU). Every rank must call it:
    each creates every row's group, in the same order."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, not {backend!r}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(parallel.launch starts one)")
    if dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()!r}, "
                         f"not {backend!r}")
    world = dist.get_world_size()
    if dp < 1 or sp < 1 or world != dp * sp:
        raise ValueError(f"world size {world} is not dp={dp} x sp={sp}")
    rows = [dist.new_group([d * sp + s for s in range(sp)], backend=backend)
            for d in range(dp)]
    dp_i, sp_i = divmod(dist.get_rank(), sp)
    return Mesh(dp=dp, sp=sp, dp_i=dp_i, sp_i=sp_i,
                device=torch.device(device), backend=backend,
                world=dist.group.WORLD, sp_group=rows[dp_i])


def sharded_config(cfg: config.RenderConfig, n_sp: int) -> config.RenderConfig:
    """Pad the frame height so the tile rows divide evenly over ``sp``.
    Fused shading runs per band where the band height holds its minimum
    block (16 rows with bf16 attributes, else 8); shorter bands take the
    unfused chain, the same arithmetic."""
    rows_per_dev = -(-cfg.tiles_y // n_sp)
    band_h = rows_per_dev * cfg.tile_h
    min_bh = 16 if cfg.bf16_attrs else 8
    return replace(cfg, height=rows_per_dev * n_sp * cfg.tile_h,
                   fused_shading=cfg.fused_shading and band_h % min_bh == 0)


@dataclass
class ShardedFrameOutput:
    sdr: torch.Tensor             # (B, H, W, 3) u8
    pick_id: torch.Tensor         # (B, H, W) i32
    depth: torch.Tensor           # (B, H, W) f32
    hdr: torch.Tensor             # (B, H, W, 3) f32
    bin_overflow: torch.Tensor    # () i32 max bin occupancy over bands
    shadow_overflow: torch.Tensor  # () i32 max shadow bin occupancy over
    #   views (0 when the atlas was passed in)
    tex_overflow: torch.Tensor    # (2,) i32 max [material blocks, overlay
    #   tiles] wanted by a band
    big_overflow: torch.Tensor    # () i32 max big-triangle count
    shadow_blocks: torch.Tensor   # () i32 max shadow-edge work items wanted
    #   by a band
    stream_overflow: torch.Tensor  # () i32 max stream pairs wanted by a band
    sky_blocks: torch.Tensor      # () i32 background blocks wanted by a
    #   frame of the batch: its bands' counts summed, FrameOutput.sky_blocks
    #   of the whole frame (0 off the block-compacted sky)


# ---- collectives -------------------------------------------------------------

def _all_gather(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """(n, *t.shape): each of the group's ``n`` ranks' ``t``, in the
    group's rank order."""
    out = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(out, t.contiguous(), group=group)
    return torch.stack(out)


def _max_over_world(mesh: Mesh, values: torch.Tensor) -> torch.Tensor:
    values = values.contiguous()
    dist.all_reduce(values, op=dist.ReduceOp.MAX, group=mesh.world)
    return values


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """(B, h, w, ...) -> (B, h, w, bytes) u8 view of each pixel's values."""
    B, h, w = t.shape[:3]
    return t.contiguous().reshape(B, h, w, -1).view(U8)


def _gather_frames(mesh: Mesh, planes: list[torch.Tensor]) -> list:
    """The (B_local, band_h, PW, ...) band planes of every rank assembled
    into (B, PH, PW, ...) frames on every rank: one all-gather of each
    pixel's bytes over the world (bit-exact whatever the dtype)."""
    packed = torch.cat([_as_bytes(p) for p in planes], dim=-1)
    Bl, bh, W, nb = packed.shape
    g = _all_gather(packed, mesh.world, mesh.dp * mesh.sp)
    g = g.reshape(mesh.dp, mesh.sp, Bl, bh, W, nb).permute(0, 2, 1, 3, 4, 5)
    g = g.reshape(mesh.dp * Bl, mesh.sp * bh, W, nb)
    out, at = [], 0
    for p in planes:
        n = _as_bytes(p).shape[-1]
        out.append(g[..., at:at + n].contiguous().view(p.dtype)
                   .reshape((g.shape[0], g.shape[1], W) + p.shape[3:]))
        at += n
    return out


def _band_neighbours(mesh: Mesh, rows: torch.Tensor, nsp: int):
    """The reference's ppermute of boundary rows over the first ``nsp``
    bands of a row of the grid. ``rows`` (2, ...) holds this band's first
    and last row; returns (the row above the band, the row below it): the
    neighbour bands' last and first rows, the band's own at the frame's
    top and bottom, zeros on bands at or past ``nsp`` (which the
    reference's permutation does not reach)."""
    g = _all_gather(rows, mesh.sp_group, mesh.sp)       # (sp, 2, ...)
    k = mesh.sp_i
    zero = torch.zeros_like(rows[0])
    above = rows[0] if k == 0 else (g[k - 1, 1] if k < nsp else zero)
    below = rows[1] if k == nsp - 1 else (g[k + 1, 0] if k < nsp - 1
                                          else zero)
    return above[None], below[None]


# ---- one band ----------------------------------------------------------------

def _band_sky(env: framelib.EnvGPU, cam: dict, cfg: config.RenderConfig,
              valid: torch.Tensor, y0: int, PH: int, nsp: int, sp_i: int):
    """(band_h, PW, 3) sky of the band and () i32 background blocks it
    wanted. The block-compacted exact sky plans the band's own blocks with
    the frame's capacity; a sky at 1/s rate renders its strip with ``e``
    coarse rows more above and below (the upsample's support: bilinear 1,
    Catmull-Rom 2), repeats the frame's edge rows at its top and bottom as
    the whole frame's upsample clamps, and crops the upsample to the band:
    the rows of the whole frame's sky."""
    band_h, PW = valid.shape
    rgbe = env.sky_rgbe if cfg.sky_rgbe else None
    proj_inv, rot_inv = cam["proj_inv"], cam["view_inv"][:3, :3]
    zero = torch.zeros((), dtype=I32, device=valid.device)
    dims = compact.block_dims(band_h, PW)
    if cfg.sky_block_capacity > 0 and dims is not None:
        bh, bw = dims
        nby, nbx = band_h // bh, PW // bw
        plan = compact.plan_blocks(compact.blocks_needed(~valid, bh, bw),
                                   min(cfg.sky_block_capacity, nby * nbx))
        cols = envops.skybox_colors_blocks(
            env.env_cube, proj_inv, rot_inv, plan.slots, bh, bw, nbx, PW,
            band_h, rgbe_win=rgbe, y0=y0, full_height=PH)
        return (compact.from_blocks(compact.scatter_blocks(cols, plan),
                                    band_h, PW), plan.needed)
    s = cfg.sky_scale
    if s == 1:
        return envops.skybox_colors(env.env_cube, proj_inv, rot_inv, PW,
                                    band_h, rgbe_win=rgbe, y0=y0,
                                    full_height=PH), zero
    cubic = cfg.sky_upsample == "cubic" and PH % s == 0 and PW % s == 0
    e = 2 if cubic else 1
    hl = band_h // s
    # the strip's first row, in float32 as the reference computes it
    y_strip = float(np.float32(y0) / np.float32(s) - np.float32(e))
    strip = envops.skybox_colors(env.env_cube, proj_inv, rot_inv, PW // s,
                                 hl + 2 * e, rgbe_win=rgbe, y0=y_strip,
                                 full_height=PH // s)
    tops = [strip[e:e + 1] if sp_i == 0 else strip[r:r + 1]
            for r in range(e)]
    bots = [strip[e + hl - 1:e + hl] if sp_i == nsp - 1
            else strip[e + hl + r:e + hl + r + 1] for r in range(e)]
    strip = torch.cat(tops + [strip[e:e + hl]] + bots, dim=0)
    if cubic:
        up = post.upsample_bicubic_int(strip, s, s)[:, :PW]
    else:
        up = framelib._upsample_bilinear(strip, (hl + 2 * e) * s, PW)
    return up[e * s:e * s + band_h], zero


def _render_band(scene: SceneGPU, pool, lights: LightsGPU,
                 atlas: Optional[torch.Tensor], camera_raw: torch.Tensor,
                 params: torch.Tensor, env: Optional[framelib.EnvGPU],
                 cfg: config.RenderConfig, mesh: Mesh, band_h: int,
                 proj_h: Optional[int]) -> tuple:
    """Rows [y0, y0 + band_h) of one camera's frame, y0 = sp_i * band_h:
    the single-card frame's passes confined to the band.

    ``proj_h``: the height the NDC y range maps onto; by default the
    padded height. The render-scale frame passes the single-card padded
    height, so that the rows the band division pads on lie below the frame
    and the projection is not rescaled.

    Returns (sdr, pick, depth, hdr, monitors (8,) i32: bin, tex material,
    tex overlay, big, shadow blocks, stream pairs, sky blocks, and 0 for
    the shadow bins, which the atlas reports)."""
    cam = framelib._unpack_camera(camera_raw)
    PW, PH = cfg.padded_width, proj_h or cfg.padded_height
    th, tw = cfg.tile_h, cfg.tile_w
    y0 = mesh.sp_i * band_h
    nsp = PH // band_h          # bands the projection reaches
    dev = camera_raw.device
    zero = torch.zeros((), dtype=I32, device=dev)
    T = scene.tri_vidx.shape[0]
    _, clip, attrs = framelib.geometry_stage(scene, cam["view_proj"])

    def band_setup(tri_vidx, tri_mask, cull):
        return raster.translate_setup_y(
            raster.triangle_setup(clip, tri_vidx, tri_mask, PW, PH, cull), y0)

    def table_of(setup):
        return resolve.build_gbuffer_table(
            setup, scene.tri_vidx, attrs, scene.tri_instance,
            scene.inst_object_id, scene.inst_material, scene.mat_record,
            scene.mat_flat)

    def dense_bins(setup):
        return raster.bin_triangles(setup, PW, band_h, th, tw,
                                    cfg.bin_capacity, cfg.bin_big_capacity)

    def stream_bins(setup):
        return raster.bin_triangles_stream(setup, PW, band_h, th, tw,
                                           cfg.stream_capacity,
                                           cfg.bin_big_capacity)

    def gbuffer(r, tri_id, depth):
        return resolve.resolve_gbuffer_from_attrs(
            r, tri_id, depth, pool, texture_filter=cfg.texture_filter,
            texture_scale=cfg.texture_scale,
            tex_block_capacity=cfg.tex_block_capacity,
            sample_textures=cfg.any_textured)

    use_stream = cfg.stream_raster and raster.stream_pays_off(T)
    use_fused = framelib.use_fused_shading(cfg) and atlas is not None
    g = rec_c = None
    tex_needed = zero
    setup = band_setup(scene.tri_vidx, scene.tri_deferred, "back")
    if use_fused:
        # the full table, K1 or K4 + K5, K2 split outputs, the compacted
        # material sample; K3 below
        table = table_of(setup)
        if use_stream:
            bins = stream_bins(setup)
            ty, tx = bins.counts.shape
            tri_id, depth = raster.rasterize_stream(bins, ty, tx, th, tw,
                                                    cfg.bin_capacity)
            outf_c, outh_c = resolve.select_eval_stream(
                tri_id, bins, table, th, tw, cfg.bin_capacity,
                bf16=cfg.bf16_attrs)
        else:
            bins = dense_bins(setup)
            tri_id, depth = raster.rasterize_binned(bins, th, tw)
            outf_c, outh_c = resolve.select_eval(tri_id, table,
                                                 bf16=cfg.bf16_attrs)
        valid = tri_id >= 0
        g_pos = torch.where(valid[..., None], outf_c[0:3].permute(1, 2, 0),
                            torch.zeros((), device=dev))
        pick = torch.where(valid, torch.round(outf_c[6]).to(I32), zero)
        if cfg.any_textured:
            uv = outf_c[3:5].permute(1, 2, 0)
            record = torch.round(outf_c[5]).to(I32)
            use_tex = outh_c[14].to(F32) > 0.5
            lvl = sampling.mip_level_from_uv(uv, pool.level_sizes[0])
            rec, tex_needed = compact.sample_pool_compacted(
                pool, record, uv, lvl, use_tex & valid,
                cfg.tex_block_capacity, filter=cfg.texture_filter,
                duv=sampling.pool_duv(pool, uv))
            rec_c = rec.permute(2, 0, 1).contiguous()
    elif cfg.use_pallas and cfg.fused_resolve:
        bins = dense_bins(setup)                         # K6
        tri_id, depth, sel = raster.rasterize_resolve_binned(
            bins, table_of(setup), th, tw)
        g, tex_needed = gbuffer(resolve.resolve_attrs_from_sel(tri_id, sel),
                                tri_id, depth)
    elif cfg.use_pallas and use_stream:
        bins = stream_bins(setup)                        # K4 + K5
        ty, tx = bins.counts.shape
        tri_id, depth = raster.rasterize_stream(bins, ty, tx, th, tw,
                                                cfg.bin_capacity)
        r = resolve.resolve_attrs_stream(tri_id, bins, table_of(setup), th,
                                         tw, cfg.bin_capacity,
                                         bf16=cfg.bf16_attrs)
        g, tex_needed = gbuffer(r, tri_id, depth)
    else:
        bins = dense_bins(setup)                         # K1 + K2
        tri_id, depth = raster.rasterize_binned(bins, th, tw)
        g, tex_needed = resolve.resolve_gbuffer_onehot(
            tri_id, depth, setup, scene.tri_vidx, scene.tri_instance, attrs,
            scene.inst_object_id, scene.inst_material, scene.mat_record,
            scene.mat_flat, pool, texture_filter=cfg.texture_filter,
            texture_scale=cfg.texture_scale,
            tex_block_capacity=cfg.tex_block_capacity,
            bf16=cfg.bf16_attrs and cfg.use_pallas,
            sample_textures=cfg.any_textured)
    bin_overflow, big_overflow = bins.overflow, bins.big_overflow
    stream_overflow = framelib._sovf(bins)

    # ---- shadow gates; a band's coarse grid sees its neighbours' rows ----
    P, D = cfg.num_point_lights, cfg.num_directional_lights
    gates, shadow_blocks = None, zero
    if cfg.enable_shadows and P + D > 0 and atlas is not None:
        vis_all, vis_slot = shadows.gate_fns(
            lights.point_position[:P],
            lights.dir_viewproj[:D] if D > 0 else None, atlas,
            bias=params[framelib.PARAM_SHADOW_BIAS])

        def halo_exchange(lo):
            u8 = lo.to(U8)
            return _band_neighbours(mesh, torch.cat([u8[:1], u8[-1:]]), nsp)

        gates, shadow_blocks = shadows.gate_refined_visibility(
            vis_all, vis_slot, g_pos if use_fused else g.position,
            cfg.shadow_lookup_scale, cfg.shadow_block_capacity,
            block_dims=(cfg.gate_block_h, cfg.gate_block_w),
            halo_exchange=halo_exchange if nsp > 1 else None)

    # ---- shading over the band's sky ----
    slights = shading.ShadingLights(
        point_position=lights.point_position, point_color=lights.point_color,
        dir_direction=lights.dir_direction, dir_color=lights.dir_color,
        dir_viewproj=lights.dir_viewproj)
    irradiance = (env.irradiance_sh
                  if (env is not None and cfg.enable_ibl) else None)
    sky, sky_blocks = None, zero
    if env is not None:
        sky, sky_blocks = _band_sky(env, cam, cfg, tri_id >= 0, y0, PH, nsp,
                                    mesh.sp_i)
    if use_fused:
        sky_c = None if sky is None else sky.permute(2, 0, 1).contiguous()
        hdr = shading.shade_deferred_fused(
            tri_id, outf_c, outh_c, rec_c, gates, sky_c, cam["position"],
            slights, P, D, irradiance).permute(1, 2, 0)
    else:
        hdr = shading.shade_deferred(g, cam["position"], slights, P, D,
                                     irradiance, gates)
        if sky is not None:
            hdr = torch.where(g.mask[..., None], hdr, sky)
        pick = g.object_id

    # ---- the forward overlay, band-local ----
    fwd_needed = zero
    if cfg.has_forward:
        f_setup = band_setup(scene.fwd_tri_vidx, scene.fwd_tri_mask, "none")
        f_bins = dense_bins(f_setup)
        f_id, _ = raster.rasterize_binned(f_bins, th, tw)
        bin_overflow = torch.maximum(bin_overflow, f_bins.overflow)
        big_overflow = torch.maximum(big_overflow, f_bins.big_overflow)
        f_table = resolve.build_gbuffer_table(
            f_setup, scene.fwd_tri_vidx, attrs, scene.fwd_tri_instance,
            scene.inst_object_id, scene.inst_material, scene.mat_record,
            scene.mat_flat)
        hdr, pick, fwd_needed = resolve.forward_overlay_compose(
            hdr, pick, f_id, f_bins, f_table, pool, th, tw,
            cfg.fwd_tile_capacity, texture_filter=cfg.texture_filter,
            fs=max(cfg.texture_scale, 2))

    # ---- SSR: per-pixel inputs band-local, taps on the gathered frame ----
    if cfg.enable_ssr:
        full_depth = _all_gather(depth, mesh.sp_group, mesh.sp)
        full_hdr = _all_gather(hdr, mesh.sp_group, mesh.sp)
        hdr = post.screen_space_reflections(
            hdr, full_depth.reshape(-1, PW)[:PH], g.position, g.normal,
            cam["view_proj"], cam["position"],
            params[framelib.PARAM_SSR_THICKNESS],
            params[framelib.PARAM_SSR_STRENGTH], mask=g.mask,
            roughness=g.rough_metal_ao[..., 0],
            tap_hdr=full_hdr.reshape(-1, PW, 3)[:PH], y0=y0)

    sdr = post.tone_map(hdr, params[framelib.PARAM_TONE_TYPE],
                        params[framelib.PARAM_EXPOSURE])
    monitors = torch.stack([bin_overflow, tex_needed, fwd_needed,
                            big_overflow, shadow_blocks, stream_overflow,
                            sky_blocks, zero]).to(I32)
    return sdr, pick, depth, hdr, monitors


# ---- shadow atlas ------------------------------------------------------------

def _atlas_roundrobin(scene: SceneGPU, lights: LightsGPU,
                      cfg: config.RenderConfig, mesh: Mesh, n_views: int):
    """Each rank rasterizes its round-robin share of the shadow views (the
    last padded with identity view-projections); one all-gather over the
    world gives every rank the atlas. Returns ((V, S, S, 4) windowed
    atlas, () i32 shadow-bin overflow, () i32 big-triangle overflow), the
    monitors of this rank's views."""
    n = mesh.dp * mesh.sp
    views_local = -(-max(n_views, 1) // n)
    vp = lights.shadow_viewprojs
    eye = torch.eye(4, dtype=F32, device=vp.device)
    vp_pad = torch.cat([vp, eye.expand(views_local * n - vp.shape[0], 4, 4)])
    my_vp = vp_pad[mesh.flat * views_local:(mesh.flat + 1) * views_local]
    world = framelib.world_positions(scene)
    wh = torch.cat([world, torch.ones_like(world[:, :1])], dim=1)
    clip_views = torch.einsum("vj,sij->svi", wh, my_vp)
    local, overflow, big = shadows.render_shadow_views(
        clip_views, scene.tri_vidx, scene.tri_shadow, cfg.shadow_size,
        cfg.shadow_tile, cfg.shadow_bin_capacity, cfg.bin_big_capacity)
    atlas = _all_gather(local, mesh.world, n).flatten(0, 1)[:n_views]
    win = shadows.window_depth_maps(atlas)
    if cfg.shadow_bf16:
        win = win.to(torch.bfloat16)
    return win, overflow, big


def render_shadow_atlas_sharded(scene: SceneGPU, lights: LightsGPU,
                                cfg: config.RenderConfig, mesh: Mesh):
    """The shadow atlas rendered once over the grid (round-robin views, one
    all-gather), on every rank, with its shadow-bin and big-triangle
    overflow monitors reduced over the world: the multi-device
    ``frame.render_shadow_atlas``. The views depend on the scene and the
    lights only, so a caller keeps the atlas across frames and passes it
    to :func:`render_frame_sharded`, as the single-card engine does."""
    _no_tf32()
    atlas, overflow, big = _atlas_roundrobin(scene, lights, cfg, mesh,
                                             cfg.num_shadow_views)
    m = _max_over_world(mesh, torch.stack([overflow, big]).to(I32))
    return atlas, m[0], m[1]


def _no_tf32() -> None:
    # the plane and shadow matrix products stay full float32, as in
    # frame.render_frame
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---- the frame ---------------------------------------------------------------

def render_frame_sharded(scene: SceneGPU, pool, lights: LightsGPU,
                         camera_raw_batch: torch.Tensor, params: torch.Tensor,
                         env: Optional[framelib.EnvGPU],
                         cfg: config.RenderConfig, mesh: Mesh,
                         atlas: Optional[torch.Tensor] = None,
                         proj_h: Optional[int] = None) -> ShardedFrameOutput:
    """Render a batch of B views over the grid; every rank of the world
    calls it with the same arguments and returns the whole frame.

    ``camera_raw_batch`` (B, 83), B a multiple of dp; ``cfg`` from
    :func:`sharded_config`. ``atlas``: a windowed shadow atlas kept from
    :func:`render_shadow_atlas_sharded` (or ``frame.render_shadow_atlas``);
    None renders it in the frame (round-robin views)."""
    _no_tf32()
    dp, sp = mesh.dp, mesh.sp
    B = camera_raw_batch.shape[0]
    if B % dp != 0:
        raise ValueError(f"camera batch {B} not divisible by dp={dp}")
    if cfg.render_scale_pct != 100:
        return _render_frame_sharded_scaled(scene, pool, lights,
                                            camera_raw_batch, params, env,
                                            cfg, mesh, atlas)
    if cfg.tiles_y % sp != 0:
        raise ValueError(f"tiles_y={cfg.tiles_y} not divisible by sp={sp}; "
                         "use sharded_config() to pad the height")
    band_h = cfg.padded_height // sp
    n_views = cfg.num_shadow_views if cfg.enable_shadows else 0

    zero = torch.zeros((), dtype=I32, device=camera_raw_batch.device)
    shadow_ovf = shadow_big = zero
    if atlas is None and n_views > 0:
        atlas, shadow_ovf, shadow_big = _atlas_roundrobin(scene, lights, cfg,
                                                          mesh, n_views)

    Bl = B // dp
    bands = [_render_band(scene, pool, lights, atlas, cam, params, env, cfg,
                          mesh, band_h, proj_h)
             for cam in camera_raw_batch[mesh.dp_i * Bl:(mesh.dp_i + 1) * Bl]]
    sdr, pick, depth, hdr = (torch.stack([b[i] for b in bands])
                             for i in range(4))
    mon = torch.stack([b[4] for b in bands])             # (Bl, 8)
    # the sky's blocks are summed over a frame's bands (below), the
    # other monitors reduced by max over bands, cameras and ranks
    mon[:, 7] = shadow_ovf
    mon[:, 3] = torch.maximum(mon[:, 3], shadow_big)
    sky = mon[:, 6].clone()
    dist.all_reduce(sky, group=mesh.sp_group)
    mon[:, 6] = sky
    m = _max_over_world(mesh, mon.amax(dim=0))
    H, W = cfg.height, cfg.width
    sdr, pick, depth, hdr = (t[:, :H, :W] for t in
                             _gather_frames(mesh, [sdr, pick, depth, hdr]))
    return ShardedFrameOutput(
        sdr=sdr, pick_id=pick, depth=depth, hdr=hdr, bin_overflow=m[0],
        shadow_overflow=m[7], tex_overflow=m[1:3], big_overflow=m[3],
        shadow_blocks=m[4], stream_overflow=m[5], sky_blocks=m[6])


def _render_frame_sharded_scaled(scene, pool, lights, camera_raw_batch,
                                 params, env, cfg, mesh, atlas):
    """Reduced internal resolution, as ``frame.render_frame``: the bands
    render at the scaled size, the projection mapped onto the single-card
    padded height of that size so that the rows the band division pads on
    lie below the frame; the gathered frame is cropped to the scaled size,
    its HDR resized bilinearly and tone-mapped at full size, pick ids and
    depth resized nearest."""
    lo0 = framelib.scaled_config(cfg)
    out = render_frame_sharded(scene, pool, lights, camera_raw_batch, params,
                               env, sharded_config(lo0, mesh.sp), mesh,
                               atlas, proj_h=lo0.padded_height)
    B, H, W = out.sdr.shape[0], cfg.height, cfg.width
    lh, lw = lo0.height, lo0.width
    hdr = post.resize_linear(out.hdr[:, :lh, :lw], (B, H, W, 3))
    sdr = post.tone_map(hdr, params[framelib.PARAM_TONE_TYPE],
                        params[framelib.PARAM_EXPOSURE])
    pick, depth = (torch.stack([post.resize_nearest(t, H, W) for t in x])
                   for x in (out.pick_id[:, :lh, :lw], out.depth[:, :lh, :lw]))
    return replace(out, sdr=sdr, pick_id=pick, depth=depth, hdr=hdr)


def compiled_sharded_frame(cfg: config.RenderConfig, mesh: Mesh):
    """The sharded frame bound to ``cfg`` and ``mesh``: ``fn(scene, pool,
    lights, cams, params, env, atlas=None)``. PyTorch compiles nothing
    ahead, so unlike the reference's jitted callable this one is not
    cached."""
    def fn(scene, pool, lights, cams, params, env, atlas=None):
        return render_frame_sharded(scene, pool, lights, cams, params, env,
                                    cfg, mesh, atlas)
    return fn
