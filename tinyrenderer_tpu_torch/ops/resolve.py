"""Visibility-buffer resolve (port of ops/resolve.py): the per-triangle
resolve table, select + eval over dense bins (kernel K2) and over CSR
stream bins (kernel K5), both in ``csrc/select_eval.cu``, the evaluation of
selected rows (K6's output), and the GBuffer assembly of the unfused
chain (material sample and normal mapping).

Every per-triangle quantity folds into one table row: the 1/w denominator
plane, the attribute numerator planes (affine in screen space) as three
component blocks A_x, A_y, A_c, and the flat per-triangle constants. A
pixel's attributes are its winning row's planes evaluated at the pixel
centre, numerator over denominator (perspective-correct interpolation).

The TPU selects each pixel's row with a one-hot matrix product over its
tile's bin because it gathers badly; the winner is always in its tile's
bin, so the port gathers ``table[tri_id]`` directly — the same row,
copied exactly.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import kernels
from . import compact, post, raster, sampling
from .fp import fma_chain, lerp, plane

F32 = torch.float32
I32 = torch.int32

N_ATTR = 14        # world3 uv2 normal3 tangent3 bitangent3
N_ATTR_SLIM = 6    # world3 normal3
ROW_D = 3 * (N_ATTR + 1) + 8        # full layout: 53
ROW_D_SLIM = 3 * (N_ATTR_SLIM + 1) + 7   # slim flat-only layout: 28

K2_LAUNCHES = 0    # CUDA launches of the select + eval kernel
K5_LAUNCHES = 0    # CUDA launches of the stream select + eval kernel


@dataclass
class GBuffer:
    """The unfused chain's per-pixel surface: zero where ``mask`` is off."""

    position: torch.Tensor        # (H, W, 3) world position
    normal: torch.Tensor          # (H, W, 3) normal-mapped shading normal
    albedo: torch.Tensor          # (H, W, 3)
    rough_metal_ao: torch.Tensor  # (H, W, 3)
    depth: torch.Tensor           # (H, W) reverse-Z
    object_id: torch.Tensor       # (H, W) i32, 0 = none
    mask: torch.Tensor            # (H, W) bool: geometry present


@dataclass
class VertexAttrs:
    """Per-vertex interpolation sources (world space)."""

    world: torch.Tensor      # (V, 3)
    uv: torch.Tensor         # (V, 2)
    normal: torch.Tensor     # (V, 3)
    tangent: torch.Tensor    # (V, 3)
    bitangent: torch.Tensor  # (V, 3)

    def rows(self) -> torch.Tensor:
        return torch.cat([self.world, self.uv, self.normal, self.tangent,
                          self.bitangent], dim=1)


def build_gbuffer_table(setup, tri_vidx: torch.Tensor, attrs: VertexAttrs,
                        tri_instance: torch.Tensor,
                        inst_object_id: torch.Tensor,
                        inst_material: torch.Tensor,
                        mat_record: torch.Tensor, mat_flat: torch.Tensor,
                        slim: bool = False) -> torch.Tensor:
    """(T, 53) per-triangle resolve table, or (T, 28) with ``slim``.

    Layout [pw 3 | A_x n | A_y n | A_c n | consts]: full n = 14 attrs
    [world3 uv2 normal3 tangent3 bitangent3] and consts [flat6 record oid];
    slim n = 6 attrs [world3 normal3] and consts [flat6 oid] — the
    flat-only layout, where uv, tangents and the record are never read.
    Rows of invalid triangles are zero."""
    attr_rows = attrs.rows()
    if slim:
        attr_rows = torch.cat([attr_rows[:, 0:3], attr_rows[:, 5:8]], dim=1)
    vidx = tri_vidx.long()
    blocks = [None, None, None]          # A_x, A_y, A_c, channel-first
    pw = [None, None, None]
    for k in range(3):
        iwk = setup.inv_w[:, k]
        awk = attr_rows[vidx[:, k]].T * iwk[None, :]           # (n, T)
        for j in range(3):
            e = setup.rows[:, 3 * k + j]
            term = awk * e[None, :]
            blocks[j] = term if blocks[j] is None else blocks[j] + term
            pw[j] = iwk * e if pw[j] is None else pw[j] + iwk * e
    mat = inst_material.long()[tri_instance.long()]
    consts = [mat_flat[mat].T,
              mat_record[mat].to(F32)[None, :],
              inst_object_id[tri_instance.long()].to(F32)[None, :]]
    if slim:
        consts = [consts[0], consts[2]]
    rows_cf = torch.cat([torch.stack(pw, dim=0)] + blocks + consts, dim=0)
    rows_cf = torch.where(setup.valid[None, :], rows_cf,
                          torch.zeros_like(rows_cf))
    return rows_cf.T.contiguous()


def _layout(D: int) -> tuple[int, int, int]:
    """(n_attr, f32 channels, h channels) of a table width D."""
    if D == ROW_D_SLIM:
        return N_ATTR_SLIM, 4, 9
    if D == ROW_D:
        return N_ATTR, 7, 15
    raise ValueError(f"resolve table width {D} is neither {ROW_D} nor "
                     f"{ROW_D_SLIM}")


def select_eval_ref(tri_id: torch.Tensor, table: torch.Tensor,
                    bf16: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2 (any device).

    (H, W) winner ids + (T, D) table -> channel-first split outputs: slim
    (4, H, W) f32 [world3 oid] + (9, H, W) [normal3 flat6]; full (7, H, W)
    f32 [world3 uv2 record oid] + (15, H, W) [normal3 tangent3 bitangent3
    flat6]. The second output is bf16 with ``bf16`` (round to nearest even),
    else f32. Background pixels (tri_id < 0) select no row: every channel
    is 0, as the reference's empty one-hot sum gives."""
    return _eval_rows(tri_id, tri_id >= 0, table, bf16)


def _eval_rows(tri_id: torch.Tensor, valid: torch.Tensor, table: torch.Tensor,
               bf16: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Evaluate ``table[tri_id]`` where ``valid`` (zeros elsewhere) into
    the split outputs of :func:`select_eval_ref` (the reference's
    ``_write_eval``)."""
    H, W = tri_id.shape
    T, D = table.shape
    n_attr, cf, _ = _layout(D)
    dev = table.device
    row = table[tri_id.clamp(0, T - 1).long()]                    # (H, W, D)
    row = torch.where(valid[..., None], row, torch.zeros((), device=dev))
    acc = row.permute(2, 0, 1)                                    # (D, H, W)
    px = torch.arange(W, dtype=F32, device=dev)[None, None, :] + 0.5
    py = torch.arange(H, dtype=F32, device=dev)[None, :, None] + 0.5
    denom = plane(acc[0:1], acc[1:2], acc[2:3], px, py)
    denom = torch.where(denom.abs() > 1e-20, denom,
                        torch.ones((), device=dev))
    ax, ay, ac = 3, 3 + n_attr, 3 + 2 * n_attr
    planes = 3 * (n_attr + 1)
    attrs = plane(acc[ax:ay], acc[ay:ac], acc[ac:planes], px, py) / denom
    consts = acc[planes:]
    n_vec = cf - (len(consts) - 6)       # f32 attribute prefix: 3 or 5
    outf = torch.cat([attrs[:n_vec], consts[6:]], dim=0).contiguous()
    outh = torch.cat([attrs[n_vec:], consts[:6]], dim=0)
    return outf, outh.to(torch.bfloat16 if bf16 else F32).contiguous()


def select_eval(tri_id: torch.Tensor, table: torch.Tensor,
                bf16: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Select + eval: :func:`select_eval_ref`'s contract. CPU tensors take
    the plain version; CUDA tensors launch K2."""
    if table.device.type == "cpu":
        return select_eval_ref(tri_id, table, bf16)
    global K2_LAUNCHES
    H, W = tri_id.shape
    T, D = table.shape
    n_attr, cf, ch = _layout(D)
    if tri_id.dtype != I32 or table.dtype != F32 or T == 0:
        raise ValueError("select_eval takes i32 tri_id and a non-empty f32 "
                         "table")
    tri_id = tri_id.contiguous()
    table = table.contiguous()
    kernels.require_cuda("select_eval", tri_id, table)
    outf = torch.empty((cf, H, W), dtype=F32, device=table.device)
    outh = torch.empty((ch, H, W), dtype=torch.bfloat16 if bf16 else F32,
                       device=table.device)
    code = kernels.library().tr_select_eval(
        tri_id.data_ptr(), table.data_ptr(), outf.data_ptr(), outh.data_ptr(),
        H, W, T, D, n_attr, int(bf16), kernels.stream_handle(table.device))
    kernels.check("tr_select_eval", code)
    K2_LAUNCHES += 1
    return outf, outh


def _check_stream_shapes(tri_id, sbins, tile_h: int, tile_w: int):
    ty, tx = sbins.counts.shape
    if tuple(tri_id.shape) != (ty * tile_h, tx * tile_w):
        raise ValueError(f"tri_id {tuple(tri_id.shape)} is not the "
                         f"{ty}x{tx} grid of {tile_h}x{tile_w} tiles")
    return ty, tx


def select_eval_stream_ref(tri_id: torch.Tensor, sbins, table: torch.Tensor,
                           tile_h: int, tile_w: int, kmax: int,
                           bf16: bool = True
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K5 (any device): :func:`select_eval_ref`
    over CSR stream bins (``raster.StreamBins``).

    A pixel gets the reference's one-hot sum over its tile's walked window
    (``raster.walked_windows``): the row of the pair whose id is its
    ``tri_id``, or zeros when the window holds no such pair. The stream is
    tile-major and id-minor, so one searchsorted of ``tile * Tp + tri_id``
    into the stream's keys finds the pair."""
    ty, tx = _check_stream_shapes(tri_id, sbins, tile_h, tile_w)
    H, W = tri_id.shape
    n_tiles = ty * tx
    Ls = sbins.ids.shape[0]
    T = table.shape[0]
    dev = table.device
    Tp = 1 << max(T - 1, 1).bit_length()
    keys = torch.where(sbins.ids >= 0,
                       raster.stream_tiles(sbins.starts, Ls) * Tp + sbins.ids,
                       n_tiles * Tp)
    tile = ((torch.arange(H, device=dev) // tile_h)[:, None] * tx
            + (torch.arange(W, device=dev) // tile_w)[None, :])  # (H, W)
    at = torch.searchsorted(keys, tile * Tp + tri_id).clamp(max=Ls - 1)
    _, stop = raster.walked_windows(sbins.starts, Ls, kmax)
    found = ((tri_id >= 0) & (at < stop[tile])
             & (sbins.ids[at] == tri_id))
    return _eval_rows(tri_id, found, table, bf16)


def select_eval_stream(tri_id: torch.Tensor, sbins, table: torch.Tensor,
                       tile_h: int, tile_w: int, kmax: int, bf16: bool = True
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Select + eval over CSR stream bins: :func:`select_eval_stream_ref`'s
    contract (split channel-first outputs, the reference's ``raw=True``).
    CPU tensors take the plain version; CUDA tensors launch K5."""
    if table.device.type == "cpu":
        return select_eval_stream_ref(tri_id, sbins, table, tile_h, tile_w,
                                      kmax, bf16)
    global K5_LAUNCHES
    _, tx = _check_stream_shapes(tri_id, sbins, tile_h, tile_w)
    H, W = tri_id.shape
    D = table.shape[1]
    n_attr, cf, ch = _layout(D)
    if tri_id.dtype != I32 or table.dtype != F32:
        raise ValueError("select_eval_stream takes i32 tri_id and an f32 "
                         "table")
    kb, nb = raster.stream_walk(sbins.ids.shape[0], kmax)
    tri_id = tri_id.contiguous()
    starts = sbins.starts.to(I32).contiguous()
    ids = sbins.ids.to(I32).contiguous()
    table = table.contiguous()
    kernels.require_cuda("select_eval_stream", tri_id, starts, ids, table)
    outf = torch.empty((cf, H, W), dtype=F32, device=table.device)
    outh = torch.empty((ch, H, W), dtype=torch.bfloat16 if bf16 else F32,
                       device=table.device)
    code = kernels.library().tr_select_eval_stream(
        tri_id.data_ptr(), starts.data_ptr(), ids.data_ptr(),
        table.data_ptr(), outf.data_ptr(), outh.data_ptr(), H, W, D, n_attr,
        int(bf16), tx, tile_h, tile_w, kb, nb,
        kernels.stream_handle(table.device))
    kernels.check("tr_select_eval_stream", code)
    K5_LAUNCHES += 1
    return outf, outh


# ---- resolved attributes (the two-pass forward-only frame, the overlay) ----

_AX, _AY, _AC = 3, 3 + N_ATTR, 3 + 2 * N_ATTR     # full-layout plane blocks
_PLANES = 3 * (N_ATTR + 1)
CONST_FLAT, CONST_REC, CONST_OBJ = _PLANES, _PLANES + 6, _PLANES + 7


@dataclass
class ResolvedAttrs:
    """Per-pixel interpolated attributes + per-triangle constants."""

    world: torch.Tensor       # (..., 3)
    uv: torch.Tensor          # (..., 2)
    normal: torch.Tensor      # (..., 3) geometric, normalized
    tangent: torch.Tensor     # (..., 3)
    bitangent: torch.Tensor   # (..., 3)
    flat: torch.Tensor        # (..., 6) material flat params
    record: torch.Tensor      # (...) i32 composite material record
    object_id: torch.Tensor   # (...) i32 (0 = none)
    valid: torch.Tensor       # (...) bool


def _safe_normalize(v: torch.Tensor) -> torch.Tensor:
    """v / max(|v|, 1e-12) over the last (3-wide) axis; the squared length
    summed x, y, z with fused multiply-adds, as the reference's reduction."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    n = fma_chain([(x, x), (y, y), (z, z)], root=True).clamp(min=1e-12)
    return v / n[..., None]


def resolve_attrs_from_sel_at(tri_id: torch.Tensor, sel: torch.Tensor,
                              px: torch.Tensor,
                              py: torch.Tensor) -> ResolvedAttrs:
    """Evaluate selected full-layout table rows sel (..., 53) at explicit
    pixel centres px, py (broadcastable to (..., 1))."""
    denom = plane(sel[..., 0:1], sel[..., 1:2], sel[..., 2:3], px, py)
    denom = torch.where(denom.abs() > 1e-20, denom,
                        torch.ones((), device=sel.device))
    a = plane(sel[..., _AX:_AY], sel[..., _AY:_AC], sel[..., _AC:_PLANES],
              px, py) / denom
    valid = tri_id >= 0
    return ResolvedAttrs(
        world=a[..., 0:3], uv=a[..., 3:5], normal=_safe_normalize(a[..., 5:8]),
        tangent=_safe_normalize(a[..., 8:11]),
        bitangent=_safe_normalize(a[..., 11:14]),
        flat=sel[..., CONST_FLAT:CONST_FLAT + 6],
        record=torch.round(sel[..., CONST_REC]).to(I32),
        object_id=torch.where(valid, torch.round(sel[..., CONST_OBJ]).to(I32),
                              0),
        valid=valid)


def resolve_attrs_from_sel(tri_id: torch.Tensor,
                           sel: torch.Tensor) -> ResolvedAttrs:
    """Evaluate each pixel's selected full-layout row sel (H, W, 53) at its
    pixel centre (the fused raster + resolve path, K6's output)."""
    H, W = tri_id.shape
    px = torch.arange(W, dtype=F32, device=sel.device)[None, :, None] + 0.5
    py = torch.arange(H, dtype=F32, device=sel.device)[:, None, None] + 0.5
    return resolve_attrs_from_sel_at(tri_id, sel, px, py)


def _attrs_from_split(tri_id: torch.Tensor, outf_c: torch.Tensor,
                      outh_c: torch.Tensor) -> ResolvedAttrs:
    """ResolvedAttrs (channel-last fields) from select + eval's split
    channel-first outputs, either layout, outh bf16 or f32. The reference
    assembles its all-f32 single output with ``_attrs_from_single``; the
    port's K2 / K5 always write the split planes (outh in f32 when
    ``bf16`` is off), whose channels are the same values."""
    valid = tri_id >= 0
    f = outf_c.permute(1, 2, 0)
    h = outh_c.to(F32).permute(1, 2, 0)
    if outf_c.shape[0] == 4:         # slim: no uv, tangent frame or record
        n = _safe_normalize(h[..., 0:3])
        return ResolvedAttrs(
            world=f[..., 0:3], uv=torch.zeros(tri_id.shape + (2,),
                                              device=f.device),
            normal=n, tangent=n, bitangent=n, flat=h[..., 3:9],
            record=torch.zeros_like(tri_id),
            object_id=torch.where(valid, torch.round(f[..., 3]).to(I32), 0),
            valid=valid)
    return ResolvedAttrs(
        world=f[..., 0:3], uv=f[..., 3:5], normal=_safe_normalize(h[..., 0:3]),
        tangent=_safe_normalize(h[..., 3:6]),
        bitangent=_safe_normalize(h[..., 6:9]), flat=h[..., 9:15],
        record=torch.round(f[..., 5]).to(I32),
        object_id=torch.where(valid, torch.round(f[..., 6]).to(I32), 0),
        valid=valid)


def resolve_attrs_pallas(tri_id: torch.Tensor, table: torch.Tensor,
                         bf16: bool = False) -> ResolvedAttrs:
    """ResolvedAttrs through select + eval over dense bins (K2). With
    ``bf16`` off it is also the reference's kernel-free tiled resolve
    (``resolve_attrs_tiled``, ``use_pallas=False``): that one-hot product
    over the tile's bin copies the winner's row exactly."""
    return _attrs_from_split(tri_id, *select_eval(tri_id, table, bf16))


def resolve_attrs_stream(tri_id: torch.Tensor, sbins, table: torch.Tensor,
                         tile_h: int, tile_w: int, kmax: int,
                         bf16: bool = False) -> ResolvedAttrs:
    """ResolvedAttrs through select + eval over CSR stream bins (K5)."""
    return _attrs_from_split(tri_id, *select_eval_stream(
        tri_id, sbins, table, tile_h, tile_w, kmax, bf16))


# ---- forward overlay (light billboards, gizmos) ----------------------------

def _forward_overlay_compact(tri_id: torch.Tensor, bins, table: torch.Tensor,
                             pool, tile_h: int, tile_w: int, capacity: int,
                             texture_filter: str, fs: int):
    """The overlay resolved on the compacted tiles that bin a forward
    triangle: (plan, cap, color (cap, P, 3), alpha (cap, P), object_id
    (cap, P) i32, valid (cap, P) bool), P = tile_h * tile_w.

    The reference selects each pixel's table row with a one-hot product
    over its tile's bin; the winner is always in that bin, so the port
    gathers ``table[tri_id]`` (zeros for background pixels and padded
    slots, as the empty one-hot sum). Sprites sample at 1/``fs`` rate with
    a tile-local mip level and a bilinear upsample (edge-clamped, the
    values of the reference's renormalized ``jax.image.resize``)."""
    ty, tx, _ = bins.ids.shape
    T = table.shape[0]
    n_tiles, P = ty * tx, tile_h * tile_w
    cap = capacity if 0 < capacity < n_tiles else n_tiles
    plan = compact.plan_blocks((bins.counts > 0).reshape(n_tiles), cap)
    tid = compact.gather_blocks(compact.to_blocks(tri_id, tile_h, tile_w),
                                plan).reshape(cap, P)
    live = plan.slots >= 0
    sel = table[tid.clamp(0, T - 1).long()]                   # (cap, P, D)
    sel = torch.where((live[:, None] & (tid >= 0))[..., None], sel,
                      torch.zeros((), device=sel.device))
    slot = plan.slots.clamp(min=0)
    p = torch.arange(P, device=tid.device)
    px = ((slot % tx * tile_w)[:, None] + p % tile_w).to(F32) + 0.5
    py = ((slot // tx * tile_h)[:, None] + p // tile_w).to(F32) + 0.5
    r = resolve_attrs_from_sel_at(tid, sel, px[..., None], py[..., None])

    use_tex = r.flat[..., 5] > 0.5
    uv_t = r.uv.reshape(cap, tile_h, tile_w, 2)[:, ::fs, ::fs]
    rec_t = r.record.reshape(cap, tile_h, tile_w)[:, ::fs, ::fs]
    lvl = sampling.mip_level_from_uv(uv_t, pool.level_sizes[0])
    tex = sampling.sample_pool_mip(pool, rec_t, uv_t, lvl,
                                   filter=texture_filter,
                                   duv=sampling.pool_duv(pool, uv_t))
    if fs > 1:
        tex = post.upsample_axis(post.upsample_axis(tex, fs, 1), fs, 2)
    tex = tex.reshape(cap, P, -1)
    color = torch.where(use_tex[..., None], tex[..., :3], r.flat[..., 0:3])
    alpha = torch.where(use_tex, tex[..., 3], 1.0) * r.valid.to(F32)
    oid = torch.where(r.valid, r.object_id, 0)
    return plan, cap, color, alpha, oid, r.valid


def forward_overlay_tiles(tri_id: torch.Tensor, bins, table: torch.Tensor,
                          pool, tile_h: int, tile_w: int, capacity: int,
                          texture_filter: str = "dithered", fs: int = 2):
    """The compacted overlay scattered back to image shape: (color (H, W,
    3), alpha (H, W), object_id (H, W) i32, valid (H, W) bool, needed ()
    i32 occupied-tile monitor). Tiles without a forward triangle get 0."""
    H, W = tri_id.shape
    plan, cap, color, alpha, oid, valid = _forward_overlay_compact(
        tri_id, bins, table, pool, tile_h, tile_w, capacity, texture_filter,
        fs)

    def scatter(x):
        x = x.reshape((cap, tile_h, tile_w) + x.shape[2:])
        return compact.from_blocks(compact.scatter_blocks(x, plan), H, W)

    return (scatter(color), scatter(alpha), scatter(oid), scatter(valid),
            plan.needed)


def forward_overlay_compose(hdr: torch.Tensor, pick: torch.Tensor,
                            tri_id: torch.Tensor, bins, table: torch.Tensor,
                            pool, tile_h: int, tile_w: int, capacity: int,
                            texture_filter: str = "dithered", fs: int = 2):
    """Composite the overlay into (hdr (H, W, 3), pick (H, W) i32) on its
    compacted tiles -> (hdr, pick, needed () i32).

    The reference walks the slots with a scan of per-tile read-modify-
    writes; here one gather reads every slot's tile and one scatter writes
    it back. A padded slot (no tile) points at tile 0 in the plan: it
    would write back tile 0's old pixels over a live tile 0's composite,
    so its pixels go to a spare row past the image instead. Outside the
    occupied tiles hdr and pick pass through untouched."""
    H, W = tri_id.shape
    ty, tx, _ = bins.ids.shape
    plan, cap, color, alpha, oid, valid = _forward_overlay_compact(
        tri_id, bins, table, pool, tile_h, tile_w, capacity, texture_filter,
        fs)
    slot = plan.slots.clamp(min=0).long()
    dev = hdr.device
    ys = (slot // tx * tile_h)[:, None] + torch.arange(tile_h, device=dev)
    xs = (slot % tx * tile_w)[:, None] + torch.arange(tile_w, device=dev)
    lin = (ys[:, :, None] * W + xs[:, None, :]).reshape(cap, -1)
    lin = torch.where((plan.slots >= 0)[:, None], lin, H * W)
    hdr_f = torch.cat([hdr.reshape(H * W, 3), hdr.new_zeros(1, 3)])
    pick_f = torch.cat([pick.reshape(H * W), pick.new_zeros(1)])
    hdr_f[lin] = lerp(hdr_f[lin], color, alpha[..., None])
    pick_f[lin] = torch.where(valid & (alpha > 0.5), oid, pick_f[lin])
    return (hdr_f[:H * W].reshape(H, W, 3), pick_f[:H * W].reshape(H, W),
            plan.needed)


# ---- GBuffer assembly of the unfused chain ---------------------------------

def resolve_gbuffer_from_attrs(r: ResolvedAttrs, tri_id: torch.Tensor,
                               depth: torch.Tensor,
                               pool: sampling.TexturePoolGPU,
                               texture_filter: str = "dithered",
                               texture_scale: int = 1,
                               tex_block_capacity: int = 0,
                               sample_textures: bool = True
                               ) -> tuple[GBuffer, torch.Tensor]:
    """Material evaluation + GBuffer assembly -> (GBuffer, () i32 blocks
    the compacted material sample wanted).

    The composite record pool holds [albedo rgba | normal rgb | rough |
    metal] a texel, so the whole material is one mip-filtered sample,
    block-compacted onto the textured pixels. ``texture_scale`` s > 1
    samples every s-th pixel in both axes on the blocks of a dilated
    textured mask and upsamples bilinearly (integer factor).
    ``sample_textures`` False (a statically flat-only scene) takes the
    flat parameters and the geometric normal."""
    valid = r.valid
    vm = valid[..., None]
    zero = torch.zeros((), device=depth.device)

    def assemble(normal, albedo, rough, metal, needed):
        rma = torch.stack([rough, metal, torch.ones_like(rough)], dim=-1)
        return GBuffer(position=torch.where(vm, r.world, zero),
                       normal=torch.where(vm, normal, zero),
                       albedo=torch.where(vm, albedo, zero),
                       rough_metal_ao=torch.where(vm, rma, zero), depth=depth,
                       object_id=r.object_id, mask=valid), needed

    flat = r.flat
    if not sample_textures:
        return assemble(r.normal, flat[..., 0:3], flat[..., 3], flat[..., 4],
                        torch.zeros((), dtype=I32, device=depth.device))
    use_tex = flat[..., 5] > 0.5
    if texture_scale > 1:
        s = texture_scale
        H, W = tri_id.shape
        uv_lo, rec_lo = r.uv[::s, ::s], r.record[::s, ::s]
        need_lo = compact.dilate_mask(
            compact.to_blocks(use_tex & valid, s, s).flatten(1).any(dim=1)
            .reshape(H // s, W // s))
        level = sampling.mip_level_from_uv(uv_lo, pool.level_sizes[0])
        rec, needed = compact.sample_pool_compacted(
            pool, rec_lo, uv_lo, level, need_lo, tex_block_capacity,
            filter=texture_filter, duv=sampling.pool_duv(pool, uv_lo))
        rec = post.upsample_bilinear_int(rec, s, s)
    else:
        level = sampling.mip_level_from_uv(r.uv, pool.level_sizes[0])
        rec, needed = compact.sample_pool_compacted(
            pool, r.record, r.uv, level, use_tex & valid, tex_block_capacity,
            filter=texture_filter, duv=sampling.pool_duv(pool, r.uv))
    nt = rec[..., 4:7] * 2.0 - 1.0
    n_mapped = _safe_normalize(fma_chain([(nt[..., 1:2], r.bitangent),
                                          (nt[..., 0:1], r.tangent),
                                          (nt[..., 2:3], r.normal)]))
    u = use_tex[..., None]
    return assemble(torch.where(u, n_mapped, r.normal),
                    torch.where(u, rec[..., 0:3], flat[..., 0:3]),
                    torch.where(use_tex, rec[..., 7], flat[..., 3]),
                    torch.where(use_tex, rec[..., 8], flat[..., 4]), needed)


def resolve_attrs_onehot(tri_id: torch.Tensor, setup, tri_vidx: torch.Tensor,
                         tri_instance: torch.Tensor, attrs: VertexAttrs,
                         inst_object_id: torch.Tensor,
                         inst_material: torch.Tensor,
                         mat_record: torch.Tensor, mat_flat: torch.Tensor,
                         bf16: bool = False) -> ResolvedAttrs:
    """The two-pass resolve of the reference's unfused band: the full
    table, then select + eval (K2), which takes each pixel's winner from
    ``tri_id`` and so needs no bin ids. ``bf16`` only where the reference
    resolves through its kernel (``use_pallas``); its kernel-free tiled
    resolve is the float32 select."""
    table = build_gbuffer_table(setup, tri_vidx, attrs, tri_instance,
                                inst_object_id, inst_material, mat_record,
                                mat_flat)
    return resolve_attrs_pallas(tri_id, table, bf16=bf16)


def resolve_gbuffer_onehot(tri_id: torch.Tensor, depth: torch.Tensor, setup,
                           tri_vidx: torch.Tensor, tri_instance: torch.Tensor,
                           attrs: VertexAttrs, inst_object_id: torch.Tensor,
                           inst_material: torch.Tensor,
                           mat_record: torch.Tensor, mat_flat: torch.Tensor,
                           pool, texture_filter: str = "dithered",
                           texture_scale: int = 1,
                           tex_block_capacity: int = 0, bf16: bool = False,
                           sample_textures: bool = True
                           ) -> tuple[GBuffer, torch.Tensor]:
    """:func:`resolve_attrs_onehot`, then the GBuffer assembly
    (:func:`resolve_gbuffer_from_attrs`)."""
    r = resolve_attrs_onehot(tri_id, setup, tri_vidx, tri_instance, attrs,
                             inst_object_id, inst_material, mat_record,
                             mat_flat, bf16=bf16)
    return resolve_gbuffer_from_attrs(r, tri_id, depth, pool, texture_filter,
                                      texture_scale, tex_block_capacity,
                                      sample_textures)


# ---- the readable spec (not on any frame path) ------------------------------

def interpolate(tri_id: torch.Tensor, setup_rows: torch.Tensor,
                tri_vidx: torch.Tensor, attr_rows: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Perspective-correct attribute interpolation by per-pixel gathers.

    tri_id (H, W) i32 (-1 none); setup_rows (T, 16); tri_vidx (T, 3);
    attr_rows (V, C) -> ((H, W, C) attributes, (H, W) valid mask).
    REFERENCE IMPLEMENTATION, as the reference's: not on any frame path."""
    H, W = tri_id.shape
    valid = tri_id >= 0
    tid = tri_id.clamp(min=0).long()
    rows = setup_rows[tid]                                    # (H, W, 16)
    px = (torch.arange(W, dtype=F32, device=rows.device) + 0.5)[None, :]
    py = (torch.arange(H, dtype=F32, device=rows.device) + 0.5)[:, None]
    lam = torch.stack([rows[..., 3 * k] * px + rows[..., 3 * k + 1] * py
                       + rows[..., 3 * k + 2] for k in range(3)], dim=-1)
    lam_p = lam * rows[..., 13:16]
    denom = lam_p.sum(dim=-1, keepdim=True)
    bary = lam_p / torch.where(denom.abs() > 1e-20, denom,
                               torch.ones_like(denom))
    attrs = attr_rows[tri_vidx.long()[tid]]                   # (H, W, 3, C)
    return torch.einsum("hwk,hwkc->hwc", bary, attrs), valid


def resolve_gbuffer(tri_id: torch.Tensor, depth: torch.Tensor,
                    setup_rows: torch.Tensor, tri_vidx: torch.Tensor,
                    tri_instance: torch.Tensor, attrs: VertexAttrs,
                    inst_object_id: torch.Tensor, inst_material: torch.Tensor,
                    mat_tex_slots: torch.Tensor, mat_flat: torch.Tensor,
                    pool) -> GBuffer:
    """Full GBuffer resolve with material evaluation, by per-pixel gathers
    of the vertex attributes, materials and the per-texture pool
    (``ScenePacker.scalar_pool_gpu``).

    REFERENCE IMPLEMENTATION, as the reference's: not on any frame path.
    It is the readable spec of what the frame's resolve (the table, select
    + eval, :func:`resolve_gbuffer_from_attrs`) computes.

    mat_tex_slots (M, 4) i32 [albedo, normal, roughness, metalness];
    mat_flat (M, 6) [albedo rgb, roughness, metalness, use_textures]."""
    interp, valid = interpolate(tri_id, setup_rows, tri_vidx, attrs.rows())
    world, uv = interp[..., 0:3], interp[..., 3:5]
    n_geom = _safe_normalize(interp[..., 5:8])
    tangent = _safe_normalize(interp[..., 8:11])
    bitangent = _safe_normalize(interp[..., 11:14])

    inst = tri_instance.long()[tri_id.clamp(min=0).long()]
    mat = inst_material.long()[inst]                          # (H, W)
    slots = mat_tex_slots[mat]                                # (H, W, 4)
    flat = mat_flat[mat]                                      # (H, W, 6)
    use_tex = flat[..., 5] > 0.5

    level = sampling.mip_level_from_uv(uv, pool.level_sizes[0])
    duv = sampling.pool_duv(pool, uv)

    def tap(i):
        return sampling.sample_pool_mip(pool, slots[..., i], uv, level,
                                        duv=duv)

    albedo_t = tap(0)[..., :3]
    normal_t = tap(1)[..., :3]
    rough_t = tap(2)[..., 0]
    metal_t = tap(3)[..., 0]
    # TBN normal mapping
    nt = normal_t * 2.0 - 1.0
    n_mapped = _safe_normalize(nt[..., 0:1] * tangent
                               + nt[..., 1:2] * bitangent
                               + nt[..., 2:3] * n_geom)
    u = use_tex[..., None]
    albedo = torch.where(u, albedo_t, flat[..., 0:3])
    normal = torch.where(u, n_mapped, n_geom)
    rough = torch.where(use_tex, rough_t, flat[..., 3])
    metal = torch.where(use_tex, metal_t, flat[..., 4])
    vm = valid[..., None]
    zero = torch.zeros((), device=depth.device)
    return GBuffer(
        position=torch.where(vm, world, zero),
        normal=torch.where(vm, normal, zero),
        albedo=torch.where(vm, albedo, zero),
        rough_metal_ao=torch.where(
            vm, torch.stack([rough, metal, torch.ones_like(rough)], dim=-1),
            zero),
        depth=depth,
        object_id=torch.where(valid, inst_object_id[inst], 0),
        mask=valid)


def select_rows_onehot(tri_id: torch.Tensor, bin_ids: torch.Tensor,
                       table: torch.Tensor, tile_h: int, tile_w: int
                       ) -> torch.Tensor:
    """Per-pixel row selection: (H, W) winner ids + (ty, tx, K) bin lists +
    (T, D) table -> (H, W, D). The reference selects with a one-hot product
    over each tile's bin; here each pixel gathers ``table[tri_id]`` where
    its id is in its tile's bin, zeros elsewhere: the same rows, copied
    exactly. Not on any frame path (K2 selects the frame's rows)."""
    H, W = tri_id.shape
    ty, tx, K = bin_ids.shape
    tiles = tri_id.reshape(ty, tile_h, tx, tile_w).permute(0, 2, 1, 3)
    tiles = tiles.reshape(ty, tx, tile_h * tile_w)           # (ty, tx, P)
    in_bin = ((tiles[..., None] == bin_ids[:, :, None, :])
              & (bin_ids >= 0)[:, :, None, :]).any(dim=-1)
    sel = table[tiles.clamp(0, table.shape[0] - 1).long()]  # (ty, tx, P, D)
    sel = torch.where(in_bin[..., None], sel, torch.zeros_like(sel))
    sel = sel.reshape(ty, tx, tile_h, tile_w, -1).permute(0, 2, 1, 3, 4)
    return sel.reshape(H, W, -1)
