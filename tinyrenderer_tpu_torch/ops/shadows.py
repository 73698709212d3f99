"""Shadow mapping (port of ops/shadows.py): depth-only raster views through
kernel K1, the windowed atlas, and the binary per-light shading gates.

All V = 6P + D shadow views rasterize with the main raster kernel
(``cull='front'``, the reference's acne trick); lookups project through
the same view-projections as the bake. The deferred shading gates each
light on ``shadow > 0``, so a light's visibility is one bit per pixel:
``gate_refined_visibility`` evaluates it on a coarse strided grid and
re-evaluates exactly only the screen blocks along a shadow edge.
"""

from __future__ import annotations

import torch

from . import compact, raster

F32 = torch.float32
I32 = torch.int32

_GATE_BLOCK_DIMS = (8, 32)
# gate compare table: the 2x2 windowed atlas (PCF) below this many bytes,
# the 1-channel min-window map above it; "auto" decides by size, True /
# False force a branch (as the reference's module switch)
_GATE_VIA_MIN = "auto"
_GATE_MIN_TABLE_BYTES = 128 * 1024 * 1024


def render_shadow_views(clip_per_view: torch.Tensor, tri_vidx: torch.Tensor,
                        tri_mask: torch.Tensor, size: int, tile: int,
                        bin_capacity: int
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rasterize V depth-only views -> ((V, S, S) reverse-Z atlas, () i32
    max bin occupancy across views, () i32 big-triangle count (0 on the
    dense path))."""
    views, overflow = [], []
    for v in range(clip_per_view.shape[0]):
        _, depth, _, bins = raster.rasterize(
            clip_per_view[v], tri_vidx, tri_mask, size, size, tile, tile,
            bin_capacity, cull="front")
        views.append(depth)
        overflow.append(bins.overflow)
    zero = torch.zeros((), dtype=I32, device=clip_per_view.device)
    return (torch.stack(views, dim=0),
            torch.stack(overflow).max() if overflow else zero, zero)


def window_depth_maps(atlas: torch.Tensor) -> torch.Tensor:
    """(V, S, S) -> (V, S, S, 4) windows [self | +x | +y | +x+y], clamped at
    the edge, so a 2x2 PCF reads one row."""
    right = torch.cat([atlas[:, :, 1:], atlas[:, :, -1:]], dim=2)
    down = torch.cat([atlas[:, 1:, :], atlas[:, -1:, :]], dim=1)
    diag = torch.cat([down[:, :, 1:], down[:, :, -1:]], dim=2)
    return torch.stack([atlas, right, down, diag], dim=-1)


def gate_min_maps(win: torch.Tensor) -> torch.Tensor:
    """(V, S, S, 4) windowed atlas -> (V, S, S) per-texel window minimum."""
    return win.min(dim=-1).values


def _cube_face(d: torch.Tensor) -> torch.Tensor:
    """Cube-face index (0..5, CUBE_FACE_DIRS order) of the light-to-point
    vector d (..., 3) by its dominant axis."""
    ax = d.abs()
    is_x = (ax[..., 0] >= ax[..., 1]) & (ax[..., 0] >= ax[..., 2])
    is_y = (ax[..., 1] > ax[..., 0]) & (ax[..., 1] >= ax[..., 2])
    w = torch.where
    return w(is_x, w(d[..., 0] >= 0, 0, 1),
             w(is_y, w(d[..., 1] >= 0, 2, 3), w(d[..., 2] >= 0, 4, 5))).to(I32)


def _cube_uvz_closed(d: torch.Tensor, near: float = 0.1, far: float = 100.0):
    """Closed-form cube-face projection of the standard point-light frusta:
    (face, u, v, reverse-Z depth, dominant-axis distance m)."""
    face = _cube_face(d)
    d0, d1, d2 = d[..., 0], d[..., 1], d[..., 2]
    m = d.abs().max(dim=-1).values
    w = torch.where
    x_loc = w(face == 0, d2, w(face == 1, -d2, w(face == 5, d0, -d0)))
    y_loc = w(face == 2, -d2, w(face == 3, d2, d1))
    inv_m = 1.0 / w(m > 1e-9, m, torch.ones_like(m))
    c1 = near / (near - far)
    c2 = -near * far / (near - far)
    u = (x_loc * inv_m) * 0.5 + 0.5
    v = 0.5 - (y_loc * inv_m) * 0.5
    z = (c1 * m + c2) * inv_m
    return face, u, v, z, m


def _ndc_uvz(c: torch.Tensor):
    """Clip (..., 4) -> (u, v, z, w): guarded divide, v flipped."""
    w = c[..., 3]
    inv_w = 1.0 / torch.where(w.abs() > 1e-9, w, torch.ones_like(w))
    ndc = c[..., :3] * inv_w[..., None]
    return ndc[..., 0] * 0.5 + 0.5, 0.5 - ndc[..., 1] * 0.5, ndc[..., 2], w


def _project(world_pos: torch.Tensor, viewproj: torch.Tensor):
    """world (..., 3) -> (u, v, z_ndc, w) under a light view-projection."""
    ph = torch.cat([world_pos, torch.ones_like(world_pos[..., :1])], dim=-1)
    return _ndc_uvz(ph @ viewproj.T)


def _texel(S: int, u: torch.Tensor, v: torch.Tensor):
    fu = u * S - 0.5
    fv = v * S - 0.5
    x0, y0 = torch.floor(fu), torch.floor(fv)
    return (fu - x0, fv - y0, x0.long().clamp(0, S - 1),
            y0.long().clamp(0, S - 1))


def _compare_pcf(shadow_map: torch.Tensor, u, v, ref_z, base=0,
                 bias=0.0) -> torch.Tensor:
    """2x2 PCF 'Greater' comparison against a windowed atlas (..., S, S, 4)
    whose layer is selected by the flat offset ``base``; one row read.
    The atlas may be bf16; the compare runs in f32."""
    S = shadow_map.shape[-2]
    fx, fy, x0, y0 = _texel(S, u, v)
    win = shadow_map.reshape(-1, 4)[base + y0 * S + x0]
    lit = (ref_z[..., None] + bias > win.to(F32)).to(F32)
    w = torch.stack([(1 - fx) * (1 - fy), fx * (1 - fy),
                     (1 - fx) * fy, fx * fy], dim=-1)
    return (lit * w).sum(dim=-1)


def _compare_gate(min_map: torch.Tensor, u, v, ref_z, base=0,
                  bias=0.0) -> torch.Tensor:
    """Binary gate ``ref_z + bias > min(2x2 window)`` against
    :func:`gate_min_maps`' table; same texel addressing as _compare_pcf."""
    S = min_map.shape[-1]
    _, _, x0, y0 = _texel(S, u, v)
    m = min_map.reshape(-1)[base + y0 * S + x0]
    return ref_z + bias > m.to(F32)


def _point_taps(world_pos, light_positions, S: int):
    """Cube-face taps of all P point lights: (P, ...) u, v, z, flat layer
    base, in-front mask."""
    Pn = light_positions.shape[0]
    lp = light_positions.reshape((Pn,) + (1,) * (world_pos.ndim - 1) + (3,))
    face, u, v, z, m = _cube_uvz_closed(world_pos[None] - lp)
    li = torch.arange(Pn, dtype=I32, device=world_pos.device).reshape(
        (Pn,) + (1,) * (world_pos.ndim - 1))
    return u, v, z, ((li * 6 + face) * (S * S)).long(), m > 0.0


def _multi_taps(world_pos, light_positions, dir_viewprojs, S: int):
    """All lights' taps, point lights first: (P + D, ...) u, v, z, flat
    layer base, inside."""
    Pn = light_positions.shape[0] if light_positions is not None else 0
    parts = []
    if Pn:
        parts.append(_point_taps(world_pos, light_positions, S))
    D = dir_viewprojs.shape[0] if dir_viewprojs is not None else 0
    for i in range(D):
        u, v, z, w = _project(world_pos, dir_viewprojs[i])
        inside = (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v <= 1.0) & (w > 0.0)
        base = torch.full(u.shape, (6 * Pn + i) * S * S, dtype=torch.long,
                          device=u.device)
        parts.append((u[None], v[None], z[None], base[None], inside[None]))
    return tuple(torch.cat([p[k] for p in parts]) for k in range(5))


def shadow_multi(world_pos, light_positions, dir_viewprojs,
                 atlas: torch.Tensor, bias=0.0) -> torch.Tensor:
    """Every light's PCF visibility against the windowed atlas (6P + D, S,
    S, 4): (P + D, ...), point lights first; outside the frustum is lit."""
    u, v, z, base, inside = _multi_taps(world_pos, light_positions,
                                        dir_viewprojs, atlas.shape[-2])
    vis = _compare_pcf(atlas, u, v, z, base=base, bias=bias)
    return torch.where(inside, vis, torch.ones_like(vis))


def shadow_multi_gate(world_pos, light_positions, dir_viewprojs,
                      min_map: torch.Tensor, bias=0.0) -> torch.Tensor:
    """:func:`shadow_multi`'s binary gate against the min-window map."""
    u, v, z, base, inside = _multi_taps(world_pos, light_positions,
                                        dir_viewprojs, min_map.shape[-1])
    return _compare_gate(min_map, u, v, z, base=base, bias=bias) | ~inside


def _slot_taps(light_positions, dir_viewprojs, S: int):
    """Tap coordinates of the refinement's (block, light) slots:
    taps(pos_c (K, bh, bw, 3), li_c (K,)) -> (u, v, z, flat base, ok)."""
    Pn = light_positions.shape[0] if light_positions is not None else 0
    D = dir_viewprojs.shape[0] if dir_viewprojs is not None else 0

    def taps(pos_c: torch.Tensor, li_c: torch.Tensor):
        li = li_c.long()
        u = v = z = base = ok = None
        if Pn:
            pi = li.clamp(0, Pn - 1)
            d = pos_c - light_positions[pi][:, None, None, :]
            face, u, v, z, m = _cube_uvz_closed(d)
            base = (pi[:, None, None] * 6 + face) * (S * S)
            ok = m > 0.0
        if D:
            di = (li - Pn).clamp(0, D - 1)
            ph = torch.cat([pos_c, torch.ones_like(pos_c[..., :1])], dim=-1)
            if D == 1:
                c = ph @ dir_viewprojs[0].T
            else:
                c = torch.einsum("khwj,kij->khwi", ph, dir_viewprojs[di])
            ud, vd, zd, w = _ndc_uvz(c)
            based = ((6 * Pn + di) * (S * S))[:, None, None].expand(ud.shape)
            okd = ((ud >= 0.0) & (ud <= 1.0) & (vd >= 0.0) & (vd <= 1.0)
                   & (w > 0.0))
            if Pn:
                is_dir = (li >= Pn)[:, None, None]
                u = torch.where(is_dir, ud, u)
                v = torch.where(is_dir, vd, v)
                z = torch.where(is_dir, zd, z)
                base = torch.where(is_dir, based, base)
                ok = torch.where(is_dir, okd, ok)
            else:
                u, v, z, base, ok = ud, vd, zd, based, okd
        return u, v, z, base, ok

    return taps


def make_vis_slot(light_positions, dir_viewprojs, atlas: torch.Tensor,
                  bias=0.0):
    """vis_slot(pos_c (K, bh, bw, 3), li_c (K,)) -> (K, bh, bw) PCF
    visibility of each slot under its own light (points first)."""
    taps = _slot_taps(light_positions, dir_viewprojs, atlas.shape[-2])

    def vis_slot(pos_c, li_c):
        u, v, z, base, ok = taps(pos_c, li_c)
        vis = _compare_pcf(atlas, u, v, z, base=base, bias=bias)
        return torch.where(ok, vis, torch.ones_like(vis))

    return vis_slot


def make_vis_slot_gate(light_positions, dir_viewprojs,
                       min_map: torch.Tensor, bias=0.0):
    """:func:`make_vis_slot`'s binary variant against the min-window map."""
    taps = _slot_taps(light_positions, dir_viewprojs, min_map.shape[-1])

    def vis_slot_gate(pos_c, li_c):
        u, v, z, base, ok = taps(pos_c, li_c)
        return _compare_gate(min_map, u, v, z, base=base, bias=bias) | ~ok

    return vis_slot_gate


def gate_fns(light_positions, dir_viewprojs, atlas: torch.Tensor, bias=0.0):
    """(vis_all, vis_slot) for :func:`gate_refined_visibility`.

    vis_all(pos (..., 3)) -> (..., L) per-light visibility; vis_slot as
    :func:`make_vis_slot`. Both are read through ``> 0`` only, so atlases
    of at least ``_GATE_MIN_TABLE_BYTES`` compare against the 1-channel
    min-window map; smaller ones against the windowed atlas (PCF)."""
    lp = (light_positions if light_positions is not None
          and light_positions.shape[0] > 0 else None)
    use_min = (_GATE_VIA_MIN if _GATE_VIA_MIN != "auto" else
               atlas.numel() * atlas.element_size() >= _GATE_MIN_TABLE_BYTES)
    if use_min:
        table = gate_min_maps(atlas)
        multi, slot = shadow_multi_gate, make_vis_slot_gate
    else:
        table = atlas
        multi, slot = shadow_multi, make_vis_slot

    def vis_all(p):
        return multi(p, lp, dir_viewprojs, table, bias=bias).movedim(0, -1)

    return vis_all, slot(lp, dir_viewprojs, table, bias=bias)


def _nearest_up(img: torch.Tensor, scale: int, dims: tuple[int, int]):
    return img.repeat_interleave(scale, dim=dims[0]).repeat_interleave(
        scale, dim=dims[1])


def gate_refined_visibility(vis_fn, vis_slot, pos: torch.Tensor, scale: int,
                            block_capacity: int,
                            block_dims: tuple[int, int] | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Binary per-light shadow gates at full resolution from a
    ``scale``-strided coarse pass plus exact re-evaluation of the blocks
    along a shadow edge, batched over all lights in one (light, block)
    work list of ``block_capacity`` slots (0 = every block).

    pos: (H, W, 3). Returns ((L, H, W) f32 0/1 gates, channel-first as the
    fused shading kernel reads them, and () i32 work items wanted)."""
    H, W = pos.shape[:2]
    dev = pos.device
    zero = torch.zeros((), dtype=I32, device=dev)
    if scale <= 1:
        return (vis_fn(pos) > 0.0).to(F32).movedim(-1, 0), zero
    lo = vis_fn(pos[::scale, ::scale]) > 0.0             # (hl, wl, L)
    hl, wl, L = lo.shape
    if hl * scale != H or wl * scale != W:
        raise NotImplementedError(
            "shadow gates need the frame to be a multiple of "
            f"shadow_lookup_scale={scale} (the resize fallback is not "
            "ported)")
    # a cell is on an edge when its gate differs from any 8-neighbour
    padded = torch.nn.functional.pad(
        lo.movedim(-1, 0)[None].to(F32), (1, 1, 1, 1), mode="replicate"
    )[0].movedim(0, -1) > 0.5
    edge = torch.zeros_like(lo)
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            if dy != 1 or dx != 1:
                edge |= lo != padded[dy:dy + hl, dx:dx + wl]
    coarse_up_cf = _nearest_up(lo.movedim(-1, 0).to(F32), scale, (1, 2))

    bh, bw = block_dims or _GATE_BLOCK_DIMS
    if H % bh or W % bw:
        return (vis_fn(pos) > 0.0).to(F32).movedim(-1, 0), zero
    nby, nbx = H // bh, W // bw
    n_blocks = nby * nbx
    n_flat = L * n_blocks
    cap = block_capacity if 0 < block_capacity < n_flat else n_flat
    pos_blocks = compact.to_blocks(pos, bh, bw)          # (N, bh, bw, 3)
    if bh % scale == 0 and bw % scale == 0:
        cy, cx = bh // scale, bw // scale
        edge_blocks = edge.reshape(nby, cy, nbx, cx, L).any(dim=3).any(dim=1)
    else:
        hi_edge = _nearest_up(edge, scale, (0, 1))
        edge_blocks = compact.to_blocks(hi_edge, bh, bw).any(dim=2).any(
            dim=1).reshape(nby, nbx, L)
    plan = compact.plan_blocks(
        edge_blocks.reshape(n_blocks, L).movedim(-1, 0).reshape(n_flat), cap)
    flat = plan.slots.clamp(0, n_flat - 1).long()
    bidx = flat % n_blocks
    li_c = flat // n_blocks
    pos_c = torch.where((plan.slots >= 0)[:, None, None, None],
                        pos_blocks[bidx], torch.zeros((), device=dev))
    exact = (vis_slot(pos_c, li_c) > 0.0).to(F32)        # (K, bh, bw)
    refined = compact.scatter_blocks(exact, plan)        # (n_flat, bh, bw)
    r_all = refined.reshape(L, nby, nbx, bh, bw).movedim(2, 3).reshape(L, H, W)
    sel = (plan.inv >= 0).reshape(L, nby, 1, nbx, 1)
    m_all = sel.expand(L, nby, bh, nbx, bw).reshape(L, H, W)
    return torch.where(m_all, r_all, coarse_up_cf), plan.needed
