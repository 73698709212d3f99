"""Tiled visibility-buffer triangle rasterizer (port of ops/raster.py).

1. ``triangle_setup``: one 16-float setup row per triangle (three
   area-normalized edge planes, the reverse-Z depth plane, id + 1, the
   corner 1/w), zeroed when the triangle is masked, behind the near plane,
   culled or degenerate.
2. ``bin_triangles_dense``: per screen tile, the K smallest ids of the
   triangles whose bbox overlaps it.
3. ``rasterize_binned``: the tile raster (kernel K1, ``csrc/raster.cu``):
   per pixel, a reverse-Z max-depth race over the tile's bin, ties broken
   by the larger id. Output: ``tri_id`` (-1 = background) and depth.

Depth is reverse-Z in (0, 1], cleared to 0. Front faces are CCW in NDC,
which is a negative signed area in the y-down screen space.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import kernels
from .fp import fma, plane

F32 = torch.float32
I32 = torch.int32

SETUP_COLS = 16
_E0X, _E1X, _E2X, _ZX, _IDF = 0, 3, 6, 9, 12
W_EPS = 1e-6

# tiles above this many pixels evaluate their planes as a 3-term matrix
# product in the reference (ops/raster.py _VPU_PLANES_MAX_P), which rounds
# differently from the broadcast multiply-adds (see fp.plane)
_VPU_PLANES_MAX_P = 8192
# dense binning only: larger pools take the reference's scatter/stream
# binners, which are not ported yet
_SCATTER_MIN_T = 4096

K1_LAUNCHES = 0   # CUDA launches of the raster kernel


@dataclass
class TriangleSetup:
    rows: torch.Tensor     # (T, 16) f32 setup rows (zeroed when invalid)
    valid: torch.Tensor    # (T,) bool
    bbox: torch.Tensor     # (T, 4) f32: xmin, ymin, xmax, ymax (pixels)
    screen: torch.Tensor   # (T, 3, 2) f32 screen-space corners
    inv_w: torch.Tensor    # (T, 3) f32 per-corner 1/w
    z_ndc: torch.Tensor    # (T, 3) f32 per-corner reverse-Z depth


@dataclass
class Bins:
    ids: torch.Tensor       # (ty, tx, K) i32 triangle ids, -1 padded
    rows: torch.Tensor      # (ty, tx, K, 16) f32 gathered setup rows
    counts: torch.Tensor    # (ty, tx) i32
    overflow: torch.Tensor  # () i32 max triangles wanted by any tile
    big_overflow: torch.Tensor  # () i32, 0 on the dense path


def affine3(a0, x, a1, y, a2, z, a3=None):
    """``a0 * x + a1 * y + a2 * z (+ a3)`` rounded as the reference's
    compiled frame rounds it: ``fma(a2, z, fma(a0, x, a1 * y)) + a3``."""
    r = fma(a2, z, fma(a0, x, a1 * y))
    return r if a3 is None else r + a3


def transform_vertices(positions: torch.Tensor, vert_instance: torch.Tensor,
                       inst_model: torch.Tensor, view_proj: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Object-space positions -> (world (V, 3), clip (V, 4))."""
    m = inst_model.reshape(-1, 16)[vert_instance.long()]          # (V, 16)
    px, py, pz = positions[:, 0], positions[:, 1], positions[:, 2]
    wx, wy, wz = [affine3(m[:, 4 * i], px, m[:, 4 * i + 1], py,
                          m[:, 4 * i + 2], pz, m[:, 4 * i + 3])
                  for i in range(3)]
    vp = view_proj
    clip = [affine3(vp[i, 0], wx, vp[i, 1], wy, vp[i, 2], wz, vp[i, 3])
            for i in range(4)]
    return torch.stack([wx, wy, wz], dim=1), torch.stack(clip, dim=1)


def triangle_setup(clip: torch.Tensor, tri_vidx: torch.Tensor,
                   tri_mask: torch.Tensor, width: int, height: int,
                   cull: str = "back") -> TriangleSetup:
    """Per-triangle raster setup rows from clip-space vertex positions.

    cull: 'back' keeps CCW (NDC) front faces, 'front' keeps back faces (the
    shadow passes), 'none' keeps both."""
    vidx = tri_vidx.long()
    cs = [clip[vidx[:, k]] for k in range(3)]                     # (T, 4) x3
    ws = [c[:, 3] for c in cs]
    w_ok = (ws[0] > W_EPS) & (ws[1] > W_EPS) & (ws[2] > W_EPS)
    inv_ws = [1.0 / torch.where(w.abs() > W_EPS, w, torch.ones_like(w))
              for w in ws]
    sxs = [(c[:, 0] * iw * 0.5 + 0.5) * width for c, iw in zip(cs, inv_ws)]
    sys_ = [(0.5 - c[:, 1] * iw * 0.5) * height for c, iw in zip(cs, inv_ws)]
    zs = [c[:, 2] * iw for c, iw in zip(cs, inv_ws)]

    x0, x1, x2 = sxs
    y0, y1, y2 = sys_
    # products that feed a sum are fused as the reference's compiled frame
    # fuses them (ops/fp.py); the unfused form differs in the last bit
    area2 = fma(x1 - x0, y2 - y0, -((x2 - x0) * (y1 - y0)))
    if cull == "back":
        face_ok = area2 < 0.0
    elif cull == "front":
        face_ok = area2 > 0.0
    elif cull == "none":
        face_ok = area2.abs() > 0.0
    else:
        raise ValueError(f"unknown cull mode {cull!r}")
    big = area2.abs() > 1e-12
    valid = tri_mask & w_ok & face_ok & big
    inv_area = 1.0 / torch.where(big, area2, torch.ones_like(area2))
    e0x, e0y = (y1 - y2) * inv_area, (x2 - x1) * inv_area
    e0c = fma(x1, y2, -(x2 * y1)) * inv_area
    e1x, e1y = (y2 - y0) * inv_area, (x0 - x2) * inv_area
    e1c = fma(x2, y0, -(x0 * y2)) * inv_area
    e2x, e2y = (y0 - y1) * inv_area, (x1 - x0) * inv_area
    e2c = fma(x0, y1, -(x1 * y0)) * inv_area
    zx = fma(e2x, zs[2], fma(e1x, zs[1], e0x * zs[0]))
    zy = affine3(e0y, zs[0], e1y, zs[1], e2y, zs[2])
    zc = fma(e2c, zs[2], fma(e1c, zs[1], e0c * zs[0]))
    idf = torch.arange(1, tri_vidx.shape[0] + 1, dtype=F32,
                       device=clip.device)
    rows = torch.stack([e0x, e0y, e0c, e1x, e1y, e1c, e2x, e2y, e2c,
                        zx, zy, zc, idf, inv_ws[0], inv_ws[1], inv_ws[2]],
                       dim=1)
    rows = torch.where(valid[:, None], rows, torch.zeros_like(rows))
    bbox = torch.stack([torch.minimum(torch.minimum(x0, x1), x2),
                        torch.minimum(torch.minimum(y0, y1), y2),
                        torch.maximum(torch.maximum(x0, x1), x2),
                        torch.maximum(torch.maximum(y0, y1), y2)], dim=1)
    screen = torch.stack([torch.stack(sxs, dim=1), torch.stack(sys_, dim=1)],
                         dim=2)                                  # (T, 3, 2)
    return TriangleSetup(rows=rows, valid=valid, bbox=bbox, screen=screen,
                         inv_w=torch.stack(inv_ws, dim=1),
                         z_ndc=torch.stack(zs, dim=1))


def _tile_ranges(setup: TriangleSetup, width: int, height: int,
                 tile_h: int, tile_w: int, tiles_y: int, tiles_x: int):
    """Per-triangle covered tile range [tymin..tymax] x [txmin..txmax] + ok."""
    b = setup.bbox

    def cell(v, size, n):
        return torch.floor(v / size).clamp(0, n - 1).to(I32)

    txmin, tymin = cell(b[:, 0], tile_w, tiles_x), cell(b[:, 1], tile_h, tiles_y)
    txmax, tymax = cell(b[:, 2], tile_w, tiles_x), cell(b[:, 3], tile_h, tiles_y)
    onscreen = ((b[:, 2] >= 0) & (b[:, 0] < width)
                & (b[:, 3] >= 0) & (b[:, 1] < height))
    return txmin, tymin, txmax, tymax, setup.valid & onscreen


def bin_triangles_dense(setup: TriangleSetup, width: int, height: int,
                        tile_h: int, tile_w: int, capacity: int) -> Bins:
    """Per tile, the ``capacity`` smallest ids (ascending) of the triangles
    whose bbox overlaps it, from a dense (tiles, T) hit tensor."""
    tiles_y = -(-height // tile_h)
    tiles_x = -(-width // tile_w)
    T = setup.rows.shape[0]
    dev = setup.rows.device
    txmin, tymin, txmax, tymax, ok = _tile_ranges(
        setup, width, height, tile_h, tile_w, tiles_y, tiles_x)
    ty = torch.arange(tiles_y, dtype=I32, device=dev)[:, None, None]
    tx = torch.arange(tiles_x, dtype=I32, device=dev)[None, :, None]
    hit = (ok & (ty >= tymin) & (ty <= tymax)
           & (tx >= txmin) & (tx <= txmax))                     # (ty, tx, T)
    counts_full = hit.sum(dim=2, dtype=I32)
    order = torch.where(hit, torch.arange(T, dtype=I32, device=dev),
                        torch.full((), T, dtype=I32, device=dev))
    if T < capacity:   # pad so every tile has `capacity` slots
        order = torch.nn.functional.pad(order, (0, capacity - T), value=T)
        topk = torch.sort(order, dim=2).values[:, :, :capacity]
    else:              # the K smallest ids without a full per-tile sort
        topk = torch.topk(order, capacity, dim=2, largest=False,
                          sorted=True).values
    ids = torch.where(topk < T, topk, torch.full_like(topk, -1))
    rows = setup.rows[ids.clamp(0, max(T - 1, 0)).long()]
    rows = torch.where((ids >= 0)[..., None], rows, torch.zeros_like(rows))
    return Bins(ids=ids, rows=rows, counts=counts_full.clamp(max=capacity),
                overflow=counts_full.max(),
                big_overflow=torch.zeros((), dtype=I32, device=dev))


def bin_triangles(setup: TriangleSetup, width: int, height: int,
                  tile_h: int, tile_w: int, capacity: int) -> Bins:
    """Dense binning; pools above 4096 triangles are not ported yet."""
    T = setup.rows.shape[0]
    if T > _SCATTER_MIN_T:
        raise NotImplementedError(
            f"triangle pool {T} > {_SCATTER_MIN_T} needs the scatter/stream "
            "binners and kernels K4/K5 (ROADMAP.md queue 1 item 13)")
    return bin_triangles_dense(setup, width, height, tile_h, tile_w,
                               capacity)


def _untile(tiles: torch.Tensor) -> torch.Tensor:
    ty, tx, th, tw = tiles.shape
    return tiles.permute(0, 2, 1, 3).reshape(ty * th, tx * tw)


def rasterize_binned_ref(bins: Bins, tile_h: int, tile_w: int,
                         chunk: int = 32) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1 (any device): the Pallas kernel's chunked
    depth race, run for all tiles at once, ``chunk`` bin rows at a time.

    Semantics are the kernel's (init ``best_z = 0``): a covered pixel whose
    depth is exactly 0 still wins on its id."""
    ty, tx, K, _ = bins.rows.shape
    dev = bins.rows.device
    P = tile_h * tile_w
    mxu = P > _VPU_PLANES_MAX_P
    p = torch.arange(P, device=dev)
    px = ((p % tile_w)[None, :] + torch.arange(tx, device=dev)[:, None]
          * tile_w).to(F32)[None, :, None, :] + 0.5              # (1, tx, 1, P)
    py = ((p // tile_w)[None, :] + torch.arange(ty, device=dev)[:, None]
          * tile_h).to(F32)[:, None, None, :] + 0.5              # (ty, 1, 1, P)
    best_z = torch.zeros((ty, tx, P), dtype=F32, device=dev)
    best_id = torch.zeros((ty, tx, P), dtype=F32, device=dev)
    kk = torch.arange(K, device=dev)
    live = kk[None, None, :] < bins.counts[..., None]            # (ty, tx, K)
    for c0 in range(0, K, chunk):
        s = bins.rows[:, :, c0:c0 + chunk, :, None]              # (.., c, 16, 1)

        def ev(lo):
            return plane(s[:, :, :, lo], s[:, :, :, lo + 1], s[:, :, :, lo + 2],
                         px, py, mxu)

        idf = s[:, :, :, _IDF]
        covered = ((ev(_E0X) >= 0.0) & (ev(_E1X) >= 0.0) & (ev(_E2X) >= 0.0)
                   & (idf > 0.0) & live[:, :, c0:c0 + chunk, None])
        cand = torch.where(covered, ev(_ZX), torch.full((), -1.0, device=dev))
        chunk_z = cand.max(dim=2).values                          # (ty, tx, P)
        chunk_id = torch.where(cand >= chunk_z[:, :, None], idf,
                               torch.zeros((), device=dev)).max(dim=2).values
        upd = (chunk_z > best_z) | ((chunk_z == best_z) & (chunk_id > best_id))
        best_z = torch.where(upd, chunk_z, best_z)
        best_id = torch.where(upd, chunk_id, best_id)
    tri_id = best_id.to(I32) - 1
    return (_untile(tri_id.reshape(ty, tx, tile_h, tile_w)),
            _untile(best_z.reshape(ty, tx, tile_h, tile_w)))


def rasterize_binned(bins: Bins, tile_h: int, tile_w: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Visibility raster over pre-binned tiles -> (tri_id (H', W') i32 with
    -1 = background, depth (H', W') f32), H' = ty * tile_h, W' = tx * tile_w.

    CPU tensors take :func:`rasterize_binned_ref`; CUDA tensors launch K1."""
    if bins.rows.device.type == "cpu":
        return rasterize_binned_ref(bins, tile_h, tile_w)
    global K1_LAUNCHES
    ty, tx, K, cols = bins.rows.shape
    if (cols != SETUP_COLS or bins.rows.dtype != F32
            or tuple(bins.counts.shape) != (ty, tx)):
        raise ValueError(f"raster takes (ty, tx, K, 16) f32 rows and (ty, tx) "
                         f"counts, got {tuple(bins.rows.shape)} "
                         f"{bins.rows.dtype}, {tuple(bins.counts.shape)}")
    counts = bins.counts.to(I32).contiguous()
    rows = bins.rows.contiguous()
    kernels.require_cuda("rasterize_binned", counts, rows)
    H, W = ty * tile_h, tx * tile_w
    tri_id = torch.empty((H, W), dtype=I32, device=rows.device)
    depth = torch.empty((H, W), dtype=F32, device=rows.device)
    lib = kernels.library()
    code = lib.tr_raster(counts.data_ptr(), rows.data_ptr(), tri_id.data_ptr(),
                         depth.data_ptr(), ty * tx, tx, tile_h, tile_w, K, W,
                         int(tile_h * tile_w > _VPU_PLANES_MAX_P),
                         kernels.stream_handle(rows.device))
    kernels.check("tr_raster", code)
    K1_LAUNCHES += 1
    return tri_id, depth


def rasterize(clip: torch.Tensor, tri_vidx: torch.Tensor,
              tri_mask: torch.Tensor, width: int, height: int, tile_h: int,
              tile_w: int, bin_capacity: int, cull: str = "back"):
    """setup -> bin -> tile raster. Returns (tri_id, depth, setup, bins)."""
    setup = triangle_setup(clip, tri_vidx, tri_mask, width, height, cull)
    bins = bin_triangles(setup, width, height, tile_h, tile_w, bin_capacity)
    tri_id, depth = rasterize_binned(bins, tile_h, tile_w)
    return tri_id, depth, setup, bins
