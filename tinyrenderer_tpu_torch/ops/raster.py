"""Tiled visibility-buffer triangle rasterizer (port of ops/raster.py).

1. ``triangle_setup``: one 16-float setup row per triangle (three
   area-normalized edge planes, the reverse-Z depth plane, id + 1, the
   corner 1/w), zeroed when the triangle is masked, behind the near plane,
   culled or degenerate.
2. Binning, per screen tile, of the triangles whose bbox overlaps it:
   ``bin_triangles_dense`` (the K smallest ids, pools <= 4096),
   ``bin_triangles_scatter`` (two-level: bigs first, then smalls in
   ascending id, larger pools) and ``bin_triangles_stream`` (CSR: one
   tile-major sorted (tile, id) stream, segments located by ``starts``).
3. The tile raster, per pixel a reverse-Z max-depth race over the tile's
   bin, ties broken by the larger id, output ``tri_id`` (-1 = background)
   and depth: ``rasterize_binned`` over dense bins (kernel K1),
   ``rasterize_stream`` over the stream's walked windows (kernel K4) and
   ``rasterize_resolve_binned`` (kernel K6: K1's race plus the winner's
   resolve-table row, the ``fused_resolve`` configuration), all in
   ``csrc/raster.cu``. The kernels cull before they race: a row is tested
   against a rectangle of pixels first (:func:`rect_rejects`), which
   :func:`rasterize_binned_culled_ref` repeats as plain tensor code so
   that its exactness can be tested without a card.

Depth is reverse-Z in (0, 1], cleared to 0. Front faces are CCW in NDC,
which is a negative signed area in the y-down screen space.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import kernels
from .fp import fma, fma_chain, plane

F32 = torch.float32
I32 = torch.int32

SETUP_COLS = 16
_E0X, _E1X, _E2X, _ZX, _IDF = 0, 3, 6, 9, 12
W_EPS = 1e-6

# tiles above this many pixels evaluate their planes as a 3-term matrix
# product in the reference (ops/raster.py _VPU_PLANES_MAX_P), which rounds
# differently from the broadcast multiply-adds (see fp.plane)
_VPU_PLANES_MAX_P = 8192
# dense/scatter crossover of the binners, and where the stream raster
# takes over the main view (the reference's stream_pays_off)
_SCATTER_MIN_T = 4096
# the stream is walked in blocks of this many rows (the reference's DMA
# block); stream_capacity is a multiple of it
STREAM_BLOCK = 2048

K1_LAUNCHES = 0   # CUDA launches of the raster kernel
K4_LAUNCHES = 0   # CUDA launches of the stream raster kernel
K6_LAUNCHES = 0   # CUDA launches of the raster + resolve kernel


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
    big_overflow: torch.Tensor  # () i32 big-triangle count (0, dense path)


@dataclass
class StreamBins:
    """CSR bins: tile t's bin is ``ids[starts[t]:starts[t + 1]]``, one
    segment of a tile-major, id-minor stream of (tile, id) pairs."""

    ids: torch.Tensor       # (Ls,) i32 triangle ids, -1 padded
    rows: torch.Tensor      # (Ls, 16) f32 gathered setup rows (0 for pad)
    starts: torch.Tensor    # (n_tiles + 1,) i32 segment offsets
    counts: torch.Tensor    # (ty, tx) i32 per-tile pair count
    overflow: torch.Tensor  # () i32 max per-tile count (bin_capacity)
    stream_overflow: torch.Tensor  # () i32 pairs wanted (stream_capacity)
    big_overflow: torch.Tensor     # () i32 big-triangle count


def affine3(a0, x, a1, y, a2, z, a3=None):
    """``a0 * x + a1 * y + a2 * z (+ a3)`` rounded as the reference's
    compiled frame rounds it: ``fma(a2, z, fma(a0, x, a1 * y)) + a3``, one
    launch of the chain kernel on the card."""
    return fma_chain([(a1, y), (a0, x), (a2, z)], d=a3)


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


def _screen_diffs(v: torch.Tensor, p: torch.Tensor, size: int,
                  pairs: list) -> torch.Tensor:
    """(T, len(pairs)) corner differences p_a - p_b of screen coordinates
    p = v * size, rounded as the reference's compiled setup rounds them:
    ``fma(v_a, size, -p_b)`` for each (a, b) of ``pairs``."""
    mul = torch.stack([v[:, i] for i, _ in pairs], 1)
    add = torch.stack([-p[:, j] for _, j in pairs], 1)
    return fma(mul, v.new_full((), float(size)), add)


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
    # corners in [0, 1] viewport units, then screen (T, 3): v * size
    vx = torch.stack([c[:, 0] * iw * 0.5 + 0.5 for c, iw in zip(cs, inv_ws)], 1)
    vy = torch.stack([0.5 - c[:, 1] * iw * 0.5 for c, iw in zip(cs, inv_ws)], 1)
    sx, sy = vx * width, vy * height
    zs = [c[:, 2] * iw for c, iw in zip(cs, inv_ws)]

    x0, x1, x2 = sx.unbind(1)
    y0, y1, y2 = sy.unbind(1)
    # products that feed a sum are fused as the reference's compiled frame
    # fuses them (ops/fp.py); the unfused form differs in the last bit.
    # Corner differences fuse the scaling: x_a - x_b = fma(vx_a, width,
    # -x_b) (exact when the size is a power of two)
    dx10, dx20, dx21, dx02 = _screen_diffs(
        vx, sx, width, [(1, 0), (2, 0), (2, 1), (0, 2)]).unbind(1)
    dy20, dy10, dy12, dy01 = _screen_diffs(
        vy, sy, height, [(2, 0), (1, 0), (1, 2), (0, 1)]).unbind(1)
    area2 = fma(dx10, dy20, -(dx20 * dy10))
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
    e0x, e0y = dy12 * inv_area, dx21 * inv_area
    e1x, e1y = dy20 * inv_area, dx02 * inv_area
    e2x, e2y = dy01 * inv_area, dx10 * inv_area
    # The planes' constants are formed around a corner: a constant from
    # absolute-coordinate cross products x_a*y_b - x_b*y_a cancels for a
    # triangle small beside its distance from the origin (a rounding of
    # ~|x * y| over a doubled area of a few px^2). An edge's constant
    # comes from a vertex of that edge, where the edge function is 0: a
    # slope times a coordinate does not cancel. The depth plane is solved
    # from corners 1 and 2's offsets from corner 0 (of the rounded screen
    # corners, whose differences close: the fused differences above need
    # not sum to 0, and that residue times a depth would tilt the plane),
    # and its constant is corner 0's depth.
    (nx0, nx1, nx2), (ny0, ny1, ny2) = (-sx).unbind(1), (-sy).unbind(1)
    e0c = fma_chain([(e0y, ny1), (e0x, nx1)])
    e1c = fma_chain([(e1y, ny2), (e1x, nx2)])
    e2c = fma_chain([(e2y, ny0), (e2x, nx0)])
    rx1, ry1, nry1, nrx2, ry2 = x1 - x0, y1 - y0, y0 - y1, x0 - x2, y2 - y0
    dz1, dz2 = zs[1] - zs[0], zs[2] - zs[0]
    det = fma_chain([(nrx2, ry1), (rx1, ry2)])      # rx1*ry2 - rx2*ry1
    det = det.masked_fill(det == 0.0, 1.0)
    zx = fma_chain([(dz2, nry1), (dz1, ry2)]) / det
    zy = fma_chain([(nrx2, dz1), (rx1, dz2)]) / det
    zc = fma_chain([(zx, nx0), (zy, ny0)], c=zs[0])
    idf = torch.arange(1, tri_vidx.shape[0] + 1, dtype=F32,
                       device=clip.device)
    rows = torch.stack([e0x, e0y, e0c, e1x, e1y, e1c, e2x, e2y, e2c,
                        zx, zy, zc, idf, inv_ws[0], inv_ws[1], inv_ws[2]],
                       dim=1)
    rows = torch.where(valid[:, None], rows, torch.zeros_like(rows))
    bbox = torch.stack([sx.amin(1), sy.amin(1), sx.amax(1), sy.amax(1)],
                       dim=1)
    screen = torch.stack([sx, sy], dim=2)                        # (T, 3, 2)
    return TriangleSetup(rows=rows, valid=valid, bbox=bbox, screen=screen,
                         inv_w=torch.stack(inv_ws, dim=1),
                         z_ndc=torch.stack(zs, dim=1))


def translate_setup_y(setup: TriangleSetup, y0: float) -> TriangleSetup:
    """The setup of the band of rows from ``y0`` down: its planes evaluated
    at band-local pixel centres (y' = y - y0) give the frame's values. The
    planes are affine, so ``a_y * y0`` folds into each edge's and the
    depth plane's constant, rounded once as the reference's compiled
    function rounds it (``fma(a_y, y0, c)``); bbox and screen y shift by
    ``-y0``."""
    rows = setup.rows.clone()
    y = rows.new_full((), float(y0))
    cols = [x + 2 for x in (_E0X, _E1X, _E2X, _ZX)]
    rows[:, cols] = fma(rows[:, [c - 1 for c in cols]], y, rows[:, cols])
    bbox = setup.bbox.clone()
    bbox[:, 1::2] -= y
    screen = setup.screen.clone()
    screen[:, :, 1] -= y
    return TriangleSetup(rows=rows, valid=setup.valid, bbox=bbox,
                         screen=screen, inv_w=setup.inv_w, z_ndc=setup.z_ndc)


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


def _gather_rows(setup: TriangleSetup, ids: torch.Tensor) -> torch.Tensor:
    """Setup rows of ``ids`` (any shape), zero where an id is -1."""
    T = setup.rows.shape[0]
    rows = setup.rows[ids.clamp(0, max(T - 1, 0)).long()]
    return torch.where((ids >= 0)[..., None], rows, torch.zeros_like(rows))


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
    return Bins(ids=ids, rows=_gather_rows(setup, ids),
                counts=counts_full.clamp(max=capacity),
                overflow=counts_full.max(),
                big_overflow=torch.zeros((), dtype=I32, device=dev))


def _split_small_big(setup: TriangleSetup, width: int, height: int,
                     tile_h: int, tile_w: int, big_capacity: int):
    """Front half of the scatter and stream binners. Triangles whose
    clipped bbox spans at most 2x2 tiles are *small* and expand to <= 4
    (tile, id) pairs ``ekeys``/``eids`` (4T,), invalid pairs keyed to the
    ``n_tiles`` sentinel. The others are *big*: ``big_ids`` (Lc,) holds the
    Lc = min(T, big_capacity) smallest big ids, T-padded, and ``hit_b``
    (ty, tx, Lc) their tile coverage. ``big_overflow``: the big count."""
    tiles_y = -(-height // tile_h)
    tiles_x = -(-width // tile_w)
    n_tiles = tiles_y * tiles_x
    T = setup.rows.shape[0]
    Lc = min(T, big_capacity)     # <= T: the big list never needs padding
    dev = setup.rows.device
    txmin, tymin, txmax, tymax, ok = _tile_ranges(
        setup, width, height, tile_h, tile_w, tiles_y, tiles_x)
    span_x = txmax - txmin + 1
    span_y = tymax - tymin + 1
    small = ok & (span_x <= 2) & (span_y <= 2)
    big = ok & ~small

    tri_ids = torch.arange(T, dtype=I32, device=dev)
    big_ids = torch.sort(torch.where(big, tri_ids, T)).values[:Lc]
    big_overflow = big.sum(dtype=I32)
    safe = big_ids.clamp(0, max(T - 1, 0)).long()
    ty = torch.arange(tiles_y, dtype=I32, device=dev)[:, None, None]
    tx = torch.arange(tiles_x, dtype=I32, device=dev)[None, :, None]
    hit_b = ((big_ids < T) & (ty >= tymin[safe]) & (ty <= tymax[safe])
             & (tx >= txmin[safe]) & (tx <= txmax[safe]))    # (ty, tx, Lc)

    e = torch.arange(4, dtype=I32, device=dev)[:, None]
    ey, ex = e // 2, e % 2
    evalid = small & (ey < span_y) & (ex < span_x)            # (4, T)
    etile = torch.where(evalid, (tymin + ey) * tiles_x + (txmin + ex),
                        n_tiles)
    eids = tri_ids.expand(4, T).reshape(-1)
    return etile.reshape(-1), eids, big_ids, hit_b, big_overflow


def _segment_starts(st: torch.Tensor, n_tiles: int) -> torch.Tensor:
    """(n_tiles + 1,) i32 first index of each tile (and the end) in the
    ascending tile keys ``st`` (searchsorted, side left)."""
    q = torch.arange(n_tiles + 1, dtype=st.dtype, device=st.device)
    return torch.searchsorted(st, q).to(I32)


def bin_triangles_scatter(setup: TriangleSetup, width: int, height: int,
                          tile_h: int, tile_w: int, capacity: int,
                          big_capacity: int = 512) -> Bins:
    """Two-level binning for large pools, O(T log T): the small
    triangles' pairs are sorted once (tile-major, id-minor) and each
    tile's smalls are a segment of that sort; the big list is binned
    densely. A tile's bin holds its bigs (ascending id), then its smalls;
    past ``capacity`` the smalls are cut first."""
    tiles_y = -(-height // tile_h)
    tiles_x = -(-width // tile_w)
    n_tiles = tiles_y * tiles_x
    T = setup.rows.shape[0]
    K = capacity
    ekeys, eids, big_ids, hit_b, big_overflow = _split_small_big(
        setup, width, height, tile_h, tile_w, big_capacity)
    Lc = big_ids.shape[0]
    sorted_b = torch.sort(torch.where(hit_b, big_ids, T), dim=2).values
    sorted_b = sorted_b.reshape(n_tiles, Lc)
    bc = hit_b.sum(dim=2, dtype=I32).reshape(n_tiles)

    # lexicographic (tile, id) order through one int64 key (ids < T)
    key = torch.sort(ekeys.long() * T + eids).values
    st, si = key // T, (key % T).to(I32)
    starts = _segment_starts(st, n_tiles)
    counts_full = bc + (starts[1:] - starts[:-1])
    k = torch.arange(K, dtype=I32, device=setup.rows.device)[None, :]
    if Lc < K:
        big_sec = torch.nn.functional.pad(sorted_b, (0, K - Lc), value=T)
    else:
        big_sec = sorted_b[:, :K]
    sidx = starts[:-1, None] + (k - bc[:, None])
    s_ok = (k >= bc[:, None]) & (k < counts_full[:, None])
    small_sec = si[sidx.clamp(0, max(4 * T - 1, 0)).long()]
    ids = torch.where(k < bc[:, None], big_sec,
                      torch.where(s_ok, small_sec, T))
    ids = torch.where(ids < T, ids, -1).reshape(tiles_y, tiles_x, K)
    return Bins(ids=ids, rows=_gather_rows(setup, ids),
                counts=counts_full.clamp(max=K).reshape(tiles_y, tiles_x),
                overflow=counts_full.max(), big_overflow=big_overflow)


def bin_triangles_stream(setup: TriangleSetup, width: int, height: int,
                         tile_h: int, tile_w: int, stream_capacity: int,
                         big_capacity: int = 512) -> StreamBins:
    """CSR binning: the small triangles' pairs and the big list's covered
    (tile, id) pairs, sorted once into a tile-major, id-minor stream of
    ``stream_capacity`` rows. A longer stream loses its highest tiles'
    pairs (the bottom of the screen); ``stream_overflow`` reports the
    pairs wanted, so the engine grows the capacity."""
    tiles_y = -(-height // tile_h)
    tiles_x = -(-width // tile_w)
    n_tiles = tiles_y * tiles_x
    T = setup.rows.shape[0]
    Ls = stream_capacity
    dev = setup.rows.device
    ekeys, eids, big_ids, hit_b, big_overflow = _split_small_big(
        setup, width, height, tile_h, tile_w, big_capacity)
    tile_idx = torch.arange(n_tiles, dtype=I32, device=dev).reshape(
        tiles_y, tiles_x, 1)
    allk = torch.cat([ekeys, torch.where(hit_b, tile_idx, n_tiles).reshape(-1)])
    allv = torch.cat([eids, big_ids.expand(hit_b.shape).reshape(-1)])
    # one int64 key tile * Tp + id; invalid pairs key to (n_tiles, 0), as in
    # the reference's fused-key sort (its lexicographic fallback for int32
    # overflow gives the same ids: the pairs are unique)
    Tp = 1 << max(T - 1, 1).bit_length()
    valid = allk < n_tiles
    key = torch.sort(torch.where(valid, allk.long() * Tp + allv,
                                 n_tiles * Tp)).values
    L = key.shape[0]
    if L < Ls:
        key = torch.nn.functional.pad(key, (0, Ls - L), value=n_tiles * Tp)
    else:
        key = key[:Ls]
    st = key // Tp
    starts = _segment_starts(st, n_tiles)
    counts = (starts[1:] - starts[:-1]).reshape(tiles_y, tiles_x)
    ids = torch.where(st < n_tiles, key % Tp, -1).to(I32)
    return StreamBins(ids=ids, rows=_gather_rows(setup, ids), starts=starts,
                      counts=counts, overflow=counts.max(),
                      stream_overflow=valid.sum(dtype=I32),
                      big_overflow=big_overflow)


def stream_pays_off(triangle_pool: int) -> bool:
    """Whether the main view takes the stream raster (K4 + K5) for a
    (static) triangle pool of this size: past the dense/scatter
    crossover, as in the reference."""
    return triangle_pool > _SCATTER_MIN_T


def bin_triangles(setup: TriangleSetup, width: int, height: int,
                  tile_h: int, tile_w: int, capacity: int,
                  big_capacity: int = 512) -> Bins:
    """Capacity-padded per-tile bins: dense up to 4096 triangles, scatter
    above (dispatch on the static pool size, as the reference)."""
    if setup.rows.shape[0] <= _SCATTER_MIN_T:
        return bin_triangles_dense(setup, width, height, tile_h, tile_w,
                                   capacity)
    return bin_triangles_scatter(setup, width, height, tile_h, tile_w,
                                 capacity, big_capacity)


def _untile(tiles: torch.Tensor) -> torch.Tensor:
    ty, tx, th, tw = tiles.shape
    return tiles.permute(0, 2, 1, 3).reshape(ty * th, tx * tw)


def _race_bins(bins: Bins, tile_h: int, tile_w: int, chunk: int,
               keep: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked depth race of :func:`rasterize_binned_ref`; ``keep``
    (ty, tx, K, P) bool, when given, takes rows out of a pixel's race."""
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
        if keep is not None:
            covered = covered & keep[:, :, c0:c0 + chunk]
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


def rasterize_binned_ref(bins: Bins, tile_h: int, tile_w: int,
                         chunk: int = 32) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1 (any device): the Pallas kernel's chunked
    depth race, run for all tiles at once, ``chunk`` bin rows at a time,
    every row tested on every pixel of its tile.

    Semantics are the kernel's (init ``best_z = 0``): a covered pixel whose
    depth is exactly 0 still wins on its id."""
    return _race_bins(bins, tile_h, tile_w, chunk)


def rect_rejects(rows: torch.Tensor, x0, y0, w, h, mxu: bool) -> torch.Tensor:
    """Whether each setup row ``rows[..., :16]`` can be dropped for the
    rectangle of ``w`` x ``h`` pixels whose first pixel is (``x0``, ``y0``)
    (ints or tensors that broadcast against ``rows[..., 0]``): its id is
    not > 0, or one of its edge planes is < 0 even at the pixel centre
    where it is largest. K1, K4 and K6 cull with this predicate
    (``tr::edges_reject`` in ``csrc/common.cuh``).

    It is exact, not merely safe: :func:`fp.plane` composes correctly
    rounded operations, each monotone, so for a fixed ``py`` it rises or
    falls with ``px`` as the sign of ``a`` says, and likewise in ``py``
    with ``b``; its largest value over the rectangle's pixel centres is
    its own value at the corner those signs pick. A NaN there drops
    nothing, so the per-pixel test decides as before."""
    def f32(v):
        return torch.as_tensor(v, device=rows.device).to(F32)

    xlo, ylo = f32(x0) + 0.5, f32(y0) + 0.5
    xhi, yhi = f32(x0 + w - 1) + 0.5, f32(y0 + h - 1) + 0.5

    def best(lo):
        a, b, c = rows[..., lo], rows[..., lo + 1], rows[..., lo + 2]
        return plane(a, b, c, torch.where(a >= 0.0, xhi, xlo),
                     torch.where(b >= 0.0, yhi, ylo), mxu)

    return (~(rows[..., _IDF] > 0.0) | (best(_E0X) < 0.0)
            | (best(_E1X) < 0.0) | (best(_E2X) < 0.0))


def rasterize_binned_culled_ref(bins: Bins, tile_h: int, tile_w: int,
                                rect: tuple[int, int] = (8, 32),
                                chunk: int = 32
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`rasterize_binned_ref` with the kernels' cull as plain tensor
    code: each tile is cut into rectangles of ``rect`` = (height, width)
    pixels, the ragged ones clipped to the tile, and a pixel races only the
    rows that :func:`rect_rejects` leaves for its rectangle. Bit-equal to
    the exhaustive race. No frame calls it: it exists to test the cull."""
    ty, tx, K, _ = bins.rows.shape
    dev = bins.rows.device
    rh, rw = rect
    ry, rx = -(-tile_h // rh), -(-tile_w // rw)
    iy = torch.arange(ry, device=dev)[:, None] * rh               # (ry, 1)
    ix = torch.arange(rx, device=dev)[None, :] * rw               # (1, rx)
    x0 = torch.arange(tx, device=dev)[None, :, None, None] * tile_w + ix
    y0 = torch.arange(ty, device=dev)[:, None, None, None] * tile_h + iy
    w = (tile_w - ix).clamp(max=rw)
    h = (tile_h - iy).clamp(max=rh)
    rej = rect_rejects(bins.rows[:, :, :, None, None, :], x0[:, :, None],
                       y0[:, :, None], w, h,
                       tile_h * tile_w > _VPU_PLANES_MAX_P)  # (ty,tx,K,ry,rx)
    p = torch.arange(tile_h * tile_w, device=dev)
    of_pixel = (p // tile_w) // rh * rx + (p % tile_w) // rw      # (P,)
    keep = ~rej.reshape(ty, tx, K, ry * rx)[:, :, :, of_pixel]
    return _race_bins(bins, tile_h, tile_w, chunk, keep)


def live_rows(bins: Bins) -> tuple[torch.Tensor, torch.Tensor]:
    """The rows a dense bin array races, compacted: (rows (N, 16), tile
    (N,) int64), the first ``counts`` rows of every tile."""
    ty, tx, K, _ = bins.rows.shape
    live = (torch.arange(K, device=bins.rows.device)
            < bins.counts.reshape(-1, 1)).reshape(-1)
    tile = torch.arange(ty * tx, device=bins.rows.device).repeat_interleave(K)
    return bins.rows.reshape(-1, SETUP_COLS)[live], tile[live]


def covered_pairs(rows: torch.Tensor, tile: torch.Tensor, tiles_x: int,
                  tile_h: int, tile_w: int) -> int:
    """How many (row, pixel centre) pairs the exhaustive test covers: row
    ``rows[i]`` (N, 16) on the pixels of its tile ``tile[i]``, all three
    edges >= 0 and the id > 0. It is the work a raster of these rows
    cannot avoid (one depth race step a pair), whatever it culls."""
    P = tile_h * tile_w
    mxu = P > _VPU_PLANES_MAX_P
    p = torch.arange(P, device=rows.device)
    total = 0
    chunk = max(1, (1 << 22) // P)           # ~4 M pixel evaluations a step
    for c0 in range(0, rows.shape[0], chunk):
        s = rows[c0:c0 + chunk, :, None]                          # (c, 16, 1)
        t = tile[c0:c0 + chunk, None]                             # (c, 1)
        px = ((t % tiles_x) * tile_w + p % tile_w).to(F32) + 0.5  # (c, P)
        py = ((t // tiles_x) * tile_h + p // tile_w).to(F32) + 0.5

        def ev(lo):
            return plane(s[:, lo], s[:, lo + 1], s[:, lo + 2], px, py, mxu)

        covered = ((ev(_E0X) >= 0.0) & (ev(_E1X) >= 0.0) & (ev(_E2X) >= 0.0)
                   & (s[:, _IDF] > 0.0))
        total += int(covered.sum())
    return total


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
    # a capacity that allows a long bin has the kernel split it over several
    # blocks, which meet in zeroed scratch
    nbytes = lib.tr_raster_scratch_bytes(ty * tx, tile_h, tile_w, K)
    scratch = (torch.zeros(-(-nbytes // 8), dtype=torch.int64,
                           device=rows.device) if nbytes else None)
    code = lib.tr_raster(counts.data_ptr(), rows.data_ptr(), tri_id.data_ptr(),
                         depth.data_ptr(),
                         None if scratch is None else scratch.data_ptr(),
                         ty * tx, tx, tile_h, tile_w, K, W,
                         int(tile_h * tile_w > _VPU_PLANES_MAX_P),
                         kernels.stream_handle(rows.device))
    kernels.check("tr_raster", code)
    K1_LAUNCHES += 1
    return tri_id, depth


def rasterize_resolve_binned_ref(bins: Bins, table: torch.Tensor,
                                 tile_h: int, tile_w: int, chunk: int = 32
                                 ) -> tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """Plain PyTorch version of K6 (any device): :func:`rasterize_binned_ref`
    and the winner's row of the (T, D) resolve table, zeros on background.

    The reference carries the row through the race as a one-hot matrix
    product over the tile's bin; the product has one non-zero term, so the
    row is copied exactly."""
    tri_id, depth = rasterize_binned_ref(bins, tile_h, tile_w, chunk)
    T = table.shape[0]
    sel = table[tri_id.clamp(0, T - 1).long()]
    sel = torch.where((tri_id >= 0)[..., None], sel,
                      torch.zeros((), dtype=table.dtype, device=table.device))
    return tri_id, depth, sel


def rasterize_resolve_binned(bins: Bins, table: torch.Tensor, tile_h: int,
                             tile_w: int) -> tuple[torch.Tensor, torch.Tensor,
                                                   torch.Tensor]:
    """Fused visibility raster + resolve-row selection -> (tri_id (H', W')
    i32, depth (H', W') f32, sel (H', W', D) f32): :func:`rasterize_binned`
    and each pixel's winning row of the (T, D) table (zeros on background).

    CPU tensors take :func:`rasterize_resolve_binned_ref`; CUDA tensors
    launch K6."""
    if bins.rows.device.type == "cpu":
        return rasterize_resolve_binned_ref(bins, table, tile_h, tile_w)
    global K6_LAUNCHES
    ty, tx, K, cols = bins.rows.shape
    T, D = table.shape
    if (cols != SETUP_COLS or bins.rows.dtype != F32 or table.dtype != F32
            or T == 0 or tuple(bins.counts.shape) != (ty, tx)):
        raise ValueError(f"raster + resolve takes (ty, tx, K, 16) f32 rows, "
                         f"(ty, tx) counts and a non-empty (T, D) f32 table, "
                         f"got {tuple(bins.rows.shape)} {bins.rows.dtype}, "
                         f"{tuple(bins.counts.shape)}, {tuple(table.shape)} "
                         f"{table.dtype}")
    counts = bins.counts.to(I32).contiguous()
    rows = bins.rows.contiguous()
    table = table.contiguous()
    kernels.require_cuda("rasterize_resolve_binned", counts, rows, table)
    H, W = ty * tile_h, tx * tile_w
    tri_id = torch.empty((H, W), dtype=I32, device=rows.device)
    depth = torch.empty((H, W), dtype=F32, device=rows.device)
    sel = torch.empty((H, W, D), dtype=F32, device=rows.device)
    code = kernels.library().tr_raster_resolve(
        counts.data_ptr(), rows.data_ptr(), table.data_ptr(),
        tri_id.data_ptr(), depth.data_ptr(), sel.data_ptr(), ty * tx, tx,
        tile_h, tile_w, K, W, T, D, int(tile_h * tile_w > _VPU_PLANES_MAX_P),
        kernels.stream_handle(rows.device))
    kernels.check("tr_raster_resolve", code)
    K6_LAUNCHES += 1
    return tri_id, depth, sel


def stream_walk(Ls: int, kmax: int) -> tuple[int, int]:
    """(kb, nb) of the reference's stream walk: the stream in ``kb``-row
    blocks, ``nb`` blocks a tile, so tile t races exactly the rows
    ``[start, min(end, (start // kb + nb) * kb))`` of its segment
    ``[start, end)`` — its *walked window*. A segment longer than ``kmax``
    loses a tail that depends on where ``start`` falls within a block."""
    kb = min(STREAM_BLOCK, Ls)
    if Ls % kb:
        raise ValueError(f"stream capacity {Ls} is not a multiple of "
                         f"{STREAM_BLOCK}")
    nblocks = Ls // kb
    return kb, min(-(-kmax // kb) + 1, nblocks)


def walked_windows(starts: torch.Tensor, Ls: int, kmax: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per tile (n_tiles,) i32 (start, stop) of its walked window."""
    kb, nb = stream_walk(Ls, kmax)
    start, end = starts[:-1], starts[1:]
    return start, torch.minimum(end, (start // kb + nb) * kb)


def stream_tiles(starts: torch.Tensor, Ls: int) -> torch.Tensor:
    """(Ls,) int64 tile of each stream row; ``n_tiles`` for the padding
    past the last segment."""
    pos = torch.arange(Ls, dtype=starts.dtype, device=starts.device)
    return torch.searchsorted(starts[1:].contiguous(), pos, right=True)


def walked_rows(sbins: StreamBins, n_tiles: int, kmax: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per stream row: (whether its tile's walked window holds it (Ls,)
    bool, its tile (Ls,) int64, clamped for the padding)."""
    Ls = sbins.rows.shape[0]
    _, stop = walked_windows(sbins.starts, Ls, kmax)
    tile = stream_tiles(sbins.starts, Ls)
    walked = ((tile < n_tiles)
              & (torch.arange(Ls, device=sbins.rows.device)
                 < stop[tile.clamp(max=n_tiles - 1)]))
    return walked, tile.clamp(max=n_tiles - 1)


def _race_stream(sbins: StreamBins, tiles_y: int, tiles_x: int, tile_h: int,
                 tile_w: int, kmax: int, keep=None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The keyed race of :func:`rasterize_stream_ref`; ``keep(rows (c, 16),
    x (c, P) i64, y (c, P) i64) -> (c, P) bool``, when given, decides in
    the edge tests' place which rows cover a pixel (x, y: the pixel's image
    coordinates)."""
    n_tiles = tiles_y * tiles_x
    P = tile_h * tile_w
    mxu = P > _VPU_PLANES_MAX_P
    dev = sbins.rows.device
    walked, tile = walked_rows(sbins, n_tiles, kmax)
    # only the walked rows can win: the stream's padding and the tails past
    # a window are never evaluated
    live = walked.nonzero().squeeze(1)
    rows, tile = sbins.rows[live], tile[live]
    p = torch.arange(P, device=dev)
    best = torch.zeros(n_tiles * P, dtype=torch.int64, device=dev)
    chunk = max(1, (1 << 21) // P)           # ~2 M pixel evaluations a step
    for c0 in range(0, live.shape[0], chunk):
        s = rows[c0:c0 + chunk, :, None]                          # (c, 16, 1)
        t = tile[c0:c0 + chunk, None]                             # (c, 1)
        x = (t % tiles_x) * tile_w + p % tile_w                   # (c, P)
        y = (t // tiles_x) * tile_h + p // tile_w
        px, py = x.to(F32) + 0.5, y.to(F32) + 0.5

        def ev(lo):
            return plane(s[:, lo], s[:, lo + 1], s[:, lo + 2], px, py, mxu)

        z = ev(_ZX)
        idf = s[:, _IDF]
        covered = (idf > 0.0) & (z >= 0.0)
        if keep is None:
            covered = (covered & (ev(_E0X) >= 0.0) & (ev(_E1X) >= 0.0)
                       & (ev(_E2X) >= 0.0))
        else:
            covered = covered & keep(s[:, :, 0], x, y)
        key = ((z + 0.0).view(I32).long() << 32) | idf.long()
        best.scatter_reduce_(0, (t * P + p).reshape(-1),
                             torch.where(covered, key, 0).reshape(-1), "amax")
    tri_id = (best & 0xFFFFFFFF).to(I32) - 1
    depth = (best >> 32).to(I32).view(F32)
    return (_untile(tri_id.reshape(tiles_y, tiles_x, tile_h, tile_w)),
            _untile(depth.reshape(tiles_y, tiles_x, tile_h, tile_w)))


def rasterize_stream_ref(sbins: StreamBins, tiles_y: int, tiles_x: int,
                         tile_h: int, tile_w: int, kmax: int
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K4 (any device): K1's race over each
    tile's walked window, as one max of (depth, id) keys.

    Every walked stream row is evaluated at its own tile's pixels; a
    covered pixel's candidate is the int64 key ``bits(z) << 32 | id + 1``,
    which orders as (z, id) for z >= 0, and ``scatter_reduce`` keeps each
    pixel's largest key over the key 0 (the race's ``best_z = 0``,
    background). Rows with z < 0 never win, as in the race; a winning depth
    of -0.0 reads +0.0 here."""
    return _race_stream(sbins, tiles_y, tiles_x, tile_h, tile_w, kmax)


# K4's descent (csrc/raster.cu): a tile is cut into sub-tiles of 8 rows of
# at most 128 pixels; a row is tested against the sub-tile's groups of 32
# columns and cells of 8, and then, a pixel column at a time, a binary
# search an edge finds the rows of the column that the row covers
STREAM_SUB = (8, 128)
STREAM_DESCENT = (32, 8)


def column_rows(rows: torch.Tensor, x: torch.Tensor, y0: torch.Tensor,
                h: torch.Tensor, mxu: bool
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """K4's last step as tensor code: (lo, hi) such that ``[lo, hi)`` are
    the rows of the pixel column ``x`` (image coordinates; ``y0`` its first
    row, ``h`` <= 8 its height), where all three edge planes of
    ``rows[..., :16]`` are >= 0 at the pixel centre. Everything broadcasts.

    :func:`fp.plane` rises with ``py`` where ``b >= 0`` and falls where
    ``b < 0``, under the rounded arithmetic too (see :func:`rect_rejects`),
    and a NaN, which only inf - inf gives, stays one for every ``py``
    further on; so the rows where an edge is >= 0 are a suffix or a prefix
    of the column, and a binary search on the plane's own values finds
    them."""
    px = x.to(F32) + 0.5
    lo, hi = torch.broadcast_tensors(torch.zeros_like(x), h, rows[..., 0])[:2]
    for e in (_E0X, _E1X, _E2X):
        a, b, c = rows[..., e], rows[..., e + 1], rows[..., e + 2]
        rising = b >= 0.0
        first, last = lo, hi
        for _ in range(4):                   # 8 rows: at most 4 halvings
            mid = (first + last) >> 1
            inside = plane(a, b, c, px, (y0 + mid).to(F32) + 0.5, mxu) >= 0.0
            open_ = first < last
            left = open_ & (inside == rising)
            right = open_ & (inside != rising)
            first, last = (torch.where(right, mid + 1, first),
                           torch.where(left, mid, last))
        lo, hi = torch.where(rising, first, lo), torch.where(rising, hi, first)
    return lo, hi


def rasterize_stream_culled_ref(sbins: StreamBins, tiles_y: int,
                                tiles_x: int, tile_h: int, tile_w: int,
                                kmax: int) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`rasterize_stream_ref` with K4's descent as plain tensor code:
    a pixel races only the rows that :func:`rect_rejects` leaves at every
    level of ``STREAM_DESCENT`` for the rectangle that holds the pixel
    (each clipped to its sub-tile) and whose :func:`column_rows` hold the
    pixel; the edges are not tested at the pixel itself. Bit-equal to the
    exhaustive race. No frame calls it: it exists to test the descent."""
    sub_h, sub_w = STREAM_SUB
    mxu = tile_h * tile_w > _VPU_PLANES_MAX_P

    def keep(rows, x, y):
        lx, ly = x % tile_w, y % tile_h          # the pixel within its tile
        sx, sy = lx // sub_w * sub_w, ly // sub_h * sub_h
        h = (tile_h - sy).clamp(max=sub_h)
        kept = torch.ones_like(x, dtype=torch.bool)
        for w in STREAM_DESCENT:
            rx = (lx - sx) // w * w + sx         # the rectangle's first column
            wc = torch.minimum(torch.minimum(rx + w, sx + sub_w),
                               torch.full_like(rx, tile_w)) - rx
            kept &= ~rect_rejects(rows[:, None, :], x - lx + rx, y - ly + sy,
                                  wc, h, mxu)
        lo, hi = column_rows(rows[:, None, :], x, y - ly + sy, h, mxu)
        return kept & (lo <= ly - sy) & (ly - sy < hi)

    return _race_stream(sbins, tiles_y, tiles_x, tile_h, tile_w, kmax, keep)


def rasterize_stream(sbins: StreamBins, tiles_y: int, tiles_x: int,
                     tile_h: int, tile_w: int, kmax: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Visibility raster over CSR stream bins -> (tri_id, depth) as
    :func:`rasterize_binned`. ``kmax`` (cfg.bin_capacity) bounds each
    tile's walked window (:func:`stream_walk`).

    CPU tensors take :func:`rasterize_stream_ref`; CUDA tensors launch K4."""
    if sbins.rows.device.type == "cpu":
        return rasterize_stream_ref(sbins, tiles_y, tiles_x, tile_h, tile_w,
                                    kmax)
    global K4_LAUNCHES
    Ls, cols = sbins.rows.shape
    n_tiles = tiles_y * tiles_x
    if (cols != SETUP_COLS or sbins.rows.dtype != F32
            or tuple(sbins.starts.shape) != (n_tiles + 1,)):
        raise ValueError(f"stream raster takes (Ls, 16) f32 rows and "
                         f"({n_tiles + 1},) starts, got "
                         f"{tuple(sbins.rows.shape)} {sbins.rows.dtype}, "
                         f"{tuple(sbins.starts.shape)}")
    kb, nb = stream_walk(Ls, kmax)
    starts = sbins.starts.to(I32).contiguous()
    rows = sbins.rows.contiguous()
    kernels.require_cuda("rasterize_stream", starts, rows)
    H, W = tiles_y * tile_h, tiles_x * tile_w
    tri_id = torch.empty((H, W), dtype=I32, device=rows.device)
    depth = torch.empty((H, W), dtype=F32, device=rows.device)
    lib = kernels.library()
    # the kernel's list of window parts and the keys long windows meet in
    nbytes = lib.tr_raster_stream_scratch_bytes(n_tiles, tile_h, tile_w, Ls)
    scratch = torch.empty(-(-nbytes // 8), dtype=torch.int64,
                          device=rows.device)
    code = lib.tr_raster_stream(
        starts.data_ptr(), rows.data_ptr(), tri_id.data_ptr(),
        depth.data_ptr(), scratch.data_ptr(), n_tiles, tiles_x, tile_h,
        tile_w, kb, nb, Ls, W,
        int(tile_h * tile_w > _VPU_PLANES_MAX_P),
        kernels.stream_handle(rows.device))
    kernels.check("tr_raster_stream", code)
    K4_LAUNCHES += 1
    return tri_id, depth


def rasterize(clip: torch.Tensor, tri_vidx: torch.Tensor,
              tri_mask: torch.Tensor, width: int, height: int, tile_h: int,
              tile_w: int, bin_capacity: int, cull: str = "back",
              big_capacity: int = 512):
    """setup -> bin -> tile raster. Returns (tri_id, depth, setup, bins)."""
    setup = triangle_setup(clip, tri_vidx, tri_mask, width, height, cull)
    bins = bin_triangles(setup, width, height, tile_h, tile_w, bin_capacity,
                         big_capacity)
    tri_id, depth = rasterize_binned(bins, tile_h, tile_w)
    return tri_id, depth, setup, bins
