"""K4's descent, as the plain tensor code beside its plain version.

The stream raster kernel (``csrc/raster.cu``) tests a row against its
sub-tile's groups of 32 columns and cells of 8, finds the rows of each
pixel column that the row covers with a binary search an edge
(``raster.column_rows``), and keeps each pixel's winner as the key
``bits(depth) << 32 | id``. ``raster.rasterize_stream_culled_ref`` is that
descent over the plain keyed race. Here, with no card: the search finds
exactly the covered rows, and the descent equals
``raster.rasterize_stream_ref`` bit for bit on ordinary and on hostile rows
(1e+-30, denormals, infinities, NaN, edges through pixel centres, depths of
exactly 0 and -0.0), on tiles of one and of several sub-tiles, ragged ones,
and on a segment the walk cuts."""

import numpy as np
import pytest
import torch

from tinyrenderer_tpu_torch.ops import fp, raster

from test_torch_raster_cull import _hostile_rows


def _triangles(rng, T, W, H, extent):
    """Setup rows of T random triangles of about ``extent`` pixels on a
    W x H screen."""
    c = rng.uniform(-1.0, 1.0, (T, 1, 2))
    xy = c + rng.uniform(-extent, extent, (T, 3, 2)) / (W, H)
    w = rng.uniform(0.5, 2.0, (T, 3, 1))
    z = rng.uniform(0.05, 0.9, (T, 3, 1))
    clip = np.concatenate([xy * w, z * w, w], 2).reshape(-1, 4)
    return raster.triangle_setup(
        torch.from_numpy(clip.astype(np.float32)),
        torch.arange(3 * T, dtype=torch.int32).reshape(T, 3),
        torch.ones(T, dtype=torch.bool), W, H, "none").rows


def _bits(a):
    return a.view(torch.int32) if a.dtype == torch.float32 else a


def _stream(rows, tile_of, n_tiles, Ls):
    """Stream bins of ``rows`` (N, 16) sorted by their tile ``tile_of``."""
    order = np.argsort(tile_of, kind="stable")
    srows = torch.zeros(Ls, 16)
    srows[:len(order)] = rows[order]
    counts = np.bincount(tile_of, minlength=n_tiles)
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    zero = torch.zeros((), dtype=torch.int32)
    return raster.StreamBins(
        ids=torch.full((Ls,), -1, dtype=torch.int32), rows=srows,
        starts=torch.from_numpy(starts),
        counts=torch.from_numpy(counts.astype(np.int32)), overflow=zero,
        stream_overflow=zero, big_overflow=zero)


def _zero_depth_rows(n, width):
    """Rows that cover everything left of a column, at depth exactly 0 and
    -0.0, and one behind the far plane (z < 0 never wins)."""
    rows = torch.zeros(n, 16)
    rows[:, 2] = rows[:, 5] = 1.0              # edges 0 and 1: 1 everywhere
    rows[:, 6] = -1.0                          # edge 2: x_max - px >= 0
    rows[:, 8] = torch.linspace(4.0, float(width), n)
    rows[:, 11] = torch.tensor([0.0, -0.0, -0.5])[torch.arange(n) % 3]
    rows[:, 12] = torch.arange(1, n + 1).float()
    return rows


@pytest.mark.parametrize("th,tw,ty,tx,n,kmax", [
    (8, 128, 2, 2, 1500, 2048),     # the main path's tile: one sub-tile
    (8, 50, 2, 3, 1500, 2048),      # a ragged sub-tile: clipped groups, cells
    (20, 136, 1, 2, 900, 2048),     # 3 x 2 sub-tiles, the last ones ragged
    (128, 128, 1, 1, 200, 2048)])   # the large-tile plane order
def test_descent_equals_exhaustive_race(th, tw, ty, tx, n, kmax):
    rng = np.random.default_rng(th * tw)
    W, H = tx * tw, ty * th
    rows = torch.cat([
        _triangles(rng, n // 3, W, H, 6.0),           # small triangles
        _triangles(rng, 12, W, H, W / 2),             # a few large ones
        _hostile_rows(rng, n // 2),
        _zero_depth_rows(9, tx * tw)])
    rows[:, 12] = torch.where(rows[:, 12] > 0,
                              torch.arange(1, len(rows) + 1).float(),
                              rows[:, 12])
    sb = _stream(rows, rng.integers(0, ty * tx, len(rows)), ty * tx, 2048)
    want = raster.rasterize_stream_ref(sb, ty, tx, th, tw, kmax)
    got = raster.rasterize_stream_culled_ref(sb, ty, tx, th, tw, kmax)
    assert (want[0] >= 0).float().mean() > 0.3
    assert torch.equal(got[0], want[0])
    assert torch.equal(_bits(got[1]), _bits(want[1]))
    assert (want[1] >= 0).all() and not torch.signbit(want[1]).any()


@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("kind", ["small", "large", "hostile"])
def test_column_rows_are_the_covered_rows(kind, mxu):
    """The binary search an edge finds exactly the rows of a pixel column
    where all three edges are >= 0 (so these are contiguous), for columns of
    1 to 8 rows anywhere on a 1920 x 1080 screen."""
    rng = np.random.default_rng(len(kind) + mxu)
    size = {"small": 16, "large": 64, "hostile": 1080}[kind]
    rows = (_hostile_rows(rng, 4000) if kind == "hostile" else
            _triangles(rng, 4000, size, size, 4.0 if kind == "small" else 48.0))
    n = len(rows)
    x = torch.from_numpy(rng.integers(0, size, n))
    y0 = torch.from_numpy(rng.integers(0, size - 8, n))
    h = torch.from_numpy(rng.integers(1, 9, n))
    lo, hi = raster.column_rows(rows, x, y0, h, mxu)
    ys = torch.arange(8)[None, :]
    px = x[:, None].float() + 0.5
    py = (y0[:, None] + ys).float() + 0.5

    def ev(e):
        return fp.plane(rows[:, e, None], rows[:, e + 1, None],
                        rows[:, e + 2, None], px, py, mxu)

    covered = ((ev(0) >= 0.0) & (ev(3) >= 0.0) & (ev(6) >= 0.0)
               & (ys < h[:, None]))
    assert torch.equal(covered, (lo[:, None] <= ys) & (ys < hi[:, None]))
    count = covered.sum(1)
    assert (count > 0).float().mean() > 0.01
    assert ((count > 0) & (count < h)).any()       # some columns in part
    assert (0 <= lo).all() and (hi <= h).all()


def test_descent_on_a_segment_the_walk_cuts():
    """Two 8 x 128 tiles of one stream of 8192 rows; the second tile's
    segment starts at row 100 and outgrows the walk of two 2048-row blocks:
    its rows from 4096 on never race, in either version."""
    rng = np.random.default_rng(11)
    rows = _triangles(rng, 5600, 256, 8, 5.0)
    rows[:, 12] = torch.arange(1, 5601).float()
    tile_of = np.where(np.arange(5600) < 100, 0, 1)
    sb = _stream(rows, tile_of, 2, 8192)
    _, stop = raster.walked_windows(sb.starts, 8192, 16)
    assert stop.tolist() == [100, 4096]
    want = raster.rasterize_stream_ref(sb, 1, 2, 8, 128, 16)
    got = raster.rasterize_stream_culled_ref(sb, 1, 2, 8, 128, 16)
    assert int(want[0].max()) < 4096 and (want[0] >= 0).float().mean() > 0.2
    assert torch.equal(got[0], want[0])
    assert torch.equal(_bits(got[1]), _bits(want[1]))
