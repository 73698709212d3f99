"""The raster kernels' cull, as the plain tensor code beside them.

K1, K4 and K6 test a setup row against a rectangle of pixels before they
test it against the pixels (``csrc/raster.cu``); ``raster.rect_rejects``
is that predicate and ``raster.rasterize_binned_culled_ref`` the race over
what it leaves. Here, with no card: the predicate drops no row that the
exhaustive per-pixel test covers anywhere in the rectangle, under the
rounded arithmetic and on hostile rows; the culled race equals the
exhaustive one bit for bit; ``raster.covered_pairs`` counts what brute
force counts."""

import dataclasses
import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tinyrenderer_tpu_torch.config import RenderConfig
from tinyrenderer_tpu_torch.ops import fp
from tinyrenderer_tpu_torch.ops import raster
from tinyrenderer_tpu_torch.render import frame as tframe
from tinyrenderer_tpu_torch.render.engine import Engine
from tinyrenderer_tpu_torch.scene import demo

LEVEL = os.path.join(os.path.dirname(__file__), "..", "levels", "demo.lvl")
W, H = 256, 128
CFG = RenderConfig(width=W, height=H, shadow_size=128, shadow_tile=128,
                   env_size=32)


def _covered(rows, x0, y0, w, h, mxu):
    """(N, h * w) bool: the exhaustive test of every row at every pixel
    centre of the rectangle."""
    px = (x0 + torch.arange(w)).float().repeat(h)[None, :] + 0.5
    py = (y0 + torch.arange(h)).float().repeat_interleave(w)[None, :] + 0.5
    s = rows[:, :, None]

    def ev(lo):
        return fp.plane(s[:, lo], s[:, lo + 1], s[:, lo + 2], px, py, mxu)

    return ((ev(0) >= 0.0) & (ev(3) >= 0.0) & (ev(6) >= 0.0)
            & (s[:, 12] > 0.0))


def _setup_rows(rng, T, size, extent):
    """Setup rows of T random triangles of about ``extent`` pixels on a
    size x size screen."""
    c = rng.uniform(-1.0, 1.0, (T, 1, 2))
    xy = c + rng.uniform(-extent, extent, (T, 3, 2)) / size
    w = rng.uniform(0.5, 2.0, (T, 3, 1))
    z = rng.uniform(0.05, 0.9, (T, 3, 1))
    clip = np.concatenate([xy * w, z * w, w], 2).reshape(-1, 4)
    setup = raster.triangle_setup(
        torch.from_numpy(clip.astype(np.float32)),
        torch.arange(3 * T, dtype=torch.int32).reshape(T, 3),
        torch.ones(T, dtype=torch.bool), size, size, "none")
    return setup.rows


def _hostile_rows(rng, n):
    """Rows built to break a cull that trusts real arithmetic: huge and
    tiny coefficients, denormals, infinities, NaN, zeros, and edges that
    pass exactly through pixel centres."""
    special = np.array([0.0, -0.0, 1e30, -1e30, 1e-30, -1e-30, 1e-42, -1e-42,
                        np.inf, -np.inf, np.nan, 1.0, -1.0, 0.5, -0.5, 3e38,
                        -3e38, 2.0 ** -126], np.float32)
    rows = special[rng.integers(0, len(special), (n, 16))]
    # a third of the coefficients ordinary, so that the specials mix in
    ordinary = rng.normal(0.0, 1.0, (n, 16)).astype(np.float32)
    rows = np.where(rng.random((n, 16)) < 0.35, ordinary, rows)
    rows[:, 12] = np.where(rng.random(n) < 0.8,
                           rng.integers(1, 1000, n), rows[:, 12])
    # edges a * px + b * py + c == 0 exactly at a pixel centre (cx, cy)
    m = n // 4
    a = rng.integers(-4, 5, (m, 3)).astype(np.float32)
    b = rng.integers(-4, 5, (m, 3)).astype(np.float32)
    cx = rng.integers(0, 64, (m, 1)) + 0.5
    cy = rng.integers(0, 64, (m, 1)) + 0.5
    through = np.zeros((m, 16), np.float32)
    through[:, 0:9:3], through[:, 1:9:3] = a, b
    through[:, 2:9:3] = -(a * cx + b * cy)
    through[:, 9:12] = rng.normal(0.0, 1.0, (m, 3))
    through[:, 12] = rng.integers(1, 1000, m)
    zeroed = np.zeros((8, 16), np.float32)
    return torch.from_numpy(np.concatenate([rows, through, zeroed]))


def _assert_sound(rows, rects, mxu):
    dropped_any = 0
    for x0, y0, w, h in rects:
        rej = raster.rect_rejects(rows, x0, y0, w, h, mxu)
        cov = _covered(rows, x0, y0, w, h, mxu).any(dim=1)
        bad = rej & cov
        assert not bad.any(), (
            f"rectangle {(x0, y0, w, h)}, mxu={mxu}: rejected a covering "
            f"row {rows[bad][0].tolist()}")
        dropped_any += int(rej.sum())
    return dropped_any


def _rects(rng, n, size):
    out = [(0, 0, 32, 8), (32, 8, 32, 1), (size - 7, size - 3, 7, 3),
           (5, 9, 1, 1)]
    for _ in range(n):
        w, h = int(rng.integers(1, 40)), int(rng.integers(1, 12))
        out.append((int(rng.integers(0, size - w + 1)),
                    int(rng.integers(0, size - h + 1)), w, h))
    return out


@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("kind", ["small", "large", "hostile"])
def test_rect_rejects_is_sound(kind, mxu):
    rng = np.random.default_rng({"small": 1, "large": 2, "hostile": 3}[kind])
    size = 64
    if kind == "hostile":
        rows = _hostile_rows(rng, 1200)
    else:
        rows = _setup_rows(rng, 600, size, 3.0 if kind == "small" else 60.0)
    dropped = _assert_sound(rows, _rects(rng, 24, size), mxu)
    if kind == "small":     # the cull is not vacuous: most pairs go
        assert dropped > 0.8 * rows.shape[0] * 28


def test_rect_rejects_keeps_what_it_must():
    """A row that covers the whole rectangle, one whose id is 0, one that
    is all NaN, and one that misses by one pixel."""
    full = torch.zeros(16)
    full[2] = full[5] = full[8] = 1.0            # every edge == 1 everywhere
    full[12] = 7.0
    no_id = full.clone()
    no_id[12] = 0.0
    nan = torch.full((16,), float("nan"))
    nan[12] = 3.0
    left = full.clone()
    left[0], left[2] = -1.0, 10.0                # edge 0: 10 - px >= 0
    rows = torch.stack([full, no_id, nan, left])
    rej = raster.rect_rejects(rows, 10, 0, 4, 4, False)   # px from 10.5
    assert rej.tolist() == [False, True, False, True]
    rej = raster.rect_rejects(rows, 9, 0, 4, 4, False)    # px from 9.5
    assert rej.tolist() == [False, True, False, False]


_coef = st.floats(width=32, allow_nan=True, allow_infinity=True)


@settings(max_examples=300, deadline=None, database=None)
@given(edges=st.lists(_coef, min_size=9, max_size=9),
       idf=st.sampled_from([0.0, 1.0, 5.0, -1.0, float("nan")]),
       x0=st.integers(0, 2000), y0=st.integers(0, 2000),
       w=st.integers(1, 33), h=st.integers(1, 9), mxu=st.booleans())
def test_rect_rejects_sound_property(edges, idf, x0, y0, w, h, mxu):
    row = torch.zeros(1, 16)
    row[0, :9] = torch.tensor(edges, dtype=torch.float32)
    row[0, 12] = idf
    rej = raster.rect_rejects(row, x0, y0, w, h, mxu)
    assert not (rej & _covered(row, x0, y0, w, h, mxu).any(dim=1)).any()


def _main_view_setup(engine):
    """Setup rows of the engine's main view (back-face culled)."""
    engine.update()
    cam = tframe._unpack_camera(torch.as_tensor(engine.camera.to_raw()))
    scene = engine._pack.scene
    _, clip, _ = tframe.geometry_stage(scene, cam["view_proj"], need_tbn=False)
    return raster.triangle_setup(clip, scene.tri_vidx, scene.tri_deferred,
                                 W, H, "back")


_SETUPS = {}


def _setup(world):
    if world not in _SETUPS:
        if world == "demo.lvl":
            eng = Engine(cfg=CFG, device="cpu", level_path=LEVEL)
        else:                                    # one sphere, ~12k triangles
            eng = Engine.from_world(
                demo.build_highpoly_world(1), camera=demo.build_demo_camera(W, H),
                cfg=dataclasses.replace(CFG, max_vertices=16384,
                                        max_triangles=16384), device="cpu")
            eng.camera.position = np.asarray((-3.0, 2.5, 0.0), np.float32)
            eng.camera.look_at(np.zeros(3, np.float32))
        _SETUPS[world] = _main_view_setup(eng)
    return _SETUPS[world]


def _bins(world, th, tw):
    setup = _setup(world)
    if world == "demo.lvl":
        assert setup.rows.shape[0] <= raster._SCATTER_MIN_T
        return raster.bin_triangles_dense(setup, W, H, th, tw, 192)
    assert setup.rows.shape[0] > raster._SCATTER_MIN_T
    return raster.bin_triangles_scatter(setup, W, H, th, tw,
                                        1024 if th == 8 else 2048, 64)


@pytest.mark.parametrize("world", ["demo.lvl", "highpoly"])
@pytest.mark.parametrize("th,tw,rect", [
    (8, 128, (8, 32)), (64, 128, (8, 32)), (128, 128, (8, 32)),
    (64, 128, (1, 32)),        # a warp's pixel row, the kernels' second level
    (64, 128, (5, 24)),        # a rectangle that does not divide the tile
    (24, 80, (8, 32)),         # a tile that the kernels' rectangle does not
])
def test_culled_race_equals_exhaustive(world, th, tw, rect):
    bins = _bins(world, th, tw)
    assert int(bins.counts.max()) > 0
    rid, rz = raster.rasterize_binned_ref(bins, th, tw)
    cid, cz = raster.rasterize_binned_culled_ref(bins, th, tw, rect)
    assert (rid >= 0).float().mean() > 0.05
    assert torch.equal(cid, rid)
    assert torch.equal(cz.view(torch.int32), rz.view(torch.int32))


def test_culled_race_on_shadow_view_bins():
    """The bins the shadow passes give the kernel (front-face culled,
    orthographic and perspective light views), captured from the atlas
    render of demo.lvl."""
    eng = Engine(cfg=CFG, device="cpu", level_path=LEVEL)
    eng.update()
    seen = []
    inner = raster.rasterize_binned

    def capture(bins, th, tw):
        seen.append((bins, th, tw))
        return inner(bins, th, tw)

    raster.rasterize_binned = capture
    try:
        tframe.render_shadow_atlas(eng._pack.scene, eng._pack.lights, eng.cfg)
    finally:
        raster.rasterize_binned = inner
    assert len(seen) == eng.cfg.num_shadow_views > 1
    for bins, th, tw in seen:
        rid, rz = raster.rasterize_binned_ref(bins, th, tw)
        cid, cz = raster.rasterize_binned_culled_ref(bins, th, tw)
        assert torch.equal(cid, rid)
        assert torch.equal(cz.view(torch.int32), rz.view(torch.int32))
    assert any((raster.rasterize_binned_ref(*s)[0] >= 0).any() for s in seen)


def test_culled_race_keeps_ties_and_zero_depth():
    """Two rows of equal depth on the same pixels (the larger id wins), a
    row of depth exactly 0 (it still wins on its id), a dead row between
    them, and a count that hides the last row."""
    def row(idf, z, x_max):
        r = torch.zeros(16)
        r[2] = r[5] = 1.0                 # edges 0 and 1: 1 everywhere
        r[6], r[8] = -1.0, x_max          # edge 2: x_max - px >= 0
        r[11], r[12] = z, idf
        return r

    rows = torch.stack([row(3.0, 0.5, 40.0), torch.zeros(16),
                        row(9.0, 0.5, 20.0), row(5.0, 0.0, 64.0),
                        row(11.0, 0.9, 64.0)])
    bins = raster.Bins(ids=torch.zeros(1, 1, 5, dtype=torch.int32),
                       rows=rows[None, None],
                       counts=torch.tensor([[4]], dtype=torch.int32),
                       overflow=torch.zeros((), dtype=torch.int32),
                       big_overflow=torch.zeros((), dtype=torch.int32))
    rid, rz = raster.rasterize_binned_ref(bins, 8, 64)
    cid, cz = raster.rasterize_binned_culled_ref(bins, 8, 64, (8, 32))
    assert torch.equal(cid, rid) and torch.equal(cz, rz)
    assert cid[0].tolist() == [8] * 20 + [2] * 20 + [4] * 24
    assert cz[0, 63] == 0.0 and cz[0, 0] == 0.5


def _brute_pairs(bins, th, tw):
    """Every row of every tile at every pixel of the tile, in one tensor."""
    ty, tx, K, _ = bins.rows.shape
    P = th * tw
    p = torch.arange(P)
    px = ((p % tw)[None, :] + torch.arange(tx)[:, None] * tw).float()
    py = ((p // tw)[None, :] + torch.arange(ty)[:, None] * th).float()
    px = px[None, :, None, :] + 0.5
    py = py[:, None, None, :] + 0.5
    s = bins.rows[..., None]

    def ev(lo):
        return fp.plane(s[:, :, :, lo], s[:, :, :, lo + 1], s[:, :, :, lo + 2],
                        px, py, P > raster._VPU_PLANES_MAX_P)

    live = torch.arange(K)[None, None, :, None] < bins.counts[..., None, None]
    cov = ((ev(0) >= 0.0) & (ev(3) >= 0.0) & (ev(6) >= 0.0)
           & (s[:, :, :, 12] > 0.0) & live)
    return int(cov.sum())


@pytest.mark.parametrize("th,tw", [(8, 128), (64, 128), (128, 128)])
def test_covered_pairs_equals_brute_force(th, tw):
    bins = _bins("demo.lvl", th, tw)
    rows, tile = raster.live_rows(bins)
    assert rows.shape[0] == int(bins.counts.sum())
    n = raster.covered_pairs(rows, tile, bins.rows.shape[1], th, tw)
    assert n == _brute_pairs(bins, th, tw) > 0
    # at least one pair a covered pixel, and overdraw on top of that
    tid, _ = raster.rasterize_binned_ref(bins, th, tw)
    assert n >= int((tid >= 0).sum())


def test_covered_pairs_of_a_stream_counts_the_walked_rows():
    setup = _setup("highpoly")
    sb = raster.bin_triangles_stream(setup, W, H, 8, 128, 16384, 64)
    ty, tx = sb.counts.shape
    walked, tile = raster.walked_rows(sb, ty * tx, 1024)
    n = raster.covered_pairs(sb.rows[walked], tile[walked], tx, 8, 128)
    # the same rows as dense bins, tile by tile
    K = int(sb.counts.max())
    rows = torch.zeros(ty * tx, K, 16)
    start, stop = raster.walked_windows(sb.starts, sb.rows.shape[0], 1024)
    for t in range(ty * tx):
        rows[t, :stop[t] - start[t]] = sb.rows[start[t]:stop[t]]
    dense = raster.Bins(ids=None, rows=rows.reshape(ty, tx, K, 16),
                        counts=(stop - start).reshape(ty, tx), overflow=None,
                        big_overflow=None)
    assert n == _brute_pairs(dense, 8, 128) > 0
