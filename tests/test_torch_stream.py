"""Port parity for the high-poly binners and kernels on the CPU: the
scatter and stream binners, the stream raster (K4) and the stream select +
eval (K5) against the JAX package (its Pallas kernels in interpret mode),
and the shadow views' big-triangle monitor. Inputs come from seeded numpy
generators; integer results must be exact, depth bit-equal and the select
outputs equal."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import planes
import pytest
import torch

from tinyrenderer_tpu.ops import raster as jraster
from tinyrenderer_tpu.ops import resolve as jresolve
from tinyrenderer_tpu.ops import shadows as jshadows
from tinyrenderer_tpu_torch.ops import raster as traster
from tinyrenderer_tpu_torch.ops import resolve as tresolve
from tinyrenderer_tpu_torch.ops import shadows as tshadows

W, H = 256, 128


def _t(a):
    return torch.from_numpy(np.array(a))


def _random_scene(seed: int, V: int = 120, T: int = 300):
    """tests/test_raster.py's generator: T triangles over V shared random
    vertices (most span many tiles: the big list)."""
    rng = np.random.default_rng(seed)
    ndc = rng.uniform(-1.2, 1.2, size=(V, 3)).astype(np.float32)
    ndc[:, 2] = rng.uniform(0.05, 0.95, size=V)
    w = rng.uniform(0.5, 2.0, size=(V, 1)).astype(np.float32)
    clip = np.concatenate([ndc * w, w], axis=1).astype(np.float32)
    return clip, rng.integers(0, V, size=(T, 3)).astype(np.int32)


def _small_scene(seed: int, T: int = 5000, cluster: bool = False):
    """T triangles of a few pixels (a high-poly mesh) and 12 large ones.
    ``cluster`` puts the small ones into the top right 8x128 tile, whose
    segment then outgrows the stream's walked window."""
    rng = np.random.default_rng(seed)
    lo, hi = ((0.2, 0.9), (0.8, 0.98)) if cluster else (-1.1, 1.1)
    xy = rng.uniform(lo, hi, (T, 1, 2)) + rng.uniform(-0.03, 0.03, (T, 3, 2))
    xy[:12] = rng.uniform(-1.5, 1.5, (12, 3, 2))
    w = rng.uniform(0.5, 2.0, (T, 3, 1))
    z = rng.uniform(0.05, 0.9, (T, 3, 1))
    clip = np.concatenate([xy * w, z * w, w], 2).reshape(-1, 4)
    return clip.astype(np.float32), np.arange(3 * T, dtype=np.int32).reshape(T, 3)


def _setups(clip, tri):
    """The JAX setup and the same arrays as a port TriangleSetup: binning
    is exact integer work on identical inputs."""
    mask = np.ones(tri.shape[0], bool)
    js = jraster.triangle_setup(jnp.asarray(clip), jnp.asarray(tri),
                                jnp.asarray(mask), W, H, "none")
    ts = traster.TriangleSetup(**{k: _t(getattr(js, k)) for k in
                                  ("rows", "valid", "bbox", "screen", "inv_w",
                                   "z_ndc")})
    return js, ts


def _assert_same(tb, jb, fields):
    for f in fields:
        a, b = getattr(tb, f).numpy(), np.asarray(getattr(jb, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def _scene(kind):
    return {"random": lambda: _random_scene(6), "small": lambda: _small_scene(7),
            "cluster": lambda: _small_scene(8, 6000, cluster=True)}[kind]()


@pytest.mark.parametrize("kind,th,capacity,big", [
    ("random", 16, 512, 512),     # roomy
    ("random", 8, 16, 32),        # bins cut, big list overflows
    ("small", 8, 256, 64),
])
def test_bin_triangles_scatter_matches(kind, th, capacity, big):
    js, ts = _setups(*_scene(kind))
    jb = jraster.bin_triangles_scatter(js, W, H, th, 128, capacity, big)
    tb = traster.bin_triangles_scatter(ts, W, H, th, 128, capacity, big)
    _assert_same(tb, jb, ("ids", "rows", "counts", "overflow", "big_overflow"))
    if big == 32:
        assert int(jb.big_overflow) > 32 and int(jb.overflow) > capacity


@pytest.mark.parametrize("kind,capacity,big", [
    ("random", 8192, 64),
    ("random", 2048, 512),        # stream cut below its pair count
    ("small", 8192, 4),           # big list overflows
    ("small", 4096, 64),          # cut: the highest tiles lose pairs
])
def test_bin_triangles_stream_matches(kind, capacity, big):
    js, ts = _setups(*_scene(kind))
    jb = jraster.bin_triangles_stream(js, W, H, 8, 128, capacity, big)
    tb = traster.bin_triangles_stream(ts, W, H, 8, 128, capacity, big)
    _assert_same(tb, jb, ("ids", "rows", "starts", "counts", "overflow",
                          "stream_overflow", "big_overflow"))
    if capacity <= 4096:
        assert int(jb.stream_overflow) > capacity
    if big == 4:
        assert int(jb.big_overflow) > 4


@pytest.mark.parametrize("kind,th,tw,capacity,kmax", [
    ("random", 8, 128, 8192, 256),    # tests/test_raster.py's cases
    ("random", 16, 128, 8192, 512),
    ("random", 64, 128, 2048, 128),
    ("small", 8, 128, 4096, 1024),    # a truncated stream
    ("cluster", 8, 128, 8192, 16),    # segment longer than the walked window
    ("random", 128, 128, 2048, 512),  # 128^2 tiles: matrix-product rounding
])
def test_rasterize_stream_matches_pallas(kind, th, tw, capacity, kmax):
    js, ts = _setups(*_scene(kind))
    jb = jraster.bin_triangles_stream(js, W, H, th, tw, capacity)
    tb = traster.bin_triangles_stream(ts, W, H, th, tw, capacity)
    ty, tx = tb.counts.shape
    jid, jz = jraster.rasterize_stream(jb, ty, tx, th, tw, kmax)
    tid, tz = traster.rasterize_stream(tb, ty, tx, th, tw, kmax)
    assert (np.asarray(jid) >= 0).mean() > 0.2
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    np.testing.assert_array_equal(tz.numpy().view(np.int32),
                                  np.asarray(jz).view(np.int32))
    if kind == "cluster":     # the walk really cut the long segment
        _, stop = traster.walked_windows(tb.starts, capacity, kmax)
        assert int((tb.starts[1:] - stop).max()) > 0


@pytest.mark.parametrize("slim", [True, False])
@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("kmax", [4096, 16])
def test_select_eval_stream_matches_pallas(slim, bf16, kmax):
    """K5's plain version against select_eval_stream(raw=True). kmax 4096
    walks nb = 3 blocks, so every short segment has padding grid steps in
    the reference; with kmax 16 (nb = 2) the walked window of the
    clustered tile misses winners of a raster that walked 3 blocks, and
    those pixels are zero."""
    js, ts = _setups(*_scene("cluster"))
    jb = jraster.bin_triangles_stream(js, W, H, 8, 128, 8192)
    tb = traster.bin_triangles_stream(ts, W, H, 8, 128, 8192)
    ty, tx = tb.counts.shape
    jid, _ = jraster.rasterize_stream(jb, ty, tx, 8, 128, 4096)
    rng = np.random.default_rng(9)
    D = tresolve.ROW_D_SLIM if slim else tresolve.ROW_D
    table = np.where(np.asarray(js.valid)[:, None],
                     rng.standard_normal((js.rows.shape[0], D)), 0.0
                     ).astype(np.float32)
    jf, jh = jresolve.select_eval_stream(jid, jb, jnp.asarray(table), 8, 128,
                                         kmax, bf16=bf16, raw=True, slim=slim)
    tf, th = tresolve.select_eval_stream(_t(jid), tb, _t(table), 8, 128,
                                         kmax, bf16=bf16)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert th.dtype == (torch.bfloat16 if bf16 else torch.float32)
    np.testing.assert_array_equal(th.float().numpy(),
                                  np.asarray(jh).astype(np.float32))
    missing = (np.asarray(jid) >= 0) & (tf[-1].numpy() == 0)
    assert missing.any() == (kmax == 16)


def test_render_shadow_views_scatter_matches():
    """Two depth-only views of a pool above 4096 triangles: scatter bins
    with a big list of 4, K1. Atlas bit-equal to the jitted reference,
    bin and big-triangle monitors exact (the big count is the max across
    views, no longer a constant 0)."""
    clip, tri = _small_scene(10)
    clip2 = clip.copy()
    clip2[:, 0] *= -1.0                       # mirrored second view
    views = np.stack([clip, clip2])
    mask = np.ones(tri.shape[0], bool)
    fn = jax.jit(functools.partial(jshadows.render_shadow_views, size=128,
                                   tile=32, bin_capacity=1024, big_capacity=4))
    ja, jo, jbig = fn(jnp.asarray(views), jnp.asarray(tri), jnp.asarray(mask))
    (ta, to, tbig), port, f64 = planes.three(
        lambda: tshadows.render_shadow_views(
            _t(views), _t(tri), _t(mask), 128, 32, 1024, big_capacity=4))
    assert int(to) == int(jo) and int(tbig) == int(jbig) > 4
    # the parity decision (tests/planes.py): bit-equal under the JAX
    # package's rounding of the planes; the port's own atlas held to the
    # float64 planes' and no farther from it than the jitted reference's
    np.testing.assert_array_equal(ta.numpy().view(np.int32),
                                  np.asarray(ja).view(np.int32))
    planes.assert_nearer({"depth": port[0]}, {"depth": ja}, {"depth": f64[0]},
                         ids=None)
