"""Port parity: tinyrenderer_tpu_torch.ops.raster against the JAX raster.

Random clip-space triangles from a seeded numpy generator go through both
packages on the CPU; the JAX raster kernel runs in Pallas interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyrenderer_tpu.ops import raster as jraster
from tinyrenderer_tpu_torch.ops import raster as traster


def _clip_tris(seed: int, T: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    V = 3 * T
    w = rng.uniform(0.5, 2.0, V)
    clip = np.stack([rng.uniform(-1.2, 1.2, V) * w, rng.uniform(-1.2, 1.2, V) * w,
                     rng.uniform(0.05, 0.9, V) * w, w], axis=1).astype(np.float32)
    clip[:4, 3] = -0.5                       # a few triangles behind the eye
    vidx = rng.permutation(V).astype(np.int32).reshape(T, 3)
    mask = rng.uniform(size=T) > 0.1
    return clip, vidx, mask


def _t(a):
    return torch.from_numpy(np.array(a))


def _jbins_to_torch(b) -> traster.Bins:
    return traster.Bins(ids=_t(b.ids), rows=_t(b.rows), counts=_t(b.counts),
                        overflow=_t(b.overflow), big_overflow=_t(b.big_overflow))


@pytest.mark.parametrize("cull", ["back", "front", "none"])
def test_triangle_setup_matches(cull):
    """Compiled (jit) setup, as the reference frame runs it: its fused
    multiply-adds are the ones the port reproduces (ops/fp.py)."""
    clip, vidx, mask = _clip_tris(1, 96)
    j = jax.jit(jraster.triangle_setup, static_argnums=(3, 4, 5))(
        jnp.asarray(clip), jnp.asarray(vidx), jnp.asarray(mask), 256, 128, cull)
    t = traster.triangle_setup(_t(clip), _t(vidx), _t(mask), 256, 128, cull)
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    for name in ("rows", "bbox", "screen", "inv_w", "z_ndc"):
        np.testing.assert_allclose(getattr(t, name).numpy(),
                                   np.asarray(getattr(j, name)), rtol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("W,H", [(256, 96), (1536, 832), (1920, 1088)])
@pytest.mark.parametrize("cull", ["back", "none"])
def test_triangle_setup_bit_equal_at_any_size(W, H, cull):
    """Padded sizes that are not powers of two (the 75% frame, 1080p): the
    compiled setup fuses the screen scaling into the corner differences,
    and the port follows it, so every output is bit-equal."""
    clip, vidx, mask = _clip_tris(5, 200)
    j = jax.jit(jraster.triangle_setup, static_argnums=(3, 4, 5))(
        jnp.asarray(clip), jnp.asarray(vidx), jnp.asarray(mask), W, H, cull)
    t = traster.triangle_setup(_t(clip), _t(vidx), _t(mask), W, H, cull)
    assert np.asarray(j.valid).mean() > 0.2
    for name in ("valid", "rows", "bbox", "screen", "inv_w", "z_ndc"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)),
                                      err_msg=name)


@pytest.mark.parametrize("capacity", [128, 32])   # sort branch, top_k branch
def test_bin_triangles_dense_matches(capacity):
    clip, vidx, mask = _clip_tris(2, 80)
    j = jraster.triangle_setup(jnp.asarray(clip), jnp.asarray(vidx),
                               jnp.asarray(mask), 256, 128, "none")
    jb = jraster.bin_triangles_dense(j, 256, 128, 16, 128, capacity)
    t = traster.triangle_setup(_t(clip), _t(vidx), _t(mask), 256, 128, "none")
    # bin the same setup on both sides: binning is exact integer work
    t.bbox, t.valid, t.rows = _t(j.bbox), _t(j.valid), _t(j.rows)
    tb = traster.bin_triangles_dense(t, 256, 128, 16, 128, capacity)
    np.testing.assert_array_equal(tb.ids.numpy(), np.asarray(jb.ids))
    np.testing.assert_array_equal(tb.counts.numpy(), np.asarray(jb.counts))
    np.testing.assert_array_equal(tb.rows.numpy(), np.asarray(jb.rows))
    assert int(tb.overflow) == int(jb.overflow)


@pytest.mark.parametrize("view", ["main", "shadow"])
def test_rasterize_binned_matches_pallas(view):
    """K1's plain version against the Pallas kernel on the same bins:
    tri_id exact, depth bit-equal."""
    W, H, th, tw, K, cull = {"main": (256, 128, 16, 128, 128, "back"),
                             "shadow": (128, 128, 128, 128, 128, "front")}[view]
    clip, vidx, mask = _clip_tris(3, 120)
    j = jraster.triangle_setup(jnp.asarray(clip), jnp.asarray(vidx),
                               jnp.asarray(mask), W, H, cull)
    jb = jraster.bin_triangles_dense(j, W, H, th, tw, K)
    jid, jz = jraster.rasterize_binned(jb, th, tw, use_pallas=True)
    tid, tz = traster.rasterize_binned(_jbins_to_torch(jb), th, tw)
    assert (np.asarray(jid) >= 0).mean() > 0.2     # the scene covers pixels
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    np.testing.assert_array_equal(tz.numpy().view(np.int32),
                                  np.asarray(jz).view(np.int32))


@pytest.mark.parametrize("T", [4096, 4097])    # dense, scatter
def test_bin_triangles_dispatch_matches(T):
    """bin_triangles dispatches on the pool size as the reference: dense up
    to 4096 triangles, the two-level scatter binner above (bigs first,
    then smalls in ascending id)."""
    clip, vidx, mask = _clip_tris(4, T)
    j = jraster.triangle_setup(jnp.asarray(clip), jnp.asarray(vidx),
                               jnp.asarray(mask), 256, 128, "none")
    jb = jraster.bin_triangles(j, 256, 128, 16, 128, 512, big_capacity=256)
    t = traster.triangle_setup(_t(clip), _t(vidx), _t(mask), 256, 128, "none")
    t.bbox, t.valid, t.rows = _t(j.bbox), _t(j.valid), _t(j.rows)
    tb = traster.bin_triangles(t, 256, 128, 16, 128, 512, big_capacity=256)
    for f in ("ids", "rows", "counts", "overflow", "big_overflow"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)
    assert (int(tb.big_overflow) > 0) == (T > 4096)
