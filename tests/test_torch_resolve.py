"""Port parity: tinyrenderer_tpu_torch.ops.resolve (resolve table and
select + eval) against the JAX resolve, on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyrenderer_tpu.ops import raster as jraster
from tinyrenderer_tpu.ops import resolve as jresolve
from tinyrenderer_tpu_torch.ops import raster as traster
from tinyrenderer_tpu_torch.ops import resolve as tresolve

W, H, TH, TW, K = 256, 128, 16, 128, 128


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(seed: int):
    """Random triangles with per-vertex attributes and instance tables."""
    rng = np.random.default_rng(seed)
    T, I, M = 100, 7, 5
    V = 3 * T
    w = rng.uniform(0.5, 2.0, V)
    clip = np.stack([rng.uniform(-1.2, 1.2, V) * w, rng.uniform(-1.2, 1.2, V) * w,
                     rng.uniform(0.05, 0.9, V) * w, w], axis=1).astype(np.float32)
    f = lambda c: rng.standard_normal((V, c)).astype(np.float32)  # noqa: E731
    return dict(
        clip=clip, vidx=rng.permutation(V).astype(np.int32).reshape(T, 3),
        mask=np.ones(T, bool), attrs=[f(3), f(2), f(3), f(3), f(3)],
        tri_instance=rng.integers(0, I, T).astype(np.int32),
        inst_object_id=rng.integers(1, 50, I).astype(np.int32),
        inst_material=rng.integers(0, M, I).astype(np.int32),
        mat_record=rng.integers(0, 9, M).astype(np.int32),
        mat_flat=rng.uniform(0, 1, (M, 6)).astype(np.float32))


def _tables(d, slim):
    js = jraster.triangle_setup(jnp.asarray(d["clip"]), jnp.asarray(d["vidx"]),
                                jnp.asarray(d["mask"]), W, H, "none")
    jt = jresolve.build_gbuffer_table(
        js, jnp.asarray(d["vidx"]), jresolve.VertexAttrs(*map(jnp.asarray, d["attrs"])),
        jnp.asarray(d["tri_instance"]), jnp.asarray(d["inst_object_id"]),
        jnp.asarray(d["inst_material"]), jnp.asarray(d["mat_record"]),
        jnp.asarray(d["mat_flat"]), slim=slim)
    ts = traster.TriangleSetup(**{k: _t(getattr(js, k)) for k in
                                  ("rows", "valid", "bbox", "screen", "inv_w", "z_ndc")})
    tt = tresolve.build_gbuffer_table(
        ts, _t(d["vidx"]), tresolve.VertexAttrs(*map(_t, d["attrs"])),
        _t(d["tri_instance"]), _t(d["inst_object_id"]), _t(d["inst_material"]),
        _t(d["mat_record"]), _t(d["mat_flat"]), slim=slim)
    return js, np.asarray(jt), tt


@pytest.mark.parametrize("slim", [True, False])
def test_build_gbuffer_table_matches(slim):
    _, jt, tt = _tables(_inputs(4), slim)
    assert tt.shape == jt.shape == (100, 28 if slim else 53)
    np.testing.assert_allclose(tt.numpy(), jt, rtol=1e-6)


@pytest.mark.parametrize("slim", [True, False])
@pytest.mark.parametrize("bf16", [True, False])
def test_select_eval_matches_pallas(slim, bf16):
    """K2's plain version against select_eval_pallas(raw=True): the f32
    outputs exact, the bf16 (or f32) attribute planes equal."""
    js, jt, _ = _tables(_inputs(5), slim)
    jb = jraster.bin_triangles_dense(js, W, H, TH, TW, K)
    jid, _ = jraster.rasterize_binned(jb, TH, TW, use_pallas=True)
    jf, jh = jresolve.select_eval_pallas(jid, jb.ids, jnp.asarray(jt), TH, TW,
                                         counts=jb.counts, bf16=bf16, raw=True,
                                         slim=slim)
    tf, th = tresolve.select_eval(_t(jid), _t(jt), bf16=bf16)
    assert (np.asarray(jid) >= 0).mean() > 0.2
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert th.dtype == (torch.bfloat16 if bf16 else torch.float32)
    np.testing.assert_array_equal(th.float().numpy(),
                                  np.asarray(jh).astype(np.float32))
