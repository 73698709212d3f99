"""Port parity for the forward overlay (light billboards, gizmos):
``forward_overlay_compose`` against the JAX function on the same binned
forward raster, table and texture pool (Pallas raster in interpret mode),
the batched compose against the scatter form ``forward_overlay_tiles``,
and a live tile 0 beside padded work-list slots."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyrenderer_tpu.ops import raster as jraster
from tinyrenderer_tpu.ops import resolve as jresolve
from tinyrenderer_tpu.ops import sampling as jsampling
from tinyrenderer_tpu_torch.ops import raster as traster
from tinyrenderer_tpu_torch.ops import resolve as tresolve
from tinyrenderer_tpu_torch.ops import sampling as tsampling
from tinyrenderer_tpu_torch.ops.fp import lerp

W, H, TH, TW = 256, 128, 32, 64          # 4 x 4 tiles


def _scene(seed: int = 0):
    """Eight perspective billboard quads (uv 0..1), one over tile 0; half
    of them textured (record 0..3 of a windowed u8 pool whose alpha
    varies), the rest flat. Returns numpy inputs + the JAX forward raster."""
    rng = np.random.default_rng(seed)
    n = 8
    centres = rng.uniform(-0.8, 0.8, (n, 2))
    centres[0] = (-0.85, 0.75)            # NDC top left: tile 0
    half = rng.uniform(0.08, 0.2, (n, 1))
    corners = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], np.float32)
    xy = centres[:, None, :] + half[:, None, :] * corners[None]   # (n, 4, 2)
    w = rng.uniform(1.0, 2.0, (n, 4, 1))
    z = rng.uniform(0.1, 0.9, (n, 1, 1)) * np.ones((n, 4, 1))
    clip = np.concatenate([xy * w, z * w, w], -1).reshape(-1, 4).astype(np.float32)
    quad = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    vidx = (quad[None] + 4 * np.arange(n)[:, None, None]).reshape(-1, 3)
    uv = np.tile(np.array([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32), (n, 1))
    V = 4 * n
    attrs = dict(world=rng.normal(0, 1, (V, 3)), uv=uv,
                 normal=rng.normal(0, 1, (V, 3)),
                 tangent=rng.normal(0, 1, (V, 3)),
                 bitangent=rng.normal(0, 1, (V, 3)))
    attrs = {k: np.asarray(v, np.float32) for k, v in attrs.items()}
    tri_inst = np.repeat(np.arange(n, dtype=np.int32), 2)
    mat_flat = np.concatenate([rng.uniform(0, 1, (n, 5)),
                               (np.arange(n) % 2 == 0)[:, None]], 1)
    inputs = dict(
        vidx=vidx, clip=clip, attrs=attrs, tri_inst=tri_inst,
        inst_oid=np.arange(1, n + 1, dtype=np.int32),
        inst_mat=np.arange(n, dtype=np.int32),
        mat_record=(np.arange(n) // 2 % 4).astype(np.int32),
        mat_flat=mat_flat.astype(np.float32),
        hdr=rng.uniform(0, 3, (H, W, 3)).astype(np.float32),
        pick=rng.integers(0, 50, (H, W)).astype(np.int32))
    mips = [rng.uniform(0, 1, (4, s, s, 9)).astype(np.float32)
            for s in (32, 16, 8, 4, 2)]
    pool = jsampling.pack_texture_pool(mips, windowed=True, u8=True)
    setup = jraster.triangle_setup(jnp.asarray(clip), jnp.asarray(vidx),
                                   jnp.ones(len(vidx), bool), W, H, "none")
    bins = jraster.bin_triangles(setup, W, H, TH, TW, 16, 64)
    f_id, _ = jraster.rasterize_binned(bins, TH, TW)
    table = jresolve.build_gbuffer_table(
        setup, jnp.asarray(vidx),
        jresolve.VertexAttrs(**{k: jnp.asarray(v) for k, v in attrs.items()}),
        jnp.asarray(tri_inst), jnp.asarray(inputs["inst_oid"]),
        jnp.asarray(inputs["inst_mat"]), jnp.asarray(inputs["mat_record"]),
        jnp.asarray(inputs["mat_flat"]))
    return inputs, pool, bins, f_id, table


def _port(pool, bins, f_id, table):
    tb = traster.Bins(*(torch.from_numpy(np.array(a)) for a in bins))
    return (tsampling.pool_from_numpy(vars(pool), "cpu"), tb,
            torch.from_numpy(np.array(f_id)), torch.from_numpy(np.array(table)))


@pytest.mark.parametrize("capacity", [8, 2, 0])
def test_forward_overlay_compose_matches_jax(capacity):
    """8: padded slots beside a live tile 0; 2: fewer slots than occupied
    tiles (the monitor reports the overflow); 0: every tile. The sprite's
    2x upsample rounds differently from ``jax.image.resize`` (edge clamp
    against renormalized weights, same values), so hdr within 2e-6 and
    pick equal."""
    inp, pool, bins, f_id, table = _scene()
    assert int(np.asarray(f_id)[:TH, :TW].max()) >= 0       # tile 0 is live
    fn = jax.jit(lambda h, p, f, b, t, pl: jresolve.forward_overlay_compose(
        h, p, f, b, t, pl, TH, TW, capacity))
    jh, jp, jn = fn(jnp.asarray(inp["hdr"]), jnp.asarray(inp["pick"]), f_id,
                    bins, table, pool)
    tpool, tbins, tid, ttable = _port(pool, bins, f_id, table)
    th, tp, tn = tresolve.forward_overlay_compose(
        torch.from_numpy(inp["hdr"]), torch.from_numpy(inp["pick"]), tid,
        tbins, ttable, tpool, TH, TW, capacity)
    assert int(tn) == int(jn) > 2
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=2e-6)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    changed = (np.asarray(jh) != inp["hdr"]).any(-1)
    assert changed[:TH, :TW].any() and changed.mean() > 0.02


@pytest.mark.parametrize("capacity", [8, 0])
def test_compose_equals_tiles(capacity):
    """The batched compose equals blending the scatter form's full-image
    outputs, bit for bit, and leaves pixels outside live tiles untouched."""
    inp, pool, bins, f_id, table = _scene(1)
    tpool, tbins, tid, ttable = _port(pool, bins, f_id, table)
    hdr, pick = torch.from_numpy(inp["hdr"]), torch.from_numpy(inp["pick"])
    ch, cp, cn = tresolve.forward_overlay_compose(hdr, pick, tid, tbins,
                                                  ttable, tpool, TH, TW,
                                                  capacity)
    color, alpha, oid, valid, n = tresolve.forward_overlay_tiles(
        tid, tbins, ttable, tpool, TH, TW, capacity)
    assert int(n) == int(cn)
    assert torch.equal(ch, lerp(hdr, color, alpha[..., None]))
    assert torch.equal(cp, torch.where(valid & (alpha > 0.5), oid, pick))
    occupied = (tbins.counts > 0).repeat_interleave(TH, 0).repeat_interleave(TW, 1)
    assert torch.equal(ch[~occupied], hdr[~occupied])
    assert (cp != pick).any()
