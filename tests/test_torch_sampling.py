"""Port parity for the texture half of ops/sampling.py and for
compact.sample_pool_compacted: the pool pack, the samplers under all four
filters, the windowed u8 blend (K7's plain version) against the JAX
Pallas kernel in interpret mode, and the mip-level estimate, all on the
CPU against the jitted JAX functions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyrenderer_tpu.ops import compact as jcompact
from tinyrenderer_tpu.ops import sampling as jsampling
from tinyrenderer_tpu_torch.ops import compact as tcompact
from tinyrenderer_tpu_torch.ops import sampling as tsampling

H, W = 32, 256           # two 8x128 compaction blocks a row of blocks


def _mips(seed: int, sizes=(16, 8, 4, 2), n: int = 4, C: int = 9):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, (n, s, s, C)).astype(np.float32) for s in sizes]


def _pools(windowed: bool, morton: bool, sizes=(16, 8, 4, 2)):
    mips = _mips(0, sizes)
    j = jsampling.pack_texture_pool(mips, windowed=windowed, u8=True,
                                    morton=morton)
    return j, tsampling.pool_from_numpy(vars(j), "cpu"), mips


def _inputs(seed: int, n: int = 4, nlev: int = 4):
    """Record ids, uv over several wraps, fractional levels past both ends
    of the chain."""
    rng = np.random.default_rng(seed)
    tex = rng.integers(0, n, (H, W)).astype(np.int32)
    uv = rng.uniform(-2.0, 3.0, (H, W, 2)).astype(np.float32)
    lvl = rng.uniform(-0.5, nlev - 0.5, (H, W)).astype(np.float32)
    return tex, uv, lvl


@pytest.mark.parametrize("windowed,morton", [(True, False), (False, False),
                                             (True, True), (False, True)])
def test_pool_from_numpy_matches_port_pack(windowed, morton):
    j, carried, mips = _pools(windowed, morton)
    own = tsampling.pack_texture_pool(mips, windowed=windowed, u8=True,
                                      morton=morton)
    assert own.texels.dtype == carried.texels.dtype == torch.uint8
    assert torch.equal(own.texels, carried.texels)
    for f in ("level_offsets", "level_sizes", "texels_per_tex", "windowed",
              "base_channels", "u8", "morton"):
        assert getattr(own, f) == getattr(carried, f) == getattr(j, f), f


@pytest.mark.parametrize("channel_first", [False, True])
@pytest.mark.parametrize("windowed,morton,sizes", [
    (True, False, (16, 8, 4, 2)), (False, False, (16, 8, 4, 2)),
    (True, True, (16, 8, 4, 2)),
    (False, False, (16, 8, 3))])        # not a halving chain: table lookup
@pytest.mark.parametrize("filt", ["dithered", "bilinear", "trilinear",
                                  "stochastic"])
def test_sample_pool_mip_matches_jax(filt, windowed, morton, sizes,
                                     channel_first):
    """Bit-equal: same gathers, and the blends fused as the reference's CPU
    build fuses them (fp.lerp; the u8 4-tap form with the decode scale on
    the weights). Trilinear within 3 ulp: the compiler fuses the two
    levels' taps and their blend differently from case to case."""
    j, t, _ = _pools(windowed, morton, sizes)
    tex, uv, lvl = _inputs(1, nlev=len(sizes))
    fn = jax.jit(lambda p, a, b, c: jsampling.sample_pool_mip(
        p, a, b, c, filter=filt, channel_first=channel_first))
    want = np.asarray(fn(j, jnp.asarray(tex), jnp.asarray(uv),
                         jnp.asarray(lvl)))
    got = tsampling.sample_pool_mip(t, torch.from_numpy(tex),
                                    torch.from_numpy(uv), torch.from_numpy(lvl),
                                    filter=filt, channel_first=channel_first)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_array_max_ulp(got.numpy(), want,
                                    maxulp=3 if filt == "trilinear" else 0)


@pytest.mark.parametrize("wrap", [True, False])
def test_bilinear_clamped_addressing_matches_jax(wrap):
    j, t, _ = _pools(True, False)
    tex, uv, _ = _inputs(2)
    lvl = np.random.default_rng(3).integers(0, 4, (H, W)).astype(np.int32)
    want = np.asarray(jax.jit(
        lambda p, a, b, c: jsampling._sample_bilinear_dynamic_level(
            p, a, b, c, wrap))(j, jnp.asarray(tex), jnp.asarray(uv),
                               jnp.asarray(lvl)))
    got = tsampling._sample_bilinear_dynamic_level(
        t, torch.from_numpy(tex), torch.from_numpy(uv), torch.from_numpy(lvl),
        wrap)
    np.testing.assert_array_equal(got.numpy(), want)


def _blend_inputs(N: int, R: int = 1000, C: int = 9):
    rng = np.random.default_rng(4)
    texels = rng.integers(0, 256, (R, 4 * C)).astype(np.uint8)
    idx = rng.integers(0, R, N).astype(np.int32)
    idx[:7] = R - 1                                  # the pool's last row
    fx = rng.uniform(0, 1, N).astype(np.float32)
    fy = rng.uniform(0, 1, N).astype(np.float32)
    fx[:3], fy[3:6] = 0.0, 1.0 - 2.0 ** -24
    return texels, idx, fx, fy


def test_windowed_blend_ref_matches_pallas_interpret():
    """K7's plain version against the TPU kernel (``_windowed_blend_kernel``
    in interpret mode, N divisible by 256): within 2 ulp, which is how far
    the reference's own Pallas and jnp forms lie apart (the plain version
    equals the jnp form, the default path's, bit for bit: next test)."""
    texels, idx, fx, fy = _blend_inputs(2048)
    want = np.asarray(jsampling._windowed_blend_u8(
        jnp.asarray(texels), jnp.asarray(idx), jnp.asarray(fx)[:, None],
        jnp.asarray(fy)[:, None], 9, channel_first=True))
    got = tsampling.windowed_blend(torch.from_numpy(texels),
                                   torch.from_numpy(idx), torch.from_numpy(fx),
                                   torch.from_numpy(fy), 9, channel_first=True)
    assert got.shape == want.shape == (9, 2048)
    np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=2)


def test_windowed_blend_ref_matches_jnp_blend():
    """Channel-last and channel-first against the reference's jnp windowed
    blend (the default path's form), bit-equal."""
    texels, idx, fx, fy = _blend_inputs(1000)
    C = 9

    def jblend(tx, i, a, b):
        row = jnp.take(tx, i, axis=0).astype(jnp.float32) * (1.0 / 255.0)
        a, b = a[:, None], b[:, None]
        return ((row[:, 0:C] * (1 - a) + row[:, C:2 * C] * a) * (1 - b)
                + (row[:, 2 * C:3 * C] * (1 - a) + row[:, 3 * C:] * a) * b)

    want = np.asarray(jax.jit(jblend)(jnp.asarray(texels), jnp.asarray(idx),
                                      jnp.asarray(fx), jnp.asarray(fy)))
    args = [torch.from_numpy(a) for a in (texels, idx, fx, fy)]
    np.testing.assert_array_equal(
        tsampling.windowed_blend(*args, C).numpy(), want)
    np.testing.assert_array_equal(
        tsampling.windowed_blend(*args, C, channel_first=True).numpy(), want.T)


def _uv_plane(seed: int):
    """A resolved-uv-like field: affine in screen space plus a little
    noise, with a fold so the derivatives cross mip levels."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    uv = np.stack([xx * 0.013 + yy * 0.002 + np.sin(xx * 0.05) * 0.3,
                   yy * 0.011 - xx * 0.003], -1)
    return (uv + rng.normal(0, 1e-3, uv.shape)).astype(np.float32)


def test_mip_level_from_uv_matches_jax():
    """Derivatives bit-equal; the level within 2 ulp (the CPU builds'
    ``log`` differ in the last bit); the dithered texel level it selects
    equal on every pixel here."""
    uv = _uv_plane(5)
    jd = np.asarray(jax.jit(jsampling.uv_derivatives)(jnp.asarray(uv)))
    jl = np.asarray(jax.jit(lambda u: jsampling.mip_level_from_uv(u, 256))(
        jnp.asarray(uv)))
    tuv = torch.from_numpy(uv)
    np.testing.assert_array_equal(tsampling.uv_derivatives(tuv).numpy(), jd)
    tl = tsampling.mip_level_from_uv(tuv, 256).numpy()
    np.testing.assert_array_max_ulp(tl, jl, maxulp=2)
    assert 0.5 < jl.max() and (jl > 0).mean() > 0.5
    thresh = np.tile(jsampling._BAYER4, (H // 4, W // 4))
    pick = lambda lv: np.floor(lv) + ((lv - np.floor(lv)) > thresh)  # noqa: E731
    assert (pick(tl) != pick(jl)).mean() == 0.0


@pytest.mark.parametrize("capacity", [3, 0, 8])   # compacted, dense, dense
def test_sample_pool_compacted_matches_jax(capacity):
    j, t, _ = _pools(True, False)
    tex, uv, lvl = _inputs(6)
    rng = np.random.default_rng(7)
    need = np.zeros((H, W), bool)
    need[rng.integers(0, H, 40), rng.integers(0, W, 40)] = True
    need[:8, 128:] = False                       # one block wants nothing
    fn = jax.jit(lambda p, a, b, c, d: jcompact.sample_pool_compacted(
        p, a, b, c, d, capacity))
    want, want_n = fn(j, jnp.asarray(tex), jnp.asarray(uv), jnp.asarray(lvl),
                      jnp.asarray(need))
    got, got_n = tcompact.sample_pool_compacted(
        t, torch.from_numpy(tex), torch.from_numpy(uv), torch.from_numpy(lvl),
        torch.from_numpy(need), capacity)
    assert int(got_n) == int(want_n) > 3
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if capacity == 3:                            # blocks left out: zeros
        assert (got.numpy() == 0).all(axis=-1).mean() > 0.4
