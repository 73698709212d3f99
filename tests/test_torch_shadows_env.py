"""Port parity on the CPU for the shadow, compaction, environment and
post-processing ops of the slice against the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyrenderer_tpu.assets import hdr as hdrlib
from tinyrenderer_tpu.ops import compact as jcompact
from tinyrenderer_tpu.ops import env as jenv
from tinyrenderer_tpu.ops import post as jpost
from tinyrenderer_tpu.ops import sampling as jsampling
from tinyrenderer_tpu.ops import shadows as jshadows
from tinyrenderer_tpu.scene import lights as lightslib
from tinyrenderer_tpu_torch.ops import compact as tcompact
from tinyrenderer_tpu_torch.ops import env as tenv
from tinyrenderer_tpu_torch.ops import post as tpost
from tinyrenderer_tpu_torch.ops import sampling as tsampling
from tinyrenderer_tpu_torch.ops import shadows as tshadows


def _t(a):
    return torch.from_numpy(np.array(a))


def test_window_depth_maps_exact():
    atlas = np.random.default_rng(0).uniform(0, 1, (3, 16, 16)).astype(np.float32)
    np.testing.assert_array_equal(
        tshadows.window_depth_maps(_t(atlas)).numpy(),
        np.asarray(jshadows.window_depth_maps(jnp.asarray(atlas))))


@pytest.mark.parametrize("capacity", [5, 64])   # overflowing, roomy
def test_plan_and_scatter_blocks_exact(capacity):
    rng = np.random.default_rng(1)
    need = rng.uniform(size=40) < 0.3
    work = rng.standard_normal((capacity, 8, 16)).astype(np.float32)
    jp = jcompact.plan_blocks(jnp.asarray(need), capacity)
    tp = tcompact.plan_blocks(_t(need), capacity)
    for f in ("slots", "inv", "needed"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)))
    np.testing.assert_array_equal(
        tcompact.scatter_blocks(_t(work), tp).numpy(),
        np.asarray(jcompact.scatter_blocks(jnp.asarray(work), jp)))
    img = rng.standard_normal((16, 64, 3)).astype(np.float32)
    blocks = tcompact.to_blocks(_t(img), 8, 16)
    np.testing.assert_array_equal(
        blocks.numpy(), np.asarray(jcompact.to_blocks(jnp.asarray(img), 8, 16)))
    np.testing.assert_array_equal(
        tcompact.from_blocks(blocks, 16, 64).numpy(), img)


def _shadow_scene():
    """A synthetic 7-view windowed atlas (one point light's cube + one
    directional), world positions on a plane with boxes, and the lights."""
    rng = np.random.default_rng(2)
    S = 64
    packed = lightslib.pack_lights([(np.array([0.5, 4.0, -0.5], np.float32),
                                     np.ones(3, np.float32))],
                                   [(np.array([-0.5, -1.0, -0.3], np.float32),
                                     np.ones(3, np.float32))])
    depth = rng.uniform(0.0, 1.0, (7, S // 8, S // 8)).astype(np.float32)
    atlas = np.repeat(np.repeat(depth, 8, 1), 8, 2)          # blocky occluders
    H, W = 64, 128
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    pos = np.stack([xs / 8.0 - 8.0, np.sin(xs / 9.0) + np.cos(ys / 7.0) - 1.5,
                    ys / 8.0 - 4.0], -1).astype(np.float32)
    return packed, atlas, pos


@pytest.mark.parametrize("via_min", [False, True])
def test_gate_refined_visibility_matches(via_min, monkeypatch):
    """Both gate branches (windowed PCF, min-window map): gates equal on at
    least 99.9% of pixels. The margin: the light projection is a matrix
    product, summed in another order on each side, which can flip a
    compare that sits exactly at the PCF boundary."""
    packed, atlas, pos = _shadow_scene()
    monkeypatch.setattr(jshadows, "_GATE_VIA_MIN", via_min)
    monkeypatch.setattr(tshadows, "_GATE_VIA_MIN", via_min)
    win_j = jshadows.window_depth_maps(jnp.asarray(atlas)).astype(jnp.bfloat16)
    win_t = tshadows.window_depth_maps(_t(atlas)).to(torch.bfloat16)
    va, vs = jshadows.gate_fns(jnp.asarray(packed.point_position),
                               jnp.asarray(packed.shadow_viewprojs[:6]).reshape(1, 6, 4, 4),
                               jnp.asarray(packed.dir_viewproj), win_j, bias=0.0)
    jg, jn = jshadows.gate_refined_visibility(va, vs, jnp.asarray(pos), 8, 24,
                                              block_dims=(8, 32),
                                              channel_first=True)
    ta, ts = tshadows.gate_fns(_t(packed.point_position), _t(packed.dir_viewproj),
                               win_t, bias=torch.tensor(0.0))
    tg, tn = tshadows.gate_refined_visibility(ta, ts, _t(pos), 8, 24,
                                              block_dims=(8, 32))
    jg = np.asarray(jg)
    assert int(tn) == int(jn) and tg.shape == jg.shape == (2, 64, 128)
    assert 0.05 < jg.mean() < 0.95                  # both lit and shadowed
    assert (tg.numpy() == jg).mean() >= 0.999


def _cube(seed=3, S=16):
    return np.random.default_rng(seed).uniform(0.0, 6.0, (6, S, S, 3)).astype(np.float32)


def test_encode_rgbe_windowed_within_one_step():
    cube = _cube()
    j = np.asarray(jsampling.encode_rgbe_windowed(jnp.asarray(cube))).astype(int)
    t = tsampling.encode_rgbe_windowed(_t(cube)).numpy().astype(int)
    assert np.abs(t - j).max() <= 1


def test_equirect_to_cubemap_and_sh_match():
    eq = hdrlib.procedural_sky(32, 64)
    j = np.asarray(jenv.equirect_to_cubemap(jnp.asarray(eq), 16, False))
    t = tenv.equirect_to_cubemap(_t(eq), 16, gamma_decode=False).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-5)
    # rtol 1e-5 plus atol 1e-6 (coefficients are ~0.1-1): the small
    # coefficients are sums of 6 * 16 * 16 solid-angle-weighted terms that
    # cancel, and the two einsums sum them in different orders
    np.testing.assert_allclose(tenv.sh_project_cubemap(_t(j)).numpy(),
                               np.asarray(jenv.sh_project_cubemap(jnp.asarray(j))),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("rgbe", [True, False])
def test_skybox_colors_match(rgbe):
    cube = _cube(4)
    from tinyrenderer_tpu.scene import demo
    raw = demo.build_demo_camera(64, 32).to_raw()
    proj_inv, view_inv = raw[64:80].reshape(4, 4), raw[32:48].reshape(4, 4)
    win = jsampling.encode_rgbe_windowed(jnp.asarray(cube)) if rgbe else None
    j = np.asarray(jenv.skybox_colors(jnp.asarray(cube), jnp.asarray(proj_inv),
                                      jnp.asarray(view_inv[:3, :3]), 64, 32,
                                      rgbe_win=win))
    t = tenv.skybox_colors(_t(cube), _t(proj_inv), _t(view_inv[:3, :3]), 64, 32,
                           rgbe_win=_t(win) if rgbe else None).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-5)


@pytest.mark.parametrize("tone", [0, 1, 2, 3])
def test_tone_map_matches(tone):
    hdr = np.random.default_rng(5).uniform(0, 4, (16, 32, 3)).astype(np.float32)
    j = np.asarray(jpost.tone_map(jnp.asarray(hdr), jnp.float32(tone),
                                  jnp.float32(1.3)))
    t = tpost.tone_map(_t(hdr), torch.tensor(float(tone)),
                       torch.tensor(1.3)).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-6)


def test_upsample_bilinear_int_cf_matches():
    img = np.random.default_rng(6).standard_normal((3, 5, 7)).astype(np.float32)
    j = np.asarray(jpost.upsample_bilinear_int_cf(jnp.asarray(img), 8, 8))
    t = tpost.upsample_bilinear_int_cf(_t(img), 8, 8).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-6)
