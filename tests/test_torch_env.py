"""Port parity on the CPU for the environment chain and the sky options:
the irradiance bake, the IBL cache file, the HDR skybox engine, the
rendering actions, the block-compacted exact sky and its monitor, the
cubic and non-integer sky upsamples, the on-device re-mip and the
per-light shadow lookups, against the JAX package. Each side builds its
worlds and configurations from its own package."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyrenderer_tpu.assets import hdr as jhdr
from tinyrenderer_tpu.config import RenderConfig as JRenderConfig
from tinyrenderer_tpu.ops import env as jenv
from tinyrenderer_tpu.ops import post as jpost
from tinyrenderer_tpu.ops import sampling as jsampling
from tinyrenderer_tpu.ops import shadows as jshadows
from tinyrenderer_tpu.render import frame as jframe
from tinyrenderer_tpu.render.engine import Engine as JEngine
from tinyrenderer_tpu.scene import demo as jdemo
from tinyrenderer_tpu.scene import lights as jlights
from tinyrenderer_tpu_torch.assets import hdr as thdr
from tinyrenderer_tpu_torch.config import RenderConfig
from tinyrenderer_tpu_torch.ops import env as tenv
from tinyrenderer_tpu_torch.ops import post as tpost
from tinyrenderer_tpu_torch.ops import sampling as tsampling
from tinyrenderer_tpu_torch.ops import shadows as tshadows
from tinyrenderer_tpu_torch.render import frame as tframe
from tinyrenderer_tpu_torch.render.engine import Engine as TEngine
from tinyrenderer_tpu_torch.render.engine import RenderingAction
from tinyrenderer_tpu_torch.scene import demo, level_io

CFG = RenderConfig(width=160, height=96, tile_h=16, tile_w=128,
                   bin_capacity=128, shadow_size=128, shadow_tile=128,
                   shadow_bin_capacity=128, env_size=32, irradiance_size=8,
                   texture_size=64, mip_levels=4)
# the bake's bar: both sides sum the same 3213 weighted cube samples per
# texel in the same chunks; the rounding of the tangent frame and of the
# in-chunk sum differs
BAKE_TOL = dict(rtol=1e-5, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors: torch ops on one thread (the suite's workers share
    the host's cores, and a thread pool a worker oversubscribes them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_engine(cfg=CFG, **kw) -> TEngine:
    return TEngine.from_world(
        demo.build_demo_world(n_cubes=9, with_point_light=False),
        camera=demo.build_demo_camera(cfg.width, cfg.height), cfg=cfg,
        device="cpu", **kw)


@pytest.fixture(scope="module")
def hdr_file(tmp_path_factory):
    """An HDR skybox written from the procedural sky (no download)."""
    p = tmp_path_factory.mktemp("sky") / "sky.hdr"
    p.write_bytes(thdr.encode_hdr(thdr.procedural_sky(32, 64)))
    return str(p)


@pytest.fixture(scope="module")
def jax_skybox_env(hdr_file):
    """The JAX engine's environment of the HDR skybox (its bake jitted)."""
    je = JEngine(cfg=JRenderConfig(**dataclasses.asdict(CFG)),
                 skybox_path=hdr_file)
    return je, je._ensure_env()


def test_irradiance_sample_dirs_bit_equal():
    for mine, theirs in zip(tenv.irradiance_sample_dirs(),
                            jenv.irradiance_sample_dirs()):
        np.testing.assert_array_equal(mine, theirs)
    assert tenv.irradiance_sample_dirs()[2] == 51 * 63


@pytest.mark.parametrize("env_size,size", [(16, 4), (32, 8)])
def test_bake_irradiance_matches_jax(env_size, size):
    eq = jhdr.procedural_sky(32, 64)
    cube = jframe.bake_env_cubemap(jnp.asarray(eq), env_size,
                                   gamma_decode=False)
    j = np.asarray(jframe.bake_irradiance(cube, size))
    t = tframe.bake_irradiance(_t(cube), size)
    assert t.shape == (6, size, size, 3) and t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), j, **BAKE_TOL)
    np.testing.assert_allclose(
        tframe.project_irradiance_sh(t).numpy(),
        np.asarray(jframe.project_irradiance_sh(jnp.asarray(j))), **BAKE_TOL)


def test_hdr_skybox_engine_matches_jax(hdr_file, jax_skybox_env, tmp_path):
    """Both engines load the same HDR file, gamma-decode it, bake the cube
    and its irradiance (no cache on the JAX side); the port writes its
    bake to the cache path."""
    _, jenv_ = jax_skybox_env
    cache = tmp_path / "ibl.data"
    te = _port_engine(skybox_path=hdr_file, ibl_cache_path=str(cache))
    env = te._ensure_env()
    assert te._equirect_is_file
    np.testing.assert_allclose(env.env_cube.numpy(),
                               np.asarray(jenv_.env_cube), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(env.irradiance.numpy(),
                               np.asarray(jenv_.irradiance), **BAKE_TOL)
    np.testing.assert_allclose(env.irradiance_sh.numpy(),
                               np.asarray(jenv_.irradiance_sh), **BAKE_TOL)
    s = CFG.irradiance_size
    assert cache.stat().st_size == 6 * s * s * 4 * 2
    assert np.isfinite(env.irradiance.numpy()).all()
    assert env.irradiance.min() > 0


def test_ibl_cache_byte_identical_and_round_trip(jax_skybox_env, tmp_path):
    """The port's cache file of an irradiance map is byte for byte the
    reference's ``write_ibl_to_file`` of the same array, and a second
    engine loads it bit-equal to the file's float16 values."""
    je, jenv_ = jax_skybox_env
    irr = np.asarray(jenv_.irradiance)
    te = _port_engine()
    te.render()
    ours, theirs = tmp_path / "port.data", tmp_path / "jax.data"
    te.write_ibl_to_file(str(ours), _t(irr))
    je.write_ibl_to_file(str(theirs), jenv_.irradiance)
    assert ours.read_bytes() == theirs.read_bytes()
    again = _port_engine(ibl_cache_path=str(ours))._ensure_env().irradiance
    np.testing.assert_array_equal(
        again.numpy(), irr.astype(np.float16).astype(np.float32))
    # the engine's own map by default; a cache of another size is passed by
    te.write_ibl_to_file(str(ours))
    np.testing.assert_array_equal(
        np.fromfile(ours, np.float16).reshape(6, 8, 8, 4)[..., :3],
        te._ensure_env().irradiance.numpy().astype(np.float16))
    small = _port_engine(dataclasses.replace(CFG, irradiance_size=4),
                         ibl_cache_path=str(ours))._ensure_env().irradiance
    assert small.shape == (6, 4, 4, 3)


@pytest.mark.parametrize("action", [RenderingAction.GENERATE_CUBEMAP,
                                    RenderingAction.BAKE_IRRADIANCE,
                                    RenderingAction.SAVE_IRRADIANCE])
def test_drain_actions(action, tmp_path):
    """Each action as the reference drains it: GENERATE_CUBEMAP drops the
    environment (baked again on use), BAKE_IRRADIANCE replaces the embedded
    map by the bake of the env cube, SAVE_IRRADIANCE writes the cache."""
    cache = tmp_path / "ibl.data"
    te = _port_engine(ibl_cache_path=str(cache))
    assert te._actions == [RenderingAction.GENERATE_CUBEMAP]  # at startup
    te.render()
    assert te._actions == []
    env = te._ensure_env()
    te.add_action(action)
    te._drain_actions()
    assert te._actions == []
    if action == RenderingAction.GENERATE_CUBEMAP:
        assert te._env is None
        assert torch.equal(te._ensure_env().env_cube, env.env_cube)
    elif action == RenderingAction.BAKE_IRRADIANCE:
        baked = te._env.irradiance
        assert torch.equal(baked, tframe.bake_irradiance(env.env_cube, 8))
        assert not torch.equal(baked, env.irradiance)
        assert torch.equal(te._env.irradiance_sh,
                           tframe.project_irradiance_sh(baked))
        assert te._env.env_cube is env.env_cube
    else:
        raw = np.fromfile(cache, np.float16).reshape(6, 8, 8, 4)
        np.testing.assert_array_equal(raw[..., :3],
                                      env.irradiance.numpy().astype(np.float16))
        assert (raw[..., 3] == 1).all()


def test_set_skybox_save_level_and_present(hdr_file, tmp_path):
    te = _port_engine()
    sdr = te.present_numpy()
    assert sdr.shape == (96, 160, 3) and sdr.dtype == np.uint8
    assert np.array_equal(sdr, te.last_output.sdr.numpy())
    procedural = te._ensure_env().env_cube
    te.set_skybox(hdr_file)
    assert te._env is None and not torch.equal(te._ensure_env().env_cube,
                                               procedural)
    p = str(tmp_path / "demo.lvl")
    te.save_level(p)
    level = level_io.load_level(p)
    assert len(list(level.world.world_objects())) == len(
        list(te.world.world_objects()))


@pytest.mark.parametrize("rgbe", [False, True])
def test_skybox_colors_blocks_matches_jax(rgbe):
    cube = np.random.default_rng(4).uniform(0, 6, (6, 16, 16, 3)).astype(np.float32)
    raw = jdemo.build_demo_camera(256, 32).to_raw()
    proj_inv, rot_inv = raw[64:80].reshape(4, 4), raw[32:48].reshape(4, 4)[:3, :3]
    slots = np.array([5, 0, -1, 7, 2, -1], np.int32)
    win = jsampling.encode_rgbe_windowed(jnp.asarray(cube)) if rgbe else None
    j = np.asarray(jenv.skybox_colors_blocks(
        jnp.asarray(cube), jnp.asarray(proj_inv), jnp.asarray(rot_inv),
        jnp.asarray(slots), 8, 64, 4, 256, 32, rgbe_win=win))
    t = tenv.skybox_colors_blocks(
        _t(cube), _t(proj_inv), _t(rot_inv), _t(slots), 8, 64, 4, 256, 32,
        rgbe_win=_t(win) if rgbe else None).numpy()
    assert t.shape == (6, 8, 64, 3) and (t[[2, 5]] == 0).all()
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("fused", [True, False])
def test_block_sky_frame_equals_full_rate_sky(fused):
    """``sky_block_capacity > 0`` (the exact sky on the background blocks
    only) gives the frame of ``sky_scale=1`` exactly, fused and unfused,
    and reports the background blocks (the reference's
    test_sky_block_compaction_exact on the demo world)."""
    base = dataclasses.replace(CFG, fused_shading=fused)
    dense = _port_engine(dataclasses.replace(base, sky_scale=1)).run_frame()
    te = _port_engine(dataclasses.replace(base, sky_scale=8,
                                          sky_block_capacity=4096))
    blocks = te.run_frame()
    assert tframe.use_fused_shading(te.cfg) == fused
    assert (dense.pick_id == 0).sum() > 50            # sky is visible
    assert 0 < int(blocks.sky_blocks) <= 24           # 12 x 2 blocks of 8x128
    assert torch.equal(dense.sdr, blocks.sdr)
    assert int(dense.sky_blocks) == 0


def test_engine_grows_sky_block_capacity():
    """The skyblk monitor: a capacity below the background blocks grows in
    256-block steps with 12.5% headroom before the first frame is handed
    out, so that frame is already exact."""
    te = _port_engine(dataclasses.replace(CFG, sky_block_capacity=1))
    out = te.run_frame()
    wanted = int(out.sky_blocks)
    assert wanted > 1 and te.cfg.sky_block_capacity == 256
    dense = _port_engine(dataclasses.replace(CFG, sky_scale=1)).run_frame()
    assert torch.equal(out.sdr, dense.sdr)    # no block was dropped
    assert torch.equal(te.run_frame().sdr, dense.sdr)
    te.cfg = dataclasses.replace(te.cfg, width=1920, height=1080)
    te._apply_monitor_values(("skyblk",), [1000])
    assert te.cfg.sky_block_capacity == 1280


@pytest.mark.parametrize("s", [2, 3, 8])
@pytest.mark.parametrize("cf", [False, True])
def test_cubic_upsample_matches_jax(s, cf):
    img = np.random.default_rng(7).standard_normal((5, 7, 3)).astype(np.float32)
    if cf:
        img = np.ascontiguousarray(img.transpose(2, 0, 1))
        j = jpost.upsample_bicubic_int_cf(jnp.asarray(img), s, s)
        t = tpost.upsample_bicubic_int_cf(_t(img), s, s)
    else:
        j = jpost.upsample_bicubic_int(jnp.asarray(img), s, s)
        t = tpost.upsample_bicubic_int(_t(img), s, s)
    assert t.shape == j.shape
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("src,dst", [((32, 85), (96, 256)), ((7, 11), (20, 30)),
                                     ((12, 21), (96, 160))])
def test_resize_bilinear_matches_jax_at_non_integer_ratios(src, dst):
    """The sky of a scale the frame does not divide: the port's resize
    against ``jax.image.resize(..., "bilinear")``, to float rounding."""
    import jax
    img = np.random.default_rng(8).uniform(0, 4, src + (3,)).astype(np.float32)
    j = np.asarray(jax.image.resize(jnp.asarray(img), dst + (3,), "bilinear"))
    t = tpost.resize_bilinear(_t(img), *dst).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=2e-6)


@pytest.mark.parametrize("windowed,wrap", [(True, True), (True, False),
                                           (False, True)])
def test_remip_pool_device_matches_jax(windowed, wrap):
    """The on-device re-mip of a u8 pool whose level 0 changed: every
    level, re-windowed and re-quantized, bit-equal to the JAX re-mip."""
    rng = np.random.default_rng(9)
    mips = [rng.uniform(0, 1, (3, 16 >> i, 16 >> i, 9)).astype(np.float32)
            for i in range(4)]
    jp = jsampling.pack_texture_pool(mips, windowed=windowed, wrap=wrap,
                                     u8=True)
    jp.texels = jnp.asarray(rng.integers(0, 256, jp.texels.shape, np.uint8))
    tp = tsampling.pool_from_numpy(vars(jp), "cpu")
    j = jsampling.remip_pool_device(jp, wrap=wrap)
    t = tsampling.remip_pool_device(tp, wrap=wrap)
    assert t.texels.dtype == torch.uint8
    np.testing.assert_array_equal(t.texels.numpy(), np.asarray(j.texels))
    img = rng.standard_normal((2, 4, 6, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tsampling.window_rows_device(_t(img), wrap).numpy(),
        np.asarray(jsampling.window_rows_device(jnp.asarray(img), wrap)))
    np.testing.assert_array_equal(
        tpost.box_mip(_t(img[0])).numpy(),
        np.asarray(jpost.box_mip(jnp.asarray(img[0]))))


def _shadow_inputs():
    rng = np.random.default_rng(10)
    S = 32
    packed = jlights.pack_lights(
        [(np.array([0.5, 4.0, -0.5], np.float32), np.ones(3, np.float32)),
         (np.array([-3.0, 2.0, 2.0], np.float32), np.ones(3, np.float32))],
        [(np.array([-0.5, -1.0, -0.3], np.float32), np.ones(3, np.float32))])
    # blocky occluders around the receivers' reverse-Z depths: ~0.01-0.07
    # in the point lights' cubes, ~0.86-0.89 in the directional view
    lo, hi = np.full((13, 1, 1), 0.01), np.full((13, 1, 1), 0.05)
    lo[12], hi[12] = 0.86, 0.89
    depth = rng.uniform(lo, hi, (13, S // 4, S // 4)).astype(np.float32)
    atlas = np.repeat(np.repeat(depth, 4, 1), 4, 2)
    win = np.asarray(jshadows.window_depth_maps(jnp.asarray(atlas)))
    ys, xs = np.mgrid[0:24, 0:40].astype(np.float32)
    pos = np.stack([xs / 4.0 - 5.0, np.sin(xs / 5.0) + np.cos(ys / 3.0) - 1.5,
                    ys / 4.0 - 3.0], -1).astype(np.float32)
    return packed, win, pos


@pytest.mark.parametrize("form", ["directional", "point", "point_multi"])
def test_per_light_shadow_forms_match_jax(form):
    """The per-light lookups that shadow_multi batches, against the JAX
    functions: equal on at least 99.9% of pixels (a compare that sits
    exactly at the PCF boundary may flip with the projection's summation
    order)."""
    packed, win, pos = _shadow_inputs()
    vps = packed.shadow_viewprojs
    lp = packed.point_position[:2]
    if form == "directional":
        j = jshadows.directional_shadow(jnp.asarray(pos), jnp.asarray(vps[12]),
                                        jnp.asarray(win[12]), bias=0.001)
        t = tshadows.directional_shadow(_t(pos), _t(vps[12]), _t(win[12]),
                                        bias=0.001)
    elif form == "point":
        j = jshadows.point_shadow(jnp.asarray(pos), jnp.asarray(lp[1]),
                                  jnp.asarray(vps[6:12]), jnp.asarray(win[6:12]))
        t = tshadows.point_shadow(_t(pos), _t(lp[1]), _t(vps[6:12]),
                                  _t(win[6:12]))
    else:
        j = jshadows.point_shadow_multi(jnp.asarray(pos), jnp.asarray(lp),
                                        jnp.asarray(vps[:12]).reshape(2, 6, 4, 4),
                                        jnp.asarray(win[:12]))
        t = tshadows.point_shadow_multi(_t(pos), _t(lp), _t(win[:12]))
    j = np.asarray(j)
    assert t.shape == j.shape
    assert 0.05 < (j == 1).mean() < 0.95                # lit and shadowed
    assert (np.abs(t.numpy() - j) <= 1e-6).mean() >= 0.999
