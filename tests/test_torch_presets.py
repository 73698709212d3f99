"""Port parity on the CPU for the configurations the port refused before
the environment slice and for the three presets: the port engine's frame
against the JAX engine's compiled frame on its own pack, environment and
shadow atlas (the block-compacted exact sky, a sky scale that
does not divide the frame, the cubic sky upsample, the forward-only frame
with a non-integer sky, the native-size texture pool, and
``performance_preset``, ``fidelity_preset`` and ``reference_parity``),
and the native pool's pack and samplers against the JAX functions. Each
side builds its worlds and configurations from its own package."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import planes
import pytest
import torch

from tinyrenderer_tpu.config import RenderConfig as JRenderConfig
from tinyrenderer_tpu.ops import sampling as jsampling
from tinyrenderer_tpu.render import frame as jframe
from tinyrenderer_tpu.render.engine import Engine as JEngine
from tinyrenderer_tpu.render.scene_gpu import ScenePacker as JScenePacker
from tinyrenderer_tpu.scene import demo as jdemo
from tinyrenderer_tpu.utils import verify
from tinyrenderer_tpu_torch.config import RenderConfig
from tinyrenderer_tpu_torch.ops import sampling as tsampling
from tinyrenderer_tpu_torch.render import frame as tframe
from tinyrenderer_tpu_torch.render.engine import Engine as TEngine
from tinyrenderer_tpu_torch.render.scene_gpu import ScenePacker
from tinyrenderer_tpu_torch.scene import demo

CFG = RenderConfig(width=160, height=96, tile_h=16, tile_w=128,
                   bin_capacity=128, shadow_size=128, shadow_tile=128,
                   shadow_bin_capacity=128, env_size=32, irradiance_size=8,
                   texture_size=64, mip_levels=4)
WORLDS = {   # name -> build_demo_world keywords
    "textured": dict(n_cubes=9, textured_every=2),   # point light, billboard
    "flat": dict(n_cubes=9, with_point_light=False),
}


def _jcfg(cfg) -> JRenderConfig:
    return JRenderConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors: torch ops on one thread (the suite's workers share
    the host's cores, and a thread pool a worker oversubscribes them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_engines():
    """One JAX engine a world and its shadow atlases by their settings,
    shared by the cases (the environment depends only on the env sizes,
    which no case changes)."""
    return {name: JEngine.from_world(
        jdemo.build_demo_world(**kw),
        camera=jdemo.build_demo_camera(CFG.width, CFG.height), cfg=_jcfg(CFG))
        for name, kw in WORLDS.items()}, {}


def _jax_frame(world: str, cfg: RenderConfig, jax_engines):
    """The JAX engine's frame under ``cfg``: its pack (the envelope derived
    from the scene), its environment, the atlas of its shadow settings
    (each compiled once) and its compiled frame."""
    engines, atlases = jax_engines
    je = engines[world]
    je.cfg = _jcfg(cfg)
    je._needs_pack = True
    je.update()
    c = je.cfg
    key = (world, c.shadow_size, c.shadow_tile, c.shadow_bin_capacity,
           c.bin_big_capacity, c.shadow_bf16, c.use_pallas,
           c.num_point_lights, c.num_directional_lights)
    if key not in atlases:
        atlases[key] = jframe.compiled_shadow_atlas(c)(je._pack.scene,
                                                       je._pack.lights)[0]
    return je, jframe.compiled_frame(c)(
        je._pack.scene, je._packer.pool_for(c), je._pack.lights,
        jnp.asarray(je.camera.to_raw()), je.params, je._ensure_env(),
        atlases[key])


def _frames_agree(world: str, cfg: RenderConfig, jax_engines):
    """The port engine's first frame and the JAX engine's under ``cfg``:
    the same derived envelope; under the JAX package's rounding of the
    raster planes (tests/planes.py), equal pick ids and depth, and the
    tone-mapped frames pass the repo's edge-aware comparator; the port's
    own frame is held to the JAX frame by ``planes.hold_frame`` (no
    farther from the float64 planes' frame than the JAX frame, the
    edge-aware comparator, the sky and tex monitors)."""
    je, j_out = _jax_frame(world, cfg, jax_engines)
    te = TEngine.from_world(
        demo.build_demo_world(**WORLDS[world]),
        camera=demo.build_demo_camera(cfg.width, cfg.height), cfg=cfg,
        device="cpu")
    port = te.run_frame(0.0)
    t_out, f64 = planes.beside(lambda: planes.rerun(te))
    planes.hold_frame(port, j_out, f64, ("sky_blocks", "tex_overflow"))
    assert dataclasses.asdict(te.cfg) == dataclasses.asdict(je.cfg)
    jp = np.asarray(j_out.pick_id)
    assert np.array_equal(t_out.pick_id.numpy(), jp)
    assert np.array_equal(t_out.depth.numpy(), np.asarray(j_out.depth))
    res = verify.edge_aware_compare(t_out.sdr.numpy(), np.asarray(j_out.sdr),
                                    pick=jp)
    assert res["status"] == "pass", res
    assert len(np.unique(jp)) > 2 and (jp == 0).any()   # geometry + sky
    assert int(t_out.sky_blocks) == int(j_out.sky_blocks)
    assert t_out.tex_overflow.tolist() == np.asarray(j_out.tex_overflow).tolist()
    return te, port


# the six configurations the port refused before this slice
@pytest.mark.parametrize("world,change", [
    ("textured", dict(sky_block_capacity=256, fused_shading=False)),
    ("textured", dict(sky_scale=3)),                  # 256 % 3: a resize
    ("textured", dict(sky_scale=8, sky_upsample="cubic", use_pallas=False)),
    ("flat", dict(sky_block_capacity=256)),           # no overlay, slim table
    ("textured", dict(sky_scale=3, fused_resolve=True, forward_only=True)),
    ("textured", dict(native_texture_pool=True)),
], ids=["block_sky_unfused", "sky_scale_3", "cubic_sky", "block_sky_flat",
        "forward_only_sky_scale_3", "native_pool"])
def test_engine_frame_matches_jax(world, change, jax_engines):
    cfg = dataclasses.replace(CFG, **change)
    te, out = _frames_agree(world, cfg, jax_engines)
    assert te.cfg.has_forward == (world == "textured")
    if cfg.sky_block_capacity and not cfg.forward_only:
        assert int(out.sky_blocks) > 0
    if cfg.native_texture_pool:
        pool = te._packer.pool_for(te.cfg, "cpu")
        assert isinstance(pool, tsampling.NativeTexturePoolGPU)
        assert int(out.tex_overflow[0]) > 0           # textured blocks


@pytest.mark.parametrize("preset", ["performance_preset", "fidelity_preset",
                                    "reference_parity"])
def test_preset_engine_frame_matches_jax(preset, jax_engines):
    """The presets on the textured world. ``reference_parity`` asks for a
    1024-texel pool with ten levels; the test keeps 64 and 4 (the pool's
    envelope, not a rendering option) so that a case stays within seconds
    on the CPU; its native pool keeps each record at its own size."""
    cfg = getattr(CFG, preset)()
    if preset == "reference_parity":
        cfg = dataclasses.replace(cfg, texture_size=64, mip_levels=4)
        assert cfg.native_texture_pool and cfg.sky_scale == 1
    te, _ = _frames_agree("textured", cfg, jax_engines)
    assert tframe.use_fused_shading(te.cfg)


# ---- the native-size pool ----------------------------------------------------

def _chains(seed=0):
    """Three records: square 16 (4 levels), non-square 8x32 (3), and 12x6
    with an odd second level (2)."""
    rng = np.random.default_rng(seed)

    def chain(h, w, n):
        return [rng.uniform(0, 1, (h >> i, w >> i, 9)).astype(np.float32)
                for i in range(n)]
    return [chain(16, 16, 4), chain(8, 32, 3), chain(12, 6, 2)]


@pytest.mark.parametrize("windowed,wrap", [(True, True), (True, False),
                                           (False, True)])
def test_pack_native_pool_bit_equal(windowed, wrap):
    j = jsampling.pack_native_pool(_chains(), windowed=windowed, wrap=wrap)
    t = tsampling.pack_native_pool(_chains(), windowed=windowed, wrap=wrap)
    for f in ("texels", "base_tab", "level_tab"):
        a, b = getattr(t, f).numpy(), np.asarray(getattr(j, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for f in ("max_levels", "base_size", "windowed", "base_channels", "u8"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.level_sizes == j.level_sizes == (32,) * 4


def _native_inputs(seed=1):
    """Record ids, a uv field whose screen derivatives span levels 0 to
    past the end (scale varies by row), and fractional levels."""
    rng = np.random.default_rng(seed)
    H, W = 32, 256
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    sc = (2.0 ** rng.uniform(-9, -1, (H, 1))).astype(np.float32)
    uv = np.stack([xs * sc + rng.uniform(-1, 1, (H, 1)),
                   ys * sc[::-1] * 0.7 + xs * 0.001], -1).astype(np.float32)
    rec = rng.integers(0, 3, (H, W)).astype(np.int32)
    lvl = rng.uniform(-0.5, 5.0, (H, W)).astype(np.float32)
    return rec, uv, lvl


@pytest.mark.parametrize("filt", ["trilinear", "dithered", "bilinear",
                                  "stochastic"])
@pytest.mark.parametrize("windowed,wrap,with_duv", [
    (True, True, True), (True, False, True), (False, True, True),
    (False, False, True), (True, True, False)])
def test_sample_native_pool_mip_matches_jax(filt, windowed, wrap, with_duv):
    """Every filter, both layouts and both edge modes, with the exact
    per-record level (uv derivatives) and with the rebiased scalar level:
    within 5e-7 of the jitted JAX sampler (a few ulp of values in [0, 1]:
    XLA fuses the bilinear and the trilinear blends differently case by
    case; the level and texel choices are equal). Windowed u8 taps go
    through the K7 wrapper, its plain version here."""
    jp = jsampling.pack_native_pool(_chains(), windowed=windowed, wrap=wrap)
    tp = tsampling.pack_native_pool(_chains(), windowed=windowed, wrap=wrap)
    rec, uv, lvl = _native_inputs()
    fn = jax.jit(lambda p, r, u, l: jsampling.sample_pool_mip(
        p, r, u, l, wrap=wrap, filter=filt,
        duv=jsampling.uv_derivatives(u) if with_duv else None))
    want = np.asarray(fn(jp, jnp.asarray(rec), jnp.asarray(uv),
                         jnp.asarray(lvl)))
    tuv = torch.from_numpy(uv)
    got = tsampling.sample_pool_mip(
        tp, torch.from_numpy(rec), tuv, torch.from_numpy(lvl), wrap=wrap,
        filter=filt, duv=tsampling.pool_duv(tp, tuv) if with_duv else None)
    assert got.shape == want.shape == (32, 256, 9)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-7)


def test_native_pool_gpu_of_a_loaded_texture(tmp_path):
    """A 128-texel asset in a 32-texel pyramid: the port's packer keeps it
    at its own size in the native pool, bit-equal to the JAX packer's."""
    from PIL import Image
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (128, 64, 4), dtype=np.uint8)
    p = os.path.join(str(tmp_path), "tex.png")
    Image.fromarray(img, "RGBA").save(p)
    cfg = dataclasses.replace(CFG, texture_size=32, mip_levels=4)
    pools = []
    for packer in (ScenePacker(cfg), JScenePacker(_jcfg(cfg))):
        slot = packer.pool.get_or_load(p, "Albedo")
        packer.pool.get_or_make_record((slot, 1, 2, 3))
        packer._pool_dirty = True
        pools.append(packer.native_pool_gpu("cpu") if packer.__class__ is
                     ScenePacker else packer.native_pool_gpu())
    t, j = pools
    assert t.base_size == j.base_size == 128
    for f in ("texels", "base_tab", "level_tab"):
        assert np.array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f))), f
    tp = ScenePacker(cfg)
    assert tp.pool_for(dataclasses.replace(cfg, native_texture_pool=True),
                       "cpu").windowed
