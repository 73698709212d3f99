"""Port parity for the whole slice: scene packing, the engine path, the
point + directional frame, the forward overlay (demo.lvl's light
billboard), the textured demo world and the forward-only frame against the
JAX package on the CPU (Pallas kernels in interpret mode), and the
texture capacity monitors. Each side builds its worlds and configurations
from its own package."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import planes
import pytest
import torch

from tinyrenderer_tpu.config import RenderConfig as JRenderConfig
from tinyrenderer_tpu.render import frame as jframe
from tinyrenderer_tpu.render.engine import Engine as JEngine
from tinyrenderer_tpu.scene import demo as jdemo
from tinyrenderer_tpu.utils import verify
from tinyrenderer_tpu_torch.config import RenderConfig
from tinyrenderer_tpu_torch.ops import sampling as tsampling
from tinyrenderer_tpu_torch.render import frame as tframe
from tinyrenderer_tpu_torch.render import scene_gpu as tscene
from tinyrenderer_tpu_torch.render.engine import Engine as TEngine
from tinyrenderer_tpu_torch.scene import demo

LEVEL = os.path.join(os.path.dirname(os.path.dirname(__file__)), "levels",
                     "demo.lvl")
CFG = RenderConfig(width=256, height=128, tile_h=16, tile_w=128,
                   bin_capacity=128, shadow_size=128, shadow_tile=128,
                   shadow_bin_capacity=128, env_size=32)


def _jcfg(cfg) -> JRenderConfig:
    return JRenderConfig(**dataclasses.asdict(cfg))


def _tcfg(cfg) -> RenderConfig:
    return RenderConfig(**dataclasses.asdict(cfg))


def _jax_engine(scene: str) -> JEngine:
    if scene == "level":
        return JEngine(cfg=_jcfg(CFG), level_path=LEVEL)
    return JEngine.from_world(
        jdemo.build_demo_world(n_cubes=9, with_point_light=False),
        camera=jdemo.build_demo_camera(CFG.width, CFG.height), cfg=_jcfg(CFG))


def _port_engine(scene: str) -> TEngine:
    if scene == "level":
        return TEngine(cfg=CFG, device="cpu", level_path=LEVEL)
    return TEngine.from_world(
        demo.build_demo_world(n_cubes=9, with_point_light=False),
        camera=demo.build_demo_camera(CFG.width, CFG.height), cfg=CFG,
        device="cpu")


def _host(nt) -> dict:
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def _assert_frames_agree(pick, depth, sdr, j_out):
    """pick_id and depth equal except on <= 0.1% of pixels; the tone-mapped
    frame passes the repo's edge-aware comparator."""
    jp, jd = np.asarray(j_out.pick_id), np.asarray(j_out.depth)
    assert (pick != jp).mean() <= 1e-3
    assert (depth != jd).mean() <= 1e-3
    res = verify.edge_aware_compare(sdr, np.asarray(j_out.sdr), pick=jp)
    assert res["status"] == "pass", res
    assert len(np.unique(jp)) > 2 and (jp == 0).any()   # geometry + sky


@pytest.mark.parametrize("scene", ["level", "demo_world"])
def test_scene_from_numpy_matches_port_pack(scene):
    """State carried across: the JAX pack's arrays, uploaded through
    scene_from_numpy / lights_from_numpy, equal the port's own pack of the
    same world built by the port's own scene modules."""
    je = _jax_engine(scene)
    je.update()
    te = _port_engine(scene)
    te.update()
    assert dataclasses.asdict(te.cfg) == dataclasses.asdict(je.cfg)
    assert te._pack.counts == je._pack.counts
    js = tscene.scene_from_numpy(_host(je._pack.scene), "cpu")
    jl = tscene.lights_from_numpy(_host(je._pack.lights), "cpu")
    for mine, theirs in ((te._pack.scene, js), (te._pack.lights, jl)):
        for f in dataclasses.fields(mine):
            a, b = getattr(mine, f.name), getattr(theirs, f.name)
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            assert torch.equal(a, b), f.name


def test_engine_frame_matches_jax_engine():
    """Engine path on the directional-only demo world (no forward
    triangles), the same config on both sides."""
    je = _jax_engine("demo_world")
    j_out = je.run_frame(0.0)
    te = _port_engine("demo_world")
    outs = planes.three(lambda: planes.rerun(te))
    # same derived envelope (lights, forward, tex)
    assert dataclasses.asdict(te.cfg) == dataclasses.asdict(je.cfg)
    assert jframe._use_fused_shading(je.cfg)
    _hold(outs, j_out)


def _frames(je: JEngine, cfg: JRenderConfig):
    """The JAX frame and the port's frame of one packed scene, pool,
    lights, camera, params and environment under ``cfg`` (atlas inline)."""
    env = je._ensure_env()
    cam = je.camera.to_raw()
    pool = je._packer.pool_for(cfg)
    j_out = jframe.compiled_frame(cfg)(
        je._pack.scene, pool, je._pack.lights, jnp.asarray(cam), je.params,
        env, None)
    t_env = tframe.EnvGPU(**{k: torch.from_numpy(np.array(v))
                             for k, v in env._asdict().items()})
    outs = planes.three(lambda: tframe.render_frame(
        tscene.scene_from_numpy(_host(je._pack.scene), "cpu"),
        tsampling.pool_from_numpy(vars(pool), "cpu"),
        tscene.lights_from_numpy(_host(je._pack.lights), "cpu"),
        torch.from_numpy(cam), torch.from_numpy(np.array(je.params)), t_env,
        _tcfg(cfg)))
    return outs, j_out


def _hold(outs, j_out):
    """The parity decision (tests/planes.py): the port's frame under the
    JAX package's rounding of the planes agrees with the JAX frame as
    before; the port's own frame is held to it by ``planes.hold_frame``
    (no farther from the float64 planes' frame than the JAX frame, the
    edge-aware comparator)."""
    under_jax, t_out, f64 = outs
    _assert_frames_agree(under_jax.pick_id.numpy(), under_jax.depth.numpy(),
                         under_jax.sdr.numpy(), j_out)
    planes.hold_frame(t_out, j_out, f64)
    return t_out


def test_point_and_directional_frame_matches_jax():
    """demo.lvl with the forward overlay switched off: P = 1, D = 1, seven
    shadow views, the atlas rendered inline; both frames get the same
    packed scene, lights, camera, params and environment."""
    je = _jax_engine("level")
    je.update()
    cfg = dataclasses.replace(je.cfg, has_forward=False)
    assert (cfg.num_point_lights, cfg.num_directional_lights) == (1, 1)
    assert not cfg.any_textured and jframe._use_fused_shading(cfg)
    outs, j_out = _frames(je, cfg)
    t_out = _hold(outs, j_out)


def test_overlay_frame_matches_jax():
    """demo.lvl as the CLI renders it: the point light's textured billboard
    is a forward triangle pair, composited by the overlay over the flat
    deferred frame (slim table: the billboard's material does not make
    the scene textured). Same inputs on both sides."""
    je = _jax_engine("level")
    je.update()
    cfg = je.cfg
    assert cfg.has_forward and not cfg.any_textured
    outs, j_out = _frames(je, cfg)
    t_out = _hold(outs, j_out)
    assert t_out.tex_overflow.tolist() == np.asarray(j_out.tex_overflow).tolist()
    assert int(t_out.tex_overflow[1]) > 0             # the billboard's tiles
    assert int(t_out.bin_overflow) == int(j_out.bin_overflow)


def test_textured_engine_frame_matches_jax_engine():
    """The demo world with every second cube textured and its point light
    (billboard): the full table, the compacted material sample, K3's
    material plane and the overlay, port engine against JAX engine."""
    je = JEngine.from_world(
        jdemo.build_demo_world(n_cubes=9, textured_every=2),
        camera=jdemo.build_demo_camera(CFG.width, CFG.height), cfg=_jcfg(CFG))
    j_out = je.run_frame(0.0)
    te = TEngine.from_world(
        demo.build_demo_world(n_cubes=9, textured_every=2),
        camera=demo.build_demo_camera(CFG.width, CFG.height), cfg=CFG,
        device="cpu")
    outs = planes.three(lambda: planes.rerun(te))
    assert dataclasses.asdict(te.cfg) == dataclasses.asdict(je.cfg)
    assert te.cfg.any_textured and te.cfg.has_forward
    assert te.cfg.num_point_lights == 1
    t_out = _hold(outs, j_out)
    assert t_out.tex_overflow.tolist() == np.asarray(j_out.tex_overflow).tolist()
    assert int(t_out.tex_overflow[0]) > 0             # textured blocks


def test_forward_only_frame_matches_jax():
    """The forward-only frame (BASELINE config 1) of demo.lvl: one raster
    of the deferred triangles, sampled or flat albedo, N-dot-L."""
    je = _jax_engine("level")
    je.update()
    cfg = dataclasses.replace(je.cfg, forward_only=True)
    outs, j_out = _frames(je, cfg)
    t_out = _hold(outs, j_out)
    assert int(t_out.shadow_blocks) == 0


def test_engine_grows_texture_capacities():
    """The tex monitor (textured 8x128 blocks) and the fwdtex monitor
    (overlay tiles): one frame of the textured world at capacity 1 grows
    tex_block_capacity straight to the block count (dense sampling, the
    reference's rule at >= half the blocks); the rules at 1920x1080:
    12.5% headroom in 256-block steps, the jump to the block count, and
    the shrink after SHRINK_AFTER low frames."""
    te = TEngine.from_world(
        demo.build_demo_world(n_cubes=9, textured_every=2),
        camera=demo.build_demo_camera(CFG.width, CFG.height),
        cfg=dataclasses.replace(CFG, tex_block_capacity=1), device="cpu")
    for _ in range(3):          # an atlas-monitor growth ends a frame early
        out = te.run_frame(0.0)
        if te.cfg.tex_block_capacity > 1:
            break
    assert int(out.tex_overflow[0]) > 1
    assert te.cfg.tex_block_capacity == te._tex_block_count() == 32
    te.cfg = dataclasses.replace(te.cfg, width=1920, height=1080)
    nb = te._tex_block_count()
    assert nb == 136 * 15
    te._apply_monitor_values(("tex", "fwdtex"), [300, 20])
    assert (te.cfg.tex_block_capacity, te.cfg.fwd_tile_capacity) == (512, 256)
    te._apply_monitor_values(("tex", "fwdtex"), [1000, 3])
    assert te.cfg.tex_block_capacity == nb
    for _ in range(te.SHRINK_AFTER):
        te._apply_monitor_values(("tex", "fwdtex"), [10, 3])
    # fwdtex would shrink to 256 blocks, which is where it stands
    assert (te.cfg.tex_block_capacity, te.cfg.fwd_tile_capacity) == (512, 256)


def test_engine_grows_overflowed_capacities():
    """An overflowed capacity grows to the next power of two before the
    first frame is handed out: render() reads the monitors of an unsettled
    frame and renders again while a capacity grew. As in the reference
    engine, a growth from the atlas monitors drops the rest of that
    render's monitors; the next render reports them again."""
    cfg = dataclasses.replace(CFG, bin_capacity=4, shadow_bin_capacity=8)
    te = TEngine.from_world(
        demo.build_demo_world(n_cubes=9, with_point_light=False),
        camera=demo.build_demo_camera(CFG.width, CFG.height), cfg=cfg,
        device="cpu")
    out = te.run_frame(0.0)
    assert te._settled and te.frame_index == 3      # two growths, two renders
    assert te.cfg.shadow_bin_capacity > 8
    wanted = int(out.bin_overflow)
    assert wanted > 4
    assert te.cfg.bin_capacity == 1 << (wanted - 1).bit_length()
    cfg1 = te.cfg
    again = te.run_frame(0.0)
    assert te.cfg == cfg1
    assert torch.equal(out.pick_id, again.pick_id)
    assert torch.equal(out.sdr, again.sdr)
