"""Port parity for the whole slice: scene packing, the engine path and the
point + directional frame against the JAX package on the CPU (Pallas
kernels in interpret mode), plus the refusal of unported scenes."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyrenderer_tpu.config import RenderConfig
from tinyrenderer_tpu.render import frame as jframe
from tinyrenderer_tpu.render.engine import Engine as JEngine
from tinyrenderer_tpu.scene import demo
from tinyrenderer_tpu.utils import verify
from tinyrenderer_tpu_torch.render import frame as tframe
from tinyrenderer_tpu_torch.render import scene_gpu as tscene
from tinyrenderer_tpu_torch.render.engine import Engine as TEngine

LEVEL = os.path.join(os.path.dirname(os.path.dirname(__file__)), "levels",
                     "demo.lvl")
CFG = RenderConfig(width=256, height=128, tile_h=16, tile_w=128,
                   bin_capacity=128, shadow_size=128, shadow_tile=128,
                   shadow_bin_capacity=128, env_size=32)


def _jax_engine(scene: str) -> JEngine:
    if scene == "level":
        return JEngine(cfg=CFG, level_path=LEVEL)
    return JEngine.from_world(
        demo.build_demo_world(n_cubes=9, with_point_light=False),
        camera=demo.build_demo_camera(CFG.width, CFG.height), cfg=CFG)


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
    scene_from_numpy / lights_from_numpy, equal the port's own pack."""
    je = _jax_engine(scene)
    je.update()
    te = TEngine(cfg=je.cfg, device="cpu", level_path=None)
    te.world, te.camera = je.world, je.camera
    te.update()
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
    te = TEngine.from_world(
        demo.build_demo_world(n_cubes=9, with_point_light=False),
        camera=demo.build_demo_camera(CFG.width, CFG.height), cfg=CFG,
        device="cpu")
    t_out = te.run_frame(0.0)
    assert te.cfg == je.cfg     # same derived envelope (lights, forward, tex)
    assert jframe._use_fused_shading(je.cfg)
    _assert_frames_agree(t_out.pick_id.numpy(), t_out.depth.numpy(),
                         t_out.sdr.numpy(), j_out)


def test_point_and_directional_frame_matches_jax():
    """demo.lvl with the forward overlay switched off: P = 1, D = 1, seven
    shadow views, the atlas rendered inline; both frames get the same
    packed scene, lights, camera, params and environment."""
    je = _jax_engine("level")
    je.update()
    cfg = dataclasses.replace(je.cfg, has_forward=False)
    assert (cfg.num_point_lights, cfg.num_directional_lights) == (1, 1)
    assert not cfg.any_textured and jframe._use_fused_shading(cfg)
    env = je._ensure_env()
    cam = je.camera.to_raw()
    j_out = jframe.compiled_frame(cfg)(
        je._pack.scene, je._packer.pool_for(cfg), je._pack.lights,
        jnp.asarray(cam), je.params, env, None)
    t_env = tframe.EnvGPU(**{k: torch.from_numpy(np.array(v))
                             for k, v in env._asdict().items()})
    t_out = tframe.render_frame(
        tscene.scene_from_numpy(_host(je._pack.scene), "cpu"),
        tscene.lights_from_numpy(_host(je._pack.lights), "cpu"),
        torch.from_numpy(cam), torch.from_numpy(np.array(je.params)), t_env,
        cfg)
    _assert_frames_agree(t_out.pick_id.numpy(), t_out.depth.numpy(),
                         t_out.sdr.numpy(), j_out)


def test_engine_refuses_forward_triangles():
    """A point light brings a billboard, i.e. forward (overlay) triangles:
    not ported yet, so the frame raises instead of skipping the overlay."""
    te = TEngine.from_world(demo.build_demo_world(n_cubes=4),
                            camera=demo.build_demo_camera(CFG.width,
                                                          CFG.height),
                            cfg=CFG, device="cpu")
    with pytest.raises(NotImplementedError, match="item 10"):
        te.run_frame(0.0)
    assert te.cfg.has_forward


@pytest.mark.parametrize("change,item", [
    (dict(fused_shading=False), "item 12"),
    (dict(render_scale_pct=50), "item 12"),
    (dict(any_textured=True, has_forward=False), "item 11"),
    (dict(sky_block_capacity=256, has_forward=False, any_textured=False),
     "item 14"),
])
def test_render_frame_refuses_unported_branches(change, item):
    with pytest.raises(NotImplementedError, match=item):
        tframe.check_ported(dataclasses.replace(CFG, **change), 2048)


def test_engine_grows_overflowed_capacities():
    """The per-frame monitor readback grows an overflowed capacity to the
    next power of two for the next frame (no settle re-render). As in the
    reference engine, a growth from the atlas monitors drops the rest of
    that frame's monitors; the next frame reports them again."""
    cfg = dataclasses.replace(CFG, bin_capacity=4, shadow_bin_capacity=8)
    te = TEngine.from_world(
        demo.build_demo_world(n_cubes=9, with_point_light=False),
        camera=demo.build_demo_camera(CFG.width, CFG.height), cfg=cfg,
        device="cpu")
    te.run_frame(0.0)
    assert te.cfg.shadow_bin_capacity > 8 and te._atlas is None
    assert te.cfg.bin_capacity == 4
    out = te.run_frame(0.0)
    wanted = int(out.bin_overflow)
    assert wanted > 4
    assert te.cfg.bin_capacity == 1 << (wanted - 1).bit_length()
