"""Port parity for the high-poly slice: frames whose triangle pool is above
4096 take the stream path (stream binning, K4, K5) on the main view and
scatter bins on the shadow view. The JAX engine renders one frame on the
CPU (Pallas kernels in interpret mode); the port renders the same packed
scene, lights, camera, params and environment under the JAX engine's
config. Also the engine's stream and big-triangle capacity monitors.
Each side builds its worlds and configurations from its own package."""

import dataclasses

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
from tinyrenderer_tpu_torch.ops import raster as traster
from tinyrenderer_tpu_torch.ops import sampling as tsampling
from tinyrenderer_tpu_torch.render import frame as tframe
from tinyrenderer_tpu_torch.render import scene_gpu as tscene
from tinyrenderer_tpu_torch.render.engine import Engine as TEngine
from tinyrenderer_tpu_torch.scene import demo

W, H = 256, 128
# 8x128 tiles as the high-poly bench config; capacities roomy enough that
# the JAX engine's first frame neither grows nor re-renders
CFG = RenderConfig(width=W, height=H, tile_h=8, tile_w=128, shadow_size=128,
                   shadow_tile=128, env_size=32)
SCENES = {
    # one 78x78 UV sphere, ~12k triangles, seen from close by
    "highpoly": (lambda d: d.build_highpoly_world(1), (-3.0, 2.5, 0.0),
                 dict(bin_capacity=1024, shadow_bin_capacity=8192)),
    # 401 cubes, 4812 triangles: the floor slab goes through the big list
    "cubes400": (lambda d: d.build_demo_world(n_cubes=400,
                                              with_point_light=False),
                 None, dict(bin_big_capacity=256, shadow_bin_capacity=4096)),
}


def _camera(eye, d=demo):
    """The demo viewpoint, or one at ``eye`` looking at the origin, from
    the demo module ``d`` of either package."""
    cam = d.build_demo_camera(W, H)
    if eye is not None:
        cam.position = np.asarray(eye, np.float32)
        cam.look_at(np.zeros(3, np.float32))
    return cam


def _host(nt) -> dict:
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_stream_frame_matches_jax_engine(scene):
    make_world, eye, caps = SCENES[scene]
    je = JEngine.from_world(
        make_world(jdemo), camera=_camera(eye, jdemo),
        cfg=JRenderConfig(**{**dataclasses.asdict(CFG), **caps}))
    j_out = je.run_frame(0.0)
    cfg = RenderConfig(**dataclasses.asdict(je.cfg))
    for k, v in caps.items():        # nothing grew: one frame, one compile
        assert getattr(cfg, k) == v, k
    assert jframe._use_fused_shading(cfg) and cfg.stream_raster
    assert traster.stream_pays_off(je._pack.scene.tri_vidx.shape[0])
    env = je._ensure_env()
    t_env = tframe.EnvGPU(**{k: torch.from_numpy(np.array(v))
                             for k, v in env._asdict().items()})
    t_out, port, f64 = planes.three(lambda: tframe.render_frame(
        tscene.scene_from_numpy(_host(je._pack.scene), "cpu"),
        tsampling.pool_from_numpy(vars(je._packer.pool_for(cfg)), "cpu"),
        tscene.lights_from_numpy(_host(je._pack.lights), "cpu"),
        torch.from_numpy(je.camera.to_raw()),
        torch.from_numpy(np.array(je.params)), t_env, cfg))
    # the parity decision (tests/planes.py): the port's own frame held to
    # the JAX frame by planes.hold_frame, its monitors too; below, the
    # port's frame under the JAX package's rounding of the planes against
    # the JAX frame as before
    planes.hold_frame(port, j_out, f64,
                      ("bin_overflow", "big_overflow", "stream_overflow"))
    for f in ("bin_overflow", "big_overflow", "stream_overflow"):
        assert int(getattr(t_out, f)) == int(getattr(j_out, f)), f
    assert 0 < int(t_out.stream_overflow) <= cfg.stream_capacity
    if scene == "cubes400":
        assert int(t_out.big_overflow) > 0
    jp, jd = np.asarray(j_out.pick_id), np.asarray(j_out.depth)
    assert (t_out.pick_id.numpy() != jp).mean() <= 1e-3
    assert (t_out.depth.numpy() != jd).mean() <= 1e-3
    res = verify.edge_aware_compare(t_out.sdr.numpy(), np.asarray(j_out.sdr),
                                    pick=jp)
    assert res["status"] == "pass", res
    assert (jp > 0).mean() > 0.1 and (jp == 0).any()   # geometry + sky


def test_stream_raster_off_takes_scatter_bins():
    """stream_raster=False with a pool above 4096: scatter bins, K1 and K2
    on the main view, as the reference; the frame equals the stream
    frame wherever no bin overflows."""
    make_world, eye, caps = SCENES["cubes400"]
    te = TEngine.from_world(make_world(demo), camera=_camera(eye),
                            cfg=dataclasses.replace(CFG, **caps), device="cpu")
    te.update()
    env = te._ensure_env()
    cam = torch.as_tensor(te.camera.to_raw())
    atlas, _, _ = tframe.render_shadow_atlas(te._pack.scene, te._pack.lights,
                                             te.cfg)
    pool = te._packer.pool_for(te.cfg, "cpu")
    outs = [tframe.render_frame(te._pack.scene, pool, te._pack.lights, cam,
                                te.params, env,
                                dataclasses.replace(te.cfg, stream_raster=s),
                                atlas)
            for s in (True, False)]
    assert int(outs[1].stream_overflow) == 0 < int(outs[0].stream_overflow)
    assert int(outs[1].bin_overflow) <= te.cfg.bin_capacity
    assert torch.equal(outs[0].pick_id, outs[1].pick_id)
    assert torch.equal(outs[0].depth, outs[1].depth)
    assert torch.equal(outs[0].sdr, outs[1].sdr)


def test_engine_grows_stream_and_big_capacities():
    """The two capacity monitors the port's engine was missing: the
    atlas's big-triangle count (8x8 shadow tiles make floor and cube faces
    big triangles there) grows bin_big_capacity and drops the atlas; the
    frame's stream_overflow grows stream_capacity to the next power of two
    (a multiple of the 2048-row block) and its big count bin_big_capacity
    again. All of it before the first frame is handed out: render() renders
    again while a capacity grew."""
    cfg = dataclasses.replace(CFG, shadow_tile=16, shadow_bin_capacity=4096,
                              bin_big_capacity=1, stream_capacity=2048)
    te = TEngine.from_world(
        demo.build_demo_world(n_cubes=400, with_point_light=False),
        camera=demo.build_demo_camera(W, H), cfg=cfg, device="cpu")
    out = te.run_frame(0.0)
    # the atlas growth ends the first render's reading; the second grows
    # the stream
    assert te._settled and te.frame_index >= 3
    atlas_big = te._shadow_big_need
    assert atlas_big > 1
    wanted = int(out.stream_overflow)
    assert wanted > 2048
    assert te.cfg.stream_capacity == 1 << (wanted - 1).bit_length()
    assert te.cfg.stream_capacity % traster.STREAM_BLOCK == 0
    pow2 = lambda v: 1 << (max(v, 1) - 1).bit_length()  # noqa: E731
    assert te.cfg.bin_big_capacity == max(pow2(atlas_big),
                                          pow2(int(out.big_overflow)))
    grown = te.cfg
    out = te.run_frame(0.0)          # settled: nothing overflows any more
    assert te.cfg == grown
    assert int(out.stream_overflow) <= grown.stream_capacity
    assert int(out.big_overflow) <= grown.bin_big_capacity


def test_engine_counts_the_stream_pairs_it_applies():
    """``Engine.stream_pairs`` sums the ``stream`` monitor's values as the
    engine applies them (the settle's reads and the queued ones) and
    ``Engine.stream_frames`` counts those frames, each engine its own; a
    fetch discarded unread counts nothing."""
    te = TEngine.from_world(demo.build_demo_world(n_cubes=2), cfg=CFG,
                            device="cpu")
    other = TEngine.from_world(demo.build_demo_world(n_cubes=2), cfg=CFG,
                               device="cpu")
    kinds = ("bins", "stream")
    te._apply_monitor_values(kinds, torch.tensor([1, 3000]), shrink=False)
    te._apply_monitor_values(kinds, torch.tensor([1, 5000]))
    assert (te.stream_pairs, te.stream_frames) == (8000, 2)
    te._overflow_inflight.append((kinds, None))
    assert te._apply_monitor_values(("bins",), torch.tensor([1 << 20]))
    assert not te._overflow_inflight and te.stream_frames == 2
    assert (other.stream_pairs, other.stream_frames) == (0, 0)
