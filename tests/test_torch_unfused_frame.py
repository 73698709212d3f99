"""Port parity for the unfused deferred chain as whole frames, on the CPU:
the port's engine against the JAX engine under each configuration that
leaves the fused frame (the fused raster + resolve kernel K6, SSR, render
scale, texture scale, fused shading off, shadows off, no lights, the
kernel-free branches of ``use_pallas=False``), and the repository's goldens
rendered by the port. Each side builds its world, camera and configuration
from its own package."""

import dataclasses
import os

import numpy as np
import planes
import pytest
from PIL import Image

from tinyrenderer_tpu.config import RenderConfig as JRenderConfig
from tinyrenderer_tpu.render import frame as jframe
from tinyrenderer_tpu.render.engine import Engine as JEngine
from tinyrenderer_tpu.scene import demo as jdemo
from tinyrenderer_tpu_torch.config import RenderConfig
from tinyrenderer_tpu_torch.render import frame as tframe
from tinyrenderer_tpu_torch.render.engine import Engine as TEngine
from tinyrenderer_tpu_torch.scene import demo
from tinyrenderer_tpu_torch.utils import verify

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
CFG = RenderConfig(width=256, height=128, tile_h=16, tile_w=128,
                   bin_capacity=128, shadow_size=128, shadow_tile=128,
                   shadow_bin_capacity=128, env_size=32)
# tests/test_golden.py's CFG: the kernel-free branches, pinned lookup rates
GOLDEN_CFG = RenderConfig(
    width=256, height=128, tile_h=16, tile_w=128, bin_capacity=160,
    shadow_size=128, shadow_tile=128, shadow_bin_capacity=128,
    env_size=32, irradiance_size=8, texture_size=64, mip_levels=4,
    max_vertices=8192, max_triangles=4096, max_instances=64,
    use_pallas=False, enable_ssr=False,
    shadow_lookup_scale=4, sky_scale=4, shadow_bf16=False)

# configuration change, world arguments (both packages' build_demo_world);
# tests/test_torch_unfused_post.py runs the SSR, scale and fused-shading-off
# cases, so that --dist loadfile spreads the JAX compiles
CASES = {
    "fused_resolve": (dict(fused_resolve=True), dict(textured_every=2)),
    "fused_resolve_forward_only": (dict(fused_resolve=True, forward_only=True),
                                   dict(textured_every=2)),
    "shadows_off": (dict(enable_shadows=False), dict(textured_every=2)),
    "no_lights": ({}, dict(with_point_light=False,
                           with_directional_light=False)),
    "use_pallas_off": (dict(use_pallas=False), dict(textured_every=2)),
}


def engines(change: dict, world_kw: dict, ssr_strength=None):
    """The JAX engine and the port's engine of the same 9-cube demo world
    under CFG + change, each built from its own package, one frame each."""
    cfg = dataclasses.replace(CFG, **change)
    je = JEngine.from_world(
        jdemo.build_demo_world(n_cubes=9, **world_kw),
        camera=jdemo.build_demo_camera(CFG.width, CFG.height),
        cfg=JRenderConfig(**dataclasses.asdict(cfg)))
    te = TEngine.from_world(
        demo.build_demo_world(n_cubes=9, **world_kw),
        camera=demo.build_demo_camera(CFG.width, CFG.height), cfg=cfg,
        device="cpu")
    if ssr_strength is not None:
        je.set_param(jframe.PARAM_SSR_STRENGTH, ssr_strength)
        te.set_param(tframe.PARAM_SSR_STRENGTH, ssr_strength)
    return je, je.run_frame(0.0), te, te.run_frame(0.0)


MONITORS = ("bin_overflow", "big_overflow", "tex_overflow", "shadow_blocks",
            "stream_overflow")


def assert_frames_equal(te, je, t_out, j_out, fused_shading=False):
    """Same derived configuration; under the JAX package's rounding of the
    raster planes (tests/planes.py), pick ids and depth equal on every
    pixel, the tone-mapped frames pass the repository's edge-aware
    comparator and the capacity monitors agree; the port's own frame
    ``t_out`` is held to the JAX frame by ``planes.hold_frame`` (no
    farther from the float64 planes' frame than the JAX frame, the
    edge-aware comparator, the capacity monitors)."""
    under_jax, f64 = planes.beside(lambda: planes.rerun(te))
    planes.hold_frame(t_out, j_out, f64, MONITORS)
    t_out = under_jax
    assert dataclasses.asdict(te.cfg) == dataclasses.asdict(je.cfg)
    assert tframe.use_fused_shading(te.cfg) == fused_shading
    assert jframe._use_fused_shading(je.cfg) == fused_shading
    jp, jd = np.asarray(j_out.pick_id), np.asarray(j_out.depth)
    assert t_out.pick_id.shape == jp.shape == (CFG.height, CFG.width)
    np.testing.assert_array_equal(t_out.pick_id.numpy(), jp)
    np.testing.assert_array_equal(t_out.depth.numpy(), jd)
    res = verify.edge_aware_compare(t_out.sdr.numpy(), np.asarray(j_out.sdr),
                                    pick=jp)
    assert res["status"] == "pass", res
    assert len(np.unique(jp)) > 2 and (jp == 0).any()      # geometry + sky
    for f in MONITORS:
        assert (np.asarray(getattr(t_out, f)).tolist()
                == np.asarray(getattr(j_out, f)).tolist()), f


@pytest.mark.parametrize("case", sorted(CASES))
def test_unfused_frame_matches_jax_engine(case):
    """The fused raster + resolve kernel's frame (deferred and forward-only),
    shadows off, a world without lights and the kernel-free branches,
    port engine against JAX engine."""
    je, j_out, te, t_out = engines(*CASES[case])
    assert_frames_equal(te, je, t_out, j_out)


@pytest.mark.parametrize("scene", ["demo", "demo_textured"])
def test_golden_through_the_port(scene):
    """tests/goldens/{demo,demo_textured}.png, rendered by the port's engine
    at tests/test_golden.py's configuration, meet that file's bar: at most
    2 LSB of difference on at least 99.5% of the pixels."""
    world = demo.build_demo_world(
        n_cubes=9, textured_every=2 if scene == "demo_textured" else 0)
    te = TEngine.from_world(world,
                            camera=demo.build_demo_camera(GOLDEN_CFG.width,
                                                          GOLDEN_CFG.height),
                            cfg=GOLDEN_CFG, device="cpu")
    img = te.run_frame(0.0).sdr.numpy().astype(np.int16)
    golden = np.asarray(Image.open(os.path.join(GOLDEN_DIR, f"{scene}.png")))
    d = np.abs(img - golden.astype(np.int16)).max(axis=-1)
    assert (d > 2).mean() < 0.005, (scene, (d > 2).mean(), d.max())
    assert te.cfg.any_textured == (scene == "demo_textured")
