"""Port parity for the unfused deferred chain as whole frames, on the CPU,
second half (tests/test_torch_unfused_frame.py holds the first): SSR,
the scaled frame, the strided material sample and fused shading off, port
engine against JAX engine, each side built from its own package."""

import dataclasses

import pytest

from test_torch_unfused_frame import CFG, assert_frames_equal, engines
from tinyrenderer_tpu_torch.render import frame as tframe
from tinyrenderer_tpu_torch.render.engine import Engine as TEngine
from tinyrenderer_tpu_torch.scene import demo

TEXTURED = dict(textured_every=2)


@pytest.mark.parametrize("case", ["ssr", "texture_scale_2",
                                  "fused_shading_off"])
def test_unfused_post_frame_matches_jax_engine(case):
    """SSR at strength 0.5 (the shipped 0 is a pass-through), the material
    sampled at every second pixel and upsampled, and the unfused chain
    chosen by the flag alone."""
    change = {"ssr": dict(enable_ssr=True),
              "texture_scale_2": dict(texture_scale=2),
              "fused_shading_off": dict(fused_shading=False)}[case]
    je, j_out, te, t_out = engines(change, TEXTURED,
                                   0.5 if case == "ssr" else None)
    assert_frames_equal(te, je, t_out, j_out)


def test_render_scale_frame_matches_jax_engine():
    """render_scale_pct 75: the fused frame at 192x96 (padded to 256x96, a
    height that is not a power of two), its HDR upsampled by 4/3
    (F.interpolate against jax.image.resize) and re-tone-mapped, pick ids
    and depth resized nearest."""
    je, j_out, te, t_out = engines(dict(render_scale_pct=75), TEXTURED)
    lo = tframe.scaled_config(te.cfg)
    assert (lo.width, lo.height, lo.padded_width, lo.padded_height) == \
        (192, 96, 256, 96)
    assert tframe.use_fused_shading(lo)
    assert_frames_equal(te, je, t_out, j_out, fused_shading=True)


def test_ssr_strength_changes_the_frame():
    """At strength 0.5 SSR reflects something in the demo world; at the
    shipped strength 0 the frame equals the unfused frame without SSR."""
    _, _, te, on = engines(dict(enable_ssr=True), TEXTURED, 0.5)
    te.set_param(tframe.PARAM_SSR_STRENGTH, 0.0)
    off = te.run_frame(0.0)
    base = TEngine.from_world(
        demo.build_demo_world(n_cubes=9, **TEXTURED),
        camera=demo.build_demo_camera(CFG.width, CFG.height),
        cfg=dataclasses.replace(CFG, fused_shading=False), device="cpu")
    base = base.run_frame(0.0)
    assert (on.hdr != off.hdr).any(dim=-1).float().mean() > 0.01
    assert (off.hdr == base.hdr).all()
