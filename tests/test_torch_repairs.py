"""Repairs of the port against the JAX package, each with the case that
showed the fault: the shadow gates at a frame size that
``shadow_lookup_scale`` does not divide (the reference's nearest resize),
and ``Engine._repack`` after a run-time change of the texture pool's
envelope and of the light count."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyrenderer_tpu.ops import shadows as jshadows
from tinyrenderer_tpu_torch.config import RenderConfig
from tinyrenderer_tpu_torch.ops import post as tpost
from tinyrenderer_tpu_torch.ops import shadows as tshadows
from tinyrenderer_tpu_torch.render.engine import Engine
from tinyrenderer_tpu_torch.scene import components as comp
from tinyrenderer_tpu_torch.scene import demo
from tinyrenderer_tpu_torch.scene.world import WorldObject


def _t(a):
    return torch.from_numpy(np.array(a))



@pytest.mark.parametrize("m,n", [(12, 90), (13, 100), (9, 72), (5, 33),
                                 (135, 1080), (17, 130)])
def test_resize_nearest_picks_the_reference_texel(m, n):
    """Half-pixel centres, floor, in float32: the source index of every
    output texel equals ``jax.image.resize(..., "nearest")``'s, at ratios
    that are no integers (a coarse grid of ceil(n / 8) cells up to n)."""
    src = np.arange(m * 3, dtype=np.float32).reshape(m, 3)
    want = np.asarray(jax.image.resize(jnp.asarray(src), (n, 3), "nearest"))
    np.testing.assert_array_equal(tpost.resize_nearest(_t(src), n, 3).numpy(),
                                  want)
    np.testing.assert_array_equal(
        tpost.resize_nearest(_t(src.T.copy()), 3, n).numpy(), want.T)


# Two lights whose visibility is a comparison of the position's own
# components, so both packages decide every pixel alike: what is compared
# is the gate logic alone (coarse grid, edges, resize, refinement).

def _jax_gates():
    def vis_all(p):
        return jnp.stack([p[..., 0] > 0.3, p[..., 2] > p[..., 1]],
                         -1).astype(jnp.float32)

    def vis_slot(pos_c, li_c):
        return jnp.where((li_c == 0)[:, None, None], pos_c[..., 0] > 0.3,
                         pos_c[..., 2] > pos_c[..., 1]).astype(jnp.float32)
    return vis_all, vis_slot


def _torch_gates():
    def vis_all(p):
        return torch.stack([p[..., 0] > 0.3, p[..., 2] > p[..., 1]],
                           -1).to(torch.float32)

    def vis_slot(pos_c, li_c):
        return torch.where((li_c == 0)[:, None, None], pos_c[..., 0] > 0.3,
                           pos_c[..., 2] > pos_c[..., 1]).to(torch.float32)
    return vis_all, vis_slot


def _positions(H, W):
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    return np.stack([xs / 8.0 - 6.0, np.sin(xs / 9.0) + np.cos(ys / 7.0) - 1.5,
                     ys / 8.0 - 4.0], -1).astype(np.float32)


@pytest.mark.parametrize("H,W,block_dims,capacity", [
    (72, 100, (8, 20), 0),      # W is no multiple of 8; blocks divide it
    (90, 100, (10, 20), 0),     # neither is; the edge grid is resized too
    (90, 100, (10, 20), 6),     # the same with an overflowing work list
    (72, 100, None, 0)])        # default blocks do not divide: full-rate gates
def test_gates_at_a_frame_the_scale_does_not_divide(H, W, block_dims,
                                                    capacity):
    """``gate_refined_visibility`` at scale 8 against the JAX function:
    gates and the work-item count equal."""
    pos = _positions(H, W)
    ja, js = _jax_gates()
    jg, jn = jshadows.gate_refined_visibility(
        ja, js, jnp.asarray(pos), 8, capacity, block_dims=block_dims,
        channel_first=True)
    ta, ts = _torch_gates()
    tg, tn = tshadows.gate_refined_visibility(ta, ts, _t(pos), 8, capacity,
                                              block_dims=block_dims)
    jg = np.asarray(jg)
    assert tg.shape == jg.shape == (2, H, W) and int(tn) == int(jn)
    assert 0.05 < jg.mean() < 0.95
    np.testing.assert_array_equal(tg.numpy(), jg)
    if block_dims is None:
        assert int(jn) == 0
    elif capacity == 0:
        assert int(jn) > 0
        full = np.moveaxis(np.asarray(ja(jnp.asarray(pos))), -1, 0)
        np.testing.assert_array_equal(jg, full)   # every edge block refined


CFG = RenderConfig(width=256, height=128, tile_h=16, tile_w=128,
                   bin_capacity=128, shadow_size=128, shadow_tile=128,
                   shadow_bin_capacity=128, env_size=32)


def _engine(cfg, **world):
    return Engine.from_world(
        demo.build_demo_world(n_cubes=9, **world),
        camera=demo.build_demo_camera(cfg.width, cfg.height), cfg=cfg,
        device="cpu")


def _settled(eng):
    """Frames until the capacities stop growing: the last one."""
    for _ in range(8):
        before, atlas_frame = eng.cfg, eng._atlas is None
        out = eng.run_frame(0.0)
        if eng.cfg == before and not atlas_frame:
            return out
    raise AssertionError(f"capacities did not settle: {eng.cfg}")


def _noise_textured_engine(cfg, png):
    """The textured demo world with a fine noise image as the albedo of its
    textured cubes, so that the pyramid's size shows in the pixels."""
    eng = _engine(cfg, textured_every=2)
    mat = comp.PbrMaterialDescriptor(textures=(
        comp.TextureSourceDescriptor(comp.TextureUsage.Albedo, png),))
    for _, obj in eng.world.world_objects():
        r = obj.get_renderable()
        if r is not None and not r.model_descriptor.material_descriptor.is_flat:
            r.model_descriptor = dataclasses.replace(
                r.model_descriptor, material_descriptor=mat)
    return eng


def test_repack_rebuilds_the_packer_for_a_new_pool_envelope(tmp_path):
    """A live engine on the textured demo world, then a smaller pyramid
    set on its config: the next frames equal a fresh engine's at that
    config (the old packer would go on sampling the 256-texel pool)."""
    from PIL import Image
    png = str(tmp_path / "noise.png")
    noise = np.random.default_rng(8).integers(0, 256, (64, 64, 4), np.uint8)
    noise[..., 3] = 255
    Image.fromarray(noise, "RGBA").save(png)
    eng = _noise_textured_engine(CFG, png)
    before = _settled(eng)
    assert eng.cfg.any_textured and eng._packer.pool.size == 256
    eng.cfg = dataclasses.replace(eng.cfg, texture_size=32, mip_levels=4)
    eng._needs_pack = True
    live = _settled(eng)
    pool = eng._packer.pool
    assert (pool.size, pool.levels) == (32, 4)
    assert eng._packer.pool_for(eng.cfg, "cpu").level_sizes == (32, 16, 8, 4)
    fresh = _settled(_noise_textured_engine(eng.cfg, png))
    assert torch.equal(live.pick_id, fresh.pick_id)
    assert torch.equal(live.hdr, fresh.hdr)
    assert torch.equal(live.pick_id, before.pick_id)
    assert (live.hdr != before.hdr).any(-1).float().mean() > 0.01


def _point_light() -> WorldObject:
    return WorldObject(
        components=[comp.LightObjectComponent(light=comp.PointLight(
            color=np.array([30.0, 28.0, 25.0], np.float32)))],
        transform=comp.TransformComponent(
            position=np.array([0.0, 5.0, 0.0], np.float32)))


def test_repack_after_a_light_was_added_equals_a_fresh_engine():
    """A point light added to a live engine changes num_point_lights and
    has_forward (its billboard); the pack made before the config followed
    the counts is the pack a fresh engine makes under the final config."""
    eng = _engine(CFG, with_point_light=False)
    before = _settled(eng)
    assert (eng.cfg.num_point_lights, eng.cfg.has_forward) == (0, False)
    eng.world.add_world_object(_point_light())
    live = _settled(eng)
    assert (eng.cfg.num_point_lights, eng.cfg.has_forward) == (1, True)
    fresh_eng = _engine(eng.cfg, with_point_light=False)
    fresh_eng.world.add_world_object(_point_light())   # the same object ids
    fresh = _settled(fresh_eng)
    assert fresh_eng.cfg == eng.cfg
    for f in dataclasses.fields(eng._pack.scene):
        assert torch.equal(getattr(eng._pack.scene, f.name),
                           getattr(fresh_eng._pack.scene, f.name)), f.name
    for f in dataclasses.fields(eng._pack.lights):
        assert torch.equal(getattr(eng._pack.lights, f.name),
                           getattr(fresh_eng._pack.lights, f.name)), f.name
    assert torch.equal(live.pick_id, fresh.pick_id)
    assert torch.equal(live.hdr, fresh.hdr)
    assert not torch.equal(live.hdr, before.hdr)    # the light is in the frame
