"""The reference's off-path spec functions on the port, against the JAX
functions on the same inputs: ``resolve.interpolate``,
``resolve.resolve_gbuffer`` (also against the frame path's GBuffer from
``select_eval_ref``), ``resolve.select_rows_onehot`` (bit-equal, on the
random slivers of ``tests/test_raster.py``),
``sampling.sample_pool_bilinear_level`` on ``ScenePacker.scalar_pool_gpu``
pools, and that none of them is called from the port's frame code."""

import ast
import dataclasses
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyrenderer_tpu.assets import textures as jtextures
from tinyrenderer_tpu.config import RenderConfig as JRenderConfig
from tinyrenderer_tpu.ops import raster as jraster
from tinyrenderer_tpu.ops import resolve as jresolve
from tinyrenderer_tpu.ops import sampling as jsampling
from tinyrenderer_tpu.render.scene_gpu import ScenePacker as JScenePacker
from tinyrenderer_tpu.scene import demo as jdemo
from tinyrenderer_tpu_torch.config import RenderConfig
from tinyrenderer_tpu_torch.ops import raster, resolve, sampling
from tinyrenderer_tpu_torch.render import frame as framelib
from tinyrenderer_tpu_torch.render.engine import Engine
from tinyrenderer_tpu_torch.scene import demo

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = RenderConfig(width=160, height=96, tile_h=16, tile_w=128,
                   bin_capacity=128, shadow_size=128, shadow_tile=128,
                   shadow_bin_capacity=128, env_size=32, irradiance_size=8,
                   texture_size=64, mip_levels=4)
WORLD = dict(n_cubes=9, textured_every=2)
GB_FIELDS = ("position", "normal", "albedo", "rough_metal_ao", "depth",
             "object_id", "mask")


def _j(t: torch.Tensor):
    return jnp.asarray(t.numpy())


@pytest.fixture(scope="module")
def frame_inputs():
    """The textured demo world's main view at 160x96 through the port's
    geometry, setup, dense bins and plain K1, with its settled config."""
    eng = Engine.from_world(demo.build_demo_world(**WORLD),
                            camera=demo.build_demo_camera(160, 96), cfg=CFG,
                            device="cpu")
    eng.run_frame(0.0)
    cfg, scene = eng.cfg, eng._pack.scene
    cam = framelib._unpack_camera(torch.from_numpy(eng.camera.to_raw()))
    _, clip, attrs = framelib.geometry_stage(scene, cam["view_proj"])
    PW, PH = cfg.padded_width, cfg.padded_height
    setup = raster.triangle_setup(clip, scene.tri_vidx, scene.tri_deferred,
                                  PW, PH, "back")
    bins = raster.bin_triangles(setup, PW, PH, cfg.tile_h, cfg.tile_w,
                                cfg.bin_capacity, cfg.bin_big_capacity)
    tri_id, depth = raster.rasterize_binned(bins, cfg.tile_h, cfg.tile_w)
    mat = scene.inst_material.long()[
        scene.tri_instance.long()[tri_id.clamp(min=0).long()]]
    textured = (scene.mat_flat[mat][..., 5] > 0.5) & (tri_id >= 0)
    assert int(textured.sum()) > 100 and len(torch.unique(tri_id)) > 20
    return SimpleNamespace(eng=eng, cfg=cfg, scene=scene, attrs=attrs,
                           setup=setup, tri_id=tri_id, depth=depth)


def _jattrs(attrs):
    return jresolve.VertexAttrs(*(_j(getattr(attrs, f)) for f in (
        "world", "uv", "normal", "tangent", "bitangent")))


def _spec_gbuffer(f):
    s = f.scene
    return resolve.resolve_gbuffer(
        f.tri_id, f.depth, f.setup.rows, s.tri_vidx, s.tri_instance, f.attrs,
        s.inst_object_id, s.inst_material, s.mat_tex_slots, s.mat_flat,
        f.eng._packer.scalar_pool_gpu("cpu"))


def test_interpolate_matches_jax(frame_inputs):
    """Within 1e-4 (world positions up to ~20 units: a few float32 ulp;
    XLA fuses the plane multiply-adds); the valid mask equal."""
    f = frame_inputs
    a, va = resolve.interpolate(f.tri_id, f.setup.rows, f.scene.tri_vidx,
                                f.attrs.rows())
    b, vb = jax.jit(jresolve.interpolate)(
        _j(f.tri_id), _j(f.setup.rows), _j(f.scene.tri_vidx),
        _jattrs(f.attrs).rows())
    assert np.array_equal(va.numpy(), np.asarray(vb))
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-4)


def test_resolve_gbuffer_matches_jax(frame_inputs):
    """The same inputs and the JAX pack of the same host texture arrays:
    positions within 1e-4, every other field within 1e-6 (ids and the mask
    equal); the scalar pools are equal."""
    f = frame_inputs
    s = f.scene
    pool = f.eng._packer.scalar_pool_gpu("cpu")
    jpool = jsampling.pack_texture_pool(f.eng._packer.pool.device_arrays())
    assert np.array_equal(pool.texels.numpy(), np.asarray(jpool.texels))
    assert (pool.level_sizes, pool.level_offsets) == (
        tuple(jpool.level_sizes), tuple(jpool.level_offsets))
    g = _spec_gbuffer(f)
    jg = jax.jit(lambda *a: jresolve.resolve_gbuffer(*a, jpool))(
        _j(f.tri_id), _j(f.depth), _j(f.setup.rows), _j(s.tri_vidx),
        _j(s.tri_instance), _jattrs(f.attrs), _j(s.inst_object_id),
        _j(s.inst_material), _j(s.mat_tex_slots), _j(s.mat_flat))
    for name in GB_FIELDS:
        a, b = getattr(g, name).numpy(), np.asarray(getattr(jg, name))
        if a.dtype.kind in "biu":
            assert np.array_equal(a, b), name
        else:
            np.testing.assert_allclose(
                a, b, rtol=0, atol=1e-4 if name == "position" else 1e-6,
                err_msg=name)


def test_resolve_gbuffer_matches_the_frame_path(frame_inputs):
    """The spec against the frame's resolve of the same pixels: the table,
    ``select_eval_ref`` (float32) and ``resolve_gbuffer_from_attrs`` on the
    u8 record pool. Positions within 2e-4 (plane evaluation against
    barycentric gathers), normals and materials within 1e-5, ids, depth
    and the mask equal."""
    f = frame_inputs
    s, cfg = f.scene, f.cfg
    table = resolve.build_gbuffer_table(
        f.setup, s.tri_vidx, f.attrs, s.tri_instance, s.inst_object_id,
        s.inst_material, s.mat_record, s.mat_flat)
    r = resolve._attrs_from_split(
        f.tri_id, *resolve.select_eval_ref(f.tri_id, table, bf16=False))
    frame_gb, _ = resolve.resolve_gbuffer_from_attrs(
        r, f.tri_id, f.depth, f.eng._packer.pool_for(cfg, "cpu"),
        texture_filter=cfg.texture_filter,
        tex_block_capacity=cfg.tex_block_capacity)
    g = _spec_gbuffer(f)
    for name in GB_FIELDS:
        a, b = getattr(g, name).numpy(), getattr(frame_gb, name).numpy()
        if a.dtype.kind in "biu":
            assert np.array_equal(a, b), name
        else:
            np.testing.assert_allclose(
                a, b, rtol=0, atol=2e-4 if name == "position" else 1e-5,
                err_msg=name)


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_select_rows_onehot_bit_equal(seed):
    """The random slivers of tests/test_raster.py (seed 11 and two more):
    the port's gather selects exactly the rows of the reference's one-hot
    product, on the reference's own bins and winners."""
    rng = np.random.default_rng(seed)
    V, T = 48, 24
    clip = jnp.asarray(np.concatenate(
        [rng.uniform(-1, 1, (V, 2)), rng.uniform(0.2, 0.9, (V, 1)),
         np.ones((V, 1))], axis=1).astype(np.float32))
    tri = jnp.asarray(rng.integers(0, V, (T, 3)).astype(np.int32))
    setup = jraster.triangle_setup(clip, tri, jnp.ones((T,), bool), 256, 64,
                                   "none")
    bins = jraster.bin_triangles(setup, 256, 64, 8, 128, 16)
    table = jnp.asarray(rng.random((T, 64)).astype(np.float32))
    table = jnp.where(setup.valid[:, None], table, 0.0)
    tid, _ = jraster.rasterize_binned(bins, 8, 128, use_pallas=False)
    want = np.asarray(jax.jit(jresolve.select_rows_onehot,
                              static_argnums=(3, 4))(tid, bins.ids, table,
                                                     8, 128))
    got = resolve.select_rows_onehot(
        torch.from_numpy(np.array(tid)), torch.from_numpy(np.array(bins.ids)),
        torch.from_numpy(np.array(table)), 8, 128)
    assert (np.asarray(tid) >= 0).sum() > 1000
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


def _scalar_pools():
    """The demo world's per-texture pool from each package's packer."""
    tpk = Engine.from_world(demo.build_demo_world(**WORLD), cfg=CFG,
                            device="cpu")
    tpk.update()
    jpk = JScenePacker(JRenderConfig(**dataclasses.asdict(tpk.cfg)))
    jpk.pack(jdemo.build_demo_world(**WORLD))
    return tpk._packer.scalar_pool_gpu("cpu"), jpk.scalar_pool_gpu()


@pytest.mark.parametrize("wrap", [True, False])
def test_sample_pool_bilinear_level_matches_jax(wrap):
    """Every level of the demo world's scalar pool and of a pool of random
    mips, at random texture ids and uv in [-1.5, 2.5): within 1e-6 (values
    in [0, 1]; XLA fuses the blend's multiply-adds)."""
    pool, jpool = _scalar_pools()
    assert np.array_equal(pool.texels.numpy(), np.asarray(jpool.texels))
    rng = np.random.default_rng(3)
    mips = [rng.uniform(0, 1, (3, s, s, 4)).astype(np.float32)
            for s in (16, 8, 4)]
    pools = [(pool, jpool), (sampling.pack_texture_pool(mips),
                             jsampling.pack_texture_pool(mips))]
    uv = rng.uniform(-1.5, 2.5, (24, 40, 2)).astype(np.float32)
    for tp, jp in pools:
        n = tp.texels.shape[0] // tp.texels_per_tex
        tex = rng.integers(0, n, (24, 40)).astype(np.int32)
        for level in range(len(tp.level_sizes)):
            a = sampling.sample_pool_bilinear_level(
                tp, torch.from_numpy(tex), torch.from_numpy(uv), level, wrap)
            b = jax.jit(jsampling.sample_pool_bilinear_level,
                        static_argnums=(0, 3, 4))(jp, jnp.asarray(tex),
                                                  jnp.asarray(uv), level, wrap)
            assert a.shape == (24, 40, 4)
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-6, err_msg=str(level))


def test_texture_pool_mip_levels():
    """tests/test_ops.py's mip case on the port: a 64-texel texture, white
    above, black below; the level sizes halve and the fine level's centre
    sample lies between; equal to the JAX sample."""
    base = np.zeros((64, 64, 4), np.float32)
    base[:32] = 1.0
    chain = jtextures.build_mip_chain(base, 4)
    pool = sampling.pack_texture_pool([m[None] for m in chain])
    assert pool.level_sizes[:2] == (64, 32)
    uv = torch.tensor([[[0.5, 0.5]]])
    fine = sampling.sample_pool_bilinear_level(
        pool, torch.zeros((1, 1), dtype=torch.int32), uv, 0)
    np.testing.assert_allclose(fine.numpy()[0, 0, :3], 0.5, atol=0.5)
    want = jsampling.sample_pool_bilinear_level(
        jsampling.pack_texture_pool([m[None] for m in chain]),
        jnp.array([[0]]), jnp.asarray(uv.numpy()), 0)
    np.testing.assert_allclose(fine.numpy(), np.asarray(want), atol=1e-6)


SPEC = {"interpolate", "resolve_gbuffer", "select_rows_onehot",
        "_gather_texel", "sample_pool_bilinear_level", "scalar_pool_gpu"}


def test_spec_functions_join_no_frame_path():
    """No module of the port calls the spec functions, except the spec
    functions themselves (``resolve_gbuffer`` interpolates,
    ``sample_pool_bilinear_level`` gathers texels); ``F.interpolate``, the
    resize, is another function."""
    pkg = os.path.join(ROOT, "tinyrenderer_tpu_torch")
    calls = []

    def called(fnode) -> str:
        if isinstance(fnode, ast.Attribute):
            if (fnode.attr == "interpolate" and isinstance(fnode.value, ast.Name)
                    and fnode.value.id == "F"):
                return ""
            return fnode.attr
        return getattr(fnode, "id", "")

    def visit(node, path, where):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if node.name in SPEC:
                return          # a spec function may call the others
            where = node.name
        if isinstance(node, ast.Call) and called(node.func) in SPEC:
            calls.append((os.path.relpath(path, ROOT), where,
                          called(node.func)))
        for child in ast.iter_child_nodes(node):
            visit(child, path, where)

    for dirpath, _, files in os.walk(pkg):
        for fn in files:
            if fn.endswith(".py"):
                path = os.path.join(dirpath, fn)
                with open(path) as fh:
                    visit(ast.parse(fh.read()), path, "<module>")
    assert calls == [], calls
