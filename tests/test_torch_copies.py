"""The port keeps its own copies of the reference's JAX-free modules
(configuration, scene description, host asset loading, the image
comparator). They must agree with the reference: the same configuration
fields and defaults, the same packed arrays for the repository's worlds,
the same meshes and sky, and the same comparator verdicts."""

import dataclasses
import os

import numpy as np
import pytest

from tinyrenderer_tpu import config as jconfig
from tinyrenderer_tpu.assets import hdr as jhdr
from tinyrenderer_tpu.assets import mesh as jmesh
from tinyrenderer_tpu.render.engine import Engine as JEngine
from tinyrenderer_tpu.scene import demo as jdemo
from tinyrenderer_tpu.utils import verify as jverify
from tinyrenderer_tpu_torch import config as tconfig
from tinyrenderer_tpu_torch.assets import hdr as thdr
from tinyrenderer_tpu_torch.assets import mesh as tmesh
from tinyrenderer_tpu_torch.assets import native as tnative
from tinyrenderer_tpu_torch.render.engine import Engine as TEngine
from tinyrenderer_tpu_torch.scene import demo as tdemo
from tinyrenderer_tpu_torch.utils import verify as tverify

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEVEL = os.path.join(ROOT, "levels", "demo.lvl")


def test_render_config_has_the_same_fields_and_defaults():
    """Field names, order, types and defaults, the derived sizes and the
    presets of the two RenderConfig classes."""
    def spec(cls):
        return [(f.name, f.type, f.default) for f in dataclasses.fields(cls)]
    assert spec(tconfig.RenderConfig) == spec(jconfig.RenderConfig)
    for kw in ({}, dict(width=1000, height=700, tile_h=8),
               dict(num_point_lights=2, num_directional_lights=1)):
        j, t = jconfig.RenderConfig(**kw), tconfig.RenderConfig(**kw)
        for name in ("tiles_y", "tiles_x", "padded_height", "padded_width",
                     "num_shadow_views"):
            assert getattr(t, name) == getattr(j, name), name
        for preset in ("performance_preset", "fidelity_preset",
                       "reference_parity"):
            assert (dataclasses.asdict(getattr(t, preset)())
                    == dataclasses.asdict(getattr(j, preset)())), preset
        assert (dataclasses.asdict(t.grown_for(70, 9000, 5000, 40, 3, 2, 9, 6,
                                               4000))
                == dataclasses.asdict(j.grown_for(70, 9000, 5000, 40, 3, 2, 9,
                                                  6, 4000)))


def _engines(world: str):
    cfg = dict(width=256, height=128, tile_h=16)
    if world == "level":
        return (JEngine(cfg=jconfig.RenderConfig(**cfg), level_path=LEVEL),
                TEngine(cfg=tconfig.RenderConfig(**cfg), device="cpu",
                        level_path=LEVEL))
    make = {"demo": lambda d: d.build_demo_world(n_cubes=9),
            "textured": lambda d: d.build_demo_world(n_cubes=9,
                                                     textured_every=2),
            "highpoly": lambda d: d.build_highpoly_world(1)}[world]
    return (JEngine.from_world(make(jdemo),
                               camera=jdemo.build_demo_camera(256, 128),
                               cfg=jconfig.RenderConfig(**cfg)),
            TEngine.from_world(make(tdemo),
                               camera=tdemo.build_demo_camera(256, 128),
                               cfg=tconfig.RenderConfig(**cfg), device="cpu"))


@pytest.mark.parametrize("world", ["demo", "textured", "highpoly", "level"])
def test_worlds_pack_to_equal_arrays(world):
    """Each package builds the world from its own scene modules and packs it
    with its own packer: the same grown configuration and counts, every
    scene and light array equal, the same camera, and the same texture
    pool."""
    je, te = _engines(world)
    je.update()
    te.update()
    assert dataclasses.asdict(te.cfg) == dataclasses.asdict(je.cfg)
    assert te._pack.counts == je._pack.counts
    for mine, theirs in ((te._pack.scene, je._pack.scene),
                         (te._pack.lights, je._pack.lights)):
        for f in dataclasses.fields(mine):
            a, b = getattr(mine, f.name).numpy(), np.asarray(getattr(theirs, f.name))
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
    np.testing.assert_array_equal(te.camera.to_raw(), je.camera.to_raw())
    tp, jp = te._packer.pool.device_arrays(), je._packer.pool.device_arrays()
    assert len(tp) == len(jp)
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    if world == "textured":
        assert te._pack.counts["textured_materials"] > 0


@pytest.mark.parametrize("noise", [0, 2, 6, 40])
def test_edge_aware_compare_gives_the_same_verdicts(noise):
    """Random image pairs with noise from none to heavy, on a pick map of
    blocks: the two comparators return equal reports."""
    rng = np.random.default_rng(noise)
    golden = rng.integers(0, 256, (64, 96, 3)).astype(np.uint8)
    d = rng.integers(-noise, noise + 1, golden.shape)
    d[rng.uniform(size=golden.shape[:2]) < 0.98] = 0
    img = np.clip(golden.astype(np.int32) + d, 0, 255).astype(np.uint8)
    pick = np.repeat(np.repeat(rng.integers(0, 5, (8, 12)), 8, 0), 8, 1)
    for kw in ({}, dict(pick=pick), dict(pick=pick, lsb=1)):
        t = tverify.edge_aware_compare(img, golden, **kw)
        j = jverify.edge_aware_compare(img, golden, **kw)
        assert t == j, (kw, t, j)


def test_host_assets_agree():
    """Meshes (primitives and an OBJ through the native loader or its numpy
    fallback), the procedural sky and the RGBE codec; the port's native
    library is built from the repository's source into the git-ignored
    build/native/, not beside the reference's."""
    assert tnative._LIB == os.path.join(ROOT, "build", "native",
                                        "libtr_assets.so")
    assert tnative._SRC == os.path.join(ROOT, "native", "asset_loader.cpp")
    obj = ("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nvt 0 0\nvt 1 0\nvt 1 1\n"
           "vt 0 1\nvn 0 0 1\nf 1/1/1 2/2/1 3/3/1\nf 1/1/1 3/3/1 4/4/1\n")
    meshes = [(tmesh.parse_obj_text(obj), jmesh.parse_obj_text(obj))]
    meshes += [(tmesh.get_primitive(n), jmesh.get_primitive(n))
               for n in ("Cube", "Sphere", "Square", "Arrow")]
    meshes.append((tmesh.uv_sphere(78, 78), jmesh.uv_sphere(78, 78)))
    for t, j in meshes:
        for f in dataclasses.fields(t):
            np.testing.assert_array_equal(getattr(t, f.name),
                                          getattr(j, f.name), err_msg=f.name)
    sky = thdr.procedural_sky()
    np.testing.assert_array_equal(sky, jhdr.procedural_sky())
    np.testing.assert_array_equal(thdr.decode_hdr(thdr.encode_hdr(sky[:32])),
                                  jhdr.decode_hdr(jhdr.encode_hdr(sky[:32])))
