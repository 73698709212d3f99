"""The plain reference against the port on the CPU: a small frame of each
cell (its configuration at 192x112 with a 128-texel atlas, a few frames of
its traffic) through the harness, held to the cell's limits; and the
benchmark's scenes against the port's own."""

import numpy as np
import pytest

from benchmark import harness
from benchmark.reference import scene as refscene
from benchmark.tests import fixtures

CELLS = ["deferred_1080p.orbit", "stress_1440p.drag", "stress_1440p.orbit",
         "deferred_1080p.drag"]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiny")
    return fixtures.write_tiny(str(root), cubes=12), str(root)


@pytest.mark.parametrize("cell", CELLS)
def test_port_matches_the_reference(tiny, cell, monkeypatch):
    man, root = tiny
    monkeypatch.setattr(harness, "QUIET_FRAMES", 1)
    r = harness.run("tiny_" + cell, 1234567891, 0.3, False, device="cpu",
                    manifest=man, search=[root], log=lambda *a: None)
    assert r["correct"], r["checks"]
    assert r["checks"]["pick_mismatch"]["value"] <= 1e-3


def test_grid_scene_is_the_ports_stress_world():
    from tinyrenderer_tpu_torch.scene import components as comp
    from tinyrenderer_tpu_torch.scene import demo
    world = demo.build_stress_world(500, seed=11)
    desc = refscene.grid_scene(500, 11)
    objs = list(world.world_objects())
    assert [oid for oid, _ in objs] == [o["oid"] for o in desc["objects"]]
    for (oid, w), o in zip(objs, desc["objects"]):
        assert np.array_equal(w.transform.position,
                              np.asarray(o["position"], np.float32))
        assert np.array_equal(w.transform.scale, np.asarray(o["scale"], np.float32))
        r = w.get_renderable()
        if o["material"] is None:
            assert w.get_light() is not None
            continue
        flat = r.model_descriptor.material_descriptor.flat
        assert np.array_equal(flat.albedo, np.asarray(o["material"]["albedo"],
                                                      np.float32))
        assert flat.roughness == o["material"]["roughness"]
        assert flat.metalness == o["material"]["metalness"]
        assert r.rendering_options.pass_ == comp.RenderingPass.DeferredMain
    (_, d), = world.omnipresent_objects()
    dl = d.get_directional_light()
    assert np.allclose(dl.direction, desc["directional_lights"][0]["direction"])


def test_level_scene_is_what_the_engine_loads():
    from tinyrenderer_tpu_torch.scene import level_io
    path = f"{harness.ROOT}/benchmark/levels/demo.lvl"
    level = level_io.load_level(path)
    desc = refscene.level_scene(path)
    drawn = [(oid, w) for oid, w in level.world.world_objects()
             if w.get_renderable() is not None]
    assert [oid for oid, _ in drawn] == [o["oid"] for o in desc["objects"]]
    for (_, w), o in zip(drawn, desc["objects"]):
        assert np.allclose(w.transform.position, o["position"])
        assert np.allclose(w.transform.scale, o["scale"])
    fwd = np.asarray(level.camera.get_forward(), np.float64)
    assert np.allclose(fwd, desc["camera"]["forward"], atol=1e-6)
    assert len(desc["point_lights"]) == 1 and len(desc["directional_lights"]) == 1
