"""Scenes that draw OBJ meshes: the reference's reader against the port's
parsers, the manifest's scenes as they were before OBJ meshes, a tiny cell
of an OBJ sphere through the harness, and a mesh the engine cannot load
stopping the run in set-up."""

import hashlib
import json
import os

import numpy as np
import pytest

from benchmark import harness, scenes
from benchmark.reference import scene as refscene
from benchmark.tests import fixtures

# quads, a pentagon, negative indices, faces without vn (and without vt),
# repeated tokens, two objects and two groups
OBJ = """\
# a test mesh
o first
g a
v -1 -1 0
v 1 -1 0
v 1 1 0
v -1 1 0
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 0 1
vn 0 0 -1
f 1/1/1 2/2/1 3/3/1 4/4/1
f 1/1/2 4/4/2 3/3/2
f 2/2/1 3/3/1 1/1/1
o second
g b
v 0 0 1
v 1 0 1.5
v 0.5 0.8 2
v -0.5 0.8 2.5
v -1 0 2
vn 0.6 0 0.8
f -5/1/-1 -4/2/-1 -3/3/-1 -2/4/-1 -1/1/-1
f 5 6 7
f 5/1 7/3 8/4 9/2
f 6//3 7//3 8//3
f -4/2/-1 -3/3/-1 -2/4/-1
"""

# sha256 of ``describe``'s JSON (sorted keys) and of the reference's
# triangle pool, and the horizontal bound, as they read before scenes could
# hold OBJ meshes
SNAPSHOTS = {
    "deferred_1080p": (
        "83abee1d838a8e335d98bc603a64ef1211a3ce8f7d3a37561b41e007b5aaf9c2",
        "055e8eedf004614f54d807b33b07f93bf0411c7fe24b523ecc0ae14352f60856",
        20.0),
    "stress_1440p": (
        "7b6379ef2c4719d9bc67e98842690b71994ad01e9bb19be829245c9f08bea8b7",
        "be7f9fef28299e5253950cb0eadab8bf44588cfcbda9a8773021070538ba1cf6",
        25.270716905593872),
}


def _python(text):
    from tinyrenderer_tpu_torch.assets import mesh as meshlib
    m = meshlib.parse_obj_text(text)
    return m.positions, m.normals, m.indices


def _native(text):
    from tinyrenderer_tpu_torch.assets import native
    got = native.parse_obj_text(text)
    if got is None:
        pytest.skip("the port's native loader is not built here")
    return got[0], got[2], got[3]


@pytest.mark.parametrize("parse", [_python, _native], ids=["python", "native"])
def test_obj_reader_matches_the_ports_parsers(tmp_path, parse):
    path = tmp_path / "m.obj"
    path.write_text(OBJ)
    pos, nrm, tri = refscene.read_obj(str(path))
    p, n, idx = parse(OBJ)
    assert tri.shape == (12, 3)
    assert np.array_equal(pos, p) and pos.dtype == np.float32
    assert np.array_equal(nrm, n)
    assert np.array_equal(tri, np.asarray(idx).reshape(-1, 3))
    # the faces without vn made vertices 12-18
    assert not nrm[12:19].any()
    assert (np.linalg.norm(np.delete(nrm, range(12, 19), 0), axis=1) > 0).all()


@pytest.mark.parametrize("config", sorted(SNAPSHOTS))
def test_describe_matches_its_snapshot(config):
    c = harness._load_json(os.path.join(harness.BENCH_DIR, "configs",
                                        config + ".json"))
    desc = scenes.describe(c, harness.ROOT)
    t = refscene.triangles(desc)
    h = hashlib.sha256()
    for k in ("local_pos", "local_nrm", "tri", "oid", "mat", "forward",
              "shadow"):
        h.update(np.ascontiguousarray(t[k]).tobytes())
    for m, n in t["models"]:
        h.update(np.ascontiguousarray(m).tobytes())
        h.update(str(n).encode())
    digest = hashlib.sha256(json.dumps(desc, sort_keys=True).encode())
    assert (digest.hexdigest(), h.hexdigest(),
            refscene.horizontal_bound(desc)) == SNAPSHOTS[config]


@pytest.mark.parametrize("mesh", [
    {"PrimitiveInCode": "Arrow"}, {"FromFile": "models/a.gltf"},
    {"FromFile": "models/a.glb#part1"}])
def test_level_scene_refuses_what_it_cannot_draw(tmp_path, mesh):
    fixtures.write_obj_cell(str(tmp_path), "m.obj")
    level = json.loads((tmp_path / "obj.lvl").read_text())
    level["world_objects"][1]["components"][0]["Renderable"][
        "model_descriptor"]["mesh_descriptor"] = mesh
    (tmp_path / "obj.lvl").write_text(json.dumps(level))
    with pytest.raises(ValueError, match="object 2"):
        refscene.level_scene(str(tmp_path / "obj.lvl"))


def test_horizontal_bound_reads_the_mesh(tmp_path):
    (tmp_path / "s.obj").write_text(fixtures.sphere_obj(12, 12))
    fixtures.write_obj_cell(str(tmp_path), str(tmp_path / "s.obj"))
    desc = refscene.level_scene(str(tmp_path / "obj.lvl"))
    assert desc["objects"][1]["mesh"] == str(tmp_path / "s.obj")
    assert refscene.horizontal_bound(desc) == 4.0
    desc["objects"][1]["position"] = [4.5, 0.0, -0.25]
    assert refscene.horizontal_bound(desc) == pytest.approx(5.5)


@pytest.fixture
def obj_cell(tmp_path, monkeypatch):
    monkeypatch.setattr(harness, "QUIET_FRAMES", 1)

    def make(mesh_path):
        return fixtures.write_obj_cell(str(tmp_path), mesh_path), str(tmp_path)
    return make


@pytest.mark.parametrize("mix", ["orbit", "drag"])
def test_obj_cell_is_correct(obj_cell, tmp_path, mix):
    sphere = tmp_path / "sphere.obj"
    sphere.write_text(fixtures.sphere_obj(12, 12))
    man, root = obj_cell(str(sphere))
    r = harness.run(f"tiny_obj.tiny_{mix}", 2147483659, 0.3, False,
                    device="cpu", manifest=man, search=[root],
                    log=lambda *a: None)
    assert r["correct"], r["checks"]
    assert r["checks"]["pick_mismatch"]["value"] <= 1e-3


def _no_window(*a, **k):
    raise AssertionError("the engine ran a frame")


def test_a_missing_obj_stops_the_run_in_set_up(obj_cell, tmp_path,
                                               monkeypatch):
    man, root = obj_cell(str(tmp_path / "missing.obj"))
    monkeypatch.setattr(harness, "warm_up", _no_window)
    with pytest.raises(FileNotFoundError, match="missing.obj"):
        harness.run("tiny_obj.tiny_drag", 5, 0.3, False, device="cpu",
                    manifest=man, search=[root], log=lambda *a: None)


def test_a_mesh_the_engine_did_not_find_stops_the_run(obj_cell, tmp_path,
                                                      monkeypatch):
    """The reference reads the file while the engine's search misses it
    (and draws a cube)."""
    from tinyrenderer_tpu_torch.render import scene_gpu
    sphere = tmp_path / "sphere.obj"
    sphere.write_text(fixtures.sphere_obj(12, 12))
    man, root = obj_cell(str(sphere))
    monkeypatch.setattr(scene_gpu.ScenePacker, "resolve_path",
                        lambda self, path: None)
    monkeypatch.setattr(harness, "warm_up", _no_window)
    with pytest.raises(RuntimeError, match="object 2 .*: the engine loaded "
                       "12 triangles, the reference 264"):
        harness.run("tiny_obj.tiny_drag", 5, 0.3, False, device="cpu",
                    manifest=man, search=[root], log=lambda *a: None)
