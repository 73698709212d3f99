"""The high-poly configuration (``highpoly_1080p``): its files against the
port's own high-poly scene, and a small frame of small triangles through
the port's plain path held against the plain reference.

The committed OBJ and level are written by this module from the port's
``uv_sphere(78, 78)`` and ``build_highpoly_world(9)``:

    python3 -m benchmark.tests.test_benchmark_highpoly --write
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import pytest

from benchmark import harness, scenes
from benchmark.reference import scene as refscene
from benchmark.tests import fixtures

OBJ = "benchmark/assets/sphere_78x78.obj"
LEVEL = "benchmark/levels/highpoly.lvl"


def sphere_obj_text(stacks: int = 78, slices: int = 78) -> str:
    """The OBJ text of the port's ``uv_sphere(stacks, slices)``: the
    vertices its triangles use, in order, each its own ``v``, ``vt`` and
    ``vn`` (float32 values to 9 digits, which read back exactly), and a
    face a triangle."""
    from tinyrenderer_tpu_torch.assets import mesh as meshlib
    m = meshlib.uv_sphere(stacks, slices)
    tri = np.asarray(m.indices).reshape(-1, 3)
    used = np.unique(tri)
    new = np.full(len(m.positions), -1, np.int64)
    new[used] = np.arange(1, len(used) + 1)
    lines = [f"# uv_sphere({stacks}, {slices}): {len(used)} vertices, "
             f"{len(tri)} triangles"]
    for k in used:
        lines.append("v %.9g %.9g %.9g" % tuple(float(x) for x in m.positions[k]))
        lines.append("vt %.9g %.9g" % tuple(float(x) for x in m.tex_coords[k]))
        lines.append("vn %.9g %.9g %.9g" % tuple(float(x) for x in m.normals[k]))
    lines += ["f " + " ".join(f"{k}/{k}/{k}" for k in new[t]) for t in tri]
    return "\n".join(lines) + "\n"


def highpoly_level(mesh_path: str = OBJ, n_spheres: int = 9) -> dict:
    """The level of ``build_highpoly_world(n_spheres)`` (its transforms,
    flat materials and directional light) with each sphere drawn from
    ``mesh_path``, under the demo camera at 1920x1080."""
    from tinyrenderer_tpu_torch.scene import components as comp
    from tinyrenderer_tpu_torch.scene import demo, level_io
    world = demo.build_highpoly_world(n_spheres)
    for _, obj in world.world_objects():
        md = obj.get_renderable().model_descriptor
        md.mesh_descriptor = comp.MeshDescriptor.from_file(mesh_path)
    return level_io.level_to_json(world, demo.build_demo_camera(1920, 1080))


def write(root: str = harness.ROOT) -> None:
    with open(os.path.join(root, OBJ), "w") as f:
        f.write(sphere_obj_text())
    with open(os.path.join(root, LEVEL), "w") as f:
        json.dump(highpoly_level(), f, indent=2)
        f.write("\n")


def test_committed_files_are_the_ports_scene():
    with open(os.path.join(harness.ROOT, OBJ)) as f:
        assert f.read() == sphere_obj_text()
    with open(os.path.join(harness.ROOT, LEVEL)) as f:
        assert json.load(f) == json.loads(json.dumps(highpoly_level()))


def test_scene_is_the_ports_highpoly_world():
    """The configuration's scene, as the reference reads it, is the port's
    high-poly world: nine spheres of 12,012 triangles (108,108), their
    transforms and materials, no ground; the OBJ holds the sphere's
    corners exactly."""
    from tinyrenderer_tpu_torch.assets import mesh as meshlib
    from tinyrenderer_tpu_torch.scene import demo
    c = harness._load_json(os.path.join(harness.BENCH_DIR, "configs",
                                        "highpoly_1080p.json"))
    desc = scenes.describe(c, harness.ROOT)
    t = refscene.triangles(desc)
    assert t["tri"].shape[0] == 9 * 12012
    world = demo.build_highpoly_world(9)
    objs = [o for _, o in world.world_objects()]
    assert len(desc["objects"]) == len(objs) == 9
    for o, w in zip(desc["objects"], objs):
        np.testing.assert_array_equal(np.asarray(o["position"], np.float32),
                                      w.transform.position)
        np.testing.assert_array_equal(np.asarray(o["scale"], np.float32),
                                      w.transform.scale)
        flat = w.get_renderable().model_descriptor.material_descriptor.flat
        np.testing.assert_array_equal(
            np.asarray(o["material"]["albedo"], np.float32), flat.albedo)
    pos, _, tri = refscene.mesh(desc["objects"][0]["mesh"])
    m = meshlib.uv_sphere(78, 78)
    np.testing.assert_array_equal(
        pos[tri], np.asarray(m.positions)[np.asarray(m.indices).reshape(-1, 3)])
    assert len(desc["directional_lights"]) == 1 and not desc["point_lights"]
    assert refscene.horizontal_bound(desc) == pytest.approx(4.2)


def _small_highpoly_cell(root: str) -> dict:
    """A 192x112 cell of two ``uv_sphere(24, 24)`` OBJs toward the far
    (bottom-right) corner of the frame, under ``deferred_1080p.drag``'s
    limits, its render block otherwise (shadows, IBL), a fixed camera."""
    man = fixtures.write_tiny(root, cubes=4)
    mesh = os.path.join(root, "sphere24.obj")
    with open(mesh, "w") as f:
        f.write(sphere_obj_text(24, 24))
    level = highpoly_level(mesh, n_spheres=4)
    # a camera looking past the spheres, so that they cover ~880 pixels
    # of the frame's bottom-right quarter (x 142-186, y 64-95; x 190-250 of
    # the 256-pixel padded frame the setup works in), 10-13 units away
    level["world_objects"] = level["world_objects"][:2]
    level["world_objects"][0]["transform"]["position"] = [-3.0, -1.0, 0.3]
    level["world_objects"][1]["transform"]["position"] = [0.5, -1.6, -0.3]
    level["camera"]["position"] = [-12.0, 5.0, -3.0]
    level["camera"]["orientation"] = [0.0, 0.0, -0.32]
    with open(os.path.join(root, "hp.lvl"), "w") as f:
        json.dump(level, f)
    c = harness._load_json(os.path.join(harness.BENCH_DIR, "configs",
                                        "highpoly_1080p.json"))
    c.update(name="tiny_hp", scene={"level": os.path.join(root, "hp.lvl")})
    c["render"].update(fixtures.TINY_RENDER)
    for k in ("max_triangles", "max_vertices", "stream_capacity"):
        c["render"].pop(k, None)
    with open(os.path.join(root, "configs", "tiny_hp.json"), "w") as f:
        json.dump(c, f)
    man["configs"].append(dict(man["configs"][0], name="tiny_hp",
                               file="none/tiny_hp.json"))
    with open(os.path.join(root, "traffic", "tiny_still.json"), "w") as f:
        json.dump({"camera": {"mode": "fixed"}, "warmup_frames": 2}, f)
    man["workloads"].append({"name": "tiny_hp.still", "config": "tiny_hp",
                             "traffic": "tiny_still", "chips": 1,
                             "why": "a test"})
    with open(os.path.join(harness.BENCH_DIR, "limits",
                           "deferred_1080p.drag.json")) as f, open(
            os.path.join(root, "limits", "tiny_hp.still.json"), "w") as g:
        g.write(f.read())
    return man


def test_small_triangles_far_from_the_origin_are_correct(tmp_path,
                                                         monkeypatch):
    """Small triangles toward the far corner of the frame, through the
    port's plain path, against the reference under the limits that the
    high-poly scene failed before its planes were anchored at a vertex.
    Before, the port read ``depth_rel`` 3.3e-4 here (limit 6.7e-5; now
    2.0e-6): the edge and depth constants came from absolute-coordinate
    cross products, which cancel for such triangles."""
    man = _small_highpoly_cell(str(tmp_path))
    monkeypatch.setattr(harness, "QUIET_FRAMES", 1)
    r = harness.run("tiny_hp.still", 3141592653, 0.3, False, device="cpu",
                    manifest=man, search=[str(tmp_path)], log=lambda *a: None)
    assert r["correct"], r["checks"]


def _window(k4_us: list, marks: list = (), frames: int = 4):
    """A traced stretch from 0 to 1000 us: K4's launches of ``k4_us``, a
    kernel beside them, and ``engine.stream_pairs`` marks at the given
    (time, pairs), on the 1080p grid of 8x128 tiles."""
    from benchmark import trace
    dev = [("void raster_stream_kernel<1>(int const*)", 10.0 * i, d)
           for i, d in enumerate(k4_us)]
    dev.append(("void stream_parts_kernel(int const*)", 99.0, 5.0))
    events = [{"ph": "X", "cat": "user_annotation", "ts": ts, "dur": 0.0,
               "name": f"engine.stream_pairs:{n}:135:15:8:128"}
              for ts, n in marks]
    events.append({"ph": "X", "cat": "user_annotation", "ts": 5.0,
                   "dur": 1.0, "name": "engine.frame"})
    return trace.Window(frames=frames, start=0.0, end=1e3, device=dev,
                        busy_us=sum(k4_us), events=events)


def test_stream_readers():
    """``stream_pairs_k`` reads the mean pairs of the program's
    ``engine.stream_pairs`` marks inside the traced stretch, in thousands
    (marks outside it are set-up's or later frames'); ``k4_roofline`` K4's
    least time at that mean over ``raster_stream_kernel``'s device time a
    launch; both read nothing where the trace holds no mark (a parent
    without them), only marks of no pairs, or no trace."""
    from benchmark import stream_work
    from benchmark.roofline import bound
    k4 = harness.load_reader(os.path.join(harness.BENCH_DIR, "metrics",
                                          "k4_roofline.py"))
    pairs = harness.load_reader(os.path.join(harness.BENCH_DIR, "metrics",
                                             "stream_pairs_k.py"))
    marks = [(-50.0, 900_000), (100.0, 90_000), (400.0, 100_000),
             (900.0, 110_000), (1200.0, 1)]
    data = harness.TraceData(window=_window([40.0, 42.0], marks))
    assert stream_work.stream_pairs(data.window) == (100_000.0,
                                                     (135, 15, 8, 128))
    assert pairs(data) == pytest.approx(100.0)
    least = bound(stream_work.k4_bytes(100_000, 135, 15, 8, 128), 0)[0]
    assert k4(data) == pytest.approx(100.0 * least / 0.041)
    for empty in (harness.TraceData(),
                  harness.TraceData(window=_window([40.0])),
                  harness.TraceData(window=_window([40.0], [(10.0, 0)]))):
        assert pairs(empty) is None and k4(empty) is None
    assert k4(harness.TraceData(window=_window([], marks))) is None


def test_engine_marks_the_stream_pairs_in_a_trace(tmp_path):
    """Under the profiler the engine marks each ``stream`` monitor value it
    applies (``engine.stream_pairs`` with the frame's tile grid), and the
    marks of a stretch sum to the growth of ``Engine.stream_pairs`` over
    it; with no profiler it makes none."""
    import torch

    from benchmark import stream_work, trace
    from tinyrenderer_tpu_torch.render.engine import Engine
    from tinyrenderer_tpu_torch.scene import demo
    from tinyrenderer_tpu_torch.utils import spans
    eng = Engine.from_world(demo.build_demo_world(n_cubes=2), device="cpu")
    kinds = ("bins", "stream")
    eng._apply_monitor_values(kinds, torch.tensor([1, 7]), shrink=False)
    assert not spans.recording()
    before = eng.stream_pairs
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(trace.FRAME_ANNOTATION):
            for v in (3000, 5000):
                eng._apply_monitor_values(kinds, torch.tensor([1, v]))
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    w = trace.window(trace.load(path))
    c = eng.cfg
    got = stream_work.stream_pairs(w)
    assert got == (4000.0, (c.tiles_y, c.tiles_x, c.tile_h, c.tile_w))
    assert eng.stream_pairs - before == 8000 and eng.stream_frames == 3


def test_k4_bytes_is_the_kernel_tables_bound():
    """At the frame of the port's table of kernels (``build_highpoly_world
    (9)`` under the demo camera at 1920x1080, 8x128 tiles: 79,483 pairs,
    every one walked, on an NVIDIA H100 80GB HBM3), K4's bytes give its
    bound there, 0.0065 ms, within 10%."""
    from benchmark import stream_work
    from benchmark.roofline import bound
    ms = bound(stream_work.k4_bytes(79483, 135, 15, 8, 128), 0)[0]
    assert abs(ms / 0.0065 - 1) < 0.1, ms


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: python3 -m benchmark.tests.test_benchmark_highpoly "
                 "--write")
    write()
