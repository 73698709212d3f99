"""The port keeps its own copies of the reference's JAX-free modules
(configuration, scene description, host asset loading, the image
comparator). They must agree with the reference: the same configuration
fields and defaults, the same packed arrays for the repository's worlds,
the same meshes and sky, and the same comparator verdicts."""

import ast
import dataclasses
import importlib
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
# the reference's JAX-free modules the port copies byte for byte
VERBATIM = ("config.py", "editor/params.py", "editor/gizmo.py", "editor/controller.py", "utils/notify.py",
            "utils/containers.py", "utils/math3d.py", "utils/verify.py",
            "scene/camera.py", "scene/components.py", "scene/demo.py",
            "scene/level_io.py", "scene/lights.py", "scene/world.py",
            "assets/gltf.py", "assets/hdr.py", "assets/mesh.py",
            "assets/textures.py")


# copies whose docstrings were reworded: the same code
SAME_CODE = ("editor/events.py",)
# repairs a copy carries on purpose: (the reference's text, the copy's)
REPAIRS = {"assets/mesh.py": [(
    """    def vertex_for(token: str) -> int:
        key = token
        got = vert_map.get(key)
        if got is not None:
            return got
        parts = token.split("/")
""", """    def vertex_for(token: str) -> int:
        # keyed by the resolved index triple, as the native loader keys it:
        # "1/1/1" and "01/1/1" (or a relative index) name one vertex
        parts = token.split("/")
"""), (
    """            ni = n - 1 if n > 0 else len(raw_norm) + n
        idx = len(positions)
""", """            ni = n - 1 if n > 0 else len(raw_norm) + n
        key = (pi, ti, ni)
        got = vert_map.get(key)
        if got is not None:
            return got
        idx = len(positions)
""")]}


@pytest.mark.parametrize("path", VERBATIM)
def test_verbatim_copies_are_the_reference_files(path):
    """Each copy is the reference module's file, byte for byte, under the
    same relative path, after the repairs listed in ``REPAIRS`` (each
    applied to exactly one place of the reference's text)."""
    with open(os.path.join(ROOT, "tinyrenderer_tpu", path), "rb") as f:
        ref = f.read().decode()
    for old, new in REPAIRS.get(path, ()):
        assert ref.count(old) == 1, old
        ref = ref.replace(old, new)
    with open(os.path.join(ROOT, "tinyrenderer_tpu_torch", path), "rb") as f:
        assert f.read().decode() == ref


def _code(path: str) -> str:
    """The module's syntax tree without its docstrings."""
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:]
    return ast.dump(tree)


@pytest.mark.parametrize("path", SAME_CODE)
def test_reworded_copies_have_the_reference_code(path):
    """Copies that differ from the reference module in docstrings only."""
    assert (_code(os.path.join(ROOT, "tinyrenderer_tpu_torch", path))
            == _code(os.path.join(ROOT, "tinyrenderer_tpu", path)))


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


def test_default_ibl_asset_is_the_reference_asset():
    """The port's embedded irradiance map holds the JAX package's arrays:
    a run of the port's generator that drifted the asset fails here."""
    with np.load(os.path.join(ROOT, "tinyrenderer_tpu_torch", "assets",
                              "default_ibl.npz")) as t, \
            np.load(os.path.join(ROOT, "tinyrenderer_tpu", "assets",
                                 "default_ibl.npz")) as j:
        assert sorted(t.files) == sorted(j.files) == ["irradiance"]
        for k in j.files:
            assert t[k].dtype == j[k].dtype and np.array_equal(t[k], j[k]), k


def _editor_session(pkg: str, tmp_path) -> list:
    """One scripted editor session through a package's own events, gizmo,
    controller and scene modules, with a fixed pick function in place of a
    frame: select, hover, a drag along an axis (the gizmo's ray solution
    for a fixed camera), camera fly, a file drop, Delete and the app keys.
    Returns what each step left behind."""
    ev = importlib.import_module(f"{pkg}.editor.events")
    ctl = importlib.import_module(f"{pkg}.editor.controller")
    demo = importlib.import_module(f"{pkg}.scene.demo")
    world = demo.build_demo_world(n_cubes=9)
    camera = demo.build_demo_camera(320, 192)
    pick = {"id": 5}
    pc = ctl.PlayerController(camera, 320, 192, lambda x, y: pick["id"])
    g = pc.gizmo_handler.gizmo
    out = []

    def record(action=None):
        out.append((None if action is None else action.value,
                    pc.selected_object_id, sorted(g.part_axis.items()),
                    g.hovered_part_id, camera.to_raw().tolist(),
                    [(oid, o.to_json()) for oid, o in world.world_objects()],
                    [[x.tolist() for x in (o.transform.position,
                                           o.transform.rotation,
                                           o.transform.scale)]
                     for _oid, o in world.world_objects()]))

    record(pc.handle_event(ev.MouseInput(ev.MouseButton.Left, True, 160, 96),
                           world))
    pc.handle_event(ev.MouseInput(ev.MouseButton.Left, False, 160, 96), world)
    pc.update(world)
    record()
    arrow = min(g.part_axis)
    pick["id"] = arrow
    pc.handle_event(ev.CursorMoved(150.0, 90.0), world)
    record()
    pc.handle_event(ev.MouseInput(ev.MouseButton.Left, True, 150.0, 90.0),
                    world)
    record()
    for x in (153.0, 158.0, 171.5, 190.25):      # the first is under 5 px
        pc.handle_event(ev.CursorMoved(x, 90.0 + (x - 150.0) / 3), world)
        record()
    pc.handle_event(ev.MouseInput(ev.MouseButton.Left, False, 190.25, 97.0),
                    world)
    pc.update(world)
    record()
    pick["id"] = 0
    pc.handle_event(ev.MouseInput(ev.MouseButton.Right, True, 0, 0), world)
    for e in (ev.MouseDelta(12.0, -7.5), ev.KeyInput("w", True),
              ev.KeyInput("d", True)):
        pc.handle_event(e, world)
    camera.update(0.25)
    pc.handle_event(ev.MouseInput(ev.MouseButton.Right, False, 0, 0), world)
    record()
    obj = tmp_path / "tri.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    record(pc.handle_event(ev.FileDropped(str(obj)), world))
    pick["id"] = 7
    pc.handle_event(ev.MouseInput(ev.MouseButton.Left, True, 10, 10), world)
    record(pc.handle_event(ev.KeyInput("Delete", True), world))
    for e in (ev.KeyInput("r", True, ctrl=True), ev.KeyInput("w", True,
                                                             ctrl=True),
              ev.KeyInput("f", True), ev.KeyInput("i", True),
              ev.KeyInput("Escape", True), ev.Resized(640, 360)):
        record(pc.handle_event(e, world))
    out.append((pc.width, pc.height, repr(ev.MouseButton.Middle.value),
                [f.name for f in dataclasses.fields(ev.FileDropped)]))
    return out


def test_editor_copies_agree(tmp_path):
    """The copied events, gizmo and controller give the same selection,
    arrows (geometry, colours, hover), drag solution, camera motion, spawned
    and deleted objects and app actions as the reference's."""
    t = _editor_session("tinyrenderer_tpu_torch", tmp_path)
    j = _editor_session("tinyrenderer_tpu", tmp_path)
    assert len(t) == len(j)
    for k, (a, b) in enumerate(zip(t, j)):
        assert a == b, k
    moved = [step[6] for step in t[3:9]]
    assert moved[0] != moved[-1], "the drag moved nothing"


def test_notifier_and_containers_copies_agree(monkeypatch):
    """The same toasts, expiry and history, and the same stable-index
    slab, from the copies and the reference modules."""
    from tinyrenderer_tpu.utils import containers as jcont
    from tinyrenderer_tpu.utils import notify as jnotify
    from tinyrenderer_tpu_torch.utils import containers as tcont
    from tinyrenderer_tpu_torch.utils import notify as tnotify

    def session(notify, cont):
        clock = [100.0]
        monkeypatch.setattr(notify.time, "monotonic", lambda: clock[0])
        n = notify.Notifier()
        n.push("a")
        clock[0] += 3.0
        n.push("b", "warning")
        steps = [[(x.message, x.level) for x in n.active()]]
        clock[0] += 2.5
        steps.append([(x.message, x.level) for x in n.history()])
        steps.append([(x.message, x.level) for x in n.active()])
        steps.append([(x.message, x.level) for x in n.history()])
        m = cont.StableIndexMap()
        ids = [m.insert(c) for c in "abcde"]
        steps.append((ids, m.remove(1), m.remove(3), m.remove(9), m.insert("x"),
                      m.insert("y"), m.insert("z"), len(m), 3 in m, 7 in m,
                      m.get(1), list(m.items())))
        return steps

    assert session(tnotify, tcont) == session(jnotify, jcont)
    assert tcont.BasicTimer().get_delta_and_reset_timer() >= 0.0
