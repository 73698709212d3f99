"""The port's editor: the reference's editor-loop scenarios (pick -> select
-> gizmo drag against real rendered frames) on CPU tensors, an event
sequence through the JAX ``EditorApp`` and the port's in lock-step, and
the ``.lvl`` hand-over between the two packages."""

import dataclasses

import numpy as np
import pytest
import torch

from tinyrenderer_tpu import config as jconfig
from tinyrenderer_tpu.editor import events as jev
from tinyrenderer_tpu.editor.session import EditorApp as JEditorApp
from tinyrenderer_tpu.render.engine import Engine as JEngine
from tinyrenderer_tpu.scene import demo as jdemo
from tinyrenderer_tpu_torch.config import RenderConfig
from tinyrenderer_tpu_torch.editor import EditorApp, events
from tinyrenderer_tpu_torch.editor.events import (CursorMoved, FileDropped,
                                                  KeyInput, MouseButton,
                                                  MouseInput)
from tinyrenderer_tpu_torch.render.engine import Engine
from tinyrenderer_tpu_torch.scene import demo
from tinyrenderer_tpu_torch.utils import verify

TINY = RenderConfig(
    width=320, height=192, tile_h=16, tile_w=128, bin_capacity=160,
    shadow_size=128, shadow_tile=128, shadow_bin_capacity=128,
    env_size=32, irradiance_size=8, texture_size=64, mip_levels=4,
    max_vertices=8192, max_triangles=4096, max_instances=64,
    use_pallas=False, enable_ssr=False,
)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Six test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def app():
    """The reference's editor fixture without the point light (one shadow
    view, no billboard): the gizmo's arrows alone take the forward
    overlay."""
    eng = Engine.from_world(demo.build_demo_world(n_cubes=9,
                                                  with_point_light=False),
                            camera=demo.build_demo_camera(TINY.width, TINY.height),
                            cfg=TINY, device="cpu")
    a = EditorApp(eng)
    a.run_frame()
    return a


def _find_pixel_of(pick, oid):
    ys, xs = np.nonzero(pick == oid)
    assert len(ys), f"object {oid} not visible"
    i = len(ys) // 2
    return float(xs[i]), float(ys[i])


def _visible_object(pick):
    """The object with the most coverage, the ground slab (id 1) aside."""
    ids = [int(i) for i in np.unique(pick) if i > 1]
    assert ids
    return max(ids, key=lambda i: (pick == i).sum())


def _click(app, x, y):
    app.handle_event(MouseInput(MouseButton.Left, True, x, y))
    app.handle_event(MouseInput(MouseButton.Left, False, x, y))


def _select_visible(app):
    oid = _visible_object(app.picker.latest)
    _click(app, *_find_pixel_of(app.picker.latest, oid))
    return oid


def _visible_arrows(app):
    gizmo = app.controller.gizmo_handler.gizmo
    pick = app.picker.latest
    return [pid for pid in gizmo.part_axis if (pick == pid).sum() > 0]


# -- the reference's editor scenarios on the port ----------------------------

def test_click_selects_and_spawns_gizmo(app):
    oid = _select_visible(app)
    assert app.selected_object_id == oid
    gizmo = app.controller.gizmo_handler.gizmo
    assert len(gizmo.part_axis) == 3  # three arrows spawned
    # arrows are transient: they must not serialize
    for part_id in gizmo.part_axis:
        assert app.engine.world.get_world_object(part_id).is_fully_transient()


def test_gizmo_drag_moves_object_along_axis(app):
    oid = _select_visible(app)
    world = app.engine.world
    start = np.array(world.get_world_object(oid).transform.position)
    # render so the arrows appear in the pick map, then grab one
    app.run_frame()
    arrow_ids = _visible_arrows(app)
    assert arrow_ids, "no gizmo arrow visible in pick map"
    pid = arrow_ids[0]
    axis = app.controller.gizmo_handler.gizmo.part_axis[pid]
    ax_, ay_ = _find_pixel_of(app.picker.latest, pid)
    app.handle_event(MouseInput(MouseButton.Left, True, ax_, ay_))
    app.handle_event(CursorMoved(ax_ + 30, ay_))        # beyond 25px² threshold
    app.handle_event(MouseInput(MouseButton.Left, False, ax_ + 30, ay_))
    delta = np.array(world.get_world_object(oid).transform.position) - start
    # movement is constrained to the grabbed axis
    for k in range(3):
        if k != axis:
            assert abs(delta[k]) < 1e-4, (axis, delta)
    assert abs(delta[axis]) > 1e-3, (axis, delta)


def test_escape_deselects_and_despawns(app):
    oid = _select_visible(app)
    assert app.selected_object_id == oid
    n_before = len(app.engine.world)
    app.handle_event(KeyInput("Escape", True))
    assert app.selected_object_id is None
    assert len(app.engine.world) == n_before - 3  # arrows despawned


def test_delete_removes_selected(app):
    oid = _select_visible(app)
    app.handle_event(KeyInput("Delete", True))
    assert app.engine.world.get_world_object(oid) is None
    out = app.run_frame()      # the frame still renders after the deletion
    assert out.sdr.shape[0] == TINY.height
    assert not (app.picker.latest == oid).any()


def test_hover_highlights_arrow(app):
    _select_visible(app)
    app.run_frame()
    gizmo = app.controller.gizmo_handler.gizmo
    arrow_ids = _visible_arrows(app)
    assert arrow_ids
    app.handle_event(CursorMoved(*_find_pixel_of(app.picker.latest,
                                                 arrow_ids[0])))
    assert gizmo.hovered_part_id == arrow_ids[0]
    app.handle_event(CursorMoved(1.0, 1.0))       # hover off restores
    assert gizmo.hovered_part_id != arrow_ids[0]


def test_camera_fly_mode(app):
    cam = app.engine.camera
    start = cam.position.copy()
    # movement keys ignored without RMB
    app.handle_event(KeyInput("w", True))
    cam.update(0.1)
    np.testing.assert_array_equal(cam.position, start)
    # RMB enables fly mode
    app.handle_event(MouseInput(MouseButton.Right, True, 0, 0))
    app.handle_event(KeyInput("w", True))
    cam.update(0.1)
    assert np.linalg.norm(cam.position - start) > 0.01
    app.handle_event(MouseInput(MouseButton.Right, False, 0, 0))
    moved = cam.position.copy()
    cam.update(0.1)  # released: movement stops
    np.testing.assert_array_equal(cam.position, moved)


def test_file_drop_spawns_object(app, tmp_path):
    n = len(app.engine.world)
    obj_path = tmp_path / "tri.obj"
    obj_path.write_text(
        "v 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0 0\nvt 1 0\nvt 0 1\n"
        "vn 0 0 1\nvn 0 0 1\nvn 0 0 1\nf 1/1/1 2/2/2 3/3/3\n")
    app.handle_event(FileDropped(str(obj_path)))
    assert len(app.engine.world) == n + 1
    out = app.run_frame()
    assert out.sdr.dtype == torch.uint8


def test_kernel_reload_noop(app):
    res = app.engine.recompile_kernels()
    assert res.ok and not res.changed
    assert any("up to date" in t.message for t in app.engine.notifier.active())


def test_reflected_params_reach_the_frame(app):
    """An edit of the registered GlobalParams lands in the engine's params
    vector on its device at the next frame, and the selected object
    registers its reflected tree."""
    oid = _select_visible(app)
    app.registry.set("global_params", ["exposure"], 2.5)
    app.run_frame()
    assert app.engine.params.device.type == "cpu"
    assert app.engine.params[0].item() == 2.5
    assert f"object_{oid}" in app.registry.describe_all()


# -- the JAX EditorApp and the port's, one event sequence --------------------

class _Pair:
    """Both editors on the editor fixture's world, driven by the same
    events; the JAX picker is flushed after each frame so that both read
    the newest frame's pick map. The world has no billboard, so the frame
    takes the forward overlay exactly while the gizmo is shown."""

    def __init__(self):
        self.j = JEditorApp(JEngine.from_world(
            jdemo.build_demo_world(n_cubes=9, with_point_light=False),
            camera=jdemo.build_demo_camera(TINY.width, TINY.height),
            cfg=jconfig.RenderConfig(**dataclasses.asdict(TINY))))
        self.t = EditorApp(Engine.from_world(
            demo.build_demo_world(n_cubes=9, with_point_light=False),
            camera=demo.build_demo_camera(TINY.width, TINY.height), cfg=TINY,
            device="cpu"))

    def event(self, name, *args):
        def build(mod):
            return getattr(mod, name)(*[mod.MouseButton(a) if a in
                                        ("left", "right") else a
                                        for a in args])
        self.j.handle_event(build(jev))
        self.t.handle_event(build(events))
        self.check_state()

    def frame(self):
        j_out = self.j.run_frame()
        self.j.picker.flush()
        t_out = self.t.run_frame()
        np.testing.assert_array_equal(self.t.picker.latest, self.j.picker.latest)
        assert self.t.engine.cfg.has_forward == self.j.engine.cfg.has_forward
        self.check_state()
        return j_out, t_out

    def check_state(self):
        """Selection, gizmo parts and hover, and every world object's
        transform bit for bit."""
        j, t = self.j, self.t
        assert t.selected_object_id == j.selected_object_id
        jg, tg = j.controller.gizmo_handler.gizmo, t.controller.gizmo_handler.gizmo
        assert tg.part_axis == jg.part_axis
        assert tg.hovered_part_id == jg.hovered_part_id
        jw = dict(j.engine.world.world_objects())
        tw = dict(t.engine.world.world_objects())
        assert sorted(tw) == sorted(jw)
        for oid, obj in tw.items():
            for f in ("position", "rotation", "scale"):
                a = getattr(obj.transform, f)
                b = getattr(jw[oid].transform, f)
                assert a.dtype == b.dtype and np.array_equal(a, b), (oid, f)


@pytest.fixture(scope="module")
def pair():
    return _Pair()


def test_editor_sequence_matches_jax_editor(pair):
    """Select, gizmo, hover repack, axis drag, Escape, six runtime
    add/deletes, Delete, each followed by a frame: equal selections, gizmo
    ids, transforms and pick maps after every step, and the last frame
    within the edge-aware comparator."""
    pair.frame()
    assert not pair.t.engine.cfg.has_forward
    pick = pair.j.picker.latest
    oid = _visible_object(pick)
    x, y = _find_pixel_of(pick, oid)
    pair.event("MouseInput", "left", True, x, y)
    pair.event("MouseInput", "left", False, x, y)
    assert pair.t.selected_object_id == oid
    pair.frame()                       # the arrows in the forward overlay
    assert pair.t.engine.cfg.has_forward
    arrows = _visible_arrows(pair.t)
    assert arrows
    ax_, ay_ = _find_pixel_of(pair.t.picker.latest, arrows[0])
    pair.event("CursorMoved", ax_, ay_)          # hover re-colours: a repack
    assert pair.t.controller.gizmo_handler.gizmo.hovered_part_id == arrows[0]
    pair.frame()
    start = pair.t.engine.world.get_world_object(oid).transform.position.copy()
    pair.event("MouseInput", "left", True, ax_, ay_)
    pair.event("CursorMoved", ax_ + 30, ay_)
    pair.event("MouseInput", "left", False, ax_ + 30, ay_)
    moved = pair.t.engine.world.get_world_object(oid).transform.position
    assert not np.array_equal(moved, start)
    pair.frame()
    pair.event("KeyInput", "Escape", True)
    assert pair.t.selected_object_id is None
    pair.frame()
    assert not pair.t.engine.cfg.has_forward

    added = []          # bench.py's editor round trip, six edits
    for i in range(6):
        add = i % 2 == 0 or not added
        ids = set()
        for app, mod in ((pair.j, jdemo), (pair.t, demo)):
            if add:
                cube = next(o for _oid, o in
                            mod.build_demo_world(n_cubes=1).world_objects())
                ids.add(app.engine.world.add_world_object(cube))
            else:
                app.engine.world.remove_world_object(added[-1])
        if add:
            assert len(ids) == 1
            added.append(ids.pop())
        else:
            added.pop()
        pair.frame()

    pick = pair.j.picker.latest
    oid = _visible_object(pick)
    x, y = _find_pixel_of(pick, oid)
    pair.event("MouseInput", "left", True, x, y)
    pair.event("MouseInput", "left", False, x, y)
    pair.event("KeyInput", "Delete", True)
    assert pair.t.engine.world.get_world_object(oid) is None
    j_out, t_out = pair.frame()
    jp = np.asarray(j_out.pick_id)
    res = verify.edge_aware_compare(t_out.sdr.numpy(), np.asarray(j_out.sdr),
                                    pick=jp)
    assert res["status"] == "pass", res
    assert len(np.unique(jp)) > 2 and (jp == 0).any()



def test_saved_levels_hand_over(pair, tmp_path):
    """A level that either editor saves (after the edits of the sequence
    above when it ran first) is the same file, and it loads into the other
    package and packs to equal arrays."""
    jpath, tpath = str(tmp_path / "jax.lvl"), str(tmp_path / "port.lvl")
    pair.j.engine.save_level(jpath)
    pair.t.engine.save_level(tpath)
    with open(jpath, "rb") as f, open(tpath, "rb") as g:
        assert f.read() == g.read()
    cfg = dict(width=256, height=128, tile_h=16)
    je = JEngine(cfg=jconfig.RenderConfig(**cfg), level_path=tpath)
    te = Engine(cfg=RenderConfig(**cfg), device="cpu", level_path=jpath)
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
