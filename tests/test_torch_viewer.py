"""The port's viewer HTTP server: the reference's viewer scenarios (the
full editor loop over the wire) on CPU tensors, its reflected parameter
tree against the JAX server's, and the headless CLI."""

import dataclasses
import io
import json
import os
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from tinyrenderer_tpu import config as jconfig
from tinyrenderer_tpu.editor.session import EditorApp as JEditorApp
from tinyrenderer_tpu.render.engine import Engine as JEngine
from tinyrenderer_tpu.scene import demo as jdemo
from tinyrenderer_tpu.viewer.server import PAGE_HTML as J_PAGE_HTML
from tinyrenderer_tpu.viewer.server import ViewerServer as JViewerServer
from tinyrenderer_tpu_torch.config import RenderConfig
from tinyrenderer_tpu_torch.editor.session import EditorApp
from tinyrenderer_tpu_torch.render.engine import Engine
from tinyrenderer_tpu_torch.scene import demo, level_io
from tinyrenderer_tpu_torch.viewer.server import PAGE_HTML, ViewerServer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = RenderConfig(
    width=256, height=128, tile_h=16, tile_w=128, bin_capacity=160,
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


@pytest.fixture(scope="module")
def server():
    eng = Engine.from_world(demo.build_demo_world(n_cubes=9),
                            camera=demo.build_demo_camera(TINY.width, TINY.height),
                            cfg=TINY, device="cpu")
    srv = ViewerServer(EditorApp(eng), port=0)  # ephemeral port
    srv.start_background()
    yield srv
    srv.shutdown()


def _get(server, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{server.port}{path}",
                                timeout=120) as r:
        return r.read()


def _post(server, path, obj):
    req = urllib.request.Request(f"http://127.0.0.1:{server.port}{path}",
                                 data=json.dumps(obj).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _png(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)))


def test_page_and_frame(server):
    page = _get(server, "/")
    assert b"<canvas" in page and page == J_PAGE_HTML.encode()
    assert PAGE_HTML == J_PAGE_HTML
    png = _get(server, "/frame.png")
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    np.testing.assert_array_equal(_png(png), server.app.engine.present_numpy())


def test_state_has_params(server):
    s = json.loads(_get(server, "/state"))
    assert "global_params" in s["params"]
    fields = {f["name"] for f in s["params"]["global_params"]["fields"]}
    assert {"exposure", "tone_mapping_type"} <= fields


def test_click_selects_over_http(server):
    _get(server, "/frame.png")
    pick = server.app.picker.latest
    ids = [int(i) for i in np.unique(pick) if i > 1]
    assert ids
    oid = max(ids, key=lambda i: (pick == i).sum())
    ys, xs = np.nonzero(pick == oid)
    x, y = float(xs[len(xs) // 2]), float(ys[len(ys) // 2])
    _post(server, "/event", [
        {"type": "button", "button": "left", "pressed": True, "x": x, "y": y},
        {"type": "button", "button": "left", "pressed": False, "x": x, "y": y},
    ])
    s = json.loads(_get(server, "/state"))
    assert s["selected"] == oid
    # the selected object's reflected UI registers on the next frame
    _get(server, "/frame.png")
    s = json.loads(_get(server, "/state"))
    assert f"object_{oid}" in s["params"]


def test_param_edit_changes_frame(server):
    _post(server, "/set", {"name": "global_params", "path": ["exposure"],
                           "value": 0.05})
    dark = _png(_get(server, "/frame.png"))
    _post(server, "/set", {"name": "global_params", "path": ["exposure"],
                           "value": 4.0})
    bright = _png(_get(server, "/frame.png"))
    assert bright.mean() > dark.mean() + 10
    _post(server, "/set", {"name": "global_params", "path": ["exposure"],
                           "value": 1.0})


def test_bad_requests_surface_cleanly(server):
    # unknown action -> 500 with toast, server stays alive
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, "/action", {"action": "nonsense"})
    assert e.value.code == 500
    s = json.loads(_get(server, "/state"))
    assert any("nonsense" in t["message"] for t in s["toasts"])
    # malformed json -> 400
    req = urllib.request.Request(f"http://127.0.0.1:{server.port}/set",
                                 data=b"{not json", method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 400
    # still serving frames
    assert _get(server, "/frame.png")[:4] == b"\x89PNG"


def test_set_config_action(server):
    _post(server, "/action", {"action": "set_config",
                              "values": {"texture_filter": "bilinear"}})
    assert server.app.engine.cfg.texture_filter == "bilinear"
    # frame still renders after the pipeline switch
    assert _get(server, "/frame.png")[:4] == b"\x89PNG"
    _post(server, "/action", {"action": "set_config",
                              "preset": "performance"})
    assert server.app.engine.cfg.texture_filter == "stochastic"
    assert _get(server, "/frame.png")[:4] == b"\x89PNG"
    # non-tunable fields are rejected (capacity envelope stays intact)
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, "/action", {"action": "set_config",
                                  "values": {"max_instances": 4}})
    assert e.value.code == 500
    assert server.app.engine.cfg.max_instances != 4


def test_set_config_resize_updates_camera(server):
    _post(server, "/action", {"action": "set_config",
                              "values": {"width": 384, "height": 192}})
    eng = server.app.engine
    assert (eng.cfg.width, eng.cfg.height) == (384, 192)
    # camera aspect follows atomically
    assert abs(eng.camera.aspect - 384 / 192) < 1e-6
    assert server.app.controller.width == 384
    img = _png(_get(server, "/frame.png"))
    assert img.shape[:2] == (192, 384)
    _post(server, "/action", {"action": "set_config",
                              "values": {"width": 256, "height": 128}})


def test_upload_spawns_model(server):
    obj = (b"v 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0 0\nvt 1 0\nvt 0 1\nvn 0 0 1\n"
           b"f 1/1/1 2/2/1 3/3/1\n")
    n_before = len(list(server.app.engine.world.world_objects()))
    req = urllib.request.Request(
        f"http://127.0.0.1:{server.port}/upload", data=obj, method="POST",
        headers={"X-Filename": "tri.obj"})
    with urllib.request.urlopen(req, timeout=120) as r:
        res = json.loads(r.read())
    assert res["ok"] and os.path.exists(res["path"])
    # FileDropped spawned a world object
    n_after = len(list(server.app.engine.world.world_objects()))
    assert n_after == n_before + 1
    assert _get(server, "/frame.png")[:4] == b"\x89PNG"


def test_event_stream_fuzz(server):
    """Seeded fuzz over the event wire: random bursts of key/mouse/wheel/
    resize/drop events in arbitrary order must never kill the server;
    every burst is followed by a working /frame.png and /state."""
    rng = np.random.default_rng(42)
    keys = ["w", "a", "s", "d", "q", "e", "Delete", "Escape", "f", "i"]

    def rand_event():
        t = rng.integers(0, 7)
        if t == 0:
            return {"type": "key", "key": str(rng.choice(keys)),
                    "pressed": bool(rng.integers(0, 2)),
                    "ctrl": bool(rng.integers(0, 2))}
        if t == 1:
            return {"type": "move", "x": float(rng.uniform(-50, 400)),
                    "y": float(rng.uniform(-50, 300))}
        if t == 2:
            return {"type": "button", "button": int(rng.integers(0, 3)),
                    "pressed": bool(rng.integers(0, 2)),
                    "x": float(rng.uniform(0, 256)),
                    "y": float(rng.uniform(0, 128))}
        if t == 3:
            return {"type": "delta", "dx": float(rng.normal() * 20),
                    "dy": float(rng.normal() * 20)}
        if t == 4:
            return {"type": "drop", "path": "/nonexistent/fuzz.obj"}
        if t == 5:
            return {"type": "unknown_kind", "x": 1}
        return {"garbage": True}

    for burst in range(6):
        events = [rand_event() for _ in range(int(rng.integers(1, 12)))]
        try:
            _post(server, "/event", events)
        except urllib.error.HTTPError as e:
            # malformed payloads surface as 500 + toast by design; the
            # requirement is that the server keeps serving
            assert e.code == 500
        frame = _get(server, "/frame.png")
        assert frame[:8] == b"\x89PNG\r\n\x1a\n"
        state = json.loads(_get(server, "/state"))
        assert state["frame_index"] > 0


def test_state_params_equal_the_jax_server():
    """The reflected parameter tree that /state serves, with nothing
    selected and with the same object selected, equals the JAX server's.
    No frame is rendered."""
    def servers():
        j = JViewerServer(JEditorApp(JEngine.from_world(
            jdemo.build_demo_world(n_cubes=9),
            camera=jdemo.build_demo_camera(TINY.width, TINY.height),
            cfg=jconfig.RenderConfig(**dataclasses.asdict(TINY)))), port=0)
        t = ViewerServer(EditorApp(Engine.from_world(
            demo.build_demo_world(n_cubes=9),
            camera=demo.build_demo_camera(TINY.width, TINY.height), cfg=TINY,
            device="cpu")), port=0)
        return j, t

    pair = servers()
    for srv in pair:
        srv.start_background()
    try:
        for select in (None, 5):
            states = []
            for srv in pair:
                if select is not None:
                    app = srv.app
                    with srv.lock:
                        app.controller.gizmo_handler.gizmo.select(
                            select, app.engine.world, app.engine.camera)
                        app._sync_registry()
                states.append(json.loads(_get(srv, "/state")))
            j, t = states
            assert t["params"] == j["params"]
            assert t["selected"] == j["selected"] == select
            assert set(t) == set(j)
    finally:
        for srv in pair:
            srv.shutdown()


# -- the headless CLI -----------------------------------------------------------

def _cli(*args, **env):
    return subprocess.run([sys.executable, "-m", "tinyrenderer_tpu_torch", *args],
                          capture_output=True, text=True, timeout=600, cwd=ROOT,
                          env={**os.environ, **env})


def test_cli_renders_on_the_cpu_when_asked(tmp_path):
    """``--device cpu`` writes the PNG of the frame an engine of the same
    level and size renders. The level has no light, so no shadow view of
    the default 1024-texel atlas is rendered on the host."""
    lvl = str(tmp_path / "unlit.lvl")
    world = demo.build_demo_world(n_cubes=4, with_point_light=False,
                                  with_directional_light=False)
    level_io.save_level(lvl, world, demo.build_demo_camera(160, 96))
    out = str(tmp_path / "frame.png")
    res = _cli("--device", "cpu", "--level", lvl, "--width", "160",
               "--height", "96", "--out", out, "--stats", OMP_NUM_THREADS="1")
    assert res.returncode == 0, res.stderr
    assert "visible objects: 5" in res.stdout, res.stdout
    eng = Engine(cfg=RenderConfig(width=160, height=96), device="cpu",
                 level_path=lvl)
    with open(out, "rb") as f:
        np.testing.assert_array_equal(_png(f.read()), eng.present_numpy())


def test_cli_without_a_card_fails(tmp_path):
    """The default device is CUDA: on a host without one the CLI exits
    non-zero, names CUDA, and writes nothing."""
    out = str(tmp_path / "frame.png")
    res = _cli("--width", "160", "--height", "96", "--out", out)
    assert res.returncode != 0 and "CUDA" in res.stderr
    assert not os.path.exists(out)
