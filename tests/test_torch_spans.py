"""The engine's spans (``utils/spans.py``): nothing built while no profiler
records; under ``torch.profiler`` a drag frame with a parameter set emits
its spans nested as the code nests them; a monitor wait is one span per
count of ``Engine.monitor_waits``; no span runs inside a function a
``CompiledFn`` captures; ``last_frame_ms`` is the whole ``run_frame``."""

import json
import time

import numpy as np
import pytest
import torch

from test_torch_overflow import _Pending
from tinyrenderer_tpu_torch.config import RenderConfig
from tinyrenderer_tpu_torch.render import frame as framelib
from tinyrenderer_tpu_torch.render.engine import Engine
from tinyrenderer_tpu_torch.scene import demo
from tinyrenderer_tpu_torch.utils import spans

CFG = RenderConfig(
    width=128, height=64, tile_h=16, tile_w=128, bin_capacity=256,
    shadow_size=64, shadow_tile=64, shadow_bin_capacity=256,
    env_size=16, irradiance_size=8, texture_size=32, mip_levels=3,
    max_vertices=8192, max_triangles=4096, max_instances=128,
    use_pallas=False, enable_ssr=False, enable_shadows=True,
)
PROGRAM = ("engine.", "pack.")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Six test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engine() -> Engine:
    return Engine.from_world(demo.build_demo_world(n_cubes=6),
                             camera=demo.build_demo_camera(128, 64), cfg=CFG,
                             device="cpu")


def _settled_engine() -> Engine:
    eng = _engine()
    for _ in range(3):
        eng.run_frame(0.0)
        eng.drain_monitors()
        if eng._settled:
            return eng
    raise AssertionError("the engine did not settle")


def _annotations(prof, tmp_path) -> list:
    """The trace's ``user_annotation`` events as (name, start, end), in
    order of start."""
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted(((e["name"], float(e["ts"]),
                    float(e["ts"]) + float(e.get("dur", 0)))
                   for e in events if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation"),
                  key=lambda a: a[1])


def _one(annotations, name):
    found = [a for a in annotations if a[0] == name]
    assert len(found) == 1, (name, found)
    return found[0]


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_span_without_a_profiler_builds_nothing(monkeypatch):
    built = []
    real = torch.profiler.record_function

    def counting(name):
        built.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    first, second = spans.span("engine.frame"), spans.span("engine.replay")
    assert first is second is spans._NULL
    with first:
        pass
    assert built == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with spans.span("engine.frame") as rf:
            assert rf is not spans._NULL
    assert built == ["engine.frame"]


def test_drag_frame_spans_nest(tmp_path):
    """One drag frame after a parameter set: ``engine.set_param``, then
    ``engine.frame`` around the repack (the upload inside it), the atlas
    and the replay, in that order."""
    eng = _settled_engine()
    oid = next(oid for oid, _ in eng.world.world_objects() if oid != 0)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        eng.set_param(framelib.PARAM_EXPOSURE, 1.5)
        obj = eng.world.get_world_object_mut(oid)
        obj.transform.position = obj.transform.position + np.float32(0.25)
        eng.run_frame(1.0 / 60.0)
    ann = [a for a in _annotations(prof, tmp_path)
           if a[0].startswith(PROGRAM)]
    names = [a[0] for a in ann]
    assert names == ["engine.set_param", "engine.frame", "engine.repack",
                     "pack.upload", "engine.atlas", "engine.replay"]
    setp, frame, repack, upload, atlas, replay = ann
    assert setp[2] <= frame[1]
    for a in (repack, atlas, replay):
        assert _inside(a, frame), a
    assert _inside(upload, repack)
    assert repack[2] <= atlas[1] and atlas[2] <= replay[1]
    assert float(eng.params[framelib.PARAM_EXPOSURE]) == 1.5


def test_orbit_frame_has_no_edit_spans(tmp_path):
    """A frame with no edit records the frame and its replay only: the
    atlas stays cached, nothing is packed."""
    eng = _settled_engine()
    eng.run_frame(0.0)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        eng.run_frame(1.0 / 60.0)
    names = [a[0] for a in _annotations(prof, tmp_path)
             if a[0].startswith(PROGRAM)]
    assert names == ["engine.frame", "engine.replay"]


def test_monitor_wait_spans_count_the_waits(tmp_path):
    """With fetches that never complete by themselves, every wait for the
    oldest one is one ``engine.monitor_wait`` span."""
    eng = Engine(cfg=RenderConfig(), device="cpu")
    eng._settled = True
    before = eng.monitor_waits
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(10):
            eng._overflow_inflight.append((("tex",), _Pending([10])))
            eng._check_overflow()
    waits = [a for a in _annotations(prof, tmp_path)
             if a[0] == "engine.monitor_wait"]
    assert eng.monitor_waits - before == 7
    assert len(waits) == eng.monitor_waits - before


def test_no_span_inside_the_compiled_functions(tmp_path):
    """The functions a ``CompiledFn`` captures (the frame, the shadow
    atlas) record no program span: a replay would not run it."""
    eng = _settled_engine()
    p = eng._pack
    pool = eng._packer.pool_for(eng.cfg, eng.device)
    cam = torch.from_numpy(eng.camera.to_raw())
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        atlas, _, _ = framelib.render_shadow_atlas(p.scene, p.lights, eng.cfg)
        framelib.render_frame(p.scene, pool, p.lights, cam, eng.params,
                              eng._ensure_env(), eng.cfg, atlas)
    assert not [a for a in _annotations(prof, tmp_path)
                if a[0].startswith(PROGRAM)]


def test_last_frame_ms_is_the_whole_call(monkeypatch):
    """``last_frame_ms`` times all of ``run_frame`` on the host clock, the
    update (the repack) included, with no profiler."""
    eng = _settled_engine()
    update = eng.update

    def slow_update(dt):
        time.sleep(0.05)
        update(dt)

    monkeypatch.setattr(eng, "update", slow_update)
    t = time.perf_counter()
    eng.run_frame(0.0)
    wall_ms = (time.perf_counter() - t) * 1e3
    assert 50.0 <= eng.last_frame_ms <= wall_ms
