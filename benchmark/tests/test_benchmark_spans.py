"""The span readers (``benchmark/spans.py`` and the four metrics that read
the program's spans) on hand-built traces: device work put down to the
span that launched it by correlation id, or in stream order where a
device event has no runtime call; spans clipped to the window; nothing
where a span is absent; a traced run of a tiny drag cell on the CPU; the
untraced split and the span guard's cost."""

import os

import pytest
import torch

from benchmark import harness, spans, trace
from benchmark.tests import fixtures

NEW = ("repack_host_ms", "pack_upload_ms", "atlas_device_ms",
       "set_param_ms")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _read(name, w):
    reader = harness.load_reader(os.path.join(harness.BENCH_DIR, "metrics",
                                              name + ".py"))
    return reader(harness.TraceData(window=w))


def _span(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur}


def _runtime(name, ts, corr):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts,
            "dur": 5, "args": {"correlation": corr}}


def _kernel(ts, dur, corr=None, stream=7):
    e = {"ph": "X", "cat": "kernel", "name": "k", "ts": ts, "dur": dur,
         "pid": 0, "tid": stream}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _drag_trace():
    """Two frames of 1000 us, each after a parameter set (the first before
    the window opens); frame 1 repacks (an upload
    inside), renders the atlas (a launch of two graph kernels, one of them
    without an id) and replays; frame 2 waits for a monitor and replays.
    The last replay's kernel runs to 2100 us, where the window ends."""
    f = trace.FRAME_ANNOTATION
    return [
        _span("engine.set_param", -50, 20),
        _span(f, 0, 1000), _span("engine.frame", 10, 980),
        _span("engine.repack", 20, 400), _span("pack.upload", 300, 100),
        _span("engine.atlas", 450, 200),
        _runtime("cudaGraphLaunch", 460, 1),
        _span("engine.replay", 700, 250),
        _runtime("cudaGraphLaunch", 710, 2),
        _span("engine.set_param", 1000, 10),
        _span(f, 1010, 990), _span("engine.frame", 1020, 970),
        _span("engine.monitor_wait", 1100, 300),
        _span("engine.replay", 1500, 400),
        _runtime("cudaGraphLaunch", 1510, 3),
        _kernel(500, 100, corr=1), _kernel(600, 50),       # the atlas's
        _kernel(800, 150, corr=2),                         # frame 1's
        _kernel(1900, 200, corr=3),                        # frame 2's
        _kernel(1000, 40, corr=99, stream=8),              # no launch
    ]


def test_correlation_and_stream_order():
    w = trace.window(_drag_trace())
    assert (w.frames, w.start, w.end) == (2, 0.0, 2100.0)
    dev = spans.device_events(w.events)
    assert [t for t, _, _ in dev] == [460.0, 460.0, 710.0, None, 1510.0]
    # the atlas's two kernels, the second by stream order
    assert spans.device_ms(w, "engine.atlas") == pytest.approx(0.15)
    assert _read("atlas_device_ms", w) == pytest.approx(0.15)
    # the replays' kernels: 150 us and 200 us over two spans
    assert spans.device_ms(w, "engine.replay") == pytest.approx(0.175)


def test_host_span_readers():
    w = trace.window(_drag_trace())
    assert _read("repack_host_ms", w) == pytest.approx(0.4)
    assert _read("pack_upload_ms", w) == pytest.approx(0.1)
    assert spans.per_frame_ms(w, "engine.replay") == pytest.approx(0.65 / 2)
    assert spans.per_frame_ms(w, "engine.monitor_wait") == pytest.approx(
        0.3 / 2)
    # the first frame's set, before the window opens, counts
    assert _read("set_param_ms", w) == pytest.approx(0.03 / 2)


def test_clipping_to_the_window():
    """A span that starts before the window counts from its start, one
    that ends after it up to its end, one outside it not at all; the
    parameter sets count from the stretch's start."""
    ev = _drag_trace() + [_span("engine.set_param", 1990, 500),
                          _span("engine.set_param", 2500, 50),
                          _span("engine.repack", -100, 300)]
    w = trace.window(ev)
    assert w.end == 2100.0
    assert spans.durations(w, "engine.set_param") == [10.0, 110.0]
    assert spans.durations(w, "engine.set_param", lead_in=True) == [
        20.0, 10.0, 110.0]
    assert _read("set_param_ms", w) == pytest.approx((20 + 10 + 110) / 2e3)
    assert spans.durations(w, "engine.repack") == [200.0, 400.0]
    assert _read("repack_host_ms", w) == pytest.approx(0.3)


def test_absent_spans_read_nothing():
    """An orbit frame has no repack, upload or atlas; a program without
    spans (or a trace without a window) gives none of the four."""
    f = trace.FRAME_ANNOTATION
    orbit = [_span(f, 0, 1000), _span("engine.frame", 10, 980),
             _span("engine.replay", 100, 800),
             _runtime("cudaGraphLaunch", 110, 1), _kernel(200, 500, corr=1)]
    w = trace.window(orbit)
    for name in ("repack_host_ms", "pack_upload_ms", "atlas_device_ms",
                 "set_param_ms"):
        assert _read(name, w) is None, name
    assert spans.per_frame_ms(w, "engine.monitor_wait") is None
    assert spans.per_frame_ms(w, "engine.replay") == pytest.approx(0.8)
    bare = trace.window([_span(f, 0, 1000), _kernel(200, 500)])
    for name in NEW:
        assert _read(name, bare) is None, name
        assert _read(name, None) is None, name


def test_report_splits_device_and_idle_time():
    f = trace.FRAME_ANNOTATION
    ev = [_span(f, 0, 1000), _span("engine.frame", 100, 800),
          _span("engine.replay", 200, 300),
          _runtime("cudaGraphLaunch", 250, 1), _kernel(300, 400, corr=1),
          _runtime("cudaMemcpyAsync", 50, 2), _kernel(900, 50, corr=2),
          _kernel(960, 20, corr=77, stream=9)]
    w = trace.window(ev)
    r = spans.report(w)
    assert r["frames"] == 1
    assert r["spans"]["engine.frame"] == {
        "count": 1, "inclusive_ms": pytest.approx(0.8),
        "self_ms": pytest.approx(0.5)}
    assert r["spans"][f]["self_ms"] == pytest.approx(0.2)
    assert r["device_ms"] == {"engine.replay": pytest.approx(0.4),
                              f: pytest.approx(0.05)}
    assert r["device_unlaunched_ms"] == pytest.approx(0.02)
    # idle: 0-100 under the frame annotation, 100-200 under engine.frame,
    # 200-300 under the replay, 700-900 under engine.frame (to 900),
    # 950-960 and 980-1000 under the frame annotation
    assert r["idle_ms"] == {"engine.frame": pytest.approx(0.3),
                            f: pytest.approx(0.13),
                            "engine.replay": pytest.approx(0.1)}
    assert r["idle_share_under_no_span"] == 0.0
    assert r["runtime_ms"] == {
        "engine.replay": {"cudaGraphLaunch": pytest.approx(0.005)},
        f: {"cudaMemcpyAsync": pytest.approx(0.005)}}
    assert r["device_share_under_no_span"] == pytest.approx(20 / 470)


def test_traced_drag_cell_on_the_cpu(tmp_path, monkeypatch):
    """The traced run of the tiny stress drag cell reports the span
    metrics its cell lists (the CPU trace has no device events:
    the atlas reads 0)."""
    man = fixtures.write_tiny(str(tmp_path), cubes=4)
    monkeypatch.setattr(harness, "QUIET_FRAMES", 1)
    monkeypatch.setattr(harness, "PROFILE_SECONDS", 0.5)
    # the stretch opens at the first frame after a third of the window:
    # one frame at least, on a loaded host too
    r = harness.run("tiny_stress_1440p.drag", 11, 10.0, True, device="cpu",
                    manifest=man, search=[str(tmp_path)],
                    log=lambda *a: None)
    m = r["metrics"]
    assert set(NEW) <= set(m)
    assert m["atlas_device_ms"]["value"] == 0.0
    assert m["repack_host_ms"]["value"] > m["pack_upload_ms"]["value"] > 0
    assert m["set_param_ms"]["value"] > 0
    assert r["correct"] is True


def test_traced_run_reports_the_spans(tmp_path, monkeypatch):
    """``spans.traced_run`` on the tiny deferred drag cell: every program
    span in the table, the device shares (none on the CPU), the monitor
    waits' spans of the whole trace (the table counts those in the
    window)."""
    man = fixtures.write_tiny(str(tmp_path), cubes=4)
    monkeypatch.setattr(harness, "QUIET_FRAMES", 1)
    monkeypatch.setattr(harness, "PROFILE_SECONDS", 0.5)
    r = spans.traced_run("tiny_deferred_1080p.drag", 5, 10.0, device="cpu",
                         manifest=man, search=[str(tmp_path)],
                         log=lambda *a: None)
    s = r["spans"]
    assert s["frames"] >= 1
    assert {"engine.frame", "engine.repack", "pack.upload", "engine.atlas",
            "engine.replay", trace.FRAME_ANNOTATION} <= set(s["spans"])
    frame = s["spans"]["engine.frame"]
    assert frame["count"] == s["frames"]
    assert 0 < frame["self_ms"] < frame["inclusive_ms"]
    assert s["device_ms"] == {} and s["device_share_under_no_span"] is None
    waits = s["spans"].get("engine.monitor_wait", {"count": 0})["count"]
    assert s["monitor_wait_spans"] >= waits
    assert r["correct"] is True


def test_untraced_split_on_the_cpu(tmp_path, monkeypatch):
    """``spans.untraced_split`` on the tiny stress drag cell: the loop's
    frames, ``run_frame``'s and ``set_param``'s host ms (the stress
    configuration sets the exposure every frame), no graph replay on the
    CPU; ``CUDAGraph.replay`` and the engine's ``set_param`` are restored."""
    man = fixtures.write_tiny(str(tmp_path), cubes=4)
    monkeypatch.setattr(harness, "QUIET_FRAMES", 1)
    replay = torch.cuda.CUDAGraph.replay
    r = spans.untraced_split("tiny_stress_1440p.drag", 3, 0.5, device="cpu",
                             manifest=man, search=[str(tmp_path)])
    assert r["frames"] >= 1
    assert r["frame_ms"] >= r["run_frame_host_ms"] > 0
    assert r["run_frame_host_ms"] > r["set_param_host_ms"] > 0
    assert r["graph_replays_per_frame"] == r["graph_replay_host_ms"] == 0
    assert r["monitor_waits_per_frame"] >= 0
    assert torch.cuda.CUDAGraph.replay is replay


def test_guard_cost_reports_each_form():
    """``spans.guard_cost`` times a span with the profiler off beside a
    bare ``nullcontext`` and ``record_function``, and a span under it."""
    r = spans.guard_cost(calls=200, repeats=3)
    assert set(r["median_us"]) == {"nullcontext", "span", "record_function"}
    assert all(len(v) == 3 and min(v) > 0 for v in r["runs_us"].values())
    assert r["guard_us"] == pytest.approx(
        r["median_us"]["span"] - r["median_us"]["nullcontext"])
    assert r["span_under_profiler_us"] > 0
