"""The harness on the CPU: every cell's files found by name, a new
configuration and mix picked up from files alone, the metrics' arithmetic
on fixtures, the result's keys, the exit without a card; and, on the
card, a short run of the headline cell."""

import gzip
import json
import os
import subprocess
import sys

import pytest

from benchmark import harness, roofline, trace
from benchmark.tests import fixtures


def _manifest():
    return harness._load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))


def test_every_cell_resolves_its_files():
    man = _manifest()
    for w in man["workloads"]:
        cell = harness.resolve(man, w["name"])
        assert cell.config["name"] == w["config"]
        assert "camera" in cell.mix
        assert cell.end_to_end and cell.per_layer
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        for m, read in cell.per_layer:
            assert callable(read), m["name"]
        assert set(cell.limits) >= {"pick_mismatch", "depth_rel", "hdr_rel",
                                    "sdr_off"}, w["name"]


def test_config_fields_are_the_engines():
    from tinyrenderer_tpu_torch.config import RenderConfig
    for entry in _manifest()["configs"]:
        c = harness._load_json(os.path.join(harness.ROOT, entry["file"]))
        cfg = RenderConfig(**c["render"])
        for k, v in c["render"].items():
            assert getattr(cfg, k) == v
        assert c["name"] == entry["name"] and c["reduced"] == entry["reduced"]


def test_new_files_are_found_without_an_edit(tmp_path):
    """A configuration, a mix and a metric added as files (and manifest
    entries) under another directory are picked up by name."""
    man = _manifest()
    (tmp_path / "configs").mkdir()
    (tmp_path / "traffic").mkdir()
    (tmp_path / "metrics").mkdir()
    c = harness._load_json(os.path.join(harness.ROOT, man["configs"][0]["file"]))
    c["name"] = "extra_cfg"
    (tmp_path / "configs" / "extra_cfg.json").write_text(json.dumps(c))
    (tmp_path / "traffic" / "still.json").write_text(json.dumps(
        {"camera": {"mode": "fixed"}, "warmup_frames": 1}))
    (tmp_path / "metrics" / "frames_traced.py").write_text(
        "def read(data):\n    return data.window.frames if data.window else None\n")
    man["configs"].append(dict(man["configs"][0], name="extra_cfg",
                               file="elsewhere/extra_cfg.json"))
    man["workloads"].append({"name": "extra_cfg.still", "config": "extra_cfg",
                             "traffic": "still", "chips": 1, "why": "a test"})
    man["per_layer"].append({"name": "frames_traced", "unit": "frames",
                             "better": "higher", "source": "device_trace",
                             "layer": "device", "moves": "frame_ms"})
    cell = harness.resolve(man, "extra_cfg.still", [str(tmp_path)])
    assert cell.config["name"] == "extra_cfg"
    assert cell.mix["camera"]["mode"] == "fixed"
    reader = dict((m["name"], r) for m, r in cell.per_layer)["frames_traced"]
    assert reader(harness.TraceData()) is None


def test_window_metrics():
    lat = [0.001 * (i + 1) for i in range(100)]       # 1 .. 100 ms
    m = harness.window_metrics(2.0, 400, lat)
    assert m["frame_ms"] == pytest.approx(5.0)
    assert m["latency_p95_ms"] == pytest.approx(95.05)  # linear between ranks
    # one stall among 100 frames moves the tail, not the median
    m2 = harness.window_metrics(2.0, 400, lat[:-1] + [1.0])
    assert m2["latency_p95_ms"] == pytest.approx(95.05)
    m3 = harness.window_metrics(2.0, 400, [0.001] * 90 + [0.2] * 10)
    assert m3["latency_p95_ms"] == pytest.approx(200.0)


def _trace_file(tmp_path):
    """Two frames over 0..1000 us: device ops 100-300, 250-400 (overlap),
    600-700 (a K3), a copy 800-850; a host op over 400-600."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.FRAME_ANNOTATION,
           "ts": 0, "dur": 500},
          {"ph": "X", "cat": "user_annotation", "name": trace.FRAME_ANNOTATION,
           "ts": 500, "dur": 500},
          {"ph": "X", "cat": "kernel", "name": "void at::elementwise", "ts": 100,
           "dur": 200},
          {"ph": "X", "cat": "kernel", "name": "void at::cat", "ts": 250,
           "dur": 150},
          {"ph": "X", "cat": "kernel", "name": "void tr::shade_kernel<2>",
           "ts": 600, "dur": 100},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD", "ts": 800,
           "dur": 50},
          {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 400,
           "dur": 200}]
    path = tmp_path / "t.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": ev}, f)
    return str(path)


def test_trace_arithmetic(tmp_path):
    w = trace.window(trace.load(_trace_file(tmp_path)))
    assert (w.frames, w.start, w.end) == (2, 0.0, 1000.0)
    assert w.busy_us == pytest.approx(300 + 100 + 50)
    data = harness.TraceData(window=w, k3_bound_ms=0.05)
    read = {m: harness.load_reader(os.path.join(harness.BENCH_DIR, "metrics",
                                                m + ".py"))
            for m in ("device_idle_pct", "launches_per_frame",
                      "glue_device_ms", "k3_roofline")}
    assert read["device_idle_pct"](data) == pytest.approx(55.0)
    assert read["launches_per_frame"](data) == pytest.approx(2.0)
    assert read["glue_device_ms"](data) == pytest.approx(0.4 / 2)
    assert read["k3_roofline"](data) == pytest.approx(50.0)
    gaps = trace.idle_gaps(w)
    assert gaps[0] == ["aten::copy_", pytest.approx(200e-6)]
    rows = trace.parse(w.events)
    assert rows[0]["name"] == "void at::elementwise"


def test_k3_bound_at_the_headline_shape():
    """K3 at 1088x1920, slim bf16 planes, two lights, sky and IBL: 28
    bytes a background pixel, 52 a covered one; bytes-bound."""
    px = 1088 * 1920
    nbytes, flops = roofline.shade_work(px, px // 2, 8, 2, False, 2, True,
                                        True)
    assert nbytes == px // 2 * 28 + px // 2 * 52
    ms, what = roofline.bound(nbytes, flops)
    assert what == "bytes" and ms == pytest.approx(nbytes / 3.35e9)
    assert roofline.shade_work(px, 0, 8, 2, False, 2, True, True)[1] == 0


def test_result_keys_and_metric_set(tmp_path):
    man = fixtures.write_tiny(str(tmp_path), cubes=4)
    harness.QUIET_FRAMES, saved = 1, harness.QUIET_FRAMES
    try:
        r = harness.run("tiny_deferred_1080p.orbit", 11, 0.2, False,
                        device="cpu", manifest=man, search=[str(tmp_path)],
                        log=lambda *a: None)
    finally:
        harness.QUIET_FRAMES = saved
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device",
                       "checks"]
    assert set(r["metrics"]) == {"frame_ms", "latency_p95_ms",
                                 "peak_device_mib", "setup_s"}
    assert r["correct"] is True and r["failed"] == 0
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())


def test_exits_without_a_card_and_prints_no_result():
    r = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        "deferred_1080p.orbit", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=harness.ROOT,
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert "correct" not in r.stdout


@pytest.mark.cuda
def test_headline_cell_on_the_card(cuda_device):
    r = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        "deferred_1080p.orbit", "--seed", "2147483659",
                        "--seconds", "3", "--trace", "1"], cwd=harness.ROOT,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["busy_s"] > 0
    assert {"launches_per_frame", "device_idle_pct"} <= set(line["metrics"])
