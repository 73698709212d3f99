"""One run of one cell: the configuration and the traffic mix found by
name, the engine built, warmed up and driven in a closed loop for the
window, the checked frames held against the plain reference, and the
result.

Everything a cell names is a file found by its name under the directories
searched (the benchmark's own by default): ``configs`` through
``BENCHMARK.json``'s ``file``, ``traffic/<mix>.json``,
``metrics/<metric>.py`` (a ``read(data)`` that returns a number or None)
and ``limits/<workload>.json``. Adding a configuration, a mix or a metric
adds files and a manifest entry, and edits nothing here.

The window (``--trace 0``): frame i's host call of ``Engine.run_frame`` is
stamped on the host clock, a CUDA event is recorded when it returns, and
the window ends with a synchronize. ``frame_ms`` is the window over its
frames; ``latency_p95_ms`` the 95th percentile over all of them of the
event's time, put on the host clock by an event recorded right after the
synchronize that opens the window, less the call's stamp.

The traced run (``--trace 1``) adds host spans around ``run_frame`` and
``Engine.update``, reads the compiled caches' misses across the window,
and profiles a short stretch from a third of the window on (at most
``PROFILE_FRAMES`` frames or ``PROFILE_SECONDS``).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np

from . import check, scenes
from . import trace as tracelib
from .traffic import Traffic, apply

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
IBL_ASSET = "benchmark/assets/default_ibl.npz"
FORBIDDEN = ("jax", "jaxlib", "flax", "tinyrenderer_tpu")
PROFILE_FRAMES = 60
PROFILE_SECONDS = 1.5
# frames in a row with no capture on a settled engine that end the warm-up
QUIET_FRAMES = 60
CHECKED_FRACTIONS = 2     # seeded frames checked besides the last
# profiled frames whose covered pixels K3's bound is read from
K3_SAMPLES = 4


# ---- finding a cell's files by name ------------------------------------------

@dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    end_to_end: list
    per_layer: list            # (metric entry, reader)
    limits: dict


def _find(search: list, *parts: str) -> str:
    for d in search:
        p = os.path.join(d, *parts)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(os.path.join(*parts))


def _load_json(path: str) -> dict:
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def load_reader(path: str):
    name = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def resolve(manifest: dict, name: str, search: list | None = None) -> Cell:
    """The cell ``name`` of a manifest with every file it names: a
    configuration's ``file`` in the checkout, else by its base name under
    the ``configs`` of the directories searched."""
    search = list(search or []) + [BENCH_DIR]
    wl = next(w for w in manifest["workloads"] if w["name"] == name)
    entry = next(c for c in manifest["configs"] if c["name"] == wl["config"])
    cpath = os.path.join(ROOT, entry["file"])
    if not os.path.exists(cpath):
        cpath = _find(search, "configs", os.path.basename(entry["file"]))
    config = _load_json(cpath)
    mix = _load_json(_find(search, "traffic", wl["traffic"] + ".json"))
    e2e = [m for m in manifest["end_to_end"]
           if name in m.get("workloads", [name])]
    layer = [(m, load_reader(_find(search, "metrics", m["name"] + ".py")))
             for m in manifest["per_layer"]
             if name in m.get("workloads", [name])]
    try:
        limits = _load_json(_find(search, "limits", name + ".json"))
    except FileNotFoundError:
        limits = {}
    return Cell(name, config, mix, e2e, layer, limits)


# ---- clocks ------------------------------------------------------------------

def process_start() -> float:
    """The process's start on ``time.perf_counter``'s clock (Linux:
    /proc; else now)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


class Clock:
    """Completion stamps of frames: CUDA events on the card, the host
    clock on the CPU (where a frame completes before its call returns)."""

    def __init__(self, device):
        import torch
        self.torch = torch
        self.cuda = torch.device(device).type == "cuda"

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def stamp(self):
        if self.cuda:
            e = self.torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def seconds(self, origin, origin_host: float, stamp) -> float:
        """A stamp on the host clock, from ``origin`` recorded at
        ``origin_host``."""
        if self.cuda:
            return origin_host + origin.elapsed_time(stamp) / 1e3
        return stamp


def gpu_state() -> str:
    """The card's SM clock, power draw and limit, temperature."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "nvidia-smi: not found"
    try:
        r = subprocess.run(
            [smi, "--query-gpu=name,clocks.sm,power.draw,power.limit,"
             "temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


# ---- the engine through set-up -------------------------------------------------

def _captures() -> int:
    from tinyrenderer_tpu_torch.render import frame as framelib
    return (framelib.compiled_frame.cache_info().misses
            + framelib.compiled_shadow_atlas.cache_info().misses)


def warm_up(eng, traffic: Traffic) -> int:
    """Settle, then run the traffic's frames until ``warmup_frames`` ran
    and ``QUIET_FRAMES`` in a row captured nothing on a settled engine,
    every monitor read. Returns the next frame index.

    The settle is the sequence of ``tinyrenderer_tpu_torch/bench.py``'s
    ``settle`` at commit ea2b515: a frame, every queued monitor read, then
    frames until one held its config."""
    dt = traffic.delta_seconds
    i = 0

    def step():
        nonlocal i
        apply(eng, traffic.warmup_frame(i))
        eng.run_frame(dt)
        i += 1

    step()
    eng.drain_monitors()
    for _ in range(10):
        if eng._settled:
            break
        step()
        eng.drain_monitors()
    else:
        raise RuntimeError("the capacities did not settle in 10 frames")
    limit = 5 * max(traffic.warmup_frames, QUIET_FRAMES)
    quiet, misses = 0, _captures()
    while True:
        step()
        m = _captures()
        quiet = quiet + 1 if (m == misses and eng._settled) else 0
        misses = m
        if i >= traffic.warmup_frames and quiet >= QUIET_FRAMES:
            eng.drain_monitors()
            if eng._settled:
                return i
            quiet = 0
        if i > limit:
            raise RuntimeError(f"the engine still captured after {i} frames")


# ---- the result ----------------------------------------------------------------

@dataclass
class TraceData:
    """What a per-layer metric reads."""

    window: tracelib.Window | None = None
    host_ms: list = field(default_factory=list)
    update_edit_ms: list = field(default_factory=list)
    captures: int | None = None
    k3_bound_ms: float | None = None


def k3_bound_ms(cfg, depths: list) -> float | None:
    """K3's least time a frame, the mean over the frames whose depth maps
    (cropped, > 0 where geometry covers) are ``depths`` (a sample of the
    profiled frames), at the frame's padded shape; None where the frame
    does not run the fused shading."""
    from tinyrenderer_tpu_torch.render import frame as framelib

    from .roofline import bound, shade_work
    if not framelib.use_fused_shading(cfg) or not depths:
        return None
    slim = not cfg.any_textured
    total = 0.0
    for d in depths:
        nbytes, flops = shade_work(
            cfg.padded_height * cfg.padded_width, int((d > 0).sum()),
            8 if slim else 15, 2 if cfg.bf16_attrs else 4, not slim,
            cfg.num_point_lights + cfg.num_directional_lights, True,
            cfg.enable_ibl)
        total += bound(nbytes, flops)[0]
    return total / len(depths)


def forbidden_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in sys.modules}
                  & set(FORBIDDEN))


@dataclass
class Kept:
    index: int
    inp: object
    out: object


def run(name: str, seed: int, seconds: float, traced: bool, *,
        device: str = "cuda", manifest: dict | None = None,
        search: list | None = None, t_start: float | None = None,
        log=print) -> dict:
    """One run of cell ``name`` of ``manifest`` (the checkout's
    ``BENCHMARK.json`` by default); returns the result line's object."""
    import torch

    t0 = process_start() if t_start is None else t_start
    if manifest is None:
        manifest = _load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = resolve(manifest, name, search)
    desc = scenes.describe(cell.config, ROOT)
    traffic = Traffic(cell.mix, cell.config, desc, seed)
    eng = scenes.build_engine(cell.config, desc, ROOT, device)
    clock = Clock(device)
    next_i = warm_up(eng, traffic)
    n_pre, expected = _expected_frames(eng, traffic, next_i, seconds, clock)
    first = next_i + n_pre
    if traced:
        _profile_nothing(clock)
    gc.collect()
    clock.sync()
    setup_s = time.perf_counter() - t0
    log(f"# setup: {setup_s:.3f} s, {next_i} frames before the window, "
        f"cfg {eng.cfg.width}x{eng.cfg.height}; card: {gpu_state()}")

    data = TraceData()
    if traced:
        frames, kept = _traced_window(eng, traffic, first, expected,
                                      seconds, seed, clock, data)
        window_s = None
    else:
        frames, kept, window_s, lat = _window(eng, traffic, first, expected,
                                              seconds, seed, clock)
    log(f"# window: {frames} frames; card: {gpu_state()}")
    peak = (torch.cuda.max_memory_reserved() if clock.cuda else 0)
    cfg = eng.cfg

    # the program's state freed before the reference runs
    outs = [(k.index, k.inp, k.out) for k in kept]
    del eng, kept
    from tinyrenderer_tpu_torch.render import frame as framelib
    framelib.compiled_frame.cache_clear()
    framelib.compiled_shadow_atlas.cache_clear()
    gc.collect()
    if clock.cuda:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    checks, failed = _check(outs, traffic, cell, device)
    log(f"# check: {len(outs)} frames against the reference in "
        f"{time.perf_counter() - t_check:.3f} s")
    correct = failed == 0 and check.passed(checks)

    metrics = {}
    if traced:
        for m, reader in cell.per_layer:
            v = reader(data)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        values = {**window_metrics(window_s, frames, lat),
                  "peak_device_mib": peak / 2 ** 20, "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if clock.cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if clock.cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": frames,
              "failed": failed, "metrics": metrics, "device": dev}
    if traced and data.window is not None:
        w = data.window
        dev["busy_s"] = w.busy_us * 1e-6
        dev["window_s"] = w.length_us * 1e-6
        result["breakdown"] = {
            "device_ops": [[r["name"], r["us"] * 1e-6]
                           for r in tracelib.parse(w.events, 10)],
            "idle_gaps": tracelib.idle_gaps(w, 10)}
        w.events = None
    result["checks"] = checks
    log(f"# cfg at the end: bins {cfg.bin_capacity}, shadow bins "
        f"{cfg.shadow_bin_capacity}, shadow blocks "
        f"{cfg.shadow_block_capacity}, fwd tiles {cfg.fwd_tile_capacity}")
    return result


def window_metrics(window_s: float, frames: int, latencies) -> dict:
    """``frame_ms``: the window over its frames; ``latency_p95_ms``: the
    95th percentile (linear between ranks) over every frame's latency."""
    return {"frame_ms": window_s * 1e3 / frames,
            "latency_p95_ms": float(np.percentile(latencies, 95)) * 1e3}


def _picks(seed: int, expected: int) -> set:
    """Window frame indices checked besides the last: fractions of the
    expected frame count drawn from the seed."""
    rng = np.random.default_rng((int(seed) & ((1 << 64) - 1), 7))
    return {int(u * expected) for u in rng.uniform(0.1, 0.9, CHECKED_FRACTIONS)}


def _expected_frames(eng, traffic, next_i, seconds, clock) -> tuple:
    """(frames run, frames the window will hold): a short timed run of the
    traffic, set-up's last frames. It holds as many frames' outputs as the
    window will keep and lets them go, so that the allocator has their
    memory cached and keeping them in the window allocates nothing."""
    clock.sync()
    t = time.perf_counter()
    n, held = 0, []
    while n < 5 or time.perf_counter() - t < 0.2:
        apply(eng, traffic.warmup_frame(next_i + n))
        out = eng.run_frame(traffic.delta_seconds)
        if len(held) < CHECKED_FRACTIONS + 1 + K3_SAMPLES:
            held.append(out)
        n += 1
    clock.sync()
    return n, max(1, int(seconds * n / (time.perf_counter() - t)))


def _activities(clock) -> list:
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if clock.cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _profile_nothing(clock) -> None:
    """Start and stop the profiler once: its first start (CUPTI's set-up)
    belongs to set-up, not to the window."""
    import torch
    with torch.profiler.profile(activities=_activities(clock)):
        clock.sync()


def _window(eng, traffic, first, expected, seconds, seed, clock):
    picks = _picks(seed, expected)
    dt = traffic.delta_seconds
    calls, stamps, kept = [], [], []
    last = None
    clock.sync()
    origin = clock.stamp()
    t_open = time.perf_counter()
    i = 0
    while time.perf_counter() - t_open < seconds:
        inp = traffic.frame(first + i)
        apply(eng, inp)
        calls.append(time.perf_counter())
        out = eng.run_frame(dt)
        stamps.append(clock.stamp())
        if i in picks:
            kept.append(Kept(i, inp, out))
        last = Kept(i, inp, out)
        i += 1
    clock.sync()
    t_close = time.perf_counter()
    if last is not None and last.index not in picks:
        kept.append(last)
    done = np.array([clock.seconds(origin, t_open, s) for s in stamps])
    lat = done - np.array(calls)
    return i, kept, t_close - t_open, lat


def _traced_window(eng, traffic, first, expected, seconds, seed, clock,
                   data):
    import torch
    picks = _picks(seed, expected)
    dt = traffic.delta_seconds
    kept, last = [], None
    update = eng.update
    span = {}

    def timed_update(*a, **k):
        t = time.perf_counter()
        update(*a, **k)
        span["update"] = time.perf_counter() - t

    eng.update = timed_update
    misses = _captures()
    acts = _activities(clock)
    prof, prof_frames, prof_t, depths = None, 0, None, []
    tmp = tempfile.mkdtemp(prefix="benchmark-trace-")
    try:
        clock.sync()
        t_open = time.perf_counter()
        i = 0
        # the window outlasts its seconds while the profiler is on
        while time.perf_counter() - t_open < seconds or prof is not None:
            now = time.perf_counter()
            if prof is None and prof_t is None and now - t_open >= seconds / 3:
                clock.sync()
                prof = torch.profiler.profile(activities=acts)
                prof.__enter__()
                prof_t = time.perf_counter()
            inp = traffic.frame(first + i)
            apply(eng, inp)
            t = time.perf_counter()
            if prof is not None:
                with torch.profiler.record_function(tracelib.FRAME_ANNOTATION):
                    out = eng.run_frame(dt)
                prof_frames += 1
                if prof_frames % (PROFILE_FRAMES // K3_SAMPLES) == 1:
                    depths.append(out.depth)
                if (prof_frames >= PROFILE_FRAMES
                        or time.perf_counter() - prof_t >= PROFILE_SECONDS):
                    clock.sync()
                    prof.__exit__(None, None, None)
                    path = os.path.join(tmp, "trace.json.gz")
                    prof.export_chrome_trace(path)
                    data.window = tracelib.window(tracelib.load(path))
                    os.remove(path)
                    prof = None
                    data.k3_bound_ms = k3_bound_ms(eng.cfg, depths)
                    depths = []
            else:
                out = eng.run_frame(dt)
                data.host_ms.append((time.perf_counter() - t) * 1e3)
                if inp.edits:
                    data.update_edit_ms.append(span["update"] * 1e3)
            if i in picks:
                kept.append(Kept(i, inp, out))
            last = Kept(i, inp, out)
            i += 1
        clock.sync()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        eng.update = update
    data.captures = _captures() - misses
    if last is not None and last.index not in picks:
        kept.append(last)
    return i, kept


# ---- the check -----------------------------------------------------------------

def _check(outs, traffic: Traffic, cell: Cell, device):
    """The checked frames against the reference: (``{number: {value,
    limit}}`` with each number the worst over the frames, frames that
    failed)."""
    import torch

    from .reference import frame as ref
    render = cell.config["render"]
    base = {"exposure": 1.0, "shadow_bias": 0.0, **cell.config.get("params", {})}
    env = ref.Environment(render, os.path.join(ROOT, IBL_ASSET), device)
    readings, failed, atlas = [], 0, None
    for _, inp, out in outs:
        scene = traffic.scene_at(inp)
        r, new_atlas = ref.render(scene, render, {**base, **inp.params}, env,
                                  atlas=None if inp.edits else atlas,
                                  device=device)
        if not inp.edits:
            atlas = new_atlas
        numbers = check.compare(out, r)
        readings.append(numbers)
        if not check.passed(check.judge(numbers, cell.limits)):
            failed += 1
        del r
    if device != "cpu":
        torch.cuda.synchronize()
    return check.judge(check.worst(readings), cell.limits), failed
