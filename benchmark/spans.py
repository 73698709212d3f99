"""The program's spans in a traced stretch: the ``user_annotation`` events
the engine records under the profiler (``tinyrenderer_tpu_torch/utils/
spans.py``: ``engine.frame``, ``engine.repack``, ``pack.upload``,
``engine.atlas``, ``engine.replay``, ``engine.monitor_wait``,
``engine.set_param``) beside the harness's ``benchmark.frame``, and the
device work each launched.

A device event (kernel, copy, set) was launched where the runtime call
with its ``correlation`` id (a launch, a graph launch, an asynchronous
copy) lies on the host's timeline. A device event with no runtime call of
its id takes the launch of the device event before it on its stream.

``report`` is the breakdown of ``PERF.md`` §5: each span's inclusive and
self ms a frame, the stretch's device time and device-idle time split by
the innermost span open (over the launch, through the gap), and the
runtime calls under each span.

    python3 -m benchmark.spans --workload stress_1440p.orbit --seed 7 \\
        --seconds 20 [--mode traced|untraced] [--out spans.jsonl]
    python3 -m benchmark.spans --mode guard

``traced`` (the default) runs the cell's traced run and prints its result
line with a ``spans`` key holding the report. ``untraced`` prints the host
split of the cell's frames with no profiler (``untraced_split``), which
the profiler distorts; ``guard`` the host cost of a span with the profiler
off and on (``guard_cost``).
"""

from __future__ import annotations

import bisect
import collections
import os

from .trace import DEVICE_CATS

RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
RUNTIME_TOP = 5      # runtime calls listed under each span
NONE = "none"        # no span open


def annotations(events: list, name: str | None = None) -> list:
    """The ``user_annotation`` events (of ``name``, or all) as (name,
    start, end) in us, by start."""
    return sorted(((e.get("name", "?"), float(e["ts"]),
                    float(e["ts"]) + float(e.get("dur", 0)))
                   for e in events if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation"
                   and (name is None or e.get("name") == name)),
                  key=lambda s: s[1])


def durations(w, name: str, lead_in: bool = False) -> list:
    """Each span ``name``'s duration in us, clipped to the window; spans
    that lie outside it are left out. ``lead_in``: the window opens at the
    profiled stretch's start, so that a call made for the first frame
    before its annotation counts (the traffic's inputs precede the frame
    they are for)."""
    start = -float("inf") if lead_in else w.start
    out = []
    for _, s, e in annotations(w.events, name):
        d = min(e, w.end) - max(s, start)
        if d > 0:
            out.append(d)
    return out


def mean_ms(w, name: str):
    """The mean of span ``name``'s durations in ms; None without one."""
    d = durations(w, name)
    return sum(d) / len(d) / 1e3 if d else None


def per_frame_ms(w, name: str, lead_in: bool = False):
    """Span ``name``'s durations summed, in ms, over the window's frames;
    None without one."""
    d = durations(w, name, lead_in)
    return sum(d) / 1e3 / w.frames if d and w.frames else None


def device_events(events: list) -> list:
    """The device events as (launch time or None, start, dur) in us, by
    start (see the module notes)."""
    calls = {e["args"]["correlation"]: float(e["ts"])
             for e in events if e.get("ph") == "X"
             and e.get("cat") in RUNTIME_CATS
             and "correlation" in e.get("args", {})}
    dev = sorted((e for e in events if e.get("ph") == "X"
                  and e.get("cat") in DEVICE_CATS),
                 key=lambda e: float(e["ts"]))
    last: dict = {}
    out = []
    for e in dev:
        stream = (e.get("pid"), e.get("tid"))
        t = calls.get(e.get("args", {}).get("correlation"))
        if t is None:
            t = last.get(stream)
        last[stream] = t
        out.append((t, float(e["ts"]), float(e.get("dur", 0))))
    return out


def _clipped(w, s: float, d: float) -> float:
    return max(0.0, min(s + d, w.end) - max(s, w.start))


def device_ms(w, name: str):
    """Device ms in the window launched inside a span ``name``, over the
    number of such spans there; None without one."""
    n = len(durations(w, name))
    if not n:
        return None
    own = annotations(w.events, name)
    starts = [s for _, s, _ in own]
    total = 0.0
    for t, s, d in device_events(w.events):
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= own[i][2]:
            total += _clipped(w, s, d)
    return total / 1e3 / n


# ---- the breakdown ------------------------------------------------------------

def _innermost(spans: list):
    """The timeline cut at every span boundary: (cut times, the innermost
    span open from each cut to the next), the innermost being the latest
    started of those open."""
    marks = sorted([(s, 1, i) for i, (_, s, _) in enumerate(spans)]
                   + [(e, 0, i) for i, (_, _, e) in enumerate(spans)])
    cuts, names, open_ = [], [], []
    for t, starts, i in marks:
        if starts:
            open_.append(i)
        else:
            open_.remove(i)
        name = spans[open_[-1]][0] if open_ else NONE
        if cuts and cuts[-1] == t:
            names[-1] = name
        else:
            cuts.append(t)
            names.append(name)
    return cuts, names


def _name_at(cuts: list, names: list, t: float) -> str:
    i = bisect.bisect_right(cuts, t) - 1
    return names[i] if i >= 0 else NONE


def _self_times(spans: list) -> dict:
    """name -> [count, inclusive us, self us]: a span's self time is its
    duration less that of the spans directly inside it."""
    out = collections.defaultdict(lambda: [0, 0.0, 0.0])
    stack: list = []
    for name, s, e in spans:
        while stack and stack[-1][2] <= s:
            stack.pop()
        row = out[name]
        row[0] += 1
        row[1] += e - s
        row[2] += e - s
        if stack:
            out[stack[-1][0]][2] -= e - s
        stack.append((name, s, e))
    return out


def _idle(w) -> list:
    """The window's intervals with no device event, as (start, end)."""
    gaps, t = [], w.start
    for _, s, d in w.device:
        if s > t:
            gaps.append((t, min(s, w.end)))
        t = max(t, s + d)
    if w.end > t:
        gaps.append((t, w.end))
    return gaps


def report(w) -> dict:
    """Each span's count, inclusive and self ms a frame (spans that start
    in the window); the window's device ms and device-idle ms a frame by
    the innermost span open, with the shares under no span; the host's
    costliest runtime calls (ms a frame) under each innermost span."""
    spans = annotations(w.events)
    inside = [s for s in spans if w.start <= s[1] < w.end]
    per = max(w.frames, 1) * 1e3
    table = {name: {"count": n, "inclusive_ms": inc / per,
                    "self_ms": own / per}
             for name, (n, inc, own) in sorted(_self_times(inside).items())}
    cuts, names = _innermost(spans)
    dev = collections.Counter()
    unlaunched = 0.0
    for t, s, d in device_events(w.events):
        c = _clipped(w, s, d)
        if t is None:
            unlaunched += c
        else:
            dev[_name_at(cuts, names, t)] += c
    idle = collections.Counter()
    for a, b in _idle(w):
        lo, hi = bisect.bisect_right(cuts, a), bisect.bisect_left(cuts, b)
        pts = [a] + cuts[lo:hi] + [b]
        for s, e in zip(pts, pts[1:]):
            idle[_name_at(cuts, names, s)] += e - s
    calls = collections.defaultdict(collections.Counter)
    for e in w.events:
        if e.get("ph") != "X" or e.get("cat") not in RUNTIME_CATS:
            continue
        t = float(e["ts"])
        if w.start <= t < w.end:
            calls[_name_at(cuts, names, t)][e.get("name", "?")] += float(
                e.get("dur", 0))
    dev_total = sum(dev.values()) + unlaunched
    idle_total = sum(idle.values())
    return {
        "frames": w.frames,
        "spans": table,
        "device_ms": {k: v / per for k, v in dev.most_common()},
        "device_unlaunched_ms": unlaunched / per,
        "idle_ms": {k: v / per for k, v in idle.most_common()},
        "runtime_ms": {k: {n: v / per for n, v in c.most_common(RUNTIME_TOP)}
                       for k, c in sorted(calls.items())},
        "device_share_under_no_span": (
            (dev[NONE] + unlaunched) / dev_total if dev_total else None),
        "idle_share_under_no_span": (
            idle[NONE] / idle_total if idle_total else None),
    }


def traced_run(name: str, seed: int, seconds: float, **kw) -> dict:
    """``harness.run``'s traced run of cell ``name`` (keywords passed on),
    its result with a ``spans`` key: the stretch's ``report`` and the
    number of ``engine.monitor_wait`` spans in the trace."""
    from . import harness
    from . import trace as tracelib

    found, window = {}, tracelib.window

    def keep_report(events):
        w = window(events)
        found.update(report(w), monitor_wait_spans=len(
            annotations(events, "engine.monitor_wait")))
        return w

    tracelib.window = keep_report
    try:
        result = harness.run(name, seed, seconds, True, **kw)
    finally:
        tracelib.window = window
    result["spans"] = found or None
    return result


# ---- with no profiler ---------------------------------------------------------

def untraced_split(name: str, seed: int, seconds: float, *,
                   device: str = "cuda", manifest: dict | None = None,
                   search: list | None = None) -> dict:
    """Host clocks over a closed loop of cell ``name`` for ``seconds``
    after the harness's warm-up, with no profiler (so the spans are off):
    ms a frame of the window, of ``run_frame`` (``Engine.last_frame_ms``),
    of the graph replays (``CUDAGraph.replay``, wrapped for the loop) and
    of ``Engine.set_param``, and the monitor waits a frame. These are the
    quantities the profiler distorts: under CUPTI a graph launch costs
    milliseconds and the host falls behind the device."""
    import time

    import torch

    from . import harness, scenes
    from .traffic import Traffic, apply

    if manifest is None:
        manifest = harness._load_json(os.path.join(harness.ROOT,
                                                   "BENCHMARK.json"))
    cell = harness.resolve(manifest, name, search)
    desc = scenes.describe(cell.config, harness.ROOT)
    traffic = Traffic(cell.mix, cell.config, desc, seed)
    eng = scenes.build_engine(cell.config, desc, harness.ROOT, device)
    clock = harness.Clock(device)
    first = harness.warm_up(eng, traffic)
    acc = collections.Counter()
    set_param = eng.set_param
    replay = torch.cuda.CUDAGraph.replay

    def timed_set_param(*a):
        t = time.perf_counter()
        set_param(*a)
        acc["set_param"] += time.perf_counter() - t

    def timed_replay(graph):
        t = time.perf_counter()
        replay(graph)
        acc["replay"] += time.perf_counter() - t
        acc["replays"] += 1

    eng.set_param = timed_set_param
    torch.cuda.CUDAGraph.replay = timed_replay
    try:
        waits = eng.monitor_waits
        clock.sync()
        t_open = time.perf_counter()
        n = 0
        while time.perf_counter() - t_open < seconds:
            apply(eng, traffic.frame(first + n))
            eng.run_frame(traffic.delta_seconds)
            acc["run_frame"] += eng.last_frame_ms
            n += 1
        clock.sync()
        window = time.perf_counter() - t_open
    finally:
        torch.cuda.CUDAGraph.replay = replay
        eng.set_param = set_param
    return {"workload": name, "seed": seed, "frames": n,
            "frame_ms": window * 1e3 / n,
            "run_frame_host_ms": acc["run_frame"] / n,
            "graph_replay_host_ms": acc["replay"] * 1e3 / n,
            "graph_replays_per_frame": acc["replays"] / n,
            "set_param_host_ms": acc["set_param"] * 1e3 / n,
            "monitor_waits_per_frame": (eng.monitor_waits - waits) / n}


def guard_cost(calls: int = 200_000, repeats: int = 5) -> dict:
    """The host us of a with-block of ``span`` with no profiler, beside a
    bare ``nullcontext`` and an unguarded ``record_function`` (the median
    of ``repeats`` loops of ``calls``), and of ``span`` under a profiler
    (the card's activity too where there is one)."""
    import contextlib
    import statistics
    import time

    import torch

    from tinyrenderer_tpu_torch.utils.spans import span

    def per_call_us(make, n):
        t = time.perf_counter()
        for _ in range(n):
            with make("engine.frame"):
                pass
        return (time.perf_counter() - t) / n * 1e6

    null = contextlib.nullcontext()
    makers = {"nullcontext": lambda _: null, "span": span,
              "record_function": torch.profiler.record_function}
    runs = {k: [] for k in makers}
    for _ in range(repeats):
        for k, make in makers.items():
            runs[k].append(per_call_us(make, calls))
    med = {k: statistics.median(v) for k, v in runs.items()}
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts):
        on = statistics.median(per_call_us(span, max(calls // 50, 1))
                               for _ in range(repeats))
    return {"median_us": med, "runs_us": runs,
            "guard_us": med["span"] - med["nullcontext"],
            "span_under_profiler_us": on, "torch": torch.__version__}


def main(argv=None) -> int:
    import argparse
    import json
    import sys

    import torch

    from . import harness

    t0 = harness.process_start()
    ap = argparse.ArgumentParser(
        description="the program's spans in one cell: a traced run with "
        "the spans' breakdown, the host split with no profiler, or the "
        "span guard's cost")
    ap.add_argument("--mode", choices=("traced", "untraced", "guard"),
                    default="traced")
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--out", default=None,
                    help="also append the result line to this file")
    args = ap.parse_args(argv)
    if args.mode == "guard":
        result = guard_cost()
    elif None in (args.workload, args.seed, args.seconds):
        ap.error(f"--mode {args.mode} needs --workload, --seed, --seconds")
    elif not torch.cuda.is_available():
        print("benchmark.spans: needs a CUDA device", file=sys.stderr)
        return 2
    elif args.mode == "traced":
        result = traced_run(args.workload, args.seed, args.seconds,
                            t_start=t0)
    else:
        result = untraced_split(args.workload, args.seed, args.seconds)
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
