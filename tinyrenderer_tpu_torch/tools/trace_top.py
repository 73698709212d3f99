"""Rank the card's device work by time from a ``torch.profiler`` trace
(the counterpart of the repository's ``tools/trace_top.py``).

``capture`` settles an engine and records 2 replays of its config's
compiled frame (or, ``--what atlas``, of its compiled shadow atlas) under
``torch.profiler`` (CPU and CUDA activities), and exports the Chrome trace
to ``--dir``; ``parse`` sums the device events of a trace by name and ranks
them. The device events of torch's export are those whose ``cat`` is
``kernel``, ``gpu_memcpy`` or ``gpu_memset`` (the reference picked the
TPU's process track); the kernels a CUDA graph replays are among them, as
CUPTI traces a graph's nodes.

The summed time counts work that overlaps twice: use the ranking to find
what is big, and an interleaved A/B (``profile_frame``, ``ab_frame``) to
verify a change.

    python -m tinyrenderer_tpu_torch.tools.trace_top [--device cpu]
        [--dir build/trace_top] [--top 40] [--parse-only]
        [--what frame|atlas] [--shadow8] [--scene test|stress|highpoly]
        [--multilight] [--level PATH]
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
from typing import Optional

import torch

from .. import bench
from ..render import frame as framelib
from . import timing

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CAVEAT = ("summed device time counts overlapping work twice: find what is "
          "big here, verify a change with an interleaved A/B")
# --shadow8: shadow lookups at 1/8 rate with the gate blocks they settle to
SHADOW8 = dict(shadow_lookup_scale=8, shadow_block_capacity=3072)


def capture(eng, trace_dir: str, what: str = "frame",
            replays: int = 2) -> str:
    """Settle ``eng``, capture its config's compiled frame (or shadow
    atlas) outside the trace, then trace ``replays`` replays and a
    synchronize. Returns the trace's path."""
    bench.settle(eng)
    cfg = eng.cfg
    scene, pool, lights, params, env, atlas = timing.frame_args(eng)
    if what == "atlas":
        fn = framelib.compiled_shadow_atlas(cfg)

        def call():
            return fn(scene, lights)
    else:
        fn = framelib.compiled_frame(cfg)
        cam = timing.camera(eng)

        def call():
            return fn(scene, pool, lights, cam, params, env, atlas)
    clock = timing.Clock(eng.device)
    call()
    clock.sync()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if clock.cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(replays):
            call()
        clock.sync()
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"trace_top_{what}.json")
    prof.export_chrome_trace(path)
    return path


def _newest_trace(trace_dir: str) -> str:
    paths = [p for pat in ("*.json", "*.json.gz")
             for p in glob.glob(os.path.join(trace_dir, "**", pat),
                                recursive=True)]
    if not paths:
        raise SystemExit(f"trace_top: no trace under {trace_dir}")
    return max(paths, key=os.path.getmtime)


def load(path: str) -> list:
    """The events of a Chrome trace file (``.json`` or ``.json.gz``) or
    of the newest one under a directory."""
    if os.path.isdir(path):
        path = _newest_trace(path)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        trace = json.load(f)
    return trace.get("traceEvents", []) if isinstance(trace, dict) else trace


def parse(path: str, top: Optional[int] = None) -> list:
    """The device entries of a trace by summed duration (the ``top``
    costliest, or all): rows of ``name``, ``us`` (summed) and ``count``,
    costliest first."""
    tot: collections.Counter = collections.Counter()
    cnt: collections.Counter = collections.Counter()
    for e in load(path):
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            name = e.get("name", "?")
            tot[name] += float(e.get("dur", 0))
            cnt[name] += 1
    return [{"name": n, "us": us, "count": cnt[n]}
            for n, us in tot.most_common(top)]


def print_rows(rows: list, total_us: float, label: str) -> None:
    print(f"# {label}")
    print(f"# total device time of the ranked entries: {total_us / 1e3:.3f} "
          f"ms ({CAVEAT})")
    print(f"{'us':>10s} {'n':>5s}  op")
    for r in rows:
        print(f"{r['us']:10.1f} {r['count']:5d}  {r['name'][:110]}")


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    timing.add_scene_args(ap)
    ap.add_argument("--dir", default=os.path.join("build", "trace_top"))
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--parse-only", action="store_true")
    ap.add_argument("--what", choices=("frame", "atlas"), default="frame")
    ap.add_argument("--shadow8", action="store_true",
                    help="shadow lookups at 1/8 rate with 3072 gate blocks")
    args = ap.parse_args(argv)
    path = args.dir
    if not args.parse_only:
        timing.require_device(args.device, "trace_top")
        eng = timing.engine_from_args(args, SHADOW8 if args.shadow8 else None)
        path = capture(eng, args.dir, args.what)
    rows = parse(path)
    print_rows(rows[:args.top], sum(r["us"] for r in rows), path)
    return rows[:args.top]


if __name__ == "__main__":
    main()
