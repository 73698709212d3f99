"""Dump the captured CUDA graph of the compiled headline frame, and find
the port's source lines that launch a kernel (the counterpart of the
repository's ``tools/dump_hlo.py``, which dumped the optimised HLO so that
``trace_top``'s ``fusion.N`` entries could be traced back to source ops).

On the card the compiled program is the graph that ``frame.compiled_frame``
captures. This tool captures the same frame function as a
``CompiledFn(..., debug_dump=--out)``: CUDA's debug mode is on before the
capture, and the graph is written as a DOT file
(``CUDAGraph.debug_dump``). It prints the graph's kernel nodes counted by
kernel name. With ``--op NAME`` (repeatable) it also profiles one eager
frame (``--what atlas``: one shadow atlas) with ``with_stack=True`` and
prints, for each kernel whose name contains NAME, the port's Python
frames that launched it (innermost first), found through the launch's
correlation id in the trace.

    python -m tinyrenderer_tpu_torch.tools.dump_graph
        [--out build/frame_graph.dot] [--op raster_kernel]
        [--what frame|atlas]
        [--scene test|stress|highpoly] [--multilight] [--level PATH]
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import os
import re
import subprocess
import tempfile

import torch

from .. import bench
from ..render import compiled
from ..render import frame as framelib
from . import timing


def dump(eng, out: str) -> str:
    """Settle ``eng`` and capture its frame function (as
    ``frame.compiled_frame(cfg)`` wraps it) into a graph written to
    ``out`` as DOT. Returns ``out``."""
    bench.settle(eng)
    cfg = eng.cfg
    scene, pool, lights, params, env, atlas = timing.frame_args(eng)
    if eng.device.type != "cuda":
        raise RuntimeError("dump_graph: a CUDA graph needs the card")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)

    def fn(scene, pool, lights, camera_raw, params, env, atlas=None):
        return framelib.render_frame(scene, pool, lights, camera_raw, params,
                                     env, cfg, atlas)
    compiled.CompiledFn(fn, debug_dump=out)(
        scene, pool, lights, timing.camera(eng), params, env, atlas)
    torch.cuda.synchronize()
    return out


def demangle(names: list) -> list:
    """``names`` demangled by ``c++filt`` where it runs, else as given."""
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, timeout=60,
                             check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        return list(names)
    return out if len(out) == len(names) else list(names)


def kernel_nodes(dot: str, demangle_names: bool = True
                 ) -> collections.Counter:
    """The kernel nodes of a graph's DOT dump counted by kernel name. In
    ``cudaGraphDebugDotPrint``'s verbose output a kernel node's label
    opens ``{KERNEL`` and its ID record ends with the kernel's mangled
    name and its launch shape, ``name\\<\\<\\<grid,block,smem\\>\\>\\>``."""
    mangled: collections.Counter = collections.Counter(
        m.group(1).strip() for m in re.finditer(
            r'label="\{KERNEL\s*\|\s*\{ID \|[^|\n]*\|\s*([^\n]*?)\\<',
            dot))
    if not demangle_names:
        return mangled
    keys = list(mangled)
    counts: collections.Counter = collections.Counter()
    for k, name in zip(keys, demangle(keys)):
        counts[name] += mangled[k]
    return counts


def op_sources(events: list, names: list) -> dict:
    """{name: [(kernel, [port frames, innermost first]), ...]} from the
    events of a ``with_stack=True`` Chrome trace: each device kernel whose
    name contains one of ``names``, its launch (the runtime event with the
    same correlation id) and the Python function events of the port that
    enclose the launch on its thread."""
    launches = {}
    py = collections.defaultdict(list)
    kernels = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat == "cuda_runtime":
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = e
        elif cat == "python_function":
            py[(e.get("pid"), e.get("tid"))].append(e)
        elif cat == "kernel":
            kernels.append(e)
    for evs in py.values():
        evs.sort(key=lambda e: e["ts"])
    starts = {key: [e["ts"] for e in evs] for key, evs in py.items()}
    found: dict = {n: [] for n in names}
    seen = set()
    for k in kernels:
        for n in names:
            if n not in k.get("name", ""):
                continue
            launch = launches.get(k.get("args", {}).get("correlation"))
            if launch is None:
                continue
            thread = (launch.get("pid"), launch.get("tid"))
            ts = launch["ts"]
            i = bisect.bisect_right(starts.get(thread, []), ts)
            stack = [e["name"] for e in py[thread][:i]
                     if e["ts"] + e.get("dur", 0) >= ts
                     and "tinyrenderer_tpu_torch" in e["name"]]
            key = (n, k["name"], tuple(stack))
            if key not in seen:
                seen.add(key)
                found[n].append((k["name"], stack[::-1]))
    return found


def trace_eager(call, device) -> list:
    """The events of ``call()`` run eagerly on ``device`` and traced with
    Python stacks."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts, with_stack=True) as prof:
        call()
        timing.Clock(device).sync()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    return trace.get("traceEvents", [])


def trace_eager_frame(eng, what: str = "frame") -> list:
    """:func:`trace_eager` of one frame (or, ``what="atlas"``, one shadow
    atlas) of ``eng``, settled, as its compiled graph would run it."""
    cfg = eng.cfg
    scene, pool, lights, params, env, atlas = timing.frame_args(eng)
    cam = timing.camera(eng)
    if what == "atlas":
        return trace_eager(
            lambda: framelib.render_shadow_atlas(scene, lights, cfg),
            eng.device)
    return trace_eager(lambda: framelib.render_frame(
        scene, pool, lights, cam, params, env, cfg, atlas), eng.device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    timing.add_scene_args(ap)
    ap.add_argument("--out", default=os.path.join("build", "frame_graph.dot"))
    ap.add_argument("--op", action="append", default=[],
                    help="kernel name (a substring) whose launching source "
                         "lines to print")
    ap.add_argument("--what", choices=("frame", "atlas"), default="frame",
                    help="what --op traces: a frame or the shadow atlas")
    args = ap.parse_args(argv)
    timing.require_device(args.device, "dump_graph")
    eng = timing.engine_from_args(args)
    out = dump(eng, args.out)
    with open(out) as f:
        nodes = kernel_nodes(f.read())
    print(f"wrote {out} ({os.path.getsize(out) / 1e6:.2f} MB): "
          f"{sum(nodes.values())} kernel nodes, {len(nodes)} kernels")
    for name, n in nodes.most_common():
        print(f"{n:6d}  {name[:150]}")
    res = {"dot": out, "kernel_nodes": dict(nodes)}
    if args.op:
        res["sources"] = op_sources(trace_eager_frame(eng, args.what),
                                    args.op)
        for op, hits in res["sources"].items():
            print(f"\n=== {op}: {len(hits)} launch sites ===")
            for kname, stack in hits:
                print(f"{kname[:110]}")
                for fr in stack:
                    print(f"    {fr}")
    return res


if __name__ == "__main__":
    main()
