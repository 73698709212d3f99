"""Reading a ``torch.profiler`` Chrome trace: the device events, the traced
window, the device's busy time, its longest idle gaps and what the host
was doing in them.

``DEVICE_CATS``, ``load`` and ``parse`` are a frozen copy of
``tinyrenderer_tpu_torch/tools/trace_top.py`` at commit ea2b515, except
that ``load`` takes a file (not a directory) and ``parse`` the events.
"""

from __future__ import annotations

import collections
import gzip
import json
from dataclasses import dataclass
from typing import Optional

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# host events that say what the host was doing
HOST_CATS = ("cpu_op", "user_annotation", "python_function", "cuda_runtime",
             "cuda_driver")
FRAME_ANNOTATION = "benchmark.frame"


def load(path: str) -> list:
    """The events of a Chrome trace file (``.json`` or ``.json.gz``)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        trace = json.load(f)
    return trace.get("traceEvents", []) if isinstance(trace, dict) else trace


def parse(events: list, top: Optional[int] = None) -> list:
    """The device entries by summed duration (the ``top`` costliest, or
    all): rows of ``name``, ``us`` (summed) and ``count``, costliest
    first."""
    tot: collections.Counter = collections.Counter()
    cnt: collections.Counter = collections.Counter()
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            name = e.get("name", "?")
            tot[name] += float(e.get("dur", 0))
            cnt[name] += 1
    return [{"name": n, "us": us, "count": cnt[n]}
            for n, us in tot.most_common(top)]


@dataclass
class Window:
    """The traced stretch: ``frames`` frames (host annotations) from
    ``start`` to ``end`` (us, the trace's clock), the device events in it
    and the device's busy time."""

    frames: int
    start: float
    end: float
    device: list          # (name, ts, dur) sorted by ts
    busy_us: float
    events: list

    @property
    def length_us(self) -> float:
        return self.end - self.start


def window(events: list) -> Window:
    """The window from the first frame annotation's start to the end of
    the last frame annotation or device event, whichever is later."""
    frames = [e for e in events if e.get("ph") == "X"
              and e.get("name") == FRAME_ANNOTATION
              and e.get("cat") in ("user_annotation", "cpu_op")]
    if not frames:
        raise ValueError("the trace holds no frame annotation")
    start = min(float(e["ts"]) for e in frames)
    end = max(float(e["ts"]) + float(e.get("dur", 0)) for e in frames)
    dev = sorted(((e.get("name", "?"), float(e["ts"]), float(e.get("dur", 0)))
                  for e in events if e.get("ph") == "X"
                  and e.get("cat") in DEVICE_CATS
                  and float(e["ts"]) + float(e.get("dur", 0)) > start),
                 key=lambda d: d[1])
    if dev:
        end = max(end, max(t + d for _, t, d in dev))
    busy, cur_s, cur_e = 0.0, None, None
    for _, t, d in dev:
        s, e = max(t, start), min(t + d, end)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return Window(frames=len(frames), start=start, end=end, device=dev,
                  busy_us=busy, events=events)


def idle_gaps(w: Window, top: int = 10) -> list:
    """The ``top`` longest stretches of the window with no device event,
    each as (what the host was doing at its start, seconds): the shortest
    host event that covers that moment, or ``idle`` where none does."""
    gaps, t = [], w.start
    for _, s, d in w.device:
        if s > t:
            gaps.append((t, s - t))
        t = max(t, s + d)
    if w.end > t:
        gaps.append((t, w.end - t))
    gaps.sort(key=lambda g: -g[1])
    host = [(float(e["ts"]), float(e.get("dur", 0)), e.get("name", "?"))
            for e in w.events if e.get("ph") == "X"
            and e.get("cat") in HOST_CATS
            and e.get("name") != FRAME_ANNOTATION]
    out = []
    for s, d in gaps[:top]:
        covering = [(dur, n) for ts, dur, n in host if ts <= s < ts + dur]
        out.append([min(covering)[1] if covering else "idle", d * 1e-6])
    return out
