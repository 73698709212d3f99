"""Named spans of the engine's host path, on the profiler's own clock.

``with span("engine.repack"): ...`` records a ``torch.profiler``
``record_function`` range while a profiler is recording, and nothing
otherwise. Under the profiler a span is a ``user_annotation`` event of the
same Chrome trace as the device events, on the same clock: a device-idle
interval can be put down to the span open through it, and a kernel's
``correlation`` id to the runtime call and the span that launched it. The
trace the profiler writes is the export; nothing is buffered here.

With no profiler recording, ``span`` returns one shared no-op context
manager after a single check of the profiler's state (a ``record_function``
built unconditionally costs some microseconds even with the profiler off).

Spans stay on the host path: none goes inside a function that a
``render.compiled.CompiledFn`` captures, whose Python a replay never runs.

The spans and where they are:

- ``engine.frame``: ``Engine.run_frame``, the root of a frame's spans;
- ``engine.repack``: ``Engine._repack``, a regrow included;
- ``pack.upload``: the scene and lights copied to the device in
  ``ScenePacker.pack``;
- ``engine.atlas``: the shadow atlas's call in ``Engine._render_once``;
- ``engine.replay``: the frame's call in ``Engine._render_once`` (a
  settled frame's graph replay, an unsettled frame's eager render);
- ``engine.monitor_wait``: a wait for the oldest monitor fetch with four in
  flight (one a count of ``Engine.monitor_waits``);
- ``engine.set_param``: ``Engine.set_param``.

The marks, zero-length spans whose name carries a count (``mark``), so
that a trace holds the count over its own stretch:

- ``engine.stream_pairs:<pairs>:<tiles_y>:<tiles_x>:<tile_h>:<tile_w>``:
  one frame's (tile, triangle) pairs of the main view's stream binning and
  the internal frame's tile grid, as ``Engine._apply_monitor_values``
  applies the frame's ``stream`` monitor (a few frames after the frame),
  where it is not 0 (a frame off the stream path reads 0).

The counters beside them, read from the engine:

- ``Engine.monitor_waits``: the waits of ``engine.monitor_wait``;
- ``Engine.stream_pairs`` and ``Engine.stream_frames``: the pairs of
  ``engine.stream_pairs`` summed over the frames applied, and those
  frames.
"""

from __future__ import annotations

import contextlib

import torch

recording = torch._C._autograd._profiler_enabled    # () -> bool
_NULL = contextlib.nullcontext()


def mark(name: str, *counts: int) -> None:
    """A zero-length ``record_function`` range named ``name`` and the
    ``counts``, joined by ``:``, while a profiler records; else nothing."""
    if recording():
        with torch.profiler.record_function(
                ":".join([name, *(str(int(c)) for c in counts)])):
            pass


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler
    records; else the shared no-op context manager."""
    if recording():
        return torch.profiler.record_function(name)
    return _NULL
