#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

Builds the seven hand-written kernels (K1-K7) from
``tinyrenderer_tpu_torch/csrc`` (one ``nvcc`` a source, in parallel) and
runs, each phase asserting or letting its exception propagate:

1. K1-K3 against their plain PyTorch versions, at the shapes the 1080p
   frame gives them (captured from one frame of ``levels/demo.lvl``), with
   the times of both (see below);
2. the engine path at 1920x1080: ``Engine.run_frame`` ten times on the
   directional-light demo world, with the kernels' launch counters reset
   just before and read just after;
3. the point + directional frame of ``levels/demo.lvl`` (overlay off) through
   the kernels and again through the plain versions: equal pick ids and a
   passing edge-aware image comparison;
4. the high-poly stream path: ``build_highpoly_world(9)`` (~108k
   triangles) at 1920x1080 with 8x128 tiles. The engine's first frame
   settles its capacities; K4, K5 (main view) and K1 (the scatter-binned
   shadow view at its grown bin capacity, whose row count and heaviest
   tile are printed) are held against their plain versions at the
   captured shapes; ten engine frames are timed with the
   launch counters reset just before (the first re-renders the atlas); and
   one frame is rendered through the kernels and again through the plain
   versions;
5. the textured frame and the forward overlay: (a) the demo world with
   every second cube textured and its point light (a light billboard) at
   1920x1080 settles its capacities; K7 is held against its
   plain version at both call sites (the compacted material sample and the
   overlay sprite) and K3 with its material plane against its plain
   version, at the captured shapes; ten engine frames are timed with the
   launch counters reset just before; one frame is rendered through the
   kernels and again through the plain versions; (b) ``levels/demo.lvl``
   with its billboard and (c) its forward-only frame, each kernels
   against plain versions and as ten timed engine frames;
6. the unfused deferred chain on the textured world of phase 5 at
   1920x1080, each configuration settled, timed over ten engine frames and
   rendered through the kernels and through the plain versions: (a)
   ``fused_resolve`` (K6, first held against its plain version at the
   captured main-view shape), (b) SSR at strength 0.5, (c)
   ``render_scale_pct=75``, (d) ``texture_scale=2``, (e) the goldens'
   settings (``use_pallas=False``, shadow lookups and sky at 1/4 rate, f32
   atlas);
7. the environment chain, the sky options and the presets on the textured
   world of phase 5 at 1920x1080: (a) an engine with an HDR skybox file
   (written from the procedural sky) and an IBL cache path bakes the
   64-texel irradiance map of its 1024-texel cube on the card (timed; held
   against the same bake on the CPU), writes the cache, a second engine
   loads it bit-equal, and the ``BAKE_IRRADIANCE`` and ``SAVE_IRRADIANCE``
   actions run; (b) the block-compacted exact sky
   (``sky_block_capacity=4096, sky_scale=8``) gives the ``sky_scale=1``
   frame exactly, fused and unfused; (c) the cubic sky upsample and a sky
   scale of 3, which does not divide the frame; (d) ``performance_preset()``,
   ``fidelity_preset()`` and ``reference_parity()`` (the native-size
   texture pool). Each frame of (b)-(d) is settled, timed over ten engine
   frames and rendered through the kernels and through the plain versions;
8. the editor and its host surfaces on ``levels/demo.lvl`` (see
   :func:`editor_phase`): (a) pick, gizmo, hover, axis drag, Escape and
   Delete through ``EditorApp`` at 1920x1080, the gizmo frame through the
   kernels and through the plain versions; (b) bench.py's editor round
   trip (50 add/deletes, 10 pick + gizmo frames, the steady frame, timed),
   the saved level loaded into a fresh engine renders the same frame; (c)
   the kernel reload: unchanged sources build nothing, an edited copy of
   ``csrc/`` is rebuilt and swapped in, a broken one keeps the old library;
   (d) the web viewer at 1280x720 over HTTP; (e) the headless CLI;
9. the multi-device frame (:func:`sharded_phase`): four gloo ranks of
   ``torch.distributed`` sharing the card render (a) ``levels/demo.lvl``
   at 1920x1080 with its overlay in four bands (and again through the
   plain versions), (b) two cameras over dp=2, sp=2, (c) the high-poly
   world with SSR at strength 1, (d) the textured world fused and under
   ``fused_resolve``; (e) one nccl rank renders demo.lvl bit-equal to the
   single-card frame. Each frame is held against the single-card frame of
   its ``sharded_config``; each rank counts its launches from 0 and times
   its steady frame and its collectives with CUDA events;
10. the frame loop (:func:`frame_loop_phase`): (a) the first frame handed
   out is bit-equal to the 10th (the high-poly world under the default
   config, bench.py's 500-object stress world at 2560x1440, a live
   demo.lvl engine switched to ``performance_preset()``, to
   ``reference_parity()``, to 1280x720 and to a ``bin_capacity`` of 8
   that overflows, which must settle in more than one render), with the
   capacities grown, the
   renders the settle took and its time; (b) ten settled demo.lvl frames
   under ``torch.cuda.set_sync_debug_mode("error")``, as every engine run
   timed in the phases above had after its timed frames (the 19
   configurations of PERF.md section 5, demo.lvl with its overlay and
   forward-only included); (c) 30 steady frames
   of demo.lvl and of the textured world under SSR 0.5 with one
   synchronize at the end and with one after every frame;
11. the single-card entry and the offline tools
   (:func:`entry_tools_phase`): (a) ``entry("cuda")``'s frame function
   through the kernels and through the plain versions, timed; (b) the
   default-IBL generator at full size against the checked-in asset,
   timed; (c) the fidelity report on demo.lvl and on the textured world
   at 1920x1080 for the default and the two presets, timed.

Every engine frame is a settled one: ``Engine.render`` reads the monitors
of a frame under a config it has not verified and renders it again while
a capacity grew. The first frame of a fresh engine, or after a config
change, may so launch each kernel more than once.

A kernel's time is its share of a run of launches: N back-to-back calls
of its wrapper between one pair of CUDA events, divided by N, the median
of seven such runs. Before each run a spin kernel holds the stream for
longer than the host needs to queue the N calls, so the device goes from
one launch to the next without waiting for the host (a run the spin did
not outlast is repeated with a longer one); N grows until a run passes
2 ms, up to 200. The inputs of such a run stay warm in L2. The earlier
reading, one call between a pair of events (the median of 20), is printed
beside it as ``single``: for a kernel shorter than its wrapper's host time
it reads the host. The plain versions keep that single-call reading.

Each kernel's line on the ``kernels`` JSON record carries its bound: the
larger of the bytes it must move (each input read once, each output written
once; K7's texel rows as many as its taps touch) over 3.35 TB/s and its
float32 operations over 67 TFLOP/s, the H100 SXM's published peaks. The
operations are counted from each kernel's formulas on this run's inputs:
for the rasters 16 a (row, pixel centre) pair that the exhaustive test
covers (``raster.covered_pairs``), which no cull can avoid; K3's are an
estimate that stays well below its bytes term. No kernel's time may be
under its bound (asserted). No single PyTorch call computes any of these
functions, so ``library_ms`` is null throughout.

With ``--profile``, every engine run timed above (and demo.lvl with its
overlay and forward-only, settled and timed the same way) is followed by
``torch.profiler`` over 5 more frames: device time and device-side
launches a frame (kernel, copy and fill events), the idle share of the
steady frame, each hand-written kernel's time and the costliest device
entries. They are printed and written one JSON object a run to
``chiprun_out/chip_smoke_profile.jsonl``.

Usage: ``python3 chip_smoke.py [--profile]`` from the repository root (one
CUDA device; exits non-zero without a result line when there is none). The
last line of standard output is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import zlib

ROOT = os.path.dirname(os.path.abspath(__file__))
LEVEL = os.path.join(ROOT, "levels", "demo.lvl")
REPS = 20
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, published
F32_FLOPS = 67e12
# the kernels of tinyrenderer_tpu_torch/csrc, by their __global__ names (K4
# is its list-building kernel and its raster; K7 its word and byte kernels)
GLOBALS = {"K1": ("raster_kernel",), "K2": ("select_eval_kernel",),
           "K3": ("shade_kernel",),
           "K4": ("raster_stream_kernel", "stream_parts_kernel"),
           "K5": ("select_eval_stream_kernel",),
           "K6": ("raster_resolve_kernel",),
           "K7": ("windowed_blend_kernel", "windowed_blend_bytes_kernel")}


def _bound(nbytes: float, flops: float) -> tuple[float, str]:
    """(least ms, what bounds it) for work that moves ``nbytes`` and does
    ``flops`` float32 operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _median_ms(fn, reps: int = REPS) -> float:
    """Median over ``reps`` calls, each between its own pair of CUDA
    events, after one warm-up: a single call's time, the host's share
    included."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _run_ms(fn, n: int, hold_ms: float) -> tuple[float, float, bool]:
    """One run of ``n`` back-to-back calls behind a spin kernel of about
    ``hold_ms``: (device ms a call, host ms a call to queue it, whether
    the spin outlasted the queueing)."""
    import torch
    props = torch.cuda.get_device_properties(0)
    hz = getattr(props, "clock_rate", 1_980_000) * 1e3
    gate = torch.cuda.Event()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(hold_ms * 1e-3 * hz))
    gate.record()
    a.record()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / n
    b.record()
    held = not gate.query()
    b.synchronize()
    return a.elapsed_time(b) / n, host_ms, held


def _launch_run_ms(fn, runs: int = 7, span_ms: float = 2.0,
                   n_max: int = 200) -> tuple[float, int]:
    """(Device ms a launch, N): ``fn`` timed as N back-to-back calls between
    one pair of events, the median of ``runs`` runs; N grown until a run
    passes ``span_ms`` (at most ``n_max``). Each run starts behind a spin
    kernel that outlasts the host's queueing of the N calls, so the device
    alone sets the span."""
    def held_run(n, host_ms):
        for _ in range(5):
            ms, host_ms, held = _run_ms(fn, n, 0.5 + 2.0 * n * host_ms)
            if held:
                return ms, host_ms
            host_ms *= 2.0
        raise RuntimeError("the host could not queue a run of launches "
                           "behind the spin kernel")

    fn()
    ms, host_ms = held_run(1, 0.2)
    n = 1
    while ms * n < span_ms and n < n_max:
        n = min(n_max, max(n + 1, int(span_ms / ms) + 1))
        ms, host_ms = held_run(n, host_ms)
    times = [held_run(n, host_ms)[0] for _ in range(runs)]
    return statistics.median(times), n


def _device_profile(engine, steady_ms: float, n: int = 5) -> dict:
    """``torch.profiler`` over ``n`` engine frames: device ms, device-side
    launches, the idle share of ``steady_ms`` and each kernel's ms, a
    frame, and the ten costliest device entries."""
    import torch
    from torch.autograd import DeviceType
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            engine.run_frame(0.0)
        torch.cuda.synchronize()
    device_us, launches, kernel_us = 0.0, 0, dict.fromkeys(GLOBALS, 0.0)
    entries = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.self_device_time_total
        device_us += us
        launches += e.count
        entries.append((us, e.count, e.key))
        for k, names in GLOBALS.items():
            if any(re.search(rf"\b{name}(\b[<(]|$)", e.key) for name in names):
                kernel_us[k] += us
    if device_us <= 0:
        raise RuntimeError("the profiler saw no device time")
    device_ms = device_us / 1e3 / n
    return {"steady_ms": steady_ms, "device_ms": device_ms,
            "idle": 1.0 - device_ms / steady_ms, "launches": launches / n,
            "kernel_ms": {k: v / 1e3 / n for k, v in kernel_us.items() if v},
            "top": [(us / 1e3 / n, c // n, key[:80])
                    for us, c, key in sorted(entries, reverse=True)[:10]]}


@contextlib.contextmanager
def _patched(module, name: str, fn):
    old = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, old)


def _decode_png(data: bytes):
    """An 8-bit RGB / RGBA PNG as an (H, W, C) uint8 array, with ``zlib``
    (the card's machine has no PIL): scanline filters 0 (None, the
    ``zlib`` encoder's) and 1 (Sub, the native encoder's)."""
    import numpy as np
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    pos, idat, head = 8, [], None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
    w, h, depth, ctype, _, _, interlace = head
    assert depth == 8 and ctype in (2, 6) and interlace == 0, head
    c = 4 if ctype == 6 else 3
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + w * c)
    out = np.empty((h, w * c), np.uint8)
    for y in range(h):
        f, row = raw[y, 0], raw[y, 1:]
        if f == 0:
            cur = row
        elif f == 1:
            cur = (np.cumsum(row.reshape(w, c), axis=0, dtype=np.int64)
                   % 256).astype(np.uint8).reshape(-1)
        else:
            raise ValueError(f"PNG filter {f} is not decoded here")
        out[y] = cur
    return out.reshape(h, w, c)


def _pixel_of(pick, oid: int) -> tuple[float, float]:
    """The middle pixel of object ``oid`` in a host pick map."""
    import numpy as np
    ys, xs = np.nonzero(pick == oid)
    assert len(ys), f"object {oid} not visible"
    return float(xs[len(xs) // 2]), float(ys[len(ys) // 2])


def _most_covered(pick) -> int:
    """The object with the most pixels in a host pick map (the ground slab,
    id 1, aside, as the reference's editor tests do)."""
    import numpy as np
    ids, counts = np.unique(pick[pick > 1], return_counts=True)
    assert len(ids), "no object visible"
    return int(ids[np.argmax(counts)])


def editor_phase(dev, smi: str, cfg, viewer_cfg, edits: int, cli_args: list,
                 kernel_vs_plain, reset_counts, add_counts) -> None:
    """Phase 8: the editor round trip and its host surfaces, on
    ``levels/demo.lvl`` under ``cfg`` (the viewer under ``viewer_cfg``).
    Each path's launches are counted from 0 (``reset_counts``) and added
    to the kernels line (``add_counts``); every time is printed with the
    card's name and power limit."""
    import urllib.request

    import numpy as np
    import torch
    from tinyrenderer_tpu_torch import kernels
    from tinyrenderer_tpu_torch.editor import events as ev
    from tinyrenderer_tpu_torch.editor.gizmo import HOVERED_COLOR
    from tinyrenderer_tpu_torch.editor.session import EditorApp
    from tinyrenderer_tpu_torch.ops import raster
    from tinyrenderer_tpu_torch.render import frame as framelib
    from tinyrenderer_tpu_torch.render import reload as reloadlib
    from tinyrenderer_tpu_torch.render.engine import Engine
    from tinyrenderer_tpu_torch.scene import demo
    from tinyrenderer_tpu_torch.utils import image_io
    from tinyrenderer_tpu_torch.viewer.server import ViewerServer

    left = ev.MouseButton.Left

    def event_ms(fn):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        return out, a.elapsed_time(b)

    def spread(ms):
        return (f"median {statistics.median(ms):.3f} ms, p90 "
                f"{float(np.percentile(ms, 90)):.3f} ms over {len(ms)}")

    def settle_app(app, label):
        for _ in range(8):
            cfg_before, atlas_frame = app.engine.cfg, app.engine._atlas is None
            out = app.run_frame(0.0)
            torch.cuda.synchronize()
            if app.engine.cfg == cfg_before and not atlas_frame:
                return out
        raise AssertionError(f"{label}: capacities did not settle")

    def click(app, x, y):
        app.handle_event(ev.MouseInput(left, True, x, y))
        app.handle_event(ev.MouseInput(left, False, x, y))

    def editor(c):
        return EditorApp(Engine(c, device=dev, level_path=LEVEL))

    # (a) pick, gizmo, hover, drag, Escape, Delete
    app = editor(cfg)
    eng = app.engine
    reset_counts()
    settle_app(app, "8a demo.lvl")
    oid = _most_covered(app.picker.latest)
    click(app, *_pixel_of(app.picker.latest, oid))
    gizmo = app.controller.gizmo_handler.gizmo
    assert app.selected_object_id == oid and len(gizmo.part_axis) == 3
    k1 = raster.K1_LAUNCHES
    shown, select_ms = event_ms(lambda: app.run_frame(0.0))
    views = eng.cfg.num_shadow_views
    assert eng.cfg.has_forward
    # the main view, the overlay, and the atlas of the repack (the arrows
    # are new world objects)
    assert raster.K1_LAUNCHES - k1 == 2 + views, raster.K1_LAUNCHES - k1
    pick = app.picker.latest
    arrows = [p for p in sorted(gizmo.part_axis) if (pick == p).any()]
    assert arrows, "no gizmo arrow in the pick map"
    ax, ay = _pixel_of(pick, arrows[0])
    app.handle_event(ev.CursorMoved(ax, ay))
    assert gizmo.hovered_part_id == arrows[0]
    albedo = eng.world.get_world_object(arrows[0]).get_renderable() \
        .model_descriptor.material_descriptor.flat.albedo
    assert np.array_equal(albedo, HOVERED_COLOR)
    hovered, hover_ms = event_ms(lambda: app.run_frame(0.0))
    mask = torch.as_tensor(pick == arrows[0], device=dev)
    assert (hovered.sdr[mask] != shown.sdr[mask]).any(), "the arrow kept its colour"
    axis = gizmo.part_axis[arrows[0]]
    start = eng.world.get_world_object(oid).transform.position.copy()
    app.handle_event(ev.MouseInput(left, True, ax, ay))
    for k in range(1, 5):
        app.handle_event(ev.CursorMoved(ax + 10 * k, ay + 4 * k))
    app.handle_event(ev.MouseInput(left, False, ax + 40, ay + 16))
    delta = eng.world.get_world_object(oid).transform.position - start
    assert abs(delta[axis]) > 1e-3 and all(
        abs(delta[k]) < 1e-4 for k in range(3) if k != axis), (axis, delta)
    _, drag_ms = event_ms(lambda: app.run_frame(0.0))
    # the gizmo frame's inputs, for the kernels-vs-plain frame below
    c = eng.cfg
    shown_args = (eng._pack.scene, eng._packer.pool_for(c, dev),
                  eng._pack.lights, torch.as_tensor(eng.camera.to_raw(),
                                                    device=dev),
                  eng.params, eng._ensure_env(), c)
    n = len(eng.world)
    app.handle_event(ev.KeyInput("Escape", True))
    assert app.selected_object_id is None and len(eng.world) == n - 3
    app.run_frame(0.0)
    assert not np.isin(app.picker.latest, list(gizmo.part_axis) + arrows).any()
    click(app, *_pixel_of(app.picker.latest, oid))
    app.handle_event(ev.KeyInput("Delete", True))
    assert eng.world.get_world_object(oid) is None
    out = app.run_frame(0.0)
    assert not (app.picker.latest == oid).any() and torch.isfinite(out.hdr).all()
    run = add_counts()
    fast = kernel_vs_plain("8a demo.lvl with the gizmo",
                           lambda: framelib.render_frame(*shown_args))
    assert all((fast.pick_id == p).any() for p in arrows)
    print(f"8a editor {c.width}x{c.height} on demo.lvl: selected {oid}, arrows "
          f"{sorted(gizmo.part_axis) or arrows} (axis {axis}, moved "
          f"{delta[axis]:+.4f}); select frame {select_ms:.3f} ms, hover "
          f"(repack) {hover_ms:.3f} ms, drag {drag_ms:.3f} ms; launches {run} "
          f"({smi})", flush=True)

    # (b) bench.py's editor round trip, then the level saved and reloaded
    app = editor(cfg)
    eng = app.engine
    settle_app(app, "8b demo.lvl")
    reset_counts()
    added, edit_ms = [], []
    for i in range(edits):
        if i % 2 == 0 or not added:
            w = demo.build_demo_world(n_cubes=1)
            added.append(eng.world.add_world_object(
                next(o for _oid, o in w.world_objects())))
        else:
            eng.world.remove_world_object(added.pop())
        edit_ms.append(event_ms(lambda: app.run_frame(0.016))[1])
    cx, cy = cfg.width // 2, cfg.height // 2
    frame = lambda: event_ms(lambda: app.run_frame(0.016))[1]  # noqa: E731
    app.handle_event(ev.CursorMoved(x=cx, y=cy))
    pick_ms = [frame() for _ in range(5)]
    app.handle_event(ev.MouseInput(left, True, cx, cy))
    for _ in range(4):
        app.handle_event(ev.CursorMoved(x=cx + 10, y=cy))
        pick_ms.append(frame())
    app.handle_event(ev.MouseInput(left, False, cx + 10, cy))
    pick_ms.append(frame())
    selected = app.selected_object_id
    app.handle_event(ev.KeyInput("Escape", True))   # arrows are not saved
    saving = settle_app(app, "8b after the edits")
    steady_ms = [frame() for _ in range(10)]
    run = add_counts()
    print(f"8b round trip {cfg.width}x{cfg.height}: edit frame "
          f"{spread(edit_ms)}; pick + gizmo frame {spread(pick_ms)} (selected "
          f"{selected}); steady frame {spread(steady_ms)}; launches {run} "
          f"({smi})", flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lvl_") as tmp:
        path = os.path.join(tmp, "roundtrip.lvl")
        eng.save_level(path)
        fresh = Engine(cfg, device=dev, level_path=path)
        for _ in range(8):
            cfg_before, atlas_frame = fresh.cfg, fresh._atlas is None
            loaded = fresh.run_frame(0.0)
            if fresh.cfg == cfg_before and not atlas_frame:
                break
        assert torch.equal(loaded.pick_id, saving.pick_id), "8b: pick ids differ"
        assert torch.equal(loaded.sdr, saving.sdr), "8b: the frame differs"
    print(f"8b level saved after the round trip ({os.path.basename(path)}) "
          f"and loaded by a fresh engine: pick ids and SDR equal", flush=True)
    del fresh

    # (c) the kernel reload: unchanged, edited and broken sources
    base = app.run_frame(0.0)
    nvcc = kernels._nvcc

    def no_nvcc():
        raise AssertionError("nvcc ran for unchanged sources")
    kernels._nvcc = no_nvcc
    try:
        res = eng.recompile_kernels()
    finally:
        kernels._nvcc = nvcc
    assert res.ok and not res.changed, res
    assert eng.notifier.history()[-1].message == "Kernels up to date"
    lib0, path0 = kernels._lib, kernels._lib_path
    csrc0, build0 = kernels.CSRC, kernels.BUILD_DIR

    def same_frame(label):
        out = app.run_frame(0.0)
        torch.cuda.synchronize()
        for f in ("pick_id", "sdr", "hdr"):
            assert torch.equal(getattr(out, f), getattr(base, f)), (label, f)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_reload_") as tmp:
        try:
            edited = os.path.join(tmp, "csrc_edited")
            shutil.copytree(csrc0, edited)
            with open(os.path.join(edited, "shade.cu"), "a") as f:
                f.write("\n// appended by chip_smoke.py phase 8c\n")
            kernels.CSRC = type(csrc0)(edited)
            kernels.BUILD_DIR = type(build0)(tmp) / "build"
            t0 = time.perf_counter()
            res = eng.recompile_kernels()
            rebuild_s = time.perf_counter() - t0
            assert res.ok and res.reloaded == [reloadlib.LIBRARY], res
            assert kernels._lib is not lib0 and kernels._lib_path != path0
            assert eng.notifier.history()[-1].message == "Reloaded kernels: csrc"
            same_frame("rebuilt library")
            lib1, path1 = kernels._lib, kernels._lib_path
            broken = os.path.join(tmp, "csrc_broken")
            shutil.copytree(edited, broken)
            with open(os.path.join(broken, "raster.cu"), "a") as f:
                f.write("\nthis is not C++\n")
            kernels.CSRC = type(csrc0)(broken)
            t0 = time.perf_counter()
            res = eng.recompile_kernels()
            failed_s = time.perf_counter() - t0
            assert not res.ok and "nvcc failed" in res.error, res
            toast = eng.notifier.history()[-1]
            assert toast.level == "error" and "csrc" in toast.message
            assert kernels._lib is lib1 and kernels._lib_path == path1
            same_frame("the old library after a failed build")
        finally:
            kernels.CSRC, kernels.BUILD_DIR = csrc0, build0
            res = eng.recompile_kernels()      # back to the checkout's build
    assert res.ok and kernels._lib_path == path0, res
    same_frame("the checkout's library again")
    print(f"8c kernel reload: unchanged sources, no nvcc; an edited csrc/ "
          f"rebuilt and swapped in {rebuild_s:.1f} s ({path1.name}), next "
          f"frame bit-equal; a broken csrc/ failed in {failed_s:.1f} s with an "
          f"error toast and the old library kept rendering bit-equal ({smi})",
          flush=True)
    del app, eng, base

    # (d) the web viewer over HTTP
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    vapp = editor(viewer_cfg)
    srv = ViewerServer(vapp, port=0)
    srv.start_background()
    url = f"http://127.0.0.1:{srv.port}"

    def get(path):
        with opener.open(url + path, timeout=120) as r:
            return r.read()

    def post(path, obj):
        req = urllib.request.Request(url + path, data=json.dumps(obj).encode(),
                                     method="POST")
        with opener.open(req, timeout=120) as r:
            return json.loads(r.read())

    try:
        reset_counts()
        png = get("/frame.png")
        img = _decode_png(png)
        assert np.array_equal(img, vapp.engine.present_numpy())
        assert img.shape == (viewer_cfg.height, viewer_cfg.width, 3)
        with srv.lock:
            vpick = vapp.picker.latest
        voi = _most_covered(vpick)
        x, y = _pixel_of(vpick, voi)
        post("/event", [{"type": "button", "button": "left", "pressed": p,
                         "x": x, "y": y} for p in (True, False)])
        assert json.loads(get("/state"))["selected"] == voi
        before = _decode_png(get("/frame.png")).astype(np.float64).mean()
        post("/set", {"name": "global_params", "path": ["exposure"],
                      "value": 4.0})
        after = _decode_png(get("/frame.png")).astype(np.float64).mean()
        assert after > before + 5, (before, after)
        post("/action", {"action": "set_config", "preset": "performance"})
        assert vapp.engine.cfg.texture_filter == "stochastic"
        assert _decode_png(get("/frame.png")).shape == img.shape

        def round_trips():
            ms = []
            for _ in range(10):
                t0 = time.perf_counter()
                get("/frame.png")
                ms.append((time.perf_counter() - t0) * 1e3)
            return ms
        # with the gizmo shown every frame is an edit frame (it rescales its
        # arrows, which repacks and re-renders the atlas); then without
        gizmo_ms = round_trips()
        post("/event", {"type": "key", "key": "Escape", "pressed": True})
        assert json.loads(get("/state"))["selected"] is None
        get("/frame.png")
        get_ms = round_trips()
        sdr = vapp.engine.present_numpy()
        enc_ms = []
        for _ in range(10):
            t0 = time.perf_counter()
            image_io.encode_png(sdr)
            enc_ms.append((time.perf_counter() - t0) * 1e3)
        run = add_counts()
    finally:
        srv.shutdown()
    print(f"8d viewer {viewer_cfg.width}x{viewer_cfg.height}: /frame.png equals "
          f"present_numpy, click selected {voi}, exposure 4 mean "
          f"{before:.1f} -> {after:.1f}, performance preset renders; PNG encode "
          f"{spread(enc_ms)} ({len(png)} bytes), /frame.png round trip "
          f"{spread(get_ms)}, with the gizmo shown {spread(gizmo_ms)}; "
          f"launches {run} ({smi})", flush=True)

    # (e) the headless CLI, in a process of its own
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        out_png = os.path.join(tmp, "cli.png")
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "tinyrenderer_tpu_torch",
                              *cli_args, "--out", out_png, "--stats"],
                             cwd=ROOT, capture_output=True, text=True,
                             timeout=600)
        cli_s = time.perf_counter() - t0
        assert res.returncode == 0, res.stderr[-4000:]
        assert os.path.exists(out_png), "the CLI wrote no PNG"
        stats = [ln for ln in res.stdout.splitlines()
                 if ln.startswith("visible objects:")]
        assert stats, res.stdout
        with open(out_png, "rb") as f:
            shape = _decode_png(f.read()).shape
    print(f"8e CLI {' '.join(cli_args)}: rc 0, {shape[1]}x{shape[0]} PNG, "
          f"{stats[0]}; {cli_s:.1f} s with the process start ({smi})",
          flush=True)


def _sdr_bars(label: str, a, b, band_h: int) -> tuple:
    """tests/test_sharded.py's bar for a sharded frame at a realistic size
    (``test_sharded_512``, :224-230), ``a`` against the single-card frame
    ``b`` (H, W, 3) u8 on the host: more than 1 LSB on under 1% of the
    pixels, more than 16 LSB on under 0.1%. Band-local plane arithmetic
    rounds otherwise than the whole frame's and flips hard shadow gates and
    mip levels on isolated pixels anywhere in a band. Returns (share over 1
    LSB, share over 16, share of the rows off the band seams within 1)."""
    import numpy as np
    d = np.abs(a.astype(np.int16) - b.astype(np.int16)).max(axis=-1)
    over, over16 = float((d > 1).mean()), float((d > 16).mean())
    assert over < 1e-2, f"{label}: {(d > 1).sum()} pixels differ by > 1 LSB"
    assert over16 < 1e-3, f"{label}: {(d > 16).sum()} pixels differ by > 16"
    interior = np.ones(d.shape[0], bool)
    for k in range(d.shape[0] // band_h + 1):
        interior[max(0, k * band_h - 1):k * band_h + 1] = False
    return over, over16, float((d[interior] <= 1).mean())


def sharded_phase(dev, smi: str, engines: dict, launches: dict,
                  verify) -> None:
    """Phase 9: the multi-device frame over ranks of ``torch.distributed``
    sharing the card (``tinyrenderer_tpu_torch.parallel``). One launch of
    four gloo ranks renders (a) demo.lvl at 1920x1080 with its overlay in
    four bands, and again through the plain versions; (b) a batch of two
    cameras over dp=2, sp=2; (c) the high-poly world with SSR at strength
    1 (the stream raster); (d) the textured world fused and under
    ``fused_resolve``; then (e) one nccl rank renders demo.lvl in one band.
    Each frame is held against the single-card frame of its
    ``sharded_config`` on the card (tests/test_sharded.py's bars; (e)
    bit-equal); each rank counts its launches from 0 before its first
    frame, and times its steady frame and its collectives with CUDA
    events. ``engines``: label -> (settled engine, world spec)."""
    import numpy as np
    import torch
    from tinyrenderer_tpu_torch.parallel import jobs, sharded
    from tinyrenderer_tpu_torch.parallel.launch import launch
    from tinyrenderer_tpu_torch.render import frame as framelib

    t_phase = time.perf_counter()
    nan = float("nan")        # no times off the card (a CPU rehearsal)
    R = dataclasses.replace
    lvl, _ = engines["lvl"]
    cam2 = dataclasses.replace(lvl.camera, orientation=lvl.camera.orientation
                               + np.array([0.25, 0.0, -0.1], np.float32))
    cams2 = np.stack([lvl.camera.to_raw(), cam2.to_raw()])
    ssr = {framelib.PARAM_SSR_STRENGTH: 1.0}
    c_lvl = engines["lvl"][0].cfg
    c_hp, c_tex = engines["highpoly"][0].cfg, engines["textured"][0].cfg
    cases = {   # label: (world, cfg, dp, extras)
        "a sp=4": ("lvl", sharded.sharded_config(c_lvl, 4), 1,
                   dict(plain=True, repeats=5)),
        "b dp=2 sp=2": ("lvl", sharded.sharded_config(c_lvl, 2), 2,
                        dict(cams=cams2, repeats=5)),
        "c high-poly SSR": ("highpoly", sharded.sharded_config(
            R(c_hp, enable_ssr=True), 4), 1, dict(params=ssr, repeats=3)),
        "d textured": ("textured", sharded.sharded_config(c_tex, 4), 1,
                       dict(repeats=3)),
        "d fused_resolve": ("textured", sharded.sharded_config(
            R(c_tex, fused_resolve=True), 4), 1, dict(repeats=3))}

    def job(backend, labels):
        worlds = {}
        for k in labels:
            w, cfg, dp, extra = cases[k]
            worlds.setdefault(w, []).append(dict(
                name=k, cfg=dataclasses.asdict(cfg), dp=dp, **extra))
        return dict(device=dev.type, backend=backend, worlds=[dict(
            world=engines[w][1], cfg=dataclasses.asdict(engines[w][0].cfg),
            cases=cs) for w, cs in worlds.items()])

    def single(label, cam_raw):
        w, cfg, _, extra = cases[label]
        eng = engines[w][0]
        params = eng.params.clone()
        for i, v in extra.get("params", {}).items():
            params[i] = v
        return framelib.render_frame(
            eng._pack.scene, eng._packer.pool_for(cfg, dev), eng._pack.lights,
            torch.as_tensor(cam_raw, device=dev), params, eng._ensure_env(),
            cfg)

    t0 = time.perf_counter()
    gloo = launch(jobs.frame_job, 4, "gloo", dev.type, job("gloo", cases),
                  timeout_s=600)
    gloo_s = time.perf_counter() - t0
    sums = dict.fromkeys(launches, 0)
    for i, label in enumerate(cases):
        w, cfg, dp, extra = cases[label]
        rs = [r[i] for r in gloo]
        assert rs[0]["name"] == label
        assert len({r["digest"] for r in rs}) == 1, f"9 {label}: ranks differ"
        out = rs[0]["out"]
        run = {k: sum(r["launches"][k] for r in rs) for k in launches}
        for k, n in run.items():
            sums[k] += n
        B = out["sdr"].shape[0]
        assert out["sdr"].shape == (B, cfg.height, cfg.width, 3)
        assert np.isfinite(out["hdr"]).all()
        bars, moved = [], []
        for c in range(B):
            cam = extra.get("cams", [engines[w][0].camera.to_raw()])[c]
            ref = single(label, cam)
            # a band's plane constants fold in its first row and round
            # otherwise than the frame's: on the 108k-triangle world a few
            # edge pixels change hands (at most 1 in 10^4 allowed there)
            moved.append(int((out["pick_id"][c]
                              != ref.pick_id.cpu().numpy()).sum()))
            assert moved[-1] <= (out["pick_id"][c].size // 10**4
                                 if w == "highpoly" else 0), (label, moved)
            bars.append(_sdr_bars(f"9 {label}", out["sdr"][c],
                                  ref.sdr.cpu().numpy(), rs[0]["band_h"]))
        if B == 1:
            assert int(ref.sky_blocks) == int(out["sky_blocks"])
        ids = len(np.unique(out["pick_id"]))
        print(f"9{label}: {B}x{cfg.width}x{cfg.height} over {len(rs)} gloo "
              f"ranks, band {rs[0]['band_h']} rows, {ids} ids; pick ids "
              f"unlike the single-card frame's {moved}, (share > 1 LSB, > 16 LSB, "
              f"interior rows within 1) {bars}; launches "
              f"{run}; steady frame ms by rank "
              f"{[round(r.get('frame_ms', nan), 3) for r in rs]}, of which "
              f"collectives {[round(r.get('collective_ms', nan), 3) for r in rs]}"
              f", each in call order (rank 0) "
              f"{[round(x, 3) for x in rs[0].get('each_collective_ms', [])]} "
              f"({smi})", flush=True)
        if "plain" in rs[0]:
            plain = rs[0]["plain"]
            np.testing.assert_array_equal(out["pick_id"], plain["pick_id"])
            res = verify.edge_aware_compare(out["sdr"][0], plain["sdr"][0],
                                            pick=plain["pick_id"][0])
            assert res["status"] == "pass", (label, res)
            print(f"9{label}: kernel frame vs plain frame over the ranks: "
                  f"pick ids equal, edge-aware compare {res}", flush=True)
    expect = {"a sp=4": ("K1", "K2", "K3", "K7"),
              "c high-poly SSR": ("K4", "K5"), "d textured": ("K7",),
              "d fused_resolve": ("K6",)}
    for i, label in enumerate(cases):
        for k in expect.get(label, ()):
            assert sum(r[i]["launches"][k] for r in gloo) > 0, (label, k)

    # (e) nccl at world size 1: the single-card frame, bit for bit
    cases["e nccl, one rank"] = ("lvl", sharded.sharded_config(c_lvl, 1), 1,
                                 {})
    t0 = time.perf_counter()
    (e,), = launch(jobs.frame_job, 1, "nccl", dev.type,
                   job("nccl", ["e nccl, one rank"]), timeout_s=600)
    nccl_s = time.perf_counter() - t0
    ref = single("e nccl, one rank", lvl.camera.to_raw())
    for f in jobs.FIELDS:
        want = getattr(ref, f).cpu().numpy()
        got = e["out"][f][0] if f in ("sdr", "pick_id", "depth", "hdr") \
            else e["out"][f]
        assert np.array_equal(got, want), f"9e: {f} differs"
    for k, n in e["launches"].items():
        sums[k] += n
    for k, n in sums.items():
        launches[k] += n
    assert all(sums[k] > 0 for k in launches), sums
    print(f"9e nccl, one rank: demo.lvl 1920x1080 in one band equals the "
          f"single-card frame bit for bit (sdr, pick ids, depth, hdr, every "
          f"monitor); launches {e['launches']}", flush=True)
    print(f"9 launches summed over the ranks: {sums}", flush=True)
    print(f"9 phase: {time.perf_counter() - t_phase:.1f} s (gloo launch "
          f"{gloo_s:.1f} s, nccl launch {nccl_s:.1f} s) ({smi})", flush=True)


def frame_loop_phase(dev, smi: str, lvl_engine, textured_cfg, reset_counts,
                     add_counts, sync_free) -> None:
    """Phase 10: the engine's monitor protocol. (a) The first frame is the
    settled frame: fresh engines whose defaults overflow (the high-poly
    world under the default config, bench.py's 500-object stress world at
    2560x1440, and a live demo.lvl engine switched as the viewer switches
    it: ``performance_preset()``, ``reference_parity()``, 1280x720, then
    a ``bin_capacity`` of 8 that overflows and must grow before the frame
    is handed out) hand out a first frame bit-equal, in pick ids and SDR,
    to the 10th frame under the same camera. (b) Ten settled frames of demo.lvl with
    its overlay (``lvl_engine``) run under
    ``torch.cuda.set_sync_debug_mode("error")``; ``drain_monitors()`` then
    leaves no fetch queued and the config as it was (``sync_free``, which
    every engine run that the phases above timed went through as well:
    the 19 configurations of PERF.md section 5). (c) 30 steady frames
    of demo.lvl and of the textured world under SSR 0.5, timed with one
    synchronize at the end and with one after every frame (the loop that
    read its monitors synchronously), in turns. Every run's launches are
    counted from 0 and added to the kernels line."""
    import torch
    from tinyrenderer_tpu_torch.config import RenderConfig
    from tinyrenderer_tpu_torch.render import frame as framelib
    from tinyrenderer_tpu_torch.render.engine import Engine
    from tinyrenderer_tpu_torch.scene import demo

    t_phase = time.perf_counter()

    def first_frame(label, eng, switch=None):
        """``switch`` (the viewer's config change) on a live engine, or a
        fresh engine; its first frame against its 10th."""
        if switch is not None:
            switch(eng)
            eng._needs_pack = True      # as viewer/server.py applies a change
            eng._atlas = None
        cfg0 = eng.cfg
        torch.cuda.synchronize()
        reset_counts()
        f0, t0 = eng.frame_index, time.perf_counter()
        first = eng.run_frame(0.0)
        torch.cuda.synchronize()
        settle_ms = (time.perf_counter() - t0) * 1e3
        renders, cfg1 = eng.frame_index - f0, eng.cfg
        for _ in range(9):
            tenth = eng.run_frame(0.0)
        torch.cuda.synchronize()
        run = add_counts()
        moved = {f.name: (getattr(cfg0, f.name), getattr(cfg1, f.name))
                 for f in dataclasses.fields(cfg0)
                 if getattr(cfg0, f.name) != getattr(cfg1, f.name)}
        monitored = {field for field, _ in Engine._MONITORS.values()}
        grown = {k: v for k, v in moved.items() if k in monitored}
        packed = {k: v for k, v in moved.items() if k not in monitored}
        print(f"10a {label} {cfg1.width}x{cfg1.height}: the first frame took "
              f"{renders} renders, {settle_ms:.3f} ms to the synchronize "
              f"(card {smi}); capacities grown by the monitors {grown}; set "
              f"by the pack {packed}; launches {run}", flush=True)
        assert eng._settled and eng.cfg == cfg1, \
            f"{label}: the capacities moved after the first frame"
        assert torch.equal(first.pick_id, tenth.pick_id), \
            f"{label}: the first frame's pick ids are not the 10th frame's"
        assert torch.equal(first.sdr, tenth.sdr), \
            f"{label}: the first frame's SDR is not the 10th frame's"
        pick = first.pick_id
        assert first.sdr.shape == (cfg1.height, cfg1.width, 3)
        assert torch.isfinite(first.hdr).all() and len(torch.unique(pick)) > 2
        return grown, renders

    # (a) fresh engines whose default capacities overflow
    hp, _ = first_frame("high-poly world, default RenderConfig", Engine.from_world(
        demo.build_highpoly_world(9), camera=demo.build_demo_camera(1920, 1080),
        cfg=RenderConfig(), device=dev))
    assert "stream_capacity" in hp and "bin_capacity" in hp, hp
    stress_cfg = RenderConfig(width=2560, height=1440, shadow_size=2048,
                              max_instances=1024, max_vertices=16384,
                              max_triangles=8192, max_materials=1024,
                              bin_capacity=512, gate_block_h=8, gate_block_w=8)
    stress = Engine.from_world(demo.build_stress_world(500),
                               camera=demo.build_demo_camera(2560, 1440),
                               cfg=stress_cfg, device=dev)
    stress.set_param(framelib.PARAM_SHADOW_BIAS, 2e-3)   # bench.py's config 5
    first_frame("stress world, 500 objects", stress)
    del stress
    live = Engine(cfg=RenderConfig(), device=dev, level_path=LEVEL)
    live.run_frame(0.0)
    for label, switch in (
            ("demo.lvl, performance_preset()",
             lambda e: setattr(e, "cfg", e.cfg.performance_preset())),
            ("demo.lvl, reference_parity()",
             lambda e: setattr(e, "cfg", e.cfg.reference_parity())),
            ("demo.lvl, reference_parity() at 1280x720",
             lambda e: e.resize(1280, 720))):
        first_frame(label, live, switch)
    # a switch whose config overflows: the settle re-armed on a settled
    # engine grows the capacity before the frame is handed out
    grown, renders = first_frame(
        "demo.lvl, bin_capacity 8", live,
        lambda e: setattr(e, "cfg", dataclasses.replace(e.cfg, bin_capacity=8)))
    assert renders > 1 and grown["bin_capacity"][1] > 8, (renders, grown)
    del live

    # (b) steady frames that never wait for their monitors: demo.lvl with
    # its overlay here; every configuration timed by the phases above went
    # through the same check after its timed frames (``sync_free``)
    eng = lvl_engine
    assert eng.cfg.has_forward
    eng.run_frame(0.0)
    torch.cuda.synchronize()
    queued = sync_free(eng, "demo.lvl with its overlay (10b)")
    print(f"10b demo.lvl with its overlay: 10 settled frames under "
          f"set_sync_debug_mode('error'), {queued} fetches still queued "
          f"after them, drain_monitors() left none and the config as it "
          f"was", flush=True)
    runs = sync_free.runs
    print(f"10b {len(runs)} runs of 10 settled frames under "
          f"set_sync_debug_mode('error') passed: {runs}", flush=True)
    assert len(set(runs)) >= 20, runs

    # (c) the pipelined loop against a synchronize after every frame
    def loop_ms(engine, sync_each, n=30):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            engine.run_frame(0.0)
            if sync_each:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    ssr = Engine.from_world(
        demo.build_demo_world(n_cubes=24, textured_every=2),
        camera=demo.build_demo_camera(1920, 1080),
        cfg=dataclasses.replace(textured_cfg, enable_ssr=True), device=dev)
    ssr.set_param(framelib.PARAM_SSR_STRENGTH, 0.5)
    times = {}
    for label, engine in (("demo.lvl with its overlay", eng),
                          ("textured world, SSR 0.5", ssr)):
        engine.run_frame(0.0)
        assert engine._settled
        reset_counts()
        turns = [loop_ms(engine, s) for s in (False, True, True, False)]
        run = add_counts()
        one, each = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        times[label] = {"one_sync_ms": one, "sync_each_ms": each,
                        "turns_ms": turns}
        print(f"10c {label} 1920x1080, 30 steady frames (card {smi}): one "
              f"synchronize at the end {one:.3f} ms a frame, a synchronize "
              f"after every frame {each:.3f} ms a frame (turns "
              f"{[round(t, 3) for t in turns]}: end, each, each, end); "
              f"launches {run}", flush=True)
    print("10c frame loop ms: " + json.dumps({"card": smi, **times}))
    print(f"10 phase: {time.perf_counter() - t_phase:.1f} s", flush=True)


def entry_tools_phase(dev, smi: str, reset_counts, add_counts,
                      kernel_vs_plain) -> None:
    """Phase 11: the single-card entry and the two offline tools. (a)
    ``entry("cuda")``'s ``fn(*args)`` (256x128, the demo world under the
    default camera, the shadow atlas inline) through the kernels and
    through the plain versions, and its ms (CUDA events, median of 9);
    (b) the default-IBL generator at its full size (cube 256, irradiance
    64) into a temporary file, within one float16 step of the checked-in
    asset, and its ms; (c) the fidelity report on demo.lvl and on the
    textured world at 1920x1080 (``--only default,performance_preset,
    fidelity_preset --time 3 --frames 8``), its rows printed. Each run's
    launches are counted from 0 and added to the kernels line."""
    import numpy as np
    import torch
    from tinyrenderer_tpu_torch import entry as entrylib
    from tinyrenderer_tpu_torch.assets import hdr as hdrlib
    from tinyrenderer_tpu_torch.ops import env as envops
    from tinyrenderer_tpu_torch.tools import fidelity_report, gen_default_ibl

    t_phase = time.perf_counter()
    # (a) the entry's frame function
    fn, args = entrylib.entry("cuda")
    torch.cuda.synchronize()
    reset_counts()
    out = fn(*args)
    torch.cuda.synchronize()
    run = add_counts()
    assert run.get("K1", 0) > 1 and run.get("K2") == 1 and run.get("K3") == 1, run
    assert out.sdr.shape == (128, 256, 3) and torch.isfinite(out.hdr).all()
    assert len(torch.unique(out.pick_id)) > 2 and (out.pick_id == 0).any()
    kernel_vs_plain("11a entry() frame 256x128", lambda: fn(*args))
    reset_counts()
    entry_ms = _median_ms(lambda: fn(*args), 9)
    add_counts()
    print(f"11a entry() frame 256x128 (card {smi}): {entry_ms:.3f} ms "
          f"(CUDA events, median of 9); launches of one frame {run}",
          flush=True)

    # (b) the full-size bake against the checked-in asset
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ibl_") as tmp:
        path = os.path.join(tmp, "ibl.npz")
        t0 = time.perf_counter()
        assert gen_default_ibl.main(["--out", path]) == 0
        tool_ms = (time.perf_counter() - t0) * 1e3
        with np.load(path) as f:
            irr = f["irradiance"]
    with np.load(gen_default_ibl.DEFAULT_OUT) as f:
        asset = f["irradiance"]
    assert irr.dtype == asset.dtype == np.float16 and irr.shape == asset.shape
    step = np.spacing(np.abs(asset)).astype(np.float32)
    d = np.abs(irr.astype(np.float32) - asset.astype(np.float32))
    # the float32 bakes may differ in their last bits, which moves a value
    # across a float16 rounding boundary: one float16 step at most
    assert (d <= step).all(), float((d / step).max())
    cube = envops.equirect_to_cubemap(
        torch.as_tensor(hdrlib.procedural_sky(), device=dev),
        256, gamma_decode=False)
    bake_ms = _median_ms(lambda: envops.bake_irradiance(cube, 64), 5)
    print(f"11b default IBL (card {smi}): the generator {tool_ms:.1f} ms "
          f"(host clock: sky, cube, bake, copy back, npz); the 64-texel bake "
          f"of the 256-texel cube {bake_ms:.3f} ms (median of 5); "
          f"{int((d > 0).sum())} of {d.size} values one float16 step off the "
          f"checked-in asset, the rest equal", flush=True)

    # (c) the fidelity report at 1920x1080
    for world in ("level", "textured"):
        reset_counts()
        rows = fidelity_report.main(
            ["--world", world, "--level", LEVEL, "--only",
             "default,performance_preset,fidelity_preset", "--time", "3",
             "--frames", "8"])
        run = add_counts()
        assert [r["config"] for r in rows] == [
            "reference_parity", "default", "fidelity_preset",
            "performance_preset"], rows
        for r in rows:
            assert r["sdr"].shape == (1080, 1920, 3) and r["ms_per_frame"] > 0
        assert rows[0]["psnr_db"] == float("inf")
        compact = [{k: ("exact" if v == float("inf") else v)
                    for k, v in r.items() if k != "sdr"} for r in rows]
        print(f"11c fidelity report, {world}, 1920x1080 (card {smi}): "
              + json.dumps(compact) + f"; launches {run}", flush=True)
    print(f"11 phase: {time.perf_counter() - t_phase:.1f} s", flush=True)


def main(argv: list[str]) -> int:
    import numpy as np
    import torch
    unknown = [a for a in argv if a != "--profile"]
    if unknown:
        print(f"chip_smoke: unknown arguments {unknown}", file=sys.stderr)
        return 2
    profile = "--profile" in argv
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from tinyrenderer_tpu_torch import kernels
    from tinyrenderer_tpu_torch.assets import hdr as hdrlib
    from tinyrenderer_tpu_torch.ops import (compact, raster, resolve,
                                            sampling, shading)
    from tinyrenderer_tpu_torch.render import frame as framelib
    from tinyrenderer_tpu_torch.render.engine import Engine, RenderingAction
    from tinyrenderer_tpu_torch.config import RenderConfig
    from tinyrenderer_tpu_torch.scene import demo
    from tinyrenderer_tpu_torch.parallel import jobs as pjobs
    from tinyrenderer_tpu_torch.utils import verify

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {smi}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    kernels.library()
    print(f"kernel build + load: {kernels.build_seconds:.1f} s "
          f"({kernels.library_path().relative_to(ROOT)})", flush=True)

    # ---- phase 1: each kernel against its plain version ----------------
    eng3 = Engine(cfg=RenderConfig(), device=dev, level_path=LEVEL)
    eng3.update()
    cfg3 = dataclasses.replace(eng3.cfg, has_forward=False)
    assert (cfg3.num_point_lights, cfg3.num_directional_lights) == (1, 1)
    env3 = eng3._ensure_env()
    cam3 = torch.as_tensor(eng3.camera.to_raw(), device=dev)
    captured: dict = {}

    def capture(module, name, key):
        inner = getattr(module, name)

        def fn(*args, **kw):
            captured.setdefault(key(*args, **kw), (args, kw))
            return inner(*args, **kw)
        return _patched(module, name, fn)

    def render3(cfg=cfg3):
        return framelib.render_frame(
            eng3._pack.scene, eng3._packer.pool_for(cfg, dev),
            eng3._pack.lights, cam3, eng3.params, env3, cfg)

    with capture(raster, "rasterize_binned",
                 lambda bins, th, tw: f"K1 {th}x{tw} tiles"), \
            capture(resolve, "select_eval", lambda *a, **k: "K2"), \
            capture(resolve, "build_gbuffer_table", lambda *a, **k: "table"), \
            capture(shading, "shade_deferred_fused", lambda *a, **k: "K3"):
        render3()
    torch.cuda.synchronize()

    results = {}

    def compare(name, kernel_fn, plain_fn, check, work, plain_reps=REPS):
        """The kernel against its plain version on the same inputs, both
        timed; ``work`` = (bytes, float32 operations) of the call."""
        out_k, out_p = kernel_fn(), plain_fn()
        torch.cuda.synchronize()
        err = check(out_k, out_p)
        (ms, n), single_ms = _launch_run_ms(kernel_fn), _median_ms(kernel_fn)
        plain_ms = _median_ms(plain_fn, plain_reps)
        bound_ms, bound_by = _bound(*work)
        print(f"{name}: max_abs_err {err:.3g}, kernel {ms:.4f} ms a launch "
              f"over runs of {n} (single {single_ms:.4f} ms), plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})",
              flush=True)
        assert ms >= bound_ms, f"{name}: {ms} ms is under its bound {bound_ms}"
        results[name] = (err, ms, plain_ms, bound_ms, bound_by, single_ms)

    def raster_work(bins, th, tw, table=None):
        """K1 / K6: the rows each tile races (its count, at most K) read
        once, tri_id and depth written; 16 operations (four planes of two
        multiply-adds) a (row, pixel centre) pair that the exhaustive test
        covers, the work no cull avoids; K6 also reads the table and writes
        each pixel's row."""
        ty, tx, K, _ = bins.rows.shape
        rows, tile = raster.live_rows(bins)
        px = ty * tx * th * tw
        nbytes = _nbytes(bins.counts) + rows.shape[0] * 64 + px * 8
        if table is not None:
            nbytes += _nbytes(table) + px * table.shape[1] * 4
        return nbytes, raster.covered_pairs(rows, tile, tx, th, tw) * 16

    def window_rows(sb, kmax):
        """Rows of the stream's walked windows, over all tiles."""
        start, stop = raster.walked_windows(sb.starts, sb.rows.shape[0], kmax)
        return int((stop - start).clamp(min=0).sum())

    def stream_work(sb, ty, tx, th, tw, kmax):
        """K4: the rows of each tile's walked window, as raster_work."""
        walked, tile = raster.walked_rows(sb, ty * tx, kmax)
        rows = sb.rows[walked]
        return (_nbytes(sb.starts) + rows.shape[0] * 64 + ty * tx * th * tw * 8,
                raster.covered_pairs(rows, tile[walked], tx, th, tw) * 16)

    def eval_work(tri_id, table, bf16=True, window_ids=0):
        """K2 / K5: tri_id and the table read (K5 also its windows' ids),
        the split planes written; per covered pixel the denominator plane
        (4 operations) and each attribute plane and division (5)."""
        n_attr, cf, ch = resolve._layout(table.shape[1])
        px = tri_id.numel()
        nbytes = (_nbytes(tri_id, table) + window_ids * 4
                  + px * (cf * 4 + ch * (2 if bf16 else 4)))
        return nbytes, int((tri_id >= 0).sum()) * (4 + 5 * n_attr)

    def shade_work(tid, outf, outh, rec, gates, sky, P, D, irr):
        """K3: its planes read, (3, H, W) written. The operations are an
        estimate, not a count of shade.cu: per pixel ~40 of setup and sky,
        ~110 a light, ~100 for the SH-9 ambient. It only has to stay below
        the bytes term (a quarter of it or less at 1080p)."""
        px = tid.numel()
        return (_nbytes(tid, outf, outh, rec, gates, sky) + px * 12,
                px * (40 + 110 * (P + D) + (100 if irr is not None else 0)))

    def blend_work(texels, idx, fx, fy, C):
        """K7: each texel row the taps touch read once, each tap's index and
        fractions read, C floats a tap written; a channel's decode and
        bilinear blend ~13 operations."""
        n = idx.numel()
        rows = torch.unique(idx.long().clamp(0, texels.shape[0] - 1)).numel()
        return (rows * texels.shape[1] * texels.element_size()
                + _nbytes(idx, fx, fy) + n * C * 4, n * C * 13)

    def raster_check(a, b):
        assert torch.equal(a[0], b[0]), "K1 tri_id differs from the plain version"
        assert torch.equal(a[1], b[1]), "K1 depth differs from the plain version"
        return (a[1] - b[1]).abs().max().item()

    for key in ("K1 64x128 tiles", "K1 128x128 tiles"):
        (bins, th, tw), _ = captured[key]
        print(f"{key}: image {bins.rows.shape[0] * th}x{bins.rows.shape[1] * tw}"
              f", K={bins.rows.shape[2]}")
        compare(key, lambda: raster.rasterize_binned(bins, th, tw),
                lambda: raster.rasterize_binned_ref(bins, th, tw, chunk=16),
                raster_check, raster_work(bins, th, tw))

    def eval_check(a, b):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and torch.equal(x, y), \
                "K2 output differs from the plain version"
        return max((x.float() - y.float()).abs().max().item()
                   for x, y in zip(a, b))

    (tri_id, table), kw = captured["K2"]
    targs, tkw = captured["table"]
    full_table = resolve.build_gbuffer_table(*targs, **{**tkw, "slim": False})
    for key, tab in (("K2 slim", table), ("K2 full", full_table)):
        compare(key, lambda: resolve.select_eval(tri_id, tab, **kw),
                lambda: resolve.select_eval_ref(tri_id, tab, **kw), eval_check,
                eval_work(tri_id, tab, **kw))

    (tid, outf, outh, rec, gates, sky, campos, slights, P, D, irr), _ = \
        captured["K3"]
    consts = shading.pack_shading_consts(campos, slights, P, D, irr)
    assert rec is None, "demo.lvl is flat: no material plane"

    def shade_check(a, b):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
        assert torch.isfinite(a).all()
        return (a - b).abs().max().item()

    compare("K3", lambda: shading.shade_deferred_fused(
                tid, outf, outh, None, gates, sky, campos, slights, P, D, irr),
            lambda: shading.shade_fused_ref(tid, outf, outh, None, gates, sky,
                                            consts, P, D, irr is not None),
            shade_check, shade_work(tid, outf, outh, None, gates, sky, P, D, irr))
    assert (P, D) == (1, 1) and irr is not None and sky is not None

    def launch_counts():
        return {"K1": raster.K1_LAUNCHES, "K2": resolve.K2_LAUNCHES,
                "K3": shading.K3_LAUNCHES, "K4": raster.K4_LAUNCHES,
                "K5": resolve.K5_LAUNCHES, "K6": raster.K6_LAUNCHES,
                "K7": sampling.K7_LAUNCHES}

    launches = dict.fromkeys(launch_counts(), 0)   # main-path runs only
    profiles = []

    def reset_counts():
        raster.K1_LAUNCHES = raster.K4_LAUNCHES = resolve.K2_LAUNCHES = 0
        resolve.K5_LAUNCHES = shading.K3_LAUNCHES = sampling.K7_LAUNCHES = 0
        raster.K6_LAUNCHES = 0

    def add_counts():
        """Adds the counts since reset_counts to ``launches``; returns the
        run's non-zero counts."""
        run = launch_counts()
        for k, n in run.items():
            launches[k] += n
        return {k: n for k, n in run.items() if n}

    def timed_frames(engine, names, label):
        """Ten engine frames, every launch count set to 0 just before; the
        first re-renders the shadow atlas. Adds the counts read just after
        to ``launches``; with ``--profile``, then profiles ``label``.
        Returns (last output, frame ms, per-frame launches of ``names``,
        this run's launches, peak MiB)."""
        engine._atlas = None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        frame_ms, per_frame = [], []
        for _ in range(10):
            before = launch_counts()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = engine.run_frame(0.0)
            b.record()
            b.synchronize()
            frame_ms.append(a.elapsed_time(b))
            now = launch_counts()
            per_frame.append(tuple(now[k] - before[k] for k in names))
        run = launch_counts()
        add_counts()
        peak_mb = torch.cuda.max_memory_allocated() / 2**20
        if profile:
            r = {"config": label, "card": smi,
                 **_device_profile(engine, statistics.median(frame_ms[1:]))}
            profiles.append(r)
            ks = ", ".join(f"{k} {v:.4f}" for k, v in r["kernel_ms"].items())
            print(f"profile | {label} | {r['steady_ms']:.3f} ms | "
                  f"{r['device_ms']:.3f} ms | {100 * r['idle']:.1f}% | "
                  f"{r['launches']:.0f} | {ks} ms |", flush=True)
            for ms, count, key in r["top"]:
                print(f"    {ms:.4f} ms  x{count}  {key}", flush=True)
        sync_free(engine, label)
        return out, frame_ms, per_frame, run, peak_mb

    def sync_free(engine, label):
        """Ten settled frames under ``set_sync_debug_mode("error")``: no
        op of the steady frame synchronizes or uploads from pageable
        memory; ``drain_monitors()`` then leaves no fetch queued and the
        config as it was. Counts from 0, added to ``launches``."""
        assert engine._settled, label
        cfg0 = engine.cfg
        torch.cuda.synchronize()
        reset_counts()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(10):
                engine.run_frame(0.0)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        queued = len(engine._overflow_inflight)
        engine.drain_monitors()
        add_counts()
        assert not engine._overflow_inflight and engine.cfg == cfg0, label
        sync_free.runs.append(label)
        return queued

    sync_free.runs = []

    def kernel_vs_plain(label, render, chunk=16):
        """One frame through the kernels and one with every kernel swapped
        for its plain version: pick ids equal, edge_aware_compare passes."""
        fast = render()
        torch.cuda.synchronize()
        with pjobs.plain_versions(chunk):
            plain = render()
        torch.cuda.synchronize()
        assert torch.equal(fast.pick_id, plain.pick_id), f"{label}: pick ids differ"
        assert torch.isfinite(fast.hdr).all(), label
        res = verify.edge_aware_compare(fast.sdr.cpu().numpy(),
                                        plain.sdr.cpu().numpy(),
                                        pick=plain.pick_id.cpu().numpy())
        assert res["status"] == "pass", (label, res)
        print(f"{label}: kernel frame vs plain frame: pick ids equal, "
              f"edge-aware compare {res}", flush=True)
        return fast

    def settle(engine, label):
        """One engine frame, which render() hands out only once the
        capacities held (it renders again while one grew), then one more
        that must leave them as they are: (last output, renders of the
        first frame)."""
        f0 = engine.frame_index
        engine.run_frame(0.0)
        renders, cfg1 = engine.frame_index - f0, engine.cfg
        out = engine.run_frame(0.0)
        torch.cuda.synchronize()
        assert engine._settled and engine.cfg == cfg1, \
            f"{label}: capacities did not settle: {engine.cfg}"
        return out, renders

    # ---- phase 2: the engine path, 10 frames at 1920x1080 ---------------
    eng = Engine.from_world(
        demo.build_demo_world(n_cubes=24, with_point_light=False),
        camera=demo.build_demo_camera(1920, 1080), cfg=RenderConfig(),
        device=dev)
    eng.update()
    eng._ensure_env()
    settle(eng, "demo world")
    assert framelib.use_fused_shading(eng.cfg), "fused path not taken"
    out, frame_ms, per_frame, run, peak_mb = timed_frames(
        eng, ("K1", "K2", "K3"), "demo world, directional light (fused)")
    assert run["K4"] == run["K5"] == 0, run
    views = eng.cfg.num_shadow_views
    assert per_frame[0] == (1 + views, 1, 1), per_frame[0]
    assert all(p == (1, 1, 1) for p in per_frame[1:]), per_frame
    pick = out.pick_id
    assert out.sdr.shape == (1080, 1920, 3) and pick.shape == (1080, 1920)
    assert torch.isfinite(out.hdr).all()
    assert (pick == 0).any() and (pick > 0).any(), "need sky and geometry"
    assert len(torch.unique(pick)) > 2
    print(f"engine frame 1920x1080 ({views} shadow view): launches per frame "
          f"{per_frame}, frame ms {[round(t, 3) for t in frame_ms]}, "
          f"first {frame_ms[0]:.3f} ms (builds the atlas), median of the "
          f"steady 9: {statistics.median(frame_ms[1:]):.3f} ms, peak memory "
          f"{peak_mb:.1f} MiB, objects {len(torch.unique(pick)) - 1}",
          flush=True)

    # ---- phase 3: point + directional frame, kernels vs plain ----------
    n_before = raster.K1_LAUNCHES
    kernel_vs_plain(f"demo.lvl 1920x1080, P=1 D=1, {cfg3.num_shadow_views} "
                    f"shadow views", render3)
    assert raster.K1_LAUNCHES - n_before == 1 + cfg3.num_shadow_views

    # ---- phase 4: the high-poly stream path (bench.py's highpoly cell) ---
    cfg4 = RenderConfig(width=1920, height=1080, max_instances=64,
                        max_vertices=131072, max_triangles=131072,
                        bin_capacity=1024, tile_h=8)
    eng4 = Engine.from_world(demo.build_highpoly_world(9),
                             camera=demo.build_demo_camera(1920, 1080),
                             cfg=cfg4, device=dev)

    shadow_k = lambda bins, th, tw: f"K1 shadow K={bins.rows.shape[2]}"  # noqa: E731
    with capture(raster, "rasterize_binned", shadow_k):
        k1 = raster.K1_LAUNCHES
        out4, renders4 = settle(eng4, "high-poly world")
        # the atlas views only, a whole atlas a render that drew one: the
        # main view takes the stream raster
        atlas_k1 = raster.K1_LAUNCHES - k1
        assert atlas_k1 > 0 and atlas_k1 % eng4.cfg.num_shadow_views == 0, \
            atlas_k1
    c4 = eng4.cfg
    assert framelib.use_fused_shading(c4) and c4.stream_raster
    tris = eng4._pack.counts["triangles"]
    assert raster.stream_pays_off(eng4._pack.scene.tri_vidx.shape[0]) and tris > 100_000
    assert int(out4.stream_overflow) <= c4.stream_capacity, int(out4.stream_overflow)
    assert int(out4.bin_overflow) <= c4.bin_capacity, int(out4.bin_overflow)
    assert int(out4.big_overflow) <= c4.bin_big_capacity, int(out4.big_overflow)
    settled = {f: getattr(c4, f) for f in (
        "stream_capacity", "bin_capacity", "bin_big_capacity",
        "shadow_bin_capacity", "shadow_block_capacity", "max_triangles")}
    print(f"high-poly world: {tris} triangles, settled in {renders4} renders: "
          f"{settled}, stream pairs {int(out4.stream_overflow)}, max tile "
          f"{int(out4.bin_overflow)}, bigs {int(out4.big_overflow)}", flush=True)

    # (a) each kernel against its plain version at the captured shapes
    with capture(raster, "rasterize_stream", lambda *a, **k: "K4"), \
            capture(resolve, "select_eval_stream", lambda *a, **k: "K5"):
        eng4.run_frame(0.0)
    torch.cuda.synchronize()
    (sb, ty4, tx4, th4, tw4, kmax), _ = captured["K4"]
    print(f"K4 1088x1920: stream {sb.rows.shape[0]} rows, {ty4}x{tx4} tiles "
          f"of {th4}x{tw4}, kmax {kmax}", flush=True)
    compare("K4", lambda: raster.rasterize_stream(sb, ty4, tx4, th4, tw4, kmax),
            lambda: raster.rasterize_stream_ref(sb, ty4, tx4, th4, tw4, kmax),
            raster_check, stream_work(sb, ty4, tx4, th4, tw4, kmax))
    (tid4, sb5, table4, th5, tw5, kmax5), kw5 = captured["K5"]
    compare("K5", lambda: resolve.select_eval_stream(tid4, sb5, table4, th5,
                                                     tw5, kmax5, **kw5),
            lambda: resolve.select_eval_stream_ref(tid4, sb5, table4, th5,
                                                   tw5, kmax5, **kw5),
            eval_check, eval_work(tid4, table4, **kw5,
                                  window_ids=window_rows(sb5, kmax5)))
    key1 = f"K1 shadow K={c4.shadow_bin_capacity}"
    (bins1, th1, tw1), _ = captured[key1]
    assert int(bins1.overflow) <= c4.shadow_bin_capacity
    print(f"{key1}: image {bins1.rows.shape[0] * th1}x"
          f"{bins1.rows.shape[1] * tw1}, {th1}x{tw1} tiles, scatter bins, "
          f"{int(bins1.counts.sum())} rows over {bins1.counts.numel()} tiles, "
          f"heaviest tile {int(bins1.counts.max())} rows (wanted "
          f"{int(bins1.overflow)}), per tile "
          f"{sorted(bins1.counts.reshape(-1).tolist(), reverse=True)[:8]}...",
          flush=True)
    compare(key1, lambda: raster.rasterize_binned(bins1, th1, tw1),
            lambda: raster.rasterize_binned_ref(bins1, th1, tw1, chunk=64),
            raster_check, raster_work(bins1, th1, tw1), plain_reps=1)
    del captured[key1], bins1

    # (b) ten engine frames; the first re-renders the shadow atlas
    out4, frame_ms, per_frame, run, peak_mb = timed_frames(
        eng4, ("K1", "K4", "K5", "K3"), "high-poly world (stream)")
    views = c4.num_shadow_views
    assert eng4.cfg == c4, "capacities grew during the timed frames"
    assert run["K2"] == 0, run
    assert per_frame[0] == (views, 1, 1, 1), per_frame[0]
    assert all(p == (0, 1, 1, 1) for p in per_frame[1:]), per_frame
    pick = out4.pick_id
    assert out4.sdr.shape == (1080, 1920, 3) and torch.isfinite(out4.hdr).all()
    assert (pick == 0).any() and len(torch.unique(pick)) == 10, "9 spheres + sky"
    print(f"high-poly engine frame 1920x1080 ({views} shadow view): launches "
          f"(K1, K4, K5, K3) per frame {per_frame}, frame ms "
          f"{[round(t, 3) for t in frame_ms]}, first {frame_ms[0]:.3f} ms "
          f"(re-renders the atlas), median of the steady 9: "
          f"{statistics.median(frame_ms[1:]):.3f} ms, peak memory "
          f"{peak_mb:.1f} MiB, {tris / statistics.median(frame_ms[1:]) / 1e3:.3f}"
          f" Mtris/s", flush=True)

    # (c) the whole frame through the kernels and through the plain versions
    scene4, lights4 = eng4._pack.scene, eng4._pack.lights
    env4 = eng4._ensure_env()
    cam4 = torch.as_tensor(eng4.camera.to_raw(), device=dev)
    kernel_vs_plain("high-poly 1920x1080", lambda: framelib.render_frame(
        scene4, eng4._packer.pool_for(c4, dev), lights4, cam4, eng4.params,
        env4, c4), chunk=64)

    # ---- phase 5: the textured frame and the forward overlay ------------
    # (a) the textured demo world with its point light, 1920x1080
    eng5 = Engine.from_world(
        demo.build_demo_world(n_cubes=24, textured_every=2),
        camera=demo.build_demo_camera(1920, 1080), cfg=RenderConfig(),
        device=dev)
    out5, n_frames = settle(eng5, "textured demo world")
    c5 = eng5.cfg
    assert c5.any_textured and c5.has_forward and framelib.use_fused_shading(c5)
    assert (c5.num_point_lights, c5.num_directional_lights) == (1, 1)
    tex_blocks, fwd_tiles = out5.tex_overflow.tolist()
    assert 0 < tex_blocks and 0 < fwd_tiles <= c5.fwd_tile_capacity
    print(f"textured demo world 1920x1080: settled in {n_frames} renders: "
          f"tex_block_capacity {c5.tex_block_capacity} ({tex_blocks} textured "
          f"blocks wanted of {eng5._tex_block_count()}), fwd_tile_capacity "
          f"{c5.fwd_tile_capacity} ({fwd_tiles} overlay tiles)", flush=True)

    site = ["?"]

    def tagging(module, name, tag):
        inner = getattr(module, name)

        def fn(*args, **kw):
            site[0] = tag
            try:
                return inner(*args, **kw)
            finally:
                site[0] = "?"
        return _patched(module, name, fn)

    with tagging(compact, "sample_pool_compacted", "K7 material"), \
            tagging(resolve, "_forward_overlay_compact", "K7 sprite"), \
            capture(sampling, "windowed_blend", lambda *a, **k: site[0]), \
            capture(shading, "shade_deferred_fused", lambda *a, **k: "K3 textured"):
        eng5.run_frame(0.0)
    torch.cuda.synchronize()

    def blend_check(a, b):
        assert a.shape == b.shape and torch.equal(a, b), \
            "K7 differs from the plain version"
        return (a - b).abs().max().item()

    for key in ("K7 material", "K7 sprite"):
        (texels, idx, fx, fy, C, cfirst), _ = captured[key]
        print(f"{key}: pool {tuple(texels.shape)} u8, {idx.shape[0]} taps, "
              f"C={C}, channel_first={cfirst}", flush=True)
        compare(key, lambda: sampling.windowed_blend(texels, idx, fx, fy, C,
                                                     cfirst),
                lambda: sampling.windowed_blend_ref(texels, idx, fx, fy, C,
                                                    cfirst), blend_check,
                blend_work(texels, idx, fx, fy, C))
    (tid5, outf5, outh5, rec5, gates5, sky5, campos5, sl5, P5, D5, irr5), _ = \
        captured["K3 textured"]
    assert rec5 is not None and rec5.shape == (9,) + tuple(tid5.shape)
    consts5 = shading.pack_shading_consts(campos5, sl5, P5, D5, irr5)
    compare("K3 textured", lambda: shading.shade_deferred_fused(
                tid5, outf5, outh5, rec5, gates5, sky5, campos5, sl5, P5, D5,
                irr5),
            lambda: shading.shade_fused_ref(tid5, outf5, outh5, rec5, gates5,
                                            sky5, consts5, P5, D5,
                                            irr5 is not None),
            shade_check, shade_work(tid5, outf5, outh5, rec5, gates5, sky5, P5,
                                    D5, irr5))

    out5, frame_ms, per_frame, run, peak_mb = timed_frames(
        eng5, ("K1", "K2", "K3", "K7"), "textured world (fused)")
    views = c5.num_shadow_views
    assert eng5.cfg == c5, "capacities grew during the timed frames"
    assert run["K4"] == run["K5"] == 0, run
    assert per_frame[0][:3] == (views + 2, 1, 1), per_frame[0]
    assert all(p[:3] == (2, 1, 1) and p[3] >= 2 for p in per_frame[1:]), per_frame
    pick = out5.pick_id
    assert out5.sdr.shape == (1080, 1920, 3) and torch.isfinite(out5.hdr).all()
    assert (pick == 0).any() and len(torch.unique(pick)) > 20
    print(f"textured engine frame 1920x1080 ({views} shadow views): launches "
          f"(K1, K2, K3, K7) per frame {per_frame}, frame ms "
          f"{[round(t, 3) for t in frame_ms]}, first {frame_ms[0]:.3f} ms "
          f"(re-renders the atlas), median of the steady 9: "
          f"{statistics.median(frame_ms[1:]):.3f} ms, peak memory "
          f"{peak_mb:.1f} MiB, objects {len(torch.unique(pick)) - 1}",
          flush=True)

    scene5, lights5 = eng5._pack.scene, eng5._pack.lights
    env5 = eng5._ensure_env()
    cam5 = torch.as_tensor(eng5.camera.to_raw(), device=dev)
    kernel_vs_plain("textured demo world 1920x1080", lambda: framelib.render_frame(
        scene5, eng5._packer.pool_for(c5, dev), lights5, cam5, eng5.params,
        env5, c5))

    # (b) demo.lvl with its light billboard; (c) its forward-only frame
    cfg5b = eng3.cfg
    assert cfg5b.has_forward and not cfg5b.any_textured
    n7 = sampling.K7_LAUNCHES
    out5b = kernel_vs_plain("demo.lvl 1920x1080 with the overlay",
                            lambda: render3(cfg5b))
    assert sampling.K7_LAUNCHES > n7, "the billboard sprite took no K7 tap"
    assert int(out5b.tex_overflow[1]) > 0
    kernel_vs_plain("demo.lvl 1920x1080 forward-only", lambda: render3(
        dataclasses.replace(cfg5b, forward_only=True)))
    # the same two frames as engine runs (timed, then steady frames under
    # the sync debug mode; profiled with --profile)
    for label, change in (("demo.lvl with the overlay", {}),
                          ("demo.lvl forward-only", dict(forward_only=True))):
        eng3.cfg = dataclasses.replace(cfg5b, **change)
        eng3._atlas = None
        settle(eng3, label)
        timed_frames(eng3, (), label)

    # ---- phase 6: the unfused deferred chain and K6, 1920x1080 -----------
    # the textured world of phase 5 (point + directional light, billboard)
    six = ("K1", "K2", "K3", "K6", "K7")
    phase6 = [("a", "fused_resolve", dict(fused_resolve=True)),
              ("b", "SSR at strength 0.5", dict(enable_ssr=True)),
              ("c", "render_scale_pct 75", dict(render_scale_pct=75)),
              ("d", "texture_scale 2", dict(texture_scale=2)),
              ("e", "the goldens' settings",
               dict(use_pallas=False, shadow_lookup_scale=4, sky_scale=4,
                    shadow_bf16=False))]
    for tag, label, change in phase6:
        eng5.cfg = dataclasses.replace(c5, **change)
        eng5._atlas = None
        eng5.set_param(framelib.PARAM_SSR_STRENGTH,
                       0.5 if change.get("enable_ssr") else 0.0)
        settle(eng5, label)
        c6 = eng5.cfg
        fused = framelib.use_fused_shading(c6) and c6.render_scale_pct == 100
        assert not fused, f"{label}: took the fused frame"
        if tag == "a":
            with capture(raster, "rasterize_resolve_binned",
                         lambda *a, **k: "K6"):
                eng5.run_frame(0.0)
            torch.cuda.synchronize()
            (bins6, table6, th6, tw6), _ = captured["K6"]
            print(f"K6 {bins6.rows.shape[0] * th6}x{bins6.rows.shape[1] * tw6}: "
                  f"{th6}x{tw6} tiles, K={bins6.rows.shape[2]}, table "
                  f"{tuple(table6.shape)}", flush=True)

            def resolve_check(a, b):
                raster_check(a, b)
                assert torch.equal(a[2], b[2]), \
                    "K6 sel differs from the plain version"
                return (a[2] - b[2]).abs().max().item()
            compare("K6", lambda: raster.rasterize_resolve_binned(
                        bins6, table6, th6, tw6),
                    lambda: raster.rasterize_resolve_binned_ref(
                        bins6, table6, th6, tw6, chunk=16),
                    resolve_check, raster_work(bins6, th6, tw6, table6))
        out6, frame_ms, per_frame, run, peak_mb = timed_frames(
            eng5, six, f"textured, {label}")
        assert eng5.cfg == c6, f"{label}: capacities grew during the timed frames"
        assert run["K4"] == run["K5"] == 0, run
        if tag == "a":
            assert all(p[3] == 1 for p in per_frame) and run["K2"] == 0, per_frame
        if tag in "bde":
            assert run["K3"] == 0 and run["K2"] >= 10, run
        if tag == "c":
            assert all(p[2] == 1 for p in per_frame), per_frame
        pick = out6.pick_id
        assert out6.sdr.shape == (1080, 1920, 3) and pick.shape == (1080, 1920)
        assert torch.isfinite(out6.hdr).all() and (pick == 0).any()
        assert len(torch.unique(pick)) > 20
        print(f"6{tag} {label} 1920x1080: launches {six} per frame {per_frame}, "
              f"frame ms {[round(t, 3) for t in frame_ms]}, first "
              f"{frame_ms[0]:.3f} ms (re-renders the atlas), median of the "
              f"steady 9: {statistics.median(frame_ms[1:]):.3f} ms, peak memory "
              f"{peak_mb:.1f} MiB, objects {len(torch.unique(pick)) - 1}",
              flush=True)
        scene6, lights6 = eng5._pack.scene, eng5._pack.lights
        cam6 = torch.as_tensor(eng5.camera.to_raw(), device=dev)
        out6 = kernel_vs_plain(f"6{tag} {label}", lambda: framelib.render_frame(
            scene6, eng5._packer.pool_for(c6, dev), lights6, cam6, eng5.params,
            env5, c6))
        if tag == "b":       # the reflections changed the frame
            eng5.set_param(framelib.PARAM_SSR_STRENGTH, 0.0)
            still = framelib.render_frame(
                scene6, eng5._packer.pool_for(c6, dev), lights6, cam6,
                eng5.params, env5, c6)
            moved = (still.hdr != out6.hdr).any(dim=-1).float().mean().item()
            print(f"6b: SSR changed {moved:.4f} of the pixels", flush=True)
            assert moved > 0.001

    # ---- phase 7: the environment chain, the sky options, the presets ----
    def textured_engine(cfg, **kw):
        return Engine.from_world(
            demo.build_demo_world(n_cubes=24, textured_every=2),
            camera=demo.build_demo_camera(1920, 1080), cfg=cfg, device=dev,
            **kw)

    def timed_config(tag, label, engine, names=("K1", "K2", "K3", "K7")):
        """Settle, ten timed engine frames, kernels vs plain: (last output,
        steady ms, the timed frames' launches)."""
        settle(engine, label)
        out, frame_ms, per_frame, run, peak_mb = timed_frames(engine, names,
                                                              label)
        steady = statistics.median(frame_ms[1:])
        pick = out.pick_id
        assert out.sdr.shape == (1080, 1920, 3) and torch.isfinite(out.hdr).all()
        assert (pick == 0).any() and len(torch.unique(pick)) > 20, label
        print(f"7{tag} {label} 1920x1080: launches {names} per frame "
              f"{per_frame}, frame ms {[round(t, 3) for t in frame_ms]}, "
              f"median of the steady 9: {steady:.3f} ms, peak memory "
              f"{peak_mb:.1f} MiB, sky blocks {int(out.sky_blocks)}",
              flush=True)
        c = engine.cfg
        scene, lights = engine._pack.scene, engine._pack.lights
        env = engine._ensure_env()
        cam = torch.as_tensor(engine.camera.to_raw(), device=dev)
        kernel_vs_plain(f"7{tag} {label}", lambda: framelib.render_frame(
            scene, engine._packer.pool_for(c, dev), lights, cam,
            engine.params, env, c))
        return out, steady, run

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # (a) HDR skybox file + IBL cache at the default sizes (1024, 64)
        sky_path = os.path.join(tmp, "sky.hdr")
        ibl_path = os.path.join(tmp, "ibl.data")
        with open(sky_path, "wb") as f:
            f.write(hdrlib.encode_hdr(hdrlib.procedural_sky()))
        cfg7 = RenderConfig()
        eng7 = textured_engine(cfg7, skybox_path=sky_path,
                               ibl_cache_path=ibl_path)
        env7 = eng7._ensure_env()
        s7 = cfg7.irradiance_size
        irr7 = env7.irradiance
        assert irr7.is_cuda and irr7.shape == (6, s7, s7, 3)
        assert torch.isfinite(irr7).all() and irr7.min() > 0
        cube7 = env7.env_cube
        assert cube7.is_cuda and cube7.shape == (6, 1024, 1024, 3)
        bake_ms = _median_ms(lambda: framelib.bake_irradiance(cube7, s7), 5)
        on_card = framelib.bake_irradiance(cube7, s7)
        assert torch.equal(on_card, irr7), "the bake is not deterministic"
        t0 = time.perf_counter()
        on_cpu = framelib.bake_irradiance(cube7.cpu(), s7)
        cpu_s = time.perf_counter() - t0
        bake_err = (on_card.cpu() - on_cpu).abs().max().item()
        # both sum the same 3213 weighted samples a texel in the same
        # chunks of 128, in another order: a float32 sum of 3213 terms may
        # move by 3213 ulp (1.9e-4) between two orders
        torch.testing.assert_close(on_card.cpu(), on_cpu, rtol=1e-4, atol=1e-6)
        bake_rel = ((on_card.cpu() - on_cpu).abs() / on_cpu.abs()).max().item()
        print(f"7a irradiance bake {s7}x{s7}x6 of the {cube7.shape[1]}-texel "
              f"cube on the card: {bake_ms:.3f} ms (median of 5), CPU "
              f"{cpu_s:.1f} s, max abs diff {bake_err:.3g}, max rel diff "
              f"{bake_rel:.3g} (rtol 1e-4, atol 1e-6), irradiance "
              f"{irr7.min().item():.4g}..{irr7.max().item():.4g}", flush=True)
        raw = np.fromfile(ibl_path, np.float16)
        assert raw.size == 6 * s7 * s7 * 4
        cached = raw.reshape(6, s7, s7, 4)[..., :3].astype(np.float32)
        assert np.array_equal(cached, irr7.cpu().numpy().astype(np.float16)
                              .astype(np.float32))
        eng7b = textured_engine(cfg7, skybox_path=sky_path,
                                ibl_cache_path=ibl_path)
        loaded = eng7b._ensure_env().irradiance
        assert loaded.is_cuda and np.array_equal(loaded.cpu().numpy(), cached)
        out7, _ = settle(eng7, "skybox world")
        assert torch.isfinite(out7.hdr).all() and (out7.pick_id == 0).any()
        os.remove(ibl_path)
        eng7.add_action(RenderingAction.BAKE_IRRADIANCE)
        eng7.add_action(RenderingAction.SAVE_IRRADIANCE)
        eng7.run_frame(0.0)
        assert not eng7._actions and os.path.exists(ibl_path)
        assert torch.equal(eng7._env.irradiance, on_card)
        assert np.array_equal(np.fromfile(ibl_path, np.float16), raw)
        print(f"7a skybox engine: cache {os.path.getsize(ibl_path)} bytes "
              f"written, loaded bit-equal by a second engine; the "
              f"BAKE_IRRADIANCE and SAVE_IRRADIANCE actions ran", flush=True)
        del eng7, eng7b, env7, on_cpu

    # (b) the block-compacted exact sky against the full-rate sky
    steady7 = {}
    for fused in (True, False):
        mode = "fused" if fused else "unfused"
        base = dataclasses.replace(c5, fused_shading=fused)
        eng_b = textured_engine(dataclasses.replace(base, sky_scale=1))
        full, steady7[f"sky_scale 1 {mode}"], _ = timed_config(
            "b", f"sky_scale 1, {mode}", eng_b)
        eng_b = textured_engine(dataclasses.replace(
            base, sky_scale=8, sky_block_capacity=4096))
        blocks, steady7[f"block sky {mode}"], _ = timed_config(
            "b", f"block sky (capacity 4096, sky_scale 8), {mode}", eng_b)
        assert framelib.use_fused_shading(eng_b.cfg) == fused
        assert int(blocks.sky_blocks) > 0
        assert torch.equal(full.sdr, blocks.sdr), \
            f"7b {mode}: the block sky differs from the full-rate sky"
        print(f"7b {mode}: block sky frame equals the sky_scale 1 frame "
              f"({int(blocks.sky_blocks)} background blocks)", flush=True)
        del eng_b

    # (c) the cubic sky upsample; a sky scale that does not divide the frame
    for label, change in (("cubic sky upsample", dict(sky_upsample="cubic")),
                          ("sky_scale 3", dict(sky_scale=3))):
        eng_c = textured_engine(dataclasses.replace(c5, **change))
        _, steady7[label], _ = timed_config("c", label, eng_c)
        del eng_c

    # (d) the presets; reference_parity samples the native-size pool
    for preset in ("performance_preset", "fidelity_preset",
                   "reference_parity"):
        eng_d = textured_engine(getattr(c5, preset)())
        _, steady7[preset], run = timed_config("d", preset, eng_d)
        if preset == "reference_parity":
            pool = eng_d._packer.pool_for(eng_d.cfg, dev)
            assert isinstance(pool, sampling.NativeTexturePoolGPU)
            assert run["K7"] >= 20, "the native windowed taps took no K7"
        del eng_d
    print("7 steady frame ms: " + json.dumps(steady7), flush=True)

    # ---- phase 8: the editor and its host surfaces ----------------------
    editor_phase(dev, smi, RenderConfig(width=1920, height=1080),
                 RenderConfig(width=1280, height=720), 50,
                 ["--level", os.path.relpath(LEVEL, ROOT)], kernel_vs_plain,
                 reset_counts, add_counts)

    # ---- phase 9: the multi-device frame ---------------------------------
    eng3.cfg, eng5.cfg = cfg5b, c5
    settle(eng3, "demo.lvl")
    sharded_phase(dev, smi, {"lvl": (eng3, ("level", LEVEL)),
                             "highpoly": (eng4, ("highpoly", 9)),
                             "textured": (eng5, ("demo", dict(
                                 n_cubes=24, textured_every=2)))},
                  launches, verify)

    # ---- phase 10: the frame loop -----------------------------------------
    frame_loop_phase(dev, smi, eng3, c5, reset_counts, add_counts, sync_free)

    # ---- phase 11: the single-card entry and the offline tools ------------
    entry_tools_phase(dev, smi, reset_counts, add_counts, kernel_vs_plain)

    sources = {"K1": ("raster.cu", "tinyrenderer_tpu/ops/raster.py:557",
                      "K1 64x128 tiles"),
               "K2": ("select_eval.cu", "tinyrenderer_tpu/ops/resolve.py:408",
                      "K2 slim"),
               "K3": ("shade.cu", "tinyrenderer_tpu/ops/shading.py:208", "K3"),
               "K4": ("raster.cu", "tinyrenderer_tpu/ops/raster.py:812", "K4"),
               "K5": ("select_eval.cu", "tinyrenderer_tpu/ops/resolve.py:647",
                      "K5"),
               "K6": ("raster.cu", "tinyrenderer_tpu/ops/raster.py:627", "K6"),
               "K7": ("sampling.cu", "tinyrenderer_tpu/ops/sampling.py:63",
                      "K7 material")}
    extra = {"K1": [("shadow_view", "K1 128x128 tiles"),
                    ("highpoly_shadow_view", key1)],
             "K3": [("textured", "K3 textured")], "K7": [("sprite", "K7 sprite")]}
    table_out = []
    for name, (src, replaces, key) in sources.items():
        err = max(v[0] for k, v in results.items() if k.startswith(name))
        _, ms, plain_ms, bound_ms, bound_by, single_ms = results[key]
        assert launches[name] > 0, f"{name} never launched on a main path"
        entry = {"name": name, "route": "cuda",
                 "source": f"tinyrenderer_tpu_torch/csrc/{src}",
                 "replaces": replaces, "launches": launches[name],
                 "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": bound_ms, "bound_by": bound_by,
                 "library_ms": None, "single_launch_ms": single_ms}
        for tag, key2 in extra.get(name, ()):
            (entry[f"{tag}_ms"], entry[f"{tag}_plain_ms"],
             entry[f"{tag}_bound_ms"]) = results[key2][1:4]
        table_out.append(entry)
    if profile:
        out_dir = os.path.join(ROOT, "chiprun_out")
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "chip_smoke_profile.jsonl"), "w") as f:
            for r in profiles:
                f.write(json.dumps(r) + "\n")
    print(json.dumps({"kernels": table_out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main(sys.argv[1:])
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
