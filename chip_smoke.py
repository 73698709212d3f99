#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

Builds the seven hand-written kernels (K1-K7) from
``tinyrenderer_tpu_torch/csrc`` (one ``nvcc`` a source, in parallel) and
runs, each phase asserting or letting its exception propagate:

1. K1-K3 against their plain PyTorch versions, at the shapes the 1080p
   frame gives them (captured from one frame of ``levels/demo.lvl``), with
   the times of both (median of 20 CUDA-event runs);
2. the engine path at 1920x1080: ``Engine.run_frame`` ten times on the
   directional-light demo world, with the kernels' launch counters reset
   just before and read just after;
3. the point + directional frame of ``levels/demo.lvl`` (overlay off) through
   the kernels and again through the plain versions: equal pick ids and a
   passing edge-aware image comparison;
4. the high-poly stream path: ``build_highpoly_world(9)`` (~108k
   triangles) at 1920x1080 with 8x128 tiles. The engine runs until its
   capacities stop growing; K4, K5 (main view) and K1 (the scatter-binned
   shadow view at its grown bin capacity) are held against their plain
   versions at the captured shapes; ten engine frames are timed with the
   launch counters reset just before (the first re-renders the atlas); and
   one frame is rendered through the kernels and again through the plain
   versions;
5. the textured frame and the forward overlay: (a) the demo world with
   every second cube textured and its point light (a light billboard) at
   1920x1080 runs until its capacities settle; K7 is held against its
   plain version at both call sites (the compacted material sample and the
   overlay sprite) and K3 with its material plane against its plain
   version, at the captured shapes; ten engine frames are timed with the
   launch counters reset just before; one frame is rendered through the
   kernels and again through the plain versions; (b) ``levels/demo.lvl``
   with its billboard and (c) its forward-only frame, each kernels
   against plain versions;
6. the unfused deferred chain on the textured world of phase 5 at
   1920x1080, each configuration settled, timed over ten engine frames and
   rendered through the kernels and through the plain versions: (a)
   ``fused_resolve`` (K6, first held against its plain version at the
   captured main-view shape), (b) SSR at strength 0.5, (c)
   ``render_scale_pct=75``, (d) ``texture_scale=2``, (e) the goldens'
   settings (``use_pallas=False``, shadow lookups and sky at 1/4 rate, f32
   atlas).

Each kernel's line on the ``kernels`` JSON record carries its bound: the
larger of the bytes it must move (each input read once, each output written
once; K7's texel rows as many as its taps touch) over 3.35 TB/s and its
float32 operations over 67 TFLOP/s, the H100 SXM's published peaks. The
operations are counted from each kernel's formulas on this run's inputs,
except K3's, an estimate that stays well below its bytes term.
No single PyTorch call computes any of these functions, so
``library_ms`` is null throughout.

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
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
LEVEL = os.path.join(ROOT, "levels", "demo.lvl")
REPS = 20
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, published
F32_FLOPS = 67e12
# the kernels of tinyrenderer_tpu_torch/csrc, by their __global__ names
GLOBALS = {"K1": "raster_kernel", "K2": "select_eval_kernel",
           "K3": "shade_kernel", "K4": "raster_stream_kernel",
           "K5": "select_eval_stream_kernel", "K6": "raster_resolve_kernel",
           "K7": "windowed_blend_kernel"}


def _bound(nbytes: float, flops: float) -> tuple[float, str]:
    """(least ms, what bounds it) for work that moves ``nbytes`` and does
    ``flops`` float32 operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _median_ms(fn, reps: int = REPS) -> float:
    """Median over ``reps`` CUDA-event timed calls, after one warm-up."""
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
        for k, name in GLOBALS.items():
            if re.search(rf"\b{name}(\b[<(]|$)", e.key):
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


def main(argv: list[str]) -> int:
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
    from tinyrenderer_tpu_torch.ops import (compact, raster, resolve,
                                            sampling, shading)
    from tinyrenderer_tpu_torch.render import frame as framelib
    from tinyrenderer_tpu_torch.render.engine import Engine
    from tinyrenderer_tpu_torch.config import RenderConfig
    from tinyrenderer_tpu_torch.scene import demo
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
        ms, plain_ms = _median_ms(kernel_fn), _median_ms(plain_fn, plain_reps)
        bound_ms, bound_by = _bound(*work)
        print(f"{name}: max_abs_err {err:.3g}, kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})",
              flush=True)
        results[name] = (err, ms, plain_ms, bound_ms, bound_by)

    def raster_work(bins, th, tw, table=None):
        """K1 / K6: the rows each tile races (its count, at most K) at 16
        operations a row and pixel (four planes of two multiply-adds),
        tri_id and depth written; K6 also reads the table and writes each
        pixel's row."""
        ty, tx, K, _ = bins.rows.shape
        rows = int(bins.counts.clamp(0, K).sum())
        px = ty * tx * th * tw
        nbytes = _nbytes(bins.counts) + rows * 64 + px * 8
        if table is not None:
            nbytes += _nbytes(table) + px * table.shape[1] * 4
        return nbytes, rows * th * tw * 16

    def window_rows(sb, kmax):
        """Rows of the stream's walked windows, over all tiles."""
        start, stop = raster.walked_windows(sb.starts, sb.rows.shape[0], kmax)
        return int((stop - start).clamp(min=0).sum())

    def stream_work(sb, ty, tx, th, tw, kmax):
        """K4: the rows of each tile's walked window, as raster_work."""
        rows = window_rows(sb, kmax)
        return (_nbytes(sb.starts) + rows * 64 + ty * tx * th * tw * 8,
                rows * th * tw * 16)

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

    def timed_frames(engine, names, label):
        """Ten engine frames, every launch count set to 0 just before; the
        first re-renders the shadow atlas. Adds the counts read just after
        to ``launches``; with ``--profile``, then profiles ``label``.
        Returns (last output, frame ms, per-frame launches of ``names``,
        this run's launches, peak MiB)."""
        engine._atlas = None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        raster.K1_LAUNCHES = raster.K4_LAUNCHES = resolve.K2_LAUNCHES = 0
        resolve.K5_LAUNCHES = shading.K3_LAUNCHES = sampling.K7_LAUNCHES = 0
        raster.K6_LAUNCHES = 0
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
        for k, n in run.items():
            launches[k] += n
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
        return out, frame_ms, per_frame, run, peak_mb

    def shade_plain(tid, outf, outh, rec, gates, sky, campos, slights, P, D,
                    irr):
        return shading.shade_fused_ref(
            tid, outf, outh, rec, gates, sky,
            shading.pack_shading_consts(campos, slights, P, D, irr), P, D,
            irr is not None)

    def kernel_vs_plain(label, render, chunk=16):
        """One frame through the kernels and one with every kernel swapped
        for its plain version: pick ids equal, edge_aware_compare passes."""
        fast = render()
        torch.cuda.synchronize()
        with contextlib.ExitStack() as stack:
            for mod, name, fn in (
                    (raster, "rasterize_binned",
                     lambda bins, th, tw: raster.rasterize_binned_ref(
                         bins, th, tw, chunk=chunk)),
                    (raster, "rasterize_stream", raster.rasterize_stream_ref),
                    (raster, "rasterize_resolve_binned",
                     lambda bins, table, th, tw:
                     raster.rasterize_resolve_binned_ref(bins, table, th, tw,
                                                         chunk=chunk)),
                    (resolve, "select_eval", resolve.select_eval_ref),
                    (resolve, "select_eval_stream",
                     resolve.select_eval_stream_ref),
                    (shading, "shade_deferred_fused", shade_plain),
                    (sampling, "windowed_blend", sampling.windowed_blend_ref)):
                stack.enter_context(_patched(mod, name, fn))
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
        """Engine frames until the capacities stop growing (at most 8):
        (last output, frames run)."""
        for i in range(8):
            cfg_before, atlas_frame = engine.cfg, engine._atlas is None
            out = engine.run_frame(0.0)
            torch.cuda.synchronize()
            if engine.cfg == cfg_before and not atlas_frame:
                return out, i + 1
        raise AssertionError(f"{label}: capacities did not settle: {engine.cfg}")

    # ---- phase 2: the engine path, 10 frames at 1920x1080 ---------------
    eng = Engine.from_world(
        demo.build_demo_world(n_cubes=24, with_point_light=False),
        camera=demo.build_demo_camera(1920, 1080), cfg=RenderConfig(),
        device=dev)
    eng.update()
    eng._ensure_env()
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
        for i in range(8):            # run until the capacities settle
            cfg_before, atlas_frame = eng4.cfg, eng4._atlas is None
            k1 = raster.K1_LAUNCHES
            out4 = eng4.run_frame(0.0)
            torch.cuda.synchronize()
            if atlas_frame:
                assert raster.K1_LAUNCHES - k1 == eng4.cfg.num_shadow_views, \
                    raster.K1_LAUNCHES - k1
            if eng4.cfg == cfg_before and not atlas_frame:
                break
        else:
            raise AssertionError(f"high-poly capacities did not settle: {eng4.cfg}")
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
    print(f"high-poly world: {tris} triangles, settled after {i + 1} frames: "
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
          f"{bins1.rows.shape[1] * tw1}, scatter bins, max tile "
          f"{int(bins1.overflow)}", flush=True)
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
    print(f"textured demo world 1920x1080: settled after {n_frames} frames: "
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
    if profile:     # the same two frames as engine runs
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
        framelib.check_ported(eng5.cfg)
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
    extra = {"K3": ("textured", "K3 textured"), "K7": ("sprite", "K7 sprite")}
    table_out = []
    for name, (src, replaces, key) in sources.items():
        err = max(v[0] for k, v in results.items() if k.startswith(name))
        _, ms, plain_ms, bound_ms, bound_by = results[key]
        assert launches[name] > 0, f"{name} never launched on a main path"
        entry = {"name": name, "route": "cuda",
                 "source": f"tinyrenderer_tpu_torch/csrc/{src}",
                 "replaces": replaces, "launches": launches[name],
                 "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": bound_ms, "bound_by": bound_by,
                 "library_ms": None}
        if name in extra:
            tag, key2 = extra[name]
            entry[f"{tag}_ms"], entry[f"{tag}_plain_ms"] = results[key2][1:3]
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
