#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

Builds the three hand-written kernels from ``tinyrenderer_tpu_torch/csrc``
and runs, each phase asserting or letting its exception propagate:

1. every kernel against its plain PyTorch version, at the shapes the
   1080p frame gives it (captured from one frame of ``levels/demo.lvl``),
   with the times of both (median of 20 CUDA-event runs);
2. the engine path at 1920x1080: ``Engine.run_frame`` ten times on the
   directional-light demo world, with the kernels' launch counters reset
   just before and read just after;
3. the point + directional frame of ``levels/demo.lvl`` (overlay off) through
   the kernels and again through the plain versions: equal pick ids and a
   passing edge-aware image comparison.

Usage: ``python3 chip_smoke.py`` from the repository root (one CUDA device;
exits non-zero without a result line when there is none). The last line
of standard output is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
LEVEL = os.path.join(ROOT, "levels", "demo.lvl")
REPS = 20


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


@contextlib.contextmanager
def _patched(module, name: str, fn):
    old = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, old)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from tinyrenderer_tpu_torch import kernels
    from tinyrenderer_tpu_torch.ops import raster, resolve, shading
    from tinyrenderer_tpu_torch.render import frame as framelib
    from tinyrenderer_tpu_torch.render.engine import Engine
    from tinyrenderer_tpu_torch.shared import RenderConfig, demo, verify

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

    def render3():
        return framelib.render_frame(eng3._pack.scene, eng3._pack.lights,
                                     cam3, eng3.params, env3, cfg3)

    with capture(raster, "rasterize_binned",
                 lambda bins, th, tw: f"K1 {th}x{tw} tiles"), \
            capture(resolve, "select_eval", lambda *a, **k: "K2"), \
            capture(resolve, "build_gbuffer_table", lambda *a, **k: "table"), \
            capture(shading, "shade_deferred_fused", lambda *a, **k: "K3"):
        render3()
    torch.cuda.synchronize()

    results = {}

    def compare(name, kernel_fn, plain_fn, check):
        out_k, out_p = kernel_fn(), plain_fn()
        torch.cuda.synchronize()
        err = check(out_k, out_p)
        ms, plain_ms = _median_ms(kernel_fn), _median_ms(plain_fn)
        print(f"{name}: max_abs_err {err:.3g}, kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms", flush=True)
        results[name] = (err, ms, plain_ms)

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
                raster_check)

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
                lambda: resolve.select_eval_ref(tri_id, tab, **kw), eval_check)

    (tid, outf, outh, gates, sky, campos, slights, P, D, irr), _ = \
        captured["K3"]
    consts = shading.pack_shading_consts(campos, slights, P, D, irr)

    def shade_check(a, b):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
        assert torch.isfinite(a).all()
        return (a - b).abs().max().item()

    compare("K3", lambda: shading.shade_deferred_fused(
                tid, outf, outh, gates, sky, campos, slights, P, D, irr),
            lambda: shading.shade_fused_ref(tid, outf, outh, gates, sky,
                                            consts, P, D, irr is not None),
            shade_check)
    assert (P, D) == (1, 1) and irr is not None and sky is not None

    # ---- phase 2: the engine path, 10 frames at 1920x1080 ---------------
    eng = Engine.from_world(
        demo.build_demo_world(n_cubes=24, with_point_light=False),
        camera=demo.build_demo_camera(1920, 1080), cfg=RenderConfig(),
        device=dev)
    eng.update()
    eng._ensure_env()
    assert framelib.use_fused_shading(eng.cfg), "fused path not taken"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    raster.K1_LAUNCHES = resolve.K2_LAUNCHES = shading.K3_LAUNCHES = 0
    frame_ms, per_frame = [], []
    for i in range(10):
        before = (raster.K1_LAUNCHES, resolve.K2_LAUNCHES,
                  shading.K3_LAUNCHES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = eng.run_frame(0.0)
        b.record()
        b.synchronize()
        frame_ms.append(a.elapsed_time(b))
        per_frame.append(tuple(n - m for n, m in zip(
            (raster.K1_LAUNCHES, resolve.K2_LAUNCHES, shading.K3_LAUNCHES),
            before)))
    launches = {"K1": raster.K1_LAUNCHES, "K2": resolve.K2_LAUNCHES,
                "K3": shading.K3_LAUNCHES}
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
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
    def shade_plain(tid, outf, outh, gates, sky, campos, slights, P, D, irr):
        return shading.shade_fused_ref(
            tid, outf, outh, gates, sky,
            shading.pack_shading_consts(campos, slights, P, D, irr), P, D,
            irr is not None)

    n_before = raster.K1_LAUNCHES
    fast = render3()
    torch.cuda.synchronize()
    assert raster.K1_LAUNCHES - n_before == 1 + cfg3.num_shadow_views
    with _patched(raster, "rasterize_binned",
                  lambda bins, th, tw: raster.rasterize_binned_ref(
                      bins, th, tw, chunk=16)), \
            _patched(resolve, "select_eval", resolve.select_eval_ref), \
            _patched(shading, "shade_deferred_fused", shade_plain):
        plain = render3()
    torch.cuda.synchronize()
    assert torch.equal(fast.pick_id, plain.pick_id), "phase 3 pick ids differ"
    res = verify.edge_aware_compare(fast.sdr.cpu().numpy(),
                                    plain.sdr.cpu().numpy(),
                                    pick=plain.pick_id.cpu().numpy())
    assert res["status"] == "pass", res
    print(f"demo.lvl 1920x1080, P=1 D=1, {cfg3.num_shadow_views} shadow views:"
          f" pick ids equal, edge-aware compare {res}", flush=True)

    sources = {"K1": ("raster.cu", "tinyrenderer_tpu/ops/raster.py:557",
                      "K1 64x128 tiles"),
               "K2": ("select_eval.cu", "tinyrenderer_tpu/ops/resolve.py:408",
                      "K2 slim"),
               "K3": ("shade.cu", "tinyrenderer_tpu/ops/shading.py:208", "K3")}
    table_out = []
    for name, (src, replaces, key) in sources.items():
        err = max(v[0] for k, v in results.items() if k.startswith(name))
        _, ms, plain_ms = results[key]
        table_out.append({"name": name, "route": "cuda",
                          "source": f"tinyrenderer_tpu_torch/csrc/{src}",
                          "replaces": replaces, "launches": launches[name],
                          "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    print(json.dumps({"kernels": table_out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
