"""Time variants of ``csrc/raster.cu`` side by side on one NVIDIA GPU, and
``csrc/sampling.cu`` (K7) beside the kernel it replaced.

``raster.cu`` takes its thresholds from the command line of ``nvcc``: K1's
and K6's ``TR_SPLIT_ROWS``, ``TR_FINE_ROWS``, ``TR_DIRECT_ROWS`` and
``TR_MIN_BLOCKS``, K4's ``TR_STREAM_SPLIT_ROWS`` and
``TR_STREAM_MIN_BLOCKS``. This tool builds one library a variant (all
``nvcc`` processes started together, into the git-ignored ``build/tune/``),
captures the bins of K1 at its three main-path shapes (the main view and a
shadow view of ``levels/demo.lvl``, the scatter-binned shadow view of
``build_highpoly_world(9)``) and K4's stream, checks every variant's output
bit-equal to the first one's, and prints each one's time a launch, measured
over runs of launches as ``chip_smoke.py`` measures it. For K4 it also
prints how the walked windows' lengths are spread over the tiles. With
``--counts`` it also prints, for K4, the (row, 8-column cell) units, the
pixel columns left in them and the pairs covered, and for the high-poly
shadow view how many rows survive ``raster.rect_rejects`` at several
rectangle sizes, and the pairs covered.

Usage, from the repository root::

    python3 -m tinyrenderer_tpu_torch.tools.tune_raster [--counts] [--k4]
        [--baseline OLD_RASTER_CU] [name:KEY=VALUE,KEY=VALUE ...]
    python3 -m tinyrenderer_tpu_torch.tools.tune_raster --k7
        [--baseline OLD_SAMPLING_CU]

A variant ``name:STREAM_SPLIT_ROWS=1024,STREAM_MIN_BLOCKS=6`` is compiled
with ``-DTR_STREAM_SPLIT_ROWS=1024 -DTR_STREAM_MIN_BLOCKS=6``; ``name:``
alone is the defaults. ``--baseline`` names an earlier ``raster.cu`` whose
``tr_raster_stream`` takes no scratch (with its ``common.cuh`` beside it):
the kernel this one replaced, timed in the same call. ``--k4`` times K4's
shape only. Without variants it times the defaults against K1 without its
split, segments and direct path, and K4 without its split.

``--k7`` times ``sampling.cu`` instead, and with ``--baseline`` an earlier
``sampling.cu`` (the same C interface) beside it: K7's calls of one settled
1920x1080 frame of the textured demo world (the compacted material sample
and the overlay sprite), each checked bit-equal to
``sampling.windowed_blend_ref``, in both output layouts.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

NEVER = 1 << 30
DEFAULT_VARIANTS = {
    "default": {}, "no_split": {"SPLIT_ROWS": NEVER},
    "no_segments": {"FINE_ROWS": NEVER}, "no_direct": {"DIRECT_ROWS": 0},
    "no_stream_split": {"STREAM_SPLIT_ROWS": NEVER}}


def _flags(defines: dict) -> list[str]:
    return [f"-DTR_{key}={value}" for key, value in defines.items()]


def _parse(arg: str) -> tuple[str, dict]:
    name, _, spec = arg.partition(":")
    return name, {k: int(v) for k, v in
                  (item.split("=") for item in spec.split(",") if item)}


def _build(kernels, sources: dict, out_dir: str) -> dict:
    """Compile ``{name: (source, flags)}`` into ``out_dir``, every ``nvcc``
    started together. Returns a function that waits for them and yields
    each (name, loaded library), so the caller can work meanwhile."""
    os.makedirs(out_dir, exist_ok=True)
    procs = {name: subprocess.Popen(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, *flags, "-Xptxas", "-v",
         "-shared", "-o", os.path.join(out_dir, f"{name}.so"), src],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, (src, flags) in sources.items()}

    def load():
        for name, p in procs.items():
            _, err = p.communicate()
            if p.returncode:
                raise RuntimeError(f"nvcc failed for {name}:\n{err}")
            print(name, sources[name][1], "|", " | ".join(
                line.split(":")[-1].strip() for line in err.splitlines()
                if "registers" in line))
            yield name, ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
    return load


def _tune_k7(torch, chip_smoke, kernels, dev, out_dir, baseline) -> int:
    from tinyrenderer_tpu_torch.config import RenderConfig
    from tinyrenderer_tpu_torch.ops import sampling
    from tinyrenderer_tpu_torch.render.engine import Engine
    from tinyrenderer_tpu_torch.scene import demo

    sources = {"k7": (str(kernels.CSRC / "sampling.cu"), [])}
    if baseline:
        sources = {"k7_baseline": (baseline, []), **sources}
    load = _build(kernels, sources, out_dir)

    calls: dict = {}
    inner = sampling.windowed_blend

    def spy(texels, idx, fx, fy, C, channel_first=False):
        calls[f"{idx.shape[0]} taps, C={C}"] = (texels, idx, fx, fy, C)
        return inner(texels, idx, fx, fy, C, channel_first)

    eng = Engine.from_world(
        demo.build_demo_world(n_cubes=24, textured_every=2),
        camera=demo.build_demo_camera(1920, 1080), cfg=RenderConfig(),
        device=dev)
    with chip_smoke._patched(sampling, "windowed_blend", spy):
        eng.run_frame(0.0)                 # settles the capacities
        calls.clear()
        eng.run_frame(0.0)                 # one settled frame's taps
    torch.cuda.synchronize()

    libs = dict(load())
    for lib in libs.values():
        lib.tr_windowed_blend.argtypes = list(
            kernels.SIGNATURES["tr_windowed_blend"])

    def run(name, texels, idx, fx, fy, C, channel_first):
        N = idx.shape[0]
        out = torch.empty((C, N) if channel_first else (N, C),
                          dtype=torch.float32, device=dev)
        kernels.check("tr_windowed_blend", libs[name].tr_windowed_blend(
            texels.data_ptr(), idx.data_ptr(), fx.data_ptr(), fy.data_ptr(),
            out.data_ptr(), texels.shape[0], C, N, int(channel_first),
            torch.cuda.current_stream().cuda_stream))
        return out

    for key, args in calls.items():
        for channel_first in (True, False):
            want = sampling.windowed_blend_ref(*args, channel_first)
            for name in libs:
                fn = lambda: run(name, *args, channel_first)  # noqa: E731
                same = torch.equal(fn(), want)
                ms, n = chip_smoke._launch_run_ms(fn)
                print(f"K7 {key}, channel_first={channel_first}: {name:12s} "
                      f"{ms:.4f} ms a launch over runs of {n}, equal to the "
                      f"plain version: {same}", flush=True)
                assert same, (key, name)
    return 0


def main(argv: list[str]) -> int:
    import torch
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, root)
    import chip_smoke
    from tinyrenderer_tpu_torch import kernels
    from tinyrenderer_tpu_torch.config import RenderConfig
    from tinyrenderer_tpu_torch.ops import raster
    from tinyrenderer_tpu_torch.render.engine import Engine
    from tinyrenderer_tpu_torch.scene import demo

    counts = "--counts" in argv
    k4_only = "--k4" in argv
    k7 = "--k7" in argv
    argv = [a for a in argv if a not in ("--counts", "--k4", "--k7")]
    baseline = None
    if "--baseline" in argv:
        i = argv.index("--baseline")
        baseline = argv[i + 1]
        del argv[i:i + 2]
    variants = dict(map(_parse, argv)) if argv else DEFAULT_VARIANTS
    if not torch.cuda.is_available():
        print("tune_raster: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print("card:", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())

    out_dir = os.path.join(root, "build", "tune")
    if k7:
        return _tune_k7(torch, chip_smoke, kernels, dev, out_dir, baseline)
    sources = {name: (str(kernels.CSRC / "raster.cu"), _flags(v))
               for name, v in variants.items()}
    if baseline:
        sources = {"baseline": (baseline, []), **sources}
    load = _build(kernels, sources, out_dir)

    captured: dict = {}

    def capture(name, key, first=False):
        """Record the arguments of raster.<name> under key(...): the first
        call's of each key, or the last's."""
        inner = getattr(raster, name)

        def fn(*a, **k):
            if not (first and key(*a, **k) in captured):
                captured[key(*a, **k)] = a
            return inner(*a, **k)
        return chip_smoke._patched(raster, name, fn)

    k1_key = lambda bins, th, tw: (  # noqa: E731
        f"K1 {th}x{tw} tiles, K={bins.rows.shape[2]}")
    with capture("rasterize_binned", k1_key, first=True):   # as chip_smoke
        cfg = RenderConfig()
        Engine(cfg=cfg, device=dev, level_path=chip_smoke.LEVEL).run_frame(0.0)
    wanted = {f"K1 {cfg.tile_h}x{cfg.tile_w} tiles, K={cfg.bin_capacity}",
              f"K1 {cfg.shadow_tile}x{cfg.shadow_tile} tiles, "
              f"K={cfg.shadow_bin_capacity}"}
    shapes = {k: v for k, v in captured.items() if k in wanted}
    assert len(shapes) == 2, sorted(captured)
    captured.clear()
    with capture("rasterize_binned", k1_key), \
            capture("rasterize_stream", lambda *a, **k: "K4"):
        eng = Engine.from_world(
            demo.build_highpoly_world(9),
            camera=demo.build_demo_camera(1920, 1080), device=dev,
            cfg=RenderConfig(width=1920, height=1080, max_instances=64,
                             max_vertices=131072, max_triangles=131072,
                             bin_capacity=1024, tile_h=8))
        eng.run_frame(0.0)                 # settles the capacities
        eng._atlas = None                  # the settled atlas, captured last
        eng.run_frame(0.0)
    torch.cuda.synchronize()
    settled = (f"K1 {eng.cfg.shadow_tile}x{eng.cfg.shadow_tile} tiles, "
               f"K={eng.cfg.shadow_bin_capacity}")
    shapes["K4"] = captured["K4"]          # the settled frame's
    shapes[settled] = captured[settled]
    captured = shapes

    libs = {}
    for name, lib in load():
        lib.tr_raster.argtypes = list(kernels.SIGNATURES["tr_raster"])
        lib.tr_raster_scratch_bytes.argtypes = [ctypes.c_int] * 4
        lib.tr_raster_scratch_bytes.restype = ctypes.c_longlong
        sig = list(kernels.SIGNATURES["tr_raster_stream"])
        if name == "baseline":     # no scratch and no Ls
            sig = sig[:4] + sig[5:11] + sig[12:]
        else:
            lib.tr_raster_stream_scratch_bytes.argtypes = [ctypes.c_int] * 4
            lib.tr_raster_stream_scratch_bytes.restype = ctypes.c_longlong
        lib.tr_raster_stream.argtypes = sig
        libs[name] = lib

    def outputs(ty, tx, th, tw):
        shape = (ty * th, tx * tw)
        return (torch.empty(shape, dtype=torch.int32, device=dev),
                torch.empty(shape, dtype=torch.float32, device=dev))

    def run_k1(name, bins, th, tw):
        ty, tx, K, _ = bins.rows.shape
        tri, z = outputs(ty, tx, th, tw)
        stream = torch.cuda.current_stream().cuda_stream
        head = (bins.counts.data_ptr(), bins.rows.data_ptr(), tri.data_ptr(),
                z.data_ptr())
        tail = (ty * tx, tx, th, tw, K, tx * tw,
                int(th * tw > raster._VPU_PLANES_MAX_P), stream)
        n = libs[name].tr_raster_scratch_bytes(ty * tx, th, tw, K)
        scratch = torch.zeros(-(-n // 8), dtype=torch.int64, device=dev)
        code = libs[name].tr_raster(
            *head, scratch.data_ptr() if n else None, *tail)
        kernels.check("tr_raster", code)
        return tri, z

    def run_k4(name, sb, ty, tx, th, tw, kmax):
        Ls = sb.rows.shape[0]
        kb, nb = raster.stream_walk(Ls, kmax)
        tri, z = outputs(ty, tx, th, tw)
        lib = libs[name]
        head = (sb.starts.data_ptr(), sb.rows.data_ptr(), tri.data_ptr(),
                z.data_ptr())
        tail = (tx * tw, int(th * tw > raster._VPU_PLANES_MAX_P),
                torch.cuda.current_stream().cuda_stream)
        if name == "baseline":
            code = lib.tr_raster_stream(*head, ty * tx, tx, th, tw, kb, nb,
                                        *tail)
        else:                      # as raster.rasterize_stream
            n = lib.tr_raster_stream_scratch_bytes(ty * tx, th, tw, Ls)
            scratch = torch.empty(-(-n // 8), dtype=torch.int64, device=dev)
            code = lib.tr_raster_stream(*head, scratch.data_ptr(), ty * tx, tx,
                                        th, tw, kb, nb, Ls, *tail)
        kernels.check("tr_raster_stream", code)
        return tri, z

    sb, ty, tx, th, tw, kmax = captured["K4"]
    start, stop = raster.walked_windows(sb.starts, sb.rows.shape[0], kmax)
    lens = (stop - start).clamp(min=0).float()
    print(f"K4 windows: {int(lens.sum())} rows over {lens.numel()} tiles, "
          f"longest {int(lens.max())}, quantiles 50/90/99% "
          f"{[int(lens.quantile(q)) for q in (0.5, 0.9, 0.99)]}, over 512 rows "
          f"{int((lens > 512).sum())}, empty {int((lens == 0).sum())}")
    if counts:           # the tile is one 8-row sub-tile of the kernel
        walked, tile = raster.walked_rows(sb, lens.numel(), kmax)
        rows, tile = sb.rows[walked], tile[walked]
        cx = torch.arange(0, tw, 8, device=dev)[None, :]
        kept = ~raster.rect_rejects(
            rows[:, None, :], (tile % tx)[:, None] * tw + cx,
            (tile // tx)[:, None] * th, 8, th,
            th * tw > raster._VPU_PLANES_MAX_P)              # (N, tw / 8)
        per_row = kept.sum(1)
        columns = ~raster.rect_rejects(
            rows[:, None, :],
            (tile % tx)[:, None] * tw + torch.arange(tw, device=dev)[None, :],
            (tile // tx)[:, None] * th, 1, th,
            th * tw > raster._VPU_PLANES_MAX_P)              # (N, tw)
        per_cell = columns.reshape(len(rows), -1, 8).sum(2)[kept]
        print(f"K4 rows by the 8-column cells they are left in: "
              f"{torch.bincount(per_row, minlength=6)[:6].tolist()} (0..5), "
              f"more {int((per_row > 5).sum())}; {int(kept.sum())} (row, cell) "
              f"pairs, by the columns left in them "
              f"{torch.bincount(per_cell, minlength=9).tolist()} (0..8); "
              f"{int(columns.sum())} (row, column) pairs, "
              f"{raster.covered_pairs(rows, tile, tx, th, tw)} (row, pixel) "
              f"pairs covered")
    if k4_only:
        captured = {"K4": captured["K4"]}

    for key, args in captured.items():
        first = None
        for name in libs:
            fn = ((lambda: run_k4(name, *args)) if key == "K4"
                  else (lambda: run_k1(name, *args)))
            out = fn()
            torch.cuda.synchronize()
            first = first or out
            same = all(torch.equal(a, b) for a, b in zip(out, first))
            ms, n = chip_smoke._launch_run_ms(fn)
            print(f"{key:32s} {name:16s} {ms:.4f} ms a launch over runs of "
                  f"{n}, equal to the first: {same}", flush=True)
            assert same, (key, name)

    if counts and not k4_only:
        bins, th, tw = captured[settled]
        rows, tile = raster.live_rows(bins)
        tx = bins.rows.shape[1]
        per_tile = torch.bincount(tile, minlength=bins.counts.numel())
        t = int(per_tile.argmax())
        rows = rows[tile == t]
        ox, oy = (t % tx) * tw, (t // tx) * th
        print(f"heaviest tile {t}: {rows.shape[0]} rows of {int(per_tile.sum())}"
              f", covered pairs {raster.covered_pairs(rows, tile[tile == t], tx, th, tw)}")
        for rh, rw in ((32, 32), (16, 16), (8, 32), (8, 8), (4, 4), (2, 2),
                       (1, 32), (1, 8), (1, 1)):
            iy = torch.arange(0, th, rh, device=dev)[:, None]
            ix = torch.arange(0, tw, rw, device=dev)[None, :]
            kept = (~raster.rect_rejects(rows[:, None, None, :], ox + ix,
                                         oy + iy, rw, rh,
                                         th * tw > raster._VPU_PLANES_MAX_P)
                    ).sum(0)
            print(f"rectangles of {rh}x{rw}: {int(kept.sum())} (row, rectangle)"
                  f" pairs survive, at most {int(kept.max())} a rectangle")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
