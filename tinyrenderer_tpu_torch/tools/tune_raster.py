"""Time variants of ``csrc/raster.cu`` side by side on one NVIDIA GPU.

``raster.cu`` takes four thresholds from the command line of ``nvcc``
(``TR_SPLIT_ROWS``, ``TR_FINE_ROWS``, ``TR_DIRECT_ROWS``, ``TR_MIN_BLOCKS``).
This tool builds one library a variant (all ``nvcc`` processes started
together, into the git-ignored ``build/tune/``), captures the bins of K1 at
its three main-path shapes (the main view and a shadow view of
``levels/demo.lvl``, the scatter-binned shadow view of
``build_highpoly_world(9)``) and K4's stream, checks every variant's output
bit-equal to the first one's, and prints each one's time a launch, measured
over runs of launches as ``chip_smoke.py`` measures it. With ``--counts`` it
also prints, for the high-poly shadow view, how many rows survive
``raster.rect_rejects`` at several rectangle sizes, and the pairs covered.

Usage, from the repository root::

    python3 -m tinyrenderer_tpu_torch.tools.tune_raster [--counts]
        [--baseline OLD_RASTER_CU] [name:SPLIT,FINE,DIRECT,MIN_BLOCKS ...]

``--baseline`` names an earlier ``raster.cu`` whose ``tr_raster`` has no
scratch argument (with its ``common.cuh`` beside it). Without variants
it times the defaults against no split, no segments and no direct path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

DEFAULT = (2048, 512, 64, 6)
NEVER = 1 << 30


def _flags(split: int, fine: int, direct: int, min_blocks: int) -> list[str]:
    return [f"-DTR_SPLIT_ROWS={split}", f"-DTR_FINE_ROWS={fine}",
            f"-DTR_DIRECT_ROWS={direct}", f"-DTR_MIN_BLOCKS={min_blocks}"]


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
    argv = [a for a in argv if a != "--counts"]
    baseline = None
    if "--baseline" in argv:
        i = argv.index("--baseline")
        baseline = argv[i + 1]
        del argv[i:i + 2]
    s, f, d, b = DEFAULT
    variants = {"default": DEFAULT, "no_split": (NEVER, f, d, b),
                "no_segments": (s, NEVER, d, b), "no_direct": (s, f, 0, b)}
    if argv:
        variants = {a.split(":")[0]: tuple(map(int, a.split(":")[1].split(",")))
                    for a in argv}
    if not torch.cuda.is_available():
        print("tune_raster: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print("card:", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())

    out_dir = os.path.join(root, "build", "tune")
    os.makedirs(out_dir, exist_ok=True)
    sources = {name: (str(kernels.CSRC / "raster.cu"), _flags(*v))
               for name, v in variants.items()}
    if baseline:
        sources = {"baseline": (baseline, []), **sources}
    procs = {name: subprocess.Popen(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, *flags, "-Xptxas", "-v",
         "-shared", "-o", os.path.join(out_dir, f"{name}.so"), src],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, (src, flags) in sources.items()}

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
        for _ in range(6):                 # the capacities settle in three
            eng._atlas = None
            eng.run_frame(0.0)
    torch.cuda.synchronize()
    settled = (f"K1 {eng.cfg.shadow_tile}x{eng.cfg.shadow_tile} tiles, "
               f"K={eng.cfg.shadow_bin_capacity}")
    shapes["K4"] = captured["K4"]          # the settled frame's
    shapes[settled] = captured[settled]
    captured = shapes

    libs = {}
    for name, p in procs.items():
        _, err = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        print(name, sources[name][1], "|", " | ".join(
            line.split(":")[-1].strip() for line in err.splitlines()
            if "registers" in line))
        lib = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
        sig = list(kernels.SIGNATURES["tr_raster"])
        lib.tr_raster.argtypes = sig[:4] + sig[5:] if name == "baseline" else sig
        lib.tr_raster_stream.argtypes = list(kernels.SIGNATURES["tr_raster_stream"])
        if name != "baseline":
            lib.tr_raster_scratch_bytes.argtypes = [ctypes.c_int] * 4
            lib.tr_raster_scratch_bytes.restype = ctypes.c_longlong
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
        if name == "baseline":
            code = libs[name].tr_raster(*head, *tail)
        else:
            n = libs[name].tr_raster_scratch_bytes(ty * tx, th, tw, K)
            scratch = torch.zeros(-(-n // 8), dtype=torch.int64, device=dev)
            code = libs[name].tr_raster(
                *head, scratch.data_ptr() if n else None, *tail)
        kernels.check("tr_raster", code)
        return tri, z

    def run_k4(name, sb, ty, tx, th, tw, kmax):
        kb, nb = raster.stream_walk(sb.rows.shape[0], kmax)
        tri, z = outputs(ty, tx, th, tw)
        kernels.check("tr_raster_stream", libs[name].tr_raster_stream(
            sb.starts.data_ptr(), sb.rows.data_ptr(), tri.data_ptr(),
            z.data_ptr(), ty * tx, tx, th, tw, kb, nb, tx * tw,
            int(th * tw > raster._VPU_PLANES_MAX_P),
            torch.cuda.current_stream().cuda_stream))
        return tri, z

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

    if counts:
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
