"""Fidelity report: image deltas between ``reference_parity()`` (trilinear,
full-rate lookups, the native-size texture pool: the reference's exact
sampling) and the default, the presets and the single levers between them,
on one scene.

Prints a markdown table: PSNR over the tone-mapped SDR frame, and the share
of pixels with any channel more than 1 and more than 4 LSB off
``reference_parity``; with ``--time``, the ms a frame of each
configuration beside it. Each engine's first frame is a settled one
(``Engine.run_frame`` renders it again while a capacity grew).

    python -m tinyrenderer_tpu_torch.tools.fidelity_report [--device cpu]
        [--level levels/demo.lvl | --world textured] [--width 1920]
        [--height 1080] [--only default,fidelity_preset]
        [--time ROUNDS --frames N] [--save-dir DIR]

``--world textured`` renders ``build_demo_world(n_cubes=24,
textured_every=2)``: ``levels/demo.lvl`` is flat, so there the texture
levers read "exact". ``--time`` settles each configuration's engine and
captures its steady frame as a body of its own (``tools/timing.py``), kept
for the whole run, then runs, for ``ROUNDS`` rounds, a loop of ``N`` calls
of each body in turn (round-robin), with one synchronize at the end of
each loop and CUDA events around it (the host clock on the CPU), and
reports each configuration's median.

It runs on the CUDA device unless ``--device cpu``; without one the
default exits non-zero and renders nothing. ``main(argv)`` returns the
rows (with each configuration's SDR frame) for callers in-process.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
from dataclasses import replace
from typing import Optional

import numpy as np
import torch

from .. import bench
from ..config import RenderConfig
from ..render.engine import Engine
from ..scene import demo
from . import timing
from .profile_frame import frame_body

BASELINE = "reference_parity"


def configurations(base: RenderConfig) -> dict:
    """The report's configurations by name, derived from ``base``."""
    perf = base.performance_preset()
    return {
        "reference_parity": base.reference_parity(),
        "default": base,
        "default_f32_attrs": replace(base, bf16_attrs=False),
        "default_shadow8": replace(base, shadow_lookup_scale=8),
        "default_shadow8_sky8": replace(base, shadow_lookup_scale=8,
                                        sky_scale=8),
        "default_texscale2": replace(base, texture_scale=2),
        # which lever pays for the default's > 1 LSB pixels
        "default_trilinear": replace(base, texture_filter="trilinear"),
        "default_sky1": replace(base, sky_scale=1),
        "default_sky4": replace(base, sky_scale=4),
        "default_shadow4": replace(base, shadow_lookup_scale=4),
        "default_f32_atlas": replace(base, shadow_bf16=False),
        "default_trilinear_sky4": replace(base, texture_filter="trilinear",
                                          sky_scale=4),
        "default_skybilinear": replace(base, sky_upsample="bilinear"),
        "default_sky4_cubic": replace(base, sky_scale=4),
        "default_skyblk": replace(base, sky_block_capacity=2048),
        "default_skyblk_trilinear": replace(base, sky_block_capacity=2048,
                                            texture_filter="trilinear"),
        "default_75pct": replace(base, render_scale_pct=75),
        "fidelity_preset": base.fidelity_preset(),
        "performance_preset": perf,
        "preset_75pct": replace(perf, render_scale_pct=75),
    }


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    """PSNR in dB of two uint8 images (inf when equal)."""
    mse = ((a.astype(np.float64) - b.astype(np.float64)) ** 2).mean()
    return float("inf") if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)


def compare_row(name: str, img: np.ndarray, ref: np.ndarray) -> dict:
    """PSNR and the percentage of pixels with any channel more than 1 and
    more than 4 LSB off ``ref``."""
    d = np.abs(img.astype(np.int16) - ref.astype(np.int16)).max(axis=-1)
    return {"config": name, "psnr_db": psnr(img, ref),
            "over_1_lsb_pct": 100.0 * float((d > 1).mean()),
            "over_4_lsb_pct": 100.0 * float((d > 4).mean())}


def table(rows: list) -> list:
    """The report's markdown lines."""
    timed = any(r.get("ms_per_frame") is not None for r in rows)
    lines = ["| config | PSNR (dB) | % pixels >1 LSB | % pixels >4 LSB |"
             + (" ms/frame |" if timed else ""),
             "|---|---|---|---|" + ("---|" if timed else "")]
    for r in rows:
        p = r["psnr_db"]
        lines.append(
            f"| {r['config']} | {'exact' if p == float('inf') else f'{p:.1f}'}"
            f" | {r['over_1_lsb_pct']:.2f}% | {r['over_4_lsb_pct']:.2f}% |"
            + (f" {r['ms_per_frame']:.2f} |" if timed else ""))
    return lines


def frame_bodies(engines: dict) -> dict:
    """Each engine settled and its steady frame captured as a body of its
    own, kept for the whole run, as the reference's tool keeps a jitted
    frame loop an engine. Not ``Engine.run_frame``: it looks its graph up
    in ``frame.compiled_frame``'s cache of 8 configurations, and a grid of
    more evicted each one before its turn came back, so every timed loop
    captured its frame again."""
    bodies = {}
    for name, eng in engines.items():
        bench.settle(eng)
        scene, pool, lights, params, env, atlas = timing.frame_args(eng)
        bodies[name] = frame_body(timing.camera(eng), scene, pool, lights,
                                  params, env, atlas, eng.cfg)
    return bodies


def time_engines(engines: dict, rounds: int, frames: int) -> dict:
    """{name: [ms a frame, one a round]} of each engine's body
    (:func:`frame_bodies`) over ``rounds`` round-robin loops of ``frames``
    (after one untimed loop each)."""
    device = next(iter(engines.values())).device
    return timing.round_robin(frame_bodies(engines), rounds, frames, device)


def make_engine(cfg: RenderConfig, device, world: str,
                level: str) -> Engine:
    if world == "textured":
        return Engine.from_world(
            demo.build_demo_world(n_cubes=24, textured_every=2),
            camera=demo.build_demo_camera(cfg.width, cfg.height), cfg=cfg,
            device=device)
    return Engine(cfg=cfg, device=device, level_path=level)


def main(argv: Optional[list] = None,
         base: Optional[RenderConfig] = None) -> list:
    """Render, compare and print the report; returns its rows (dicts with
    ``config``, ``psnr_db``, ``over_1_lsb_pct``, ``over_4_lsb_pct``,
    ``ms_per_frame`` (the median of ``ms_rounds``, each round's; None
    without ``--time``) and ``sdr``, the frame).
    ``base``: the envelope the configurations derive from (default
    ``RenderConfig()``), at ``--width`` x ``--height``."""
    ap = argparse.ArgumentParser(description="fidelity report against "
                                             "reference_parity()")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    ap.add_argument("--level", default="levels/demo.lvl",
                    help=".lvl file rendered by --world level")
    ap.add_argument("--world", choices=("level", "textured"),
                    default="level",
                    help="the level, or the textured demo world")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--save-dir", default="",
                    help="also write each configuration's PNG here")
    ap.add_argument("--time", type=int, default=0, metavar="ROUNDS",
                    help="also time each configuration, ROUNDS rounds")
    ap.add_argument("--frames", type=int, default=8,
                    help="frames a timed loop")
    ap.add_argument("--only", default="",
                    help="comma-separated configuration names "
                         "(reference_parity is always kept)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("fidelity_report: no CUDA device; pass --device cpu",
              file=sys.stderr)
        raise SystemExit(1)

    base = replace(base or RenderConfig(), width=args.width,
                   height=args.height)
    configs = configurations(base)
    if args.only:
        keep = set(args.only.split(",")) | {BASELINE}
        unknown = keep - set(configs)
        if unknown:
            raise SystemExit(f"fidelity_report: unknown configurations "
                             f"{sorted(unknown)}")
        configs = {k: v for k, v in configs.items() if k in keep}

    frames, engines = {}, {}
    for name, cfg in configs.items():
        eng = make_engine(cfg, args.device, args.world, args.level)
        frames[name] = eng.run_frame(0.0).sdr.cpu().numpy()
        engines[name] = eng
        if args.save_dir:
            from ..utils import image_io
            os.makedirs(args.save_dir, exist_ok=True)
            image_io.save_png(os.path.join(args.save_dir, f"{name}.png"),
                              frames[name])
        print(f"# rendered {name}", file=sys.stderr)

    times = time_engines(engines, args.time, args.frames) if args.time else {}
    rows = []
    for name, img in frames.items():
        row = compare_row(name, img, frames[BASELINE])
        ms = times.get(name)
        rows.append({**row, "ms_per_frame": None if ms is None else
                     statistics.median(ms),
                     "ms_rounds": ms, "sdr": img})
    print("\n".join(table(rows)))
    return rows


if __name__ == "__main__":
    main()
