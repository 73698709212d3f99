"""Render an orbiting-camera turntable (PNG frames and, with ``--gif``, an
animated GIF): the offline-animation analog of the reference's fly-around,
the whole frame pipeline over many camera poses in one process.

Usage (on the CUDA device unless ``--device cpu``; without a CUDA device
the default exits non-zero and writes nothing):

    python -m tinyrenderer_tpu_torch.tools.orbit --level levels/demo.lvl \\
        --frames 24 --out orbit --gif

The first frame is a settled one (``Engine.render`` renders it again
while a capacity grew), so every frame written is right.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time

import numpy as np


def orbit(eng, frames: int, out_dir: str, radius: float = 16.0,
          elevation: float = 8.0, gif: bool = False) -> list:
    """``frames`` engine frames from a camera circling the origin at
    ``radius`` and ``elevation``, written as ``frame_NNNN.png`` into
    ``out_dir`` (and ``orbit.gif`` with ``gif``). Returns the (H, W, 3)
    uint8 frames."""
    from ..utils import image_io

    os.makedirs(out_dir, exist_ok=True)
    images = []
    t0 = time.perf_counter()
    for i in range(frames):
        a = 2.0 * math.pi * i / frames
        eng.camera.position = np.array(
            [radius * math.cos(a), elevation, radius * math.sin(a)],
            np.float32)
        eng.camera.look_at(np.zeros(3, np.float32))
        img = eng.run_frame(1.0 / 30.0).sdr.cpu().numpy()
        image_io.save_png(os.path.join(out_dir, f"frame_{i:04d}.png"), img)
        images.append(img)
        print(f"frame {i + 1}/{frames}", flush=True)
    dt = time.perf_counter() - t0
    print(f"rendered {frames} frames in {dt:.1f} s ({dt / frames * 1e3:.1f} "
          f"ms a frame, host IO included, {eng.device})")
    if gif:
        path = os.path.join(out_dir, "orbit.gif")
        image_io.save_gif(path, images, delay_ms=83)
        print("wrote", path)
    return images


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="render a turntable sequence")
    ap.add_argument("--level", default="levels/demo.lvl",
                    help=".lvl file (the procedural demo scene if missing)")
    ap.add_argument("--out", default="orbit")
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=384)
    ap.add_argument("--radius", type=float, default=16.0)
    ap.add_argument("--elevation", type=float, default=8.0)
    ap.add_argument("--gif", action="store_true", help="also write orbit.gif")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default: cuda)")
    args = ap.parse_args(argv)

    from ..__main__ import require_device
    device = require_device(args.device)

    from ..config import RenderConfig
    from ..render.engine import Engine
    from ..scene import demo

    cfg = RenderConfig(width=args.width, height=args.height)
    if os.path.exists(args.level):
        eng = Engine(cfg=cfg, device=device, level_path=args.level)
    else:
        eng = Engine.from_world(
            demo.build_demo_world(),
            camera=demo.build_demo_camera(args.width, args.height), cfg=cfg,
            device=device)
    orbit(eng, args.frames, args.out, args.radius, args.elevation, args.gif)


if __name__ == "__main__":
    main(sys.argv[1:])
