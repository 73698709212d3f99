"""Headless render CLI:
``python -m tinyrenderer_tpu_torch --level x.lvl --out y.png``.

Renders one frame of a level (or the procedural demo scene) to a PNG, the
screenshot/offline-render path. It renders on the CUDA device unless
``--device cpu`` asks for the CPU; without a CUDA device the default exits
non-zero and writes nothing.
"""

from __future__ import annotations

import argparse
import logging
import sys


def require_device(name: str):
    """The torch device ``name``; exits non-zero when it is a CUDA device
    and there is none (never renders on the CPU in its place)."""
    import torch
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit(f"no CUDA device is available for --device {name} "
                 "(pass --device cpu to render on the CPU)")
    return device


def main() -> None:
    ap = argparse.ArgumentParser(description="render a level to PNG")
    ap.add_argument("--level", default="",
                    help=".lvl file (default: procedural demo scene)")
    ap.add_argument("--out", default="frame.png")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--exposure", type=float, default=1.0)
    ap.add_argument("--tone", type=int, default=1, choices=[0, 1, 2, 3])
    ap.add_argument("--skybox", default="", help="equirect .hdr for the environment")
    ap.add_argument("--stats", action="store_true", help="print frame stats")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default: cuda)")
    args = ap.parse_args()

    logging.basicConfig(level=logging.INFO)
    device = require_device(args.device)

    import os

    from .config import RenderConfig
    from .render import frame as framelib
    from .render.engine import Engine
    from .scene import demo
    from .utils import image_io

    cfg = RenderConfig(width=args.width, height=args.height)
    kwargs = dict(device=device, skybox_path=args.skybox or None)
    if args.level and os.path.exists(args.level):
        eng = Engine(cfg=cfg, level_path=args.level, **kwargs)
    else:
        eng = Engine.from_world(
            demo.build_demo_world(),
            camera=demo.build_demo_camera(args.width, args.height),
            cfg=cfg, **kwargs)
    eng.set_param(framelib.PARAM_EXPOSURE, args.exposure)
    eng.set_param(framelib.PARAM_TONE_TYPE, float(args.tone))

    out = eng.run_frame()
    image_io.save_png(args.out, out.sdr.cpu().numpy())
    print(f"wrote {args.out} ({eng.cfg.width}x{eng.cfg.height}, "
          f"{eng.last_frame_ms:.2f} ms host, {device})")
    if args.stats:
        pick = out.pick_id
        ids = pick.unique()
        print(f"visible objects: {int((ids > 0).sum())}, "
              f"geometry coverage: {(pick > 0).float().mean().item():.1%}, "
              f"triangles: {eng._pack.counts['triangles']}")


if __name__ == "__main__":
    main()
