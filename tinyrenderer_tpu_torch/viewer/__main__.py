"""Entry point: ``python -m tinyrenderer_tpu_torch.viewer``, the main.rs
analog.

Opens the engine on a level (the repository's ``levels/demo.lvl`` by
default; the procedural demo scene when the file is missing) and serves
the interactive editor at http://localhost:8000/. It renders on the CUDA
device unless ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import logging
import os

DEFAULT_LEVEL = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "levels", "demo.lvl")


def main() -> None:
    ap = argparse.ArgumentParser(description="tinyrenderer_tpu_torch viewer")
    ap.add_argument("--level", default=DEFAULT_LEVEL,
                    help=".lvl file to load (falls back to the demo scene)")
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--no-pallas", action="store_true",
                    help="take the reference's kernel-free branches "
                         "(use_pallas=False)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default: cuda)")
    args = ap.parse_args()

    logging.basicConfig(level=logging.INFO)

    from ..__main__ import require_device
    from ..config import RenderConfig
    from ..editor.session import EditorApp
    from ..render.engine import Engine
    from ..scene import demo
    from .server import ViewerServer

    device = require_device(args.device)
    cfg = RenderConfig(width=args.width, height=args.height,
                       use_pallas=not args.no_pallas)
    if os.path.exists(args.level):
        engine = Engine(cfg=cfg, device=device, level_path=args.level)
    else:
        engine = Engine.from_world(
            demo.build_demo_world(),
            camera=demo.build_demo_camera(args.width, args.height), cfg=cfg,
            device=device)

    server = ViewerServer(EditorApp(engine), host=args.host, port=args.port)
    print(f"viewer: http://{args.host}:{server.port}/")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()


if __name__ == "__main__":
    main()
