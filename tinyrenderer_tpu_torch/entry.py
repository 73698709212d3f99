"""The single-card entry (port of ``__graft_entry__.entry``): the whole
deferred-PBR frame function with its example arguments, at a small config.

``fn, args = entry()`` builds and packs an engine, drains its queued
rendering actions and bakes its environment, then returns ``fn(scene,
pool, lights, camera_raw, params)`` over :func:`render_frame` (the shadow
atlas rendered inline, as the reference's jitted function does) and the
engine's own arguments. A caller times or captures ``fn(*args)`` as one
unit; on the card it launches K1 (main view and shadow views), K2 and K3.

The entry runs on the card unless the caller passes another device. It
takes a level path, or renders ``scene.demo.build_demo_world()`` under the
default camera, as the reference does when it finds no level.

    python -m tinyrenderer_tpu_torch.entry [--device cpu] [--level PATH]
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

import torch

from .config import RenderConfig
from .render import frame as framelib
from .render.engine import Engine
from .scene import demo


def small_config() -> RenderConfig:
    """The reference entry's config: 256x128 with 16x128 tiles, a 128-texel
    shadow atlas and 64-texel pool, SSR off."""
    return RenderConfig(
        width=256, height=128, tile_h=16, tile_w=128, bin_capacity=128,
        shadow_size=128, shadow_tile=128, shadow_bin_capacity=128,
        env_size=32, irradiance_size=8, texture_size=64, mip_levels=4,
        max_vertices=4096, max_triangles=2048, max_instances=64,
        enable_ssr=False,
    )


def entry(device="cuda", level_path: Optional[str] = None):
    """(fn, args): ``fn(*args)`` renders one frame of the packed engine
    (a :class:`frame.FrameOutput`)."""
    if level_path is not None:
        eng = Engine(cfg=small_config(), device=device, level_path=level_path)
    else:
        eng = Engine.from_world(demo.build_demo_world(), cfg=small_config(),
                                device=device)
    eng.update(0.0)
    eng._drain_actions()
    env = eng._ensure_env()
    cfg = eng.cfg  # may have grown during packing

    def fn(scene, pool, lights, camera_raw, params):
        return framelib.render_frame(scene, pool, lights, camera_raw, params,
                                     env, cfg)

    args = (eng._pack.scene, eng._packer.pool_for(cfg, eng.device),
            eng._pack.lights,
            torch.as_tensor(eng.camera.to_raw(), device=eng.device),
            eng.params)
    return fn, args


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    ap.add_argument("--level", default=None,
                    help=".lvl file (default: the procedural demo world)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("entry: no CUDA device; pass --device cpu", file=sys.stderr)
        return 1
    fn, fargs = entry(args.device, args.level)
    out = fn(*fargs)
    print(f"entry: sdr {tuple(out.sdr.shape)}, "
          f"{len(torch.unique(out.pick_id))} pick ids")
    return 0


if __name__ == "__main__":
    sys.exit(main())
