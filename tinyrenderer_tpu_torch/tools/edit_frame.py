"""Edit-frame and steady-frame times of the high-poly scene on one GPU.

An edit re-renders the shadow atlas: the frame after it runs K1 on every
shadow view before the steady work. This tool settles
``build_highpoly_world(9)`` at 1920x1080 (8x128 tiles, pools of 131072),
then times ``--frames`` edit frames (the atlas dropped before each) and as
many steady frames, CUDA events around ``Engine.run_frame``, and prints the
medians. It imports the port from ``--root`` (default: the current
directory), so two checkouts can be timed one after the other on one card::

    python3 tinyrenderer_tpu_torch/tools/edit_frame.py [--root DIR] [--frames N]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.getcwd())
    ap.add_argument("--frames", type=int, default=15)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    if not torch.cuda.is_available():
        print("edit_frame: no CUDA device", file=sys.stderr)
        return 1
    from tinyrenderer_tpu_torch.config import RenderConfig
    from tinyrenderer_tpu_torch.render.engine import Engine
    from tinyrenderer_tpu_torch.scene import demo

    eng = Engine.from_world(
        demo.build_highpoly_world(9), camera=demo.build_demo_camera(1920, 1080),
        device=torch.device("cuda"),
        cfg=RenderConfig(width=1920, height=1080, max_instances=64,
                         max_vertices=131072, max_triangles=131072,
                         bin_capacity=1024, tile_h=8))
    for _ in range(8):                       # the capacities settle in three
        eng.run_frame(0.0)

    def frame_ms(edit: bool) -> float:
        if edit:
            eng._atlas = None
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        eng.run_frame(0.0)
        b.record()
        b.synchronize()
        return a.elapsed_time(b)

    edit, steady = [], []
    for _ in range(args.frames):             # interleaved: one host, one mood
        edit.append(frame_ms(True))
        steady.append(frame_ms(False))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({
        "root": root, "card": card, "frames": args.frames,
        "shadow_bin_capacity": eng.cfg.shadow_bin_capacity,
        "edit_ms_median": statistics.median(edit), "edit_ms_min": min(edit),
        "steady_ms_median": statistics.median(steady),
        "steady_ms_min": min(steady)}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
