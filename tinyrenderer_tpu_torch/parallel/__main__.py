"""One step of the multi-device frame over ``--ranks`` processes (the port of
``__graft_entry__.py``'s ``dryrun_multichip``).

    python -m tinyrenderer_tpu_torch.parallel --ranks 4 --backend gloo
    python -m tinyrenderer_tpu_torch.parallel --ranks 4 --dp 2 \\
        --backend gloo --device cpu

The dryrun configuration (256x128, the demo world) turns on the paths whose
sharded form carries collectives: SSR at strength 1 (the tap buffers'
all-gathers) and the stream raster, its triangle pool padded above 4096 so
that the stream is the path taken; then the fused-shading step, SSR off.
Each step asserts the frame's shape on every rank. The backend is an
argument (``nccl``: one card a rank; ``gloo``: ranks may share a card), and
the ranks run on the card unless ``--device cpu`` asks for the host;
nothing queries a device before both are set.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys


def dryrun_config():
    from ..config import RenderConfig
    return RenderConfig(
        width=256, height=128, tile_h=16, tile_w=128, bin_capacity=128,
        shadow_size=128, shadow_tile=128, shadow_bin_capacity=128,
        env_size=32, irradiance_size=8, texture_size=64, mip_levels=4,
        max_vertices=8192, max_triangles=8192, max_instances=64,
        enable_ssr=True, use_pallas=True, stream_raster=True)


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog="python -m tinyrenderer_tpu_torch"
                                      ".parallel", description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--dp", type=int, default=None,
                    help="rows of the grid (default: 2 for an even number "
                         "of ranks from 4, else 1)")
    ap.add_argument("--backend", choices=("gloo", "nccl"), required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    dp = args.dp or (2 if args.ranks % 2 == 0 and args.ranks >= 4 else 1)
    if args.ranks % dp:
        ap.error(f"--ranks {args.ranks} is not a multiple of --dp {dp}")

    from ..ops import raster
    from ..render import frame as framelib
    from . import jobs, sharded
    from .launch import launch

    # the configuration, packed on the host: the ranks pack their own
    eng = jobs.make_engine(("demo", {}), dryrun_config(), "cpu")
    cfg = sharded.sharded_config(eng.cfg, args.ranks // dp)
    pool = eng._pack.scene.tri_vidx.shape[0]
    if not raster.stream_pays_off(pool):
        raise AssertionError(f"triangle pool {pool} is below the stream "
                             "crossover: the stream path would not run")
    cfg_f = dataclasses.replace(cfg, enable_ssr=False)
    if not framelib.use_fused_shading(cfg_f):
        raise AssertionError("the second step must take fused shading")
    steps = {"ssr_stream": (cfg, {framelib.PARAM_SSR_STRENGTH: 1.0}),
             "fused_shading": (cfg_f, {})}
    job = dict(device=args.device, backend=args.backend, worlds=[dict(
        world=("demo", {}), cfg=dataclasses.asdict(eng.cfg),
        cases=[dict(name=k, cfg=dataclasses.asdict(c), dp=dp, params=p)
               for k, (c, p) in steps.items()])])
    results = launch(jobs.frame_job, args.ranks, args.backend, args.device,
                     job)
    for i, name in enumerate(steps):
        c = steps[name][0]
        out = results[0][i]["out"]
        want = (dp, c.height, c.width, 3)
        if out["sdr"].shape != want or out["hdr"].shape != want:
            raise AssertionError(f"{name}: frame {out['sdr'].shape}, "
                                 f"want {want}")
        if len({r[i]["digest"] for r in results}) != 1:
            raise AssertionError(f"{name}: the ranks hold different frames")
        launches = {k: sum(r[i]["launches"][k] for r in results)
                    for k in results[0][i]["launches"]}
        print(json.dumps({"step": name, "ranks": args.ranks, "dp": dp,
                          "sp": args.ranks // dp, "backend": args.backend,
                          "device": args.device, "frame": list(want),
                          "launches": launches}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
