"""Op-level study of the block-compacted exact sky (the counterpart of the
repository's ``tools/bench_sky_blocks.py``).

First the compacted sky op alone, on a random 256-texel HDR cube (seed 3)
under the default 1920x1080 camera, across the capacity (K = 512 and 2048
blocks of 8x32 pixels), the windowed RGBE display cube against the f32
cube (``sampling.encode_rgbe_windowed``, ``sample_cubemap_rgbe_windowed``,
``sample_cubemap``), and the (K, 8, 32) block shape against (M, 128) rows
of the same pixels. Then the frame's sky, per config, from a mask whose
top quarter is background: the block-compacted exact sky
(``sky_block_capacity=2048``) against the default 1/8-rate sky.

The reference's names map onto the port's so:

- ``envops.skybox_colors_blocks`` is ``ops/env.py``'s of the same name;
- the reference's flat form spelled out the unprojection and the cube tap
  inline: that is ``ops/env.py`` ``_sky_at`` (pixel centres to NDC, the
  inverse projection, the inverse view rotation, the cube sample), which
  the block form calls too;
- ``frame._sky_image(cfg, env, cam, valid, PW, PH)`` (an (H, W, 3) sky and
  the blocks wanted) is ``render/frame.py`` ``_sky_cf(env, cam, cfg,
  valid)``, which takes the padded size from ``cfg`` and returns the sky
  channel-first.

Before anything is timed the forms are checked: a block form and the row
form of the same pixels are equal, and the RGBE forms are within one RGBE
step (the cube's largest texel's mantissa step) of the f32 forms.

    python -m tinyrenderer_tpu_torch.tools.bench_sky_blocks [--device cpu]
        [--rounds 4] [--frames 8] [--pipeline]
"""

from __future__ import annotations

import argparse
import math
from dataclasses import replace

import numpy as np
import torch

from .. import bench
from ..config import RenderConfig
from ..ops import env as envops
from ..ops import sampling
from ..render import frame as framelib
from ..scene.camera import Camera
from . import timing

BH, BW = 8, 32


def sky_inputs(device, S: int = 256, W: int = 1920, H: int = 1080) -> dict:
    """The study's inputs: the cube, its RGBE display cube, the camera."""
    rng = np.random.default_rng(3)
    cube = torch.from_numpy(rng.uniform(0, 4, (6, S, S, 3)).astype(
        np.float32)).to(device)
    cam = framelib._unpack_camera(torch.as_tensor(
        Camera.new_default(W, H).to_raw(), device=device))
    cfg = RenderConfig(width=W, height=H)
    return {"cube": cube, "rgbe": sampling.encode_rgbe_windowed(cube),
            "cam": cam, "PW": cfg.padded_width, "PH": cfg.padded_height}


def rgbe_step(cube: torch.Tensor) -> float:
    """One mantissa step of the cube's largest texel in its RGBE form."""
    return 2.0 ** math.ceil(math.log2(float(cube.max()))) / 255.0


def op_forms(inp: dict, capacities=(512, 2048)) -> dict:
    """{name: fn(cube, rgbe) -> colours}: the block form (K, 8, 32, 3) and
    the row form (M, 128, 3) of the first K blocks of the frame, each from
    the RGBE and the f32 cube."""
    PW, PH = inp["PW"], inp["PH"]
    proj_inv = inp["cam"]["proj_inv"]
    rot = inp["cam"]["view_inv"][:3, :3]
    nbx = PW // BW
    dev = inp["cube"].device

    def blocks(K, use_rgbe):
        slots = torch.arange(K, dtype=torch.int32, device=dev)

        def fn(cube, rgbe):
            return envops.skybox_colors_blocks(
                cube, proj_inv, rot, slots, BH, BW, nbx, PW, PH,
                rgbe_win=rgbe if use_rgbe else None)
        return fn

    def rows(K, use_rgbe):
        pix = torch.arange(K * BH * BW, dtype=torch.int32,
                           device=dev).reshape(-1, 128)
        b, r = pix // (BH * BW), pix % (BH * BW)
        py = ((b // nbx) * BH + r // BW).float() + 0.5
        px = ((b % nbx) * BW + r % BW).float() + 0.5

        def fn(cube, rgbe):
            return envops._sky_at(cube, proj_inv, rot, px, py, PW, PH,
                                  rgbe if use_rgbe else None)
        return fn

    forms = {}
    for K in capacities:
        forms[f"blk_rgbe_K{K}"] = blocks(K, True)
        forms[f"blk_f32_K{K}"] = blocks(K, False)
        forms[f"flat_rgbe_K{K}"] = rows(K, True)
    forms[f"flat_f32_K{capacities[-1]}"] = rows(capacities[-1], False)
    return forms


def check_forms(forms: dict, inp: dict) -> dict:
    """Asserts that the forms agree (module notes); returns the largest
    differences."""
    out = {k: fn(inp["cube"], inp["rgbe"]).reshape(-1, 3)
           for k, fn in forms.items()}
    step = rgbe_step(inp["cube"])
    diffs = {}
    for k, v in out.items():
        if k.startswith("flat_"):
            blk = out.get(k.replace("flat_", "blk_"))
            if blk is not None:
                assert torch.equal(v, blk), f"{k} differs from its block form"
        f32 = out.get(k.replace("_rgbe_", "_f32_"))
        if "_rgbe_" in k and f32 is not None:
            d = float((v - f32).abs().max())
            assert d <= step, f"{k}: {d} over one RGBE step {step}"
            diffs[k] = d
    return {"rgbe_step": step, "max_rgbe_minus_f32": diffs}


def sky_ops(device, rounds: int = 4, frames: int = 8) -> list:
    """The op study's rows: each form checked, then timed round-robin."""
    inp = sky_inputs(device)
    forms = op_forms(inp)
    check = check_forms(forms, inp)
    bodies = {k: timing.capture(lambda c, r, fn=fn: timing.reduce(fn(c, r)),
                                inp["cube"], inp["rgbe"])
              for k, fn in forms.items()}
    rows = []
    for r in timing.summary(timing.round_robin(bodies, rounds, frames,
                                               device)):
        n_px = int(r["name"].split("K")[-1]) * BH * BW
        rows.append({"form": r["name"], "median_ms": r["median_ms"],
                     "pixels": n_px, **check})
    return rows


def sky_image(cfg, env, cam: dict, valid: torch.Tensor):
    """The reference's ``frame._sky_image(cfg, env, cam, valid, PW, PH)``
    on the port: ((PH, PW, 3) sky, () i32 blocks wanted)."""
    sky, needed = framelib._sky_cf(env, cam, cfg, valid)
    return sky.permute(1, 2, 0), needed


def pipeline_configs() -> dict:
    """The frame's sky configurations: the block-compacted exact sky and
    the default 1/8-rate sky."""
    base = RenderConfig(width=1920, height=1080)
    return {"sky_image_compact": replace(base, sky_block_capacity=2048),
            "sky_image_scale8": base}


def sky_pipeline(device, rounds: int = 4, frames: int = 8,
                 configs=None) -> list:
    """The frame's sky (``frame._sky_cf``: plan, block op, scatter, untile;
    or the 1/8-rate pass and its upsample) per config (all of one size),
    on a mask whose top quarter is background."""
    configs = configs or pipeline_configs()
    first = next(iter(configs.values()))
    inp = sky_inputs(device, W=first.width, H=first.height)
    valid = torch.ones((inp["PH"], inp["PW"]), dtype=torch.bool,
                       device=device)
    valid[: inp["PH"] // 4] = False
    bodies = {}
    for name, cfg in configs.items():
        def body(cube, rgbe, valid, cfg=cfg):
            sky, needed = sky_image(
                cfg, framelib.EnvGPU(cube, None, None, rgbe), inp["cam"],
                valid)
            return sky.sum() + needed.float()
        bodies[name] = timing.capture(body, inp["cube"], inp["rgbe"], valid)
    return [{"config": r["name"], "median_ms": r["median_ms"]}
            for r in timing.summary(timing.round_robin(bodies, rounds,
                                                       frames, device))]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--pipeline", action="store_true",
                    help="the frame's sky per config alone")
    args = ap.parse_args(argv)
    dev = timing.require_device(args.device, "bench_sky_blocks")
    print(f"# {bench.device_name(dev)}")
    res = {}
    if not args.pipeline:
        res["ops"] = sky_ops(dev, args.rounds, args.frames)
        print(f"# forms agree: RGBE within {res['ops'][0]['rgbe_step']:.6f} "
              f"of f32 ({res['ops'][0]['max_rgbe_minus_f32']})")
        print("=== medians (ms per eval) ===")
        for r in res["ops"]:
            print(f"{r['form']:18s} {r['median_ms']:8.4f} ms   "
                  f"{r['pixels'] / r['median_ms'] / 1e3:8.0f}K rows/ms")
    res["pipeline"] = sky_pipeline(dev, args.rounds, args.frames)
    for r in res["pipeline"]:
        print(f"{r['config']:20s} {r['median_ms']:8.4f} ms", flush=True)
    return res


if __name__ == "__main__":
    main()
