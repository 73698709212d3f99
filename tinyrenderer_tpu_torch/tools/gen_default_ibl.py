"""Generate the embedded default IBL (``tinyrenderer_tpu_torch/assets/
default_ibl.npz``): the diffuse irradiance map of the procedural sky,
which the engine loads at startup instead of baking it
(``Engine._load_or_bake_irradiance``).

The procedural sky is resampled to a cube of ``--cube`` texels a face
(256: the irradiance integral has converged there), the cube convolved to
``--size`` texels a face (64), and the map stored as float16 under the key
``irradiance``. Re-run after changing the procedural sky or the bake:

    python -m tinyrenderer_tpu_torch.tools.gen_default_ibl [--device cpu]
        [--out PATH] [--cube 256] [--size 64]

It runs on the CUDA device unless ``--device cpu``; without one the
default exits non-zero and writes nothing.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from ..assets import hdr as hdrlib
from ..ops import env as envops

DEFAULT_OUT = os.path.join(os.path.dirname(hdrlib.__file__),
                           "default_ibl.npz")


def bake(device="cuda", cube: int = 256, size: int = 64) -> np.ndarray:
    """(6, size, size, 3) float16 irradiance of the procedural sky."""
    eq = torch.as_tensor(hdrlib.procedural_sky(), device=device)
    env_cube = envops.equirect_to_cubemap(eq, cube, gamma_decode=False)
    return envops.bake_irradiance(env_cube, size).cpu().numpy().astype(
        np.float16)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="bake the default IBL asset")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="npz to write (default: the port's asset)")
    ap.add_argument("--cube", type=int, default=256,
                    help="environment cube face size")
    ap.add_argument("--size", type=int, default=64,
                    help="irradiance face size")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("gen_default_ibl: no CUDA device; pass --device cpu",
              file=sys.stderr)
        return 1
    irr = bake(args.device, args.cube, args.size)
    np.savez_compressed(args.out, irradiance=irr)
    print(f"wrote {os.path.abspath(args.out)} ({os.path.getsize(args.out)} "
          f"bytes), shape {irr.shape}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
