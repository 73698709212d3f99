"""A/B of the two binners on the card (the counterpart of the repository's
``tools/bench_binning.py``): ``raster.bin_triangles_dense`` against
``raster.bin_triangles_scatter`` on the 1080p grid of 64x128 tiles, on the
reference's two synthetic pools: 600 triangles padded to T=2048 (the
test.lvl-sized pool, K=256) and 108000 small triangles padded to
T=131072 (the high-poly pool, K=1024), made from seed 3 as the reference
makes them.

Before they are timed the two bins must agree: equal counts and overflow,
and in every tile under its capacity the same triangle ids (a tile over it
keeps a different K: the dense binner the smallest ids, the scatter binner
its big triangles first). The scatter binner's big-triangle list is sized
to the pool's big triangles (at least the default 512): a list below that
drops triangles, which the engine's monitor would grow.

    python -m tinyrenderer_tpu_torch.tools.bench_binning [--device cpu]
        [--rounds 3] [--frames 30]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import bench
from ..ops import raster
from . import timing

# label, T, real triangles, W, H, tile_h, tile_w, K
CASES = (("test.lvl-ish", 2048, 600, 1920, 1088, 64, 128, 256),
         ("high-poly", 131072, 108000, 1920, 1088, 64, 128, 1024))
BIG_CAPACITY = 512


def make_setups(device, cases=CASES, seed: int = 3) -> list:
    """(case, TriangleSetup) for each case: the reference's random
    triangles, drawn in its order from one generator (seed 3)."""
    rng = np.random.default_rng(seed)
    out = []
    for case in cases:
        _label, T, n_real, W, H = case[:5]
        ndc = rng.uniform(-1.05, 1.05, size=(n_real, 3, 3)).astype(np.float32)
        # mostly small triangles: shrink each around its centroid
        c = ndc.mean(axis=1, keepdims=True)
        ndc = c + (ndc - c) * (0.06 if T > 4096 else 0.25)
        ndc[..., 2] = rng.uniform(0.05, 0.95, size=(n_real, 3))
        verts = ndc.reshape(-1, 3)
        clip = np.concatenate([verts, np.ones((verts.shape[0], 1),
                                              np.float32)], axis=1)
        tri = np.arange(n_real * 3, dtype=np.int32).reshape(-1, 3)
        tri = np.pad(tri, ((0, T - n_real), (0, 0)))
        mask = np.zeros(T, bool)
        mask[:n_real] = True
        clip, tri, mask = (torch.from_numpy(a).to(device)
                           for a in (clip, tri, mask))
        setup = raster.triangle_setup(clip, tri, mask, W, H, "none")
        out.append((case, setup))
    return out


def big_capacity(setup, case) -> int:
    """The scatter binner's big list: the default, or the next power of
    two over the pool's big triangles where the default drops some."""
    _label, _T, _n, W, H, th, tw, K = case
    need = int(raster.bin_triangles_scatter(setup, W, H, th, tw, K,
                                            BIG_CAPACITY).big_overflow)
    return max(BIG_CAPACITY, 1 << max(need - 1, 0).bit_length())


def binners(case, big_cap: int) -> dict:
    """{name: fn(setup) -> Bins} of the two binners."""
    _label, _T, _n, W, H, th, tw, K = case
    return {"dense": lambda s: raster.bin_triangles_dense(s, W, H, th, tw, K),
            "scatter": lambda s: raster.bin_triangles_scatter(
                s, W, H, th, tw, K, big_cap)}


def agreement(dense, scatter, K: int) -> dict:
    """Where the two bins agree (see the module notes): asserts it, and
    returns the tiles compared and those over capacity."""
    assert torch.equal(dense.counts, scatter.counts), "counts differ"
    assert int(dense.overflow) == int(scatter.overflow), "overflow differs"
    under = dense.counts < K
    a = torch.sort(dense.ids, dim=-1).values[under]
    b = torch.sort(scatter.ids, dim=-1).values[under]
    assert torch.equal(a, b), "the ids of a tile under capacity differ"
    return {"tiles_compared": int(under.sum()),
            "tiles_at_capacity": int((~under).sum()),
            "max_tile": int(dense.overflow)}


def bench_binning(device, rounds: int = 3, frames: int = 30,
                  cases=CASES) -> list:
    """A row a case: both binners checked, then timed round-robin."""
    rows = []
    for case, setup in make_setups(device, cases):
        label, T, K = case[0], case[1], case[7]
        big_cap = big_capacity(setup, case)
        fns = binners(case, big_cap)
        agree = agreement(fns["dense"](setup), fns["scatter"](setup), K)
        bodies = {name: timing.capture(
            lambda s, fn=fn: timing.reduce(fn(s)), setup)
            for name, fn in fns.items()}
        ms = {r["name"]: r["median_ms"] for r in timing.summary(
            timing.round_robin(bodies, rounds, frames, device))}
        rows.append({"case": label, "T": T, "big_capacity": big_cap,
                     "dense_ms": ms["dense"], "scatter_ms": ms["scatter"],
                     **agree})
    return rows


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--frames", type=int, default=30)
    args = ap.parse_args(argv)
    dev = timing.require_device(args.device, "bench_binning")
    rows = bench_binning(dev, args.rounds, args.frames)
    print(f"# {bench.device_name(dev)}")
    for r in rows:
        print(f"{r['case']:14s} T={r['T']:7d} dense {r['dense_ms']:8.4f} ms   "
              f"scatter {r['scatter_ms']:8.4f} ms   (big list "
              f"{r['big_capacity']}; ids equal in {r['tiles_compared']} "
              f"tiles, {r['tiles_at_capacity']} at capacity, max tile "
              f"{r['max_tile']})", flush=True)
    return rows


if __name__ == "__main__":
    main()
