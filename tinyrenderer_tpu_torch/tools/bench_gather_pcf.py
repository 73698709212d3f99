"""A/B of the shadow refinement's PCF gather forms on the card (the
counterpart of the repository's ``tools/bench_gather_pcf.py``).

The same 16 bytes a row gathered as a float32[4] row of the windowed
atlas (``f32x4``) and as a uint8[16] row of a byte view of it, viewed back
as float32 (``u8x16``); beside them the form before the windowed atlas,
four separate 4-byte taps of one channel (``4taps``). The index stream is
the refinement's: blocks of 128 locally coherent taps at scattered bases
(seed 0). The two 16-byte forms must be bit-equal (asserted before
anything is timed). A replay repeats its indices, so the rows it touches
may stay in the card's L2 cache between replays.

    python -m tinyrenderer_tpu_torch.tools.bench_gather_pcf [--device cpu]
        [--rounds 5] [--frames 10] [--rows 393216] [--table 7340032]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import bench
from . import timing


def make_inputs(device, rows: int = 393216,
                table: int = 7 * 1024 * 1024) -> tuple:
    """(table (N, 4) f32, its (N, 16) u8 view, indices (rows,) i64)."""
    rng = np.random.default_rng(0)
    tab = torch.from_numpy(rng.random((table, 4)).astype(np.float32)).to(
        device)
    nblk = rows // 128
    bases = rng.integers(0, table - 4096, nblk)[:, None]
    local = rng.integers(0, 4096, (nblk, 128))
    idx = torch.from_numpy((bases + local).reshape(-1)).to(device)
    return tab, tab.view(torch.uint8).reshape(-1, 16), idx


def forms() -> dict:
    """{name: fn(table, table_u8, idx) -> gathered (rows, 4) f32}."""
    def f32x4(tab, _tab_u8, idx):
        return tab[idx]

    def u8x16(_tab, tab_u8, idx):
        return tab_u8[idx].view(torch.float32)

    def taps4(tab, _tab_u8, idx):
        col = tab[:, 0]
        return torch.stack([col[(idx + k) % tab.shape[0]] for k in range(4)],
                           dim=1)
    return {"f32x4": f32x4, "u8x16": u8x16, "4taps": taps4}


def bench_gather(device, rounds: int = 5, frames: int = 10,
                 rows: int = 393216, table: int = 7 * 1024 * 1024) -> list:
    """The two 16-byte forms checked bit-equal, then every form timed
    round-robin: a row a form."""
    args = make_inputs(device, rows, table)
    fns = forms()
    a, b = fns["f32x4"](*args), fns["u8x16"](*args)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32)), \
        "the f32[4] and u8[16] gathers differ"
    bodies = {k: timing.capture(lambda *x, fn=fn: fn(*x).sum(), *args)
              for k, fn in fns.items()}
    return [{"form": r["name"], "median_ms": r["median_ms"],
             "min_ms": r["min_ms"], "rows": rows, "bit_equal": True}
            for r in timing.summary(timing.round_robin(bodies, rounds, frames,
                                                       device))]


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--rows", type=int, default=393216)
    ap.add_argument("--table", type=int, default=7 * 1024 * 1024)
    args = ap.parse_args(argv)
    dev = timing.require_device(args.device, "bench_gather_pcf")
    rows = bench_gather(dev, args.rounds, args.frames, args.rows, args.table)
    print(f"# {bench.device_name(dev)}; f32x4 and u8x16 bit-equal")
    print(f"{'form':8s} {'median':>9s} {'min':>9s}  (ms per {args.rows} "
          f"rows)")
    for r in rows:
        print(f"{r['form']:8s} {r['median_ms']:9.4f} {r['min_ms']:9.4f}")
    return rows


if __name__ == "__main__":
    main()
