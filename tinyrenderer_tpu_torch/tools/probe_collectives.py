"""Which ``torch.distributed`` collectives take CUDA tensors: gloo with two
ranks sharing the card, and nccl at world size 1 (the card's machine has
one card). Each collective runs in ranks of its own, as a backend that
cannot take a tensor may abort the process instead of raising; a line a
collective, by dtype::

    python3 -m tinyrenderer_tpu_torch.tools.probe_collectives [--device cpu]
        [COLLECTIVE ...]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

COLLECTIVES = ("all_reduce_sum", "all_reduce_max", "broadcast", "all_gather",
               "all_gather_into_tensor", "all_to_all_single", "send_recv")


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("collectives", nargs="*",
                    help=f"of {', '.join(COLLECTIVES)} (default: all)")
    args = ap.parse_args(argv)
    bad = set(args.collectives) - set(COLLECTIVES)
    if bad:
        ap.error(f"unknown collectives {sorted(bad)}")
    from ..parallel import jobs
    from ..parallel.launch import launch
    runs = [("gloo", 2)] + ([("nccl", 1)] if args.device == "cuda" else [])
    for backend, ranks in runs:
        for name in args.collectives or COLLECTIVES:
            t0 = time.perf_counter()
            try:
                res = launch(jobs.probe_collective, ranks, backend,
                             args.device, name, args.device,
                             timeout_s=120)[0]
            except RuntimeError as e:    # the rank died or raised
                res = {"failed": str(e).replace("\n", " | ")[-240:]}
            print(json.dumps({"backend": backend, "ranks": ranks,
                              "device": args.device, "collective": name,
                              "result": res,
                              "s": round(time.perf_counter() - t0, 1)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
