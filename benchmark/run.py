"""Run one cell of the benchmark and print its result as the last line.

    python3 -m benchmark.run --workload deferred_1080p.orbit --seed 7 \\
        --seconds 20 --trace 0

Needs a CUDA device (exits non-zero and prints no result without one, or
with fewer cards than the cell asks for). ``--trace 0`` prints the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics, the device's busy
time and a breakdown. Every run checks frames of its window against the
plain reference and prints each number compared beside its limit, last
on standard error and as the last key of the result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

# one process, few threads: BLAS and OpenMP pools of one thread, set
# before numpy or torch load them
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")


def main(argv=None) -> int:
    from . import harness
    t0 = harness.process_start()
    ap = argparse.ArgumentParser(description="run one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    manifest = harness._load_json(f"{harness.ROOT}/BENCHMARK.json")
    chips = next(w["chips"] for w in manifest["workloads"]
                 if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), t_start=t0)
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: the process loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
