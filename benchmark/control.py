"""The control of the correctness check: the plain reference put in the
program's place and computed one precision below what the configuration
states. The configurations state float32 with TF32 off (the frame sets
``allow_tf32 = False`` for its matrix products), so the control is the
reference with TF32 on; it has to read above each limit.

    python3 -m benchmark.control --workload deferred_1080p.orbit \\
        --seeds 1 2 3

prints, per seed, the numbers of the check for the control's frames (the
frames a run would check, at the cell's own size) and the worst of each.
TF32 exists on the card only.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

from . import check, harness, scenes
from .traffic import Traffic


@contextlib.contextmanager
def tf32():
    import torch
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def frames(seed: int, expected: int) -> list:
    """The frame indices a window of ``expected`` frames would check."""
    return sorted(harness._picks(seed, expected)) + [expected - 1]


# the window length, in frames, whose checked frames the control renders
EXPECTED_FRAMES = 4000


def readings(name: str, seed: int, device: str = "cuda",
             manifest: dict | None = None, search: list | None = None) -> dict:
    """The worst of each number over the control's frames of one seed: the
    reference in TF32 against the reference."""
    import torch

    from .reference import frame as ref
    if manifest is None:
        manifest = harness._load_json(os.path.join(harness.ROOT,
                                                   "BENCHMARK.json"))
    cell = harness.resolve(manifest, name, search)
    desc = scenes.describe(cell.config, harness.ROOT)
    traffic = Traffic(cell.mix, cell.config, desc, seed)
    render = cell.config["render"]
    base = {"exposure": 1.0, "shadow_bias": 0.0, **cell.config.get("params", {})}
    env = ref.Environment(render, os.path.join(harness.ROOT, harness.IBL_ASSET),
                          device)
    with tf32():
        env_low = ref.Environment(render, os.path.join(harness.ROOT,
                                                       harness.IBL_ASSET), device)
    out = []
    first = traffic.warmup_frames
    for i in frames(seed, EXPECTED_FRAMES):
        inp = traffic.frame(first + i)
        scene = traffic.scene_at(inp)
        params = {**base, **inp.params}
        r, _ = ref.render(scene, render, params, env, device=device)
        with tf32():
            c, _ = ref.render(scene, render, params, env_low, device=device)
        out.append(check.compare(c, r))
        del r, c
        if device != "cpu":
            torch.cuda.empty_cache()
    return check.worst(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the check's control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control: TF32 needs a CUDA device", file=sys.stderr)
        return 2
    rows = {s: readings(args.workload, s) for s in args.seeds}
    for s, r in rows.items():
        print(json.dumps({"workload": args.workload, "seed": s, **r}))
    print(json.dumps({"workload": args.workload, "least": {
        k: min(r[k] for r in rows.values()) for k in check.NUMBERS}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
