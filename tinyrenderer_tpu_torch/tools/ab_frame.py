"""Interleaved A/B of a code or config variant on the whole steady frame
(the counterpart of the repository's ``tools/ab_frame.py``).

``--flag module:NAME`` captures the frame twice, with the module attribute
False and with it True, each value set while that variant's graph is
captured (a graph freezes the flag's effect, as a trace did). The port
keeps one such flag, ``tinyrenderer_tpu_torch.ops.shadows:_GATE_VIA_MIN``;
the reference's others exit with the decision that left them out.
``--cfg k=v[,k=v...]`` settles a second engine with those RenderConfig
overrides. Either way the two frames are captured as bodies of their own
(not through ``frame.compiled_frame``'s cache) and timed round-robin
(``tools/timing.py``).

    python -m tinyrenderer_tpu_torch.tools.ab_frame [--device cpu]
        (--flag tinyrenderer_tpu_torch.ops.shadows:_GATE_VIA_MIN |
         --cfg sky_block_capacity=2048) [--scene test|stress|highpoly|
         multilight] [--level PATH] [--rounds 6] [--frames 8]
"""

from __future__ import annotations

import argparse
import importlib
from typing import Callable
from unittest.mock import patch

from .. import bench
from ..config import RenderConfig
from . import timing
from .profile_frame import DECISION, frame_body

PORT = "tinyrenderer_tpu_torch."
# the reference's module A/B flags that the port does not keep
LEFT_OUT_FLAGS = ("_PLANES_ON_MXU", "_FLAT_WINDOW_BLEND", "_CF_SAMPLE",
                  "_WINDOWED_BLEND_PALLAS", "_CF_BLEND_PALLAS")


def parse_flag(spec: str) -> tuple:
    """(module, NAME) of ``module.path:NAME``: an attribute the port's
    module has. Anything else raises ValueError naming the decision."""
    modname, _, attr = spec.partition(":")
    if attr in LEFT_OUT_FLAGS or not modname.startswith(PORT):
        raise ValueError(f"ab_frame: {spec!r} is not a flag of the port: "
                         f"{DECISION}")
    mod = importlib.import_module(modname)
    if not hasattr(mod, attr):
        raise ValueError(f"ab_frame: {modname} has no {attr}: {DECISION}")
    return mod, attr


def parse_cfg(spec: str, cfg) -> dict:
    """``k=v,k=v`` as RenderConfig overrides typed like ``cfg``'s fields."""
    overrides = {}
    for kv in spec.split(","):
        k, v = kv.split("=")
        cur = getattr(cfg, k)
        overrides[k] = (v.lower() in ("1", "true") if isinstance(cur, bool)
                        else type(cur)(v))
    return overrides


def _frame_body(eng, setup=None) -> timing.Body:
    scene, pool, lights, params, env, atlas = timing.frame_args(eng)
    return frame_body(timing.camera(eng), scene, pool, lights, params, env,
                      atlas, eng.cfg, setup)


def _rows(bodies: dict, rounds: int, frames: int, device) -> list:
    return timing.summary(timing.round_robin(bodies, rounds, frames, device))


def ab_flag(eng, module, name: str, rounds: int = 6,
            frames: int = 8) -> list:
    """The settled frame of ``eng`` captured with ``module.name`` False
    and True, timed round-robin: a row a value."""
    bench.settle(eng)
    bodies = {f"{name}={v}": _frame_body(
        eng, lambda v=v: patch.object(module, name, v))
        for v in (False, True)}
    return _rows(bodies, rounds, frames, eng.device)


def ab_cfg(build: Callable, overrides: dict, rounds: int = 6,
           frames: int = 8) -> list:
    """``build(cfg_overrides)`` -> engine, once without and once with
    ``overrides``, each settled; their frames timed round-robin."""
    label = ",".join(f"{k}={v}" for k, v in overrides.items())
    bodies = {}
    for key, ov in (("base", None), (label, overrides)):
        eng = build(ov)
        bench.settle(eng)
        bodies[key] = _frame_body(eng)
    return _rows(bodies, rounds, frames, eng.device)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    timing.add_scene_args(ap, multilight=False,
                          scenes=("test", "stress", "highpoly", "multilight"))
    ap.add_argument("--flag", default="",
                    help="module.path:ATTR set False and True")
    ap.add_argument("--cfg", default="",
                    help="comma-separated RenderConfig overrides (k=v) of "
                         "the B variant")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--frames", type=int, default=8)
    args = ap.parse_args(argv)
    if bool(args.flag) == bool(args.cfg):
        raise SystemExit("ab_frame: pass exactly one of --flag / --cfg")
    try:
        flag = parse_flag(args.flag) if args.flag else None
    except ValueError as e:
        raise SystemExit(str(e)) from None
    timing.require_device(args.device, "ab_frame")
    if flag:
        rows = ab_flag(timing.engine_from_args(args), *flag,
                       rounds=args.rounds, frames=args.frames)
    else:
        overrides = parse_cfg(args.cfg, RenderConfig())
        rows = ab_cfg(lambda ov: timing.engine_from_args(args, ov),
                      overrides, args.rounds, args.frames)
    print("\n=== medians (ms/frame) ===")
    for r in rows:
        print(f"{r['name']:30s} {r['median_ms']:8.3f}")
    print(f"delta (B - A): {rows[1]['median_ms'] - rows[0]['median_ms']:+.3f}"
          f" ms; device {bench.device_name(args.device)}")
    return rows


if __name__ == "__main__":
    main()
