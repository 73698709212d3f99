"""Interleaved frame profiler: config variants of the steady frame timed
round-robin in one process (the counterpart of the repository's
``tools/profile_frame.py``).

Each variant is a ``RenderConfig`` derived from the settled engine's (the
reference's group and variant names and ``replace(...)`` overrides), or a
module flag set while its graph is captured. Each gets its own texture
pool and steady shadow atlas, rendered once and passed as arguments, and
its frame captured as a body of its own (``tools/timing.py``); the
variants of a group are timed round-robin. ``--set all`` runs the groups
one after another, dropping each group's graphs (and emptying the
allocator's cache) before the next is captured, and prints each group's
peak MiB: a configuration's graphs hold their own memory (``PERF.md``
section 5 has what they reserve on the card).

Two groups of the reference are left out, and asking for them exits with
an error: ``wblend`` and ``rkernel`` toggle ``_WINDOWED_BLEND_PALLAS``,
``_FLAT_WINDOW_BLEND`` and ``_PLANES_ON_MXU``, which the port does not
keep (ROADMAP.md, "Left out by decision": the module A/B flags).
``stream`` forces the stream raster (``raster.stream_pays_off``) while its
variants are captured, so that a small scene measures the stream path.
A variant's capacities are the reference's: one set below its scene's need
drops work and reads fast.

    python -m tinyrenderer_tpu_torch.tools.profile_frame [--device cpu]
        [--set all|gatemin|fshade|gateblk|next|r3|stream|passes|shadow|
         layout|filters|rates] [--rounds 5] [--frames 8]
        [--scene test|stress|highpoly] [--multilight] [--level PATH]
        [--width W --height H]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import sys
from dataclasses import replace
from typing import Optional
from unittest.mock import patch

import torch

from .. import bench
from ..ops import raster, shadows
from ..render import frame as framelib
from . import timing

DECISION = ("ROADMAP.md, 'Left out by decision': the module A/B flags "
            "_PLANES_ON_MXU, _FLAT_WINDOW_BLEND, _CF_SAMPLE, "
            "_WINDOWED_BLEND_PALLAS and _CF_BLEND_PALLAS are not ported; "
            "the port keeps only _GATE_VIA_MIN")
LEFT_OUT = {"wblend": ("_WINDOWED_BLEND_PALLAS", "_FLAT_WINDOW_BLEND"),
            "rkernel": ("_PLANES_ON_MXU",)}


class LeftOutByDecision(ValueError):
    """A variant of the reference that the port does not keep."""


@dataclasses.dataclass(frozen=True)
class Variant:
    """A RenderConfig from the base: ``preset`` (a RenderConfig method,
    e.g. ``performance_preset``) or the base itself, with ``overrides``
    replaced; ``flag`` (module, NAME, value) is set while its frame is
    captured."""

    overrides: tuple = ()
    preset: Optional[str] = None
    flag: Optional[tuple] = None

    def config(self, base):
        cfg = getattr(base, self.preset)() if self.preset else base
        return replace(cfg, **dict(self.overrides))


def V(preset: Optional[str] = None, flag: Optional[tuple] = None,
      **overrides) -> Variant:
    return Variant(tuple(overrides.items()), preset, flag)


BASE = V()
PRESET = "performance_preset"
SHADOW8 = dict(shadow_lookup_scale=8, shadow_block_capacity=3072)

GROUPS = {
    # the shadow gates' compare table: the 1-channel min-window map against
    # the 4-channel windowed PCF atlas
    "gatemin": {
        "min-map": V(flag=(shadows, "_GATE_VIA_MIN", True)),
        "pcf-win": V(flag=(shadows, "_GATE_VIA_MIN", False)),
    },
    "fshade": {
        "fused": V(fused_shading=True),
        "unfused": V(fused_shading=False),
    },
    # gate-refinement block dims, capacity-fair: slots scale inversely
    # with block area for the same boundary coverage
    "gateblk": {
        "blk8x16": V(gate_block_h=8, gate_block_w=16,
                     shadow_block_capacity=2560),
        "blk8x8": V(gate_block_h=8, gate_block_w=8,
                    shadow_block_capacity=5632),
        "blk8x32": V(gate_block_h=8, gate_block_w=32),
        "blk16x16": V(gate_block_h=16, gate_block_w=16,
                      shadow_block_capacity=1536),
    },
    "next": {
        "full": BASE,
        "shadow8": V(**SHADOW8),
        "shadow8-sky8": V(**SHADOW8, sky_scale=8),
        "texscale-2": V(texture_scale=2),
        "shadow8-tex2": V(**SHADOW8, texture_scale=2),
        "shadow8-sky8-stoch": V(**SHADOW8, sky_scale=8,
                                texture_filter="stochastic",
                                windowed_pool=False),
        "densetex": V(tex_block_capacity=0),
    },
    "r3": {
        "full": BASE,
        "shadowscale-2": V(shadow_lookup_scale=2),
        "shadowscale-8": V(shadow_lookup_scale=8),
        "no-shadows": V(enable_shadows=False),
        "f32-sky": V(sky_rgbe=False),
        "sky-full": V(sky_scale=1),
        "no-ibl": V(enable_ibl=False),
        "preset": V(PRESET),
        "stoch-only": V(texture_filter="stochastic", windowed_pool=False),
    },
    "stream": {
        "stream": BASE,
        "dense": V(stream_raster=False),
        "stream-fused": V(fused_resolve=True),
        "bf16-attrs": V(bf16_attrs=True),
        "streamcap-8k": V(stream_capacity=8192),
        "streamcap-4k": V(stream_capacity=4096),
        "bigcap-32": V(bin_big_capacity=32),
        "lean": V(stream_capacity=4096, bin_big_capacity=32, bf16_attrs=True),
    },
    "passes": {
        "full": BASE,
        "no-shadows": V(enable_shadows=False),
        "no-ibl": V(enable_ibl=False),
        "no-forward": V(has_forward=False),
        "forward-only": V(forward_only=True),
        "fused-resolve": V(fused_resolve=True),
        "jnp-raster": V(use_pallas=False),
    },
    "shadow": {
        "full": BASE,
        "bf16-atlas": V(shadow_bf16=True),
        "shadowscale-4": V(shadow_lookup_scale=4),
        "bf16+scale4": V(shadow_bf16=True, shadow_lookup_scale=4),
        "no-shadows": V(enable_shadows=False),
    },
    "layout": {
        "full": BASE,
        "morton": V(morton_pool=True),
        "scale-75": V(render_scale_pct=75),
        "scale-50": V(render_scale_pct=50),
        "preset": V(PRESET),
        "preset-morton": V(PRESET, morton_pool=True),
        "preset-75": V(PRESET, render_scale_pct=75),
    },
    "filters": {
        "full": BASE,
        "trilinear": V(texture_filter="trilinear"),
        "bilinear": V(texture_filter="bilinear"),
        "stochastic": V(texture_filter="stochastic", windowed_pool=False),
        "narrow-dithered": V(windowed_pool=False),
        "win-stochastic": V(texture_filter="stochastic"),
    },
    "rates": {
        "full": BASE,
        "texscale-2": V(texture_scale=2),
        "texscale-8": V(texture_scale=8),
        "shadowscale-4": V(shadow_lookup_scale=4),
        "shadowscale-8": V(shadow_lookup_scale=8),
        "sky-16": V(sky_scale=16),
        "preset": V(PRESET),
    },
}


def group(name: str) -> dict:
    """The variants of group ``name``; raises :class:`LeftOutByDecision`
    for ``wblend`` and ``rkernel``."""
    if name in LEFT_OUT:
        raise LeftOutByDecision(
            f"profile_frame: group {name!r} toggles "
            f"{', '.join(LEFT_OUT[name])}: {DECISION}")
    return GROUPS[name]


def variant_setup(group_name: str, v: Variant):
    """A function returning what a variant holds while its frame's Python
    runs (``timing.Body``): its module flag; in group ``stream``, the
    stream raster forced on any pool."""
    def setup():
        stack = contextlib.ExitStack()
        if group_name == "stream":
            stack.enter_context(patch.object(raster, "stream_pays_off",
                                             lambda _t: True))
        if v.flag:
            stack.enter_context(patch.object(*v.flag))
        return stack
    return setup


def frame_body(cam, scene, pool, lights, params, env, atlas, cfg,
               setup=None) -> timing.Body:
    """The steady frame under ``cfg`` captured as a body of its own on its
    arguments, returning one pixel and one depth (a small reduction)."""
    def body(cam, scene, pool, lights, params, env, atlas):
        out = framelib.render_frame(scene, pool, lights, cam, params, env,
                                    cfg, atlas)
        return out.sdr[0, 0, 0].float() + out.depth[0, 0]
    return timing.capture(body, cam, scene, pool, lights, params, env, atlas,
                          setup=setup)


def profile_group(eng, name: str, rounds: int = 5, frames: int = 8) -> list:
    """Rows (variant, median and min ms a frame, peak MiB of the group) of
    group ``name`` on ``eng``, settled first. The group's graphs are
    dropped before this returns."""
    variants = group(name)
    bench.settle(eng)
    base, dev = eng.cfg, eng.device
    scene, _pool, lights, params, env, _atlas = timing.frame_args(eng)
    cam = timing.camera(eng)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        a0 = torch.cuda.memory_allocated()
    bodies = {}
    for vname, v in variants.items():
        cfg = v.config(base)
        pool = eng._packer.pool_for(cfg, dev)
        # the variant's steady atlas, rendered once (its row width follows
        # shadow_bf16)
        atlas = (None if cfg.forward_only else
                 framelib.render_shadow_atlas(scene, lights, cfg)[0])
        bodies[vname] = frame_body(cam, scene, pool, lights, params, env,
                                   atlas, cfg, variant_setup(name, v))
        print(f"# captured {name}/{vname}", file=sys.stderr, flush=True)
    samples = timing.round_robin(bodies, rounds, frames, dev)
    peak = ((torch.cuda.max_memory_allocated() - a0) / 2 ** 20 if cuda
            else None)
    del bodies, atlas
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return [{"group": name, "variant": r["name"],
             "median_ms": r["median_ms"], "min_ms": r["min_ms"],
             "peak_mib": peak} for r in timing.summary(samples)]


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    timing.add_scene_args(ap)
    ap.add_argument("--set", default="all",
                    choices=["all"] + list(GROUPS) + list(LEFT_OUT))
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    args = ap.parse_args(argv)
    names = list(GROUPS) if args.set == "all" else [args.set]
    try:
        for n in names:
            group(n)
    except LeftOutByDecision as e:
        raise SystemExit(str(e)) from None
    timing.require_device(args.device, "profile_frame")
    size = {k: v for k, v in (("width", args.width),
                              ("height", args.height)) if v}
    eng = timing.engine_from_args(args, size or None)
    rows = []
    for n in names:
        grows = profile_group(eng, n, args.rounds, args.frames)
        rows += grows
        peak = grows[0]["peak_mib"]
        print(f"\n[{n}] {'variant':22s} {'median':>9s} {'min':>9s}   "
              f"(ms/frame, {args.rounds} interleaved rounds; peak "
              f"{'n/a' if peak is None else f'{peak:.0f} MiB'})")
        for r in grows:
            print(f"{'':{len(n) + 3}s}{r['variant']:22s} "
                  f"{r['median_ms']:9.3f} {r['min_ms']:9.3f}", flush=True)
    return rows


if __name__ == "__main__":
    main()
