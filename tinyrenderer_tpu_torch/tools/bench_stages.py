"""Stage ledger of the deferred frame on the card (the counterpart of the
repository's ``tools/bench_stages.py``).

Times nested prefixes of the frame, each captured as a graph of its own and
replayed round-robin (``tools/timing.py``): null, geometry, setup, bin,
raster, select, material and the full frame. The difference between
consecutive rows is a stage's cost, without a trace's double count of
overlapping work. The prefixes are built from the port's functions of the
reference's names:

- geometry: ``frame._unpack_camera``, ``frame.geometry_stage``;
- setup, bin, raster: ``raster.triangle_setup``, ``bin_triangles`` (dense
  up to 4096 triangles, scatter above) and ``rasterize_binned`` (K1);
- select: ``resolve.build_gbuffer_table`` (the full 53-column table) and
  ``resolve_attrs_pallas`` (K2, float32 planes);
- material: ``resolve.resolve_gbuffer_from_attrs`` (K7 on a textured
  world);
- full: ``frame.render_frame`` (K1, K2, K3 on the fused frame) on the
  settled engine's shadow atlas, rendered once outside the rounds. It is
  the frame alone, as the reference's full row was once XLA had dropped
  its prefix's unused outputs: a graph keeps every node it captured, so a
  full row that also ran the prefix would count it twice.

A row's time contains the harness floor (the ``null`` row) and one sum a
tensor of its stage's outputs.

    python -m tinyrenderer_tpu_torch.tools.bench_stages [--device cpu]
        [--scene test|stress|highpoly] [--multilight] [--level PATH]
        [--rounds 5] [--frames 10]

``stage_fns(engine)`` returns each prefix as ``fn(camera_raw) -> dict`` of
its stage's real outputs; ``stage_ledger(engine, rounds, frames)`` settles
the engine and returns the rows.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Callable

import torch

from .. import bench
from ..ops import raster, resolve
from ..render import frame as framelib
from . import timing

STAGES = ("null", "geometry", "setup", "bin", "raster", "select", "material",
          "full")


def as_dict(x) -> dict:
    """A dataclass's tensors by field name."""
    return {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}


def stage_fns(eng) -> dict:
    """{stage: fn(camera_raw) -> {name: tensor}}: each prefix of the frame
    of ``eng`` (packed and settled) up to that stage, returning what the
    stage computed."""
    cfg = eng.cfg
    scene, pool, lights, params, env, atlas = timing.frame_args(eng)
    PW, PH = cfg.padded_width, cfg.padded_height
    th, tw = cfg.tile_h, cfg.tile_w

    def upto(stage: str) -> Callable:
        def fn(cam):
            if stage == "null":
                return {"camera": cam}
            if stage == "full":
                # the frame alone: XLA dropped the reference's unused
                # prefix outputs, and a graph replays every node it holds
                return as_dict(framelib.render_frame(
                    scene, pool, lights, cam, params, env, cfg, atlas))
            c = framelib._unpack_camera(cam)
            _world, clip, attrs = framelib.geometry_stage(scene,
                                                          c["view_proj"])
            if stage == "geometry":
                return {"clip": clip}
            setup = raster.triangle_setup(clip, scene.tri_vidx,
                                          scene.tri_deferred, PW, PH, "back")
            if stage == "setup":
                return {"rows": setup.rows}
            bins = raster.bin_triangles(setup, PW, PH, th, tw,
                                        cfg.bin_capacity, cfg.bin_big_capacity)
            if stage == "bin":
                return {"ids": bins.ids, "counts": bins.counts,
                        "rows": bins.rows}
            tri_id, depth = raster.rasterize_binned(bins, th, tw)
            if stage == "raster":
                return {"tri_id": tri_id, "depth": depth}
            table = resolve.build_gbuffer_table(
                setup, scene.tri_vidx, attrs, scene.tri_instance,
                scene.inst_object_id, scene.inst_material, scene.mat_record,
                scene.mat_flat)
            r = resolve.resolve_attrs_pallas(tri_id, table)
            if stage == "select":
                return {"table": table, **as_dict(r)}
            g, tex_needed = resolve.resolve_gbuffer_from_attrs(
                r, tri_id, depth, pool, texture_filter=cfg.texture_filter,
                texture_scale=cfg.texture_scale,
                tex_block_capacity=cfg.tex_block_capacity)
            return {**as_dict(g), "tex_needed": tex_needed}
        return fn

    return {s: upto(s) for s in STAGES}


def ledger(fns: dict, cam: torch.Tensor, rounds: int, frames: int) -> list:
    """Rows of a stage ledger: each of ``fns`` (stage -> fn(camera_raw))
    captured as a body returning the sum of its outputs, timed
    round-robin; each row has the stage, its median and min ms a frame and
    its delta from the previous row's median."""
    bodies = {}
    for name, fn in fns.items():
        bodies[name] = timing.capture(lambda c, fn=fn: timing.reduce(fn(c)),
                                      cam)
        print(f"# captured {name}", flush=True)
    rows, prev = [], 0.0
    for row in timing.summary(timing.round_robin(bodies, rounds, frames,
                                                 cam.device)):
        rows.append({"stage": row.pop("name"), **row,
                     "delta_ms": row["median_ms"] - prev})
        prev = row["median_ms"]
    return rows


def stage_ledger(eng, rounds: int = 5, frames: int = 10) -> list:
    """Settle ``eng`` (``bench.settle``: a frame, the monitors drained,
    frames until one held its config), then the ledger of
    :func:`stage_fns`."""
    bench.settle(eng)
    return ledger(stage_fns(eng), timing.camera(eng), rounds, frames)


def print_rows(rows: list, key: str = "stage") -> None:
    print(f"\n{key:14s} {'median':>9s} {'delta':>9s} {'min':>9s}   "
          f"(ms/frame)")
    for r in rows:
        print(f"{r[key]:14s} {r['median_ms']:9.4f} {r['delta_ms']:+9.4f} "
              f"{r['min_ms']:9.4f}")


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    timing.add_scene_args(ap)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--frames", type=int, default=10)
    args = ap.parse_args(argv)
    timing.require_device(args.device, "bench_stages")
    rows = stage_ledger(timing.engine_from_args(args), args.rounds,
                        args.frames)
    print_rows(rows)
    return rows


if __name__ == "__main__":
    main()
