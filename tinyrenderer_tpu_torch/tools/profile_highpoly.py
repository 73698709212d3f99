"""Stage ledger of the high-poly frame on the card (the counterpart of the
repository's ``tools/profile_highpoly.py``): the ledger of
``tools/bench_stages.py`` on the CSR stream path of
``build_highpoly_world(9)`` (~108k triangles, 8x128 tiles).

The prefixes: geometry, + triangle setup, + ``raster.bin_triangles_stream``,
+ ``rasterize_stream`` (K4), + the resolve table (slim on a flat-only
world), + ``resolve.resolve_attrs_stream`` (K5), and the full frame
(``frame.render_frame`` on the settled engine's atlas; K1 renders the
atlas outside the rounds).

    python -m tinyrenderer_tpu_torch.tools.profile_highpoly [--device cpu]
        [--rounds 5] [--frames 8]
"""

from __future__ import annotations

import argparse

from .. import bench
from ..ops import raster, resolve
from ..render import frame as framelib
from . import timing
from .bench_stages import as_dict, ledger, print_rows

STAGES = ("geometry", "+setup", "+stream_bin", "+raster", "+table",
          "+resolve", "full_frame")


def stage_fns(eng) -> dict:
    """{stage: fn(camera_raw) -> {name: tensor}} on the stream path, as
    :func:`bench_stages.stage_fns`."""
    cfg = eng.cfg
    scene, pool, lights, params, env, atlas = timing.frame_args(eng)
    PW, PH = cfg.padded_width, cfg.padded_height
    th, tw = cfg.tile_h, cfg.tile_w
    slim = not cfg.any_textured

    def upto(depth_k: int):
        def fn(cam):
            if depth_k == len(STAGES) - 1:
                return as_dict(framelib.render_frame(
                    scene, pool, lights, cam, params, env, cfg, atlas))
            c = framelib._unpack_camera(cam)
            world, clip, attrs = framelib.geometry_stage(scene,
                                                         c["view_proj"])
            if depth_k == 0:
                return {"world": world, "clip": clip}
            setup = raster.triangle_setup(clip, scene.tri_vidx,
                                          scene.tri_deferred, PW, PH, "back")
            if depth_k == 1:
                return {"rows": setup.rows}
            sbins = raster.bin_triangles_stream(
                setup, PW, PH, th, tw, cfg.stream_capacity,
                cfg.bin_big_capacity)
            if depth_k == 2:
                return {"ids": sbins.ids, "starts": sbins.starts,
                        "counts": sbins.counts, "rows": sbins.rows}
            ty, tx = sbins.counts.shape
            tri_id, depth = raster.rasterize_stream(sbins, ty, tx, th, tw,
                                                    cfg.bin_capacity)
            if depth_k == 3:
                return {"tri_id": tri_id, "depth": depth}
            table = resolve.build_gbuffer_table(
                setup, scene.tri_vidx, attrs, scene.tri_instance,
                scene.inst_object_id, scene.inst_material, scene.mat_record,
                scene.mat_flat, slim=slim)
            if depth_k == 4:
                return {"table": table}
            return as_dict(resolve.resolve_attrs_stream(
                tri_id, sbins, table, th, tw, cfg.bin_capacity,
                bf16=cfg.bf16_attrs))
        return fn

    return {s: upto(k) for k, s in enumerate(STAGES)}


def stage_ledger(eng, rounds: int = 5, frames: int = 8) -> list:
    """Settle ``eng``, then the ledger of :func:`stage_fns`."""
    bench.settle(eng)
    return ledger(stage_fns(eng), timing.camera(eng), rounds, frames)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--frames", type=int, default=8)
    args = ap.parse_args(argv)
    timing.require_device(args.device, "profile_highpoly")
    eng = bench.build_engine(highpoly=True, device=args.device)
    rows = stage_ledger(eng, args.rounds, args.frames)
    print(f"# triangles {eng._pack.counts['triangles']}, tiles "
          f"{eng.cfg.tile_h}x{eng.cfg.tile_w}, bin_capacity "
          f"{eng.cfg.bin_capacity}, stream_capacity "
          f"{eng.cfg.stream_capacity}; device "
          f"{bench.device_name(args.device)}")
    print_rows(rows)
    return rows


if __name__ == "__main__":
    main()
