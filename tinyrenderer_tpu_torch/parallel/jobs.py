"""What the ranks of :func:`parallel.launch` run: sharded frames of worlds
each rank builds for itself, and the probes of the process group.

A job is a plain dict, so that it pickles into a spawned process: its
``device`` and ``backend``, and ``worlds``, a list of dicts, each with

- ``world``: ``("level", path)``, ``("demo", build_demo_world kwargs)`` or
  ``("highpoly", n_spheres)``; the demo worlds take the demo camera;
- ``cfg``: the engine's ``RenderConfig`` fields (the world is packed under
  it);
- ``cases``: a list of dicts, each with ``name``, ``cfg`` (the frame's
  ``RenderConfig`` fields, from ``sharded_config``), ``dp``, and at will
  ``cams`` ((B, 83) camera rows; default the engine's camera once a
  ``dp`` row), ``params`` ({index: value} over the engine's), ``atlas``
  ("cached": :func:`render_shadow_atlas_sharded` first; by default the
  frame renders it), ``scatter_min_t`` (``raster._SCATTER_MIN_T`` for the
  case), ``plain`` (the frame again with every kernel's plain version, on
  the same device), ``repeats`` (on the card: frames timed after the
  first, over a kept atlas as the engine's steady frame).

:func:`frame_job` returns one dict a case, in order: the frame (rank 0
only), a digest of it (every rank), the kernels' launches in the frame and,
on the card, the times of the steady frame and of its collectives.
"""

from __future__ import annotations

import contextlib
import hashlib
import statistics
import sys

import numpy as np
import torch

from ..config import RenderConfig
from ..ops import raster, resolve, sampling, shading
from ..render import compiled
from ..render.engine import Engine
from ..scene import demo
from . import sharded
from .launch import rank_device

FIELDS = ("sdr", "pick_id", "depth", "hdr", "bin_overflow", "shadow_overflow",
          "tex_overflow", "big_overflow", "shadow_blocks", "stream_overflow",
          "sky_blocks")


def make_engine(world, cfg: RenderConfig, device) -> Engine:
    """An engine of the job's world, packed, its environment built."""
    kind, arg = world
    if kind == "level":
        eng = Engine(cfg=cfg, device=device, level_path=arg)
    else:
        w = (demo.build_demo_world(**arg) if kind == "demo"
             else demo.build_highpoly_world(arg))
        eng = Engine.from_world(w, camera=demo.build_demo_camera(
            cfg.width, cfg.height), cfg=cfg, device=device)
    eng.update()
    eng._drain_actions()
    eng._ensure_env()
    return eng


@contextlib.contextmanager
def _patched(module, name: str, fn):
    old = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, old)


def plain_versions(chunk: int = 16) -> contextlib.ExitStack:
    """Every kernel's wrapper swapped for its plain version (on any
    device; the rasters race ``chunk`` rows a step), until the returned
    stack closes."""
    def shade_plain(tid, outf, outh, rec, gates, sky, campos, lights, P, D,
                    irr):
        return shading.shade_fused_ref(
            tid, outf, outh, rec, gates, sky,
            shading.pack_shading_consts(campos, lights, P, D, irr), P, D,
            irr is not None)

    stack = contextlib.ExitStack()
    for mod, name, fn in (
            (raster, "rasterize_binned",
             lambda bins, th, tw: raster.rasterize_binned_ref(bins, th, tw,
                                                              chunk=chunk)),
            (raster, "rasterize_stream", raster.rasterize_stream_ref),
            (raster, "rasterize_resolve_binned",
             lambda bins, table, th, tw: raster.rasterize_resolve_binned_ref(
                 bins, table, th, tw, chunk=chunk)),
            (resolve, "select_eval", resolve.select_eval_ref),
            (resolve, "select_eval_stream", resolve.select_eval_stream_ref),
            (shading, "shade_deferred_fused", shade_plain),
            (sampling, "windowed_blend", sampling.windowed_blend_ref)):
        stack.enter_context(_patched(mod, name, fn))
    return stack


class _CollectiveClock:
    """Times the sharded frame's collectives: CUDA events around each of
    its all-gathers (``sharded._all_gather``) and all-reduces, summed over
    a frame."""

    def __init__(self):
        self.spans: list = []

    def wrap(self, fn):
        def timed(*args, **kw):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kw)
            b.record()
            self.spans.append((a, b))
            return out
        return timed

    def __enter__(self):
        self._stack = contextlib.ExitStack()
        self._stack.enter_context(_patched(
            sharded, "_all_gather", self.wrap(sharded._all_gather)))
        self._stack.enter_context(_patched(
            sharded.dist, "all_reduce", self.wrap(sharded.dist.all_reduce)))
        return self

    def __exit__(self, *exc):
        self._stack.close()

    def take_ms(self) -> list:
        """The ms of each collective since the last call, in call order."""
        torch.cuda.synchronize()
        ms = [a.elapsed_time(b) for a, b in self.spans]
        self.spans = []
        return ms


def _digest(out) -> str:
    h = hashlib.sha256()
    for f in FIELDS:
        h.update(getattr(out, f).detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def frame_job(rank: int, world: int, job: dict) -> list:
    """Run the job's cases on this rank (see the module's docstring)."""
    dev = rank_device(rank, job["backend"], job["device"])
    results = []
    for w in job["worlds"]:
        eng = make_engine(w["world"], RenderConfig(**w["cfg"]), dev)
        for case in w["cases"]:
            results.append(_run_case(eng, case, rank, world, dev,
                                     job["backend"]))
        del eng
    return results


def _run_case(eng: Engine, case: dict, rank: int, world: int, dev,
              backend: str) -> dict:
    cfg = RenderConfig(**case["cfg"])
    mesh = sharded.make_mesh(case["dp"], world // case["dp"], dev, backend)
    cams = case.get("cams")
    cams = torch.as_tensor(np.stack([eng.camera.to_raw()] * case["dp"])
                           if cams is None else cams, device=dev)
    params = eng.params.clone()
    for i, v in case.get("params", {}).items():
        params[i] = v
    pool = eng._packer.pool_for(cfg, dev)
    scene, lights, env = eng._pack.scene, eng._pack.lights, eng._ensure_env()

    fn = sharded.compiled_sharded_frame(cfg, mesh)

    def frame(atlas):
        return fn(scene, pool, lights, cams, params, env, atlas)

    old_min_t = raster._SCATTER_MIN_T
    raster._SCATTER_MIN_T = case.get("scatter_min_t", old_min_t)
    try:
        atlas = None
        if case.get("atlas") == "cached":
            atlas, _, _ = sharded.render_shadow_atlas_sharded(scene, lights,
                                                              cfg, mesh)
        compiled.reset_launches()
        out = frame(atlas)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        r = {"name": case["name"], "launches": compiled.launch_counts(),
             "digest": _digest(out), "band_h": cfg.padded_height // mesh.sp}
        if rank == 0:
            r["out"] = {f: getattr(out, f) for f in FIELDS}
        if case.get("plain"):
            with plain_versions():
                plain = frame(atlas)
            if rank == 0:
                r["plain"] = {f: getattr(plain, f) for f in FIELDS}
        if dev.type == "cuda" and case.get("repeats"):
            kept, _, _ = sharded.render_shadow_atlas_sharded(scene, lights,
                                                             cfg, mesh)
            r.update(_timed(lambda: frame(kept), case["repeats"]))
    finally:
        raster._SCATTER_MIN_T = old_min_t
    return r


def _timed(frame, repeats: int) -> dict:
    """Medians over ``repeats`` frames after a first: the whole sharded
    frame's ms (CUDA events around it), its collectives' sum and each
    collective's ms in call order."""
    frame()
    frame_ms, coll = [], []
    clock = _CollectiveClock()
    with clock:
        for _ in range(repeats):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            frame()
            b.record()
            b.synchronize()
            frame_ms.append(a.elapsed_time(b))
            coll.append(clock.take_ms())
    return {"frame_ms": statistics.median(frame_ms),
            "collective_ms": statistics.median(sum(c) for c in coll),
            "each_collective_ms": [statistics.median(c) for c in zip(*coll)]}


def loaded_modules(rank: int, world: int) -> list:
    """The top-level packages this rank has imported (its target's module
    and the package's whole frame among them)."""
    return sorted({m.split(".")[0] for m in sys.modules})


def probe_collective(rank: int, world: int, name: str, device: str) -> dict:
    """Whether the process group's collective ``name`` takes this rank's
    tensors, by dtype: {dtype: "ok" or the error raised}. A backend that
    cannot take them may also abort the process, so a caller runs each
    collective in ranks of its own."""
    import torch.distributed as dist
    dev = rank_device(rank, dist.get_backend(), device)
    out = {}
    for dt in (torch.float32, torch.int32, torch.uint8):
        t = (torch.arange(6, device=dev) + 10 * rank).to(dt)
        calls = {
            "all_gather": lambda: dist.all_gather(
                [torch.empty_like(t) for _ in range(world)], t),
            "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
                torch.empty(6 * world, dtype=dt, device=dev), t),
            "all_to_all_single": lambda: dist.all_to_all_single(
                torch.empty(6 * world, dtype=dt, device=dev),
                torch.cat([t] * world)),
            "send_recv": lambda: [w.wait() for w in dist.batch_isend_irecv(
                [dist.P2POp(dist.isend, t, (rank + 1) % world),
                 dist.P2POp(dist.irecv, torch.empty_like(t),
                            (rank - 1) % world)])],
            "all_reduce_sum": lambda: dist.all_reduce(t),
            "all_reduce_max": lambda: dist.all_reduce(
                t, op=dist.ReduceOp.MAX),
            "broadcast": lambda: dist.broadcast(t, src=0)}
        try:
            calls[name]()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            out[str(dt)] = "ok"
        except RuntimeError as e:           # what the backend refuses
            out[str(dt)] = str(e).splitlines()[0][:100]
        dist.barrier()
    return out
