"""Start one process a rank and run a function in each, as one program.

:func:`launch` spawns ``ranks`` processes (the ``spawn`` start method:
``fork`` breaks CUDA in a parent that has touched it), joins them in a
``torch.distributed`` process group whose rendezvous is a ``FileStore`` in
a temporary directory, and calls ``fn(rank, world, *args)`` in each. Every
tensor in a rank's result comes back as a numpy array. A rank that raises
exits non-zero, and ``launch`` raises with that rank's traceback after
stopping the others.

``fn`` must be importable by its module path, as spawned processes import
it; the targets this package runs live here. On the card, the parent
builds the kernel library before it spawns, so the ranks load the built
``build/kernels/libtr_kernels_<hash>.so`` instead of each running
``nvcc``.
"""

from __future__ import annotations

import datetime
import os
import sys
import tempfile
import traceback
from multiprocessing import connection, get_context

import torch

from .. import kernels


def rank_device(rank: int, backend: str, device: str) -> torch.device:
    """The device of ``rank``: the CPU, or card ``rank % count`` (ranks
    share cards under gloo; nccl takes one card a rank)."""
    if device == "cpu":
        return torch.device("cpu")
    if device != "cuda":
        raise ValueError(f"device must be 'cuda' or 'cpu', not {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "ranks on the host")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _to_numpy(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_numpy(v) for v in obj)
    return obj


def _rank_main(fn, rank: int, world: int, backend: str, device: str,
               store_path: str, timeout_s: float, conn, args) -> None:
    import torch.distributed as dist
    try:
        dev = rank_device(rank, backend, device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)          # before any other CUDA call
        else:                                   # the ranks share the cores
            torch.set_num_threads(1)
        store = dist.FileStore(store_path, world)
        dist.init_process_group(
            backend, store=store, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            result = _to_numpy(fn(rank, world, *args))
        finally:
            dist.destroy_process_group()
    except Exception:
        conn.send(("error", traceback.format_exc()))
        conn.close()
        sys.exit(1)
    conn.send(("ok", result))
    conn.close()


def launch(fn, ranks: int, backend: str, device: str, *args,
           timeout_s: float = 600.0) -> list:
    """Run ``fn(rank, ranks, *args)`` in ``ranks`` spawned processes of one
    process group on ``backend`` ("gloo" or "nccl"), each on its
    :func:`rank_device`; return the ranks' results (tensors as numpy
    arrays) in rank order."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', not {backend!r}")
    if backend == "nccl" and (device != "cuda"
                              or ranks > torch.cuda.device_count()):
        raise ValueError(f"nccl needs one card a rank: {ranks} ranks, "
                         f"{torch.cuda.device_count()} cards, device "
                         f"{device!r}")
    if device == "cuda":
        rank_device(0, backend, device)
        kernels.library()
    ctx = get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="tr_launch_") as tmp:
        store = os.path.join(tmp, "store")
        pipes = [ctx.Pipe(duplex=False) for _ in range(ranks)]
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, ranks, backend, device, store,
                                   timeout_s, pipes[r][1], args),
                             name=f"rank{r}")
                 for r in range(ranks)]
        for p in procs:
            p.start()
        for _, send in pipes:
            send.close()
        results: dict = {}
        waiting = {pipes[r][0]: r for r in range(ranks)}
        try:
            while waiting:
                ready = connection.wait(list(waiting), timeout=timeout_s)
                if not ready:
                    raise TimeoutError(f"ranks {sorted(waiting.values())} "
                                       f"sent nothing in {timeout_s} s")
                for conn in ready:
                    r = waiting.pop(conn)
                    try:
                        status, payload = conn.recv()
                    except EOFError:
                        procs[r].join(5)
                        raise RuntimeError(
                            f"rank {r} exited with code {procs[r].exitcode} "
                            "before it sent a result") from None
                    if status != "ok":
                        raise RuntimeError(f"rank {r} failed:\n{payload}")
                    results[r] = payload
        finally:
            for p in procs:
                p.join(timeout=30 if not waiting else 0.1)
                if p.is_alive():
                    p.terminate()
                    p.join(5)
    return [results[r] for r in range(ranks)]
