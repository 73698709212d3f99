"""The compiled frame: a frame function captured once per configuration
as a CUDA graph and replayed (the counterpart of the reference's
``jax.jit``).

On the TPU a frame of the JAX engine is one compiled program: ``jax.jit``
traces the frame function once per static ``RenderConfig`` and argument
layout, and every later call runs that program. On the card the same unit
is a ``torch.cuda.CUDAGraph``. A :class:`CompiledFn` wraps a function of
tensors and dataclasses of tensors (``SceneGPU``, ``LightsGPU``, the
texture pools, ``EnvGPU``):

- **The key** is jit's trace key: the shape, dtype and device of every
  tensor argument, the class and static fields of every dataclass argument
  (the pools' layout: ``level_offsets``, ``level_sizes``,
  ``texels_per_tex``, ``windowed``, ``u8``, ``morton``; the native pool's
  ``max_levels`` and ``base_size``), and which optional arguments are None
  (``atlas``, ``env.sky_rgbe``).
- **The first call under a key** copies the arguments into slots the entry
  owns, runs the function once eagerly on the slots (the warm-up: the
  kernel library is built on its first launch and every Python-side cache
  the frame reads is filled outside the capture), captures it on the slots
  into a graph, and replays the graph.
- **Every later call** copies its arguments into the slots and replays. A
  tensor of at most ``SMALL_BYTES`` (the camera, the parameters) is copied
  at every call; a larger one (the scene, the lights, the pool's texels,
  the environment, the atlas) only when its identity or its ``_version``
  changed since its last copy, so a repack, an atlas re-render, an
  environment bake or an in-place edit reaches the graph with no new
  capture, as new arguments reach a jitted function. The slots lie on the
  graph's device and the copies do not block: an argument in pinned host
  memory (the engine's camera) goes up with its copy.
- **The outputs** are cloned after the replay: the caller gets fresh
  tensors, as jit returns new arrays, and may hold a frame across frames.
- **Launch counters.** A kernel captured into a graph counts its launch
  when it is recorded, not when it runs. The counts a capture added are
  taken back and added again at every replay, so ``K1_LAUNCHES`` ...
  ``K7_LAUNCHES`` and ``ops/fp.py``'s counters count what the card ran.

Each graph keeps its transient memory in a private pool for as long as the
entry lives (``frame.compiled_frame``'s cache of 8 configurations;
``reload.invalidate_compiled_frames`` drops them all).

On the CPU a CompiledFn calls the function directly: that is the CPU path
the caller asked for. On a CUDA device a failed capture or replay raises;
nothing renders eagerly in its place.
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Any, Callable, Optional

import torch

from ..ops import fp, raster, resolve, sampling, shading

# a tensor of at most this many bytes is copied into its slot at every call
SMALL_BYTES = 4096

_COUNTERS = (("K1", raster, "K1_LAUNCHES"), ("K2", resolve, "K2_LAUNCHES"),
             ("K3", shading, "K3_LAUNCHES"), ("K4", raster, "K4_LAUNCHES"),
             ("K5", resolve, "K5_LAUNCHES"), ("K6", raster, "K6_LAUNCHES"),
             ("K7", sampling, "K7_LAUNCHES"),
             # the glue's fused multiply-adds (csrc/fp.cu), one an entry
             ("fp.fma", fp, "FMA_LAUNCHES"), ("fp.lerp", fp, "LERP_LAUNCHES"),
             ("fp.plane", fp, "PLANE_LAUNCHES"),
             ("fp.sqrt", fp, "SQRT_LAUNCHES"),
             ("fp.fma_chain", fp, "CHAIN_LAUNCHES"))


def launch_counts() -> dict:
    """The kernels' launch counters: K1 ... K7, then the fp kernels."""
    return {k: getattr(mod, name) for k, mod, name in _COUNTERS}


def add_launches(delta: dict) -> None:
    """Add ``delta`` (a counter's key -> n) to the launch counters."""
    for k, mod, name in _COUNTERS:
        setattr(mod, name, getattr(mod, name) + delta.get(k, 0))


def reset_launches() -> None:
    """Set every launch counter to 0."""
    for _, mod, name in _COUNTERS:
        setattr(mod, name, 0)


class _CudaGraph:
    """The capture backend on a CUDA device: ``torch.cuda.CUDAGraph``."""

    def __init__(self, device: torch.device):
        self.device = device
        self.graph = torch.cuda.CUDAGraph()
        self.dump_path = None

    def debug_dump_to(self, path: str) -> None:
        """Keep the captured graph's nodes (a graph that keeps them and is
        in debug mode before the capture) and write them to ``path`` as a
        DOT file once it is instantiated."""
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        self.graph.enable_debug_mode()
        self.dump_path = path

    def warm_up(self, run: Callable[[], Any]) -> None:
        # on a side stream, as PyTorch's capture recipe warms up
        stream = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            run()
        stream.wait_stream(side)

    def capture(self, run: Callable[[], Any]) -> Any:
        with torch.cuda.graph(self.graph):
            out = run()
        if self.dump_path:
            self.graph.instantiate()
            self.graph.debug_dump(self.dump_path)
        return out

    def replay(self) -> None:
        self.graph.replay()


def capture_backend(device: torch.device):
    """What a CompiledFn captures into on ``device``: a CUDA graph on a
    CUDA device; None elsewhere, where the function is called directly.
    (The CPU tests put a stand-in here.)"""
    return _CudaGraph(device) if device.type == "cuda" else None


def _flatten(x, leaves: list, key: list) -> Callable:
    """Append the tensors of ``x`` to ``leaves`` and its static layout to
    ``key``; return a function that rebuilds ``x`` from an iterator over
    tensors in ``leaves``' order."""
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        key.append((tuple(x.shape), x.dtype, x.device))
        return lambda it: next(it)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        key.append(type(x))
        parts = [(f.name, _flatten(getattr(x, f.name), leaves, key))
                 for f in dataclasses.fields(x) if f.init]
        return lambda it: dataclasses.replace(
            x, **{name: part(it) for name, part in parts})
    if isinstance(x, dict):
        key.append((dict, tuple(x)))
        parts = [(k, _flatten(v, leaves, key)) for k, v in x.items()]
        return lambda it: {k: part(it) for k, part in parts}
    if isinstance(x, (tuple, list)):
        key.append((type(x), len(x)))
        parts = [_flatten(v, leaves, key) for v in x]
        return lambda it: type(x)(part(it) for part in parts)
    key.append(x)          # a static value: None, a number, a string
    return lambda it: x


def _clone(x):
    """A copy of an output tree whose tensors are fresh."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _clone(getattr(x, f.name))
            for f in dataclasses.fields(x) if f.init})
    if isinstance(x, (tuple, list)):
        return type(x)(_clone(v) for v in x)
    return x


class _Entry:
    """One key's graph: the argument slots, the captured outputs and the
    launches a replay makes."""

    def __init__(self, fn: Callable, rebuild: Callable, leaves: list,
                 graph):
        self.slots = [torch.empty_like(x, device=graph.device,
                                       memory_format=torch.contiguous_format)
                      for x in leaves]
        self._src: list = [None] * len(leaves)    # weakref of the last copy
        self._version = [0] * len(leaves)
        self.load(leaves)
        self.args, self.kwargs = rebuild(iter(self.slots))
        self.graph = graph
        t0 = time.perf_counter()

        def run():
            return fn(*self.args, **self.kwargs)

        graph.warm_up(run)
        before = launch_counts()
        self.out = graph.capture(run)
        after = launch_counts()
        # the capture recorded these launches; the card runs them at replay
        self.launches = {k: after[k] - before[k] for k in after}
        add_launches({k: -n for k, n in self.launches.items()})
        self.capture_ms = (time.perf_counter() - t0) * 1e3

    def load(self, leaves: list) -> None:
        """Copy the arguments into the slots (see the module notes)."""
        for i, (slot, x) in enumerate(zip(self.slots, leaves)):
            if slot.numel() * slot.element_size() > SMALL_BYTES:
                src = self._src[i]
                if (src is not None and src() is x
                        and x._version == self._version[i]):
                    continue
                self._src[i], self._version[i] = weakref.ref(x), x._version
            slot.copy_(x, non_blocking=True)

    def replay(self):
        self.graph.replay()
        add_launches(self.launches)
        return _clone(self.out)


class CompiledFn:
    """``fn`` compiled as the module notes say: called as ``fn`` is, it
    returns what ``fn`` returns on the same arguments. ``debug_dump``: a
    path each capture writes its graph to as a DOT file
    (``CUDAGraph.debug_dump``; ``tools/dump_graph.py`` passes it)."""

    def __init__(self, fn: Callable, debug_dump: Optional[str] = None):
        self.fn = fn
        self.debug_dump = debug_dump
        self._entries: dict = {}

    def __call__(self, *args, **kwargs):
        leaves, key = [], []
        rebuild = _flatten((args, kwargs), leaves, key)
        key = tuple(key)
        entry = self._entries.get(key)
        if entry is None:
            # the graph's device: that of the first argument off the host
            dev = next((x.device for x in leaves if x.device.type != "cpu"),
                       torch.device("cpu"))
            graph = capture_backend(dev)
            if graph is None:
                return self.fn(*args, **kwargs)
            if self.debug_dump:
                graph.debug_dump_to(self.debug_dump)
            entry = self._entries[key] = _Entry(self.fn, rebuild, leaves,
                                                graph)
        else:
            entry.load(leaves)
        return entry.replay()

    @property
    def captured(self) -> bool:
        """Whether a graph was captured (never on the CPU)."""
        return bool(self._entries)

    @property
    def capture_ms(self) -> list:
        """Host ms of each entry's warm-up and capture, in capture order."""
        return [e.capture_ms for e in self._entries.values()]
