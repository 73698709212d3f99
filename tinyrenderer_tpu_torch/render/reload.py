"""Live kernel reload: the shader hot-recompile analog.

The reference stores each pipeline's shader path and mtime, rebuilds the
pipeline when the file changes, and traps compile errors so that the old
pipeline keeps running; recompilation stops at the first failure. Here
the "shaders" are two things:

- the Python modules under ``tinyrenderer_tpu_torch/ops``: a reload
  re-imports every module whose source file is newer, stops at the first
  module that fails, and keeps the old module (its mtime is not taken, so
  a fixed file reloads);
- the CUDA library (``kernels.reload``): on an engine on the card, the
  sources under ``csrc/`` are hashed again and, when they changed, the
  library is rebuilt by ``nvcc``, loaded, bound and swapped in. When
  ``nvcc`` fails the error carries its message and the old library goes on
  serving. This is the old pipeline that keeps running, not a fallback to
  the plain versions.

A graph captured before a reload goes on launching what it captured: the
old modules' glue and the old library's kernels. So every reload drops the
compiled frames (:func:`invalidate_compiled_frames`), as the reference
drops its jitted ones, and the next settled frame captures anew.
"""

from __future__ import annotations

import importlib
import logging
import os
import sys
from dataclasses import dataclass, field
from typing import List

from .. import kernels
from . import frame as framelib

log = logging.getLogger(__name__)

# Reload order respects intra-package dependencies (raster is imported as a
# module by shadows; resolve/shading/post/env/sampling are siblings).
_KERNEL_MODULES = (
    "tinyrenderer_tpu_torch.ops.raster",
    "tinyrenderer_tpu_torch.ops.sampling",
    "tinyrenderer_tpu_torch.ops.resolve",
    "tinyrenderer_tpu_torch.ops.shading",
    "tinyrenderer_tpu_torch.ops.shadows",
    "tinyrenderer_tpu_torch.ops.env",
    "tinyrenderer_tpu_torch.ops.post",
)
# the name a rebuilt CUDA library is reported under
LIBRARY = "tinyrenderer_tpu_torch.csrc"


@dataclass
class ReloadResult:
    """The reference's ShaderCompilationResult."""

    reloaded: List[str] = field(default_factory=list)
    error: str = ""

    @property
    def ok(self) -> bool:
        return not self.error

    @property
    def changed(self) -> bool:
        return bool(self.reloaded)


class KernelReloader:
    def __init__(self, modules=_KERNEL_MODULES):
        self.modules = modules
        self._mtimes: dict[str, float] = {}
        for name in self.modules:
            p = self._path(name)
            if p:
                self._mtimes[name] = os.path.getmtime(p)

    @staticmethod
    def _path(name: str) -> str:
        mod = sys.modules.get(name)
        if mod is None:
            mod = importlib.import_module(name)
        return getattr(mod, "__file__", "")

    def reload_if_changed(self, library: bool = False) -> ReloadResult:
        """Reload every module with a newer mtime, stopping at the first
        failure; then, with ``library`` (an engine on the card), rebuild
        and swap the CUDA library if its sources changed."""
        result = ReloadResult()
        for name in self.modules:
            p = self._path(name)
            if not p or not os.path.exists(p):
                continue
            mtime = os.path.getmtime(p)
            if mtime <= self._mtimes.get(name, 0.0):
                continue
            try:
                importlib.reload(sys.modules[name])
                self._mtimes[name] = mtime
                result.reloaded.append(name)
            except Exception as e:  # keep the old module running
                result.error = f"{name}: {e}"
                log.error("kernel reload failed: %s", result.error)
                return result
        if library:
            try:
                if kernels.reload():
                    result.reloaded.append(LIBRARY)
            # nvcc failed, or the new library did not load or lacks an
            # entry point: the old library goes on serving
            except (RuntimeError, OSError, AttributeError) as e:
                result.error = f"{LIBRARY}: {e}"
                log.error("kernel library rebuild failed: %s", result.error)
        return result


def invalidate_compiled_frames() -> None:
    """Drop every compiled frame and shadow atlas, with their graphs and
    memory pools: the next settled frame captures through the reloaded
    modules and library. The reference clears ``compiled_frame`` (and
    ``compiled_sharded_frame``) but keeps ``compiled_shadow_atlas``; a
    graph captured before ``kernels.reload()`` would keep launching the old
    library's kernels, so the atlas cache goes too. The port's sharded
    frame is a plain callable (gloo's collectives cannot be captured):
    nothing of it is cached."""
    framelib.compiled_frame.cache_clear()
    framelib.compiled_shadow_atlas.cache_clear()
