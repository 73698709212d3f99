"""Build and load the hand-written Hopper kernels.

The CUDA sources under ``csrc/`` have a plain C interface. They are
compiled with one ``nvcc`` call into ``build/kernels/libtr_kernels_<hash>.so``
(the hash covers the sources and the flags, so an edited source rebuilds)
and loaded with ``ctypes``. The build happens on the first CUDA launch,
never at import, and never falls back: a failed build raises.

Every entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("raster.cu", "select_eval.cu", "shade.cu")
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
# no --use_fast_math: sqrt and division stay IEEE round-to-nearest.
# -fmad=false: no multiply-add is contracted behind the source's back; the
# kernels write every fused multiply-add they want as __fmaf_rn, in the
# places the plain versions spell out with ops/fp.py fma
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signature of every entry point: (argtypes), all return int
SIGNATURES = {
    # counts, rows, tri_id, depth, n_tiles, tiles_x, tile_h, tile_w, K,
    # width, mxu_order, stream
    "tr_raster": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # tri_id, table, outf, outh, H, W, T, D, n_attr, h_bf16, stream
    "tr_select_eval": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # consts, tri_id, outf, outh, gates, sky, hdr, H, W, cf, ch, h_bf16,
    # num_point, num_dir, has_ibl, stream
    "tr_shade": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                 _I, _P),
}

_lib: ctypes.CDLL | None = None
build_seconds: float | None = None   # wall time of the last build + load


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "cannot be built")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + ("common.cuh",):
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libtr_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless the hashed library exists; return it."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(CSRC / s) for s in SOURCES]]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}"
                           f"\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib, build_seconds
    if _lib is None:
        t0 = time.perf_counter()
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
        build_seconds = time.perf_counter() - t0
    return _lib


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(name: str, code: int) -> None:
    """Raise if a launch reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {code}")


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Every kernel operand on one CUDA device and contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all operands must be on one CUDA "
                             f"device (got {t.device})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
