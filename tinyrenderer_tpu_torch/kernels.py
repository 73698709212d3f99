"""Build and load the hand-written Hopper kernels.

The CUDA sources under ``csrc/`` (K1 + K4 + K6 ``raster.cu``, K2 + K5
``select_eval.cu``, K3 ``shade.cu``, K7 ``sampling.cu``, and the glue's
fused multiply-adds of ``ops/fp.py`` in ``fp.cu``) have a plain C
interface. Each is compiled by its own ``nvcc`` process, all started
together, and the objects are linked into
``build/kernels/libtr_kernels_<hash>.so`` (the hash covers the sources and
the flags, so an edited source rebuilds), loaded with ``ctypes``. The
build happens on the first CUDA launch, never at import, and never falls
back: a failed build raises. :func:`reload` rebuilds after an edit of the
sources and swaps the library only once the new one is built, loaded and
bound; every wrapper calls :func:`library` at each launch, so the swap
reaches every kernel.

Every launching entry point returns ``cudaGetLastError()`` after its launch;
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
SOURCES = ("raster.cu", "select_eval.cu", "shade.cu", "sampling.cu", "fp.cu")
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
# no --use_fast_math: sqrt and division stay IEEE round-to-nearest.
# -fmad=false: no multiply-add is contracted behind the source's back; the
# kernels write every fused multiply-add they want as __fmaf_rn, in the
# places the plain versions spell out with ops/fp.py fma
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH + ("-std=c++17", "-O3", "-fmad=false", "-Xcompiler",
                     "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int

FP_DIMS = 6    # csrc/fp.cu TR_FP_DIMS
FP_SLOTS = 8   # csrc/fp.cu TR_FP_SLOTS: a0 b0 a1 b1 a2 b2 c d


class FpOperand(ctypes.Structure):
    """csrc/fp.cu ``FpOperand``: a pointer with element strides, or a
    by-value float (``ptr`` null)."""
    _fields_ = [("ptr", _P), ("stride", ctypes.c_longlong * FP_DIMS),
                ("value", ctypes.c_float), ("dtype", _I)]


class FpArgs(ctypes.Structure):
    """csrc/fp.cu ``FpArgs``, passed by value to the ``tr_fp_*`` entry
    points and on to the kernel as its parameter."""
    _fields_ = [("op", FpOperand * FP_SLOTS),
                ("shape", ctypes.c_longlong * FP_DIMS),
                ("n", ctypes.c_longlong), ("ndim", _I), ("n_pairs", _I),
                ("has_c", _I), ("has_d", _I), ("lerp", _I), ("root", _I),
                ("used", _I), ("path", _I), ("vec", _I),
                ("magic", ctypes.c_uint * FP_DIMS), ("shift", _I * FP_DIMS)]

# C signature of every entry point: (argtypes); all return int but those
# of RETURNS
SIGNATURES = {
    # n_tiles, tile_h, tile_w, K -> bytes of zeroed scratch tr_raster needs
    "tr_raster_scratch_bytes": (_I, _I, _I, _I),
    # counts, rows, tri_id, depth, scratch, n_tiles, tiles_x, tile_h,
    # tile_w, K, width, mxu_order, stream
    "tr_raster": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # n_tiles, tile_h, tile_w, Ls -> bytes of scratch tr_raster_stream needs
    "tr_raster_stream_scratch_bytes": (_I, _I, _I, _I),
    # starts, rows, tri_id, depth, scratch, n_tiles, tiles_x, tile_h,
    # tile_w, kb, nb, Ls, width, mxu_order, stream
    "tr_raster_stream": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                         _I, _P),
    # counts, rows, table, tri_id, depth, sel, n_tiles, tiles_x, tile_h,
    # tile_w, K, width, T, D, mxu_order, stream
    "tr_raster_resolve": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                          _I, _I, _P),
    # tri_id, table, outf, outh, H, W, T, D, n_attr, h_bf16, stream
    "tr_select_eval": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # tri_id, starts, ids, table, outf, outh, H, W, D, n_attr, h_bf16,
    # tiles_x, tile_h, tile_w, kb, nb, stream
    "tr_select_eval_stream": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _I, _I, _I, _I, _I, _P),
    # consts, tri_id, outf, outh, rec, gates, sky, hdr, H, W, cf, ch,
    # h_bf16, num_point, num_dir, has_ibl, stream
    "tr_shade": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                 _I, _I, _P),
    # texels, idx, fx, fy, out, R, C, N, channel_first, stream
    "tr_windowed_blend": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # -> sizeof(FpArgs), checked against the ctypes mirror before a
    # library's first fp launch (ops/fp.py)
    "tr_fp_args_bytes": (),
    # args (FpArgs by value), out, stream: one per ops/fp.py entry point
    "tr_fp_fma": (FpArgs, _P, _P),
    "tr_fp_lerp": (FpArgs, _P, _P),
    "tr_fp_plane": (FpArgs, _P, _P),
    "tr_fp_sqrt": (FpArgs, _P, _P),
    "tr_fp_chain": (FpArgs, _P, _P),
}

RETURNS = {"tr_raster_scratch_bytes": ctypes.c_longlong,
           "tr_raster_stream_scratch_bytes": ctypes.c_longlong}

_lib: ctypes.CDLL | None = None
_lib_path: Path | None = None        # the file _lib was loaded from
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


def _check_nvcc(cmd: list, stdout: str, stderr: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"nvcc failed ({code}):\n{' '.join(cmd)}\n{stdout}"
                           f"\n{stderr}")


def build() -> Path:
    """Compile the kernels unless the hashed library exists; return it."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{Path(s).stem}.o" for s in SOURCES]
    jobs = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)]
            for s, o in zip(SOURCES, objs)]
    try:
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for cmd in jobs]
        outs = [p.communicate() for p in procs]   # wait for every compile
        for cmd, p, (so, se) in zip(jobs, procs, outs):
            _check_nvcc(cmd, so, se, p.returncode)
        tmp = BUILD_DIR / f"{tag}.tmp"
        link = [nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)]
        res = subprocess.run(link, capture_output=True, text=True)
        _check_nvcc(link, res.stdout, res.stderr, res.returncode)
        os.replace(tmp, out)
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    return out


def _build_and_load() -> ctypes.CDLL:
    """Build the library of the current sources, load and bind it, then
    make it the one every launch uses."""
    global _lib, _lib_path, build_seconds
    t0 = time.perf_counter()
    path = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = RETURNS.get(name, ctypes.c_int)
    _lib, _lib_path = lib, path
    build_seconds = time.perf_counter() - t0
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    return _lib if _lib is not None else _build_and_load()


def reload() -> bool:
    """Rebuild the library if the sources under ``CSRC`` changed since it
    was loaded, and swap it in once built, loaded and bound: True when it
    was swapped. A failed build raises and the loaded library keeps
    serving. Without a loaded library there is nothing to swap (the next
    launch builds from the current sources); on unchanged sources nothing
    is compiled. A new source hash names a new file, so ``dlopen`` never
    hands back the handle of an older build under the same name."""
    if _lib is None or library_path() == _lib_path:
        return False
    _build_and_load()
    return True


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
