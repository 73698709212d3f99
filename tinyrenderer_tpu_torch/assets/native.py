"""ctypes binding for the native asset pipeline (native/asset_loader.cpp).

Builds the shared library from the repository's ``native/asset_loader.cpp``
on first use with g++, into the git-ignored ``build/native/``; every entry
point falls back to the pure-Python implementation in assets/mesh.py if
the toolchain or library is unavailable, so the engine never hard-depends
on a compiler at runtime.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import Optional

import numpy as np

log = logging.getLogger(__name__)

_ROOT = os.path.join(os.path.dirname(__file__), "..", "..")
_SRC = os.path.abspath(os.path.join(_ROOT, "native", "asset_loader.cpp"))
_LIB = os.path.abspath(os.path.join(_ROOT, "build", "native",
                                    "libtr_assets.so"))

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    tmp = f"{_LIB}.{os.getpid()}"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", tmp, _SRC,
           "-lz"]
    try:
        os.makedirs(os.path.dirname(_LIB), exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB)   # another process never loads a partial file
        return True
    except (OSError, subprocess.SubprocessError) as e:
        log.warning("native asset loader build failed (%s); using Python path", e)
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SRC):
            return None
        if (not os.path.exists(_LIB)
                or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError as e:
            log.warning("native asset loader load failed: %s", e)
            return None

        lib.tr_parse_obj.restype = ctypes.c_void_p
        lib.tr_parse_obj.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.tr_mesh_error.restype = ctypes.c_char_p
        lib.tr_mesh_error.argtypes = [ctypes.c_void_p]
        lib.tr_mesh_num_vertices.restype = ctypes.c_int64
        lib.tr_mesh_num_vertices.argtypes = [ctypes.c_void_p]
        lib.tr_mesh_num_indices.restype = ctypes.c_int64
        lib.tr_mesh_num_indices.argtypes = [ctypes.c_void_p]
        lib.tr_mesh_copy.restype = None
        lib.tr_mesh_copy.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 4
        lib.tr_mesh_free.restype = None
        lib.tr_mesh_free.argtypes = [ctypes.c_void_p]
        lib.tr_compute_tangents.restype = None
        lib.tr_compute_tangents.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
        lib.tr_box_downsample.restype = None
        lib.tr_box_downsample.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p]
        lib.tr_encode_png.restype = ctypes.c_void_p
        lib.tr_encode_png.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64)]
        lib.tr_png_free.restype = None
        lib.tr_png_free.argtypes = [ctypes.c_void_p]
        lib.tr_decode_hdr.restype = ctypes.c_void_p
        lib.tr_decode_hdr.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
        lib.tr_buf_free.restype = None
        lib.tr_buf_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def parse_obj_text(text: str):
    """Native OBJ parse -> (positions, tex_coords, normals, indices) float32
    arrays, or None if the native path is unavailable/failed."""
    lib = get_lib()
    if lib is None:
        return None
    data = text.encode()
    handle = lib.tr_parse_obj(data, len(data))
    if not handle:
        return None
    try:
        err = lib.tr_mesh_error(handle)
        if err:
            log.warning("native OBJ parse error: %s", err.decode())
            return None
        nv = lib.tr_mesh_num_vertices(handle)
        ni = lib.tr_mesh_num_indices(handle)
        positions = np.empty((nv, 3), np.float32)
        tex_coords = np.empty((nv, 2), np.float32)
        normals = np.empty((nv, 3), np.float32)
        indices = np.empty(ni, np.int32)
        lib.tr_mesh_copy(handle,
                         positions.ctypes.data, tex_coords.ctypes.data,
                         normals.ctypes.data, indices.ctypes.data)
        return positions, tex_coords, normals, indices
    finally:
        lib.tr_mesh_free(handle)


def parse_obj(path: str):
    """Parse an OBJ file natively; None -> caller uses the Python parser."""
    if get_lib() is None:
        return None
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        return parse_obj_text(f.read())


def compute_tangents(positions: np.ndarray, tex_coords: np.ndarray,
                     indices: np.ndarray):
    """Native tangent generation, or None for fallback."""
    lib = get_lib()
    if lib is None:
        return None
    p = np.ascontiguousarray(positions, np.float32)
    t = np.ascontiguousarray(tex_coords, np.float32)
    idx = np.ascontiguousarray(indices, np.int32)
    nv = p.shape[0]
    tangents = np.empty((nv, 3), np.float32)
    bitangents = np.empty((nv, 3), np.float32)
    lib.tr_compute_tangents(p.ctypes.data, t.ctypes.data, idx.ctypes.data,
                            nv, idx.size, tangents.ctypes.data,
                            bitangents.ctypes.data)
    return tangents, bitangents


def encode_png(img: np.ndarray):
    """Native PNG encode (Sub filter + zlib level 1) -> bytes, or None for
    the PIL fallback. img: (H, W, 3|4) uint8 contiguous."""
    lib = get_lib()
    if lib is None:
        return None
    a = np.ascontiguousarray(img)
    if a.dtype != np.uint8 or a.ndim != 3 or a.shape[-1] not in (3, 4):
        return None
    out_len = ctypes.c_int64(0)
    buf = lib.tr_encode_png(a.ctypes.data, a.shape[0], a.shape[1],
                            a.shape[2], ctypes.byref(out_len))
    if not buf or out_len.value <= 0:
        return None
    try:
        return ctypes.string_at(buf, out_len.value)
    finally:
        lib.tr_png_free(buf)


def decode_hdr_rgbe(data: bytes):
    """Native Radiance HDR scanline decode -> (H, W, 4) u8 RGBE array, or
    None for the Python fallback (unavailable lib OR malformed input — the
    Python decoder raises the descriptive error)."""
    lib = get_lib()
    if lib is None:
        return None
    w = ctypes.c_int64(0)
    h = ctypes.c_int64(0)
    buf = lib.tr_decode_hdr(data, len(data), ctypes.byref(w), ctypes.byref(h))
    if not buf or w.value <= 0 or h.value <= 0:
        return None
    try:
        flat = ctypes.string_at(buf, h.value * w.value * 4)
        return np.frombuffer(flat, np.uint8).reshape(h.value, w.value, 4)
    finally:
        lib.tr_buf_free(buf)


def box_downsample(img: np.ndarray):
    """Native 2x2 box filter (one mip step), or None for fallback."""
    lib = get_lib()
    if lib is None:
        return None
    a = np.ascontiguousarray(img, np.float32)
    h, w, c = a.shape
    out = np.empty((h // 2, w // 2, c), np.float32)
    lib.tr_box_downsample(a.ctypes.data, h, w, c, out.ctypes.data)
    return out
