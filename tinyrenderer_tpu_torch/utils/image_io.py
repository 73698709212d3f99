"""Image output helpers (the swapchain/present + screenshot analog).

The reference writes and encodes PNGs with PIL; the card's machine has no
PIL, so the port encodes with the repository's native encoder
(``native/asset_loader.cpp`` ``tr_encode_png``: Sub filter + zlib level 1,
through ``assets/native``) and, where that library cannot be built, with
the standard library (``zlib`` + ``struct``: filter 0, zlib level 1).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from ..assets import native


def _as_u8(img: np.ndarray) -> np.ndarray:
    a = np.asarray(img)
    if a.dtype != np.uint8:
        a = np.clip(a * 255.0 + 0.5, 0, 255).astype(np.uint8)
    if a.ndim != 3 or a.shape[-1] not in (3, 4):
        raise ValueError(f"expected an (H, W, 3|4) image, got {a.shape}")
    return np.ascontiguousarray(a)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data)))


def _encode_png_zlib(a: np.ndarray) -> bytes:
    """(H, W, 3|4) uint8 -> PNG bytes with the standard library: every
    scanline unfiltered (filter byte 0), zlib level 1."""
    h, w, c = a.shape
    raw = np.zeros((h, 1 + w * c), np.uint8)
    raw[:, 1:] = a.reshape(h, w * c)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6 if c == 4 else 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 1))
            + _chunk(b"IEND", b""))


def encode_png(img: np.ndarray) -> bytes:
    """Encode (H, W, 3|4) uint8 (or float in [0, 1]) to PNG bytes (viewer
    frame streaming): the native encoder, else the standard library's."""
    a = _as_u8(img)
    out = native.encode_png(a)
    return out if out is not None else _encode_png_zlib(a)


def save_png(path: str, img: np.ndarray) -> None:
    """img: (H, W, 3|4) uint8 or float in [0, 1]."""
    with open(path, "wb") as f:
        f.write(encode_png(img))


def save_pfm_like_npy(path: str, img: np.ndarray) -> None:
    np.save(path, np.asarray(img, np.float32))
