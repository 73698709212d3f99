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


def _palette_332() -> np.ndarray:
    """(256, 3) uint8: the centres of 3-3-2 bit RGB cells."""
    i = np.arange(256)
    r, g, b = i >> 5, (i >> 2) & 7, i & 3
    return np.stack([r * 255 // 7, g * 255 // 7, b * 255 // 3],
                    1).astype(np.uint8)


def _lzw(indices: np.ndarray) -> bytes:
    """GIF LZW of 8-bit color indices (minimum code size 8): codes packed
    least significant bit first, the width growing from 9 to 12 bits and a
    clear code when the table is full."""
    clear, eoi = 256, 257
    out = bytearray()
    acc = nbits = 0

    def emit(code: int, width: int) -> None:
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    table: dict = {}
    width, nxt = 9, eoi + 1
    emit(clear, width)
    data = indices.tobytes()
    w = data[0]
    for c in data[1:]:
        key = (w << 8) | c
        code = table.get(key)
        if code is not None:
            w = code
            continue
        emit(w, width)
        if nxt < 4096:
            table[key] = nxt
            nxt += 1
            if nxt > (1 << width):
                width += 1
        else:
            emit(clear, width)
            table.clear()
            width, nxt = 9, eoi + 1
        w = c
    emit(w, width)
    emit(eoi, width)
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def encode_gif(frames: list, delay_ms: int = 83) -> bytes:
    """Frames of (H, W, 3) uint8 (or float in [0, 1]), all one size, to an
    animated GIF that loops: one global 3-3-2 bit palette, no dithering,
    ``delay_ms`` a frame (in the format's hundredths of a second). The
    standard library and numpy only: the card's machine has no PIL."""
    imgs = [_as_u8(f)[..., :3] for f in frames]
    if not imgs:
        raise ValueError("a GIF needs at least one frame")
    h, w, _ = imgs[0].shape
    if any(im.shape != imgs[0].shape for im in imgs):
        raise ValueError("every frame of a GIF must have the same size")
    head = [b"GIF89a", struct.pack("<HHBBB", w, h, 0xF7, 0, 0),
            _palette_332().tobytes(),
            b"\x21\xFF\x0BNETSCAPE2.0\x03\x01\x00\x00\x00"]   # loop forever
    body = []
    delay = max(1, round(delay_ms / 10))
    for im in imgs:
        idx = ((im[..., 0] >> 5) << 5) | ((im[..., 1] >> 5) << 2) | (im[..., 2] >> 6)
        data = _lzw(np.ascontiguousarray(idx, np.uint8))
        blocks = b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                          for i in range(0, len(data), 255))
        body += [b"\x21\xF9\x04\x04" + struct.pack("<H", delay) + b"\x00\x00",
                 b"\x2C" + struct.pack("<HHHHB", 0, 0, w, h, 0),
                 b"\x08" + blocks + b"\x00"]
    return b"".join(head + body) + b"\x3B"


def save_gif(path: str, frames: list, delay_ms: int = 83) -> None:
    with open(path, "wb") as f:
        f.write(encode_gif(frames, delay_ms))
