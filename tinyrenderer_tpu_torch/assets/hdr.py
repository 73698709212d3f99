"""Radiance HDR (.hdr / RGBE) decode + encode, and a procedural sky.

The reference loads its HDR environment with the `radiant` crate
(src/texture.rs:166-192, src/equirectangular_to_cubemap_renderer.rs:32-38).
The bundled golf_course.hdr asset is not present in the reference checkout,
so the default environment here is a procedural sky; real .hdr files are
fully supported (both flat and adaptive-RLE scanline encodings).
"""

from __future__ import annotations

import numpy as np

F32 = np.float32


def decode_hdr(data: bytes) -> np.ndarray:
    """Decode a Radiance RGBE file into a (H, W, 3) float32 array.

    The scanline decode prefers the native C++ path (native/
    asset_loader.cpp tr_decode_hdr — the RLE inner loop is the loader's
    hot spot on large env maps); the Python loop below is the fallback
    and the semantic reference. Both feed the same rgbe_to_float, so the
    two paths are bit-identical (fuzz-tested in tests/test_native.py)."""
    try:
        from . import native
        rgbe_n = native.decode_hdr_rgbe(data)
    except Exception:  # noqa: BLE001 — loader must never hard-fail on this
        rgbe_n = None
    if rgbe_n is not None:
        return rgbe_to_float(rgbe_n)
    return _decode_hdr_py(data)


def _decode_hdr_py(data: bytes) -> np.ndarray:
    # --- header ---
    if not data.startswith(b"#?"):
        raise ValueError("not a Radiance HDR file (missing #? magic)")
    pos = 0
    lines = []
    while True:
        eol = data.index(b"\n", pos)
        line = data[pos:eol]
        pos = eol + 1
        if line == b"":
            break
        lines.append(line)
    dims = data[pos:data.index(b"\n", pos)].split()
    pos = data.index(b"\n", pos) + 1
    if dims[0] != b"-Y" or dims[2] != b"+X":
        raise ValueError(f"unsupported HDR orientation: {dims!r}")
    height, width = int(dims[1]), int(dims[3])

    rgbe = np.zeros((height, width, 4), np.uint8)
    buf = np.frombuffer(data, np.uint8, offset=pos)
    off = 0
    for y in range(height):
        # adaptive RLE scanline: 0x02 0x02 hi lo
        if width >= 8 and width <= 0x7FFF and off + 4 <= buf.size and \
                buf[off] == 2 and buf[off + 1] == 2 and \
                (int(buf[off + 2]) << 8 | int(buf[off + 3])) == width:
            off += 4
            for ch in range(4):
                x = 0
                while x < width:
                    count = int(buf[off]); off += 1
                    if count > 128:  # run
                        rgbe[y, x:x + count - 128, ch] = buf[off]
                        off += 1
                        x += count - 128
                    else:  # literal
                        rgbe[y, x:x + count, ch] = buf[off:off + count]
                        off += count
                        x += count
        else:  # flat scanline
            row = buf[off:off + width * 4].reshape(width, 4)
            rgbe[y] = row
            off += width * 4

    return rgbe_to_float(rgbe)


def rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp == 0, 0.0, np.ldexp(1.0, exp - 136)).astype(F32)
    return (rgbe[..., :3].astype(F32) + 0.5) * scale[..., None] * np.where(
        exp[..., None] == 0, 0.0, 1.0).astype(F32)


def float_to_rgbe(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img, F32)
    maxc = img.max(axis=-1)
    exp = np.zeros(maxc.shape, np.int32)
    mant = np.zeros(maxc.shape, F32)
    nz = maxc >= 1e-32
    mant[nz], exp[nz] = np.frexp(maxc[nz])
    scale = np.where(nz, mant * 256.0 / np.where(nz, maxc, 1.0), 0.0)
    rgbe = np.zeros((*img.shape[:-1], 4), np.uint8)
    rgbe[..., :3] = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(nz, exp + 128, 0).astype(np.uint8)
    return rgbe


def encode_hdr(img: np.ndarray, rle: bool = False) -> bytes:
    """Encode (H, W, 3) float32 to a Radiance file.

    rle=False writes flat scanlines; rle=True writes the adaptive-RLE
    scanline format real .hdr tools emit (runs >= 4 texels become
    (count+128, value) pairs, literals chunked at 128) — the encoding the
    decoders' RLE branch reads, exercised by the native-vs-Python fuzz
    differential."""
    h, w = img.shape[:2]
    header = (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
              + f"-Y {h} +X {w}\n".encode())
    rgbe = float_to_rgbe(img)
    if not rle or w < 8 or w > 0x7FFF:
        return header + rgbe.tobytes()
    out = bytearray(header)
    for y in range(h):
        out += bytes((2, 2, (w >> 8) & 0xFF, w & 0xFF))
        for ch in range(4):
            row = rgbe[y, :, ch]
            x = 0
            while x < w:
                # measure the run at x
                run = 1
                while x + run < w and row[x + run] == row[x] and run < 127:
                    run += 1
                if run >= 4:
                    out += bytes((128 + run, int(row[x])))
                    x += run
                else:
                    # literal chunk: until the next >=4 run or 128 texels
                    lit = x
                    while lit < w and lit - x < 128:
                        r = 1
                        while (lit + r < w and row[lit + r] == row[lit]
                               and r < 4):
                            r += 1
                        if r >= 4:
                            break
                        lit += r
                    # the short-repeat hop above can overshoot the 128-
                    # texel literal cap by up to 3; clamp and re-process
                    n = min(lit - x, 128)
                    out += bytes((n,)) + row[x:x + n].tobytes()
                    x += n
    return bytes(out)


def load_hdr(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_hdr(f.read())


def procedural_sky(height: int = 256, width: int = 512,
                   sun_direction=(0.35, 0.65, 0.4),
                   sun_intensity: float = 40.0) -> np.ndarray:
    """Simple analytic HDR sky: horizon gradient + sun disk + ground.

    Equirectangular layout: u in [0,1] -> azimuth (atan2 convention of
    equirectangular_to_cubemap.wgsl:48-56), v in [0,1] -> y from +1 (top)
    to -1 (bottom).
    """
    v, u = np.meshgrid(np.linspace(0, 1, height, endpoint=False) + 0.5 / height,
                       np.linspace(0, 1, width, endpoint=False) + 0.5 / width,
                       indexing="ij")
    # Invert the spherical map of the bake shader: u = atan2(z,x)*0.1591+0.5,
    # v = 1 - (asin(y)*0.3183 + 0.5)
    phi = (u - 0.5) / 0.1591
    theta = ((1.0 - v) - 0.5) / 0.3183
    y = np.sin(theta)
    c = np.cos(theta)
    x = c * np.cos(phi)
    z = c * np.sin(phi)

    sky_top = np.array([0.35, 0.55, 0.95], F32)
    sky_horizon = np.array([0.85, 0.9, 1.0], F32)
    ground = np.array([0.25, 0.22, 0.2], F32)

    t = np.clip(y, 0.0, 1.0)[..., None]
    sky = sky_horizon * (1.0 - t) + sky_top * t
    img = np.where(y[..., None] >= 0.0, sky, ground * (1.0 + 0.5 * y[..., None]))

    sd = np.asarray(sun_direction, F32)
    sd = sd / np.linalg.norm(sd)
    cosang = x * sd[0] + y * sd[1] + z * sd[2]
    disk = np.clip((cosang - 0.9995) / 0.0005, 0.0, 1.0) ** 2
    glow = np.clip(cosang, 0.0, 1.0) ** 64
    img = img + (disk * sun_intensity + glow * 0.5)[..., None] * np.array([1.0, 0.95, 0.85], F32)
    return img.astype(F32)
