"""Texture sampling (port of ops/sampling.py): the pooled material
textures and the cubemaps.

Material textures live in one static pool (:class:`TexturePoolGPU`): level
``l`` of record ``t`` is a contiguous region of a flattened texel array,
row-major or in Morton order, so any (record, level, y, x) sample is one
gather. A *windowed* pool row carries the texel and its +x, +y and +x+y
neighbours, so a bilinear tap is one row. The default pool is windowed
u8 with 9 channels; its taps go through kernel K7 (``csrc/sampling.cu``):
row gather, decode and bilinear blend in one pass.

The native-size pool (:class:`NativeTexturePoolGPU`,
``cfg.native_texture_pool``) keeps each material record at its own size and
level count, addressed through two small tables; its windowed u8 taps go
through K7 as well.

Cubemaps are (6, S, S, C) with the face order +X, -X, +Y, -Y, +Z, -Z.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from .fp import fma, lerp

F32 = torch.float32
I32 = torch.int32
U8 = torch.uint8

K7_LAUNCHES = 0    # CUDA launches of the windowed blend kernel


@dataclass
class TexturePoolGPU:
    """Flattened mip-pyramid pool on a device; every field but ``texels``
    is static layout."""

    texels: torch.Tensor          # (n * texels_per_tex, C | 4C) f32 or u8
    level_offsets: tuple          # per-level row offset inside a record
    level_sizes: tuple            # per-level edge length
    texels_per_tex: int
    windowed: bool = False        # rows hold [self | +x | +y | +x+y]
    base_channels: int = 4        # C
    u8: bool = False              # texels stored as round(255 * value)
    morton: bool = False          # Z-curve texel order inside a level

    def _decode(self, rows: torch.Tensor) -> torch.Tensor:
        return rows.to(F32) * (1.0 / 255.0) if self.u8 else rows

    @functools.cached_property
    def level_tables(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(sizes, offsets) (L,) i32 on the pool's device, uploaded once:
        a frame that indexes them uploads nothing (a captured frame must
        not)."""
        dev = self.texels.device
        return (torch.tensor(self.level_sizes, dtype=I32, device=dev),
                torch.tensor(self.level_offsets, dtype=I32, device=dev))

    def _texel_index(self, yi: torch.Tensor, xi: torch.Tensor,
                     sizes: torch.Tensor) -> torch.Tensor:
        return _morton2(yi, xi) if self.morton else yi * sizes + xi


def _part1by1(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 16 bits of v (int32 or int64) to even bit positions."""
    v = v & 0xFFFF
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    return (v | (v << 1)) & 0x55555555


def _morton2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Interleave (y, x) -> Z-curve index (power-of-two level sizes)."""
    return (_part1by1(y) << 1) | _part1by1(x)


def window_rows(img: np.ndarray, wrap: bool = True) -> np.ndarray:
    """(..., s, s, C) -> (..., s, s, 4C) on the host: [self | +x | +y |
    +x+y] (:func:`window_rows_device`)."""
    return window_rows_device(torch.from_numpy(np.ascontiguousarray(img)),
                              wrap).numpy()


def window_rows_device(img: torch.Tensor, wrap: bool = True) -> torch.Tensor:
    """(..., s, s, C) -> (..., s, s, 4C): each texel beside its +x, +y and
    +x+y neighbours, wrapping or clamped at the edge."""
    if wrap:
        right = torch.roll(img, -1, dims=-2)
        down = torch.roll(img, -1, dims=-3)
        diag = torch.roll(down, -1, dims=-2)
    else:
        right = torch.cat([img[..., :, 1:, :], img[..., :, -1:, :]], -2)
        down = torch.cat([img[..., 1:, :, :], img[..., -1:, :, :]], -3)
        diag = torch.cat([down[..., :, 1:, :], down[..., :, -1:, :]], -2)
    return torch.cat([img, right, down, diag], dim=-1)


def remip_pool_device(pool: TexturePoolGPU,
                      wrap: bool = True) -> TexturePoolGPU:
    """Every record's mip chain rebuilt from its level-0 texels on the
    pool's device (2x2 box reductions, :func:`post.box_mip`), re-windowed
    and re-quantized as packed: the runtime re-mip after level 0 changed
    on the device. Same static layout; ``wrap`` must match the pack. Needs
    a row-major pool whose levels halve."""
    from . import post
    sizes = pool.level_sizes
    if pool.morton or any(sizes[i] != 2 * sizes[i + 1]
                          for i in range(len(sizes) - 1)):
        raise ValueError("remip_pool_device needs a row-major pool whose "
                         "levels halve")
    tpt, C, S0 = pool.texels_per_tex, pool.base_channels, sizes[0]
    Cw = pool.texels.shape[-1]
    n = pool.texels.shape[0] // tpt
    off0 = pool.level_offsets[0]
    lvl0 = pool.texels.reshape(n, tpt, Cw)[:, off0:off0 + S0 * S0]
    mips = [pool._decode(lvl0.reshape(n, S0, S0, Cw)[..., :C])]
    for _ in sizes[1:]:
        mips.append(post.box_mip(mips[-1]))
    if pool.windowed:
        mips = [window_rows_device(m, wrap) for m in mips]
    flat = torch.cat([m.reshape(n, s * s, Cw) for m, s in zip(mips, sizes)],
                     dim=1).reshape(n * tpt, Cw)
    if pool.u8:
        flat = (flat * 255.0 + 0.5).clamp(0, 255).to(U8)
    return TexturePoolGPU(flat, pool.level_offsets, sizes, tpt,
                          pool.windowed, C, pool.u8, pool.morton)


def pack_texture_pool(mips: list, windowed: bool = False, wrap: bool = True,
                      u8: bool = False, morton: bool = False,
                      device="cpu") -> TexturePoolGPU:
    """Flatten host mips [(n, s, s, C) per level] into one pool on
    ``device``. ``u8`` stores ``round(255 * v)`` (v in [0, 1]); ``morton``
    stores each level in Z-curve order (power-of-two sizes only)."""
    n = mips[0].shape[0]
    base_channels = mips[0].shape[-1]
    if windowed:
        mips = [window_rows(m, wrap) for m in mips]
    channels = mips[0].shape[-1]
    level_sizes = tuple(int(m.shape[1]) for m in mips)
    if morton and any(s & (s - 1) for s in level_sizes):
        raise ValueError("morton layout needs power-of-two level sizes")
    offsets = tuple(int(sum(s * s for s in level_sizes[:i]))
                    for i in range(len(level_sizes)))
    tpt = sum(s * s for s in level_sizes)
    flat = np.zeros((n, tpt, channels), np.float32)
    for m, s, off in zip(mips, level_sizes, offsets):
        region = m.reshape(n, s * s, channels)
        if morton:
            ys, xs = np.mgrid[0:s, 0:s]
            z = _morton2(torch.from_numpy(ys.reshape(-1)),
                         torch.from_numpy(xs.reshape(-1))).numpy()
            reordered = np.empty_like(region)
            reordered[:, z] = region          # row-major texel -> Z slot
            region = reordered
        flat[:, off:off + s * s] = region
    flat = flat.reshape(n * tpt, channels)
    if u8:
        flat = np.clip(flat * 255.0 + 0.5, 0, 255).astype(np.uint8)
    return TexturePoolGPU(torch.as_tensor(flat, device=device), offsets,
                          level_sizes, tpt, windowed, base_channels, u8,
                          morton)


def pool_from_numpy(fields: dict, device) -> TexturePoolGPU:
    """TexturePoolGPU from host fields named as its own: the port's pack,
    or the JAX pool's ``vars()`` (texels fetched with ``np.asarray``)."""
    return TexturePoolGPU(
        texels=torch.as_tensor(np.array(fields["texels"]), device=device),
        level_offsets=tuple(int(o) for o in fields["level_offsets"]),
        level_sizes=tuple(int(s) for s in fields["level_sizes"]),
        texels_per_tex=int(fields["texels_per_tex"]),
        windowed=bool(fields["windowed"]),
        base_channels=int(fields["base_channels"]),
        u8=bool(fields["u8"]), morton=bool(fields["morton"]))


# ---- K7: the windowed u8 bilinear tap --------------------------------------

def windowed_blend_ref(texels: torch.Tensor, idx: torch.Tensor,
                       fx: torch.Tensor, fy: torch.Tensor, C: int,
                       channel_first: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K7 (any device).

    texels (R, 4C) u8 windowed rows; idx (N,) i32 row indices (clamped to
    the pool); fx, fy (N,) f32 corner fractions -> (N, C) f32, or (C, N)
    with ``channel_first``. Decode ``q * (1/255)``, then
    ``lerp(lerp(c00, c10, fx), lerp(c01, c11, fx), fy)`` with the
    reference's fused multiply-adds (``fp.lerp``)."""
    R = texels.shape[0]
    rows = texels[idx.long().clamp(0, R - 1)].to(F32) * (1.0 / 255.0)
    fx, fy = fx[:, None], fy[:, None]
    out = lerp(lerp(rows[:, 0:C], rows[:, C:2 * C], fx),
               lerp(rows[:, 2 * C:3 * C], rows[:, 3 * C:4 * C], fx), fy)
    return out.T.contiguous() if channel_first else out


def windowed_blend(texels: torch.Tensor, idx: torch.Tensor, fx: torch.Tensor,
                   fy: torch.Tensor, C: int,
                   channel_first: bool = False) -> torch.Tensor:
    """Windowed u8 bilinear tap: :func:`windowed_blend_ref`'s contract.
    CPU tensors take the plain version; CUDA tensors launch K7."""
    if texels.device.type == "cpu":
        return windowed_blend_ref(texels, idx, fx, fy, C, channel_first)
    global K7_LAUNCHES
    R, C4 = texels.shape
    N = idx.shape[0]
    if (texels.dtype != U8 or C4 != 4 * C or idx.dtype != I32
            or fx.dtype != F32 or fy.dtype != F32
            or idx.shape != fx.shape or fx.shape != fy.shape
            or idx.ndim != 1):
        raise ValueError("windowed_blend takes (R, 4C) u8 texels and (N,) "
                         "i32 indices + f32 fractions")
    ops = [texels.contiguous(), idx.contiguous(), fx.contiguous(),
           fy.contiguous()]
    kernels.require_cuda("windowed_blend", *ops)
    if ops[0].data_ptr() % 4:
        raise ValueError("windowed_blend reads the pool's rows as 32-bit "
                         "words: the texels must start on a 4-byte boundary "
                         "(a view into a u8 buffer at an odd offset does "
                         "not)")
    out = torch.empty((C, N) if channel_first else (N, C), dtype=F32,
                      device=texels.device)
    if N:
        code = kernels.library().tr_windowed_blend(
            *(t.data_ptr() for t in ops), out.data_ptr(), R, C, N,
            int(channel_first), kernels.stream_handle(texels.device))
        kernels.check("tr_windowed_blend", code)
        K7_LAUNCHES += 1
    return out


# ---- samplers ---------------------------------------------------------------

def _level_address(pool: TexturePoolGPU, level_i: torch.Tensor):
    """Per-pixel (size, offset) of an int32 level: closed form on a
    power-of-two chain, else a lookup in the pool's level tables."""
    S0 = pool.level_sizes[0]
    if all(s == S0 >> i and o == (S0 * S0 - (S0 >> i) ** 2) * 4 // 3
           for i, (s, o) in enumerate(zip(pool.level_sizes,
                                          pool.level_offsets))):
        sizes = torch.full_like(level_i, S0) >> level_i
        return sizes, (S0 * S0 - sizes * sizes) * 4 // 3
    li = level_i.long()
    sizes, offsets = pool.level_tables
    return sizes[li], offsets[li]


_HALF = torch.tensor(-0.5)   # texel-centre shift: uv * size - 0.5, fused


def _clip(x: torch.Tensor, sizes: torch.Tensor) -> torch.Tensor:
    return torch.minimum(x.clamp(min=0), sizes - 1)


def _sample_bilinear_dynamic_level(pool: TexturePoolGPU, tex: torch.Tensor,
                                   uv: torch.Tensor, level_i: torch.Tensor,
                                   wrap: bool,
                                   channel_first: bool = False
                                   ) -> torch.Tensor:
    """Bilinear sample at a per-pixel int32 mip level. tex (...) i32
    records, uv (..., 2) -> (..., C), or (C, ...) with ``channel_first``.
    A windowed pool reads one row a tap (K7 when u8), others four."""
    sizes, offs = _level_address(pool, level_i)
    sf = sizes.to(F32)
    u = fma(uv[..., 0], sf, _HALF)
    v = fma(uv[..., 1], sf, _HALF)
    if wrap:
        u = torch.remainder(u, sf)         # floor-mod, as jnp.mod
        v = torch.remainder(v, sf)
    x0, y0 = torch.floor(u), torch.floor(v)
    fx, fy = u - x0, v - y0
    x0i, y0i = x0.to(I32), y0.to(I32)
    if wrap:
        x1i = torch.remainder(x0i + 1, sizes)
        y1i = torch.remainder(y0i + 1, sizes)
        x0i = torch.remainder(x0i, sizes)
        y0i = torch.remainder(y0i, sizes)
    else:
        x1i = torch.minimum(x0i + 1, sizes - 1)
        y1i = torch.minimum(y0i + 1, sizes - 1)
    base = tex * pool.texels_per_tex + offs
    C = pool.base_channels
    shape = tuple(base.shape)

    if pool.windowed:
        idx = base + pool._texel_index(_clip(y0i, sizes), _clip(x0i, sizes),
                                       sizes)
        if pool.u8:
            out = windowed_blend(pool.texels, idx.reshape(-1),
                                 fx.reshape(-1), fy.reshape(-1), C,
                                 channel_first)
            return out.reshape(((C,) + shape) if channel_first
                               else (shape + (C,)))
        row = pool.texels[idx.long()]
        fx, fy = fx[..., None], fy[..., None]
        out = lerp(lerp(row[..., 0:C], row[..., C:2 * C], fx),
                   lerp(row[..., 2 * C:3 * C], row[..., 3 * C:4 * C], fx), fy)
        return out.movedim(-1, 0) if channel_first else out

    def texel(xi, yi):
        i = base + pool._texel_index(_clip(yi, sizes), _clip(xi, sizes), sizes)
        return pool.texels[i.long()]

    out = _blend4(pool.u8, texel(x0i, y0i), texel(x1i, y0i),
                  texel(x0i, y1i), texel(x1i, y1i), fx, fy)
    return out.movedim(-1, 0) if channel_first else out


def _blend4(u8: bool, t00, t10, t01, t11, fx, fy) -> torch.Tensor:
    """Bilinear blend of four gathered texel rows (..., C) at fractions
    (...) with the reference's rounding."""
    fx, fy = fx[..., None], fy[..., None]
    if u8:
        # the reference's compiler moves the decode scale onto the weights:
        # q00 * ((1 - fx) / 255) + q10 * (fx / 255), then fused as fp.lerp
        t00, t10, t01, t11 = (t.to(F32) for t in (t00, t10, t01, t11))
        w0, w1 = (1.0 - fx) * (1.0 / 255.0), fx * (1.0 / 255.0)
        return fma(fma(t00, w0, t10 * w1), 1.0 - fy,
                   fma(t01, w0, t11 * w1) * fy)
    return lerp(lerp(t00, t10, fx), lerp(t01, t11, fx), fy)


# unbounded: a captured frame graph reads these tensors, and one evicted
# and freed while such a graph lives would hand its memory to another
# tensor (a handful of shapes a resolution, three phases)
@functools.lru_cache(maxsize=None)
def _bayer_threshold(shape2d: tuple, device, phase: int = 0) -> torch.Tensor:
    """(h, w) tiled 4x4 Bayer thresholds in (0, 1); ``phase`` rotates the
    pattern so independent decisions (mip level, u, v) decorrelate.
    Cached per shape, device and phase (a frame asks for the same few up
    to three times a sample site; callers only read it). Computed where it
    is used, with no upload: entry k of the reference's
    flattened table rolled by ``5 * phase`` is the 4x4 Bayer value of
    (i, j) = divmod((k - 5 * phase) % 16, 4), 4 M2(i & 1, j & 1) +
    M2(i >> 1, j >> 1) with M2(a, b) = 2 (a ^ b) + a, over 16, plus 1/32."""
    h, w = shape2d
    ys = torch.arange(h, dtype=torch.int32, device=device)[:, None] % 4
    xs = torch.arange(w, dtype=torch.int32, device=device)[None, :] % 4
    k = (ys * 4 + xs - 5 * phase) % 16
    i, j = k >> 2, k & 3

    def m2(a, b):
        return 2 * (a ^ b) + a
    m = 4 * m2(i & 1, j & 1) + m2(i >> 1, j >> 1)
    return m.to(torch.float32) / 16.0 + 1.0 / 32.0


def _sample_stochastic_dynamic_level(pool: TexturePoolGPU, tex: torch.Tensor,
                                     uv: torch.Tensor, level_i: torch.Tensor,
                                     wrap: bool) -> torch.Tensor:
    """Stochastic-bilinear sample: one texel a pixel, the bilinear corner
    chosen by Bayer thresholds on the subtexel fractions."""
    sizes, offs = _level_address(pool, level_i)
    sf = sizes.to(F32)
    u = fma(uv[..., 0], sf, _HALF)
    v = fma(uv[..., 1], sf, _HALF)
    if wrap:
        u = torch.remainder(u, sf)
        v = torch.remainder(v, sf)
    x0, y0 = torch.floor(u), torch.floor(v)
    tu = _bayer_threshold(u.shape[-2:], u.device, phase=1)
    tv = _bayer_threshold(v.shape[-2:], v.device, phase=2)
    xi = x0.to(I32) + ((u - x0) > tu).to(I32)
    yi = y0.to(I32) + ((v - y0) > tv).to(I32)
    if wrap:
        xi = torch.remainder(xi, sizes)
        yi = torch.remainder(yi, sizes)
    else:
        xi, yi = _clip(xi, sizes), _clip(yi, sizes)
    i = tex * pool.texels_per_tex + offs + pool._texel_index(yi, xi, sizes)
    row = pool._decode(pool.texels[i.long()])
    return row[..., :pool.base_channels] if pool.windowed else row


def sample_pool_mip(pool, tex: torch.Tensor, uv: torch.Tensor,
                    level_f: torch.Tensor, wrap: bool = True,
                    filter: str = "dithered", duv: torch.Tensor | None = None,
                    channel_first: bool = False) -> torch.Tensor:
    """Mip-filtered sample at a per-pixel fractional level.

    'trilinear' blends bilinear taps at the two levels; 'dithered' takes
    one bilinear tap at lo or lo + 1 by a 4x4 Bayer threshold on the level
    fraction; 'bilinear' the nearest level; 'stochastic' the dithered
    level and a one-texel stochastic footprint. A native pool takes
    :func:`sample_native_pool_mip` (``duv``: its uv derivatives)."""
    if isinstance(pool, NativeTexturePoolGPU):
        out = sample_native_pool_mip(pool, tex, uv, level_f, wrap=wrap,
                                     filter=filter, duv=duv)
        return out.movedim(-1, 0) if channel_first else out
    nlev = len(pool.level_sizes)
    lf = level_f.clamp(0.0, nlev - 1.0)
    lo = torch.floor(lf).to(I32)
    if filter == "trilinear":
        frac = (lf - lo.to(F32)).unsqueeze(0 if channel_first else -1)
        out_lo = _sample_bilinear_dynamic_level(pool, tex, uv, lo, wrap,
                                                channel_first)
        out_hi = _sample_bilinear_dynamic_level(
            pool, tex, uv, torch.clamp(lo + 1, max=nlev - 1), wrap,
            channel_first)
        return lerp(out_lo, out_hi, frac)
    if filter in ("dithered", "stochastic"):
        frac = lf - lo.to(F32)
        thresh = _bayer_threshold(lf.shape[-2:], lf.device)
        level = torch.clamp(lo + (frac > thresh).to(I32), max=nlev - 1)
        if filter == "stochastic":
            out = _sample_stochastic_dynamic_level(pool, tex, uv, level, wrap)
            return out.movedim(-1, 0) if channel_first else out
        return _sample_bilinear_dynamic_level(pool, tex, uv, level, wrap,
                                              channel_first)
    if filter != "bilinear":
        raise ValueError(f"unknown texture filter {filter!r}")
    level = torch.round(lf).clamp(0, nlev - 1).to(I32)
    return _sample_bilinear_dynamic_level(pool, tex, uv, level, wrap,
                                          channel_first)


def uv_derivatives(uv: torch.Tensor) -> torch.Tensor:
    """Screen-space finite-difference uv derivatives (..., 4):
    (dx_u, dx_v, dy_u, dy_v), one-sided at row / column 0, wrap-aware
    (the nearest integer step is removed)."""
    du = uv - torch.roll(uv, 1, dims=-2)
    dv = uv - torch.roll(uv, 1, dims=-3)
    du[..., :, 0, :] = du[..., :, 1, :]
    dv[..., 0, :, :] = dv[..., 1, :, :]
    du = du - torch.round(du)
    dv = dv - torch.round(dv)
    return torch.cat([du, dv], dim=-1)


def pool_duv(pool, uv: torch.Tensor) -> torch.Tensor | None:
    """The uv derivatives a native pool's per-record level needs; None for
    the pyramid pool, whose scalar level suffices."""
    return (uv_derivatives(uv) if isinstance(pool, NativeTexturePoolGPU)
            else None)


_LN2 = float(np.float32(math.log(2.0)))


def _log2(x: torch.Tensor) -> torch.Tensor:
    """The reference CPU build's ``log2``: ``log(x) / log(2)``."""
    return torch.log(x) / _LN2


def mip_level_from_uv(uv: torch.Tensor, base_size: int) -> torch.Tensor:
    """Per-pixel fractional mip level of a resolved uv map (..., H, W, 2)
    (leading dims are independent images): ``max(0, 0.5 * log2(rho *
    base^2))`` with rho the larger squared screen-space uv step.

    The reference's ``log2`` is its CPU build's ``log(x) / log(2)``; the
    port divides ``torch.log`` the same way. The two ``log``
    implementations still differ in the last bit on a few percent of
    inputs, which moves a dithered level only when the fraction sits
    within that bit of a Bayer threshold."""
    d = uv_derivatives(uv)
    rho = torch.maximum(fma(d[..., 1], d[..., 1], d[..., 0] * d[..., 0]),
                        fma(d[..., 3], d[..., 3], d[..., 2] * d[..., 2]))
    texel_d2 = rho * float(base_size * base_size)
    return (0.5 * _log2(texel_d2.clamp(min=1e-12))).clamp(min=0.0)


# ---- one static level (tests and tooling; not on any frame path) -----------

def _gather_texel(pool: TexturePoolGPU, tex: torch.Tensor, level: int,
                  ix: torch.Tensor, iy: torch.Tensor) -> torch.Tensor:
    """The pool rows of texels (ix, iy), clamped to the level's edge."""
    s = pool.level_sizes[level]
    idx = (tex * pool.texels_per_tex + pool.level_offsets[level]
           + pool._texel_index(iy.clamp(0, s - 1), ix.clamp(0, s - 1), s))
    return pool.texels[idx.long()]


def sample_pool_bilinear_level(pool: TexturePoolGPU, tex: torch.Tensor,
                               uv: torch.Tensor, level: int,
                               wrap: bool = True) -> torch.Tensor:
    """Bilinear sample at one static mip level: four texel gathers. uv
    (..., 2); tex (...) i32 -> (..., C)."""
    s = pool.level_sizes[level]
    u = uv[..., 0] * s - 0.5
    v = uv[..., 1] * s - 0.5
    if wrap:
        u, v = torch.remainder(u, s), torch.remainder(v, s)
    x0, y0 = torch.floor(u), torch.floor(v)
    fx, fy = (u - x0)[..., None], (v - y0)[..., None]
    x0i, y0i = x0.to(I32), y0.to(I32)
    if wrap:
        x1i, y1i = torch.remainder(x0i + 1, s), torch.remainder(y0i + 1, s)
        x0i, y0i = torch.remainder(x0i, s), torch.remainder(y0i, s)
    else:
        x1i, y1i = x0i + 1, y0i + 1

    def texel(xi, yi):
        return pool._decode(_gather_texel(pool, tex, level, xi, yi))

    return ((texel(x0i, y0i) * (1 - fx) + texel(x1i, y0i) * fx) * (1 - fy)
            + (texel(x0i, y1i) * (1 - fx) + texel(x1i, y1i) * fx) * fy)


# ---- the native-size pool ---------------------------------------------------

@dataclass
class NativeTexturePoolGPU:
    """Per-record native-size mip chains, flattened on a device: each record
    keeps its own dimensions and level count. ``base_tab`` (R, 4) i32 holds
    (w0, h0, levels, 0) a record; ``level_tab`` (R * max_levels, 4) i32
    (row offset, w, h, 0) a (record, level), a record's last level repeated
    up to ``max_levels``."""

    texels: torch.Tensor          # (N, C | 4C) u8 or f32
    base_tab: torch.Tensor
    level_tab: torch.Tensor
    max_levels: int
    base_size: int                # largest base dimension
    windowed: bool = False
    base_channels: int = 9
    u8: bool = True

    @property
    def level_sizes(self) -> tuple:
        """For :func:`mip_level_from_uv`: level 0 at the largest base (the
        sampler rebiases per record)."""
        return (self.base_size,) * self.max_levels

    def _decode(self, rows: torch.Tensor) -> torch.Tensor:
        return rows.to(F32) * (1.0 / 255.0) if self.u8 else rows


def pack_native_pool(chains: list, windowed: bool = False, wrap: bool = True,
                     u8: bool = True, device="cpu") -> NativeTexturePoolGPU:
    """chains: [record -> [(h, w, C) f32 per level]] at native sizes."""
    Lmax = max((len(c) for c in chains), default=1)
    base_size = max((max(c[0].shape[:2]) for c in chains), default=1)
    C = chains[0][0].shape[-1] if chains else 9
    parts, base_rows, level_rows = [], [], []
    off = 0
    for c in chains:
        h0, w0 = c[0].shape[:2]
        base_rows.append([w0, h0, len(c), 0])
        for m in c:
            h, w = m.shape[:2]
            rows = window_rows(m, wrap) if windowed else m
            parts.append(rows.reshape(h * w, -1))
            level_rows.append([off, w, h, 0])
            off += h * w
        level_rows += [level_rows[-1]] * (Lmax - len(c))
    flat = (np.concatenate(parts, axis=0) if parts
            else np.zeros((1, C * (4 if windowed else 1)), np.float32))
    if u8:
        flat = np.clip(flat * 255.0 + 0.5, 0, 255).astype(np.uint8)

    def tab(rows):
        return torch.as_tensor(np.array(rows, np.int32).reshape(-1, 4),
                               device=device)

    return NativeTexturePoolGPU(torch.as_tensor(flat, device=device),
                                tab(base_rows), tab(level_rows), Lmax,
                                base_size, windowed, C, u8)


def _sample_native_level(pool: NativeTexturePoolGPU, rec: torch.Tensor,
                         uv: torch.Tensor, level_i: torch.Tensor, wrap: bool,
                         stochastic: bool = False) -> torch.Tensor:
    """One bilinear (or stochastic one-texel) tap of a native pool at a
    per-pixel int32 level -> (..., C). A windowed u8 pool's tap is K7."""
    tab = pool.level_tab[(rec * pool.max_levels + level_i).long()]
    off, w, h = tab[..., 0], tab[..., 1], tab[..., 2]
    wf, hf = w.to(F32), h.to(F32)
    u = fma(uv[..., 0], wf, _HALF)
    v = fma(uv[..., 1], hf, _HALF)
    if wrap:
        u = torch.remainder(u, wf)
        v = torch.remainder(v, hf)
    x0, y0 = torch.floor(u), torch.floor(v)
    fx, fy = u - x0, v - y0
    x0i, y0i = x0.to(I32), y0.to(I32)
    C = pool.base_channels

    def addr(xi, yi):
        xi = torch.remainder(xi, w) if wrap else _clip(xi, w)
        yi = torch.remainder(yi, h) if wrap else _clip(yi, h)
        return off + yi * w + xi

    if stochastic:
        tu = _bayer_threshold(u.shape[-2:], u.device, phase=1)
        tv = _bayer_threshold(v.shape[-2:], v.device, phase=2)
        i = addr(x0i + (fx > tu).to(I32), y0i + (fy > tv).to(I32))
        return pool._decode(pool.texels[i.long()])[..., :C]
    if pool.windowed:
        idx = addr(x0i, y0i)
        if pool.u8:
            out = windowed_blend(pool.texels, idx.reshape(-1),
                                 fx.reshape(-1), fy.reshape(-1), C)
            return out.reshape(tuple(idx.shape) + (C,))
        row = pool.texels[idx.long()]
        return _blend4(False, row[..., 0:C], row[..., C:2 * C],
                       row[..., 2 * C:3 * C], row[..., 3 * C:4 * C], fx, fy)

    def texel(xi, yi):
        return pool.texels[addr(xi, yi).long()]

    return _blend4(pool.u8, texel(x0i, y0i), texel(x0i + 1, y0i),
                   texel(x0i, y0i + 1), texel(x0i + 1, y0i + 1), fx, fy)


def sample_native_pool_mip(pool: NativeTexturePoolGPU, rec: torch.Tensor,
                           uv: torch.Tensor, level_f: torch.Tensor,
                           wrap: bool = True, filter: str = "trilinear",
                           duv: torch.Tensor | None = None) -> torch.Tensor:
    """Mip-filtered native-pool sample -> (..., C), the filters of
    :func:`sample_pool_mip`. With ``duv`` (:func:`uv_derivatives`) the
    level is exact per record: ``0.5 * log2(max over the screen axes of
    (du * w0)^2 + (dv * h0)^2)``; without, ``level_f`` (against
    ``base_size``) is rebiased by ``log2(w0 / base_size)``, exact for
    square textures only."""
    base = pool.base_tab[rec.long()]
    w0, h0 = base[..., 0].to(F32), base[..., 1].to(F32)
    top = base[..., 2].to(F32) - 1.0
    if duv is not None:
        ax, ay = duv[..., 0] * w0, duv[..., 1] * h0
        bx, by = duv[..., 2] * w0, duv[..., 3] * h0
        texel_d2 = torch.maximum(fma(ay, ay, ax * ax), fma(by, by, bx * bx))
        lf = (0.5 * _log2(texel_d2.clamp(min=1e-12))).clamp(min=0.0)
    else:
        base_size = w0.new_full((), float(pool.base_size))
        lf = level_f + (_log2(w0.clamp(min=1.0)) - _log2(base_size))
    lf = torch.minimum(lf.clamp(min=0.0), top)
    lo = torch.floor(lf).to(I32)
    top_i = top.to(I32)
    if filter == "trilinear":
        frac = (lf - lo.to(F32))[..., None]
        return lerp(_sample_native_level(pool, rec, uv, lo, wrap),
                    _sample_native_level(pool, rec, uv,
                                         torch.minimum(lo + 1, top_i), wrap),
                    frac)
    if filter == "bilinear":
        level = torch.round(lf).to(I32)
    elif filter in ("dithered", "stochastic"):
        thresh = _bayer_threshold(lf.shape[-2:], lf.device)
        level = torch.minimum(lo + ((lf - lo.to(F32)) > thresh).to(I32), top_i)
    else:
        raise ValueError(f"unknown texture filter {filter!r}")
    return _sample_native_level(pool, rec, uv, level, wrap,
                                stochastic=filter == "stochastic")


# ---- cubemaps ---------------------------------------------------------------

# For each face (order matches CUBE_FACE_DIRS): dir = f + u * ru + v * rv
# with u, v in [-1, 1].
_FACE_AXES = np.array([
    # forward        right(u)        down(v)
    [[1, 0, 0], [0, 0, -1], [0, -1, 0]],   # +X
    [[-1, 0, 0], [0, 0, 1], [0, -1, 0]],   # -X
    [[0, 1, 0], [1, 0, 0], [0, 0, 1]],     # +Y
    [[0, -1, 0], [1, 0, 0], [0, 0, -1]],   # -Y
    [[0, 0, 1], [1, 0, 0], [0, -1, 0]],    # +Z
    [[0, 0, -1], [-1, 0, 0], [0, -1, 0]],  # -Z
], np.float32)


def cubemap_dir(face: int, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(face, u, v in [-1, 1]) -> unnormalized direction (..., 3)."""
    f, ru, rv = (torch.as_tensor(a, device=u.device) for a in _FACE_AXES[face])
    return f + u[..., None] * ru + v[..., None] * rv


def cubemap_face_uv(d: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """direction (..., 3) -> (face i32, u, v in [-1, 1])."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    ax, ay, az = x.abs(), y.abs(), z.abs()
    is_x = (ax >= ay) & (ax >= az)
    is_y = (ay > ax) & (ay >= az)

    def sel(c, a, b):
        return torch.where(c, a, b)

    face = sel(is_x, sel(x >= 0, 0, 1), sel(is_y, sel(y >= 0, 2, 3),
                                             sel(z >= 0, 4, 5)))
    major = sel(is_x, ax, sel(is_y, ay, az)).clamp(min=1e-20)
    u = sel(is_x, sel(x >= 0, -z, z), sel(is_y, x, sel(z >= 0, x, -x)))
    v = sel(is_x, -y, sel(is_y, sel(y >= 0, z, -z), -y))
    return face.to(I32), u / major, v / major


def _bilinear_coords(d: torch.Tensor, S: int):
    face, u, v = cubemap_face_uv(d)
    fu = ((u * 0.5 + 0.5) * S - 0.5).clamp(0.0, S - 1.0)
    fv = ((v * 0.5 + 0.5) * S - 0.5).clamp(0.0, S - 1.0)
    x0, y0 = torch.floor(fu), torch.floor(fv)
    return (face.long(), x0.long(), y0.long(),
            (fu - x0)[..., None], (fv - y0)[..., None])


def sample_cubemap(cube: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Bilinear cubemap sample (no seam blending). cube: (6, S, S, C),
    d: (..., 3) -> (..., C)."""
    S = cube.shape[1]
    face, x0, y0, fx, fy = _bilinear_coords(d, S)
    x1 = (x0 + 1).clamp(max=S - 1)
    y1 = (y0 + 1).clamp(max=S - 1)
    flat = cube.reshape(6 * S * S, cube.shape[-1])

    def tex(xi, yi):
        return flat[(face * S + yi) * S + xi]

    return ((tex(x0, y0) * (1 - fx) + tex(x1, y0) * fx) * (1 - fy)
            + (tex(x0, y1) * (1 - fx) + tex(x1, y1) * fx) * fy)


def encode_rgbe_windowed(cube: torch.Tensor) -> torch.Tensor:
    """(6, S, S, 3) f32 HDR cube -> (6, S, S, 16) u8 windowed RGBE: each
    row packs the texel and its +x / +y / +x+y neighbours (clamped at face
    edges) as shared-exponent RGBE (u8 mantissas, exponent biased by 128),
    so a bilinear sky tap is one 16-byte gather."""
    m = cube.max(dim=-1).values
    e = torch.where(m > 1e-30, torch.ceil(torch.log2(m.clamp(min=1e-30))),
                    torch.full((), -127.0, device=cube.device))
    mant = torch.round(cube * torch.exp2(-e)[..., None] * 255.0).clamp(0, 255)
    rgbe = torch.cat([mant, (e[..., None] + 128.0).clamp(0, 255)], dim=-1)
    right = torch.cat([rgbe[:, :, 1:], rgbe[:, :, -1:]], dim=2)
    down = torch.cat([rgbe[:, 1:, :], rgbe[:, -1:, :]], dim=1)
    diag = torch.cat([down[:, :, 1:], down[:, :, -1:]], dim=2)
    return torch.cat([rgbe, right, down, diag], dim=-1).to(torch.uint8)


def _decode_rgbe(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) u8 RGBE -> (..., 3) f32 linear."""
    f = q.to(F32)
    return f[..., :3] * (torch.exp2(f[..., 3] - 128.0) / 255.0)[..., None]


def sample_cubemap_rgbe_windowed(win: torch.Tensor, d: torch.Tensor
                                 ) -> torch.Tensor:
    """Bilinear cubemap sample from a windowed RGBE cube (one gather).
    win: (6, S, S, 16) u8 from :func:`encode_rgbe_windowed`; d: (..., 3)."""
    S = win.shape[1]
    face, x0, y0, fx, fy = _bilinear_coords(d, S)
    row = win.reshape(6 * S * S, 16)[(face * S + y0) * S + x0]
    c00, c10 = _decode_rgbe(row[..., 0:4]), _decode_rgbe(row[..., 4:8])
    c01, c11 = _decode_rgbe(row[..., 8:12]), _decode_rgbe(row[..., 12:16])
    return ((c00 * (1 - fx) + c10 * fx) * (1 - fy)
            + (c01 * (1 - fx) + c11 * fx) * fy)


def face_texel_dirs(size: int, device: torch.device) -> torch.Tensor:
    """(6, S, S, 3) unit direction of every cubemap texel centre."""
    t = (torch.arange(size, dtype=F32, device=device) + 0.5) / size * 2.0 - 1.0
    v, u = torch.meshgrid(t, t, indexing="ij")
    dirs = []
    for f in range(6):
        d = cubemap_dir(f, u, v)
        dirs.append(d / torch.linalg.vector_norm(d, dim=-1, keepdim=True))
    return torch.stack(dirs, dim=0)
