"""The environment as the plain reference computes it: the engine's
procedural sky (an equirectangular HDR image), its cube, the windowed RGBE
display cube the frame's sky is read from, and the SH-9 irradiance of the
IBL asset file.

Formulas of the upstream engine as the port states them (tinyrenderer_tpu
_torch at ea2b515: ``assets/hdr.py`` ``procedural_sky``, ``ops/env.py``,
``ops/sampling.py``), written out plainly here.
"""

from __future__ import annotations

import math

import numpy as np
import torch

F32 = torch.float32

SH_C = (0.282095, 0.488603, 1.092548, 0.315392, 0.546274)
# per cube face: forward, the direction of u, the direction of v
FACE_AXES = (((1, 0, 0), (0, 0, -1), (0, -1, 0)),
             ((-1, 0, 0), (0, 0, 1), (0, -1, 0)),
             ((0, 1, 0), (1, 0, 0), (0, 0, 1)),
             ((0, -1, 0), (1, 0, 0), (0, 0, -1)),
             ((0, 0, 1), (1, 0, 0), (0, -1, 0)),
             ((0, 0, -1), (-1, 0, 0), (0, -1, 0)))


def procedural_sky(height: int = 256, width: int = 512) -> np.ndarray:
    """(height, width, 3) float32: a horizon gradient, a sun disk and glow,
    and the ground, on the equirectangular map of the cube bake."""
    v, u = np.meshgrid(np.linspace(0, 1, height, endpoint=False) + 0.5 / height,
                       np.linspace(0, 1, width, endpoint=False) + 0.5 / width,
                       indexing="ij")
    phi = (u - 0.5) / 0.1591
    theta = ((1.0 - v) - 0.5) / 0.3183
    y = np.sin(theta)
    x = np.cos(theta) * np.cos(phi)
    z = np.cos(theta) * np.sin(phi)
    top = np.array([0.35, 0.55, 0.95], np.float32)
    horizon = np.array([0.85, 0.9, 1.0], np.float32)
    ground = np.array([0.25, 0.22, 0.2], np.float32)
    t = np.clip(y, 0.0, 1.0)[..., None]
    img = np.where(y[..., None] >= 0.0, horizon * (1.0 - t) + top * t,
                   ground * (1.0 + 0.5 * y[..., None]))
    sd = np.array([0.35, 0.65, 0.4], np.float32)
    sd = sd / np.linalg.norm(sd)
    cosang = x * sd[0] + y * sd[1] + z * sd[2]
    disk = np.clip((cosang - 0.9995) / 0.0005, 0.0, 1.0) ** 2
    glow = np.clip(cosang, 0.0, 1.0) ** 64
    img = img + (disk * 40.0 + glow * 0.5)[..., None] * np.array(
        [1.0, 0.95, 0.85], np.float32)
    return img.astype(np.float32)


def texel_dirs(size: int, device) -> torch.Tensor:
    """(6, S, S, 3) unit directions of the cube's texel centres."""
    t = (torch.arange(size, dtype=F32, device=device) + 0.5) / size * 2.0 - 1.0
    v, u = torch.meshgrid(t, t, indexing="ij")
    out = []
    for f, ru, rv in FACE_AXES:
        f, ru, rv = (torch.tensor(a, dtype=F32, device=device) for a in (f, ru, rv))
        d = f + u[..., None] * ru + v[..., None] * rv
        out.append(d / torch.linalg.vector_norm(d, dim=-1, keepdim=True))
    return torch.stack(out)


def equirect_cube(eq: torch.Tensor, size: int) -> torch.Tensor:
    """(6, S, S, 3): the equirect image sampled bilinearly (u wraps, v
    clamps) along each texel's direction."""
    d = texel_dirs(size, eq.device)
    u = torch.atan2(d[..., 2], d[..., 0]) * 0.1591 + 0.5
    v = 1.0 - (torch.asin(d[..., 1].clamp(-1.0, 1.0)) * 0.3183 + 0.5)
    h, w = eq.shape[:2]
    fu = u * w - 0.5
    fv = (v * h - 0.5).clamp(0.0, h - 1.0)
    x0, y0 = torch.floor(fu), torch.floor(fv)
    fx, fy = (fu - x0)[..., None], (fv - y0)[..., None]
    x0 = torch.remainder(x0.long(), w)
    x1 = torch.remainder(x0 + 1, w)
    y0 = y0.long()
    y1 = (y0 + 1).clamp(max=h - 1)
    return ((eq[y0, x0] * (1 - fx) + eq[y0, x1] * fx) * (1 - fy)
            + (eq[y1, x0] * (1 - fx) + eq[y1, x1] * fx) * fy)


def rgbe(cube: torch.Tensor) -> torch.Tensor:
    """(6, S, S, 3) -> (6, S, S, 3) float32 as the display cube stores it:
    8-bit mantissas under a shared exponent, decoded."""
    m = cube.max(dim=-1).values
    e = torch.where(m > 1e-30, torch.ceil(torch.log2(m.clamp(min=1e-30))),
                    torch.full((), -127.0, device=cube.device))
    mant = torch.round(cube * torch.exp2(-e)[..., None] * 255.0).clamp(0, 255)
    e = (e + 128.0).clamp(0, 255)
    return mant * (torch.exp2(e - 128.0) / 255.0)[..., None]


def sample_cube(cube: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Bilinear sample (no seam blending, clamped to the face) of (6, S, S,
    C) along the directions d (..., 3)."""
    S = cube.shape[1]
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    ax, ay, az = x.abs(), y.abs(), z.abs()
    is_x = (ax >= ay) & (ax >= az)
    is_y = (ay > ax) & (ay >= az)
    w = torch.where
    face = w(is_x, w(x >= 0, 0, 1), w(is_y, w(y >= 0, 2, 3), w(z >= 0, 4, 5)))
    major = w(is_x, ax, w(is_y, ay, az)).clamp(min=1e-20)
    u = w(is_x, w(x >= 0, -z, z), w(is_y, x, w(z >= 0, x, -x))) / major
    v = w(is_x, -y, w(is_y, w(y >= 0, z, -z), -y)) / major
    fu = ((u * 0.5 + 0.5) * S - 0.5).clamp(0.0, S - 1.0)
    fv = ((v * 0.5 + 0.5) * S - 0.5).clamp(0.0, S - 1.0)
    x0, y0 = torch.floor(fu), torch.floor(fv)
    fx, fy = (fu - x0)[..., None], (fv - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    x1, y1 = (x0 + 1).clamp(max=S - 1), (y0 + 1).clamp(max=S - 1)
    face = face.long()
    return ((cube[face, y0, x0] * (1 - fx) + cube[face, y0, x1] * fx) * (1 - fy)
            + (cube[face, y1, x0] * (1 - fx) + cube[face, y1, x1] * fx) * fy)


def sh_basis(n: torch.Tensor) -> torch.Tensor:
    x, y, z = n[..., 0], n[..., 1], n[..., 2]
    return torch.stack([torch.full_like(x, SH_C[0]),
                        SH_C[1] * y, SH_C[1] * z, SH_C[1] * x,
                        SH_C[2] * x * y, SH_C[2] * y * z,
                        SH_C[3] * (3.0 * z * z - 1.0),
                        SH_C[2] * x * z, SH_C[4] * (x * x - y * y)], dim=-1)


def sh_project(cube: torch.Tensor) -> torch.Tensor:
    """(6, S, S, 3) -> (9, 3): the SH-9 coefficients, each texel weighted by
    its solid angle."""
    S = cube.shape[1]
    t = (torch.arange(S, dtype=F32, device=cube.device) + 0.5) / S * 2.0 - 1.0
    v, u = torch.meshgrid(t, t, indexing="ij")
    r2 = 1.0 + u * u + v * v
    wt = (4.0 / (torch.sqrt(r2) * r2)).expand(6, S, S)
    basis = sh_basis(texel_dirs(S, cube.device))
    coeffs = torch.einsum("fijk,fijc,fij->kc", basis, cube, wt)
    return coeffs * (4.0 * math.pi / wt.sum())

