"""Environment (port of ops/env.py): equirect -> cubemap bake, the
diffuse irradiance bake, the SH-9 projection of the irradiance map and its
evaluation at normals, and the skybox, per pixel or on a compacted block
work list."""

from __future__ import annotations

import math

import numpy as np
import torch

from . import sampling

F32 = torch.float32

# Y_lm basis constants (shared with the fused shading kernel, csrc/shade.cu)
_SH_C = (
    0.282095,                      # Y00
    0.488603,                      # Y1m1 (y), Y10 (z), Y11 (x)
    1.092548,                      # Y2m2 (xy), Y2m1 (yz), Y21 (xz)
    0.315392,                      # Y20 (3z^2 - 1)
    0.546274,                      # Y22 (x^2 - y^2)
)


def sample_equirect(equirect: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Spherical mapping uv = (atan2(z, x), asin(y)) * (0.1591, 0.3183) +
    0.5 with v flipped; bilinear, wrapping in u and clamped in v."""
    dn = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True).clamp(min=1e-12)
    u = torch.atan2(dn[..., 2], dn[..., 0]) * 0.1591 + 0.5
    v = 1.0 - (torch.asin(dn[..., 1].clamp(-1.0, 1.0)) * 0.3183 + 0.5)
    h, w = equirect.shape[:2]
    fu = u * w - 0.5
    fv = (v * h - 0.5).clamp(0.0, h - 1.0)
    x0, y0 = torch.floor(fu), torch.floor(fv)
    fx, fy = (fu - x0)[..., None], (fv - y0)[..., None]
    x0i = torch.remainder(x0.long(), w)
    x1i = torch.remainder(x0i + 1, w)
    y0i = y0.long()
    y1i = (y0i + 1).clamp(max=h - 1)
    flat = equirect.reshape(h * w, equirect.shape[-1])

    def tex(xi, yi):
        return flat[yi * w + xi]

    return ((tex(x0i, y0i) * (1 - fx) + tex(x1i, y0i) * fx) * (1 - fy)
            + (tex(x0i, y1i) * (1 - fx) + tex(x1i, y1i) * fx) * fy)


def equirect_to_cubemap(equirect: torch.Tensor, size: int,
                        gamma_decode: bool = True) -> torch.Tensor:
    """(6, S, S, 3) environment cube from an equirect HDR image;
    ``gamma_decode`` applies pow(c, 2.2) as the reference bake does."""
    c = sample_equirect(equirect, sampling.face_texel_dirs(size,
                                                           equirect.device))
    if gamma_decode:
        c = torch.pow(c.clamp(min=0.0), 2.2)
    return c.to(F32)


def irradiance_sample_dirs() -> tuple[np.ndarray, np.ndarray, int]:
    """Tangent-space hemisphere sample directions and their cos * sin
    weights: phi in steps of 0.125 while below 2 pi, theta in steps of
    0.025 while below pi / 2 (51 x 63 = 3213 samples)."""
    phis = np.arange(0.0, 2.0 * math.pi, 0.125)
    thetas = np.arange(0.0, 0.5 * math.pi, 0.025)
    ph, th = np.meshgrid(phis, thetas, indexing="ij")
    ph, th = ph.ravel(), th.ravel()
    dirs = np.stack([np.sin(th) * np.cos(ph),
                     np.sin(th) * np.sin(ph),
                     np.cos(th)], axis=1).astype(np.float32)
    weights = (np.cos(th) * np.sin(th)).astype(np.float32)
    return dirs, weights, dirs.shape[0]


def bake_irradiance(env_cube: torch.Tensor, size: int,
                    chunk: int = 128) -> torch.Tensor:
    """Diffuse irradiance convolution -> (6, size, size, 3) on the cube's
    device: ``pi * sum(env(dir) * cos * sin) / N`` over the hemisphere
    around each texel normal, the sample directions taken ``chunk`` at a
    time (zero-padded, weight 0) and accumulated in order."""
    dev = env_cube.device
    n = sampling.face_texel_dirs(size, dev).reshape(-1, 3)        # (T, 3)

    def unit(v):
        return v / torch.linalg.vector_norm(v, dim=-1,
                                            keepdim=True).clamp(min=1e-6)

    guessed_up = torch.tensor([0.0, 1.0, 0.0], dtype=F32, device=dev)
    right = unit(torch.linalg.cross(guessed_up.expand_as(n), n))
    up = unit(torch.linalg.cross(n, right))
    dirs, weights, total = irradiance_sample_dirs()
    pad = (-len(weights)) % chunk
    dirs = torch.as_tensor(np.pad(dirs, ((0, pad), (0, 0))).reshape(-1, chunk, 3),
                           device=dev)
    weights = torch.as_tensor(np.pad(weights, (0, pad)).reshape(-1, chunk),
                              device=dev)
    acc = torch.zeros((n.shape[0], 3), dtype=F32, device=dev)
    for d, w in zip(dirs, weights):
        world = (d[None, :, 0:1] * right[:, None, :]
                 + d[None, :, 1:2] * up[:, None, :]
                 + d[None, :, 2:3] * n[:, None, :])           # (T, chunk, 3)
        c = sampling.sample_cubemap(env_cube, world)
        acc = acc + (c * w[None, :, None]).sum(dim=1)
    return (math.pi * acc / float(total)).reshape(6, size, size, 3)


def _sh_basis(d: torch.Tensor) -> torch.Tensor:
    """(..., 3) unit dirs -> (..., 9) SH basis values."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    return torch.stack([
        torch.full_like(x, _SH_C[0]),
        _SH_C[1] * y, _SH_C[1] * z, _SH_C[1] * x,
        _SH_C[2] * x * y, _SH_C[2] * y * z,
        _SH_C[3] * (3.0 * z * z - 1.0),
        _SH_C[2] * x * z,
        _SH_C[4] * (x * x - y * y),
    ], dim=-1)


def sh_project_cubemap(cube: torch.Tensor) -> torch.Tensor:
    """(6, S, S, 3) cube -> (9, 3) SH-9 coefficients, texel solid angles
    weighting the sum."""
    size = cube.shape[1]
    dev = cube.device
    t = (torch.arange(size, dtype=F32, device=dev) + 0.5) / size * 2.0 - 1.0
    v, u = torch.meshgrid(t, t, indexing="ij")
    r2 = 1.0 + u * u + v * v
    w = (4.0 / (torch.sqrt(r2) * r2)).expand(6, size, size)
    basis = _sh_basis(sampling.face_texel_dirs(size, dev))        # (6,S,S,9)
    coeffs = torch.einsum("fijk,fijc,fij->kc", basis, cube, w)
    return coeffs * (4.0 * math.pi / w.sum())


def sh_eval_irradiance(sh: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """SH-9 coefficients (9, 3) of an irradiance signal evaluated at the
    normals n (..., 3) -> (..., 3)."""
    return _sh_basis(n) @ sh


def _sky_at(env_cube: torch.Tensor, proj_inv: torch.Tensor,
            view_rot_inv: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
            width: int, height: int,
            rgbe_win: torch.Tensor | None) -> torch.Tensor:
    """Sky colours (..., 3) at the pixel centres (px, py) of a width x
    height frame: unproject their NDC, rotate into the world by the inverse
    view rotation, sample the env cube (from the windowed-RGBE display cube
    when ``rgbe_win`` is given)."""
    x = (px / width) * 2.0 - 1.0
    y = -((py / height) * 2.0 - 1.0)
    ndc = torch.stack([x, y, torch.zeros_like(x), torch.ones_like(x)], dim=-1)
    un = ndc @ proj_inv.T
    d = un[..., :3] @ view_rot_inv.T
    if rgbe_win is not None:
        return sampling.sample_cubemap_rgbe_windowed(rgbe_win, d)
    return sampling.sample_cubemap(env_cube, d)


def skybox_colors(env_cube: torch.Tensor, proj_inv: torch.Tensor,
                  view_rot_inv: torch.Tensor, width: int, height: int,
                  rgbe_win: torch.Tensor | None = None, y0: float = 0,
                  full_height: int = 0) -> torch.Tensor:
    """(height, width, 3) skybox at every pixel (:func:`_sky_at`). With
    ``full_height``, the band of rows [y0, y0 + height) of a frame that
    tall (``y0`` may be fractional or negative: a band's sky strip reaches
    past its rows)."""
    dev = env_cube.device
    py, px = torch.meshgrid(torch.arange(height, dtype=F32, device=dev)
                            + y0 + 0.5,
                            torch.arange(width, dtype=F32, device=dev) + 0.5,
                            indexing="ij")
    return _sky_at(env_cube, proj_inv, view_rot_inv, px, py, width,
                   full_height or height, rgbe_win)


def skybox_colors_blocks(env_cube: torch.Tensor, proj_inv: torch.Tensor,
                         view_rot_inv: torch.Tensor, slots: torch.Tensor,
                         bh: int, bw: int, nbx: int, width: int, height: int,
                         rgbe_win: torch.Tensor | None = None, y0: float = 0,
                         full_height: int = 0) -> torch.Tensor:
    """:func:`skybox_colors` on a compacted block work list -> (K, bh, bw,
    3). ``slots`` (K,) are block indices (``compact.BlockPlan.slots``, -1
    empty, which gets 0) over the row-major (height // bh, width // bw)
    block grid, of the band of rows from ``y0`` of a ``full_height`` frame
    where that is given; each pixel's direction is closed-form in its
    block's coordinates, so only the cube sample gathers."""
    dev = env_cube.device
    b = slots.clamp(min=0)
    by = (b // nbx).to(F32)[:, None, None]
    bx = (b % nbx).to(F32)[:, None, None]
    xs = torch.arange(bw, dtype=F32, device=dev)[None, None, :]
    ys = torch.arange(bh, dtype=F32, device=dev)[None, :, None]
    px, py = torch.broadcast_tensors(bx * bw + xs + 0.5,
                                     by * bh + ys + y0 + 0.5)
    cols = _sky_at(env_cube, proj_inv, view_rot_inv, px, py, width,
                   full_height or height, rgbe_win)
    return torch.where((slots >= 0)[:, None, None, None], cols,
                       torch.zeros((), dtype=cols.dtype, device=dev))
