"""Environment (port of the ops/env.py parts on the frame path):
equirect -> cubemap bake, the SH-9 projection of the irradiance map, and
the per-pixel skybox."""

from __future__ import annotations

import math

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


def skybox_colors(env_cube: torch.Tensor, proj_inv: torch.Tensor,
                  view_rot_inv: torch.Tensor, width: int, height: int,
                  rgbe_win: torch.Tensor | None = None) -> torch.Tensor:
    """(height, width, 3) skybox: unproject each pixel's NDC, rotate it into
    the world by the inverse view rotation, sample the env cube (from the
    windowed-RGBE display cube when ``rgbe_win`` is given)."""
    dev = env_cube.device
    x = ((torch.arange(width, dtype=F32, device=dev) + 0.5) / width) * 2.0 - 1.0
    y = -(((torch.arange(height, dtype=F32, device=dev) + 0.5) / height)
          * 2.0 - 1.0)
    yg, xg = torch.meshgrid(y, x, indexing="ij")
    ndc = torch.stack([xg, yg, torch.zeros_like(xg), torch.ones_like(xg)],
                      dim=-1)
    un = ndc @ proj_inv.T
    d = un[..., :3] @ view_rot_inv.T
    if rgbe_win is not None:
        return sampling.sample_cubemap_rgbe_windowed(rgbe_win, d)
    return sampling.sample_cubemap(env_cube, d)
