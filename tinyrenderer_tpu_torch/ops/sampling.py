"""Cubemap sampling (the cube-map part of ops/sampling.py): face
addressing, bilinear samples of f32 cubes, and the windowed-RGBE display
cube the sky samples with one gather per tap."""

from __future__ import annotations

import numpy as np
import torch

F32 = torch.float32
I32 = torch.int32

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
