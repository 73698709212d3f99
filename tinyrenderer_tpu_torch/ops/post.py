"""Post-processing (port of ops/post.py): tone mapping + gamma, and the
exact integer-factor bilinear upsample of the coarse sky."""

from __future__ import annotations

import torch

TONE_MAP_NONE = 0
TONE_MAP_EXPOSURE = 1
TONE_MAP_REINHARD = 2


def tone_map(hdr: torch.Tensor, tone_type: torch.Tensor,
             exposure: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) HDR -> (H, W, 3) u8 SDR. Type 1: ``1 - exp(-c * k)``;
    type 2: Reinhard ``c / (c + 1)``; otherwise identity. Then gamma 1/2.2
    and 8-bit quantization. ``tone_type``/``exposure`` are 0-d tensors."""
    t = tone_type.to(torch.int32)
    ldr_exposure = 1.0 - torch.exp(-hdr * exposure)
    ldr_reinhard = hdr / (hdr + 1.0)
    ldr = torch.where(t == TONE_MAP_EXPOSURE, ldr_exposure,
                      torch.where(t == TONE_MAP_REINHARD, ldr_reinhard, hdr))
    gamma = torch.pow(ldr.clamp(0.0, 1.0), 1.0 / 2.2)
    return (gamma * 255.0 + 0.5).clamp(0.0, 255.0).to(torch.uint8)


def upsample_axis(img: torch.Tensor, s: int, axis: int) -> torch.Tensor:
    """Exact integer-factor bilinear upsample along one axis (half-pixel
    centres, clamp at the edge): ``s`` phase-wise weighted adds of the
    image and its one-step shifts, interleaved."""
    n = img.shape[axis]
    lo = torch.cat([img.narrow(axis, 0, 1), img.narrow(axis, 0, n - 1)], axis)
    hi = torch.cat([img.narrow(axis, 1, n - 1), img.narrow(axis, n - 1, 1)],
                   axis)
    phases = []
    for k in range(s):
        f = (k + 0.5) / s - 0.5        # offset of output phase k from in[i]
        if f < 0.0:
            phases.append(img * (1.0 + f) + lo * (-f))
        else:
            phases.append(img * (1.0 - f) + hi * f)
    out = torch.stack(phases, dim=axis + 1)
    shape = list(img.shape)
    shape[axis] = n * s
    return out.reshape(shape)


def upsample_bilinear_int_cf(img: torch.Tensor, sy: int, sx: int
                             ) -> torch.Tensor:
    """(C, H, W) -> (C, H * sy, W * sx) bilinear upsample, integer factors."""
    out = upsample_axis(img, sy, 1) if sy > 1 else img
    return upsample_axis(out, sx, 2) if sx > 1 else out
