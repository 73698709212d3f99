"""Rounding helpers shared by the plain versions.

The JAX reference runs its kernels on the CPU through XLA, whose LLVM
backend contracts ``a * b + c`` into one fused multiply-add (rounded once).
PyTorch rounds every operation. Where a result must be bit-equal to the
reference (raster depth and coverage, the select + eval planes), the port
spells the contraction out with :func:`fma`, and the CUDA kernels use
``__fmaf_rn`` in the same places.
"""

from __future__ import annotations

import torch


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once.

    The float64 product of two float32 values is exact; the float64 sum is
    rounded to 53 bits before the float32 rounding, which differs from a
    true fused multiply-add only when that first rounding lands exactly on
    a float32 halfway point (about 2**-29 of random inputs)."""
    return (a.double() * b.double() + c.double()).float()


def plane(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
          px: torch.Tensor, py: torch.Tensor,
          mxu_order: bool = False) -> torch.Tensor:
    """Affine plane ``a * px + b * py + c`` with the reference's rounding.

    Broadcast multiply-adds (the VPU form): ``fma(a, px, b * py) + c``.
    The 3-term matrix product of large tiles (``mxu_order``):
    ``fma(b, py, a * px) + c``."""
    if mxu_order:
        return fma(b, py, a * px) + c
    return fma(a, px, b * py) + c
