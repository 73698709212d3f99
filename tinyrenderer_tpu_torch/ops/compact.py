"""Block-compacted screen-space work lists (port of ops/compact.py).

The pixel grid splits into small blocks; a per-block predicate selects up
to ``capacity`` blocks into a static work list (ascending block index),
the work runs on the compacted (K, bh, bw) domain, and the results
scatter back. ``needed`` counts the blocks that wanted work — the
capacity monitor the engine grows the envelope from.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from . import sampling

I32 = torch.int32

_BLOCK_H = 8
_BLOCK_WIDTHS = (128, 64, 32, 16)


def block_dims(height: int, width: int) -> Optional[tuple[int, int]]:
    """(bh, bw) block dims dividing the grid, or None."""
    if height % _BLOCK_H != 0:
        return None
    for bw in _BLOCK_WIDTHS:
        if width % bw == 0:
            return _BLOCK_H, bw
    return None


def to_blocks(img: torch.Tensor, bh: int, bw: int) -> torch.Tensor:
    """(H, W, *C) -> (N, bh, bw, *C) row-major blocks."""
    H, W = img.shape[0], img.shape[1]
    rest = img.shape[2:]
    x = img.reshape(H // bh, bh, W // bw, bw, *rest).movedim(2, 1)
    return x.reshape((H // bh) * (W // bw), bh, bw, *rest)


def from_blocks(blocks: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(N, bh, bw, *C) -> (H, W, *C)."""
    _, bh, bw = blocks.shape[:3]
    rest = blocks.shape[3:]
    x = blocks.reshape(height // bh, width // bw, bh, bw, *rest).movedim(1, 2)
    return x.reshape(height, width, *rest)


@dataclass
class BlockPlan:
    slots: torch.Tensor    # (K,) i32 block index per work slot (-1 = empty)
    inv: torch.Tensor      # (N,) i32 work slot per block (-1 = not selected)
    needed: torch.Tensor   # () i32 blocks that wanted work


def plan_blocks(need: torch.Tensor, capacity: int) -> BlockPlan:
    """Select up to ``capacity`` of the blocks where ``need`` (N,) is set."""
    N = need.shape[0]
    dev = need.device
    order = torch.where(need, torch.arange(N, dtype=I32, device=dev),
                        torch.full((), N, dtype=I32, device=dev))
    if N < capacity:
        order = torch.nn.functional.pad(order, (0, capacity - N), value=N)
    raw = torch.sort(order).values[:capacity]
    slots = torch.where(raw < N, raw, torch.full_like(raw, -1))
    inv = torch.full((N + 1,), -1, dtype=I32, device=dev)
    inv[raw.long()] = torch.arange(capacity, dtype=I32, device=dev)
    return BlockPlan(slots=slots, inv=inv[:N], needed=need.sum(dtype=I32))


def gather_blocks(blocks: torch.Tensor, plan: BlockPlan) -> torch.Tensor:
    """(N, bh, bw, *C) -> (K, bh, bw, *C) work-list gather (empty slots 0)."""
    N = blocks.shape[0]
    g = blocks[plan.slots.clamp(0, N - 1).long()]
    mask = (plan.slots >= 0).reshape((-1,) + (1,) * (blocks.ndim - 1))
    return torch.where(mask, g, torch.zeros((), dtype=g.dtype, device=g.device))


def scatter_blocks(work: torch.Tensor, plan: BlockPlan,
                   fill: float = 0.0) -> torch.Tensor:
    """(K, bh, bw, *C) -> (N, bh, bw, *C); unselected blocks get ``fill``."""
    K = work.shape[0]
    out = work[plan.inv.clamp(0, K - 1).long()]
    mask = (plan.inv >= 0).reshape((-1,) + (1,) * (work.ndim - 1))
    return torch.where(mask, out,
                       torch.full((), fill, dtype=out.dtype, device=out.device))


def dilate_mask(mask: torch.Tensor) -> torch.Tensor:
    """(H, W) bool -> its 3x3 max-dilation (no wrap at the edges): widens a
    block-selection mask so that a bilinear upsample of a strided sample
    never reads an unselected (zeroed) neighbour."""
    m = mask
    m = m | F.pad(m[:-1], (0, 0, 1, 0)) | F.pad(m[1:], (0, 0, 0, 1))
    return m | F.pad(m[:, :-1], (1, 0)) | F.pad(m[:, 1:], (0, 1))


def blocks_needed(need: torch.Tensor, bh: int, bw: int) -> torch.Tensor:
    """(N,) bool: the (bh, bw) blocks of ``need`` (H, W) with a set pixel."""
    return to_blocks(need, bh, bw).flatten(1).any(dim=1)


def sample_pool_compacted(pool, rec: torch.Tensor, uv: torch.Tensor,
                          level_f: torch.Tensor, need: torch.Tensor,
                          capacity: int, filter: str = "dithered",
                          wrap: bool = True, duv: torch.Tensor | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mip-filtered material sample gathered only on the blocks where
    ``need`` (H, W) is set: every pixel of a selected block is sampled
    (equal to the dense sampler there), the others return 0. rec (H, W)
    i32, uv (H, W, 2), level_f (H, W), a native pool's ``duv`` (H, W, 4)
    -> ((H, W, C), () i32 blocks that wanted work). ``capacity`` <= 0 or
    >= the block count samples densely and still reports the count."""
    H, W = need.shape
    dims = block_dims(H, W)
    n_blocks = 0 if dims is None else (H // dims[0]) * (W // dims[1])
    if dims is None or capacity <= 0 or capacity >= n_blocks:
        out = sampling.sample_pool_mip(pool, rec, uv, level_f, wrap=wrap,
                                       filter=filter, duv=duv)
        needed = (torch.zeros((), dtype=I32, device=need.device)
                  if dims is None
                  else blocks_needed(need, *dims).sum(dtype=I32))
        return out, needed
    bh, bw = dims
    plan = plan_blocks(blocks_needed(need, bh, bw), capacity)

    def work(x):
        return None if x is None else gather_blocks(to_blocks(x, bh, bw), plan)

    # blocks are origin-aligned multiples of 4, so the sampler's Bayer
    # thresholds tile exactly as on the dense grid
    out_c = sampling.sample_pool_mip(pool, work(rec), work(uv),
                                     work(level_f), wrap=wrap, filter=filter,
                                     duv=work(duv))
    return from_blocks(scatter_blocks(out_c, plan), H, W), plan.needed
