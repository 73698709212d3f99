"""A plain z-buffer rasterizer: each triangle tested at the pixel centres
of its bounding box, the nearest covered triangle kept per pixel.

Conventions (the engine's): screen x = (ndc_x / 2 + 1/2) * width, y =
(1/2 - ndc_y / 2) * height; a pixel's centre is (x + 0.5, y + 0.5); a
centre is covered when its three barycentric weights are >= 0 (edges
belong to both triangles); depth is reverse-Z, z_ndc interpolated
linearly on the screen, cleared to 0, and the larger depth wins, a tie
going to the larger triangle index. A triangle with a corner at w <= 1e-6
is not drawn (there is no clipping). Front faces are counter-clockwise in
NDC: ``cull="back"`` draws them, ``"front"`` draws the others (the shadow
views), ``"none"`` both.
"""

from __future__ import annotations

import torch

W_EPS = 1e-6
# candidate pixels tested per batch
BATCH = 1 << 22


def setup(clip: torch.Tensor, tri: torch.Tensor, width: int, height: int):
    """Screen corners (T, 3) x, y, z_ndc, 1/w and the signed doubled area
    (T,) of each triangle; ``clip`` (V, 4), ``tri`` (T, 3) long."""
    c = clip[tri]                                            # (T, 3, 4)
    w = c[..., 3]
    ok = (w > W_EPS).all(dim=1)
    inv_w = 1.0 / torch.where(ok[:, None], w, torch.ones_like(w))
    x = (c[..., 0] * inv_w * 0.5 + 0.5) * width
    y = (0.5 - c[..., 1] * inv_w * 0.5) * height
    z = c[..., 2] * inv_w
    area2 = ((x[:, 1] - x[:, 0]) * (y[:, 2] - y[:, 0])
             - (x[:, 2] - x[:, 0]) * (y[:, 1] - y[:, 0]))
    return x, y, z, inv_w, area2, ok


def barycentric(x, y, area2, px, py):
    """The three weights at (px, py) of triangles with corners x, y (each
    (..., 3), broadcast against px, py)."""
    x0, x1, x2 = x[..., 0], x[..., 1], x[..., 2]
    y0, y1, y2 = y[..., 0], y[..., 1], y[..., 2]
    b0 = ((x1 - px) * (y2 - py) - (x2 - px) * (y1 - py)) / area2
    b1 = ((x2 - px) * (y0 - py) - (x0 - px) * (y2 - py)) / area2
    b2 = ((x0 - px) * (y1 - py) - (x1 - px) * (y0 - py)) / area2
    return b0, b1, b2


def _pow2(n: torch.Tensor) -> torch.Tensor:
    """The least power of two >= n (n >= 1)."""
    return torch.exp2(torch.ceil(torch.log2(n.double()))).long().clamp(min=1)


def rasterize(clip: torch.Tensor, tri: torch.Tensor, draw: torch.Tensor,
              width: int, height: int, cull: str):
    """-> (triangle index (H, W) long, -1 where none; depth (H, W) f32)."""
    dev = clip.device
    x, y, z, _, area2, ok = setup(clip, tri, width, height)
    if cull == "back":
        face = area2 < 0.0
    elif cull == "front":
        face = area2 > 0.0
    else:
        face = area2 != 0.0
    keep = draw & ok & face
    x0 = torch.ceil(x.amin(1) - 0.5).clamp(min=0).long()
    x1 = torch.floor(x.amax(1) - 0.5).clamp(max=width - 1).long()
    y0 = torch.ceil(y.amin(1) - 0.5).clamp(min=0).long()
    y1 = torch.floor(y.amax(1) - 0.5).clamp(max=height - 1).long()
    keep &= (x1 >= x0) & (y1 >= y0)
    best = torch.zeros(height * width + 1, dtype=torch.long, device=dev)
    idx = torch.nonzero(keep).flatten()
    if idx.numel():
        cw = _pow2(x1[idx] - x0[idx] + 1)
        ch = _pow2(y1[idx] - y0[idx] + 1)
        group = cw * 65536 + ch
        for g in torch.unique(group).tolist():
            members = idx[group == g]
            gw, gh = g // 65536, g % 65536
            step = max(1, BATCH // (gw * gh))
            for s in range(0, members.numel(), step):
                _race(best, members[s:s + step], gw, gh, x, y, z, area2,
                      x0, x1, y0, y1, width, height)
    tid = (best[:-1] & 0xFFFFFFFF) - 1
    depth = (best[:-1] >> 32).to(torch.int32).view(torch.float32)
    return tid.reshape(height, width), depth.reshape(height, width)


def _race(best, t, gw, gh, x, y, z, area2, x0, x1, y0, y1, width, height):
    """Test triangles ``t`` on a gw x gh window from their bounding box's
    first pixel and keep, per pixel, the largest (depth bits, index + 1)."""
    dev = best.device
    gx = x0[t, None] + torch.arange(gw, device=dev)             # (n, gw)
    gy = y0[t, None] + torch.arange(gh, device=dev)             # (n, gh)
    inside = (gx <= x1[t, None])[:, None, :] & (gy <= y1[t, None])[:, :, None]
    px = gx.float()[:, None, :] + 0.5
    py = gy.float()[:, :, None] + 0.5
    xt, yt = x[t][:, None, None, :], y[t][:, None, None, :]
    b0, b1, b2 = barycentric(xt, yt, area2[t][:, None, None], px, py)
    cov = inside & (b0 >= 0.0) & (b1 >= 0.0) & (b2 >= 0.0)
    zt = z[t]
    d = b0 * zt[:, 0, None, None] + b1 * zt[:, 1, None, None] + b2 * zt[:, 2, None, None]
    key = (d.view(torch.int32).long() << 32) | (t[:, None, None] + 1)
    lin = gy[:, :, None] * width + gx[:, None, :]
    lin = torch.where(cov, lin, torch.full((), height * width, device=dev))
    best.scatter_reduce_(0, lin.flatten(), key.flatten(), reduce="amax")


def interpolate(clip: torch.Tensor, tri: torch.Tensor, tid: torch.Tensor,
                attrs: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """Perspective-correct per-vertex ``attrs`` (V, C) at the pixel centres
    of the winners ``tid`` (H, W) -> (H, W, C), 0 where none."""
    dev = clip.device
    valid = tid >= 0
    t = tid.clamp(min=0)
    x, y, _, inv_w, area2, _ = setup(clip, tri[t.flatten()], width, height)
    px = torch.arange(width, device=dev).float().repeat(height) + 0.5
    py = torch.arange(height, device=dev).float().repeat_interleave(width) + 0.5
    b0, b1, b2 = barycentric(x, y, area2, px, py)
    wts = torch.stack([b0, b1, b2], dim=1) * inv_w               # (HW, 3)
    wts = wts / wts.sum(dim=1, keepdim=True)
    a = attrs[tri[t.flatten()]]                                  # (HW, 3, C)
    out = (wts[:, :, None] * a).sum(dim=1)
    out = torch.where(valid.flatten()[:, None], out, torch.zeros((), device=dev))
    return out.reshape(height, width, -1)
