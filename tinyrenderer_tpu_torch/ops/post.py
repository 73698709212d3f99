"""Post-processing (port of ops/post.py): tone mapping + gamma,
screen-space reflections, the exact integer-factor bilinear and
Catmull-Rom upsamples (the coarse sky, the strided material sample), the
resizes of the scaled frame, of a sky the scale does not divide and of the
irradiance map, and the 2x2 box mip reduction."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .fp import fma, fma_chain, lerp

F32 = torch.float32
I32 = torch.int32

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


def upsample_bilinear_int(img: torch.Tensor, sy: int, sx: int
                          ) -> torch.Tensor:
    """(H, W, *C) -> (H * sy, W * sx, *C) bilinear upsample, integer
    factors (equal to ``jax.image.resize``'s bilinear for them)."""
    out = upsample_axis(img, sy, 0) if sy > 1 else img
    return upsample_axis(out, sx, 1) if sx > 1 else out


def _shift_clamped(img: torch.Tensor, k: int, axis: int) -> torch.Tensor:
    """``in[i + k]`` along ``axis``, the edge row repeated (clamp at the
    edge), any ``|k| < n``."""
    if k == 0:
        return img
    n = img.shape[axis]
    if k > 0:
        return torch.cat([img.narrow(axis, k, n - k)]
                         + [img.narrow(axis, n - 1, 1)] * k, axis)
    return torch.cat([img.narrow(axis, 0, 1)] * -k
                     + [img.narrow(axis, 0, n + k)], axis)


def _cr_weights(p: float) -> tuple[float, float, float, float]:
    """Catmull-Rom (a = -0.5) weights of the taps at -1, 0, 1, 2 around
    the base sample, at fraction ``p`` in [0, 1)."""
    p2, p3 = p * p, p * p * p
    return (-0.5 * p3 + p2 - 0.5 * p,
            1.5 * p3 - 2.5 * p2 + 1.0,
            -1.5 * p3 + 2.0 * p2 + 0.5 * p,
            0.5 * p3 - 0.5 * p2)


def _upsample_axis_cubic(img: torch.Tensor, s: int, axis: int
                         ) -> torch.Tensor:
    """Exact integer-factor Catmull-Rom upsample along one axis
    (half-pixel centres, clamp at the edge): ``s`` phase-wise four-tap
    weighted adds, interleaved."""
    shifts = {k: _shift_clamped(img, k, axis) for k in (-2, -1, 0, 1, 2)}
    phases = []
    for k in range(s):
        f = (k + 0.5) / s - 0.5
        m = -1 if f < 0.0 else 0
        w = _cr_weights(f - m)
        phases.append(w[0] * shifts[m - 1] + w[1] * shifts[m]
                      + w[2] * shifts[m + 1] + w[3] * shifts[m + 2])
    out = torch.stack(phases, dim=axis + 1)
    shape = list(img.shape)
    shape[axis] *= s
    return out.reshape(shape)


def upsample_bicubic_int(img: torch.Tensor, sy: int, sx: int
                         ) -> torch.Tensor:
    """(H, W, *C) -> (H * sy, W * sx, *C) Catmull-Rom upsample, integer
    factors (separable)."""
    out = _upsample_axis_cubic(img, sy, 0) if sy > 1 else img
    return _upsample_axis_cubic(out, sx, 1) if sx > 1 else out


def upsample_bicubic_int_cf(img: torch.Tensor, sy: int, sx: int
                            ) -> torch.Tensor:
    """(C, H, W) -> (C, H * sy, W * sx) Catmull-Rom upsample, integer
    factors."""
    out = _upsample_axis_cubic(img, sy, 1) if sy > 1 else img
    return _upsample_axis_cubic(out, sx, 2) if sx > 1 else out


def box_mip(img: torch.Tensor) -> torch.Tensor:
    """(..., h, w, C) -> (..., h / 2, w / 2, C): the 2x2 box mip
    reduction, summed row by row as the reference's reduction."""
    h, w = img.shape[-3], img.shape[-2]
    q = img.reshape(img.shape[:-3] + (h // 2, 2, w // 2, 2, img.shape[-1]))
    return (((q[..., 0, :, 0, :] + q[..., 0, :, 1, :]) + q[..., 1, :, 0, :])
            + q[..., 1, :, 1, :]) / 4.0


def resize_bilinear(img: torch.Tensor, height: int, width: int
                    ) -> torch.Tensor:
    """(H, W, C) -> (height, width, C) bilinear upsample, half-pixel
    centres, clamped at the edge: the values of ``jax.image.resize(...,
    "bilinear")`` for an upsample (which renormalizes its edge weights,
    the same as clamping), to rounding."""
    x = img.permute(2, 0, 1)[None]
    out = F.interpolate(x, size=(height, width), mode="bilinear",
                        align_corners=False)
    return out[0].permute(1, 2, 0)


def resize_nearest(img: torch.Tensor, height: int, width: int
                   ) -> torch.Tensor:
    """(H, W, ...) nearest resize with ``jax.image.resize``'s indices:
    ``floor(float32((i + 0.5) * in / out))``, computed in float32 so that
    ids stay exact and land where the reference puts them."""
    for axis, n in ((0, height), (1, width)):
        m = img.shape[axis]
        if m == n:
            continue
        i = torch.arange(n, dtype=F32, device=img.device)
        idx = torch.floor((i + 0.5) * m / n).to(torch.long).clamp(max=m - 1)
        img = img.index_select(axis, idx)
    return img


def resize_linear(img: torch.Tensor, shape: tuple) -> torch.Tensor:
    """``jax.image.resize(img, shape, "linear")`` with its antialiasing:
    a separable product with (out, in) triangle-filter weight matrices,
    widened by the downsample factor, normalized, and zero where a sample
    falls outside the input (the irradiance map's resize)."""
    out = img
    for d, n in enumerate(shape):
        m = out.shape[d]
        if m == n:
            continue
        inv_scale = m / n
        kscale = max(inv_scale, 1.0)
        sample = ((torch.arange(n, dtype=F32, device=img.device) + 0.5)
                  * inv_scale - 0.5)
        x = (sample[None, :] - torch.arange(m, dtype=F32,
                                            device=img.device)[:, None]
             ).abs() / kscale
        w = (1.0 - x).clamp(min=0.0)                          # (m, n)
        total = w.sum(dim=0, keepdim=True)
        w = torch.where(total.abs() > 1000.0 * torch.finfo(F32).eps,
                        w / torch.where(total != 0, total, 1.0), 0.0)
        w = torch.where((sample >= -0.5) & (sample <= m - 0.5), w, 0.0)
        out = torch.tensordot(out.movedim(d, -1), w, dims=1).movedim(-1, d)
    return out


def _project_ray_points(position, refl, ts, view_proj):
    """World points ``position + refl * ts`` projected to (u, v, ray_z),
    rounded as the reference's compiled frame: the point as one fused
    multiply-add, each clip row ``fma(p2, v2, fma(p1, v1, p0 * v0)) + v3``."""
    p = fma(refl, ts[..., None], position)
    px, py, pz = p[..., 0], p[..., 1], p[..., 2]
    vp = view_proj
    c = [fma_chain([(px, vp[i, 0]), (py, vp[i, 1]), (pz, vp[i, 2])],
                   d=vp[i, 3]) for i in range(4)]
    w = c[3].clamp(min=1e-6)
    u = (c[0] / w) * 0.5 + 0.5
    v = 0.5 - (c[1] / w) * 0.5
    return u, v, c[2] / w


def _tap(img_flat: torch.Tensor, u, v, H: int, W: int):
    """Full-resolution tap at (u, v): (xi, yi, value). ``u * W`` truncates
    toward zero before the clip, as the reference's int32 cast."""
    xi = (u * W).to(I32).clamp(0, W - 1)
    yi = (v * H).to(I32).clamp(0, H - 1)
    return xi, yi, img_flat[(yi * W + xi).long()]


def screen_space_reflections(hdr: torch.Tensor, depth: torch.Tensor,
                             position: torch.Tensor, normal: torch.Tensor,
                             view_proj: torch.Tensor,
                             camera_pos: torch.Tensor,
                             thickness: torch.Tensor, strength: torch.Tensor,
                             num_steps: int = 256,
                             mask: torch.Tensor | None = None,
                             roughness: torch.Tensor | None = None,
                             tap_hdr: torch.Tensor | None = None,
                             y0: int | None = None) -> torch.Tensor:
    """Screen-space reflections over (H, W) maps: a coarse march of
    ``num_steps // 4`` taps of 4 steps each against the 4x4 max-reduced
    depth (reverse-Z: the nearest surface of the footprint, so no surface
    the fine march could hit is stepped over), then 8 bisection taps of the
    full-resolution depth inside the bracketed interval, a thickness test
    at the refined point, rejection of hits on or next to the pixel itself,
    and a blend by ``strength`` times the gloss ``(1 - roughness)^2``.
    Strength 0 (the default parameter) passes the image through.

    Band mode (the sharded frame): the per-pixel inputs (hdr, position,
    normal, mask, roughness) cover the band of rows from ``y0`` while the
    taps read the gathered frame, ``depth`` and ``tap_hdr`` (H, W); the
    projection is the frame's already, ``y0`` only places the band's
    pixels for the self-hit test."""
    H, W = depth.shape
    Bh = position.shape[0]
    dev = hdr.device
    tap_hdr = hdr if tap_hdr is None else tap_hdr
    view = position - camera_pos
    vx, vy, vz = view[..., 0], view[..., 1], view[..., 2]
    n = fma_chain([(vy, vy), (vx, vx), (vz, vz)], root=True).clamp(min=1e-9)
    view = view / n[..., None]
    vx, vy, vz = view[..., 0], view[..., 1], view[..., 2]
    nx, ny, nz = normal[..., 0], normal[..., 1], normal[..., 2]
    vdn = fma_chain([(vy, ny), (vx, nx), (vz, nz)])
    refl = view - (2.0 * vdn)[..., None] * normal

    step_len = 0.25
    Hp, Wp = -(-H // 4) * 4, -(-W // 4) * 4
    dmax = F.pad(depth, (0, Wp - W, 0, Hp - H)).reshape(
        Hp // 4, 4, Wp // 4, 4).amax(dim=(1, 3))
    Hc, Wc = Hp // 4, Wp // 4
    dmax_flat, depth_flat = dmax.reshape(-1), depth.reshape(-1)

    t_hit = torch.zeros((Bh, W), dtype=F32, device=dev)
    found = torch.zeros((Bh, W), dtype=torch.bool, device=dev)
    for i in range(max(num_steps // 4, 1)):
        t = step_len * 4.0 * (i + 1.0)
        u, v, ray_z = _project_ray_points(position, refl,
                                          torch.full((Bh, W), t, device=dev),
                                          view_proj)
        _, _, scene_z = _tap(dmax_flat, u, v, Hc, Wc)
        inside = (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1)
        hit = inside & (scene_z > ray_z) & (scene_z > 0)
        t_hit = torch.where(hit & ~found, t, t_hit)
        found = found | hit

    t_lo = (t_hit - step_len * 4.0).clamp(min=0.0)
    t_hi = t_hit
    for _ in range(8):
        tm = 0.5 * (t_lo + t_hi)
        u, v, ray_z = _project_ray_points(position, refl, tm, view_proj)
        _, _, scene_z = _tap(depth_flat, u, v, H, W)
        front = (scene_z > ray_z) & (scene_z > 0)
        t_lo, t_hi = torch.where(front, t_lo, tm), torch.where(front, tm, t_hi)

    u, v, ray_z = _project_ray_points(position, refl, t_hi, view_proj)
    xi, yi, scene_z = _tap(depth_flat, u, v, H, W)
    inside = (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1)
    hit = (found & inside & (scene_z > ray_z)
           & (scene_z - ray_z < thickness) & (scene_z > 0))
    px = torch.arange(W, dtype=I32, device=dev)[None, :]
    py = torch.arange(Bh, dtype=I32, device=dev)[:, None] + (y0 or 0)
    hit = hit & (((xi - px).abs() + (yi - py).abs()) > 2)
    if mask is not None:
        hit = hit & mask
    refl_color = tap_hdr.reshape(-1, 3)[(yi * W + xi).long()]
    blend = strength * hit.to(F32)[..., None]
    if roughness is not None:
        gloss = (1.0 - roughness).clamp(0.0, 1.0)[..., None]
        blend = blend * gloss * gloss
    return lerp(hdr, refl_color, blend)
