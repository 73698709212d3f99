"""Deferred shading (port of ops/shading.py): the Cook-Torrance core
over GBuffer maps (``shade_deferred``, the unfused chain) and the fused
pass, kernel K3, ``csrc/shade.cu``.

The fused pass is one pass over the select + eval outputs, the material
sample, the shadow gates and the sky: normalize the geometric normal (and, on textured
scenes, the tangent frame: the tangent-space normal map and the choice
between the sampled and the flat material by ``use_tex``), evaluate
Cook-Torrance per point light (inverse-square falloff) and per
directional light, each gated on ``shadow > 0``, add SH-9 ambient with
roughness Fresnel, composite the sky over the background, and write
(3, H, W) HDR. Light counts are static per frame.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import kernels
from .env import _SH_C, sh_eval_irradiance
from .fp import fma, sqrt

F32 = torch.float32

PI = 3.14159265359
F0_NON_METALLIC = 0.04

K3_LAUNCHES = 0    # CUDA launches of the fused shading kernel


@dataclass
class ShadingLights:
    point_position: torch.Tensor   # (P, 3)
    point_color: torch.Tensor      # (P, 3)
    dir_direction: torch.Tensor    # (D, 3)
    dir_color: torch.Tensor        # (D, 3)
    dir_viewproj: torch.Tensor     # (D, 4, 4)


def pack_shading_consts(camera_pos: torch.Tensor, lights: ShadingLights,
                        num_point: int, num_dir: int,
                        irradiance_sh: torch.Tensor | None) -> torch.Tensor:
    """(NC,) f32 constants row: [camera 3 | (pos 3, color 3) per point |
    (dir 3, color 3) per directional | SH-9 row-major 27 with IBL]."""
    parts = [camera_pos.reshape(-1)[:3]]
    for i in range(num_point):
        parts += [lights.point_position[i], lights.point_color[i]]
    for i in range(num_dir):
        parts += [lights.dir_direction[i], lights.dir_color[i]]
    if irradiance_sh is not None:
        parts.append(irradiance_sh.reshape(-1))
    return torch.cat(parts).to(F32)


# ---- the unfused chain: (H, W, 3) maps, formulas of main.wgsl ----------

def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the last (3-wide) axis of a * b, keepdim, rounded as the
    reference's reduction: ``fma(a2, b2, fma(a1, b1, a0 * b0))``."""
    return fma(a[..., 2:3], b[..., 2:3],
               fma(a[..., 1:2], b[..., 1:2], a[..., 0:1] * b[..., 0:1]))


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / sqrt(_dot(v, v)).clamp(min=1e-12)


def fresnel_schlick(cos_theta, f0):
    return f0 + (1.0 - f0) * _pow5((1.0 - cos_theta).clamp(0.0, 1.0))


def fresnel_schlick_roughness(cos_theta, f0, roughness):
    return f0 + (torch.maximum(1.0 - roughness, f0) - f0) * _pow5(
        (1.0 - cos_theta).clamp(0.0, 1.0))


def distribution_ggx(n_dot_h, roughness):
    r2 = roughness * roughness
    r4 = r2 * r2
    denom = fma(n_dot_h * n_dot_h, r4 - 1.0, torch.ones_like(r4))
    return r4 / (PI * denom * denom)


def geometry_schlick_ggx(n_dot_v, roughness):
    r = roughness + 1.0
    k = r * r / 8.0
    return n_dot_v / (n_dot_v * (1.0 - k) + k)


def geometry_smith(n_dot_v, n_dot_l, roughness):
    return (geometry_schlick_ggx(n_dot_v, roughness)
            * geometry_schlick_ggx(n_dot_l, roughness))


def light_contribution(pixel_to_light, light_color, attenuation,
                       pixel_to_camera, normal, albedo, metalness, roughness):
    """One light's Cook-Torrance term (main.wgsl:165-189), (..., 3) and
    (..., 1) maps."""
    half_dir = _normalize(pixel_to_camera + pixel_to_light)
    radiance = light_color * attenuation
    f0 = F0_NON_METALLIC * (1.0 - metalness) + albedo * metalness
    f = fresnel_schlick(_dot(half_dir, pixel_to_camera).clamp(min=0.0), f0)
    n_dot_h = _dot(normal, half_dir).clamp(min=0.0)
    n_dot_v = _dot(normal, pixel_to_camera).clamp(min=0.0)
    n_dot_l = _dot(normal, pixel_to_light).clamp(min=0.0)
    ndf = distribution_ggx(n_dot_h, roughness)
    g = geometry_smith(n_dot_v, n_dot_l, roughness)
    specular = (ndf * g * f) / (4.0 * n_dot_v * n_dot_l + 0.0001)
    k_d = (1.0 - f) * (1.0 - metalness)
    return (k_d * albedo / PI + specular) * radiance * n_dot_l


def diffuse_irradiance_ambient(normal, view, roughness, albedo, metalness,
                               irradiance_sh):
    """Diffuse IBL (main.wgsl:191-200) from the SH-9 irradiance."""
    f0 = F0_NON_METALLIC * (1.0 - metalness) + albedo * metalness
    ks = fresnel_schlick_roughness(_dot(normal, view).clamp(min=0.0), f0,
                                   roughness)
    irr = sh_eval_irradiance(irradiance_sh, normal).clamp(min=0.0)
    return (1.0 - ks) * irr * albedo


def shade_deferred(g, camera_pos: torch.Tensor, lights: "ShadingLights",
                   num_point: int, num_directional: int,
                   irradiance_sh: torch.Tensor | None,
                   shadow_gates: torch.Tensor | None = None) -> torch.Tensor:
    """Deferred shading over a ``resolve.GBuffer`` (main.wgsl:202-259) ->
    HDR (H, W, 3): each point light with inverse-square falloff and each
    directional light, gated on ``shadow > 0`` as the reference gates (not
    scaled by the PCF fraction), plus SH-9 ambient times ao; zero off the
    mask. ``shadow_gates`` (P + D, H, W), points first; None = all lit."""
    pos, normal, albedo = g.position, g.normal, g.albedo
    rough = g.rough_metal_ao[..., 0:1]
    metal = g.rough_metal_ao[..., 1:2]
    ao = g.rough_metal_ao[..., 2:3]
    to_cam = _normalize(camera_pos - pos)
    hdr = torch.zeros_like(albedo)

    def gate(i):
        if shadow_gates is None:
            return 1.0
        return (shadow_gates[i] > 0.0).to(F32)[..., None]

    for i in range(num_point):
        to_light = lights.point_position[i] - pos
        dist2 = _dot(to_light, to_light).clamp(min=1e-8)
        contrib = light_contribution(
            to_light / sqrt(dist2), lights.point_color[i], 1.0 / dist2,
            to_cam, normal, albedo, metal, rough)
        hdr = hdr + contrib * gate(i)
    for i in range(num_directional):
        contrib = light_contribution(
            -lights.dir_direction[i], lights.dir_color[i], 1.0, to_cam,
            normal, albedo, metal, rough)
        hdr = hdr + contrib * gate(num_point + i)
    if irradiance_sh is not None:
        hdr = hdr + diffuse_irradiance_ambient(normal, to_cam, rough, albedo,
                                               metal, irradiance_sh) * ao
    return torch.where(g.mask[..., None], hdr,
                       torch.zeros((), device=hdr.device))


# ---- the fused pass (K3) -------------------------------------------------

def _dot3(ax, ay, az, bx, by, bz):
    # ax * bx + ay * by + az * bz as the reference's CPU build rounds it:
    # fma(az, bz, fma(ax, bx, ay * by))
    return fma(az, bz, fma(ax, bx, ay * by))


def _norm3(x, y, z):
    # divide (not multiply by a reciprocal), as the reference
    d = sqrt(_dot3(x, y, z, x, y, z)).clamp(min=1e-12)
    return x / d, y / d, z / d


def _pow5(x):
    # x * ((x * x) * (x * x)): the reference's integer_pow(x, 5)
    x2 = x * x
    return x * (x2 * x2)


def _layout(outf_c: torch.Tensor, outh_c: torch.Tensor) -> bool:
    """True for the slim layout; checks the channel counts."""
    cf, ch = outf_c.shape[0], outh_c.shape[0]
    if (cf, ch) not in ((4, 9), (7, 15)):
        raise ValueError(f"select + eval outputs must have (4, 9) or (7, 15) "
                         f"channels, got ({cf}, {ch})")
    return cf == 4


def _check_rec(outf_c: torch.Tensor, outh_c: torch.Tensor,
               rec_c: torch.Tensor | None) -> bool:
    """True for the slim layout; a material plane needs the full one."""
    slim = _layout(outf_c, outh_c)
    if rec_c is not None and (slim or rec_c.shape[0] != 9):
        raise ValueError("the material plane rec_c (9, H, W) needs the full "
                         "select + eval layout (the slim one carries no "
                         "tangent frame or use_tex)")
    return slim


def shade_fused_ref(tri_id: torch.Tensor, outf_c: torch.Tensor,
                    outh_c: torch.Tensor, rec_c: torch.Tensor | None,
                    gates_c: torch.Tensor, sky_c: torch.Tensor | None,
                    consts: torch.Tensor, num_point: int, num_dir: int,
                    has_ibl: bool) -> torch.Tensor:
    """Plain PyTorch version of K3 (any device), line by line the
    reference's ``_shade_kernel``. Returns (3, H, W) HDR."""
    slim = _check_rec(outf_c, outh_c, rec_c)
    c = consts
    valid = tri_id >= 0
    h = outh_c.to(F32)
    nx, ny, nz = _norm3(h[0], h[1], h[2])
    a0 = 3 if slim else 9
    alb = [h[a0 + k] for k in range(3)]
    rough, metal = h[a0 + 3], h[a0 + 4]
    if rec_c is not None:
        # tangent-space normal map through the normalized TBN frame; the
        # sampled material where the flat params' use_tex (h[14]) is set
        tx, ty, tz = _norm3(h[3], h[4], h[5])
        bx, by, bz = _norm3(h[6], h[7], h[8])
        use_tex = h[14] > 0.5
        nt = [rec_c[4 + k] * 2.0 - 1.0 for k in range(3)]
        mx, my, mz = _norm3(_dot3(*nt, tx, bx, nx), _dot3(*nt, ty, by, ny),
                            _dot3(*nt, tz, bz, nz))
        nx, ny, nz = (torch.where(use_tex, m, g)
                      for m, g in ((mx, nx), (my, ny), (mz, nz)))
        alb = [torch.where(use_tex, rec_c[k], alb[k]) for k in range(3)]
        rough = torch.where(use_tex, rec_c[7], rough)
        metal = torch.where(use_tex, rec_c[8], metal)
    px, py, pz = outf_c[0], outf_c[1], outf_c[2]
    vx, vy, vz = _norm3(c[0] - px, c[1] - py, c[2] - pz)

    one_m = 1.0 - metal
    f0 = [F0_NON_METALLIC * one_m + a * metal for a in alb]
    n_dot_v = _dot3(nx, ny, nz, vx, vy, vz).clamp(min=0.0)
    kg = (rough + 1.0) * (rough + 1.0) / 8.0
    gv = n_dot_v / (n_dot_v * (1.0 - kg) + kg)
    r2 = rough * rough
    r4 = r2 * r2
    hdr = [torch.zeros_like(px) for _ in range(3)]

    def add_light(hdr, lx, ly, lz, radiance, gate):
        hx, hy, hz = _norm3(vx + lx, vy + ly, vz + lz)
        h_dot_v = _dot3(hx, hy, hz, vx, vy, vz).clamp(min=0.0)
        fres5 = _pow5((1.0 - h_dot_v).clamp(0.0, 1.0))
        n_dot_h = _dot3(nx, ny, nz, hx, hy, hz).clamp(min=0.0)
        n_dot_l = _dot3(nx, ny, nz, lx, ly, lz).clamp(min=0.0)
        denom = fma(n_dot_h * n_dot_h, r4 - 1.0, torch.ones_like(r4))
        ndf = r4 / (PI * denom * denom)
        gl = n_dot_l / (n_dot_l * (1.0 - kg) + kg)
        spec_s = ndf * (gv * gl) / (4.0 * n_dot_v * n_dot_l + 1e-4)
        w = n_dot_l * gate
        out = []
        for ch in range(3):
            f = f0[ch] + (1.0 - f0[ch]) * fres5
            kd = (1.0 - f) * one_m
            out.append(hdr[ch] + (kd * alb[ch] / PI + f * spec_s)
                       * radiance[ch] * w)
        return out

    for i in range(num_point):
        b0 = 3 + 6 * i
        tlx, tly, tlz = c[b0] - px, c[b0 + 1] - py, c[b0 + 2] - pz
        d2 = _dot3(tlx, tly, tlz, tlx, tly, tlz).clamp(min=1e-8)
        dist = sqrt(d2)
        atten = 1.0 / d2
        gate = (gates_c[i] > 0.0).to(F32)
        hdr = add_light(hdr, tlx / dist, tly / dist, tlz / dist,
                        [c[b0 + 3 + ch] * atten for ch in range(3)], gate)
    for i in range(num_dir):
        b0 = 3 + 6 * num_point + 6 * i
        gate = (gates_c[num_point + i] > 0.0).to(F32)
        hdr = add_light(hdr, -c[b0], -c[b0 + 1], -c[b0 + 2],
                        [c[b0 + 3 + ch].expand_as(px) for ch in range(3)],
                        gate)
    if has_ibl:
        s0 = 3 + 6 * (num_point + num_dir)
        basis = [None, _SH_C[1] * ny, _SH_C[1] * nz, _SH_C[1] * nx,
                 _SH_C[2] * nx * ny, _SH_C[2] * ny * nz,
                 _SH_C[3] * (3.0 * nz * nz - 1.0),
                 _SH_C[2] * nx * nz, _SH_C[4] * (nx * nx - ny * ny)]
        fres5 = _pow5((1.0 - n_dot_v).clamp(0.0, 1.0))
        for ch in range(3):
            irr = c[s0 + ch] * _SH_C[0]
            for k in range(1, 9):
                irr = irr + c[s0 + 3 * k + ch] * basis[k]
            irr = irr.clamp(min=0.0)
            ks = f0[ch] + (torch.maximum(1.0 - rough, f0[ch]) - f0[ch]) * fres5
            hdr[ch] = hdr[ch] + (1.0 - ks) * irr * alb[ch]
    bg = sky_c if sky_c is not None else torch.zeros((3,) + px.shape,
                                                     device=px.device)
    return torch.stack([torch.where(valid, hdr[ch], bg[ch])
                        for ch in range(3)], dim=0)


def shade_deferred_fused(tri_id: torch.Tensor, outf_c: torch.Tensor,
                         outh_c: torch.Tensor, rec_c: torch.Tensor | None,
                         gates_c: torch.Tensor, sky_c: torch.Tensor | None,
                         camera_pos: torch.Tensor, lights: ShadingLights,
                         num_point: int, num_dir: int,
                         irradiance_sh: torch.Tensor | None) -> torch.Tensor:
    """Fused deferred shading + sky composite -> (3, H, W) HDR.

    tri_id (H, W) i32; outf_c / outh_c the select + eval split outputs
    (slim or full layout, outh f32 or bf16); rec_c (9, H, W) f32 material
    sample [albedo rgba | normal rgb | rough | metal] (full layout only),
    or None for a flat-only scene: then outh's use_tex plane must be 0
    everywhere, as the engine guarantees through ``cfg.any_textured``;
    gates_c (P + D, H, W) 0/1 shadow gates, points first; sky_c (3, H, W)
    or None. CPU tensors take :func:`shade_fused_ref`; CUDA tensors launch
    K3."""
    if num_point + num_dir == 0 or gates_c.shape[0] != num_point + num_dir:
        raise ValueError("fused shading needs one gate plane per light")
    consts = pack_shading_consts(camera_pos, lights, num_point, num_dir,
                                 irradiance_sh)
    has_ibl = irradiance_sh is not None
    if tri_id.device.type == "cpu":
        return shade_fused_ref(tri_id, outf_c, outh_c, rec_c, gates_c, sky_c,
                               consts, num_point, num_dir, has_ibl)
    global K3_LAUNCHES
    _check_rec(outf_c, outh_c, rec_c)
    H, W = tri_id.shape
    if (tri_id.dtype != torch.int32 or outf_c.dtype != F32
            or outh_c.dtype not in (F32, torch.bfloat16)
            or gates_c.dtype != F32
            or any(t is not None and t.dtype != F32 for t in (rec_c, sky_c))):
        raise ValueError("fused shading operand dtypes: i32 ids, f32 planes, "
                         "f32 or bf16 attributes")
    rec_c, sky_c = (None if t is None else t.contiguous()
                    for t in (rec_c, sky_c))
    ops = [consts.contiguous(), tri_id.contiguous(), outf_c.contiguous(),
           outh_c.contiguous(), gates_c.contiguous()]
    ops += [t for t in (rec_c, sky_c) if t is not None]
    kernels.require_cuda("shade_deferred_fused", *ops)
    for t in ops[1:]:
        if t.shape[-2:] != (H, W):
            raise ValueError(f"fused shading plane shape {tuple(t.shape)} "
                             f"does not end in ({H}, {W})")
    if sky_c is not None and sky_c.shape[0] != 3:
        raise ValueError(f"sky must be (3, H, W), got {tuple(sky_c.shape)}")
    hdr = torch.empty((3, H, W), dtype=F32, device=tri_id.device)
    code = kernels.library().tr_shade(
        ops[0].data_ptr(), ops[1].data_ptr(), ops[2].data_ptr(),
        ops[3].data_ptr(), None if rec_c is None else rec_c.data_ptr(),
        ops[4].data_ptr(), None if sky_c is None else sky_c.data_ptr(),
        hdr.data_ptr(),
        H, W, outf_c.shape[0], outh_c.shape[0],
        int(outh_c.dtype == torch.bfloat16), num_point, num_dir,
        int(has_ibl), kernels.stream_handle(tri_id.device))
    kernels.check("tr_shade", code)
    K3_LAUNCHES += 1
    return hdr
