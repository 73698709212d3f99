"""The plain reference frame: what the engine's deferred frame draws, worked
out again from the scene, the camera, the parameters and the IBL asset.

Per frame: the vertices to world and clip space; the main view's z-buffer
(object ids, reverse-Z depth); the position and normal interpolated
perspective-correct; the shadow views (one z-buffer a view, back faces);
per light a binary gate, PCF ``> 0``, on a coarse grid and exactly on the
blocks along a coarse edge; Cook-Torrance for each point light (inverse
square) and directional light under its gate, plus the SH-9 irradiance
ambient; the sky behind, from the RGBE display cube at a coarse rate and
upsampled; the overlay (the light's billboard) on top; the exposure tone
map. The configuration's stated approximations are followed, not replaced
by the exact quantities: normals and material parameters stored in
bfloat16 (``bf16_attrs``), a bfloat16 atlas (``shadow_bf16``), the RGBE sky
(``sky_rgbe``) at 1/``sky_scale`` rate, the gates at
1/``shadow_lookup_scale`` rate with their refinement.

Everything is float32. Vertex, light and sky transforms and the SH-9
evaluation are matrix products, so ``allow_tf32`` reaches them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from . import env as envlib
from . import raster
from . import scene as scenelib

F32 = torch.float32
PI = 3.14159265359
F0 = 0.04


# an atlas depth whose float32 value lies this close (relative) to a
# midpoint between two bfloat16 values may round to either: float32
# rounding decides it
BF16_TIE = 2.0 ** -14


@dataclass
class Output:
    pick_id: torch.Tensor   # (H, W) int64, 0 = none
    depth: torch.Tensor     # (H, W) f32 reverse-Z
    hdr: torch.Tensor       # (H, W, 3) f32
    sdr: torch.Tensor       # (H, W, 3) uint8
    # the frame where every bfloat16 tie of the atlas rounds the other way
    # (None without ties): a frame may take either at each pixel
    hdr_alt: torch.Tensor | None = None
    sdr_alt: torch.Tensor | None = None


class Environment:
    """The sky's display cube and the irradiance's SH-9 coefficients."""

    def __init__(self, render: dict, ibl_path: str, device):
        eq = torch.as_tensor(envlib.procedural_sky(), device=device)
        cube = envlib.equirect_cube(eq, render["env_size"])
        self.sky = envlib.rgbe(cube) if render["sky_rgbe"] else cube
        irr = torch.as_tensor(np.load(ibl_path)["irradiance"].astype(np.float32),
                              device=device)
        if irr.shape[1] != render["irradiance_size"]:
            raise ValueError("the reference reads the IBL asset at its own size")
        self.sh = envlib.sh_project(irr)


def _h(v, device):
    return torch.as_tensor(np.asarray(v, np.float64), dtype=F32, device=device)


def _bf16(t: torch.Tensor, on: bool) -> torch.Tensor:
    return t.to(torch.bfloat16).to(F32) if on else t


def _homog(p: torch.Tensor) -> torch.Tensor:
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


class Geometry:
    """The scene's vertices in world space, one copy an object."""

    def __init__(self, scene: dict, device):
        t = scenelib.triangles(scene)
        pos, nrm = [], []
        start = 0
        for model, n in t["models"]:
            m = _h(model, device)
            nm = _h(np.linalg.inv(model[:3, :3]).T, device)
            lp = _h(t["local_pos"][start:start + n], device)
            ln = _h(t["local_nrm"][start:start + n], device)
            pos.append(_homog(lp) @ m.T)
            nrm.append(ln @ nm.T)
            start += n
        self.world = torch.cat(pos)[:, :3]                       # (V, 3)
        self.normal = torch.cat(nrm)
        self.tri = torch.as_tensor(t["tri"], device=device)
        self.oid = torch.as_tensor(t["oid"], device=device)
        self.forward = torch.as_tensor(t["forward"], device=device)
        self.shadow = torch.as_tensor(t["shadow"], device=device)
        mats = [o["material"] or dict(albedo=[1.0, 1.0, 1.0], roughness=1.0,
                                      metalness=0.0)
                for o in scene["objects"]]
        flat = [[*m["albedo"], m["roughness"], m["metalness"]] for m in mats]
        self.flat = _h(flat, device)[torch.as_tensor(t["mat"], device=device)]

    def clip(self, viewproj: torch.Tensor) -> torch.Tensor:
        return _homog(self.world) @ viewproj.T


class Lights:
    def __init__(self, scene: dict, device):
        pts, dirs = scene["point_lights"], scene["directional_lights"]
        self.point_pos = _h([p["position"] for p in pts], device).reshape(-1, 3)
        self.point_color = _h([p["color"] for p in pts], device).reshape(-1, 3)
        d = [np.asarray(x["direction"], np.float64) for x in dirs]
        self.dir_dir = _h([v / np.linalg.norm(v) for v in d], device).reshape(-1, 3)
        self.dir_color = _h([x["color"] for x in dirs], device).reshape(-1, 3)
        self.point_vps = _h(np.stack([scenelib.point_light_viewprojs(p["position"])
                                      for p in pts]) if pts else
                            np.zeros((0, 6, 4, 4)), device)
        self.dir_vps = _h(np.stack([scenelib.directional_light_viewproj(x["direction"])
                                    for x in dirs]) if dirs else
                          np.zeros((0, 4, 4)), device)

    @property
    def count(self) -> int:
        return self.point_pos.shape[0] + self.dir_dir.shape[0]

    def views(self) -> torch.Tensor:
        return torch.cat([self.point_vps.reshape(-1, 4, 4), self.dir_vps])


def shadow_atlas(geo: Geometry, lights: Lights, render: dict) -> torch.Tensor:
    """(views, S, S, 4) float32: each view's depth with its +x, +y and +x+y
    neighbours (clamped at the edge); see :func:`atlas_bounds` for its
    bfloat16 storage."""
    S = render["shadow_size"]
    maps = []
    for vp in lights.views():
        _, d = raster.rasterize(geo.clip(vp), geo.tri, geo.shadow, S, S, "front")
        maps.append(d)
    a = torch.stack(maps)
    right = torch.cat([a[:, :, 1:], a[:, :, -1:]], dim=2)
    down = torch.cat([a[:, 1:], a[:, -1:]], dim=1)
    diag = torch.cat([down[:, :, 1:], down[:, :, -1:]], dim=2)
    return torch.stack([a, right, down, diag], dim=-1)


def atlas_bounds(atlas: torch.Tensor, bf16: bool):
    """The stored atlas, as (lowest, highest) it can be: float32 as it is;
    under bfloat16 each depth rounded to nearest even, except that a depth
    within ``BF16_TIE`` of a midpoint between two bfloat16 values takes the
    lower of the two in the first and the upper in the second."""
    if not bf16:
        return atlas, atlas
    near = atlas.to(torch.bfloat16).to(F32)
    bits = atlas.view(torch.int32) & -65536           # truncated (depth >= 0)
    down = bits.view(F32)
    up = (bits + 65536).view(F32)
    tie = ((atlas - 0.5 * (down + up)).abs() <= BF16_TIE * atlas.abs()) & (atlas > 0)
    return torch.where(tie, down, near), torch.where(tie, up, near)


def _project(pos: torch.Tensor, vp: torch.Tensor):
    c = _homog(pos) @ vp.T
    w = c[..., 3]
    inv = 1.0 / torch.where(w.abs() > 1e-9, w, torch.ones_like(w))
    return (c[..., 0] * inv * 0.5 + 0.5, 0.5 - c[..., 1] * inv * 0.5,
            c[..., 2] * inv, w)


def visibility(pos: torch.Tensor, lights: Lights, atlas: torch.Tensor,
               bias: float) -> torch.Tensor:
    """(L, ...) bool: each light's 2x2 PCF visibility at world points pos
    (..., 3) is > 0; a point outside a directional light's box is lit."""
    S = atlas.shape[1]
    flat = atlas.reshape(-1, 4)
    out = []

    def pcf(view, u, v, z):
        fu, fv = u * S - 0.5, v * S - 0.5
        x0, y0 = torch.floor(fu), torch.floor(fv)
        fx, fy = fu - x0, fv - y0
        x0 = x0.long().clamp(0, S - 1)
        y0 = y0.long().clamp(0, S - 1)
        taps = flat[(view * S + y0) * S + x0]
        wts = torch.stack([(1 - fx) * (1 - fy), fx * (1 - fy),
                           (1 - fx) * fy, fx * fy], dim=-1)
        lit = (z[..., None] + bias > taps).to(F32)
        return (lit * wts).sum(dim=-1) > 0.0

    for i in range(lights.point_pos.shape[0]):
        d = pos - lights.point_pos[i]
        a = d.abs()
        is_x = (a[..., 0] >= a[..., 1]) & (a[..., 0] >= a[..., 2])
        is_y = (a[..., 1] > a[..., 0]) & (a[..., 1] >= a[..., 2])
        face = torch.where(is_x, torch.where(d[..., 0] >= 0, 0, 1),
                           torch.where(is_y, torch.where(d[..., 1] >= 0, 2, 3),
                                       torch.where(d[..., 2] >= 0, 4, 5)))
        u = v = z = w = None
        for f in range(6):
            pu, pv, pz, pw = _project(pos, lights.point_vps[i, f])
            m = face == f
            if u is None:
                u, v, z, w = pu, pv, pz, pw
            else:
                u, v = torch.where(m, pu, u), torch.where(m, pv, v)
                z, w = torch.where(m, pz, z), torch.where(m, pw, w)
        vis = pcf(6 * i + face.long(), u, v, z)
        out.append(vis | ~(w > 0.0))
    n_point = lights.point_pos.shape[0]
    for i in range(lights.dir_dir.shape[0]):
        u, v, z, w = _project(pos, lights.dir_vps[i])
        inside = (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1) & (w > 0)
        vis = pcf(torch.full_like(u, 6 * n_point + i, dtype=torch.long), u, v, z)
        out.append(vis | ~inside)
    return torch.stack(out)


def gates(pos: torch.Tensor, lights: Lights, atlas: torch.Tensor, bias: float,
          scale: int, block: tuple) -> torch.Tensor:
    """(L, H, W) bool gates of the padded frame: the visibility of each
    scale x scale cell's first pixel, except on the blocks that hold a cell
    whose coarse gate differs from one of its eight neighbours (the frame's
    edge repeated), where each pixel's own visibility is taken."""
    H, W = pos.shape[:2]
    if scale <= 1:
        return visibility(pos, lights, atlas, bias)
    lo = visibility(pos[::scale, ::scale], lights, atlas, bias)  # (L, h, w)
    L, h, w = lo.shape
    pad = F.pad(lo[None].float(), (1, 1, 1, 1), mode="replicate")[0] > 0.5
    edge = torch.zeros_like(lo)
    for dy in range(3):
        for dx in range(3):
            edge |= lo != pad[:, dy:dy + h, dx:dx + w]
    coarse = lo.repeat_interleave(scale, 1).repeat_interleave(scale, 2)
    bh, bw = block
    cell_edge = edge.repeat_interleave(scale, 1).repeat_interleave(scale, 2)
    blk = cell_edge.reshape(L, H // bh, bh, W // bw, bw).any(dim=4).any(dim=2)
    refine = blk.repeat_interleave(bh, 1).repeat_interleave(bw, 2)
    exact = visibility(pos, lights, atlas, bias)
    return torch.where(refine, exact, coarse)


def shade(pos, normal, flat, cam_pos, lights: Lights, gate, sh):
    """Cook-Torrance (GGX, Smith-Schlick, Fresnel-Schlick) per light, the
    gate applied, plus the SH-9 diffuse ambient with roughness Fresnel."""
    albedo, rough, metal = flat[..., 0:3], flat[..., 3:4], flat[..., 4:5]
    n = normal / torch.linalg.vector_norm(normal, dim=-1, keepdim=True).clamp(min=1e-12)
    v = cam_pos - pos
    v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp(min=1e-12)
    f0 = F0 * (1.0 - metal) + albedo * metal
    n_v = (n * v).sum(-1, keepdim=True).clamp(min=0.0)
    k = (rough + 1.0) ** 2 / 8.0
    g_v = n_v / (n_v * (1.0 - k) + k)
    r4 = rough ** 4
    hdr = torch.zeros_like(pos)
    dirs = []
    for i in range(lights.point_pos.shape[0]):
        to_l = lights.point_pos[i] - pos
        d2 = (to_l * to_l).sum(-1, keepdim=True).clamp(min=1e-8)
        dirs.append((to_l / torch.sqrt(d2), lights.point_color[i] / d2))
    for i in range(lights.dir_dir.shape[0]):
        dirs.append((-lights.dir_dir[i].expand_as(pos), lights.dir_color[i]))
    for i, (l, radiance) in enumerate(dirs):
        hv = v + l
        hv = hv / torch.linalg.vector_norm(hv, dim=-1, keepdim=True).clamp(min=1e-12)
        h_v = (hv * v).sum(-1, keepdim=True).clamp(min=0.0)
        n_h = (n * hv).sum(-1, keepdim=True).clamp(min=0.0)
        n_l = (n * l).sum(-1, keepdim=True).clamp(min=0.0)
        fres = f0 + (1.0 - f0) * (1.0 - h_v).clamp(0.0, 1.0) ** 5
        ndf = r4 / (PI * (n_h * n_h * (r4 - 1.0) + 1.0) ** 2)
        g = g_v * n_l / (n_l * (1.0 - k) + k)
        spec = ndf * g * fres / (4.0 * n_v * n_l + 1e-4)
        kd = (1.0 - fres) * (1.0 - metal)
        hdr = hdr + (kd * albedo / PI + spec) * radiance * n_l * gate[i][..., None]
    if sh is not None:
        irr = (envlib.sh_basis(n) @ sh).clamp(min=0.0)
        ks = f0 + (torch.maximum(1.0 - rough, f0) - f0) * (1.0 - n_v).clamp(0.0, 1.0) ** 5
        hdr = hdr + (1.0 - ks) * irr * albedo
    return hdr


def upsample_bilinear(img: torch.Tensor, s: int) -> torch.Tensor:
    """(h, w, C) -> (h s, w s, C): half-pixel centres, edges clamped."""
    out = img.permute(2, 0, 1)[None]
    out = F.interpolate(out, scale_factor=s, mode="bilinear", align_corners=False)
    return out[0].permute(1, 2, 0)


def sky(environment: Environment, view: torch.Tensor, proj_inv: torch.Tensor,
        PH: int, PW: int, s: int) -> torch.Tensor:
    """(PH, PW, 3): the cube along each coarse pixel's ray (unprojected at
    the far plane, rotated by the inverse view), upsampled."""
    h, w = PH // s, PW // s
    dev = view.device
    py, px = torch.meshgrid(torch.arange(h, device=dev, dtype=F32) + 0.5,
                            torch.arange(w, device=dev, dtype=F32) + 0.5,
                            indexing="ij")
    ndc = torch.stack([px / w * 2.0 - 1.0, -(py / h * 2.0 - 1.0),
                       torch.zeros_like(px), torch.ones_like(px)], dim=-1)
    ray = (ndc @ proj_inv.T)[..., :3] @ view[:3, :3]
    c = envlib.sample_cube(environment.sky, ray)
    return upsample_bilinear(c, s) if s > 1 else c


def tone_map(hdr: torch.Tensor, exposure: float) -> torch.Tensor:
    ldr = (1.0 - torch.exp(-hdr * exposure)).clamp(0.0, 1.0)
    return (torch.pow(ldr, 1.0 / 2.2) * 255.0 + 0.5).clamp(0.0, 255.0).to(torch.uint8)


def render(scene: dict, render_cfg: dict, params: dict,
           environment: Environment, atlas: torch.Tensor | None = None,
           device="cpu") -> tuple[Output, torch.Tensor]:
    """One frame of ``scene`` under the configuration's ``render`` fields
    and the parameters (``exposure``, ``shadow_bias``) -> (Output, the
    shadow atlas, which a caller may pass back while the scene stands)."""
    rc = render_cfg
    W, H = rc["width"], rc["height"]
    PW = -(-W // rc["tile_w"]) * rc["tile_w"]
    PH = -(-H // rc["tile_h"]) * rc["tile_h"]
    geo = Geometry(scene, device)
    lights = Lights(scene, device)
    view64, proj64 = scenelib.camera_matrices(scene["camera"], W, H)
    view, proj = _h(view64, device), _h(proj64, device)
    proj_inv = _h(np.linalg.inv(proj.double().cpu().numpy()), device)
    clip = geo.clip(proj @ view)

    # the main view: ids, depth, position and the stored normal
    tid, depth = raster.rasterize(clip, geo.tri, ~geo.forward, PW, PH, "back")
    valid = tid >= 0
    t = tid.clamp(min=0)
    interp = raster.interpolate(clip, geo.tri, tid,
                                torch.cat([geo.world, geo.normal], dim=1), PW, PH)
    pos = interp[..., 0:3]
    normal = _bf16(interp[..., 3:6], rc["bf16_attrs"])
    flat = _bf16(geo.flat[t], rc["bf16_attrs"])
    pick = torch.where(valid, geo.oid[t], torch.zeros((), dtype=torch.long,
                                                      device=device))

    # shadows: the gates of the atlas's lowest and highest storage
    n_lights = lights.count
    if rc["enable_shadows"] and n_lights:
        if atlas is None:
            atlas = shadow_atlas(geo, lights, rc)
        gate_set = [gates(pos, lights, a, params["shadow_bias"],
                          rc["shadow_lookup_scale"],
                          (rc["gate_block_h"], rc["gate_block_w"]))
                    for a in atlas_bounds(atlas, rc["shadow_bf16"])]
        if torch.equal(gate_set[0], gate_set[1]):
            gate_set = gate_set[:1]
    else:
        gate_set = [torch.ones((n_lights, PH, PW), dtype=torch.bool,
                               device=device)]

    cam_pos = _h(scene["camera"]["position"], device)
    sh = environment.sh if rc["enable_ibl"] else None
    bg = sky(environment, view, proj_inv, PH, PW, rc["sky_scale"])
    fid, _ = raster.rasterize(clip, geo.tri, geo.forward, PW, PH, "none")
    over = fid >= 0
    color = torch.tensor(scenelib.BILLBOARD_RGB, dtype=F32, device=device)
    pick = torch.where(over, geo.oid[fid.clamp(min=0)], pick)
    frames = []
    for gate in gate_set:
        lit = shade(pos, normal, flat, cam_pos, lights, gate.to(F32), sh)
        hdr = torch.where(valid[..., None], lit, bg)
        # the overlay: forward triangles drawn on top, unlit
        hdr = torch.where(over[..., None], color, hdr)[:H, :W]
        frames.append((hdr, tone_map(hdr, params["exposure"])))
    hdr, sdr = frames[0]
    alt = frames[1] if len(frames) > 1 else (None, None)
    out = Output(pick_id=pick[:H, :W], depth=depth[:H, :W], hdr=hdr, sdr=sdr,
                 hdr_alt=alt[0], sdr_alt=alt[1])
    return out, atlas
