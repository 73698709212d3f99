"""Scene -> device packing (port of render/scene_gpu.py).

The world becomes a handful of padded, capacity-static arrays: an
instance-shared unique vertex pool, the flattened per-instance vertex and
triangle pools, the instance table and the material table. Packing is
host numpy (:class:`ScenePacker`); :func:`scene_from_numpy` and
:func:`lights_from_numpy` upload the named arrays — the port's own pack,
or the JAX pack's fields fetched with ``np.asarray``.

Material textures are staged on the host (``assets.textures.TexturePool``)
as composite 9-channel records; ``pool_for``
packs them into the windowed u8 device pool the frame samples, once per
pool change and device.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import config
from ..assets import mesh as meshlib
from ..assets import textures as texlib
from ..ops import sampling
from ..scene import components as comp
from ..scene import lights as lightslib
from ..scene.world import World

log = logging.getLogger(__name__)

F32 = np.float32
I32 = np.int32


@dataclass
class SceneGPU:
    """Device-resident packed scene."""

    vert_data: torch.Tensor       # (Uc, 14) unique rows: pos3 uv2 n3 t3 b3
    vert_src: torch.Tensor        # (Vc,) i32 flattened slot -> unique row
    vert_instance: torch.Tensor   # (Vc,) i32
    tri_vidx: torch.Tensor        # (Tc, 3) i32
    tri_instance: torch.Tensor    # (Tc,) i32
    tri_deferred: torch.Tensor    # (Tc,) bool
    tri_shadow: torch.Tensor      # (Tc,) bool
    fwd_tri_vidx: torch.Tensor    # (Fc, 3) i32 forward (overlay) triangles
    fwd_tri_instance: torch.Tensor  # (Fc,) i32
    fwd_tri_mask: torch.Tensor    # (Fc,) bool
    inst_model: torch.Tensor      # (Ic, 4, 4)
    inst_normal_mat: torch.Tensor  # (Ic, 3, 3)
    inst_object_id: torch.Tensor  # (Ic,) i32
    inst_material: torch.Tensor   # (Ic,) i32
    mat_tex_slots: torch.Tensor   # (Mc, 4) i32
    mat_flat: torch.Tensor        # (Mc, 6) f32: albedo3 rough metal use_tex
    mat_record: torch.Tensor      # (Mc,) i32 composite-record index


@dataclass
class LightsGPU:
    point_position: torch.Tensor    # (P, 3)
    point_color: torch.Tensor       # (P, 3)
    dir_direction: torch.Tensor     # (D, 3)
    dir_color: torch.Tensor         # (D, 3)
    dir_viewproj: torch.Tensor      # (D, 4, 4)
    shadow_viewprojs: torch.Tensor  # (6P + D, 4, 4)


@dataclass
class PackResult:
    scene: SceneGPU
    lights: LightsGPU
    counts: dict        # host-side sizes for capacity checks


def _upload(cls, arrays: dict, device) -> object:
    return cls(**{f.name: torch.tensor(np.asarray(arrays[f.name]), device=device)
                  for f in dataclasses.fields(cls)})


def scene_from_numpy(arrays: dict, device) -> SceneGPU:
    """SceneGPU from numpy arrays named by its fields (extra keys ignored)."""
    return _upload(SceneGPU, arrays, device)


def lights_from_numpy(arrays: dict, device) -> LightsGPU:
    """LightsGPU from numpy arrays named by its fields (extra keys ignored)."""
    return _upload(LightsGPU, arrays, device)


class CapacityError(RuntimeError):
    """The scene exceeds the configured capacities: grow the RenderConfig."""

    def __init__(self, counts: dict):
        super().__init__(f"scene exceeds capacities: {counts}")
        self.counts = counts


def _cat_mats(mats: list, capacity: int, n: int) -> np.ndarray:
    out = np.tile(np.eye(n, dtype=F32), (capacity, 1, 1))
    for i, m in enumerate(mats):
        out[i] = m
    return out


class ScenePacker:
    """Host-side packer with mesh and material caches."""

    def __init__(self, cfg: config.RenderConfig,
                 asset_search_paths: tuple[str, ...] = (".",)):
        self.cfg = cfg
        self.asset_search_paths = asset_search_paths
        self.pool = texlib.TexturePool.create(cfg)
        self._pool_gpu: dict = {}     # layout flags + device -> pool
        self._pool_dirty = True       # host records changed since packing
        self._mesh_cache: dict = {}
        self._material_cache: dict = {}
        # (tex slots, flat params, record); material 0 is the default
        self._materials: list = [(
            np.array([texlib.DEFAULT_ALBEDO_SLOT, texlib.DEFAULT_NORMAL_SLOT,
                      texlib.DEFAULT_ROUGHNESS_SLOT,
                      texlib.DEFAULT_METALNESS_SLOT], I32),
            np.array([1.0, 1.0, 1.0, 1.0, 0.0, 1.0], F32), 0)]

    def resolve_path(self, path: str) -> Optional[str]:
        if os.path.isabs(path):
            return path if os.path.exists(path) else None
        for root in self.asset_search_paths:
            p = os.path.join(root, path)
            if os.path.exists(p):
                return p
        return None

    def load_mesh(self, desc: comp.MeshDescriptor) -> meshlib.MeshData:
        if desc in self._mesh_cache:
            return self._mesh_cache[desc]
        if desc.kind == "PrimitiveInCode":
            mesh = meshlib.get_primitive(desc.value)
        else:
            from ..assets import gltf as gltflib
            base, part = gltflib.split_part_fragment(desc.value)
            path = self.resolve_path(base)
            if path is None:
                log.warning("mesh not found: %s; substituting cube", desc.value)
                mesh = meshlib.get_primitive("Cube")
            elif path.lower().endswith(".obj"):
                mesh = meshlib.load_obj(path)
            elif path.lower().endswith((".gltf", ".glb")):
                if part is not None:
                    path = f"{path}#part{part}"
                try:
                    mesh = gltflib.load_gltf(path)
                except (OSError, ValueError, KeyError) as e:
                    log.warning("glTF load failed (%s): %s; substituting cube",
                                path, e)
                    mesh = meshlib.get_primitive("Cube")
            else:
                log.warning("unsupported mesh format: %s; substituting cube",
                            path)
                mesh = meshlib.get_primitive("Cube")
        self._mesh_cache[desc] = mesh
        return mesh

    def material_index(self, desc: comp.PbrMaterialDescriptor) -> int:
        key = json.dumps(desc.to_json(), sort_keys=True)
        if key in self._material_cache:
            return self._material_cache[key]
        if desc.is_flat:
            p = desc.flat
            slots = np.array([0, 1, 2, 3], I32)
            flat = np.array([p.albedo[0], p.albedo[1], p.albedo[2],
                             p.roughness, p.metalness, 0.0], F32)
            record = 0
        else:
            by_usage = {t.usage: t for t in desc.textures}
            slots = np.zeros(4, I32)
            for i, usage in enumerate((comp.TextureUsage.Albedo,
                                       comp.TextureUsage.Normal,
                                       comp.TextureUsage.Roughness,
                                       comp.TextureUsage.Metalness)):
                t = by_usage.get(usage)
                path = (self.resolve_path(t.path)
                        if t is not None and t.path is not None else None)
                if t is not None and t.path is not None and path is None:
                    log.warning("texture not found: %s; using default", t.path)
                slots[i] = (self.pool.get_or_load(path, usage.value) if path
                            else self.pool.default_slot(usage.value))
            flat = np.array([1.0, 1.0, 1.0, 1.0, 0.0, 1.0], F32)
            record = self.pool.get_or_make_record(tuple(slots))
            self._pool_dirty = True
        idx = len(self._materials)
        self._materials.append((slots, flat, record))
        self._material_cache[key] = idx
        return idx

    def _cached_pool(self, key: tuple, build):
        """The device pool of one layout, built on first use; every layout
        is dropped when a textured material changed the host records."""
        if self._pool_dirty:
            self._pool_gpu = {}
            self._pool_dirty = False
        if key not in self._pool_gpu:
            self._pool_gpu[key] = build()
        return self._pool_gpu[key]

    def texture_pool_gpu(self, device, windowed: bool = True,
                         morton: bool = False) -> sampling.TexturePoolGPU:
        """The composite material-record pool (9-channel u8 texels) on
        ``device``, repacked when a textured material changed the host
        records (their count, bucketed by ``record_arrays``, sets its
        shape). ``windowed`` (``cfg.windowed_pool``) packs each row with its
        bilinear neighbourhood; ``morton`` (``cfg.morton_pool``) stores each
        level in Z-curve order."""
        return self._cached_pool(
            (windowed, morton, str(device)),
            lambda: sampling.pack_texture_pool(
                self.pool.record_arrays(), windowed=windowed, u8=True,
                morton=morton, device=device))

    def native_pool_gpu(self, device, windowed: bool = True
                        ) -> sampling.NativeTexturePoolGPU:
        """The native-size record pool (``cfg.native_texture_pool``: each
        record at its sources' own size with its own mip chain) on
        ``device``."""
        return self._cached_pool(
            ("native", windowed, str(device)),
            lambda: sampling.pack_native_pool(
                self.pool.native_record_chains(), windowed=windowed,
                device=device))

    def pool_for(self, cfg: config.RenderConfig, device):
        """The pool matching a RenderConfig's layout flags."""
        if cfg.native_texture_pool:
            return self.native_pool_gpu(device, cfg.windowed_pool)
        return self.texture_pool_gpu(device, cfg.windowed_pool,
                                     cfg.morton_pool)

    def scalar_pool_gpu(self, device) -> sampling.TexturePoolGPU:
        """The per-texture 4-channel f32 pool on ``device`` (the spec
        resolve ``resolve.resolve_gbuffer``, tests and tooling; not on any
        frame path)."""
        return sampling.pack_texture_pool(self.pool.device_arrays(),
                                          device=device)

    def _count_textured_deferred(self, t_inst, t_def, i_mat) -> int:
        """Textured materials referenced by at least one deferred triangle
        (drives cfg.any_textured)."""
        if not t_inst:
            return 0
        inst = np.concatenate([np.asarray(a).ravel() for a in t_inst])
        deff = np.concatenate([np.asarray(a).ravel() for a in t_def]).astype(bool)
        return int(sum(1 for mi in np.unique(inst[deff])
                       if self._materials[int(i_mat[int(mi)])][1][5] > 0.5))

    def pack(self, world: World, device) -> PackResult:
        cfg = self.cfg
        u_rows, u_base = [], {}
        v_src, vi = [], []
        t_vidx, t_inst, t_def, t_fwd, t_shadow = [], [], [], [], []
        i_model, i_nmat, i_oid, i_mat = [], [], [], []
        point_lights, dir_lights = [], []
        vert_off = u_off = 0
        for oid, obj in world.world_objects():
            light = obj.get_light()
            if light is not None:
                point_lights.append((obj.transform.position.copy(),
                                     light.light.color.copy()))
            for c in obj.components:
                if not isinstance(c, comp.RenderableComponent):
                    continue
                mesh = self.load_mesh(c.model_descriptor.mesh_descriptor)
                mat_idx = self.material_index(
                    c.model_descriptor.material_descriptor)
                inst = len(i_model)
                i_model.append(obj.transform.model_matrix())
                i_nmat.append(obj.transform.normal_matrix())
                i_oid.append(oid)
                i_mat.append(mat_idx)
                vcount = mesh.num_vertices
                base = u_base.get(id(mesh))
                if base is None:   # first instance of this mesh: store rows
                    base = u_base[id(mesh)] = u_off
                    u_rows.append(mesh.vertex_rows())
                    u_off += vcount
                v_src.append(np.arange(base, base + vcount, dtype=I32))
                vi.append(np.full(vcount, inst, I32))
                tri = mesh.indices.reshape(-1, 3).astype(I32) + vert_off
                t_vidx.append(tri)
                n_tri = tri.shape[0]
                t_inst.append(np.full(n_tri, inst, I32))
                opts = c.rendering_options
                is_fwd = opts.pass_ == comp.RenderingPass.ForceForwardAfterDeferred
                t_def.append(np.full(n_tri, not is_fwd, bool))
                t_fwd.append(np.full(n_tri, is_fwd, bool))
                t_shadow.append(np.full(n_tri, opts.cast_shadows and not is_fwd,
                                        bool))
                vert_off += vcount
        for _oid, obj in world.omnipresent_objects():
            dl = obj.get_directional_light()
            if dl is not None:
                dir_lights.append((dl.direction.copy(), dl.color.copy()))
        if len(point_lights) > config.MAX_LIGHTS:
            log.warning("dropping %d point lights over MAX_LIGHTS=%d",
                        len(point_lights) - config.MAX_LIGHTS, config.MAX_LIGHTS)
            point_lights = point_lights[:config.MAX_LIGHTS]
        if len(dir_lights) > config.MAX_LIGHTS:
            log.warning("dropping %d directional lights over MAX_LIGHTS=%d",
                        len(dir_lights) - config.MAX_LIGHTS, config.MAX_LIGHTS)
            dir_lights = dir_lights[:config.MAX_LIGHTS]

        n_tris = sum(t.shape[0] for t in t_vidx)
        n_fwd = int(sum(np.count_nonzero(f) for f in t_fwd))
        counts = dict(vertices=vert_off, unique_vertices=u_off,
                      triangles=n_tris, instances=len(i_model),
                      materials=len(self._materials), forward_triangles=n_fwd,
                      point_lights=len(point_lights),
                      directional_lights=len(dir_lights),
                      textures=self.pool.next_slot,
                      textured_materials=self._count_textured_deferred(
                          t_inst, t_def, i_mat))
        if (vert_off > cfg.max_vertices or n_tris > cfg.max_triangles
                or u_off > cfg.max_unique_vertices
                or len(i_model) > cfg.max_instances
                or len(self._materials) > cfg.max_materials
                or n_fwd > cfg.max_forward_triangles):
            raise CapacityError(counts)

        def cat(parts, shape, dtype):
            out = np.zeros(shape, dtype)
            if parts:
                a = np.concatenate([np.asarray(p).reshape(-1, *shape[1:])
                                    for p in parts])
                out[:a.shape[0]] = a
            return out

        Vc, Tc, Ic, Mc = (cfg.max_vertices, cfg.max_triangles,
                          cfg.max_instances, cfg.max_materials)
        Fc = cfg.max_forward_triangles
        h_tri_vidx = cat(t_vidx, (Tc, 3), I32)
        h_tri_inst = cat(t_inst, (Tc,), I32)
        fwd_rows = np.nonzero(cat(t_fwd, (Tc,), bool))[0][:Fc]
        fwd_vidx = np.zeros((Fc, 3), I32)
        fwd_inst = np.zeros((Fc,), I32)
        fwd_mask = np.zeros((Fc,), bool)
        fwd_vidx[:len(fwd_rows)] = h_tri_vidx[fwd_rows]
        fwd_inst[:len(fwd_rows)] = h_tri_inst[fwd_rows]
        fwd_mask[:len(fwd_rows)] = True
        packed = lightslib.pack_lights(point_lights, dir_lights)
        host = {
            "vert_data": cat(u_rows, (cfg.max_unique_vertices, 14), F32),
            "vert_src": cat(v_src, (Vc,), I32),
            "vert_instance": cat(vi, (Vc,), I32),
            "tri_vidx": h_tri_vidx,
            "tri_instance": h_tri_inst,
            "tri_deferred": cat(t_def, (Tc,), bool),
            "tri_shadow": cat(t_shadow, (Tc,), bool),
            "fwd_tri_vidx": fwd_vidx,
            "fwd_tri_instance": fwd_inst,
            "fwd_tri_mask": fwd_mask,
            "inst_model": _cat_mats(i_model, Ic, 4),
            "inst_normal_mat": _cat_mats(i_nmat, Ic, 3),
            "inst_object_id": cat(i_oid, (Ic,), I32),
            "inst_material": cat(i_mat, (Ic,), I32),
            "mat_tex_slots": cat([m[0] for m in self._materials], (Mc, 4), I32),
            "mat_flat": cat([m[1] for m in self._materials], (Mc, 6), F32),
            "mat_record": cat([m[2] for m in self._materials], (Mc,), I32),
            **dataclasses.asdict(packed),
        }
        return PackResult(scene=scene_from_numpy(host, device),
                          lights=lights_from_numpy(host, device),
                          counts=counts)
