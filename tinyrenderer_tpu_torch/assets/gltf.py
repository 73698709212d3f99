"""Minimal glTF 2.0 loader (.gltf / .glb) -> MeshData.

The reference hard-errors on glTF ("Gltf file loading is not yet
implemented", src/resource_loader.rs:254-283); this module completes the
format instead of stubbing it. Scope: static triangle geometry —

- containers: .glb (binary, JSON + BIN chunks) and .gltf (JSON with
  external buffer files or base64 data URIs),
- accessors: all core component types, strided or packed bufferViews,
- attributes: POSITION, NORMAL (generated flat if absent), TEXCOORD_0,
  indexed or non-indexed primitives (modes TRIANGLES / STRIP / FAN),
- the node hierarchy: every mesh instance is baked through its world
  transform (matrix or TRS) and merged into one unified-index mesh, so a
  multi-node asset drops into the scene looking right,
- PBR materials (the reference stubs ALL of glTF,
  src/resource_loader.rs:254-283): ``load_gltf_parts`` groups primitives
  by material and maps each to the engine's PbrMaterialDescriptor —
  baseColorTexture -> Albedo slot, normalTexture -> Normal,
  metallicRoughnessTexture -> Roughness (G channel) + Metalness (B
  channel) extracted to cache files (the texture pool's slot loader takes
  the R channel of a file, matching the reference's single-channel policy
  at src/texture.rs:136-150); texture-less materials become
  Flat(baseColorFactor, roughnessFactor, metallicFactor). Embedded images
  (GLB bufferViews, base64 data URIs) are decoded once into
  ``~/.cache/tinyrenderer_tpu_gltf/``.

Skins/animations are out of scope. Stdlib + numpy (+PIL for embedded
image decode) only.
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import struct
from dataclasses import dataclass

import numpy as np

from .mesh import MeshData, build_mesh

F32 = np.float32
I32 = np.int32

_COMPONENT_DTYPE = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNT = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
               "MAT2": 4, "MAT3": 9, "MAT4": 16}


def _load_container(path: str) -> tuple[dict, list[bytes]]:
    """Parse .glb/.gltf -> (gltf json, buffer byte blobs)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] == b"glTF":
        magic, version, _length = struct.unpack_from("<4sII", data, 0)
        if version != 2:
            raise ValueError(f"unsupported glTF version {version}")
        off, gltf, bin_chunk = 12, None, b""
        while off + 8 <= len(data):
            clen, ctype = struct.unpack_from("<II", data, off)
            chunk = data[off + 8:off + 8 + clen]
            if ctype == 0x4E4F534A:       # 'JSON'
                gltf = json.loads(chunk)
            elif ctype == 0x004E4942:     # 'BIN\0'
                bin_chunk = chunk
            off += 8 + clen + ((-clen) % 4)   # chunks are 4-byte aligned
        if gltf is None:
            raise ValueError("glb missing JSON chunk")
    else:
        gltf = json.loads(data)
        bin_chunk = b""

    base_dir = os.path.dirname(os.path.abspath(path))
    buffers = []
    for buf in gltf.get("buffers", []):
        uri = buf.get("uri")
        if uri is None:
            buffers.append(bin_chunk)
        elif uri.startswith("data:"):
            buffers.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            from urllib.parse import unquote
            with open(os.path.join(base_dir, unquote(uri)), "rb") as f:
                buffers.append(f.read())
    return gltf, buffers


def _read_accessor(gltf: dict, buffers: list[bytes], idx: int) -> np.ndarray:
    acc = gltf["accessors"][idx]
    n = acc["count"]
    comps = _TYPE_COUNT[acc["type"]]
    dtype = _COMPONENT_DTYPE[acc["componentType"]]
    itemsize = np.dtype(dtype).itemsize * comps

    if "bufferView" not in acc:          # zero-filled sparse base
        out = np.zeros((n, comps), dtype)
    else:
        bv = gltf["bufferViews"][acc["bufferView"]]
        buf = buffers[bv["buffer"]]
        start = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
        stride = bv.get("byteStride", 0) or itemsize
        if stride == itemsize:
            out = np.frombuffer(buf, dtype, count=n * comps, offset=start)
            out = out.reshape(n, comps).copy()
        else:                             # interleaved: strided view
            # as_strided performs no bounds checking: validate the accessor
            # extent first or a truncated/malformed buffer reads OOB memory.
            end = start + (n - 1) * stride + itemsize if n > 0 else start
            if end > len(buf):
                raise ValueError(
                    f"accessor {idx} extent {end} exceeds buffer size "
                    f"{len(buf)} (truncated or malformed glTF)")
            raw = np.frombuffer(buf, np.uint8)
            rows = np.lib.stride_tricks.as_strided(
                raw[start:], shape=(n, itemsize), strides=(stride, 1))
            out = rows.copy().view(dtype).reshape(n, comps)

    sparse = acc.get("sparse")
    if sparse:
        si = sparse["indices"]
        sv = sparse["values"]
        ibv = gltf["bufferViews"][si["bufferView"]]
        ioff = ibv.get("byteOffset", 0) + si.get("byteOffset", 0)
        ind = np.frombuffer(buffers[ibv["buffer"]],
                            _COMPONENT_DTYPE[si["componentType"]],
                            count=sparse["count"], offset=ioff)
        vbv = gltf["bufferViews"][sv["bufferView"]]
        voff = vbv.get("byteOffset", 0) + sv.get("byteOffset", 0)
        vals = np.frombuffer(buffers[vbv["buffer"]], dtype,
                             count=sparse["count"] * comps, offset=voff)
        out[ind] = vals.reshape(-1, comps)

    if acc.get("normalized") and dtype != np.float32:
        info = np.iinfo(dtype)
        out = out.astype(F32) / float(info.max)
    return out


def _node_world_transforms(gltf: dict) -> list[np.ndarray]:
    """(4, 4) world matrix per node (column-vector convention)."""
    nodes = gltf.get("nodes", [])
    local = []
    for nd in nodes:
        if "matrix" in nd:
            m = np.array(nd["matrix"], F32).reshape(4, 4).T  # column-major
        else:
            t = np.array(nd.get("translation", [0, 0, 0]), F32)
            qx, qy, qz, qw = nd.get("rotation", [0, 0, 0, 1])
            s = np.array(nd.get("scale", [1, 1, 1]), F32)
            r = np.array([
                [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)],
                [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw)],
                [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx * qx + qy * qy)],
            ], F32)
            m = np.eye(4, dtype=F32)
            m[:3, :3] = r * s[None, :]
            m[:3, 3] = t
        local.append(m)

    world = [None] * len(nodes)

    def walk(i: int, parent: np.ndarray) -> None:
        world[i] = parent @ local[i]
        for c in nodes[i].get("children", []):
            walk(c, world[i])

    scene = gltf.get("scenes", [{}])[gltf.get("scene", 0)]
    for root in scene.get("nodes", range(len(nodes))):
        walk(root, np.eye(4, dtype=F32))
    for i in range(len(nodes)):          # nodes outside the scene graph
        if world[i] is None:
            world[i] = local[i]
    return world


def _triangulate(indices: np.ndarray, mode: int) -> np.ndarray:
    if mode == 4:                         # TRIANGLES
        return indices[: len(indices) - len(indices) % 3]
    if mode == 5:                         # TRIANGLE_STRIP
        tris = []
        for k in range(len(indices) - 2):
            a, b, c = indices[k], indices[k + 1], indices[k + 2]
            tris.extend((a, c, b) if k % 2 else (a, b, c))
        return np.array(tris, indices.dtype)
    if mode == 6:                         # TRIANGLE_FAN
        tris = []
        for k in range(1, len(indices) - 1):
            tris.extend((indices[0], indices[k], indices[k + 1]))
        return np.array(tris, indices.dtype)
    raise ValueError(f"unsupported primitive mode {mode} (points/lines)")


def _load_primitives(path: str):
    """Parse the asset into per-primitive arrays, node transforms baked.

    Returns (gltf json, buffers, [(material_idx | None, pos, uv, nrm,
    idx)])."""
    gltf, buffers = _load_container(path)
    world = _node_world_transforms(gltf)

    prims = []
    instances = []
    for ni, nd in enumerate(gltf.get("nodes", [])):
        if "mesh" in nd:
            instances.append((nd["mesh"], world[ni]))
    if not instances:                     # meshes with no node reference
        instances = [(i, np.eye(4, dtype=F32))
                     for i in range(len(gltf.get("meshes", [])))]

    for mesh_i, m in instances:
        mesh = gltf["meshes"][mesh_i]
        for prim in mesh.get("primitives", []):
            mode = prim.get("mode", 4)
            if mode < 4:
                continue                  # points/lines: not renderable here
            attrs = prim["attributes"]
            pos = _read_accessor(gltf, buffers, attrs["POSITION"]).astype(F32)
            n = pos.shape[0]
            uv = (_read_accessor(gltf, buffers, attrs["TEXCOORD_0"])
                  .astype(F32)[:, :2] if "TEXCOORD_0" in attrs
                  else np.zeros((n, 2), F32))
            if "indices" in prim:
                idx = _read_accessor(gltf, buffers, prim["indices"])
                idx = idx.reshape(-1).astype(np.int64)
            else:
                idx = np.arange(n, dtype=np.int64)
            idx = _triangulate(idx, mode).astype(np.int64)

            # bake the node transform (normals via inverse-transpose)
            ph = np.concatenate([pos, np.ones((n, 1), F32)], axis=1)
            pos_w = (ph @ m.T)[:, :3]
            nrm_mat = np.linalg.inv(m[:3, :3]).T if abs(
                np.linalg.det(m[:3, :3])) > 1e-12 else m[:3, :3]
            if "NORMAL" in attrs:
                nrm = _read_accessor(gltf, buffers,
                                     attrs["NORMAL"]).astype(F32)[:, :3]
                nrm_w = nrm @ nrm_mat.T
            else:                         # flat normals from the faces
                nrm_w = np.zeros((n, 3), F32)
                tri = idx.reshape(-1, 3)
                fn = np.cross(pos_w[tri[:, 1]] - pos_w[tri[:, 0]],
                              pos_w[tri[:, 2]] - pos_w[tri[:, 0]])
                for c in range(3):
                    np.add.at(nrm_w, tri[:, c], fn)
            lens = np.linalg.norm(nrm_w, axis=1, keepdims=True)
            nrm_w = nrm_w / np.maximum(lens, 1e-12)

            prims.append((prim.get("material"), pos_w.astype(F32), uv,
                          nrm_w.astype(F32), idx))
    return gltf, buffers, prims


def _merge_prims(path: str, prims) -> MeshData:
    positions, tex_coords, normals, indices = [], [], [], []
    vert_off = 0
    for _mat, pos, uv, nrm, idx in prims:
        positions.append(pos)
        tex_coords.append(uv)
        normals.append(nrm)
        indices.append(idx + vert_off)
        vert_off += pos.shape[0]
    if not positions:
        raise ValueError(f"{path}: no triangle geometry found")
    return build_mesh(np.concatenate(positions),
                      np.concatenate(tex_coords),
                      np.concatenate(normals),
                      np.concatenate(indices).astype(I32))


def load_gltf(path: str) -> MeshData:
    """Load triangle geometry into one MeshData.

    ``path`` may carry a ``#part<k>`` fragment selecting the k-th
    material group of ``load_gltf_parts`` (how multi-material assets are
    addressed by per-part MeshDescriptors)."""
    base, part = split_part_fragment(path)
    if part is not None:
        parts = load_gltf_parts(base)
        if not 0 <= part < len(parts):
            raise ValueError(f"{base}: part {part} out of range "
                             f"({len(parts)} parts)")
        return parts[part].mesh
    _gltf, _buffers, prims = _load_primitives(base)
    return _merge_prims(base, prims)


def split_part_fragment(path: str) -> tuple:
    """'model.glb#part2' -> ('model.glb', 2); no fragment -> (path, None)."""
    if "#part" in path:
        base, frag = path.rsplit("#part", 1)
        try:
            return base, int(frag)
        except ValueError:
            pass
    return path, None


# -- materials (baseColorTexture and friends -> PbrMaterialDescriptor) ------

_CACHE_DIR = os.path.join(os.path.expanduser("~"), ".cache",
                          "tinyrenderer_tpu_gltf")


@dataclass(frozen=True)
class GltfPart:
    """One material group of an asset: merged geometry + its material."""

    mesh: MeshData
    material: object        # scene.components.PbrMaterialDescriptor


def _image_bytes(gltf: dict, buffers, img: dict, base_dir: str):
    """Raw encoded bytes of a glTF image entry (or a direct file path)."""
    uri = img.get("uri")
    if uri is not None and not uri.startswith("data:"):
        from urllib.parse import unquote
        return None, os.path.join(base_dir, unquote(uri))
    if uri is not None:                   # base64 data URI
        return base64.b64decode(uri.split(",", 1)[1]), None
    bv = gltf["bufferViews"][img["bufferView"]]
    start = bv.get("byteOffset", 0)
    return buffers[bv["buffer"]][start:start + bv["byteLength"]], None


def _texture_file(gltf: dict, buffers, tex_index: int, base_dir: str,
                  asset_key: str, channel: int | None = None):
    """Materialize texture ``tex_index`` as an image file path.

    External non-data-URI images are referenced in place; embedded ones
    (and any needing channel extraction — the engine's pool reads the R
    channel of single-channel usages) are decoded to the glTF cache dir.
    Returns None when the texture can't be realized (caller falls back to
    the default slot)."""
    try:
        src = gltf["textures"][tex_index].get("source")
        if src is None:
            return None
        raw, direct = _image_bytes(gltf, buffers, gltf["images"][src],
                                   base_dir)
        if direct is not None and channel is None:
            return direct if os.path.exists(direct) else None

        import io

        from PIL import Image
        if raw is None:
            with open(direct, "rb") as f:
                raw = f.read()
        key = hashlib.sha1(
            f"{asset_key}:{tex_index}:{channel}".encode()
            + raw[:64] + str(len(raw)).encode()).hexdigest()[:20]
        out_path = os.path.join(_CACHE_DIR, f"{key}.png")
        if not os.path.exists(out_path):
            os.makedirs(_CACHE_DIR, exist_ok=True)
            im = np.asarray(Image.open(io.BytesIO(raw)).convert("RGBA"))
            if channel is not None:       # e.g. metallicRoughness G / B
                im = np.repeat(im[..., channel:channel + 1], 3, axis=-1)
            Image.fromarray(im[..., :3], "RGB").save(out_path)
        return out_path
    except Exception:                     # malformed image -> default slot
        return None


def _material_descriptor(gltf: dict, buffers, mat_idx, base_dir: str,
                         asset_key: str):
    """Map a glTF material to the engine's PbrMaterialDescriptor.

    Textured materials become Texture([...]) with Albedo / Normal /
    Roughness / Metalness slots (missing ones fall back to engine
    defaults); texture-less ones become Flat(baseColorFactor,
    roughnessFactor, metallicFactor)."""
    from ..scene import components as comp

    if mat_idx is None:
        return comp.PbrMaterialDescriptor(flat=comp.PbrParameters(
            albedo=np.array([1.0, 1.0, 1.0], F32), roughness=1.0,
            metalness=0.0))
    mat = gltf.get("materials", [])[mat_idx]
    pbr = mat.get("pbrMetallicRoughness", {})

    sources = []

    def add(usage, tex_info, channel=None):
        if tex_info is None:
            return
        p = _texture_file(gltf, buffers, tex_info["index"], base_dir,
                          asset_key, channel)
        if p is not None:
            sources.append(comp.TextureSourceDescriptor(usage=usage, path=p))

    add(comp.TextureUsage.Albedo, pbr.get("baseColorTexture"))
    add(comp.TextureUsage.Normal, mat.get("normalTexture"))
    # glTF packs roughness in G and metalness in B of one texture; the
    # pool's single-channel loads take R, so each channel is extracted
    # to its own cached grayscale image
    add(comp.TextureUsage.Roughness, pbr.get("metallicRoughnessTexture"),
        channel=1)
    add(comp.TextureUsage.Metalness, pbr.get("metallicRoughnessTexture"),
        channel=2)

    if not sources:
        base = pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0])
        return comp.PbrMaterialDescriptor(flat=comp.PbrParameters(
            albedo=np.array(base[:3], F32),
            roughness=float(pbr.get("roughnessFactor", 1.0)),
            metalness=float(pbr.get("metallicFactor", 1.0))))
    return comp.PbrMaterialDescriptor(textures=tuple(sources))


def load_gltf_parts(path: str) -> list:
    """Load an asset as material groups: [GltfPart(mesh, material)].

    Primitives sharing a material index merge into one part (stable by
    first appearance); the part order is the ``#part<k>`` addressing
    contract used by MeshDescriptor paths."""
    gltf, buffers, prims = _load_primitives(path)
    if not prims:
        raise ValueError(f"{path}: no triangle geometry found")
    base_dir = os.path.dirname(os.path.abspath(path))
    asset_key = os.path.abspath(path)

    order = []
    groups = {}
    for p in prims:
        if p[0] not in groups:
            groups[p[0]] = []
            order.append(p[0])
        groups[p[0]].append(p)

    parts = []
    for mat_idx in order:
        mesh = _merge_prims(path, groups[mat_idx])
        material = _material_descriptor(gltf, buffers, mat_idx, base_dir,
                                        asset_key)
        parts.append(GltfPart(mesh=mesh, material=material))
    return parts
