"""Mesh data: OBJ loading, tangent generation, and procedural primitives.

Equivalent surface to src/resource_loader.rs:316-353 (OBJ via tobj with
GPU_LOAD_OPTIONS: triangulated, one unified index per unique
position/uv/normal triple, sub-models merged with index offsetting) and
src/model.rs:418-520 (per-triangle tangent/bitangent accumulation + per-
vertex averaging, learnopengl method). The vertex layout matches
VertexRawWithTangents (src/vertex.rs:34-65): position, tex_coord, normal,
tangent, bitangent.

A C++ fast path (native/) parses OBJ and computes tangents for large
meshes; this module transparently falls back to the numpy implementation.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

F32 = np.float32
I32 = np.int32


@dataclass
class MeshData:
    """Unified-index triangle mesh with tangent frames."""

    positions: np.ndarray   # (V, 3) f32
    tex_coords: np.ndarray  # (V, 2) f32
    normals: np.ndarray     # (V, 3) f32
    tangents: np.ndarray    # (V, 3) f32
    bitangents: np.ndarray  # (V, 3) f32
    indices: np.ndarray     # (3T,) i32

    @property
    def num_vertices(self) -> int:
        return self.positions.shape[0]

    @property
    def num_triangles(self) -> int:
        return self.indices.shape[0] // 3

    def vertex_rows(self) -> np.ndarray:
        """(V, 14) packed rows: pos(3) uv(2) normal(3) tangent(3) bitangent(3)."""
        return np.concatenate([
            self.positions, self.tex_coords, self.normals,
            self.tangents, self.bitangents], axis=1).astype(F32)


def compute_tangents(positions: np.ndarray, tex_coords: np.ndarray,
                     indices: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-vertex tangent/bitangent: per-triangle solve, accumulate, average
    by the number of incident triangles (src/model.rs:442-499).
    """
    v = positions.astype(np.float64)
    uv = tex_coords.astype(np.float64)
    tri = indices.reshape(-1, 3)

    p0, p1, p2 = v[tri[:, 0]], v[tri[:, 1]], v[tri[:, 2]]
    t0, t1, t2 = uv[tri[:, 0]], uv[tri[:, 1]], uv[tri[:, 2]]
    e1, e2 = p1 - p0, p2 - p0
    d1, d2 = t1 - t0, t2 - t0

    det = d1[:, 0] * d2[:, 1] - d2[:, 0] * d1[:, 1]
    # Degenerate UVs: the reference divides by zero and propagates inf/nan;
    # we guard with a tiny epsilon instead.
    r = 1.0 / np.where(np.abs(det) < 1e-20, 1e-20, det)
    tangent = (e1 * d2[:, 1:2] - e2 * d1[:, 1:2]) * r[:, None]
    bitangent = (e2 * d1[:, 0:1] - e1 * d2[:, 0:1]) * -r[:, None]

    tan_acc = np.zeros_like(v)
    bit_acc = np.zeros_like(v)
    counts = np.zeros(v.shape[0], np.float64)
    for corner in range(3):
        np.add.at(tan_acc, tri[:, corner], tangent)
        np.add.at(bit_acc, tri[:, corner], bitangent)
        np.add.at(counts, tri[:, corner], 1.0)
    counts = np.maximum(counts, 1.0)
    return ((tan_acc / counts[:, None]).astype(F32),
            (bit_acc / counts[:, None]).astype(F32))


def build_mesh(positions, tex_coords, normals, indices) -> MeshData:
    positions = np.asarray(positions, F32).reshape(-1, 3)
    tex_coords = np.asarray(tex_coords, F32).reshape(-1, 2)
    normals = np.asarray(normals, F32).reshape(-1, 3)
    indices = np.asarray(indices, I32).ravel()
    # native C++ fast path (native/asset_loader.cpp), numpy fallback
    from . import native
    tb = native.compute_tangents(positions, tex_coords, indices)
    if tb is None:
        tb = compute_tangents(positions, tex_coords, indices)
    tangents, bitangents = tb
    return MeshData(positions, tex_coords, normals, tangents, bitangents, indices)


# ---------------------------------------------------------------------------
# OBJ parsing
# ---------------------------------------------------------------------------

def load_obj(path: str) -> MeshData:
    """Parse a Wavefront OBJ into a unified-index MeshData.

    Semantics follow tobj's GPU_LOAD_OPTIONS as used by the reference:
    faces are fan-triangulated, each unique (pos, uv, normal) triple becomes
    one vertex, objects/groups are merged into a single mesh. Missing uv or
    normal indices are filled with zeros.
    """
    try:
        from . import native  # optional C++ fast path
        parsed = native.parse_obj(path)
        if parsed is not None:
            positions, tex_coords, normals, indices = parsed
            return build_mesh(positions, tex_coords, normals, indices)
    except ImportError:
        pass
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        return parse_obj_text(f.read())


def parse_obj_text(text: str) -> MeshData:
    raw_pos: list = []
    raw_uv: list = []
    raw_norm: list = []
    vert_map: dict = {}
    positions: list = []
    tex_coords: list = []
    normals: list = []
    indices: list = []

    def vertex_for(token: str) -> int:
        # keyed by the resolved index triple, as the native loader keys it:
        # "1/1/1" and "01/1/1" (or a relative index) name one vertex
        parts = token.split("/")
        pi = int(parts[0])
        pi = pi - 1 if pi > 0 else len(raw_pos) + pi
        ti = ni = None
        if len(parts) > 1 and parts[1]:
            t = int(parts[1])
            ti = t - 1 if t > 0 else len(raw_uv) + t
        if len(parts) > 2 and parts[2]:
            n = int(parts[2])
            ni = n - 1 if n > 0 else len(raw_norm) + n
        key = (pi, ti, ni)
        got = vert_map.get(key)
        if got is not None:
            return got
        idx = len(positions)
        positions.append(raw_pos[pi])
        tex_coords.append(raw_uv[ti] if ti is not None else (0.0, 0.0))
        normals.append(raw_norm[ni] if ni is not None else (0.0, 0.0, 0.0))
        vert_map[key] = idx
        return idx

    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        tag = parts[0]
        if tag == "v":
            raw_pos.append((float(parts[1]), float(parts[2]), float(parts[3])))
        elif tag == "vt":
            raw_uv.append((float(parts[1]), float(parts[2]) if len(parts) > 2 else 0.0))
        elif tag == "vn":
            raw_norm.append((float(parts[1]), float(parts[2]), float(parts[3])))
        elif tag == "f":
            corner_ids = [vertex_for(t) for t in parts[1:]]
            for k in range(1, len(corner_ids) - 1):  # fan triangulation
                indices.extend((corner_ids[0], corner_ids[k], corner_ids[k + 1]))

    return build_mesh(positions, tex_coords, normals, indices)


# ---------------------------------------------------------------------------
# Procedural primitives (replacing assets/models/cube/cube.obj and
# src/primitive_shapes.rs without shipping binary assets)
# ---------------------------------------------------------------------------

def square() -> MeshData:
    """Unit square in the XZ plane — same geometry as
    src/primitive_shapes.rs:5-38 (including its degenerate tangent frame,
    which we replace with a correct one derived from the UVs)."""
    positions = [(-0.5, 0.0, -0.5), (-0.5, 0.0, 0.5), (0.5, 0.0, -0.5), (0.5, 0.0, 0.5)]
    tex_coords = [(0.0, 0.0), (0.0, 1.0), (1.0, 0.0), (1.0, 1.0)]
    normals = [(0.0, 1.0, 0.0)] * 4
    indices = [3, 2, 1, 2, 0, 1]
    return build_mesh(positions, tex_coords, normals, indices)


def cube() -> MeshData:
    """Axis-aligned cube spanning [-1, 1]^3 with per-face UVs and normals
    (the reference loads an equivalent blender cube from
    assets/models/cube/cube.obj)."""
    faces = [
        # (normal, corner order) — CCW when viewed from outside
        ((0.0, 0.0, 1.0), [(-1, -1, 1), (1, -1, 1), (1, 1, 1), (-1, 1, 1)]),
        ((0.0, 0.0, -1.0), [(1, -1, -1), (-1, -1, -1), (-1, 1, -1), (1, 1, -1)]),
        ((1.0, 0.0, 0.0), [(1, -1, 1), (1, -1, -1), (1, 1, -1), (1, 1, 1)]),
        ((-1.0, 0.0, 0.0), [(-1, -1, -1), (-1, -1, 1), (-1, 1, 1), (-1, 1, -1)]),
        ((0.0, 1.0, 0.0), [(-1, 1, 1), (1, 1, 1), (1, 1, -1), (-1, 1, -1)]),
        ((0.0, -1.0, 0.0), [(-1, -1, -1), (1, -1, -1), (1, -1, 1), (-1, -1, 1)]),
    ]
    uvs = [(0.0, 1.0), (1.0, 1.0), (1.0, 0.0), (0.0, 0.0)]
    positions, tex_coords, normals, indices = [], [], [], []
    for n, corners in faces:
        base = len(positions)
        for c, uv in zip(corners, uvs):
            positions.append(tuple(float(x) for x in c))
            tex_coords.append(uv)
            normals.append(n)
        indices.extend([base, base + 1, base + 2, base, base + 2, base + 3])
    return build_mesh(positions, tex_coords, normals, indices)


def uv_sphere(stacks: int = 16, slices: int = 24) -> MeshData:
    """Unit UV sphere — an extension primitive (the reference ships only
    cube/square) used by the high-poly stress scenes."""
    positions, tex_coords, normals, indices = [], [], [], []
    for i in range(stacks + 1):
        theta = math.pi * i / stacks
        for j in range(slices + 1):
            phi = 2.0 * math.pi * j / slices
            n = (math.sin(theta) * math.cos(phi), math.cos(theta),
                 math.sin(theta) * math.sin(phi))
            positions.append(n)
            normals.append(n)
            tex_coords.append((j / slices, i / stacks))
    for i in range(stacks):
        for j in range(slices):
            a = i * (slices + 1) + j
            b = a + slices + 1
            if i > 0:
                indices.extend((a, b, a + 1))
            if i < stacks - 1:
                indices.extend((a + 1, b, b + 1))
    return build_mesh(positions, tex_coords, normals, indices)


def arrow(shaft_radius: float = 0.03, head_radius: float = 0.09,
          shaft_length: float = 0.75, total_length: float = 1.0,
          segments: int = 12) -> MeshData:
    """Procedural +Y arrow (shaft cylinder + cone head) for the translation
    gizmo — replaces assets/models/arrow/arrow.obj."""
    positions, tex_coords, normals, indices = [], [], [], []

    def ring(y: float, radius: float):
        ids = []
        for s in range(segments):
            a = 2.0 * math.pi * s / segments
            ids.append(len(positions))
            positions.append((radius * math.cos(a), y, radius * math.sin(a)))
            tex_coords.append((s / segments, y / total_length))
            normals.append((math.cos(a), 0.0, math.sin(a)))
        return ids

    r0 = ring(0.0, shaft_radius)
    r1 = ring(shaft_length, shaft_radius)
    for s in range(segments):
        a, b = r0[s], r0[(s + 1) % segments]
        c, d = r1[s], r1[(s + 1) % segments]
        indices.extend([a, c, b, b, c, d])

    r2 = ring(shaft_length, head_radius)
    tip = len(positions)
    positions.append((0.0, total_length, 0.0))
    tex_coords.append((0.5, 1.0))
    normals.append((0.0, 1.0, 0.0))
    for s in range(segments):
        a, b = r2[s], r2[(s + 1) % segments]
        indices.extend([a, tip, b])
    # cone base cap + shaft base cap
    base_center = len(positions)
    positions.append((0.0, 0.0, 0.0))
    tex_coords.append((0.5, 0.0))
    normals.append((0.0, -1.0, 0.0))
    for s in range(segments):
        a, b = r0[s], r0[(s + 1) % segments]
        indices.extend([a, b, base_center])

    return build_mesh(positions, tex_coords, normals, indices)


_PRIMITIVE_CACHE: dict[str, MeshData] = {}


def get_primitive(name: str) -> MeshData:
    """Primitive cache (src/resource_loader.rs:75-85)."""
    key = name.lower()
    if key not in _PRIMITIVE_CACHE:
        if key == "cube":
            _PRIMITIVE_CACHE[key] = cube()
        elif key == "square":
            _PRIMITIVE_CACHE[key] = square()
        elif key == "arrow":
            _PRIMITIVE_CACHE[key] = arrow()
        elif key == "sphere":
            _PRIMITIVE_CACHE[key] = uv_sphere()
        else:
            raise KeyError(f"unknown primitive: {name}")
    return _PRIMITIVE_CACHE[key]
