"""The scene as the plain reference sees it: a description made by the
benchmark (a parsed ``.lvl`` file or a seeded recipe), its meshes (the two
primitives and OBJ files of the repository), the camera and light
matrices.

A scene is a dict of plain values:

- ``objects``: one dict an object that draws, in id order: ``oid``,
  ``mesh`` (``"cube"``, ``"square"`` or the path of an ``.obj`` file
  relative to the repository's root, read by :func:`read_obj`),
  ``position``, ``rotation`` (a quaternion x, y, z, w), ``scale``,
  ``material`` (``albedo``, ``roughness``, ``metalness``) or None for the
  light's billboard, and ``forward`` (the overlay pass, drawn on top) and
  ``cast_shadows``;
- ``point_lights`` (``position``, ``color``) and ``directional_lights``
  (``direction``, ``color``), in id order;
- ``camera``: ``position``, ``forward`` (a unit vector), ``up``,
  ``fov_y`` (fed to the projection as radians, as the upstream engine
  does with the level file's 45.0), ``znear``, ``zfar``.

The engine's conventions it follows: a point light object with no
renderable draws a 1x1 billboard square at its transform in the overlay
pass; a primitive cube spans [-1, 1]^3; the directional shadow box is
-50..100 on both axes, near 0.1, far 250, its eye 30 units up the light;
point lights render six 90-degree faces, near 0.1, far 100; every
projection is reverse-Z.
"""

from __future__ import annotations

import functools
import json
import math
import os

import numpy as np

F32 = np.float32
# the repository's root: an OBJ mesh's path is relative to it, as the
# engine's asset search path is
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# the light billboard's colour: the engine's default albedo texture (its
# light-bulb image is not shipped), opaque and unlit
BILLBOARD_RGB = (254.0 / 255.0, 245.0 / 255.0, 71.0 / 255.0)

POINT_NEAR, POINT_FAR = 0.1, 100.0
DIR_NEAR, DIR_FAR, DIR_BOX, DIR_EYE = 0.1, 250.0, 100.0, 30.0
CUBE_FACES = (((1.0, 0.0, 0.0), (0.0, 1.0, 0.0)),
              ((-1.0, 0.0, 0.0), (0.0, 1.0, 0.0)),
              ((0.0, 1.0, 0.0), (0.0, 0.0, -1.0)),
              ((0.0, -1.0, 0.0), (0.0, 0.0, 1.0)),
              ((0.0, 0.0, 1.0), (0.0, 1.0, 0.0)),
              ((0.0, 0.0, -1.0), (0.0, 1.0, 0.0)))


# ---- meshes: (positions (V, 3), normals (V, 3), triangles (T, 3)) ----------

def cube_mesh():
    faces = [((0, 0, 1), [(-1, -1, 1), (1, -1, 1), (1, 1, 1), (-1, 1, 1)]),
             ((0, 0, -1), [(1, -1, -1), (-1, -1, -1), (-1, 1, -1), (1, 1, -1)]),
             ((1, 0, 0), [(1, -1, 1), (1, -1, -1), (1, 1, -1), (1, 1, 1)]),
             ((-1, 0, 0), [(-1, -1, -1), (-1, -1, 1), (-1, 1, 1), (-1, 1, -1)]),
             ((0, 1, 0), [(-1, 1, 1), (1, 1, 1), (1, 1, -1), (-1, 1, -1)]),
             ((0, -1, 0), [(-1, -1, -1), (1, -1, -1), (1, -1, 1), (-1, -1, 1)])]
    pos, nrm, tri = [], [], []
    for n, corners in faces:
        b = len(pos)
        pos += corners
        nrm += [n] * 4
        tri += [(b, b + 1, b + 2), (b, b + 2, b + 3)]
    return (np.array(pos, F32), np.array(nrm, F32), np.array(tri, np.int64))


def square_mesh():
    pos = [(-0.5, 0.0, -0.5), (-0.5, 0.0, 0.5), (0.5, 0.0, -0.5), (0.5, 0.0, 0.5)]
    return (np.array(pos, F32), np.array([(0.0, 1.0, 0.0)] * 4, F32),
            np.array([(3, 2, 1), (2, 0, 1)], np.int64))


MESHES = {"cube": cube_mesh, "square": square_mesh}


# The engine's OBJ loader, as upstream's (tobj with GPU_LOAD_OPTIONS,
# src/resource_loader.rs:316-353) and the port's native one: faces
# fan-triangulated in file order, groups and objects merged into one mesh,
# one vertex a distinct (v, vt, vn) index triple in first-use order,
# negative indices counted back from the last element read, a missing
# normal zero. The triangle order matters: equal depth goes to the larger
# triangle index. Two tokens naming one triple (-1 and the last index)
# share a vertex here and in the native loader, not in the port's Python
# fallback, which keys by the token's text: the vertex numbering differs,
# no triangle's corners.
@functools.lru_cache(maxsize=None)
def read_obj(path: str):
    """(positions (V, 3), normals (V, 3), triangles (T, 3)) of an OBJ file,
    read once a path; the arrays are read-only."""
    counts = {"v": 0, "vt": 0, "vn": 0}
    raw_pos, raw_nrm = [], []
    index, pos, nrm, tri = {}, [], [], []

    def resolve(token: str, kind: str):
        if not token:
            return None
        i = int(token)
        return i - 1 if i > 0 else counts[kind] + i

    def vertex(token: str) -> int:
        parts = token.split("/") + ["", ""]
        key = (resolve(parts[0], "v"), resolve(parts[1], "vt"),
               resolve(parts[2], "vn"))
        if key not in index:
            index[key] = len(pos)
            pos.append(raw_pos[key[0]])
            nrm.append((0.0, 0.0, 0.0) if key[2] is None else raw_nrm[key[2]])
        return index[key]

    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag in counts:
                counts[tag] += 1
                if tag == "v":
                    raw_pos.append(tuple(float(x) for x in parts[1:4]))
                elif tag == "vn":
                    raw_nrm.append(tuple(float(x) for x in parts[1:4]))
            elif tag == "f":
                corners = [vertex(t) for t in parts[1:]]
                tri += [(corners[0], corners[k], corners[k + 1])
                        for k in range(1, len(corners) - 1)]
    out = (np.array(pos, F32).reshape(-1, 3), np.array(nrm, F32).reshape(-1, 3),
           np.array(tri, np.int64).reshape(-1, 3))
    for a in out:
        a.flags.writeable = False
    return out


def mesh(name: str):
    """An object's mesh by its ``mesh``: a primitive's, else the OBJ file
    at that path under :data:`ROOT`."""
    if name in MESHES:
        return MESHES[name]()
    return read_obj(os.path.join(ROOT, name))


# ---- matrices (float64, row-major, M @ v) ----------------------------------

def _unit(v):
    v = np.asarray(v, np.float64)
    n = np.linalg.norm(v)
    return v / n if n > 0 else v


def look_at(eye, center, up) -> np.ndarray:
    eye = np.asarray(eye, np.float64)
    f = _unit(np.asarray(center, np.float64) - eye)
    s = _unit(np.cross(f, up))
    u = np.cross(s, f)
    m = np.eye(4)
    m[0, :3], m[1, :3], m[2, :3] = s, u, -f
    m[0, 3], m[1, 3], m[2, 3] = -s @ eye, -u @ eye, f @ eye
    return m


def reverse_z() -> np.ndarray:
    m = np.eye(4)
    m[2, 2], m[2, 3] = -1.0, 1.0
    return m


def perspective(fov_y: float, aspect: float, near: float, far: float):
    h = math.cos(0.5 * fov_y) / math.sin(0.5 * fov_y)
    r = far / (near - far)
    m = np.zeros((4, 4))
    m[0, 0], m[1, 1], m[2, 2], m[2, 3], m[3, 2] = h / aspect, h, r, r * near, -1.0
    return m


def orthographic(left, right, bottom, top, near, far) -> np.ndarray:
    m = np.eye(4)
    m[0, 0], m[1, 1] = 2.0 / (right - left), 2.0 / (top - bottom)
    m[2, 2] = 1.0 / (near - far)
    m[0, 3] = -(left + right) / (right - left)
    m[1, 3] = -(top + bottom) / (top - bottom)
    m[2, 3] = near / (near - far)
    return m


def model_matrix(position, rotation, scale) -> np.ndarray:
    x, y, z, w = (float(v) for v in rotation)
    r = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                  [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                  [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
    m = np.eye(4)
    m[:3, :3] = r * np.asarray(scale, np.float64)[None, :]
    m[:3, 3] = position
    return m


def camera_matrices(cam: dict, width: int, height: int):
    """(view, proj) of a camera dict, float64."""
    eye = np.asarray(cam["position"], np.float64)
    view = look_at(eye, eye + np.asarray(cam["forward"], np.float64),
                   cam.get("up", (0.0, 1.0, 0.0)))
    proj = reverse_z() @ perspective(cam["fov_y"], width / height,
                                     cam["znear"], cam["zfar"])
    return view, proj


def forward_of_orientation(o) -> list:
    """The unit forward of an upstream camera orientation (z, y, x euler):
    Ry(o[0]) Rz(o[2]) applied to +x."""
    a, c = float(o[0]), float(o[2])
    return [math.cos(c) * math.cos(a), math.sin(c), -math.cos(c) * math.sin(a)]


def point_light_viewprojs(position) -> np.ndarray:
    proj = reverse_z() @ perspective(math.pi / 2.0, 1.0, POINT_NEAR, POINT_FAR)
    p = np.asarray(position, np.float64)
    return np.stack([proj @ look_at(p, p + np.asarray(d), up)
                     for d, up in CUBE_FACES])


def directional_light_viewproj(direction) -> np.ndarray:
    d = _unit(direction)
    right = np.cross(d, (1.0, 0.0, 0.0))
    if np.linalg.norm(right) < 1e-6:
        right = np.cross(d, (0.0, 0.0, 1.0))
    up = np.cross(right, d)
    view = look_at(DIR_EYE * -d, np.zeros(3), up)
    h = DIR_BOX / 2.0
    proj = orthographic(-h, DIR_BOX, -h, DIR_BOX, DIR_NEAR, DIR_FAR)
    return reverse_z() @ proj @ view


# ---- scene descriptions -----------------------------------------------------

def _billboard(oid: int, transform: dict) -> dict:
    return dict(oid=oid, mesh="square", position=transform["position"],
                rotation=transform["rotation"], scale=transform["scale"],
                material=None, forward=True, cast_shadows=False)


def _level_mesh(oid: int, desc: dict, flat) -> str:
    """An object's ``mesh`` from its level descriptor: a Cube or Square
    primitive, or a ``FromFile`` OBJ path, each with a ``Flat`` material."""
    prim, path = desc.get("PrimitiveInCode"), desc.get("FromFile")
    if flat is not None:
        if prim in ("Cube", "Square"):
            return prim.lower()
        if isinstance(path, str) and path.lower().endswith(".obj"):
            return path
    raise ValueError(f"object {oid}: the reference draws flat primitives "
                     f"and flat OBJ meshes only")


def level_scene(path: str) -> dict:
    """The scene of an upstream ``.lvl`` file: world objects take ids 1, 2,
    ... in file order, then the omnipresent objects."""
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    objects, points, dirs = [], [], []
    oid = 0
    for od in data.get("world_objects", []):
        oid += 1
        t = od.get("transform", {})
        t = dict(position=t.get("position", [0.0, 0.0, 0.0]),
                 rotation=t.get("rotation", [0.0, 0.0, 0.0, 1.0]),
                 scale=t.get("scale", [1.0, 1.0, 1.0]))
        renderable = False
        for c in od["components"]:
            if "LightObject" in c:
                points.append(dict(position=t["position"],
                                   color=c["LightObject"]["light"]["color"]))
            if "Renderable" in c:
                renderable = True
                r = c["Renderable"]
                md = r["model_descriptor"]
                flat = md["material_descriptor"].get("Flat")
                opts = r.get("rendering_options", {})
                fwd = opts.get("pass") == "ForceForwardAfterDeferred"
                objects.append(dict(
                    oid=oid, mesh=_level_mesh(oid, md["mesh_descriptor"], flat),
                    **t,
                    material=dict(albedo=flat["albedo"],
                                  roughness=flat["roughness"],
                                  metalness=flat["metalness"]),
                    forward=fwd,
                    cast_shadows=opts.get("cast_shadows", True) and not fwd))
        if not renderable and any("LightObject" in c for c in od["components"]):
            objects.append(_billboard(oid, t))
    for od in data.get("omnipresent_objects", []):
        oid += 1
        for c in od["components"]:
            if "DirectionalLight" in c:
                dirs.append(dict(direction=c["DirectionalLight"]["direction"],
                                 color=c["DirectionalLight"]["color"]))
    cam = data["camera"]
    camera = dict(position=cam["position"],
                  forward=forward_of_orientation(cam["orientation"]),
                  up=cam["up"], fov_y=cam["fov_y"], znear=cam["znear"],
                  zfar=cam["zfar"])
    return dict(objects=objects, point_lights=points, directional_lights=dirs,
                camera=camera)


def grid_scene(n_cubes: int, seed: int) -> dict:
    """A ground slab, ``n_cubes`` flat cubes on a jittered grid, a point
    light over the middle and a directional light, every number drawn as
    the engine's demo world draws it (``scene/demo.py`` of
    tinyrenderer_tpu_torch at ea2b515: BASELINE config 5 is 500 cubes of
    seed 11). The camera is the demo's: at (-12, 10, 0), looking at the
    origin."""
    rng = np.random.default_rng(seed)
    ident = [0.0, 0.0, 0.0, 1.0]
    objects = [dict(oid=1, mesh="cube", position=[0.0, -2.0, 0.0],
                    rotation=ident, scale=[20.0, 0.5, 20.0],
                    material=dict(albedo=[0.45, 0.45, 0.5], roughness=0.9,
                                  metalness=0.0),
                    forward=False, cast_shadows=True)]
    side = max(1, int(round(n_cubes ** 0.5)))
    for i in range(n_cubes):
        gx, gz = i % side, i // side
        pos = (2.2 * (gx - side / 2) + rng.uniform(-0.3, 0.3),
               rng.uniform(-1.0, 2.0),
               2.2 * (gz - side / 2) + rng.uniform(-0.3, 0.3))
        color = rng.uniform(0.1, 0.9, size=3)
        scale = float(rng.uniform(0.4, 0.9))
        rough = float(rng.uniform(0.1, 0.9))
        metal = float(rng.uniform(0.0, 0.5))
        objects.append(dict(
            oid=i + 2, mesh="cube", position=[float(np.float32(p)) for p in pos],
            rotation=ident, scale=[float(np.float32(scale))] * 3,
            material=dict(albedo=[float(np.float32(c)) for c in color],
                          roughness=rough, metalness=metal),
            forward=False, cast_shadows=True))
    light_t = dict(position=[0.0, 5.0, 0.0], rotation=ident, scale=[1.0] * 3)
    objects.append(_billboard(n_cubes + 2, light_t))
    d = np.array([-0.5, -1.0, -0.3]) / np.linalg.norm([-0.5, -1.0, -0.3])
    eye = np.array([-12.0, 10.0, 0.0])
    return dict(
        objects=objects,
        point_lights=[dict(position=[0.0, 5.0, 0.0], color=[30.0, 28.0, 25.0])],
        directional_lights=[dict(direction=[float(np.float32(v)) for v in d],
                                 color=[2.0, 1.9, 1.7])],
        camera=dict(position=eye.tolist(), forward=list(_unit(-eye)),
                    up=[0.0, 1.0, 0.0], fov_y=45.0, znear=0.1, zfar=300.0))


def horizontal_bound(scene: dict) -> float:
    """The largest |x| or |z| any deferred object reaches: its position's
    plus its mesh's largest local |x| or |z| times its scale, rotation
    aside (1 for the cube)."""
    b = 0.0
    for o in scene["objects"]:
        if not o["forward"]:
            p, s = np.abs(o["position"]), np.abs(o["scale"])
            ex, ez = np.abs(mesh(o["mesh"])[0][:, [0, 2]]).max(0).astype(float)
            b = max(b, float(p[0] + ex * s[0]), float(p[2] + ez * s[2]))
    return b


def triangles(scene: dict):
    """The scene's triangle pool in the engine's order (objects by id,
    each mesh's triangles in order): world-space corners and normals per
    vertex, and per triangle its vertex indices, object id, material index
    and flags. Numpy float32 inputs of :mod:`frame`."""
    pos, nrm, tri, oid, mat, fwd, shadow = [], [], [], [], [], [], []
    models = []
    base = 0
    for k, o in enumerate(scene["objects"]):
        p, n, t = mesh(o["mesh"])
        models.append((model_matrix(o["position"], o["rotation"], o["scale"]),
                       p.shape[0]))
        pos.append(p)
        nrm.append(n)
        tri.append(t + base)
        base += p.shape[0]
        nt = t.shape[0]
        oid += [o["oid"]] * nt
        mat += [k] * nt
        fwd += [o["forward"]] * nt
        shadow += [o["cast_shadows"] and not o["forward"]] * nt
    return dict(local_pos=np.concatenate(pos), local_nrm=np.concatenate(nrm),
                models=models, tri=np.concatenate(tri),
                oid=np.array(oid, np.int64), mat=np.array(mat, np.int64),
                forward=np.array(fwd, bool), shadow=np.array(shadow, bool))
