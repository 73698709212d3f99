"""A configuration's scene, as the benchmark makes it: the plain description
that the reference reads (``reference/scene.py``) and the engine that the
window drives, built from the same description through the port's public
API (a level file through the engine's own loader). The engine finds a
mesh file under the repository's root, whatever the working directory,
and a run whose engine loaded another mesh than the reference reads (the
engine draws a cube where a path does not resolve) stops in set-up."""

from __future__ import annotations

import os

import numpy as np

from .reference import scene as refscene

F32 = np.float32


def describe(config: dict, root: str) -> dict:
    """The plain scene of a configuration's ``scene`` entry: ``{"level":
    path}`` or ``{"grid": {"cubes": n, "seed": s}}``."""
    s = config["scene"]
    if "level" in s:
        return refscene.level_scene(os.path.join(root, s["level"]))
    if "grid" in s:
        return refscene.grid_scene(s["grid"]["cubes"], s["grid"]["seed"])
    raise ValueError(f"unknown scene {s!r}")


def _world(desc: dict):
    """The port's World of a plain scene (a light's billboard is added by
    the World itself)."""
    from tinyrenderer_tpu_torch.scene import components as comp
    from tinyrenderer_tpu_torch.scene.world import (OmnipresentObject, World,
                                                    WorldObject)

    world = World()
    lights = iter(desc["point_lights"])
    for o in desc["objects"]:
        t = comp.TransformComponent(position=np.asarray(o["position"], F32),
                                    scale=np.asarray(o["scale"], F32),
                                    rotation=np.asarray(o["rotation"], F32))
        if o["material"] is None:
            light = next(lights)
            world.add_world_object(WorldObject(
                components=[comp.LightObjectComponent(light=comp.PointLight(
                    color=np.asarray(light["color"], F32)))],
                transform=t))
            continue
        m = o["material"]
        mat = comp.PbrMaterialDescriptor(flat=comp.PbrParameters(
            albedo=np.asarray(m["albedo"], F32), roughness=m["roughness"],
            metalness=m["metalness"]))
        mesh = (comp.MeshDescriptor.primitive(
                    comp.PrimitiveShape(o["mesh"].capitalize()))
                if o["mesh"] in refscene.MESHES
                else comp.MeshDescriptor.from_file(o["mesh"]))
        world.add_world_object(WorldObject(
            components=[comp.RenderableComponent(
                model_descriptor=comp.ModelDescriptor(
                    mesh_descriptor=mesh, material_descriptor=mat),
                rendering_options=comp.ModelRenderingOptions(
                    cast_shadows=o["cast_shadows"],
                    pbr_resource_type=comp.PbrRenderingType.FlatParameters))],
            transform=t))
    for d in desc["directional_lights"]:
        world.add_omnipresent_object(OmnipresentObject(components=[
            comp.DirectionalLight(direction=np.asarray(d["direction"], F32),
                                  color=np.asarray(d["color"], F32))]))
    return world


def check_meshes(eng, desc: dict) -> None:
    """Raise unless every drawn object's mesh, as the engine loaded it, has
    the reference's triangles with the same corners."""
    world = dict(eng.world.world_objects())
    for o in desc["objects"]:
        obj = world.get(o["oid"])
        r = obj.get_renderable() if obj is not None else None
        if r is None:
            raise RuntimeError(f"object {o['oid']} ({o['mesh']}): the engine "
                               f"draws nothing there")
        # the packer's cache: the frame packs this same mesh
        got = eng._packer.load_mesh(r.model_descriptor.mesh_descriptor)
        pos, _, tri = refscene.mesh(o["mesh"])
        n = got.num_triangles
        if n != tri.shape[0] or not np.allclose(
                got.positions[got.indices.reshape(-1, 3)], pos[tri],
                rtol=1e-6, atol=1e-6):
            raise RuntimeError(
                f"object {o['oid']} ({o['mesh']}): the engine loaded {n} "
                f"triangles, the reference {tri.shape[0]}"
                + (", with other corners" if n == tri.shape[0] else ""))


def build_engine(config: dict, desc: dict, root: str, device):
    """The engine of a configuration: its ``render`` fields, its scene with
    its meshes checked (:func:`check_meshes`), its ``params`` set (index by
    the frame module's ``PARAM_`` names)."""
    from tinyrenderer_tpu_torch.config import RenderConfig
    from tinyrenderer_tpu_torch.render import frame as framelib
    from tinyrenderer_tpu_torch.render.engine import Engine
    from tinyrenderer_tpu_torch.scene.camera import Camera

    cfg = RenderConfig(**config["render"])
    s = config["scene"]
    if "level" in s:
        eng = Engine(cfg=cfg, device=device, asset_search_paths=(root,),
                     level_path=os.path.join(root, s["level"]))
    else:
        cam = Camera.new_default(cfg.width, cfg.height)
        cam.look_at(np.asarray(desc["camera"]["position"], F32)
                    + np.asarray(desc["camera"]["forward"], F32))
        eng = Engine.from_world(_world(desc), camera=cam, cfg=cfg,
                                device=device, asset_search_paths=(root,))
    check_meshes(eng, desc)
    for name, value in config.get("params", {}).items():
        eng.set_param(getattr(framelib, "PARAM_" + name.upper()), value)
    return eng
