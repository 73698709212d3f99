"""Procedural demo scenes.

The reference ships a standing test scene (`levels/test.lvl`: ~50 cubes, a
point light and a directional light, SURVEY.md §4). This module builds
equivalent scenes entirely in code, so the engine can run — and be
benchmarked — without any external asset files.
"""

from __future__ import annotations

import numpy as np

from . import components as comp
from .camera import Camera
from .world import OmnipresentObject, World, WorldObject

F32 = np.float32


def _cube(position, scale=1.0, color=(0.8, 0.2, 0.2), roughness=0.5,
          metalness=0.0, textured: bool = False) -> WorldObject:
    if textured:
        # default texture slots (no file needed) — still exercises the
        # textured material path end to end
        mat = comp.PbrMaterialDescriptor(textures=())
    else:
        mat = comp.PbrMaterialDescriptor(flat=comp.PbrParameters(
            albedo=np.asarray(color, F32), roughness=roughness,
            metalness=metalness))
    return WorldObject(
        components=[comp.RenderableComponent(
            model_descriptor=comp.ModelDescriptor(
                mesh_descriptor=comp.MeshDescriptor.primitive(comp.PrimitiveShape.Cube),
                material_descriptor=mat),
            rendering_options=comp.ModelRenderingOptions(
                pbr_resource_type=comp.PbrRenderingType.FlatParameters))],
        transform=comp.TransformComponent(
            position=np.asarray(position, F32),
            scale=np.full(3, float(scale), F32) if np.ndim(scale) == 0
            else np.asarray(scale, F32)),
    )


def build_demo_world(n_cubes: int = 24, seed: int = 7,
                     with_point_light: bool = True,
                     with_directional_light: bool = True,
                     textured_every: int = 0) -> World:
    """A grid of flat-material cubes on a ground slab + the standard lights
    (the test.lvl analog: 43 flat cubes + lights, SURVEY.md §4).
    ``textured_every`` = N gives every Nth cube a (default-slot) textured
    material, like test.lvl's brick cubes; 0 = all flat."""
    rng = np.random.default_rng(seed)
    world = World()

    world.add_world_object(_cube((0.0, -2.0, 0.0), scale=(20.0, 0.5, 20.0),
                                 color=(0.45, 0.45, 0.5), roughness=0.9))

    side = max(1, int(round(n_cubes ** 0.5)))
    for i in range(n_cubes):
        gx, gz = i % side, i // side
        pos = (2.2 * (gx - side / 2) + rng.uniform(-0.3, 0.3),
               rng.uniform(-1.0, 2.0),
               2.2 * (gz - side / 2) + rng.uniform(-0.3, 0.3))
        color = rng.uniform(0.1, 0.9, size=3)
        world.add_world_object(_cube(
            pos, scale=rng.uniform(0.4, 0.9), color=color,
            roughness=float(rng.uniform(0.1, 0.9)),
            metalness=float(rng.uniform(0.0, 0.5)),
            textured=(textured_every > 0 and i % textured_every == 0)))

    if with_point_light:
        light = WorldObject(
            components=[comp.LightObjectComponent(
                light=comp.PointLight(color=np.array([30.0, 28.0, 25.0], F32)))],
            transform=comp.TransformComponent(position=np.array([0.0, 5.0, 0.0], F32)))
        world.add_world_object(light)

    if with_directional_light:
        world.add_omnipresent_object(OmnipresentObject(components=[
            comp.DirectionalLight(
                direction=np.array([-0.5, -1.0, -0.3], F32) / np.linalg.norm([-0.5, -1.0, -0.3]),
                color=np.array([2.0, 1.9, 1.7], F32))]))

    return world


def build_demo_camera(width: int, height: int) -> Camera:
    """Default editor viewpoint: eye at (-12, 10, 0) looking at the origin,
    the reference's Camera::new placement (src/camera.rs:43-76) with a
    corrected look-at orientation (see Camera.look_at)."""
    cam = Camera.new_default(width, height)
    cam.look_at(np.zeros(3, F32))
    return cam


def build_stress_world(n_objects: int = 500, seed: int = 11) -> World:
    """BASELINE.json config 5: 500+ draws."""
    return build_demo_world(n_cubes=n_objects, seed=seed)


def build_highpoly_world(n_spheres: int = 9, seed: int = 13) -> World:
    """Raster-throughput scene: ~12k-triangle spheres (~108k triangles at
    n_spheres=9) for the BASELINE Mtris/s metric — a scene where triangle
    count actually dominates, unlike test.lvl's ~600 triangles."""
    from ..assets import mesh as meshlib

    key = "sphere_hd"
    if key not in meshlib._PRIMITIVE_CACHE:
        meshlib._PRIMITIVE_CACHE[key] = meshlib.uv_sphere(stacks=78, slices=78)

    rng = np.random.default_rng(seed)
    world = World()
    side = max(1, int(round(n_spheres ** 0.5)))
    for i in range(n_spheres):
        gx, gz = i % side, i // side
        color = rng.uniform(0.2, 0.9, size=3)
        mat = comp.PbrMaterialDescriptor(flat=comp.PbrParameters(
            albedo=np.asarray(color, F32),
            roughness=float(rng.uniform(0.2, 0.8)), metalness=0.1))
        world.add_world_object(WorldObject(
            components=[comp.RenderableComponent(
                model_descriptor=comp.ModelDescriptor(
                    mesh_descriptor=comp.MeshDescriptor("PrimitiveInCode", key),
                    material_descriptor=mat),
                rendering_options=comp.ModelRenderingOptions(
                    pbr_resource_type=comp.PbrRenderingType.FlatParameters))],
            transform=comp.TransformComponent(
                position=np.asarray((3.0 * (gx - side / 2 + 0.5),
                                     rng.uniform(-0.5, 1.5),
                                     3.0 * (gz - side / 2 + 0.5)), F32),
                scale=np.full(3, 1.2, F32)),
        ))

    world.add_omnipresent_object(OmnipresentObject(components=[
        comp.DirectionalLight(
            direction=np.array([-0.5, -1.0, -0.3], F32) / np.linalg.norm([-0.5, -1.0, -0.3]),
            color=np.array([2.0, 1.9, 1.7], F32))]))
    return world
