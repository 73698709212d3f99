"""`.lvl` level save/load — JSON-compatible with the reference's serde output
(src/world_loader.rs:16-77).

Format: pretty-printed JSON ``{"camera": ..., "omnipresent_objects": [...],
"world_objects": [...]}``. Loading adds objects through the normal World API
so the dirty list fires for every object (src/world_loader.rs:23-37); saving
filters transient components (gizmos, light billboards,
src/world_loader.rs:59-70).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

from .camera import Camera
from .world import OmnipresentObject, World, WorldObject


@dataclass
class Level:
    world: World
    camera: Camera


def load_level(path: str) -> Level:
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    world = World()
    for od in data.get("world_objects", []):
        world.add_world_object(WorldObject.from_json(od))
    for od in data.get("omnipresent_objects", []):
        world.add_omnipresent_object(OmnipresentObject.from_json(od))
    camera = Camera.from_json(data["camera"])
    return Level(world=world, camera=camera)


def level_to_json(world: World, camera: Camera) -> dict:
    world_objects = []
    for _oid, obj in world.world_objects():
        j = obj.to_json()
        # Objects whose every component is transient are dropped entirely
        # (gizmo arrows), matching world_loader.rs:59-70.
        if not j["components"] and obj.get_renderable() is not None:
            continue
        world_objects.append(j)
    omnipresent = [obj.to_json() for _oid, obj in world.omnipresent_objects()]
    return {
        "camera": camera.to_json(),
        "omnipresent_objects": omnipresent,
        "world_objects": world_objects,
    }


def save_level(path: str, world: World, camera: Camera) -> None:
    data = level_to_json(world, camera)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=2)
