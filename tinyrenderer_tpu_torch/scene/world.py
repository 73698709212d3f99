"""World container with dirty-object diffing.

Mirrors src/world.rs: objects live in id-keyed maps with monotonically
increasing ids starting at 1 (0 = "no object", src/world.rs:47); every
mutation appends to ``dirty_objects`` which downstream render state consumes
once per frame and the app clears at end-of-frame (src/world.rs:136-138).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, Iterator, List, Optional

import numpy as np

from . import components as comp

NO_OBJECT_ID = 0


class DirtyKind(Enum):
    Added = "Added"
    Removed = "Removed"
    Modified = "Modified"


@dataclass(frozen=True)
class DirtyObject:
    id: int
    kind: DirtyKind


@dataclass
class WorldObject:
    """src/world_object.rs:24-28: components + transform."""

    components: List[comp.SceneComponentType] = field(default_factory=list)
    transform: comp.TransformComponent = field(default_factory=comp.TransformComponent)

    def get_renderable(self) -> Optional[comp.RenderableComponent]:
        for c in self.components:
            if isinstance(c, comp.RenderableComponent):
                return c
        return None

    def get_light(self) -> Optional[comp.LightObjectComponent]:
        for c in self.components:
            if isinstance(c, comp.LightObjectComponent):
                return c
        return None

    def is_fully_transient(self) -> bool:
        return bool(self.components) and all(comp.is_transient(c) for c in self.components)

    def to_json(self) -> dict:
        return {
            "components": [comp.scene_component_to_json(c) for c in self.components
                           if not comp.is_transient(c)],
            "transform": self.transform.to_json(),
        }

    @classmethod
    def from_json(cls, d: dict) -> "WorldObject":
        return cls(
            components=[comp.scene_component_from_json(c) for c in d["components"]],
            transform=comp.TransformComponent.from_json(d["transform"]),
        )


@dataclass
class OmnipresentObject:
    """src/world_object.rs:31-34: transform-less (directional lights)."""

    components: List[comp.DirectionalLight] = field(default_factory=list)

    def get_directional_light(self) -> Optional[comp.DirectionalLight]:
        for c in self.components:
            if isinstance(c, comp.DirectionalLight):
                return c
        return None

    def to_json(self) -> dict:
        return {"components": [comp.omnipresent_component_to_json(c)
                               for c in self.components]}

    @classmethod
    def from_json(cls, d: dict) -> "OmnipresentObject":
        return cls(components=[comp.omnipresent_component_from_json(c)
                               for c in d["components"]])


def make_light_debug_billboard() -> comp.RenderableComponent:
    """Debug "lightbulb" billboard auto-added next to point lights
    (src/world_object.rs:44-71): a textured square, forward pass, transient.
    """
    return comp.RenderableComponent(
        model_descriptor=comp.ModelDescriptor(
            mesh_descriptor=comp.MeshDescriptor.primitive(comp.PrimitiveShape.Square),
            material_descriptor=comp.PbrMaterialDescriptor(
                textures=(comp.TextureSourceDescriptor(
                    usage=comp.TextureUsage.Albedo,
                    path="assets/textures/defaults/lightbulb.png"),)),
        ),
        rendering_options=comp.ModelRenderingOptions(
            pass_=comp.RenderingPass.ForceForwardAfterDeferred,
            use_depth_test=True,
            cast_shadows=False,
            pbr_resource_type=comp.PbrRenderingType.Textures,
        ),
        is_transient=True,
    )


class World:
    """src/world.rs:53-151."""

    def __init__(self) -> None:
        self._objects: Dict[int, WorldObject] = {}
        self._omnipresent: Dict[int, OmnipresentObject] = {}
        self._next_id = 1  # 0 is reserved for "no object"
        self.dirty_objects: List[DirtyObject] = []

    # -- mutation ----------------------------------------------------------

    def add_world_object(self, obj: WorldObject) -> int:
        oid = self._next_id
        self._next_id += 1
        if obj.get_light() is not None and obj.get_renderable() is None:
            obj.components.append(make_light_debug_billboard())
        self._objects[oid] = obj
        self.dirty_objects.append(DirtyObject(oid, DirtyKind.Added))
        return oid

    def add_omnipresent_object(self, obj: OmnipresentObject) -> int:
        oid = self._next_id
        self._next_id += 1
        self._omnipresent[oid] = obj
        self.dirty_objects.append(DirtyObject(oid, DirtyKind.Added))
        return oid

    def remove_world_object(self, oid: int) -> Optional[WorldObject]:
        obj = self._objects.pop(oid, None)
        if obj is not None:
            self.dirty_objects.append(DirtyObject(oid, DirtyKind.Removed))
        return obj

    # -- access ------------------------------------------------------------

    def get_world_object(self, oid: int) -> Optional[WorldObject]:
        return self._objects.get(oid)

    def get_world_object_mut(self, oid: int) -> Optional[WorldObject]:
        """Auto-marks the object Modified (src/world.rs:106-113)."""
        obj = self._objects.get(oid)
        if obj is not None:
            self.mark_modified(oid)
        return obj

    def get_omnipresent_object(self, oid: int) -> Optional[OmnipresentObject]:
        return self._omnipresent.get(oid)

    def get_omnipresent_object_mut(self, oid: int) -> Optional[OmnipresentObject]:
        obj = self._omnipresent.get(oid)
        if obj is not None:
            self.mark_modified(oid)
        return obj

    def mark_modified(self, oid: int) -> None:
        self.dirty_objects.append(DirtyObject(oid, DirtyKind.Modified))

    def world_objects(self) -> Iterator[tuple[int, WorldObject]]:
        return iter(sorted(self._objects.items()))

    def omnipresent_objects(self) -> Iterator[tuple[int, OmnipresentObject]]:
        return iter(sorted(self._omnipresent.items()))

    def __len__(self) -> int:
        return len(self._objects) + len(self._omnipresent)

    # -- frame lifecycle ----------------------------------------------------

    def on_end_frame(self) -> None:
        self.dirty_objects.clear()
