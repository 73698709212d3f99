"""Player controller + camera fly-mode input routing.

Mirrors src/player_controller.rs:95-189 and
src/camera_controller.rs:76-115: the gizmo handler gets events first, then
the camera controller (RMB enables fly mode; WASD/QE move, mouse deltas
look), then app-level keys — Delete removes the selected object, Ctrl+R
requests a kernel recompile, Ctrl+W requests exit, dropped files spawn a
world object.
"""

from __future__ import annotations

from enum import Enum
from typing import Callable, Optional

import numpy as np

from ..scene import components as comp
from ..scene.camera import Camera
from ..scene.world import World, WorldObject
from . import events
from .gizmo import GizmoHandler

F32 = np.float32

# key -> (camera movement axis, positive?) — src/camera.rs:106-126
# axes: 0 = right, 1 = up, 2 = forward (see Camera.update)
_MOVE_KEYS = {
    "w": (2, True), "s": (2, False),
    "d": (0, True), "a": (0, False),
    "q": (1, True), "e": (1, False),
}


class Action(Enum):
    """WindowEventHandlingAction (src/app.rs:28-32)."""

    RecompileShaders = "RecompileShaders"
    Exit = "Exit"
    SaveIbl = "SaveIbl"
    ToggleGui = "ToggleGui"


class CameraInputController:
    """RMB-gated fly controls (src/camera_controller.rs:76-115)."""

    def __init__(self, camera: Camera):
        self.camera = camera
        self.is_movement_enabled = False

    def set_is_movement_enabled(self, value: bool) -> None:
        self.is_movement_enabled = value
        if not value:
            self.camera.stop_movement()

    def handle_event(self, event) -> bool:
        if isinstance(event, events.MouseInput):
            if event.button == events.MouseButton.Right:
                self.set_is_movement_enabled(event.pressed)
                return True
            return False
        if isinstance(event, events.MouseDelta):
            if self.is_movement_enabled:
                self.camera.rotate(event.dx, event.dy)
                return True
            return False
        if isinstance(event, events.KeyInput) and self.is_movement_enabled:
            k = event.key.lower()
            if k in _MOVE_KEYS:
                axis, positive = _MOVE_KEYS[k]
                self.camera.set_movement_axis(axis, positive, event.pressed)
                return True
        return False


class PlayerController:
    """src/player_controller.rs — the editor's event hub."""

    def __init__(self, camera: Camera, width: int, height: int,
                 pick_id_at: Callable[[float, float], int]):
        self.gizmo_handler = GizmoHandler()
        self.camera_input = CameraInputController(camera)
        self.width = width
        self.height = height
        self.pick_id_at = pick_id_at
        self.cursor_position: Optional[tuple[float, float]] = None

    # -- per-frame (src/player_controller.rs:74-93) ----------------------------

    def update(self, world: World) -> None:
        self.gizmo_handler.update(world, self.camera_input.camera)

    @property
    def selected_object_id(self) -> Optional[int]:
        return self.gizmo_handler.get_active_object_id()

    # -- events ---------------------------------------------------------------

    def handle_event(self, event, world: World) -> Optional[Action]:
        """Route one event. Returns a requested app action, or None.

        Routing order is the reference's: gizmo first, camera second,
        app-level keys last (src/player_controller.rs:101-110).
        """
        cam = self.camera_input.camera

        if self.gizmo_handler.handle_event(event, world, cam,
                                           self.width, self.height,
                                           self.pick_id_at):
            return None

        if self.camera_input.handle_event(event):
            return None

        if isinstance(event, events.CursorMoved):
            self.cursor_position = (event.x, event.y)
            return None

        if isinstance(event, events.Resized):
            self.width, self.height = event.width, event.height
            return None

        if isinstance(event, events.KeyInput) and event.pressed:
            key = event.key
            if key == "Delete":
                oid = self.gizmo_handler.get_active_object_id()
                if oid is not None:
                    self.gizmo_handler.gizmo.select(None, world, cam)
                    world.remove_world_object(oid)
                return None
            if key.lower() == "r" and event.ctrl:
                return Action.RecompileShaders
            if key.lower() == "w" and event.ctrl:
                return Action.Exit
            if key.lower() == "f":            # toggle GUI (src/app.rs:223-229)
                return Action.ToggleGui
            if key.lower() == "i":            # save IBL (src/app.rs:231-235)
                return Action.SaveIbl
            return None

        if isinstance(event, events.FileDropped):
            # spawn a world object from the dropped model file
            # (src/player_controller.rs:169-185). glTF assets carry their
            # own PBR materials (which the reference can't load at all):
            # one renderable per material group, addressed '#part<k>'.
            components = None
            if event.path.lower().endswith((".gltf", ".glb")):
                try:
                    from ..assets import gltf as gltflib
                    parts = gltflib.load_gltf_parts(event.path)
                    components = [comp.RenderableComponent(
                        model_descriptor=comp.ModelDescriptor(
                            mesh_descriptor=comp.MeshDescriptor.from_file(
                                f"{event.path}#part{k}"),
                            material_descriptor=part.material),
                        rendering_options=comp.ModelRenderingOptions(
                            pbr_resource_type=(
                                comp.PbrRenderingType.FlatParameters
                                if part.material.is_flat
                                else comp.PbrRenderingType.Textures)))
                        for k, part in enumerate(parts)]
                except Exception:  # malformed asset -> default-cube path
                    components = None
            if components is None:
                # non-glTF (or unreadable): default flat material
                components = [comp.RenderableComponent(
                    model_descriptor=comp.ModelDescriptor(
                        mesh_descriptor=comp.MeshDescriptor.from_file(event.path),
                        material_descriptor=comp.PbrMaterialDescriptor(
                            flat=comp.PbrParameters())),
                    rendering_options=comp.ModelRenderingOptions(
                        pbr_resource_type=comp.PbrRenderingType.FlatParameters))]
            world.add_world_object(WorldObject(
                components=components,
                transform=comp.TransformComponent()))
            return None

        return None
