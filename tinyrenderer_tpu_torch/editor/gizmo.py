"""Translation gizmo + drag interaction (src/gizmo.rs, src/gizmo_handler.rs).

Three procedural arrow renderables (transient, forward pass, no depth test,
no shadow casting — src/gizmo.rs:266-276), axis-colored, scaled with camera
distance (0.06 · dist, src/gizmo.rs:38,122-124). Hover swaps the arrow
material to the highlight color (src/gizmo.rs:157-200). Dragging solves the
closest point between the gizmo-axis line and the camera cursor ray
(crates/math_helpers/src/line.rs:17), with a 25 px² dead zone before a
press becomes a move (src/gizmo_handler.rs:17,87-101).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from ..scene import components as comp
from ..scene.camera import Camera
from ..scene.world import World, WorldObject
from ..utils import math3d
from . import events

F32 = np.float32

GIZMO_DISTANCE_SCALE = 0.06              # src/gizmo.rs:38
DRAG_SQUARED_DISTANCE_THRESHOLD = 25.0   # src/gizmo_handler.rs:17

AXIS_COLORS = {
    0: np.array([1.0, 0.0, 0.0], F32),   # X (src/gizmo.rs:18-22)
    1: np.array([0.0, 1.0, 0.0], F32),   # Y
    2: np.array([0.0, 0.0, 1.0], F32),   # Z
}
HOVERED_COLOR = np.array([0.9, 0.9, 0.0], F32)  # src/gizmo.rs:33-36

_AXIS_VECS = {
    0: np.array([1.0, 0.0, 0.0], F32),
    1: np.array([0.0, 1.0, 0.0], F32),
    2: np.array([0.0, 0.0, 1.0], F32),
}
# Arrow mesh points +Y; rotations to each axis (src/gizmo.rs:86-102).
_AXIS_ROTATIONS = {
    0: math3d.quat_from_axis_angle(np.array([0.0, 0.0, 1.0]), -math.pi / 2.0),
    1: math3d.quat_identity(),
    2: math3d.quat_from_axis_angle(np.array([1.0, 0.0, 0.0]), math.pi / 2.0),
}


def _arrow_renderable(color: np.ndarray) -> comp.RenderableComponent:
    return comp.RenderableComponent(
        model_descriptor=comp.ModelDescriptor(
            mesh_descriptor=comp.MeshDescriptor.primitive(comp.PrimitiveShape.Arrow),
            material_descriptor=comp.PbrMaterialDescriptor(
                flat=comp.PbrParameters(albedo=color.copy(), roughness=1.0,
                                        metalness=0.0))),
        rendering_options=comp.ModelRenderingOptions(
            pass_=comp.RenderingPass.ForceForwardAfterDeferred,
            use_depth_test=False,
            cast_shadows=False,
            pbr_resource_type=comp.PbrRenderingType.FlatParameters),
        is_transient=True,
    )


class Gizmo:
    """Gizmo arrows + selection state (src/gizmo.rs:47-314)."""

    def __init__(self) -> None:
        self.selected_object_id: Optional[int] = None
        self.part_axis: Dict[int, int] = {}     # arrow object id -> axis
        self.hovered_part_id: Optional[int] = None

    # -- queries --------------------------------------------------------------

    def is_gizmo_part(self, oid: int) -> bool:
        return oid in self.part_axis

    def axis_line(self, axis: int, world: World) -> Optional[math3d.Line]:
        obj = (world.get_world_object(self.selected_object_id)
               if self.selected_object_id else None)
        if obj is None:
            return None
        return math3d.Line(position=np.asarray(obj.transform.position, F32),
                           direction=_AXIS_VECS[axis].copy())

    # -- lifecycle ------------------------------------------------------------

    def _despawn(self, world: World) -> None:
        for oid in list(self.part_axis):
            world.remove_world_object(oid)
        self.part_axis.clear()
        self.hovered_part_id = None

    def _spawn(self, position: np.ndarray, scale: float, world: World) -> None:
        for axis in range(3):
            obj = WorldObject(
                components=[_arrow_renderable(AXIS_COLORS[axis])],
                transform=comp.TransformComponent(
                    position=np.asarray(position, F32).copy(),
                    scale=np.full(3, scale, F32),
                    rotation=np.asarray(_AXIS_ROTATIONS[axis], F32)))
            self.part_axis[world.add_world_object(obj)] = axis

    def select(self, oid: Optional[int], world: World,
               camera: Camera) -> None:
        """Select a world object (or None): move/spawn/despawn the arrows
        (src/gizmo.rs:202-304)."""
        if oid == self.selected_object_id:
            return
        self._despawn(world)
        self.selected_object_id = oid
        if oid is None:
            return
        obj = world.get_world_object(oid)
        if obj is None:
            self.selected_object_id = None
            return
        pos = np.asarray(obj.transform.position, F32)
        self._spawn(pos, self._scale_for(pos, camera), world)

    def _scale_for(self, position: np.ndarray, camera: Camera) -> float:
        return float(np.linalg.norm(camera.position - position)) * GIZMO_DISTANCE_SCALE

    def update(self, world: World, camera: Camera) -> None:
        """Per-frame distance-proportional rescale (src/gizmo.rs:122-150)."""
        if self.selected_object_id is None:
            return
        obj = world.get_world_object(self.selected_object_id)
        if obj is None:  # selected object deleted externally
            self.select(None, world, camera)
            return
        pos = np.asarray(obj.transform.position, F32)
        s = self._scale_for(pos, camera)
        for oid in self.part_axis:
            part = world.get_world_object_mut(oid)
            if part is not None:
                part.transform.scale = np.full(3, s, F32)
                # follow the object when its position was edited externally
                # (reflected-UI edits, src/player_controller.rs:74-93 sync)
                part.transform.position = pos.copy()

    def update_position(self, position: np.ndarray, world: World) -> None:
        for oid in self.part_axis:
            part = world.get_world_object_mut(oid)
            if part is not None:
                part.transform.position = np.asarray(position, F32).copy()

    # -- hover highlight (src/gizmo.rs:157-200) --------------------------------

    def set_hovered_object_id(self, oid: Optional[int], world: World) -> None:
        if oid == self.hovered_part_id:
            return
        if self.hovered_part_id is not None:
            self._set_part_color(self.hovered_part_id,
                                 AXIS_COLORS[self.part_axis[self.hovered_part_id]],
                                 world)
            self.hovered_part_id = None
        if oid is not None and oid in self.part_axis:
            self.hovered_part_id = oid
            self._set_part_color(oid, HOVERED_COLOR, world)

    def _set_part_color(self, oid: int, color: np.ndarray, world: World) -> None:
        obj = world.get_world_object_mut(oid)
        if obj is None:
            return
        r = obj.get_renderable()
        if r is not None:
            r.model_descriptor.material_descriptor = comp.PbrMaterialDescriptor(
                flat=comp.PbrParameters(albedo=color.copy(), roughness=1.0,
                                        metalness=0.0))


@dataclass
class _MoveInfo:
    """GizmoMoveInfo (src/gizmo_handler.rs:38-45)."""

    axis_line: math3d.Line
    grab_to_object: np.ndarray  # object position - interaction start point


class GizmoHandler:
    """Idle / WaitingForThreshold / Moving state machine
    (src/gizmo_handler.rs:47-217)."""

    def __init__(self, gizmo: Optional[Gizmo] = None):
        self.gizmo = gizmo or Gizmo()
        self._state = "idle"
        self._press_xy: Optional[tuple[float, float]] = None
        self._move_info: Optional[_MoveInfo] = None

    # -- helpers ---------------------------------------------------------------

    @staticmethod
    def _camera_ray(camera: Camera, x: float, y: float,
                    width: int, height: int) -> math3d.Line:
        p = camera.deproject_screen_to_world((x, y), 0.5, width, height)
        d = math3d.normalize(p - camera.position)
        return math3d.Line(position=camera.position.copy(), direction=d)

    def _begin_grab(self, axis: int, x: float, y: float, world: World,
                    camera: Camera, width: int, height: int) -> Optional[_MoveInfo]:
        line = self.gizmo.axis_line(axis, world)
        if line is None:
            return None
        ray = self._camera_ray(camera, x, y, width, height)
        grab, _ = line.closest_points(ray)
        obj = world.get_world_object(self.gizmo.selected_object_id)
        return _MoveInfo(axis_line=line,
                         grab_to_object=np.asarray(obj.transform.position, F32) - grab)

    def _perform_move(self, x: float, y: float, world: World, camera: Camera,
                      width: int, height: int) -> None:
        """src/gizmo_handler.rs:182-212."""
        info = self._move_info
        ray = self._camera_ray(camera, x, y, width, height)
        axis_point, _ = info.axis_line.closest_points(ray)
        new_pos = axis_point + info.grab_to_object
        obj = world.get_world_object_mut(self.gizmo.selected_object_id)
        if obj is not None:
            obj.transform.position = new_pos.astype(F32)
        self.gizmo.update_position(new_pos, world)

    # -- event entry (src/gizmo_handler.rs:76-178) -----------------------------

    def handle_event(self, event, world: World, camera: Camera,
                     width: int, height: int, pick_id_at) -> bool:
        """Returns True if the event was consumed (blocks camera input).
        ``pick_id_at(x, y) -> int`` is the async pick lookup."""
        g = self.gizmo

        if isinstance(event, events.CursorMoved):
            if self._state == "idle":
                g.set_hovered_object_id(pick_id_at(event.x, event.y) or None, world)
                return False
            if self._state == "waiting":
                dx = event.x - self._press_xy[0]
                dy = event.y - self._press_xy[1]
                if dx * dx + dy * dy >= DRAG_SQUARED_DISTANCE_THRESHOLD:
                    self._state = "moving"
                    self._perform_move(event.x, event.y, world, camera, width, height)
                return True
            if self._state == "moving":
                self._perform_move(event.x, event.y, world, camera, width, height)
                return True
            return False

        if isinstance(event, events.MouseInput) and event.button == events.MouseButton.Left:
            if event.pressed:
                oid = pick_id_at(event.x, event.y)
                if oid and g.is_gizmo_part(oid):
                    axis = g.part_axis[oid]
                    info = self._begin_grab(axis, event.x, event.y, world,
                                            camera, width, height)
                    if info is not None:
                        self._move_info = info
                        self._press_xy = (event.x, event.y)
                        self._state = "waiting"
                        return True
                elif oid:
                    g.select(oid, world, camera)
                    return True
                else:
                    g.select(None, world, camera)
                    return False
            else:
                ended = self._state in ("waiting", "moving")
                self._state = "idle"
                self._move_info = None
                return ended
            return False

        if isinstance(event, events.KeyInput) and event.pressed:
            if event.key == "Escape":  # deselect (src/gizmo_handler.rs:170-177)
                g.select(None, world, camera)
                self._state = "idle"
                return True
        return False

    def get_active_object_id(self) -> Optional[int]:
        return self.gizmo.selected_object_id

    def update(self, world: World, camera: Camera) -> None:
        self.gizmo.update(world, camera)
