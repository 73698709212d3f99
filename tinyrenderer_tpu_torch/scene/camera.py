"""FPS camera and its packed GPU uniform.

Math mirrors src/camera.rs + src/camera_controller.rs:
- orientation is a (z, y, x)-euler 3-tuple; forward = Ry(o0) * Rz(o2) * X
  (src/camera.rs:85-90); mouse look mutates o0/o2 with pitch clamp.
- view = look_at_rh(position, position + forward, up)
- proj = reverse_z * perspective_rh(fov_y, aspect, znear, zfar); the .lvl
  `fov_y` value (45.0) is fed to perspective_rh as radians, exactly like the
  reference does (src/camera_controller.rs:122-123) — effective FOV ~58.3 deg.
- CameraRaw packs {view_proj, view, view_inv(=view^T), proj, proj_inv,
  camera_pos} (src/camera_controller.rs:161-170; the transpose quirk at :130
  is kept: the shaders only use its rotation part, where it equals the
  inverse).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from ..editor.params import ui_param
from ..utils import math3d

F32 = np.float32

REFERENCE_DIRECTION = np.array([1.0, 0.0, 0.0], F32)
CAMERA_UP = np.array([0.0, 1.0, 0.0], F32)
DEFAULT_FOV_Y = 45.0
DEFAULT_MOVEMENT_SENSITIVITY = 20.0
DEFAULT_LOOK_SENSITIVITY = 0.005


@dataclass
class Camera:
    position: np.ndarray = field(default_factory=lambda: np.array([-12.0, 10.0, 0.0], F32),
                                 metadata=ui_param(min=-300.0, max=300.0))
    up: np.ndarray = field(default_factory=lambda: CAMERA_UP.copy())
    aspect: float = 1.5
    znear: float = 0.1
    zfar: float = 300.0
    orientation: np.ndarray = field(default_factory=lambda: np.zeros(3, F32))
    fov_y: float = DEFAULT_FOV_Y
    look_sensitivity: np.ndarray = field(
        default_factory=lambda: np.full(2, DEFAULT_LOOK_SENSITIVITY, F32))
    movement_sensitivity: np.ndarray = field(
        default_factory=lambda: np.full(3, DEFAULT_MOVEMENT_SENSITIVITY, F32))

    # runtime-only (serde skip_serializing, src/camera.rs:35-40)
    current_speed_positive: np.ndarray = field(default_factory=lambda: np.zeros(3, F32),
                                               metadata=ui_param(skip=True))
    current_speed_negative: np.ndarray = field(default_factory=lambda: np.zeros(3, F32),
                                               metadata=ui_param(skip=True))

    @classmethod
    def new_default(cls, width: int, height: int) -> "Camera":
        """Replicates Camera::new (src/camera.rs:43-76)."""
        eye = np.array([-12.0, 10.0, 0.0], F32)
        target = np.zeros(3, F32)
        view_dir = math3d.normalize(target - eye)
        axis = math3d.normalize(math3d.cross(view_dir, REFERENCE_DIRECTION))
        angle = -math.acos(np.clip(np.dot(view_dir, REFERENCE_DIRECTION), -1.0, 1.0))
        q = math3d.quat_from_axis_angle(axis, angle)
        orientation = np.array(_quat_to_euler_zyx(q), F32)
        return cls(position=eye, aspect=width / height, orientation=orientation)

    # -- movement/orientation (src/camera.rs:85-190) -------------------------

    def get_forward(self) -> np.ndarray:
        pitch = math3d.quat_from_rotation_y(float(self.orientation[0]))
        yaw = math3d.quat_from_rotation_z(float(self.orientation[2]))
        return math3d.quat_rotate(math3d.quat_mul(pitch, yaw), REFERENCE_DIRECTION)

    def get_right(self) -> np.ndarray:
        return math3d.normalize(math3d.cross(self.get_forward(), CAMERA_UP))

    def get_target(self) -> np.ndarray:
        return (self.position + self.get_forward()).astype(F32)

    def resize(self, width: int, height: int) -> None:
        self.aspect = width / height

    def set_movement_axis(self, axis: int, positive: bool, pressed: bool) -> None:
        arr = self.current_speed_positive if positive else self.current_speed_negative
        arr[axis] = 1.0 if pressed else 0.0

    def stop_movement(self) -> None:
        self.current_speed_positive[:] = 0.0
        self.current_speed_negative[:] = 0.0

    def rotate(self, delta_x: float, delta_y: float) -> None:
        self.orientation[0] += self.look_sensitivity[0] * -delta_x
        self.orientation[2] += self.look_sensitivity[1] * -delta_y
        lim = math.pi / 2.0 - 0.0001
        self.orientation[2] = float(np.clip(self.orientation[2], -lim, lim))

    def look_at(self, target) -> None:
        """Point the camera at ``target`` by solving the orientation euler
        pair directly: forward = Ry(o0) * Rz(o2) * X, so
        o2 = asin(dir.y) and o0 = atan2(-dir.z, dir.x).

        The reference's Camera::new derives orientation through a quaternion
        whose euler decomposition lands in the wrong slots (the in-source
        TODO "Now the camera can flip", src/camera.rs:55); .lvl files always
        carry a hand-tuned orientation so it never shows there. This solver
        is the corrected path used by procedural scenes.
        """
        d = math3d.normalize(np.asarray(target, F32) - self.position)
        self.orientation[2] = float(np.arcsin(np.clip(d[1], -1.0, 1.0)))
        self.orientation[0] = float(np.arctan2(-d[2], d[0]))

    def update(self, delta_seconds: float) -> None:
        speed = self.current_speed_positive - self.current_speed_negative
        if not speed.any():
            return
        s = speed / np.linalg.norm(speed)
        v = (s[0] * self.get_right() + s[1] * CAMERA_UP + s[2] * self.get_forward())
        self.position = (self.position
                         + F32(delta_seconds) * v * self.movement_sensitivity).astype(F32)

    # -- matrices ------------------------------------------------------------

    def view_matrix(self) -> np.ndarray:
        return math3d.look_at_rh(self.position, self.get_target(), self.up)

    def proj_matrix(self, reverse_z: bool = True) -> np.ndarray:
        p = math3d.perspective_rh(self.fov_y, self.aspect, self.znear, self.zfar)
        return (math3d.reverse_z_matrix() @ p) if reverse_z else p

    def to_raw(self) -> np.ndarray:
        """Pack the CameraRaw uniform as a flat (84,) f32 row:
        view_proj(16) | view(16) | view_inv(16) | proj(16) | proj_inv(16) |
        camera_pos(4) — with matrices flattened row-major for M @ v."""
        view = self.view_matrix()
        proj = self.proj_matrix()
        vp = (proj @ view).astype(F32)
        return np.concatenate([
            vp.ravel(), view.ravel(), view.T.ravel(), proj.ravel(),
            np.linalg.inv(proj.astype(np.float64)).astype(F32).ravel(),
            np.array([*self.position, 1.0], F32),
        ]).astype(F32)

    def deproject_screen_to_world(self, screen_xy, ndc_z: float,
                                  width: int, height: int) -> np.ndarray:
        vp = self.proj_matrix(reverse_z=False) @ self.view_matrix()
        return math3d.deproject_screen_to_world(vp, screen_xy, ndc_z, width, height)

    # -- serde ----------------------------------------------------------------

    def to_json(self) -> dict:
        return {
            "aspect": float(self.aspect),
            "fov_y": float(self.fov_y),
            "look_sensitivity": [float(v) for v in self.look_sensitivity],
            "movement_sensitivity": [float(v) for v in self.movement_sensitivity],
            "orientation": [float(v) for v in self.orientation],
            "position": [float(v) for v in self.position],
            "up": [float(v) for v in self.up],
            "zfar": float(self.zfar),
            "znear": float(self.znear),
        }

    @classmethod
    def from_json(cls, d: dict) -> "Camera":
        return cls(
            position=np.asarray(d["position"], F32),
            up=np.asarray(d["up"], F32),
            aspect=float(d["aspect"]),
            znear=float(d["znear"]),
            zfar=float(d["zfar"]),
            orientation=np.asarray(d["orientation"], F32),
            fov_y=float(d["fov_y"]),
            look_sensitivity=np.asarray(d["look_sensitivity"], F32),
            movement_sensitivity=np.asarray(d["movement_sensitivity"], F32),
        )


def _quat_to_euler_zyx(q: np.ndarray) -> tuple[float, float, float]:
    """glam Quat::to_euler(EulerRot::ZYX) -> (z, y, x) angles."""
    x, y, z, w = (float(v) for v in q)
    # ZYX intrinsic: R = Rz(a) * Ry(b) * Rx(c)
    sin_b = np.clip(2.0 * (w * y - z * x), -1.0, 1.0)
    b = math.asin(sin_b)
    a = math.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    c = math.atan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    return (a, b, c)
