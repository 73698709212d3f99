"""Host-side 3D math helpers (numpy, float32 throughout).

Conventions follow the reference engine (glam, right-handed, column-vector
matrices `M @ v`) so that packed matrices are bit-comparable:

- ``reverse_z_matrix``      -> crates/math_helpers/src/matrix.rs:3
- ``perspective_rh``        -> glam `Mat4::perspective_rh` (0..1 depth range)
- ``orthographic_rh``       -> glam `Mat4::orthographic_rh`
- ``look_at_rh``            -> glam `Mat4::look_at_rh`
- ``Line.closest_points``   -> crates/math_helpers/src/line.rs:17
- ``quat_*``                -> glam quaternion ops used by components.rs

All functions return numpy float32 arrays; matrices are (4, 4) acting on
column vectors (world = M @ v).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

F32 = np.float32


def vec3(x, y=None, z=None) -> np.ndarray:
    if y is None:
        a = np.asarray(x, dtype=F32)
        assert a.shape == (3,)
        return a
    return np.array([x, y, z], dtype=F32)


def normalize(v: np.ndarray) -> np.ndarray:
    v = np.asarray(v, dtype=F32)
    n = np.linalg.norm(v)
    if n == 0.0:
        return v
    return (v / n).astype(F32)


def cross(a, b) -> np.ndarray:
    return np.cross(np.asarray(a, F32), np.asarray(b, F32)).astype(F32)


def dot(a, b) -> float:
    return float(np.dot(np.asarray(a, F32), np.asarray(b, F32)))


# ---------------------------------------------------------------------------
# Matrices
# ---------------------------------------------------------------------------

def identity4() -> np.ndarray:
    return np.eye(4, dtype=F32)


def reverse_z_matrix() -> np.ndarray:
    """Maps NDC z in [0, 1] to [1, 0] (reverse-Z).

    Mirrors crates/math_helpers/src/matrix.rs:3 (glam column-major columns
    written there correspond to this row-major layout for M @ v).
    """
    m = np.eye(4, dtype=F32)
    m[2, 2] = -1.0
    m[2, 3] = 1.0
    return m


def perspective_rh(fov_y_radians: float, aspect: float, z_near: float, z_far: float) -> np.ndarray:
    """glam Mat4::perspective_rh — right-handed, depth 0..1.

    NOTE: the reference feeds ``fov_y = 45.0`` (from the .lvl file) straight
    into this function *as radians* (src/camera_controller.rs:122-123), which
    works out to an effective FOV of ~58.3 deg. We reproduce that verbatim:
    callers pass the raw value from the level file.
    """
    sin_fov = math.sin(0.5 * fov_y_radians)
    cos_fov = math.cos(0.5 * fov_y_radians)
    h = cos_fov / sin_fov
    w = h / aspect
    r = z_far / (z_near - z_far)
    m = np.zeros((4, 4), dtype=F32)
    m[0, 0] = w
    m[1, 1] = h
    m[2, 2] = r
    m[2, 3] = r * z_near
    m[3, 2] = -1.0
    return m


def orthographic_rh(left: float, right: float, bottom: float, top: float,
                    near: float, far: float) -> np.ndarray:
    """glam Mat4::orthographic_rh — right-handed, depth 0..1."""
    rcp_w = 1.0 / (right - left)
    rcp_h = 1.0 / (top - bottom)
    r = 1.0 / (near - far)
    m = np.eye(4, dtype=F32)
    m[0, 0] = 2.0 * rcp_w
    m[1, 1] = 2.0 * rcp_h
    m[2, 2] = r
    m[0, 3] = -(left + right) * rcp_w
    m[1, 3] = -(top + bottom) * rcp_h
    m[2, 3] = r * near
    return m


def look_at_rh(eye, center, up) -> np.ndarray:
    """glam Mat4::look_at_rh."""
    eye = np.asarray(eye, F32)
    f = normalize(np.asarray(center, F32) - eye)  # forward
    s = normalize(cross(f, np.asarray(up, F32)))  # right ("side")
    u = cross(s, f)
    m = np.eye(4, dtype=F32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -dot(s, eye)
    m[1, 3] = -dot(u, eye)
    m[2, 3] = dot(f, eye)
    return m


# ---------------------------------------------------------------------------
# Quaternions (x, y, z, w) — glam layout, as serialized in .lvl files
# ---------------------------------------------------------------------------

def quat_identity() -> np.ndarray:
    return np.array([0.0, 0.0, 0.0, 1.0], dtype=F32)


def quat_from_axis_angle(axis, angle: float) -> np.ndarray:
    axis = normalize(axis)
    s = math.sin(angle * 0.5)
    return np.array([axis[0] * s, axis[1] * s, axis[2] * s, math.cos(angle * 0.5)], dtype=F32)


def quat_from_rotation_y(angle: float) -> np.ndarray:
    return quat_from_axis_angle(np.array([0.0, 1.0, 0.0]), angle)


def quat_from_rotation_z(angle: float) -> np.ndarray:
    return quat_from_axis_angle(np.array([0.0, 0.0, 1.0]), angle)


def quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ax, ay, az, aw = (float(v) for v in a)
    bx, by, bz, bw = (float(v) for v in b)
    return np.array([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], dtype=F32)


def quat_rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Rotate vector v by quaternion q."""
    qv = np.asarray(q[:3], F32)
    w = float(q[3])
    v = np.asarray(v, F32)
    t = 2.0 * cross(qv, v)
    return (v + w * t + cross(qv, t)).astype(F32)


def quat_to_mat3(q: np.ndarray) -> np.ndarray:
    x, y, z, w = (float(v) for v in q)
    x2, y2, z2 = x + x, y + y, z + z
    xx, xy, xz = x * x2, x * y2, x * z2
    yy, yz, zz = y * y2, y * z2, z * z2
    wx, wy, wz = w * x2, w * y2, w * z2
    return np.array([
        [1.0 - (yy + zz), xy - wz, xz + wy],
        [xy + wz, 1.0 - (xx + zz), yz - wx],
        [xz - wy, yz + wx, 1.0 - (xx + yy)],
    ], dtype=F32)


def compose_trs(position, rotation_quat, scale) -> np.ndarray:
    """Model matrix = T * R * S (glam Mat4::from_scale_rotation_translation)."""
    m = np.eye(4, dtype=F32)
    r = quat_to_mat3(rotation_quat)
    s = np.asarray(scale, F32)
    m[:3, :3] = r * s[None, :]
    m[:3, 3] = np.asarray(position, F32)
    return m


def normal_matrix(model: np.ndarray) -> np.ndarray:
    """3x3 inverse-transpose of the model matrix's linear part.

    The reference constructs it from the rotation alone (uniform-scale
    assumption, src/components.rs:69-144); we use the general inverse
    transpose, which agrees for rotations and also handles non-uniform scale.
    """
    lin = model[:3, :3].astype(np.float64)
    return np.linalg.inv(lin).T.astype(F32)


# ---------------------------------------------------------------------------
# Lines (gizmo math) — crates/math_helpers/src/line.rs
# ---------------------------------------------------------------------------

@dataclass
class Line:
    position: np.ndarray
    direction: np.ndarray

    def evaluate(self, t: float) -> np.ndarray:
        return (np.asarray(self.position, F32) + np.asarray(self.direction, F32) * F32(t)).astype(F32)

    def closest_points(self, other: "Line") -> tuple[np.ndarray, np.ndarray]:
        """Closest points between two (skew) lines.

        Same formulation as the reference (math.stackexchange.com/a/2217845,
        crates/math_helpers/src/line.rs:17-42).
        """
        diff_vec = cross(self.direction, other.direction)
        denom = float(np.dot(diff_vec, diff_vec))
        delta = np.asarray(other.position, F32) - np.asarray(self.position, F32)
        self_t = float(np.dot(cross(other.direction, diff_vec), delta)) / denom
        other_t = float(np.dot(cross(self.direction, diff_vec), delta)) / denom
        return self.evaluate(self_t), other.evaluate(other_t)


def normalize_to_interval(value: float, lo: float, hi: float) -> float:
    """Wrap value into [lo, hi) — crates/math_helpers/src/degrees.rs:8."""
    width = hi - lo
    return ((value - lo) % width) + lo


# ---------------------------------------------------------------------------
# Screen <-> world
# ---------------------------------------------------------------------------

def deproject_screen_to_world(view_proj_no_reverse_z: np.ndarray, screen_xy, ndc_z: float,
                              width: int, height: int) -> np.ndarray:
    """Screen pixel -> world point at the given NDC depth.

    Mirrors src/camera_controller.rs:137-158 (note: the reference deprojects
    with a *non* reverse-Z projection).
    """
    x = screen_xy[0] / float(width) * 2.0 - 1.0
    y = -(screen_xy[1] / float(height) * 2.0 - 1.0)
    inv = np.linalg.inv(view_proj_no_reverse_z.astype(np.float64))
    p = inv @ np.array([x, y, ndc_z, 1.0], dtype=np.float64)
    return (p[:3] / p[3]).astype(F32)
