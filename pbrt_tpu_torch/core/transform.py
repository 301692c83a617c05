"""4x4 transforms for host-side scene compilation (numpy).

Port of pbrt_tpu/core/transform.py, unchanged in its arithmetic: shape
vertices are transformed to world space once at scene build, exactly as pbrt
does at creation (shapes/triangle.cpp:54); only cameras and quadrics carry
4x4 matrices to the device.  A Transform is a pair (m, m_inv) of float32
numpy 4x4 matrices.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class Transform:
    m: np.ndarray
    m_inv: np.ndarray

    def __matmul__(self, other: "Transform") -> "Transform":
        return Transform(self.m @ other.m, other.m_inv @ self.m_inv)

    @property
    def inverse(self) -> "Transform":
        return Transform(self.m_inv, self.m)

    def swaps_handedness(self) -> bool:
        """(transform.cpp SwapsHandedness) det of upper 3x3 < 0."""
        return float(np.linalg.det(self.m[:3, :3])) < 0.0

    def apply_point(self, p: np.ndarray) -> np.ndarray:
        ph = p @ self.m[:3, :3].T + self.m[:3, 3]
        w = p @ self.m[3, :3].T + self.m[3, 3]
        w = np.asarray(w)
        return np.where(w[..., None] == 1.0, ph, ph / w[..., None])

    def apply_vector(self, v: np.ndarray) -> np.ndarray:
        return v @ self.m[:3, :3].T

    def apply_normal(self, n: np.ndarray) -> np.ndarray:
        """Normals transform by the inverse transpose (transform.h:287)."""
        return n @ self.m_inv[:3, :3]

    def is_identity(self) -> bool:
        return bool(np.allclose(self.m, np.eye(4)))


def identity() -> Transform:
    e = np.eye(4, dtype=np.float32)
    return Transform(e, e.copy())


def from_matrix(m: np.ndarray) -> Transform:
    m = np.asarray(m, np.float32).reshape(4, 4)
    return Transform(m, np.linalg.inv(m).astype(np.float32))


def translate(dx, dy, dz) -> Transform:
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = [dx, dy, dz]
    mi = np.eye(4, dtype=np.float32)
    mi[:3, 3] = [-dx, -dy, -dz]
    return Transform(m, mi)


def scale(sx, sy, sz) -> Transform:
    m = np.diag(np.array([sx, sy, sz, 1.0], np.float32))
    mi = np.diag(np.array([1.0 / sx, 1.0 / sy, 1.0 / sz, 1.0], np.float32))
    return Transform(m, mi)


def rotate(angle_deg, ax, ay, az) -> Transform:
    """Axis-angle rotation (transform.cpp:170 Rotate), angle in degrees."""
    a = np.array([ax, ay, az], np.float64)
    a = a / np.linalg.norm(a)
    s = math.sin(math.radians(angle_deg))
    c = math.cos(math.radians(angle_deg))
    m = np.eye(4, dtype=np.float64)
    m[0, 0] = a[0] * a[0] + (1 - a[0] * a[0]) * c
    m[0, 1] = a[0] * a[1] * (1 - c) - a[2] * s
    m[0, 2] = a[0] * a[2] * (1 - c) + a[1] * s
    m[1, 0] = a[0] * a[1] * (1 - c) + a[2] * s
    m[1, 1] = a[1] * a[1] + (1 - a[1] * a[1]) * c
    m[1, 2] = a[1] * a[2] * (1 - c) - a[0] * s
    m[2, 0] = a[0] * a[2] * (1 - c) - a[1] * s
    m[2, 1] = a[1] * a[2] * (1 - c) + a[0] * s
    m[2, 2] = a[2] * a[2] + (1 - a[2] * a[2]) * c
    m = m.astype(np.float32)
    return Transform(m, m.T.copy())


def look_at(eye, look, up) -> Transform:
    """Camera-to-world from eye/look/up (transform.cpp:216 LookAt)."""
    eye = np.asarray(eye, np.float64)
    look = np.asarray(look, np.float64)
    up = np.asarray(up, np.float64)
    d = look - eye
    d = d / np.linalg.norm(d)
    right = np.cross(up / np.linalg.norm(up), d)
    nr = np.linalg.norm(right)
    if nr < 1e-10:
        raise ValueError("LookAt: up vector parallel to viewing direction")
    right = right / nr
    new_up = np.cross(d, right)
    c2w = np.eye(4, dtype=np.float64)
    c2w[:3, 0] = right
    c2w[:3, 1] = new_up
    c2w[:3, 2] = d
    c2w[:3, 3] = eye
    c2w = c2w.astype(np.float32)
    return Transform(c2w, np.linalg.inv(c2w.astype(np.float64)).astype(np.float32))


def perspective(fov_deg, znear, zfar) -> Transform:
    """Projective camera->screen transform (transform.cpp:238 Perspective)."""
    persp = np.array(
        [
            [1, 0, 0, 0],
            [0, 1, 0, 0],
            [0, 0, zfar / (zfar - znear), -zfar * znear / (zfar - znear)],
            [0, 0, 1, 0],
        ],
        np.float32,
    )
    inv_tan = 1.0 / math.tan(math.radians(fov_deg) / 2)
    return from_matrix(scale(inv_tan, inv_tan, 1.0).m @ persp)



def orthographic(znear, zfar) -> Transform:
    """Orthographic camera->screen transform (transform.cpp:231)."""
    return scale(1.0, 1.0, 1.0 / (zfar - znear)) @ translate(0.0, 0.0, -znear)
