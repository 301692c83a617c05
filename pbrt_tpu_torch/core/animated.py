"""AnimatedTransform: keyframe interpolation for motion blur.

Port of pbrt_tpu/core/animated.py (core/quaternion.{h,cpp} and
AnimatedTransform, transform.h:412-439, transform.cpp:1108-1612), a
library as in the JAX package: the port's scene reader refuses
ActiveTransform, as the JAX package's ignores it.  The two keyframes are
decomposed on the host in float64 into translation, rotation (a
quaternion) and scale (pbrt's polar decomposition, transform.cpp:
1138-1174); ``interpolate`` maps per-ray times [N] to object-to-world
matrices [N, 4, 4] on the device (transform.cpp:1176-1202).  Motion bounds
are the union of the box carried to 64 times over the shutter, padded
(the JAX package's conservative stand-in for pbrt's closed-form
BoundPointMotion).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def quat_from_matrix(m: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (x, y, z, w) (quaternion.cpp:62-102);
    host, one matrix."""
    m = np.asarray(m, np.float64)[:3, :3]
    trace = m[0, 0] + m[1, 1] + m[2, 2]
    q = np.zeros(4)
    if trace > 0.0:
        s = np.sqrt(trace + 1.0)
        q[3] = s / 2.0
        s = 0.5 / s
        q[0] = (m[2, 1] - m[1, 2]) * s
        q[1] = (m[0, 2] - m[2, 0]) * s
        q[2] = (m[1, 0] - m[0, 1]) * s
    else:
        nxt = [1, 2, 0]
        i = 0
        if m[1, 1] > m[0, 0]:
            i = 1
        if m[2, 2] > m[i, i]:
            i = 2
        j = nxt[i]
        k = nxt[j]
        s = np.sqrt((m[i, i] - (m[j, j] + m[k, k])) + 1.0)
        qv = np.zeros(3)
        qv[i] = s * 0.5
        if s != 0.0:
            s = 0.5 / s
        q[3] = (m[k, j] - m[j, k]) * s
        qv[j] = (m[j, i] + m[i, j]) * s
        qv[k] = (m[k, i] + m[i, k]) * s
        q[:3] = qv
    return q / np.linalg.norm(q)


def quat_to_matrix(q):
    """Quaternions [..., 4] -> rotation matrices [..., 3, 3]
    (Quaternion::ToTransform, quaternion.cpp:47-60, transposed for pbrt's
    left-handed convention)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y + z * w), 2 * (x * z - y * w)], -1),
        torch.stack([2 * (x * y - z * w), 1 - 2 * (x * x + z * z), 2 * (y * z + x * w)], -1),
        torch.stack([2 * (x * z + y * w), 2 * (y * z - x * w), 1 - 2 * (x * x + y * y)], -1),
    ], -1)


def slerp(t, q0, q1):
    """Spherical linear interpolation (quaternion.cpp:34-45) at t [...]."""
    cos_theta = torch.sum(q0 * q1, -1)
    lin = cos_theta > 0.9995
    qlin = q0 * (1 - t)[..., None] + q1 * t[..., None]
    qlin = qlin / torch.linalg.norm(qlin, dim=-1, keepdim=True)
    theta = torch.arccos(torch.clamp(cos_theta, -1.0, 1.0))
    thetap = theta * t
    qperp = q1 - q0 * cos_theta[..., None]
    qperp = qperp / torch.clamp(torch.linalg.norm(qperp, dim=-1, keepdim=True),
                                min=1e-12)
    qs = q0 * torch.cos(thetap)[..., None] + qperp * torch.sin(thetap)[..., None]
    return torch.where(lin[..., None], qlin, qs)


def decompose(m: np.ndarray):
    """M = T R S (AnimatedTransform::Decompose, transform.cpp:1138-1174):
    the translation, then the rotation by polar iteration, then
    S = R^-1 M.  Host, float64; returns float32 (T [3], quaternion [4],
    S [3, 3])."""
    m = np.asarray(m, np.float64)
    T = m[:3, 3].copy()
    M = m.copy()
    M[:3, 3] = 0.0
    M[3, :] = (0, 0, 0, 1)
    R = M.copy()
    for _ in range(100):
        r_next = 0.5 * (R + np.linalg.inv(R.T))
        norm = np.max(np.sum(np.abs(R - r_next), axis=1)[:3])
        R = r_next
        if norm < 1e-4:
            break
    quat = quat_from_matrix(R)
    S = np.linalg.inv(R) @ M
    return T.astype(np.float32), quat.astype(np.float32), S[:3, :3].astype(np.float32)


@dataclasses.dataclass(frozen=True)
class AnimatedXf:
    """A decomposed keyframe pair on one device."""
    start_time: float
    end_time: float
    trans: torch.Tensor  # [2, 3]
    quat: torch.Tensor  # [2, 4]
    scale: torch.Tensor  # [2, 3, 3]
    m0: torch.Tensor  # [4, 4] the keyframes themselves, used at t <= t0
    m1: torch.Tensor  # [4, 4] and t >= t1


def make_animated(m_start: np.ndarray, m_end: np.ndarray,
                  start_time: float = 0.0, end_time: float = 1.0,
                  device="cpu") -> AnimatedXf:
    """AnimatedTransform's constructor (transform.cpp:1108-1136): the
    second quaternion flipped into the first one's hemisphere for the
    shortest slerp."""
    t0, q0, s0 = decompose(m_start)
    t1, q1, s1 = decompose(m_end)
    if float(np.dot(q0, q1)) < 0.0:
        q1 = -q1

    def dev(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return AnimatedXf(start_time=float(np.float32(start_time)),
                      end_time=float(np.float32(end_time)),
                      trans=dev(np.stack([t0, t1])), quat=dev(np.stack([q0, q1])),
                      scale=dev(np.stack([s0, s1])), m0=dev(m_start), m1=dev(m_end))


def is_animated(m_start: np.ndarray, m_end: np.ndarray) -> bool:
    return not np.allclose(np.asarray(m_start), np.asarray(m_end))


def interpolate(at: AnimatedXf, time) -> torch.Tensor:
    """Per-ray times [N] -> object-to-world matrices [N, 4, 4]
    (AnimatedTransform::Interpolate, transform.cpp:1176-1202); the exact
    keyframes outside [t0, t1]."""
    time = torch.as_tensor(time, dtype=torch.float32, device=at.trans.device)
    span = max(np.float32(at.end_time) - np.float32(at.start_time), np.float32(1e-12))
    dt = (time - at.start_time) / float(span)
    dtc = torch.clamp(dt, 0.0, 1.0)
    trans = (1 - dtc)[..., None] * at.trans[0] + dtc[..., None] * at.trans[1]
    rot = quat_to_matrix(slerp(dtc, at.quat[0][None], at.quat[1][None]))
    scl = ((1 - dtc)[..., None, None] * at.scale[0]
           + dtc[..., None, None] * at.scale[1])
    rs = torch.sum(rot[..., :, :, None] * scl[..., None, :, :], dim=-2)
    m = torch.zeros(time.shape + (4, 4), dtype=torch.float32, device=time.device)
    m[..., :3, :3] = rs
    m[..., :3, 3] = trans
    m[..., 3, 3] = 1.0
    m = torch.where((dt <= 0.0)[..., None, None], at.m0, m)
    return torch.where((dt >= 1.0)[..., None, None], at.m1, m)


def interpolate_inverse(at: AnimatedXf, time) -> torch.Tensor:
    """Per-ray world-to-object matrices: the inverses of interpolate's."""
    return torch.linalg.inv(interpolate(at, time))


_MB_SAMPLES = 64


def motion_bounds(at: AnimatedXf, bounds_min, bounds_max):
    """Conservative world bounds of a box over [t0, t1]
    (AnimatedTransform::MotionBounds, transform.cpp:1214-1230): the union
    of the box carried to _MB_SAMPLES times, padded by 1% and 1e-5.  Host,
    numpy in and out."""
    bmin = np.asarray(bounds_min, np.float64)
    bmax = np.asarray(bounds_max, np.float64)
    corners = np.array([[x, y, z] for z in (bmin[2], bmax[2])
                        for y in (bmin[1], bmax[1]) for x in (bmin[0], bmax[0])])
    times = np.linspace(at.start_time, at.end_time, _MB_SAMPLES, dtype=np.float32)
    ms = interpolate(at, torch.as_tensor(times, device=at.trans.device)).cpu().numpy()
    pts = np.einsum("sij,cj->sci", ms[:, :3, :3], corners) + ms[:, None, :3, 3]
    lo = pts.min(axis=(0, 1))
    hi = pts.max(axis=(0, 1))
    pad = 0.01 * (hi - lo) + 1e-5
    return (lo - pad).astype(np.float32), (hi + pad).astype(np.float32)
