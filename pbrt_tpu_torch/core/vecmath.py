"""Batched 3D vector math over ``[..., 3]`` tensors.

Port of pbrt_tpu/core/vecmath.py.  A vector is the trailing axis of a float32
tensor; every function works on any leading batch shape.  Sums over the three
components are written out left to right, (x + y) + z, so they round as the
JAX package's three-term reductions do.
"""
from __future__ import annotations

import math

import torch

MACHINE_EPSILON = float(torch.finfo(torch.float32).eps) / 2.0


def gamma(n) -> float:
    """pbrt's conservative rounding bound gamma(n) (core/pbrt.h:409)."""
    return (n * MACHINE_EPSILON) / (1 - n * MACHINE_EPSILON)


def vec(x, y, z):
    return torch.stack(torch.broadcast_tensors(x, y, z), dim=-1)


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def absdot(a, b):
    return torch.abs(dot(a, b))


def cross(a, b):
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def length_squared(v):
    return dot(v, v)


def length(v):
    return torch.sqrt(length_squared(v))


def normalize(v):
    return v / torch.sqrt(torch.clamp(length_squared(v), min=1e-30))[..., None]


def distance_squared(p, q):
    return length_squared(p - q)


def xform_point(m, p):
    """Affine part of a [..., 4, 4] (or [..., 3, 4]) matrix applied to points."""
    return torch.stack(
        [
            m[..., i, 0] * p[..., 0] + m[..., i, 1] * p[..., 1]
            + m[..., i, 2] * p[..., 2] + m[..., i, 3]
            for i in range(3)
        ],
        dim=-1,
    )


def xform_vector(m, v):
    return torch.stack(
        [
            m[..., i, 0] * v[..., 0] + m[..., i, 1] * v[..., 1]
            + m[..., i, 2] * v[..., 2]
            for i in range(3)
        ],
        dim=-1,
    )


def xform_normal_w2o(w2o, n):
    """Normal transform by (M^-1)^T given world-to-object:
    n_world[i] = sum_j w2o[j, i] * n_obj[j] (transform.h:287-295)."""
    return torch.stack(
        [
            w2o[..., 0, i] * n[..., 0] + w2o[..., 1, i] * n[..., 1]
            + w2o[..., 2, i] * n[..., 2]
            for i in range(3)
        ],
        dim=-1,
    )


def component3(v, idx):
    """v[..., idx] for a per-lane axis index in {0, 1, 2}."""
    return torch.gather(v, -1, idx.long()[..., None])[..., 0]


def permute3(v, kx, ky, kz):
    return torch.stack(
        [component3(v, kx), component3(v, ky), component3(v, kz)], dim=-1
    )


def coordinate_system(v1):
    """Orthonormal basis around unit v1 (geometry.h:236 CoordinateSystem)."""
    x, y, z = v1[..., 0], v1[..., 1], v1[..., 2]
    c1 = torch.abs(x) > torch.abs(y)
    inv_a = 1.0 / torch.sqrt(
        torch.clamp(torch.where(c1, x * x + z * z, y * y + z * z), min=1e-30)
    )
    zero = torch.zeros_like(inv_a)
    v2 = torch.where(
        c1[..., None],
        vec(-z * inv_a, zero, x * inv_a),
        vec(zero, z * inv_a, -y * inv_a),
    )
    return v2, cross(v1, v2)


def spherical_direction_basis(sin_theta, cos_theta, phi, x, y, z):
    return (
        (sin_theta * torch.cos(phi))[..., None] * x
        + (sin_theta * torch.sin(phi))[..., None] * y
        + cos_theta[..., None] * z
    )


# ---- local shading frame (z = normal), reflection.h:50-102 ----

def cos_theta(w):
    return w[..., 2]


def cos2_theta(w):
    return w[..., 2] * w[..., 2]


def abs_cos_theta(w):
    return torch.abs(w[..., 2])


def sin2_theta(w):
    return torch.clamp(1.0 - cos2_theta(w), min=0.0)


def safe_sqrt(x):
    """sqrt with a zero gradient at x <= 0: the double where keeps sqrt'(0)
    = inf out of the backward pass (vecmath.py:188-192)."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def sin_theta(w):
    return safe_sqrt(sin2_theta(w))


def tan_theta(w):
    z = w[..., 2]
    bad = z == 0.0
    return torch.where(bad, math.inf, sin_theta(w) / torch.where(bad, 1.0, z))


def tan2_theta(w):
    c2 = cos2_theta(w)
    bad = c2 == 0.0
    return torch.where(bad, math.inf, sin2_theta(w) / torch.where(bad, 1.0, c2))


def cos_phi(w):
    s = sin_theta(w)
    return torch.where(
        s == 0.0, 1.0,
        torch.clamp(w[..., 0] / torch.clamp(s, min=1e-20), -1.0, 1.0),
    )


def sin_phi(w):
    s = sin_theta(w)
    return torch.where(
        s == 0.0, 0.0,
        torch.clamp(w[..., 1] / torch.clamp(s, min=1e-20), -1.0, 1.0),
    )


def same_hemisphere(w, wp):
    return w[..., 2] * wp[..., 2] > 0.0


def reflect(wo, n):
    return -wo + 2.0 * dot(wo, n)[..., None] * n


class _NudgeAway(torch.autograd.Function):
    """Round po one ulp away from the surface (geometry.h:1450-1457), with
    an identity derivative, as the JAX package's custom_jvp (vecmath.py:
    248-264): nextafter has no derivative in PyTorch before 2.13."""

    @staticmethod
    def forward(ctx, po, offset):
        up = torch.nextafter(po, torch.full_like(po, math.inf))
        down = torch.nextafter(po, torch.full_like(po, -math.inf))
        return torch.where(offset > 0.0, up, torch.where(offset < 0.0, down, po))

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def offset_ray_origin(p, p_error, n, w):
    """Robust ray-origin offset (geometry.h:1440 OffsetRayOrigin), with the
    final one-ulp nudge away from the surface."""
    dd = dot(torch.abs(n), p_error)
    offset = dd[..., None] * n
    offset = torch.where(dot(w, n)[..., None] < 0.0, -offset, offset)
    return _NudgeAway.apply(p + offset, offset)
