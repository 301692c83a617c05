"""Sphere intersection and geometry, port of the sphere parts of
pbrt_tpu/shapes/quadrics.py (Sphere::Intersect, sphere.cpp:70-236).

The discriminant is computed in double-single arithmetic (core/dsfloat.py),
as the JAX package does in place of pbrt's f64 refuge (efloat.h Quadratic).
Other quadric types are not part of this port yet: the scene builder refuses
them.
"""
from __future__ import annotations

import math

import torch

from ..core import dsfloat as ds
from ..core.vecmath import (dot, gamma, length, normalize, safe_acos,
                            xform_normal_w2o, xform_point, xform_vector)


def _quadratic(a, b, c):
    """Stable quadratic solve; returns (ok, t0, t1) with t0 <= t1."""
    dh, dl = ds.dd_discriminant(a, b, c)
    ok = ~((dh < 0.0) | ((dh == 0.0) & (dl < 0.0)))
    root = ds.dd_sqrt_to_f32(dh, dl)
    q = torch.where(b < 0.0, -0.5 * (b - root), -0.5 * (b + root))
    t0 = q / torch.where(a == 0.0, 1.0, a)
    t1 = c / torch.where(q == 0.0, 1.0, q)
    return ok, torch.minimum(t0, t1), torch.maximum(t0, t1)


def _safe_atan2(y, x):
    zero = (x == 0.0) & (y == 0.0)
    return torch.atan2(torch.where(zero, 0.0, y), torch.where(zero, 1.0, x))


def _phi(p):
    phi = _safe_atan2(p[..., 1], p[..., 0])
    return torch.where(phi < 0.0, phi + 2.0 * math.pi, phi)


def _z_ok(z, z_min, z_max, radius):
    lo = torch.where(z_min > -radius, z >= z_min, True)
    hi = torch.where(z_max < radius, z <= z_max, True)
    return lo & hi


def intersect_sphere_object(oo, od, t_max, radius, z_min, z_max, phi_max):
    """t-only sphere test with the ray already in object space (the
    traversal's quadric pass)."""
    a = dot(od, od)
    b = 2.0 * dot(oo, od)
    c = dot(oo, oo) - radius * radius
    ok, t0, t1 = _quadratic(a, b, c)

    def clip(t):
        p = oo + t[..., None] * od
        return _z_ok(p[..., 2], z_min, z_max, radius) & (_phi(p) <= phi_max)

    valid0 = ok & (t0 > 0.0) & (t0 < t_max) & clip(t0)
    valid1 = ok & (t1 > 0.0) & (t1 < t_max) & clip(t1)
    hit = valid0 | valid1
    t = torch.where(valid0, t0, t1)
    return {"hit": hit, "t": torch.where(hit, t, math.inf)}


def intersect_sphere(o, d, t_max, w2o, o2w, radius, z_min, z_max, phi_max):
    """Full Sphere::Intersect for hit_record: hit, t, p_hit, ng, uv and
    p_error, all in world space."""
    oo = xform_point(w2o, o)
    od = xform_vector(w2o, d)
    a = dot(od, od)
    b = 2.0 * dot(oo, od)
    c = dot(oo, oo) - radius * radius
    ok, t0, t1 = _quadratic(a, b, c)

    def clip_phi(p_hit):
        # Refine onto the surface (sphere.cpp:139).
        p_hit = p_hit * (radius / torch.clamp(length(p_hit), min=1e-20))[..., None]
        x = torch.where((p_hit[..., 0] == 0.0) & (p_hit[..., 1] == 0.0),
                        1e-5 * radius, p_hit[..., 0])
        p_hit = torch.cat([x[..., None], p_hit[..., 1:]], dim=-1)
        phi = _phi(p_hit)
        return p_hit, phi, _z_ok(p_hit[..., 2], z_min, z_max, radius) & (phi <= phi_max)

    p0, phi0, ok0 = clip_phi(oo + t0[..., None] * od)
    p1, phi1, ok1 = clip_phi(oo + t1[..., None] * od)
    valid0 = ok & (t0 > 0.0) & (t0 < t_max) & ok0
    valid1 = ok & (t1 > 0.0) & (t1 < t_max) & ok1
    hit = valid0 | valid1
    t = torch.where(valid0, t0, t1)
    p_hit = torch.where(valid0[..., None], p0, p1)
    phi = torch.where(valid0, phi0, phi1)

    u = phi / phi_max
    theta = safe_acos(p_hit[..., 2] / radius)  # the poles: acos' = -inf
    theta_min = torch.acos(torch.clamp(z_max / radius, -1.0, 1.0))
    theta_max = torch.acos(torch.clamp(z_min / radius, -1.0, 1.0))
    v = (theta - theta_min) / torch.clamp(theta_max - theta_min, min=1e-20)
    uv = torch.stack([u, v], dim=-1)

    p_err_obj = gamma(5) * torch.abs(p_hit)
    ng_obj = normalize(p_hit)
    p_world = xform_point(o2w, p_hit)
    ng_world = normalize(xform_normal_w2o(w2o, ng_obj))
    abs_m = torch.abs(o2w[..., :3, :3])
    abs_p = torch.abs(p_hit)
    p_err_world = (
        xform_vector(abs_m, p_err_obj)
        + gamma(3) * (xform_vector(abs_m, abs_p) + torch.abs(o2w[..., :3, 3]))
    )
    return {
        "hit": hit,
        "t": torch.where(hit, t, math.inf),
        "p_hit": p_world,
        "ng": ng_world,
        "uv": uv,
        "p_error": p_err_world,
    }
