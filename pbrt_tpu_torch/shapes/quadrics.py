"""Quadric shapes: sphere, cylinder, disk, cone, paraboloid and hyperboloid.

Port of pbrt_tpu/shapes/quadrics.py (src/shapes/{sphere,cylinder,disk,cone,
paraboloid,hyperboloid}.cpp), operation for operation:

* ``intersect_<type>_object``: the t-only test with the ray already in
  object space, used by the traversal (the oracle's leaf step, the brute
  force pass of ops/bvh.py and the typed leaves of the bvh4 kernel, whose
  CUDA code repeats these operations in this order);
* ``intersect_<type>``: the full test with the world-space attributes
  (point, normal, uv, error bound) for hit_record.

The discriminant is computed in double-single arithmetic (core/dsfloat.py),
as the JAX package does in place of pbrt's f64 refuge (efloat.h Quadratic).
Each quadric's parameters ride in its q_params row: sphere, cylinder
(radius, z_min, z_max, phi_max), disk (radius, inner radius, height,
phi_max), cone (radius, height, phi_max), paraboloid (radius, z_min, z_max,
phi_max) and hyperboloid (ah, ch, z_min, z_max, phi_max, p1, p2), with ah
and ch solved on the host (scene.py add_hyperboloid).
"""
from __future__ import annotations

import math

import torch

from ..core import dsfloat as ds
from ..core.vecmath import (cross, dot, gamma, length, normalize, safe_acos,
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


def _sq(x):
    return x * x


def _roots_hit(ok, t0, t1, t_max, clip0, clip1):
    valid0 = ok & (t0 > 0.0) & (t0 < t_max) & clip0
    valid1 = ok & (t1 > 0.0) & (t1 < t_max) & clip1
    return valid0, valid0 | valid1


def _cylinder_roots(oo, od, radius):
    a = _sq(od[..., 0]) + _sq(od[..., 1])
    b = 2.0 * (od[..., 0] * oo[..., 0] + od[..., 1] * oo[..., 1])
    c = _sq(oo[..., 0]) + _sq(oo[..., 1]) - radius * radius
    return _quadratic(a, b, c)


def intersect_cylinder_object(oo, od, t_max, radius, z_min, z_max, phi_max):
    ok, t0, t1 = _cylinder_roots(oo, od, radius)

    def clip(t):
        p = oo + t[..., None] * od
        return (p[..., 2] >= z_min) & (p[..., 2] <= z_max) & (_phi(p) <= phi_max)

    valid0, hit = _roots_hit(ok, t0, t1, t_max, clip(t0), clip(t1))
    t = torch.where(valid0, t0, t1)
    return {"hit": hit, "t": torch.where(hit, t, math.inf)}


def intersect_disk_object(oo, od, t_max, radius, inner_radius, height, phi_max):
    dz = torch.where(od[..., 2] == 0.0, 1e-20, od[..., 2])
    t = (height - oo[..., 2]) / dz
    p = oo + t[..., None] * od
    dist2 = _sq(p[..., 0]) + _sq(p[..., 1])
    hit = ((od[..., 2] != 0.0) & (t > 0.0) & (t < t_max)
           & (dist2 <= radius * radius)
           & (dist2 >= inner_radius * inner_radius) & (_phi(p) <= phi_max))
    return {"hit": hit, "t": torch.where(hit, t, math.inf)}


def _cone_roots(oo, od, radius, height):
    k = _sq(radius / torch.where(height == 0.0, 1e-12, height))
    ozh = oo[..., 2] - height
    a = _sq(od[..., 0]) + _sq(od[..., 1]) - k * _sq(od[..., 2])
    b = 2.0 * (od[..., 0] * oo[..., 0] + od[..., 1] * oo[..., 1]
               - k * od[..., 2] * ozh)
    c = _sq(oo[..., 0]) + _sq(oo[..., 1]) - k * ozh * ozh
    return _quadratic(a, b, c)


def intersect_cone_object(oo, od, t_max, par):
    """Cone t-only test (cone.cpp:47-137); par [..., 12] its q_params."""
    radius, height, phi_max = par[..., 0], par[..., 1], par[..., 2]
    ok, t0, t1 = _cone_roots(oo, od, radius, height)

    def clip(t):
        p = oo + t[..., None] * od
        return (p[..., 2] >= 0.0) & (p[..., 2] <= height) & (_phi(p) <= phi_max)

    valid0, hit = _roots_hit(ok, t0, t1, t_max, clip(t0), clip(t1))
    t = torch.where(valid0, t0, t1)
    return {"hit": hit, "t": torch.where(hit, t, math.inf)}


def _paraboloid_roots(oo, od, radius, z_max):
    k = z_max / torch.clamp(radius * radius, min=1e-20)
    a = k * (_sq(od[..., 0]) + _sq(od[..., 1]))
    b = 2.0 * k * (od[..., 0] * oo[..., 0] + od[..., 1] * oo[..., 1]) - od[..., 2]
    c = k * (_sq(oo[..., 0]) + _sq(oo[..., 1])) - oo[..., 2]
    return _quadratic(a, b, c)


def intersect_paraboloid_object(oo, od, t_max, par):
    """Paraboloid t-only test (paraboloid.cpp:48-135)."""
    radius, z_min, z_max, phi_max = par[..., 0], par[..., 1], par[..., 2], par[..., 3]
    ok, t0, t1 = _paraboloid_roots(oo, od, radius, z_max)

    def clip(t):
        p = oo + t[..., None] * od
        return (p[..., 2] >= z_min) & (p[..., 2] <= z_max) & (_phi(p) <= phi_max)

    valid0, hit = _roots_hit(ok, t0, t1, t_max, clip(t0), clip(t1))
    t = torch.where(valid0, t0, t1)
    return {"hit": hit, "t": torch.where(hit, t, math.inf)}


def _hyperboloid_roots(oo, od, ah, ch):
    a = ah * (_sq(od[..., 0]) + _sq(od[..., 1])) - ch * _sq(od[..., 2])
    b = 2.0 * (ah * (od[..., 0] * oo[..., 0] + od[..., 1] * oo[..., 1])
               - ch * od[..., 2] * oo[..., 2])
    c = ah * (_sq(oo[..., 0]) + _sq(oo[..., 1])) - ch * _sq(oo[..., 2]) - 1.0
    return _quadratic(a, b, c)


def _hyperboloid_phi(p, par):
    """pbrt's phi: the angle of p about the profile point at its v
    (hyperboloid.cpp:122-130).  The degenerate profile z1 = z2 divides by
    1e-12."""
    z1, z2 = par[..., 7], par[..., 10]
    dz = z2 - z1
    v = (p[..., 2] - z1) / torch.where(torch.abs(dz) < 1e-12, 1e-12, dz)
    xr = (1.0 - v) * par[..., 5] + v * par[..., 8]
    yr = (1.0 - v) * par[..., 6] + v * par[..., 9]
    phi = _safe_atan2(p[..., 1] * xr - p[..., 0] * yr,
                      p[..., 0] * xr + p[..., 1] * yr)
    return torch.where(phi < 0.0, phi + 2.0 * math.pi, phi), v


def intersect_hyperboloid_object(oo, od, t_max, par):
    """Hyperboloid t-only test (hyperboloid.cpp:48-140)."""
    z_min, z_max, phi_max = par[..., 2], par[..., 3], par[..., 4]
    ok, t0, t1 = _hyperboloid_roots(oo, od, par[..., 0], par[..., 1])

    def clip(t):
        p = oo + t[..., None] * od
        phi, _ = _hyperboloid_phi(p, par)
        return (p[..., 2] >= z_min) & (p[..., 2] <= z_max) & (phi <= phi_max)

    valid0, hit = _roots_hit(ok, t0, t1, t_max, clip(t0), clip(t1))
    t = torch.where(valid0, t0, t1)
    return {"hit": hit, "t": torch.where(hit, t, math.inf)}


def intersect_object(qtype: int, oo, od, t_max, par):
    """The t-only test of quadric shape type `qtype` (scene.SHAPE_*, 1-6)
    with par [..., 12] its q_params."""
    if qtype in (1, 2, 3):
        fn = {1: intersect_sphere_object, 2: intersect_cylinder_object,
              3: intersect_disk_object}[qtype]
        return fn(oo, od, t_max, par[..., 0], par[..., 1], par[..., 2], par[..., 3])
    fn = {4: intersect_cone_object, 5: intersect_paraboloid_object,
          6: intersect_hyperboloid_object}[qtype]
    return fn(oo, od, t_max, par)


def _world_attrs(o2w, w2o, p_hit, ng_obj, err_scale):
    """Object-space hit to world point, normal and error bound."""
    p_world = xform_point(o2w, p_hit)
    ng_world = normalize(xform_normal_w2o(w2o, ng_obj))
    p_err_obj = err_scale * torch.abs(p_hit)
    abs_m = torch.abs(o2w[..., :3, :3])
    p_err_world = (xform_vector(abs_m, p_err_obj)
                   + gamma(3) * (xform_vector(abs_m, torch.abs(p_hit))
                                 + torch.abs(o2w[..., :3, 3])))
    return p_world, ng_world, p_err_world


def _record(hit, t, p_world, ng_world, u, v, p_err_world):
    return {"hit": hit, "t": torch.where(hit, t, math.inf), "p_hit": p_world,
            "ng": ng_world, "uv": torch.stack([u, v], dim=-1),
            "p_error": p_err_world}


def intersect_disk(o, d, t_max, w2o, o2w, radius, inner_radius, height, phi_max):
    """Disk::Intersect (disk.cpp:47-107)."""
    oo = xform_point(w2o, o)
    od = xform_vector(w2o, d)
    dz = torch.where(od[..., 2] == 0.0, 1e-20, od[..., 2])
    t = (height - oo[..., 2]) / dz
    p_hit = oo + t[..., None] * od
    dist2 = _sq(p_hit[..., 0]) + _sq(p_hit[..., 1])
    phi = _phi(p_hit)
    hit = ((od[..., 2] != 0.0) & (t > 0.0) & (t < t_max)
           & (dist2 <= radius * radius)
           & (dist2 >= inner_radius * inner_radius) & (phi <= phi_max))
    r_hit = torch.sqrt(torch.clamp(dist2, min=1e-20))
    u = phi / phi_max
    v = (radius - r_hit) / torch.clamp(radius - inner_radius, min=1e-20)
    ng_obj = torch.zeros_like(p_hit)
    ng_obj[..., 2] = 1.0
    return _record(hit, t, xform_point(o2w, p_hit),
                   normalize(xform_normal_w2o(w2o, ng_obj)), u, v,
                   torch.zeros_like(p_hit))


def intersect_cylinder(o, d, t_max, w2o, o2w, radius, z_min, z_max, phi_max):
    """Cylinder::Intersect (cylinder.cpp:47-156)."""
    oo = xform_point(w2o, o)
    od = xform_vector(w2o, d)
    ok, t0, t1 = _cylinder_roots(oo, od, radius)

    def clip(t):
        p = oo + t[..., None] * od
        hit_r = torch.sqrt(torch.clamp(_sq(p[..., 0]) + _sq(p[..., 1]), min=1e-20))
        s = radius / hit_r
        p = p * torch.stack([s, s, torch.ones_like(hit_r)], dim=-1)
        phi = _phi(p)
        return p, phi, (p[..., 2] >= z_min) & (p[..., 2] <= z_max) & (phi <= phi_max)

    p0, phi0, ok0 = clip(t0)
    p1, phi1, ok1 = clip(t1)
    valid0, hit = _roots_hit(ok, t0, t1, t_max, ok0, ok1)
    t = torch.where(valid0, t0, t1)
    p_hit = torch.where(valid0[..., None], p0, p1)
    phi = torch.where(valid0, phi0, phi1)
    u = phi / phi_max
    v = (p_hit[..., 2] - z_min) / torch.clamp(z_max - z_min, min=1e-20)
    zero = torch.zeros_like(phi)
    radial = torch.stack([p_hit[..., 0], p_hit[..., 1], zero], dim=-1)
    ng_world = normalize(xform_normal_w2o(w2o, normalize(radial)))
    p_err_obj = gamma(3) * torch.abs(radial)
    abs_m = torch.abs(o2w[..., :3, :3])
    p_err_world = (xform_vector(abs_m, p_err_obj)
                   + gamma(3) * (xform_vector(abs_m, torch.abs(p_hit))
                                 + torch.abs(o2w[..., :3, 3])))
    return _record(hit, t, xform_point(o2w, p_hit), ng_world, u, v, p_err_world)


def _roots_record(oo, od, t_max, ok, t0, t1, clip):
    """Shared selection of the nearer valid root for the records."""
    p0, phi0, v0, ok0 = clip(t0)
    p1, phi1, v1, ok1 = clip(t1)
    valid0, hit = _roots_hit(ok, t0, t1, t_max, ok0, ok1)
    return (hit, torch.where(valid0, t0, t1),
            torch.where(valid0[..., None], p0, p1),
            torch.where(valid0, phi0, phi1), torch.where(valid0, v0, v1))


def intersect_cone(o, d, t_max, w2o, o2w, par):
    """Cone::Intersect with attributes (cone.cpp:47-161)."""
    radius, height, phi_max = par[..., 0], par[..., 1], par[..., 2]
    oo = xform_point(w2o, o)
    od = xform_vector(w2o, d)
    ok, t0, t1 = _cone_roots(oo, od, radius, height)

    def clip(t):
        p = oo + t[..., None] * od
        phi = _phi(p)
        return p, phi, phi, (p[..., 2] >= 0.0) & (p[..., 2] <= height) & (phi <= phi_max)

    hit, t, p_hit, phi, _ = _roots_record(oo, od, t_max, ok, t0, t1, clip)
    u = phi / phi_max
    v = p_hit[..., 2] / height
    one_m_v = torch.clamp(1.0 - v, min=1e-6)
    zero = torch.zeros_like(phi)
    dpdu = torch.stack([-phi_max * p_hit[..., 1], phi_max * p_hit[..., 0], zero], -1)
    dpdv = torch.stack([-p_hit[..., 0] / one_m_v, -p_hit[..., 1] / one_m_v,
                        torch.broadcast_to(height, phi.shape)], -1)
    ng_obj = normalize(cross(dpdu, dpdv))
    p_w, ng_w, err_w = _world_attrs(o2w, w2o, p_hit, ng_obj, gamma(7))
    return _record(hit, t, p_w, ng_w, u, v, err_w)


def intersect_paraboloid(o, d, t_max, w2o, o2w, par):
    """Paraboloid::Intersect with attributes (paraboloid.cpp:48-158)."""
    radius, z_min, z_max, phi_max = par[..., 0], par[..., 1], par[..., 2], par[..., 3]
    oo = xform_point(w2o, o)
    od = xform_vector(w2o, d)
    ok, t0, t1 = _paraboloid_roots(oo, od, radius, z_max)

    def clip(t):
        p = oo + t[..., None] * od
        phi = _phi(p)
        return p, phi, phi, (p[..., 2] >= z_min) & (p[..., 2] <= z_max) & (phi <= phi_max)

    hit, t, p_hit, phi, _ = _roots_record(oo, od, t_max, ok, t0, t1, clip)
    u = phi / phi_max
    v = (p_hit[..., 2] - z_min) / torch.clamp(z_max - z_min, min=1e-20)
    z = p_hit[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-8, 1e-8, z)
    zero = torch.zeros_like(phi)
    dpdu = torch.stack([-phi_max * p_hit[..., 1], phi_max * p_hit[..., 0], zero], -1)
    dpdv = torch.stack([p_hit[..., 0] / (2.0 * z_safe), p_hit[..., 1] / (2.0 * z_safe),
                        torch.ones_like(phi)], -1) * (z_max - z_min)[..., None]
    ng_obj = normalize(cross(dpdu, dpdv))
    p_w, ng_w, err_w = _world_attrs(o2w, w2o, p_hit, ng_obj, gamma(9))
    return _record(hit, t, p_w, ng_w, u, v, err_w)


def intersect_hyperboloid(o, d, t_max, w2o, o2w, par):
    """Hyperboloid::Intersect with attributes (hyperboloid.cpp:48-167); the
    normal is the implicit gradient (ah x, ah y, -ch z), outward for ah > 0,
    as in the JAX package."""
    ah, ch = par[..., 0], par[..., 1]
    z_min, z_max, phi_max = par[..., 2], par[..., 3], par[..., 4]
    oo = xform_point(w2o, o)
    od = xform_vector(w2o, d)
    ok, t0, t1 = _hyperboloid_roots(oo, od, ah, ch)

    def clip(t):
        p = oo + t[..., None] * od
        phi, v = _hyperboloid_phi(p, par)
        return p, phi, v, (p[..., 2] >= z_min) & (p[..., 2] <= z_max) & (phi <= phi_max)

    hit, t, p_hit, phi, v = _roots_record(oo, od, t_max, ok, t0, t1, clip)
    u = phi / phi_max
    ng_obj = normalize(torch.stack([ah * p_hit[..., 0], ah * p_hit[..., 1],
                                    -ch * p_hit[..., 2]], -1))
    p_w, ng_w, err_w = _world_attrs(o2w, w2o, p_hit, ng_obj, gamma(9))
    return _record(hit, t, p_w, ng_w, u, v, err_w)


def intersect_record(qtype: int, o, d, t_max, w2o, o2w, par):
    """The full test of quadric shape type `qtype` (scene.SHAPE_*, 1-6)."""
    if qtype in (1, 2, 3):
        fn = {1: intersect_sphere, 2: intersect_cylinder, 3: intersect_disk}[qtype]
        return fn(o, d, t_max, w2o, o2w, par[..., 0], par[..., 1], par[..., 2],
                  par[..., 3])
    fn = {4: intersect_cone, 5: intersect_paraboloid, 6: intersect_hyperboloid}[qtype]
    return fn(o, d, t_max, w2o, o2w, par)
