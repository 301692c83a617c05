"""Procedural cubic Bezier curves (flat, ribbon and cylinder): hair and fur.

Port of the procedural half of pbrt_tpu/shapes/curve.py (shapes/curve.cpp:
188-380).  pbrt intersects a curve by recursive subdivision against the ray;
the JAX package, and this port, replace the recursion with a fixed sweep of
2^K_LOG2 = 16 windows over each curve primitive's (u0, u1) range.  The
scene builder splits a curve until pbrt's refinement depth needs at most
K_LOG2 more levels (``split_curve_for_build``), and the sweep masks the
windows beyond each ray's own depth (the Log2 bit trick on ray-space
curvature, curve.cpp:217-230).  The leaf test (edge tests, the closest
point w, the width test, v from the edge function) is curve.cpp:294-339;
as in pbrt's recursion, a later (higher-u) passing window overwrites an
earlier one.

* ``curve_intersect(o, d, t_max, row)``: the test of one curve row per
  lane, with ``want_record`` the SurfaceInteraction pieces hit_record
  needs; the typed leaves of the bvh4 kernel (csrc/bvh4_traverse.cu)
  repeat its t-only part operation for operation;
* ``pack_curve_rows``, ``split_curve_for_build``, ``curve_prim_bounds``:
  the host side of SceneBuilder.add_curve.

The JAX package's round-1 tessellator (``tessellate_curves``) is not on its
render path and is not ported.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.vecmath import coordinate_system, cross, dot, safe_sqrt

CURVE_FLAT, CURVE_CYLINDER, CURVE_RIBBON = 0, 1, 2
CURVE_TYPES = {"flat": CURVE_FLAT, "cylinder": CURVE_CYLINDER,
               "ribbon": CURVE_RIBBON}
K_LOG2 = 4  # leaf windows per primitive test: 16
CURVE_ROW_W = 28  # cp(12) w0 w1 u0 u1 n0(3) n1(3) angle 1/sin(angle) type pad(3)
# 1.41421356237 * 6.0 in float64, as the JAX package folds it
_DEPTH_SCALE = 1.41421356237 * 6.0


def _lerp(t, a, b):
    return (1.0 - t) * a + t * b


def _blossom1(c0, c1, c2, c3, u0, u1, u2):
    """BlossomBezier (curve.cpp:44-50) on one component."""
    a0 = _lerp(u0, c0, c1)
    a1 = _lerp(u0, c1, c2)
    a2 = _lerp(u0, c2, c3)
    b0 = _lerp(u1, a0, a1)
    b1 = _lerp(u1, a1, a2)
    return _lerp(u2, b0, b1)


def _eval_bezier1(c0, c1, c2, c3, u):
    """EvalBezier's value and derivative on one component (curve.cpp:64-85)."""
    a0 = _lerp(u, c0, c1)
    a1 = _lerp(u, c1, c2)
    a2 = _lerp(u, c2, c3)
    b0 = _lerp(u, a0, a1)
    b1 = _lerp(u, a1, a2)
    return _lerp(u, b0, b1), 3.0 * (b1 - b0)


def _log2_pbrt(v):
    """pbrt's Log2Int rounded to nearest through the float's bits
    (curve.cpp:220); 0 below 1."""
    bits = v.contiguous().view(torch.int32)
    lg = (bits >> 23) - 127 + ((bits & (1 << 22)) != 0).to(torch.int32)
    return torch.where(v < 1.0, 0, lg)


def _box_miss(xs, mw, zmax):
    mx = torch.maximum(torch.maximum(xs[0], xs[1]), torch.maximum(xs[2], xs[3]))
    mn = torch.minimum(torch.minimum(xs[0], xs[1]), torch.minimum(xs[2], xs[3]))
    return (mx + 0.5 * mw < 0.0) | (mn - 0.5 * mw > zmax)


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def ray_frame(o, d, row):
    """The ray's coordinate system of curve.cpp:160-175: (right, newup),
    with d as the third axis.  The JAX package's up is cross(d, p3 - p0),
    or a CoordinateSystem vector of d when that is degenerate."""
    span = row[..., 9:12] - row[..., 0:3]
    up0 = cross(d, span)
    deg = dot(up0, up0) < 1e-20
    fb, _ = coordinate_system(d)
    up = torch.where(deg[..., None], fb, up0)
    upl = torch.sqrt(torch.clamp(dot(up, up), min=1e-30))[..., None]
    right0 = cross(up / upl, d)
    rl = torch.sqrt(torch.clamp(dot(right0, right0), min=1e-30))[..., None]
    right = right0 / rl
    return right, cross(d, right), span


def curve_intersect(o, d, t_max, row, want_record: bool = False):
    """Curve::Intersect of one curve row per lane.  o, d [N, 3] (d unit),
    t_max [N], row [N, CURVE_ROW_W] (world-space control points).  Returns
    {"hit", "t", "windows"} (windows: the windows the ray's depth keeps, 0
    where it misses the primitive's box) and, with want_record, p_hit,
    p_error, ng, dpdu, dpdv and uv (curve.cpp:340-370)."""
    cp = [row[..., 3 * i:3 * i + 3] for i in range(4)]
    w0, w1 = row[..., 12], row[..., 13]
    u0g, u1g = row[..., 14], row[..., 15]
    n0, n1 = row[..., 16:19], row[..., 19:22]
    norm_angle, inv_sin_na = row[..., 22], row[..., 23]
    ctype = row[..., 24].to(torch.int32)
    right, newup, span = ray_frame(o, d, row)

    cx, cy, cz = [], [], []
    for i in range(4):
        q = cp[i] - o
        cx.append(dot(right, q))
        cy.append(dot(newup, q))
        cz.append(dot(d, q))

    zmax = t_max  # d is a unit vector: rayLength is 1
    max_width = torch.maximum(_lerp(u0g, w0, w1), _lerp(u1g, w0, w1))
    prim_miss = (_box_miss(cy, max_width, 0.0) | _box_miss(cx, max_width, 0.0)
                 | _box_miss(cz, max_width, zmax))

    # the ray's refinement depth (curve.cpp:207-230)
    l0 = torch.zeros_like(w0)
    for i in range(2):
        l0 = torch.maximum(l0, torch.maximum(torch.maximum(
            torch.abs(cx[i] - 2.0 * cx[i + 1] + cx[i + 2]),
            torch.abs(cy[i] - 2.0 * cy[i + 1] + cy[i + 2])),
            torch.abs(cz[i] - 2.0 * cz[i + 1] + cz[i + 2])))
    eps = torch.maximum(w0, w1) * 0.05
    r0 = torch.div(_log2_pbrt(_DEPTH_SCALE * l0 / (8.0 * torch.clamp(eps, min=1e-20))),
                   2, rounding_mode="floor")
    d_eff = torch.clamp(torch.clamp(r0, 0, 10), max=K_LOG2).to(torch.int32)
    stride = torch.bitwise_left_shift(torch.ones_like(d_eff), K_LOG2 - d_eff)
    stride_f = stride.to(torch.float32)
    inv_k = 1.0 / (1 << K_LOG2)
    is_ribbon = ctype == CURVE_RIBBON
    small = norm_angle < 1e-6

    hit = torch.zeros(w0.shape, dtype=torch.bool, device=w0.device)
    t_out = torch.zeros_like(w0)
    u_out = torch.zeros_like(w0)
    v_out = torch.zeros_like(w0)
    nhit_out = torch.zeros_like(n0)
    windows = range(1 << K_LOG2)
    if not want_record:
        # the traversal's test: no window of a lane that misses the
        # primitive's box is read, and a window no lane keeps is skipped
        # (one host read of the lanes' smallest stride); the same results
        keep = ~prim_miss
        if not bool(keep.any()):
            windows = range(0)
        else:
            windows = range(0, 1 << K_LOG2, int(stride[keep].min()))
    for wdx in windows:
        active = (wdx & (stride - 1)) == 0
        s0 = wdx * inv_k
        s1 = s0 + stride_f * inv_k
        knots = ((s0, s0, s0), (s0, s0, s1), (s0, s1, s1), (s1, s1, s1))
        qx = [_blossom1(*cx, a, b, c) for a, b, c in knots]
        qy = [_blossom1(*cy, a, b, c) for a, b, c in knots]
        qz = [_blossom1(*cz, a, b, c) for a, b, c in knots]
        uw0 = _lerp(s0, u0g, u1g)
        uw1 = _lerp(torch.clamp(s1, max=1.0), u0g, u1g)
        mw = torch.maximum(_lerp(uw0, w0, w1), _lerp(uw1, w0, w1))
        cull = (_box_miss(qy, mw, 0.0) | _box_miss(qx, mw, 0.0)
                | _box_miss(qz, mw, zmax))
        # the leaf test (curve.cpp:294-339)
        edge0 = (qy[1] - qy[0]) * (-qy[0]) + qx[0] * (qx[0] - qx[1])
        edge1 = (qy[2] - qy[3]) * (-qy[3]) + qx[3] * (qx[3] - qx[2])
        sdx = qx[3] - qx[0]
        sdy = qy[3] - qy[0]
        denom = sdx * sdx + sdy * sdy
        wseg = (-(qx[0]) * sdx + (-(qy[0])) * sdy) / torch.where(denom == 0.0, 1.0, denom)
        u_hit = _clip(_lerp(wseg, uw0, uw1), uw0, uw1)
        hit_width = _lerp(u_hit, w0, w1)
        # the ribbon's orientation (curve.cpp:311-318); parallel end
        # normals lerp
        sin0 = torch.sin((1.0 - u_hit) * norm_angle) * inv_sin_na
        sin1 = torch.sin(u_hit * norm_angle) * inv_sin_na
        nhit_r = torch.where(small[..., None], _lerp(u_hit[..., None], n0, n1),
                             sin0[..., None] * n0 + sin1[..., None] * n1)
        hit_width = torch.where(is_ribbon, hit_width * torch.abs(dot(nhit_r, d)),
                                hit_width)
        wc = torch.clamp(wseg, 0.0, 1.0)
        pcx, dxw = _eval_bezier1(*qx, wc)
        pcy, dyw = _eval_bezier1(*qy, wc)
        pcz, _ = _eval_bezier1(*qz, wc)
        dist2 = pcx * pcx + pcy * pcy
        ok = (active & ~cull & (edge0 >= 0.0) & (edge1 >= 0.0) & (denom != 0.0)
              & (dist2 <= hit_width * hit_width * 0.25) & (pcz >= 0.0)
              & (pcz <= zmax))
        dist = safe_sqrt(dist2)  # sqrt(max(dist2, 0)), finite derivative at 0
        edge_f = dxw * (-pcy) + pcx * dyw
        hw = torch.clamp(hit_width, min=1e-20)
        v = torch.where(edge_f > 0.0, 0.5 + dist / hw, 0.5 - dist / hw)
        hit = hit | ok
        t_out = torch.where(ok, pcz, t_out)
        u_out = torch.where(ok, u_hit, u_out)
        v_out = torch.where(ok, v, v_out)
        nhit_out = torch.where(ok[..., None], nhit_r, nhit_out)

    hit = hit & ~prim_miss
    out = {"hit": hit, "t": torch.where(hit, t_out, math.inf),
           "windows": torch.where(prim_miss, 0, (1 << K_LOG2) // stride).to(torch.int64)}
    if not want_record:
        return out

    # the SurfaceInteraction pieces (curve.cpp:340-370): dpdu of the
    # primitive's sub-curve at its local s (the JAX package's direction;
    # hit_record normalises it)
    u = u_out
    s_loc = torch.where(u1g > u0g, (u - u0g) / torch.clamp(u1g - u0g, min=1e-20), 0.0)
    dpdu = torch.stack([_eval_bezier1(*(cp[i][..., c] for i in range(4)), s_loc)[1]
                        for c in range(3)], -1)
    dpdu = torch.where((dot(dpdu, dpdu) < 1e-24)[..., None], span, dpdu)
    hw = _lerp(u, w0, w1)
    hw = torch.where(is_ribbon, hw * torch.abs(dot(nhit_out, d)), hw)
    # flat and cylinder: dpdv in the ray's plane, the cylinder's rotated
    # by -theta about dpdu (curve.cpp:355-366)
    dpdu_px = dot(right, dpdu)
    dpdu_py = dot(newup, dpdu)
    dpl = torch.sqrt(torch.clamp(dpdu_px * dpdu_px + dpdu_py * dpdu_py, min=1e-30))
    dvx = -dpdu_py / dpl
    dvy = dpdu_px / dpl
    theta = _lerp(v_out, -90.0, 90.0) * (math.pi / 180.0)
    is_cyl = ctype == CURVE_CYLINDER
    axx = dpdu_px / dpl
    axy = dpdu_py / dpl
    ct = torch.cos(-theta)
    st = torch.sin(-theta)
    czc = (axx * dvy - axy * dvx) * st
    rvx = torch.where(is_cyl, dvx * ct, dvx)
    rvy = torch.where(is_cyl, dvy * ct, dvy)
    rvz = torch.where(is_cyl, czc, torch.zeros_like(ct))
    dpdv_plane = (rvx[..., None] * right + rvy[..., None] * newup
                  + rvz[..., None] * d) * hw[..., None]
    # the ribbon's dpdv (curve.cpp:352-353)
    rib_dv = cross(nhit_out, dpdu)
    rl2 = torch.sqrt(torch.clamp(dot(rib_dv, rib_dv), min=1e-30))[..., None]
    dpdv = torch.where(is_ribbon[..., None], rib_dv / rl2 * hw[..., None], dpdv_plane)
    p_hit = o + t_out[..., None] * d
    ng_raw = cross(dpdu, dpdv)
    ngl = torch.sqrt(torch.clamp(dot(ng_raw, ng_raw), min=1e-30))[..., None]
    out.update(p_hit=p_hit,
               p_error=torch.broadcast_to((2.0 * hw)[..., None], p_hit.shape),
               ng=ng_raw / ngl, dpdu=dpdu, dpdv=dpdv,
               uv=torch.stack([u, v_out], -1))
    return out


# ---------------------------------------------------------------------------
# The host side (numpy)
# ---------------------------------------------------------------------------

def blossom_cps(c, s0, s1):
    """The control points of the cubic c [4, 3] over [s0, s1] (float64):
    [4, 3], or [K, 4, 3] for arrays s0, s1 [K] (the same operations on
    each range)."""
    s0 = np.asarray(s0, np.float64)[..., None]
    s1 = np.asarray(s1, np.float64)[..., None]

    def bl(a, b, cc):
        a0 = c[0] * (1 - a) + c[1] * a
        a1 = c[1] * (1 - a) + c[2] * a
        a2 = c[2] * (1 - a) + c[3] * a
        b0 = a0 * (1 - b) + a1 * b
        b1 = a1 * (1 - b) + a2 * b
        return b0 * (1 - cc) + b1 * cc

    return np.stack([bl(s0, s0, s0), bl(s0, s0, s1), bl(s0, s1, s1),
                     bl(s1, s1, s1)], -2)


def pack_curve_rows(cp, w0, w1, u0, u1, ctype, n0=None, n1=None):
    """Rows of curve_packed [C, CURVE_ROW_W]."""
    cp = np.asarray(cp, np.float32).reshape(-1, 12)
    rows = np.zeros((cp.shape[0], CURVE_ROW_W), np.float32)
    rows[:, 0:12] = cp
    rows[:, 12] = w0
    rows[:, 13] = w1
    rows[:, 14] = u0
    rows[:, 15] = u1
    if n0 is not None:
        n0 = np.asarray(n0, np.float32).reshape(-1, 3)
        n1 = np.asarray(n1, np.float32).reshape(-1, 3)
        n0 = n0 / np.maximum(np.linalg.norm(n0, axis=-1, keepdims=True), 1e-12)
        n1 = n1 / np.maximum(np.linalg.norm(n1, axis=-1, keepdims=True), 1e-12)
        rows[:, 16:19] = n0
        rows[:, 19:22] = n1
        ang = np.arccos(np.clip(np.sum(n0 * n1, -1), 0.0, 1.0))
        rows[:, 22] = ang
        with np.errstate(divide="ignore"):
            rows[:, 23] = np.where(ang > 1e-6, 1.0 / np.sin(ang), 0.0)
    rows[:, 24] = ctype
    return rows


def curve_build_depth(cp) -> float:
    """The largest 2-norm second difference of the control points, the
    upper bound over rotations of the per-ray refinement formula's l0."""
    cp = np.asarray(cp, np.float64).reshape(4, 3)
    return max(float(np.linalg.norm(cp[i] - 2 * cp[i + 1] + cp[i + 2]))
               for i in range(2))


def split_curve_for_build(cp, w0, w1, u0=0.0, u1=1.0, max_extra=6):
    """Split (cp, [u0, u1]) in halves until the conservative depth fits
    K_LOG2 (at most max_extra times).  Returns [(cp12 f32, u0, u1)]."""
    out = []

    def rec(c, a, b, extra):
        l0 = curve_build_depth(c)
        eps = max(w0, w1) * 0.05
        if l0 <= 0 or eps <= 0:
            depth = 0
        else:
            depth = max(0, round(math.log2(1.41421356237 * 6.0 * l0 / (8.0 * eps)))) // 2
        if depth <= K_LOG2 or extra <= 0:
            out.append((c.reshape(12).astype(np.float32), a, b))
            return
        mid = 0.5 * (a + b)
        rec(blossom_cps(c, 0.0, 0.5), a, mid, extra - 1)
        rec(blossom_cps(c, 0.5, 1.0), mid, b, extra - 1)

    rec(np.asarray(cp, np.float64).reshape(4, 3), float(u0), float(u1), max_extra)
    return out


def curve_prim_bounds(cp12, u0, u1, w0, w1):
    """Curve::ObjectBound (curve.cpp:123-135): the segment's control-point
    box grown by half its largest width."""
    c = np.asarray(cp12, np.float32).reshape(4, 3)
    mw = 0.5 * max((1 - u0) * w0 + u0 * w1, (1 - u1) * w0 + u1 * w1)
    return c.min(0) - mw, c.max(0) + mw
