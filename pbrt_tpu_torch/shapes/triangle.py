"""Watertight ray-triangle intersection, batched.

Port of pbrt_tpu/shapes/triangle.py (Triangle::Intersect, triangle.cpp:
188-430): translate to the ray origin, permute so z is the largest |d|
component, shear, signed edge functions with the exact double-single
fallback, the scaled depth test and the gamma()-bounded error estimate.
"""
from __future__ import annotations

import math

import torch

from ..core import dsfloat as ds
from ..core.vecmath import coordinate_system, cross, gamma, normalize, permute3

GAMMA2 = gamma(2)
GAMMA3 = gamma(3)
GAMMA5 = gamma(5)
GAMMA7 = gamma(7)


def _max_dimension(v):
    ax = torch.abs(v)
    return torch.where(
        ax[..., 0] > ax[..., 1],
        torch.where(ax[..., 0] > ax[..., 2], 0, 2),
        torch.where(ax[..., 1] > ax[..., 2], 1, 2),
    )


def intersect_triangle(o, d, t_max, p0, p1, p2):
    """Watertight test of each ray against its own triangle.  Returns a dict
    with hit, t (inf on a miss), b0, b1, b2, p_hit, p_error."""
    p0t = p0 - o
    p1t = p1 - o
    p2t = p2 - o
    kz = _max_dimension(d)
    kx = (kz + 1) % 3
    ky = (kx + 1) % 3
    dt = permute3(d, kx, ky, kz)
    p0t = permute3(p0t, kx, ky, kz)
    p1t = permute3(p1t, kx, ky, kz)
    p2t = permute3(p2t, kx, ky, kz)

    dz = dt[..., 2]
    degen = dz == 0.0
    inv_dz = 1.0 / torch.where(degen, 1.0, dz)
    sx = -dt[..., 0] * inv_dz
    sy = -dt[..., 1] * inv_dz
    sz = inv_dz
    p0x = p0t[..., 0] + sx * p0t[..., 2]
    p0y = p0t[..., 1] + sy * p0t[..., 2]
    p1x = p1t[..., 0] + sx * p1t[..., 2]
    p1y = p1t[..., 1] + sy * p1t[..., 2]
    p2x = p2t[..., 0] + sx * p2t[..., 2]
    p2y = p2t[..., 1] + sy * p2t[..., 2]

    e0 = p1x * p2y - p1y * p2x
    e1 = p2x * p0y - p2y * p0x
    e2 = p0x * p1y - p0y * p1x
    any_zero = (e0 == 0.0) | (e1 == 0.0) | (e2 == 0.0)
    e0 = torch.where(any_zero, ds.dd_cross2_f32(p1x, p1y, p2x, p2y), e0)
    e1 = torch.where(any_zero, ds.dd_cross2_f32(p2x, p2y, p0x, p0y), e1)
    e2 = torch.where(any_zero, ds.dd_cross2_f32(p0x, p0y, p1x, p1y), e2)

    has_neg = (e0 < 0) | (e1 < 0) | (e2 < 0)
    has_pos = (e0 > 0) | (e1 > 0) | (e2 > 0)
    det = e0 + e1 + e2
    miss_sign = has_neg & has_pos
    miss_det = det == 0.0

    p0z = p0t[..., 2] * sz
    p1z = p1t[..., 2] * sz
    p2z = p2t[..., 2] * sz
    t_scaled = e0 * p0z + e1 * p1z + e2 * p2z
    neg_det = det < 0.0
    miss_range = torch.where(
        neg_det,
        (t_scaled >= 0.0) | (t_scaled < t_max * det),
        (t_scaled <= 0.0) | (t_scaled > t_max * det),
    )
    inv_det = 1.0 / torch.where(miss_det, 1.0, det)
    b0 = e0 * inv_det
    b1 = e1 * inv_det
    b2 = e2 * inv_det
    t = t_scaled * inv_det

    max_zt = torch.maximum(torch.maximum(torch.abs(p0z), torch.abs(p1z)),
                           torch.abs(p2z))
    delta_z = GAMMA3 * max_zt
    max_xt = torch.maximum(torch.maximum(torch.abs(p0x), torch.abs(p1x)),
                           torch.abs(p2x))
    max_yt = torch.maximum(torch.maximum(torch.abs(p0y), torch.abs(p1y)),
                           torch.abs(p2y))
    delta_x = GAMMA5 * (max_xt + max_zt)
    delta_y = GAMMA5 * (max_yt + max_zt)
    delta_e = 2.0 * (GAMMA2 * max_xt * max_yt + delta_y * max_xt
                     + delta_x * max_yt)
    max_e = torch.maximum(torch.maximum(torch.abs(e0), torch.abs(e1)),
                          torch.abs(e2))
    delta_t = 3.0 * (GAMMA3 * max_e * max_zt + delta_e * max_zt
                     + delta_z * max_e) * torch.abs(inv_det)
    miss_eps = t <= delta_t

    hit = ~(miss_sign | miss_det | miss_range | miss_eps | degen)
    p_hit = b0[..., None] * p0 + b1[..., None] * p1 + b2[..., None] * p2
    x_abs = (torch.abs(b0[..., None] * p0) + torch.abs(b1[..., None] * p1)
             + torch.abs(b2[..., None] * p2))
    return {
        "hit": hit,
        "t": torch.where(hit, t, math.inf),
        "b0": b0,
        "b1": b1,
        "b2": b2,
        "p_hit": p_hit,
        "p_error": GAMMA7 * x_abs,
    }


def triangle_geometry(p0, p1, p2, uv0, uv1, uv2):
    """dpdu, dpdv and the geometric normal from the uv parameterisation
    (triangle.cpp:309-334).  Returns (ng, dpdu, dpdv)."""
    duv02 = uv0 - uv2
    duv12 = uv1 - uv2
    dp02 = p0 - p2
    dp12 = p1 - p2
    det = duv02[..., 0] * duv12[..., 1] - duv02[..., 1] * duv12[..., 0]
    degenerate = torch.abs(det) < 1e-8
    inv_det = 1.0 / torch.where(degenerate, 1.0, det)
    dpdu = (duv12[..., 1:2] * dp02 - duv02[..., 1:2] * dp12) * inv_det[..., None]
    dpdv = (-duv12[..., 0:1] * dp02 + duv02[..., 0:1] * dp12) * inv_det[..., None]
    ng = normalize(cross(dp02, dp12))
    t_fb, b_fb = coordinate_system(ng)
    dpdu = torch.where(degenerate[..., None], t_fb, dpdu)
    dpdv = torch.where(degenerate[..., None], b_fb, dpdv)
    return ng, dpdu, dpdv
