"""Trowbridge-Reitz (GGX) microfacet distribution in the local shading frame.

Port of the Trowbridge-Reitz parts of pbrt_tpu/materials/microfacet.py
(microfacet.h:48-129, microfacet.cpp TrowbridgeReitzSample11 :238-290) with
the same grazing-angle guards.
"""
from __future__ import annotations

import math

import torch

from ..core.vecmath import (abs_cos_theta, cos2_theta, cos_phi, cos_theta, dot,
                            normalize, sin_phi, tan2_theta, tan_theta, vec)


def roughness_to_alpha(roughness):
    """TrowbridgeReitzDistribution::RoughnessToAlpha (microfacet.h:122)."""
    x = torch.log(torch.clamp(roughness, min=1e-3))
    return (1.62142 + 0.819955 * x + 0.1734 * x * x + 0.0171201 * x * x * x
            + 0.000640711 * x * x * x * x)


def tr_d(wh, ax, ay):
    t2 = tan2_theta(wh)
    fin = torch.isfinite(t2) & (t2 <= 1e12)
    t2 = torch.where(fin, t2, 0.0)
    c4 = torch.where(fin, cos2_theta(wh), 1.0) ** 2
    e = (cos_phi(wh) ** 2 / (ax * ax) + sin_phi(wh) ** 2 / (ay * ay)) * t2
    d = 1.0 / (math.pi * ax * ay * c4 * (1.0 + e) ** 2)
    return torch.where(fin, d, 0.0)


def tr_lambda(w, ax, ay):
    abs_tan = torch.abs(tan_theta(w))
    fin = torch.isfinite(abs_tan)
    abs_tan = torch.clamp(torch.where(fin, abs_tan, 0.0), max=1e12)
    alpha = torch.sqrt(torch.clamp(
        cos_phi(w) ** 2 * ax * ax + sin_phi(w) ** 2 * ay * ay, min=1e-14))
    a2t2 = (alpha * abs_tan) ** 2
    lam = (-1.0 + torch.sqrt(1.0 + a2t2)) / 2.0
    return torch.where(fin, lam, 0.0)


def tr_g1(w, ax, ay):
    return 1.0 / (1.0 + tr_lambda(w, ax, ay))


def tr_g(wo, wi, ax, ay):
    return 1.0 / (1.0 + tr_lambda(wo, ax, ay) + tr_lambda(wi, ax, ay))


def _tr_sample_11(cos_theta_in, u1, u2):
    """TrowbridgeReitzSample11 (microfacet.cpp:238)."""
    r = torch.sqrt(u1 / torch.clamp(1.0 - u1, min=1e-12))
    phi = 2.0 * math.pi * u2
    slope_x_n = r * torch.cos(phi)
    slope_y_n = r * torch.sin(phi)

    cos_t = torch.clamp(cos_theta_in, -0.9999999, 0.9999999)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    tan_t = sin_t / torch.where(cos_t == 0.0, 1e-12, cos_t)
    a = 1.0 / torch.where(tan_t == 0.0, 1e-12, tan_t)
    g1 = 2.0 / (1.0 + torch.sqrt(1.0 + 1.0 / torch.clamp(a * a, min=1e-20)))

    A = 2.0 * u1 / g1 - 1.0
    denom = A * A - 1.0
    tmp = 1.0 / torch.where(denom == 0.0, 1e-10, denom)
    tmp = torch.clamp(tmp, -1e10, 1e10)
    B = tan_t
    darg = B * B * tmp * tmp - (A * A - B * B) * tmp
    pos = darg > 0.0
    D = torch.where(pos, torch.sqrt(torch.where(pos, darg, 1.0)), 0.0)
    sx1 = B * tmp - D
    sx2 = B * tmp + D
    slope_x = torch.where(
        (A < 0.0) | (sx2 > 1.0 / torch.clamp(tan_t, min=1e-12)), sx1, sx2)

    s = torch.where(u2 > 0.5, 1.0, -1.0)
    u2r = torch.where(u2 > 0.5, 2.0 * (u2 - 0.5), 2.0 * (0.5 - u2))
    z = (u2r * (u2r * (u2r * 0.27385 - 0.73369) + 0.46341)) / (
        u2r * (u2r * (u2r * 0.093073 + 0.309420) - 1.000000) + 0.597999)
    slope_y = s * z * torch.sqrt(1.0 + slope_x * slope_x)

    near_normal = cos_theta_in > 0.9999
    return (torch.where(near_normal, slope_x_n, slope_x),
            torch.where(near_normal, slope_y_n, slope_y))


def tr_sample_wh_visible(wo, u, ax, ay):
    """TrowbridgeReitzSample (microfacet.cpp:292), visible normals."""
    flip = cos_theta(wo) < 0.0
    wo_f = torch.where(flip[..., None], -wo, wo)
    wi_str = normalize(vec(ax * wo_f[..., 0], ay * wo_f[..., 1], wo_f[..., 2]))
    sx, sy = _tr_sample_11(cos_theta(wi_str), u[..., 0], u[..., 1])
    cp = cos_phi(wi_str)
    sp = sin_phi(wi_str)
    tmp = cp * sx - sp * sy
    sy = sp * sx + cp * sy
    sx = ax * tmp
    sy = ay * sy
    wh = normalize(vec(-sx, -sy, torch.ones_like(sx)))
    return torch.where(flip[..., None], -wh, wh)


def tr_pdf_visible(wo, wh, ax, ay):
    """MicrofacetDistribution::Pdf with sampleVisibleArea (microfacet.cpp:336)."""
    return (tr_d(wh, ax, ay) * tr_g1(wo, ax, ay) * torch.abs(dot(wo, wh))
            / torch.clamp(abs_cos_theta(wo), min=1e-12))
