"""The hair BSDF (Marschner's lobes in Chiang et al. 2016's parameters).

Port of pbrt_tpu/materials/hair.py (materials/hair.{h,cpp}, HairBSDF
hair.h:90-115): R, TT, TRT and the residual (P_MAX = 3), each the product
of the longitudinal Mp (variance from beta_m), the attenuation Ap
(Beer-Lambert through the fiber from sigma_a) and the azimuthal Np (a
trimmed logistic of scale from beta_n), elementwise over the batch.

pbrt's frame: the local x axis is the curve's tangent, so sin(theta) =
w.x and the azimuth lies in the (y, z) plane.  h in [-1, 1], the offset
across the fiber, comes from the hit's uv[1] (h = -1 + 2 v), on any shape,
as in the JAX package; pbrt gives HairMaterial a curve's v.
"""
from __future__ import annotations

import math

import torch

from ..core.vecmath import safe_asin, safe_atan2, safe_sqrt
from . import bsdf as bx

P_MAX = 3
SQRT_PI_OVER_8 = 0.626657069


def _i0(x):
    """The modified Bessel function I0 (hair.cpp I0): 10 series terms."""
    val = torch.zeros_like(x)
    x2i = torch.ones_like(x)
    ifact = 1.0
    i4 = 1.0
    for i in range(10):
        if i > 1:
            ifact *= i
        val = val + x2i / (i4 * ifact * ifact)
        x2i = x2i * x * x
        i4 *= 4.0
    return val


def _log_i0(x):
    big = x > 12.0
    safe = torch.clamp(x, max=12.0)
    return torch.where(
        big,
        x + 0.5 * (-math.log(2.0 * math.pi)
                   + torch.log(1.0 / torch.clamp(x, min=1e-6))
                   + 1.0 / torch.clamp(8.0 * x, min=1e-6)),
        torch.log(torch.clamp(_i0(safe), min=1e-30)))


def _mp(cos_ti, cos_to, sin_ti, sin_to, v):
    """Longitudinal scattering (hair.cpp Mp)."""
    a = cos_ti * cos_to / v
    b = sin_ti * sin_to / v
    mp_small = torch.exp(_log_i0(a) - b - 1.0 / v + 0.6931
                         + torch.log(1.0 / (2.0 * v)))
    mp_big = (torch.exp(-b) * _i0(a)) / torch.clamp(torch.sinh(1.0 / v) * 2.0 * v,
                                                     min=1e-30)
    return torch.where(v <= 0.1, mp_small, mp_big)


def _logistic(x, s):
    x = torch.abs(x)
    e = torch.exp(-x / s)
    return e / (s * (1.0 + e) ** 2)


def _logistic_cdf(x, s):
    return 1.0 / (1.0 + torch.exp(-x / s))


def _trimmed_logistic(x, s, a, b):
    return _logistic(x, s) / torch.clamp(_logistic_cdf(b, s) - _logistic_cdf(a, s),
                                         min=1e-12)


def _sample_trimmed_logistic(u, s, a, b):
    """The inverse CDF (hair.cpp SampleTrimmedLogistic)."""
    k = _logistic_cdf(b, s) - _logistic_cdf(a, s)
    x = -s * torch.log(1.0 / torch.clamp(u * k + _logistic_cdf(a, s), min=1e-12)
                       - 1.0)
    return torch.clamp(x, a, b)


def _phi_fn(p, gamma_o, gamma_t):
    return 2.0 * p * gamma_t - 2.0 * gamma_o + p * math.pi


def _np(phi, p, s, gamma_o, gamma_t):
    dphi = phi - _phi_fn(p, gamma_o, gamma_t)
    dphi = torch.remainder(dphi + math.pi, 2.0 * math.pi) - math.pi
    return _trimmed_logistic(dphi, s, -math.pi, math.pi)


def _geometry(mat, wo):
    """The per-lane quantities eval and sample share."""
    hp = mat["hair"]
    sigma_a = hp[:, 0:3]
    beta_m = hp[:, 3]
    beta_n = hp[:, 4]
    alpha = torch.deg2rad(hp[:, 5])
    eta = torch.full_like(beta_m, 1.55)
    h = torch.clamp(-1.0 + 2.0 * mat["uv"][:, 1], -1.0, 1.0)
    # longitudinal variances per lobe (hair.cpp:270-276)
    t = 0.726 * beta_m + 0.812 * beta_m ** 2 + 3.7 * beta_m ** 20
    v0 = t * t
    v = [v0, 0.25 * v0, 4.0 * v0, 4.0 * v0]
    s = SQRT_PI_OVER_8 * (0.265 * beta_n + 1.194 * beta_n ** 2
                          + 5.372 * beta_n ** 22)  # hair.cpp:282
    # the scales' tilt, sin and cos of 2^k alpha (hair.cpp:287-293)
    sin2k = [torch.sin(alpha)]
    cos2k = [safe_sqrt(1.0 - sin2k[0] ** 2)]
    for i in range(1, 3):
        sin2k.append(2.0 * cos2k[i - 1] * sin2k[i - 1])
        cos2k.append(cos2k[i - 1] ** 2 - sin2k[i - 1] ** 2)
    sin_to = wo[:, 0]
    cos_to = safe_sqrt(1.0 - sin_to * sin_to)
    phi_o = safe_atan2(wo[:, 2], wo[:, 1])
    gamma_o = safe_asin(h)
    # the refracted ray (hair.cpp:359-372)
    sin_tt = sin_to / eta
    cos_tt = safe_sqrt(1.0 - sin_tt * sin_tt)
    etap = (torch.sqrt(torch.clamp(eta * eta - sin_to * sin_to, min=1e-12))
            / torch.clamp(cos_to, min=1e-6))
    sin_gt = h / etap
    cos_gt = safe_sqrt(1.0 - sin_gt * sin_gt)
    gamma_t = safe_asin(sin_gt)
    # the transmittance through the fiber (hair.cpp:373)
    T = torch.exp(-sigma_a * (2.0 * cos_gt / torch.clamp(cos_tt, min=1e-6))[:, None])
    return dict(eta=eta, v=v, s=s, sin2k=sin2k, cos2k=cos2k, sin_to=sin_to,
                cos_to=cos_to, phi_o=phi_o, gamma_o=gamma_o, gamma_t=gamma_t, T=T)


def _ap(g):
    """The attenuation of each lobe (hair.cpp Ap): P_MAX + 1 of [n, 3]."""
    cos_theta_fr = g["cos_to"] * torch.cos(g["gamma_o"])
    f = bx.fresnel_dielectric(cos_theta_fr, torch.ones_like(g["eta"]),
                              g["eta"])[:, None]
    T = g["T"]
    ap = [f * torch.ones_like(T), (1.0 - f) ** 2 * T]
    for p in range(2, P_MAX):
        ap.append(ap[p - 1] * T * f)
    # the residual, the geometric series' remainder (hair.cpp:410)
    ap.append(ap[P_MAX - 1] * f * T / torch.clamp(1.0 - T * f, min=1e-4))
    return ap


def _lum(a):
    return 0.212671 * a[:, 0] + 0.715160 * a[:, 1] + 0.072169 * a[:, 2]


def _tilted_angles(g, p):
    """sin and |cos| of theta_o tilted by the scales for lobe p
    (hair.cpp:391-403)."""
    sin_to, cos_to = g["sin_to"], g["cos_to"]
    s2, c2 = g["sin2k"], g["cos2k"]
    if p == 0:
        sin_top = sin_to * c2[1] - cos_to * s2[1]
        cos_top = cos_to * c2[1] + sin_to * s2[1]
    elif p == 1:
        sin_top = sin_to * c2[0] + cos_to * s2[0]
        cos_top = cos_to * c2[0] - sin_to * s2[0]
    elif p == 2:
        sin_top = sin_to * c2[2] + cos_to * s2[2]
        cos_top = cos_to * c2[2] - sin_to * s2[2]
    else:
        sin_top, cos_top = sin_to, cos_to
    return sin_top, torch.abs(cos_top)


def hair_eval(mat, wo, wi):
    """HairBSDF::f and ::Pdf (hair.cpp:340-430, 625-664)."""
    g = _geometry(mat, wo)
    sin_ti = wi[:, 0]
    cos_ti = safe_sqrt(1.0 - sin_ti * sin_ti)
    phi = safe_atan2(wi[:, 2], wi[:, 1]) - g["phi_o"]
    ap = _ap(g)
    lums = [_lum(a) for a in ap]
    lum_sum = sum(lums)
    f = torch.zeros_like(wo)
    pdf = torch.zeros(wo.shape[0], dtype=torch.float32, device=wo.device)
    for p in range(P_MAX + 1):
        sin_top, cos_top = _tilted_angles(g, p)
        mp = _mp(cos_ti, cos_top, sin_ti, sin_top, g["v"][p])
        if p < P_MAX:
            np_ = _np(phi, p, g["s"], g["gamma_o"], g["gamma_t"])
        else:
            np_ = torch.full_like(mp, 1.0 / (2.0 * math.pi))
        f = f + mp[:, None] * ap[p] * np_[:, None]
        pdf = pdf + mp * (lums[p] / torch.clamp(lum_sum, min=1e-12)) * np_
    return f / torch.clamp(torch.abs(wi[:, 2]), min=1e-6)[:, None], pdf


def hair_sample(mat, wo, u2):
    """HairBSDF::Sample_f (hair.cpp:511-598), with the JAX package's reuse
    of the two uniforms: u2[0] picks the lobe and, remapped, theta; u2[1]
    gives the azimuth, and its fraction of 7 u2[1] the cone's angle."""
    g = _geometry(mat, wo)
    ap = _ap(g)
    lums = [_lum(a) for a in ap]
    lum_sum = torch.clamp(sum(lums), min=1e-12)
    u0 = u2[:, 0]
    cdf = torch.zeros_like(u0)
    p_choice = torch.full(u0.shape, P_MAX, dtype=torch.int32, device=u0.device)
    rem = u0
    for p in range(P_MAX + 1):
        w = lums[p] / lum_sum
        inside = (u0 >= cdf) & (u0 < cdf + w)
        if p < P_MAX:
            p_choice = torch.where(inside & (p_choice == P_MAX), p, p_choice)
        rem = torch.where(inside, (u0 - cdf) / torch.clamp(w, min=1e-12), rem)
        cdf = cdf + w
    u_theta = torch.clamp(rem, 1e-6, 1.0 - 1e-6)
    u_phi = u2[:, 1]

    # Mp of the chosen lobe (hair.cpp:540-554)
    sin_top = torch.zeros_like(u0)
    cos_top = torch.zeros_like(u0)
    vs = torch.zeros_like(u0)
    for p in range(P_MAX + 1):
        st, ct = _tilted_angles(g, p)
        m = p_choice == p
        sin_top = torch.where(m, st, sin_top)
        cos_top = torch.where(m, ct, cos_top)
        vs = torch.where(m, g["v"][p], vs)
    cos_theta = 1.0 + vs * torch.log(
        torch.clamp(u_theta + (1.0 - u_theta) * torch.exp(-2.0 / vs), min=1e-30))
    sin_theta = safe_sqrt(1.0 - cos_theta ** 2)
    cos_phi_r = torch.cos(2.0 * math.pi * torch.remainder(u_phi * 7.0, 1.0))
    sin_ti = -cos_theta * sin_top + sin_theta * cos_phi_r * cos_top
    cos_ti = safe_sqrt(1.0 - sin_ti * sin_ti)

    # Np (hair.cpp:560-570)
    dphi_lobe = torch.zeros_like(u0)
    for p in range(P_MAX):
        dphi_lobe = torch.where(p_choice == p,
                                _phi_fn(p, g["gamma_o"], g["gamma_t"]), dphi_lobe)
    sampled = _sample_trimmed_logistic(torch.clamp(u_phi, 1e-6, 1.0 - 1e-6),
                                       g["s"], -math.pi, math.pi)
    dphi = torch.where(p_choice < P_MAX, dphi_lobe + sampled,
                       2.0 * math.pi * u_phi)
    phi_i = g["phi_o"] + dphi
    wi = torch.stack([sin_ti, cos_ti * torch.cos(phi_i), cos_ti * torch.sin(phi_i)],
                     -1)
    f, pdf = hair_eval(mat, wo, wi)
    return {"wi": wi, "f": f, "pdf": pdf,
            "is_specular": torch.zeros(wo.shape[0], dtype=torch.bool,
                                       device=wo.device)}
