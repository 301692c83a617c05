"""BSDF lobes for matte, plastic and mirror, with pbrt's mixture sampling.

Port of the matte / plastic / mirror parts of pbrt_tpu/materials/bsdf.py
(reflection.{h,cpp}, materials/{matte,plastic,mirror}.cpp).  Lobes work in
the local shading frame (z = shading normal); a material is a dict of
per-lane parameters gathered from the MaterialTable.
"""
from __future__ import annotations

import torch

from ..core import sampling as smp
from ..core.sampling import INV_PI
from ..core.vecmath import (abs_cos_theta, cos_phi, coordinate_system,
                            cos_theta, cross, dot, normalize, reflect,
                            safe_sqrt, same_hemisphere, sin_phi, sin_theta, vec)
from ..scene import MAT_MATTE, MAT_MIRROR, MAT_PLASTIC
from . import microfacet as mf


# ---- shading frame ----

def make_frame(ns, dpdu):
    """BSDF ctor (reflection.h:166): ss = normalize(dpdu), ts = ns x ss."""
    ss_len = torch.sqrt(dot(dpdu, dpdu))[..., None]
    fb, _ = coordinate_system(ns)
    ss = torch.where(ss_len > 1e-12, dpdu / torch.clamp(ss_len, min=1e-20), fb)
    return ss, cross(ns, ss), ns


def frame_from_rec(rec):
    return make_frame(rec["ns"], rec["ss"])


def to_local(ss, ts, ns, v):
    return torch.stack([dot(v, ss), dot(v, ts), dot(v, ns)], dim=-1)


def to_world(ss, ts, ns, v):
    return v[..., 0:1] * ss + v[..., 1:2] * ts + v[..., 2:3] * ns


# ---- Fresnel and lobes ----

def fresnel_dielectric(cos_theta_i, eta_i, eta_t):
    """FrDielectric (reflection.cpp:47) for scalar eta_i, eta_t."""
    ci = torch.clamp(cos_theta_i, -1.0, 1.0)
    entering = ci > 0.0
    ei = torch.where(entering, eta_i, eta_t)
    et = torch.where(entering, eta_t, eta_i)
    ci = torch.abs(ci)
    si = safe_sqrt(1.0 - ci * ci)
    st = ei / et * si
    tir = st >= 1.0
    ct = safe_sqrt(1.0 - st * st)
    r_parl = (et * ci - ei * ct) / torch.clamp(et * ci + ei * ct, min=1e-12)
    r_perp = (ei * ci - et * ct) / torch.clamp(ei * ci + et * ct, min=1e-12)
    fr = 0.5 * (r_parl * r_parl + r_perp * r_perp)
    return torch.where(tir, 1.0, fr)


def oren_nayar_f(kd, sigma_deg, wo, wi):
    """OrenNayar::f (reflection.cpp:197); sigma = 0 is Lambertian kd/pi."""
    sigma = torch.deg2rad(sigma_deg)
    s2 = sigma * sigma
    A = 1.0 - s2 / (2.0 * (s2 + 0.33))
    B = 0.45 * s2 / (s2 + 0.09)
    sin_ti = sin_theta(wi)
    sin_to = sin_theta(wo)
    max_cos = torch.clamp(cos_phi(wi) * cos_phi(wo) + sin_phi(wi) * sin_phi(wo),
                          min=0.0)
    abs_ci = abs_cos_theta(wi)
    abs_co = abs_cos_theta(wo)
    sin_alpha = torch.where(abs_ci > abs_co, sin_to, sin_ti)
    tan_beta = torch.where(abs_ci > abs_co,
                           sin_ti / torch.clamp(abs_ci, min=1e-12),
                           sin_to / torch.clamp(abs_co, min=1e-12))
    return kd * (INV_PI * (A + B * max_cos * sin_alpha * tan_beta))[..., None]


def _cosine_sample_wi(wo, u):
    wi = smp.cosine_sample_hemisphere(u)
    flip = torch.tensor([1.0, 1.0, -1.0], device=wi.device)
    return torch.where((cos_theta(wo) < 0.0)[..., None], wi * flip, wi)


def cosine_pdf(wo, wi):
    return torch.where(same_hemisphere(wo, wi), abs_cos_theta(wi) * INV_PI, 0.0)


def microfacet_reflection_f(R, ax, ay, wo, wi, fresnel_fn):
    co = abs_cos_theta(wo)
    ci = abs_cos_theta(wi)
    wh = wi + wo
    degenerate = (ci < 1e-8) | (co < 1e-8) | (dot(wh, wh) < 1e-16)
    ci_s = torch.where(degenerate, 1.0, ci)
    co_s = torch.where(degenerate, 1.0, co)
    z = torch.tensor([0.0, 0.0, 1.0], device=wo.device)
    wh = normalize(torch.where(degenerate[..., None], z, wh))
    whf = torch.where((wh[..., 2] < 0.0)[..., None], -wh, wh)
    F = fresnel_fn(dot(wi, whf))
    d = mf.tr_d(wh, ax, ay)
    g = mf.tr_g(wo, wi, ax, ay)
    f = R * F * (d * g / torch.clamp(4.0 * ci_s * co_s, min=1e-12))[..., None]
    return torch.where((degenerate | ~same_hemisphere(wo, wi))[..., None], 0.0, f)


def microfacet_reflection_pdf(ax, ay, wo, wi):
    wh_r = wo + wi
    degen = dot(wh_r, wh_r) < 1e-16
    z = torch.tensor([0.0, 0.0, 1.0], device=wo.device)
    wh = normalize(torch.where(degen[..., None], z, wh_r))
    pdf = mf.tr_pdf_visible(wo, wh, ax, ay) / torch.clamp(4.0 * dot(wo, wh),
                                                          min=1e-12)
    return torch.where(~degen & same_hemisphere(wo, wi), pdf, 0.0)


def microfacet_reflection_sample(ax, ay, wo, u):
    """Returns (wi, raw map pdf)."""
    wh = mf.tr_sample_wh_visible(wo, u, ax, ay)
    wi = reflect(wo, wh)
    pdf = mf.tr_pdf_visible(wo, wh, ax, ay) / torch.clamp(4.0 * dot(wo, wh),
                                                          min=1e-12)
    return wi, torch.where(dot(wo, wh) > 0.0, pdf, 0.0)


def _plastic_fresnel(c):
    # pbrt's plastic constructs FresnelDielectric(1.5, 1.0) (plastic.cpp:59).
    return fresnel_dielectric(c, 1.5, 1.0)[..., None]


# ---- material dispatch ----

def count_nonspecular(mat):
    """BSDF::NumComponents(BSDF_ALL & ~BSDF_SPECULAR) > 0 per lane."""
    t = mat["type"]
    any_kd = torch.any(mat["kd"] > 0.0, dim=-1)
    any_ks = torch.any(mat["ks"] > 0.0, dim=-1)
    out = torch.where(t == MAT_MATTE, any_kd, False)
    out = torch.where(t == MAT_PLASTIC, any_kd | any_ks, out)
    return out & (t >= 0)


def eval_material(mat, wo, wi, mat_types):
    """BSDF::f and BSDF::Pdf over the non-specular lobes.  Mirror lanes give
    f = 0, pdf = 0."""
    t = mat["type"]
    f = torch.zeros_like(wo)
    pdf = torch.zeros(wo.shape[:-1], dtype=torch.float32, device=wo.device)
    refl = same_hemisphere(wo, wi)
    if MAT_MATTE in mat_types:
        m = t == MAT_MATTE
        f_m = torch.where(refl[..., None], oren_nayar_f(mat["kd"], mat["sigma"],
                                                        wo, wi), 0.0)
        f = torch.where(m[..., None], f_m, f)
        pdf = torch.where(m, cosine_pdf(wo, wi), pdf)
    if MAT_PLASTIC in mat_types:
        m = t == MAT_PLASTIC
        mfr = microfacet_reflection_f(mat["ks"], mat["ax"], mat["ay"], wo, wi,
                                      _plastic_fresnel)
        f_m = torch.where(refl[..., None], mat["kd"] * INV_PI + mfr, 0.0)
        pdf_m = 0.5 * (cosine_pdf(wo, wi)
                       + microfacet_reflection_pdf(mat["ax"], mat["ay"], wo, wi))
        f = torch.where(m[..., None], f_m, f)
        pdf = torch.where(m, pdf_m, pdf)
    return f, pdf


def sample_material(mat, wo, u, mat_types):
    """BSDF::Sample_f (reflection.cpp:714-764).  Returns dict: wi, f, pdf,
    is_specular, valid.  Specular lobes return the delta weight as f and
    the lobe-selection probability as pdf."""
    t = mat["type"]
    n = wo.shape[0]
    wi = torch.zeros_like(wo)
    f = torch.zeros_like(wo)
    pdf = torch.zeros(n, dtype=torch.float32, device=wo.device)
    is_spec = torch.zeros(n, dtype=torch.bool, device=wo.device)
    if MAT_MATTE in mat_types:
        m = t == MAT_MATTE
        wi_m = _cosine_sample_wi(wo, u)
        wi = torch.where(m[..., None], wi_m, wi)
        f = torch.where(m[..., None],
                        oren_nayar_f(mat["kd"], mat["sigma"], wo, wi_m), f)
        pdf = torch.where(m, cosine_pdf(wo, wi_m), pdf)
    if MAT_PLASTIC in mat_types:
        m = t == MAT_PLASTIC
        # Two matching lobes: comp = floor(2 u0), u0 remapped (reflection.cpp:725).
        spec_lobe = u[..., 0] >= 0.5
        u0 = torch.where(spec_lobe, 2.0 * (u[..., 0] - 0.5), 2.0 * u[..., 0])
        u_re = torch.stack([torch.clamp(u0, max=1.0 - 1e-7), u[..., 1]], -1)
        wi_d = _cosine_sample_wi(wo, u_re)
        wi_s, _ = microfacet_reflection_sample(mat["ax"], mat["ay"], wo, u_re)
        wi_m = torch.where(spec_lobe[..., None], wi_s, wi_d)
        mfr = microfacet_reflection_f(mat["ks"], mat["ax"], mat["ay"], wo, wi_m,
                                      _plastic_fresnel)
        f_m = torch.where(same_hemisphere(wo, wi_m)[..., None],
                          mat["kd"] * INV_PI + mfr, 0.0)
        pdf_m = 0.5 * (cosine_pdf(wo, wi_m)
                       + microfacet_reflection_pdf(mat["ax"], mat["ay"], wo, wi_m))
        wi = torch.where(m[..., None], wi_m, wi)
        f = torch.where(m[..., None], f_m, f)
        pdf = torch.where(m, pdf_m, pdf)
    if MAT_MIRROR in mat_types:
        # SpecularReflection with FresnelNoOp (materials/mirror.cpp:45).
        m = t == MAT_MIRROR
        wi_m = vec(-wo[..., 0], -wo[..., 1], wo[..., 2])
        w_m = mat["kr"] / torch.clamp(abs_cos_theta(wi_m), min=1e-12)[..., None]
        wi = torch.where(m[..., None], wi_m, wi)
        f = torch.where(m[..., None], w_m, f)
        pdf = torch.where(m, 1.0, pdf)
        is_spec = is_spec | m
    valid = (pdf > 0.0) & torch.any(f != 0.0, dim=-1)
    return {"wi": wi, "f": f, "pdf": pdf, "is_specular": is_spec, "valid": valid}


def gather_material(table, mat_id):
    """Per-lane material parameters from the MaterialTable."""
    mid = torch.clamp(mat_id.to(torch.int64), 0, table.mat_type.shape[0] - 1)
    rough = table.roughness[mid]
    remap = table.remap_roughness[mid]
    urough = table.urough[mid]
    vrough = table.vrough[mid]
    ur = torch.where(urough >= 0.0, urough, rough)
    vr = torch.where(vrough >= 0.0, vrough, rough)
    ax = torch.where(remap, mf.roughness_to_alpha(ur), torch.clamp(ur, min=1e-3))
    ay = torch.where(remap, mf.roughness_to_alpha(vr), torch.clamp(vr, min=1e-3))
    return {
        "type": torch.where(mat_id >= 0, table.mat_type[mid], -1),
        "kd": table.kd[mid],
        "ks": table.ks[mid],
        "kr": table.kr[mid],
        "sigma": table.sigma[mid],
        "ax": ax,
        "ay": ay,
        "eta": table.eta[mid],
    }
