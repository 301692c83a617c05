"""BSDF lobes for matte, plastic, mirror, glass, metal, substrate, uber,
translucent, mix, disney, hair, fourier and subsurface, with pbrt's mixture
sampling.

Port of pbrt_tpu/materials/bsdf.py (reflection.{h,cpp}, materials/{matte,
plastic,mirror,glass,metal,substrate,uber,translucent,mixmat,disney,hair,
fourier,subsurface,kdsubsurface}.cpp); disney.py, hair.py and fourier.py
hold those three.  A subsurface material's own surface BSDF is glass's
(subsurface.cpp:49-92); the exit point's SeparableBSSRDFAdapter is the
internal type MAT_BSSRDF_ADAPTER, a diffuse lobe of Sw (bssrdf.h:153-171).  Lobes work in the local shading frame (z = shading normal);
a material is a dict of per-lane parameters gathered from the
MaterialTable, with texture-bound parameters taken from the evaluated
texture stack (textures/textures.py).  A mix lane carries its two
materials' dicts, gathered one level deep ("sub_a", "sub_b"); the scene
refuses a mix of mixes.
"""
from __future__ import annotations

import math

import torch
from torch.profiler import record_function

from ..core import sampling as smp
from ..core.sampling import INV_PI
from ..core.vecmath import (abs_cos_theta, cos_phi, coordinate_system,
                            cos_theta, cross, dot, normalize, reflect, refract,
                            safe_sqrt, same_hemisphere, sin_phi, sin_theta, vec)
from ..scene import (MAT_BSSRDF_ADAPTER, MAT_DISNEY, MAT_FOURIER, MAT_GLASS,
                     MAT_HAIR, MAT_MATTE, MAT_METAL, MAT_MIRROR, MAT_MIX,
                     MAT_PLASTIC, MAT_SUBSTRATE, MAT_SUBSURFACE,
                     MAT_TRANSLUCENT, MAT_UBER)
from ..textures.textures import gather_texture
from . import microfacet as mf


# ---- shading frame ----

def make_frame(ns, dpdu):
    """BSDF ctor (reflection.h:166): ss = normalize(dpdu), ts = ns x ss."""
    ss_len = safe_sqrt(dot(dpdu, dpdu))[..., None]  # dpdu 0: no probe hit
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


def fresnel_conductor(cos_theta_i, eta_i, eta_t, k):
    """FrConductor (reflection.cpp:77) per channel: eta_i, eta_t and k are
    [..., 3]; returns [..., 3]."""
    ci = torch.clamp(torch.abs(cos_theta_i), 0.0, 1.0)[..., None]
    eta = eta_t / eta_i
    etak = k / eta_i
    ci2 = ci * ci
    si2 = 1.0 - ci2
    eta2 = eta * eta
    etak2 = etak * etak
    t0 = eta2 - etak2 - si2
    a2b2 = safe_sqrt(t0 * t0 + 4.0 * eta2 * etak2)
    t1 = a2b2 + ci2
    a = safe_sqrt(0.5 * (a2b2 + t0))
    t2 = 2.0 * ci * a
    rs = (t1 - t2) / torch.clamp(t1 + t2, min=1e-12)
    t3 = ci2 * a2b2 + si2 * si2
    t4 = t2 * si2
    rp = rs * (t3 - t4) / torch.clamp(t3 + t4, min=1e-12)
    return 0.5 * (rp + rs)


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


def _cosine_sample_wi_transmit(wo, u):
    """LambertianTransmission::Sample_f (reflection.cpp:800): a cosine
    sample of the hemisphere opposite wo."""
    wi = smp.cosine_sample_hemisphere(u)
    flip = torch.tensor([1.0, 1.0, -1.0], device=wi.device)
    return torch.where((cos_theta(wo) > 0.0)[..., None], wi * flip, wi)


def cosine_transmit_pdf(wo, wi):
    return torch.where(~same_hemisphere(wo, wi), abs_cos_theta(wi) * INV_PI, 0.0)


def schlick_fresnel(rs, cos_t):
    """FresnelBlend::SchlickFresnel (reflection.h): rs [..., 3]."""
    c = torch.clamp(1.0 - cos_t, 0.0, 1.0)
    pow5 = (c * c) * (c * c) * c
    return rs + pow5[..., None] * (1.0 - rs)


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


def microfacet_reflection_pdf_raw(ax, ay, wo, wi):
    """The reflection map's density at wi, below the horizon too: a mixture
    with transmission lobes counts it on the sampling side
    (bsdf.py:238-252)."""
    wh_r = wo + wi
    degen = dot(wh_r, wh_r) < 1e-16
    z = torch.tensor([0.0, 0.0, 1.0], device=wo.device)
    wh = normalize(torch.where(degen[..., None], z, wh_r))
    pdf = mf.tr_pdf_visible(wo, wh, ax, ay) / torch.clamp(4.0 * dot(wo, wh),
                                                          min=1e-12)
    return torch.where(degen | (dot(wo, wh) <= 0.0), 0.0, pdf)


def microfacet_reflection_sample(ax, ay, wo, u):
    """Returns (wi, raw map pdf)."""
    wh = mf.tr_sample_wh_visible(wo, u, ax, ay)
    wi = reflect(wo, wh)
    pdf = mf.tr_pdf_visible(wo, wh, ax, ay) / torch.clamp(4.0 * dot(wo, wh),
                                                          min=1e-12)
    return wi, torch.where(dot(wo, wh) > 0.0, pdf, 0.0)


def _transmit_half(wo, wi, eta_mat):
    """Half vector toward +z and eta = etaT / etaI on wo's side, for the
    transmission lobe; eta_mat is the interior IOR."""
    eta = torch.where(cos_theta(wo) > 0.0, eta_mat, 1.0 / eta_mat)
    wh = normalize(wo + wi * eta[..., None])
    return torch.where((wh[..., 2] < 0.0)[..., None], -wh, wh), eta


def microfacet_transmission_f(T, ax, ay, eta_mat, wo, wi):
    """MicrofacetTransmission::f (reflection.cpp:492), radiance transport."""
    co = cos_theta(wo)
    ci = cos_theta(wi)
    wh, eta = _transmit_half(wo, wi, eta_mat)
    dwo = dot(wo, wh)
    dwi = dot(wi, wh)
    F = fresnel_dielectric(dwo, torch.ones_like(eta_mat), eta_mat)
    sqrt_denom = dwo + eta * dwi
    factor = 1.0 / eta
    d = mf.tr_d(wh, ax, ay)
    g = mf.tr_g(wo, wi, ax, ay)
    val = ((1.0 - F) * torch.abs(d * g * eta * eta * torch.abs(dwi)
                                 * torch.abs(dwo) * factor * factor)
           / torch.clamp(torch.abs(ci * co) * sqrt_denom * sqrt_denom,
                         min=1e-12))
    bad = same_hemisphere(wo, wi) | (ci == 0.0) | (co == 0.0) | (dwo * dwi > 0.0)
    return torch.where(bad[..., None], 0.0, T * val[..., None])


def microfacet_transmission_pdf(ax, ay, eta_mat, wo, wi):
    """(reflection.cpp:522) pdf_wh * |dwh / dwi|."""
    wh, eta = _transmit_half(wo, wi, eta_mat)
    dwo = dot(wo, wh)
    dwi = dot(wi, wh)
    sqrt_denom = dwo + eta * dwi
    dwh_dwi = torch.abs((eta * eta * dwi)
                        / torch.clamp(sqrt_denom * sqrt_denom, min=1e-12))
    pdf = mf.tr_pdf_visible(wo, wh, ax, ay) * dwh_dwi
    return torch.where(same_hemisphere(wo, wi) | (dwo * dwi > 0.0), 0.0, pdf)


def microfacet_transmission_sample(ax, ay, eta_mat, wo, u):
    """MicrofacetTransmission::Sample_f (reflection.cpp:538): sample wh and
    refract wo about it.  Returns (wi, pdf, ok)."""
    wh = mf.tr_sample_wh_visible(wo, u, ax, ay)
    eta_ratio = torch.where(cos_theta(wo) > 0.0, 1.0 / eta_mat, eta_mat)
    whf = torch.where((dot(wo, wh) < 0.0)[..., None], -wh, wh)
    ok, wi = refract(wo, whf, eta_ratio)
    ok = ok & (dot(wo, wh) > 0.0) & ~same_hemisphere(wo, wi)
    pdf = microfacet_transmission_pdf(ax, ay, eta_mat, wo, wi)
    return wi, torch.where(ok, pdf, 0.0), ok


def fresnel_blend_f(rd, rs, ax, ay, wo, wi):
    """FresnelBlend::f (reflection.cpp:555): Ashikhmin-Shirley diffuse plus
    a Schlick-Fresnel microfacet gloss."""
    ci = abs_cos_theta(wi)
    co = abs_cos_theta(wo)

    def pow5(x):
        return (x * x) * (x * x) * x

    diffuse = ((28.0 / (23.0 * math.pi)) * rd * (1.0 - rs)
               * (1.0 - pow5(1.0 - 0.5 * ci))[..., None]
               * (1.0 - pow5(1.0 - 0.5 * co))[..., None])
    wh = wi + wo
    degenerate = dot(wh, wh) == 0.0
    z = torch.tensor([0.0, 0.0, 1.0], device=wo.device)
    wh_n = normalize(torch.where(degenerate[..., None], z, wh))
    d = mf.tr_d(wh_n, ax, ay)
    spec = (d / torch.clamp(4.0 * torch.abs(dot(wi, wh_n)) * torch.maximum(ci, co),
                            min=1e-12))[..., None] * schlick_fresnel(rs, dot(wi, wh_n))
    ok = same_hemisphere(wo, wi) & ~degenerate
    return torch.where(ok[..., None], diffuse + spec, 0.0)


def fresnel_blend_pdf(ax, ay, wo, wi):
    """FresnelBlend::Pdf (reflection.cpp:594): half cosine, half the
    microfacet map."""
    wh = normalize(wo + wi)
    pdf_wh = mf.tr_pdf_visible(wo, wh, ax, ay) / torch.clamp(4.0 * dot(wo, wh),
                                                             min=1e-12)
    return torch.where(same_hemisphere(wo, wi),
                       0.5 * (abs_cos_theta(wi) * INV_PI + pdf_wh), 0.0)


def fresnel_blend_sample(ax, ay, wo, u):
    """FresnelBlend::Sample_f (reflection.cpp:580): u0 < 0.5 a cosine
    sample, else a sampled half vector reflected; returns (wi, pdf)."""
    pick_diff = u[..., 0] < 0.5
    u0 = torch.where(pick_diff, 2.0 * u[..., 0], 2.0 * (u[..., 0] - 0.5))
    u_re = torch.stack([torch.clamp(u0, max=1.0 - 1e-7), u[..., 1]], -1)
    wi_d = _cosine_sample_wi(wo, u_re)
    wi_s = reflect(wo, mf.tr_sample_wh_visible(wo, u_re, ax, ay))
    wi = torch.where(pick_diff[..., None], wi_d, wi_s)
    return wi, fresnel_blend_pdf(ax, ay, wo, wi)


def _plastic_fresnel(c):
    # pbrt's plastic constructs FresnelDielectric(1.5, 1.0) (plastic.cpp:59).
    return fresnel_dielectric(c, 1.5, 1.0)[..., None]


# ---- material dispatch ----

def _any3(x):
    return torch.any(x > 0.0, dim=-1)


def count_nonspecular(mat):
    """BSDF::NumComponents(BSDF_ALL & ~BSDF_SPECULAR) > 0 per lane: lobes
    exist only for non-black coefficients; glass has microfacet lobes only
    when rough (glass.cpp:59-92), and so has subsurface's surface, uber's
    non-specular lobes are op * kd and op * ks, disney, hair, fourier and
    the BSSRDF adapter have some always, and a mix has those of either
    material (bsdf.py:400-440)."""
    t = mat["type"]
    any_kd, any_ks = _any3(mat["kd"]), _any3(mat["ks"])
    out = torch.where(t == MAT_MATTE, any_kd, False)
    out = torch.where((t == MAT_PLASTIC) | (t == MAT_SUBSTRATE)
                      | (t == MAT_TRANSLUCENT), any_kd | any_ks, out)
    out = torch.where(t == MAT_GLASS, mat["is_rough"] & (
        _any3(mat["kr"]) | _any3(mat["kt"])), out)
    out = torch.where(t == MAT_SUBSURFACE, mat["is_rough"], out)
    out = torch.where((t == MAT_METAL) | (t == MAT_FOURIER) | (t == MAT_HAIR)
                      | (t == MAT_DISNEY) | (t == MAT_BSSRDF_ADAPTER), True, out)
    op = mat["opacity"]
    out = torch.where(t == MAT_UBER, _any3(op * mat["kd"]) | _any3(op * mat["ks"]),
                      out)
    if "sub_a" in mat:
        out = torch.where(t == MAT_MIX, count_nonspecular(mat["sub_a"])
                          | count_nonspecular(mat["sub_b"]), out)
    return out & (t >= 0)


def _glass_fresnel(eta):
    return lambda c: fresnel_dielectric(c, 1.0, eta)[..., None]


def eval_material(mat, wo, wi, mat_types):
    """BSDF::f and BSDF::Pdf over the non-specular lobes.  Mirror and smooth
    glass lanes, and uber's specular lobes, give f = 0, pdf = 0.  A mix
    (mixmat.cpp:46) blends its materials' f by amount and averages their
    pdfs."""
    f, pdf = _eval_one(mat, wo, wi, mat_types)
    if MAT_MIX not in mat_types:
        return f, pdf
    sub = mat["sub_types"]
    f_a, pdf_a = _eval_one(mat["sub_a"], wo, wi, sub)
    f_b, pdf_b = _eval_one(mat["sub_b"], wo, wi, sub)
    amt = mat["mix_amount"]
    is_mix = mat["type"] == MAT_MIX
    return (torch.where(is_mix[..., None], amt * f_a + (1.0 - amt) * f_b, f),
            torch.where(is_mix, 0.5 * (pdf_a + pdf_b), pdf))


def _translucent_f(mat, wo, wi):
    """translucent (translucent.cpp:47-76): Lambertian and microfacet
    reflection weighted by "reflect" (kr), Lambertian and microfacet
    transmission by "transmit" (kt), at a fixed eta of 1.5 (bsdf.py:
    562-584)."""
    r_w, t_w = mat["kr"], mat["kt"]
    ax, ay = mat["ax"], mat["ay"]
    lam_r = r_w * mat["kd"] * INV_PI
    lam_t = t_w * mat["kd"] * INV_PI
    mf_r = microfacet_reflection_f(r_w * mat["ks"], ax, ay, wo, wi,
                                   _glass_fresnel(1.5))
    mf_t = microfacet_transmission_f(t_w * mat["ks"], ax, ay,
                                     torch.full_like(mat["eta"], 1.5), wo, wi)
    return torch.where(same_hemisphere(wo, wi)[..., None], lam_r + mf_r,
                       lam_t + mf_t)


def _translucent_pdf(mat, wo, wi):
    """The four lobes' pdfs averaged, the reflection map's zeroed below
    the horizon (BSDF::Pdf)."""
    ax, ay = mat["ax"], mat["ay"]
    eta15 = torch.full_like(mat["eta"], 1.5)
    return 0.25 * ((cosine_pdf(wo, wi) + microfacet_reflection_pdf(ax, ay, wo, wi))
                   + (cosine_transmit_pdf(wo, wi)
                      + microfacet_transmission_pdf(ax, ay, eta15, wo, wi)))


def _eval_one(mat, wo, wi, mat_types):
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
    if MAT_GLASS in mat_types or MAT_SUBSURFACE in mat_types:
        # Rough glass: microfacet reflection + transmission (glass.cpp:62-87),
        # subsurface's surface too (subsurface.cpp:49-92).
        m = ((t == MAT_GLASS) | (t == MAT_SUBSURFACE)) & mat["is_rough"]
        ax, ay, eta = mat["ax"], mat["ay"], mat["eta"]
        f_r = microfacet_reflection_f(mat["kr"], ax, ay, wo, wi,
                                      _glass_fresnel(eta))
        f_t = microfacet_transmission_f(mat["kt"], ax, ay, eta, wo, wi)
        pdf_m = 0.5 * (microfacet_reflection_pdf(ax, ay, wo, wi)
                       + microfacet_transmission_pdf(ax, ay, eta, wo, wi))
        f = torch.where(m[..., None], f_r + f_t, f)
        pdf = torch.where(m, pdf_m, pdf)
    if MAT_UBER in mat_types:
        # op * kd Lambertian and op * ks microfacet (uber.cpp:42-98); its
        # specular lobes evaluate to 0
        m = t == MAT_UBER
        op = mat["opacity"]
        kd_e, ks_e = op * mat["kd"], op * mat["ks"]
        mfr = microfacet_reflection_f(ks_e, mat["ax"], mat["ay"], wo, wi,
                                      _glass_fresnel(mat["eta"]))
        has_d = _any3(kd_e).to(torch.float32)
        has_g = _any3(ks_e).to(torch.float32)
        f_m = torch.where(refl[..., None], kd_e * INV_PI + mfr, 0.0)
        pdf_m = ((cosine_pdf(wo, wi) * has_d
                  + microfacet_reflection_pdf(mat["ax"], mat["ay"], wo, wi) * has_g)
                 / torch.clamp(has_d + has_g, min=1.0))
        f = torch.where(m[..., None], f_m, f)
        pdf = torch.where(m, pdf_m, pdf)
    if MAT_SUBSTRATE in mat_types:
        m = t == MAT_SUBSTRATE
        f = torch.where(m[..., None], fresnel_blend_f(
            mat["kd"], mat["ks"], mat["ax"], mat["ay"], wo, wi), f)
        pdf = torch.where(m, fresnel_blend_pdf(mat["ax"], mat["ay"], wo, wi), pdf)
    if MAT_METAL in mat_types:
        m = t == MAT_METAL
        f = torch.where(m[..., None], microfacet_reflection_f(
            torch.ones_like(mat["ks"]), mat["ax"], mat["ay"], wo, wi,
            _metal_fresnel(mat)), f)
        pdf = torch.where(m, microfacet_reflection_pdf(mat["ax"], mat["ay"],
                                                       wo, wi), pdf)
    if MAT_TRANSLUCENT in mat_types:
        m = t == MAT_TRANSLUCENT
        f = torch.where(m[..., None], _translucent_f(mat, wo, wi), f)
        pdf = torch.where(m, _translucent_pdf(mat, wo, wi), pdf)
    for mt, fn in _advanced_evals(mat_types):
        m = t == mt
        with record_function(f"layer: materials / {_RANGE[mt]}"):
            f_m, pdf_m = fn(mat, wo, wi)
        f = torch.where(m[..., None], f_m, f)
        pdf = torch.where(m, pdf_m, pdf)
    return f, pdf


# the profiler ranges of the advanced materials' calls
_RANGE = {MAT_DISNEY: "disney", MAT_HAIR: "hair", MAT_FOURIER: "fourier",
          MAT_BSSRDF_ADAPTER: "bssrdf adapter"}


def _advanced_evals(mat_types):
    """(type, eval function) of the scene's disney, hair, fourier and BSSRDF
    adapter lanes."""
    from . import disney, fourier, hair

    fns = {MAT_DISNEY: disney.disney_eval, MAT_HAIR: hair.hair_eval,
           MAT_FOURIER: fourier.fourier_eval, MAT_BSSRDF_ADAPTER: _adapter_eval}
    return [(mt, fn) for mt, fn in fns.items() if mt in mat_types]


def _adapter_f(mat, wi):
    """SeparableBSSRDFAdapter::f = Sw(wi) eta^2 in radiance transport
    (bssrdf.h:153-166)."""
    from .bssrdf import sw

    return (sw(mat["eta"], wi[..., 2]) * mat["eta"] ** 2)[..., None].expand(-1, 3)


def _adapter_eval(mat, wo, wi):
    """The adapter's diffuse reflection lobe: f, and the cosine pdf."""
    f = torch.where(same_hemisphere(wo, wi)[..., None], _adapter_f(mat, wi), 0.0)
    return f, cosine_pdf(wo, wi)


def _adapter_sample(mat, wo, u):
    """BxDF::Sample_f's cosine sample of the adapter's lobe."""
    wi = _cosine_sample_wi(wo, u)
    return {"wi": wi, "f": _adapter_f(mat, wi), "pdf": cosine_pdf(wo, wi),
            "is_specular": torch.zeros(wo.shape[0], dtype=torch.bool,
                                       device=wo.device)}


def _metal_fresnel(mat):
    eta = mat["metal_eta"]
    return lambda c: fresnel_conductor(c, torch.ones_like(eta), eta, mat["metal_k"])


def sample_material(mat, wo, u, mat_types):
    """BSDF::Sample_f (reflection.cpp:714-764).  Returns dict: wi, f, pdf,
    is_specular, valid.  Specular lobes return the delta weight as f and
    the lobe-selection probability as pdf.  A mix picks its first material
    on u0 < 1/2 (u0 remapped) and samples it; a non-specular pick takes the
    blended f and the averaged pdf of both materials at that wi, a specular
    one the picked material's delta weight scaled by its share and half
    its pdf (bsdf.py:633-675)."""
    out = _sample_one(mat, wo, u, mat_types)
    if MAT_MIX not in mat_types:
        return out
    pick_a = u[..., 0] < 0.5
    u0 = torch.where(pick_a, 2.0 * u[..., 0], 2.0 * (u[..., 0] - 0.5))
    u_re = torch.stack([torch.clamp(u0, max=1.0 - 1e-7), u[..., 1]], -1)
    sub = mat["sub_types"]
    s_a = _sample_one(mat["sub_a"], wo, u_re, sub)
    s_b = _sample_one(mat["sub_b"], wo, u_re, sub)
    amt = mat["mix_amount"]
    pa = pick_a[..., None]
    wi_m = torch.where(pa, s_a["wi"], s_b["wi"])
    spec_m = torch.where(pick_a, s_a["is_specular"], s_b["is_specular"])
    f_a, pdf_a = _eval_one(mat["sub_a"], wo, wi_m, sub)
    f_b, pdf_b = _eval_one(mat["sub_b"], wo, wi_m, sub)
    f_mix = torch.where(spec_m[..., None],
                        torch.where(pa, amt * s_a["f"], (1.0 - amt) * s_b["f"]),
                        amt * f_a + (1.0 - amt) * f_b)
    pdf_mix = torch.where(spec_m,
                          0.5 * torch.where(pick_a, s_a["pdf"], s_b["pdf"]),
                          0.5 * (pdf_a + pdf_b))
    is_mix = mat["type"] == MAT_MIX
    mv = is_mix[..., None]
    out = {"wi": torch.where(mv, wi_m, out["wi"]),
           "f": torch.where(mv, f_mix, out["f"]),
           "pdf": torch.where(is_mix, pdf_mix, out["pdf"]),
           "is_specular": torch.where(is_mix, spec_m, out["is_specular"])}
    out["valid"] = (out["pdf"] > 0.0) & torch.any(out["f"] != 0.0, dim=-1)
    return out


def _sample_one(mat, wo, u, mat_types):
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
    if MAT_GLASS in mat_types or MAT_SUBSURFACE in mat_types:
        # Smooth glass: FresnelSpecular (reflection.cpp:126-161), reflection
        # with probability F, else refraction, on either side; subsurface's
        # smooth surface the same (subsurface.cpp:60-62).
        m = ((t == MAT_GLASS) | (t == MAT_SUBSURFACE)) & ~mat["is_rough"]
        eta = mat["eta"]
        F = fresnel_dielectric(cos_theta(wo), torch.ones_like(eta), eta)
        choose_refl = u[..., 0] < F
        wi_r = vec(-wo[..., 0], -wo[..., 1], wo[..., 2])
        f_r = (F / torch.clamp(abs_cos_theta(wi_r), min=1e-12))[..., None] * mat["kr"]
        entering = cos_theta(wo) > 0.0
        eta_i = torch.where(entering, 1.0, eta)
        eta_t = torch.where(entering, eta, 1.0)
        z = torch.tensor([0.0, 0.0, 1.0], device=wo.device)
        ok_t, wi_t = refract(wo, torch.where(entering[..., None], z, -z),
                             eta_i / eta_t)
        # (eta_i / eta_t)^2 radiance scaling (reflection.cpp:155).
        ft = mat["kt"] * (1.0 - F)[..., None] * ((eta_i / eta_t) ** 2)[..., None]
        f_t = ft / torch.clamp(abs_cos_theta(wi_t), min=1e-12)[..., None]
        wi_m = torch.where(choose_refl[..., None], wi_r, wi_t)
        f_m = torch.where(choose_refl[..., None], f_r, f_t)
        f_m = torch.where((choose_refl | ok_t)[..., None], f_m, 0.0)
        wi = torch.where(m[..., None], wi_m, wi)
        f = torch.where(m[..., None], f_m, f)
        pdf = torch.where(m, torch.where(choose_refl, F, 1.0 - F), pdf)
        is_spec = is_spec | m

        # Rough glass: two non-specular lobes picked by halves of u0, f
        # summed, pdf averaged (glass.cpp:62-87).
        m = ((t == MAT_GLASS) | (t == MAT_SUBSURFACE)) & mat["is_rough"]
        ax, ay = mat["ax"], mat["ay"]
        pick_t = u[..., 0] >= 0.5
        u0 = torch.where(pick_t, 2.0 * (u[..., 0] - 0.5), 2.0 * u[..., 0])
        u_re = torch.stack([torch.clamp(u0, max=1.0 - 1e-7), u[..., 1]], -1)
        wi_r, _ = microfacet_reflection_sample(ax, ay, wo, u_re)
        wi_t, _, ok_t = microfacet_transmission_sample(ax, ay, eta, wo, u_re)
        wi_m = torch.where(pick_t[..., None], wi_t, wi_r)
        f_r = microfacet_reflection_f(mat["kr"], ax, ay, wo, wi_m,
                                      _glass_fresnel(eta))
        f_t = microfacet_transmission_f(mat["kt"], ax, ay, eta, wo, wi_m)
        pdf_m = 0.5 * (microfacet_reflection_pdf_raw(ax, ay, wo, wi_m)
                       + microfacet_transmission_pdf(ax, ay, eta, wo, wi_m))
        bad_t = pick_t & ~ok_t
        wi = torch.where(m[..., None], wi_m, wi)
        f = torch.where(m[..., None],
                        torch.where(bad_t[..., None], 0.0, f_r + f_t), f)
        pdf = torch.where(m, torch.where(bad_t, 0.0, pdf_m), pdf)
    if MAT_METAL in mat_types:
        m = t == MAT_METAL
        wi_m, pdf_m = microfacet_reflection_sample(mat["ax"], mat["ay"], wo, u)
        wi = torch.where(m[..., None], wi_m, wi)
        f = torch.where(m[..., None], microfacet_reflection_f(
            torch.ones_like(mat["ks"]), mat["ax"], mat["ay"], wo, wi_m,
            _metal_fresnel(mat)), f)
        pdf = torch.where(m, pdf_m, pdf)
    if MAT_SUBSTRATE in mat_types:
        m = t == MAT_SUBSTRATE
        wi_m, pdf_m = fresnel_blend_sample(mat["ax"], mat["ay"], wo, u)
        wi = torch.where(m[..., None], wi_m, wi)
        f = torch.where(m[..., None], fresnel_blend_f(
            mat["kd"], mat["ks"], mat["ax"], mat["ay"], wo, wi_m), f)
        pdf = torch.where(m, pdf_m, pdf)
    if MAT_TRANSLUCENT in mat_types:
        wi, f, pdf = _sample_translucent(mat, wo, u, t == MAT_TRANSLUCENT,
                                         wi, f, pdf)
    if MAT_UBER in mat_types:
        wi, f, pdf, is_spec = _sample_uber(mat, wo, u, t == MAT_UBER, wi, f,
                                           pdf, is_spec)
    for mt, fn in _advanced_samples(mat_types):
        m = t == mt
        with record_function(f"layer: materials / {_RANGE[mt]}"):
            s = fn(mat, wo, u)
        wi = torch.where(m[..., None], s["wi"], wi)
        f = torch.where(m[..., None], s["f"], f)
        pdf = torch.where(m, s["pdf"], pdf)
    valid = (pdf > 0.0) & torch.any(f != 0.0, dim=-1)
    return {"wi": wi, "f": f, "pdf": pdf, "is_specular": is_spec, "valid": valid}


def _advanced_samples(mat_types):
    """(type, sample function) of the scene's disney, hair, fourier and
    BSSRDF adapter lanes; none of their lobes is specular."""
    from . import disney, fourier, hair

    fns = {MAT_DISNEY: disney.disney_sample, MAT_HAIR: hair.hair_sample,
           MAT_FOURIER: fourier.fourier_sample,
           MAT_BSSRDF_ADAPTER: _adapter_sample}
    return [(mt, fn) for mt, fn in fns.items() if mt in mat_types]


def _sample_translucent(mat, wo, u, m, wi, f, pdf):
    """translucent's four lobes, picked by quarters of u0 (reflection.cpp:
    725): Lambertian reflection and transmission, microfacet reflection and
    transmission.  f sums the lobes at wi; the pdf averages their maps'
    densities there, the reflection map's below the horizon too
    (microfacet_reflection_pdf_raw).  A microfacet-transmission pick that
    fails by total internal reflection is invalid."""
    ax, ay = mat["ax"], mat["ay"]
    lobe = torch.clamp((u[..., 0] * 4.0).to(torch.int32), 0, 3)
    u0 = torch.clamp(u[..., 0] * 4.0 - lobe.to(torch.float32), max=1.0 - 1e-7)
    u_re = torch.stack([u0, u[..., 1]], -1)
    eta15 = torch.full_like(mat["eta"], 1.5)
    wi_mr, _ = microfacet_reflection_sample(ax, ay, wo, u_re)
    wi_mt, _, ok_mt = microfacet_transmission_sample(ax, ay, eta15, wo, u_re)
    lv = lobe[..., None]
    wi_m = torch.where(lv == 0, _cosine_sample_wi(wo, u_re),
                       torch.where(lv == 1, _cosine_sample_wi_transmit(wo, u_re),
                                   torch.where(lv == 2, wi_mr, wi_mt)))
    f_m = _translucent_f(mat, wo, wi_m)
    pdf_m = 0.25 * (cosine_pdf(wo, wi_m) + cosine_transmit_pdf(wo, wi_m)
                    + microfacet_reflection_pdf_raw(ax, ay, wo, wi_m)
                    + microfacet_transmission_pdf(ax, ay, eta15, wo, wi_m))
    bad = (lobe == 3) & ~ok_mt
    mv = m[..., None]
    return (torch.where(mv, wi_m, wi),
            torch.where(mv, torch.where(bad[..., None], 0.0, f_m), f),
            torch.where(m, torch.where(bad, 0.0, pdf_m), pdf))


def _sample_uber(mat, wo, u, m, wi, f, pdf, is_spec):
    """uber's matching lobes (uber.cpp:42-98), in this order where present:
    pass-through (1 - op, specular transmission with wi = -wo), op * kd
    Lambertian, op * ks microfacet, op * kr specular reflection and op * kt
    specular transmission; lobe floor(u0 * nmatch), u0 remapped
    (reflection.cpp:714-737).  A non-specular pick takes the non-specular
    lobes' f and their pdfs over nmatch; a specular one its delta weight
    and 1 / nmatch."""
    op = mat["opacity"]
    kd_e, ks_e = op * mat["kd"], op * mat["ks"]
    kr_e, kt_e = op * mat["kr"], op * mat["kt"]
    present = [_any3(1.0 - op), _any3(kd_e), _any3(ks_e), _any3(kr_e),
               _any3(kt_e)]
    counts = [p.to(torch.float32) for p in present]
    nmatch = torch.clamp(counts[0] + counts[1] + counts[2] + counts[3]
                         + counts[4], min=1.0)
    idx = torch.clamp((u[..., 0] * nmatch).to(torch.int32), 0, 4)
    u0 = torch.clamp(u[..., 0] * nmatch - idx.to(torch.float32), max=1.0 - 1e-7)
    u_re = torch.stack([u0, u[..., 1]], -1)
    cum = torch.zeros_like(counts[0])
    choose = []
    for p, c in zip(present, counts):
        choose.append(p & (idx == cum.to(torch.int32)))
        cum = cum + c
    eta = mat["eta"]
    ax, ay = mat["ax"], mat["ay"]
    wi_g, _ = microfacet_reflection_sample(ax, ay, wo, u_re)
    entering = cos_theta(wo) > 0.0
    z = torch.tensor([0.0, 0.0, 1.0], device=wo.device)
    eta_i = torch.where(entering, 1.0, eta)
    eta_t = torch.where(entering, eta, 1.0)
    ok_st, wi_st = refract(wo, torch.where(entering[..., None], z, -z),
                           eta_i / eta_t)
    c = [x[..., None] for x in choose]
    wi_m = torch.where(c[0], -wo, torch.where(
        c[1], _cosine_sample_wi(wo, u_re), torch.where(
            c[2], wi_g, torch.where(
                c[3], vec(-wo[..., 0], -wo[..., 1], wo[..., 2]), wi_st))))
    spec_m = choose[0] | choose[3] | choose[4]
    mfr = microfacet_reflection_f(ks_e, ax, ay, wo, wi_m, _glass_fresnel(eta))
    f_ns = torch.where(same_hemisphere(wo, wi_m)[..., None],
                       kd_e * INV_PI + mfr, 0.0)
    pdf_ns = (cosine_pdf(wo, wi_m) * counts[1]
              + microfacet_reflection_pdf(ax, ay, wo, wi_m) * counts[2]) / nmatch
    fr = fresnel_dielectric(cos_theta(wo), torch.ones_like(eta), eta)
    ac = torch.clamp(abs_cos_theta(wi_m), min=1e-12)[..., None]
    w_st = kt_e * (1.0 - fr)[..., None] * ((eta_i / eta_t) ** 2)[..., None] / ac
    w_st = torch.where(ok_st[..., None], w_st, 0.0)
    f_sp = torch.where(c[0], (1.0 - op) / ac,
                       torch.where(c[3], kr_e * fr[..., None] / ac, w_st))
    mv = m[..., None]
    return (torch.where(mv, wi_m, wi),
            torch.where(mv, torch.where(spec_m[..., None], f_sp, f_ns), f),
            torch.where(m, torch.where(spec_m, 1.0 / nmatch, pdf_ns), pdf),
            is_spec | (m & spec_m))


def gather_material(table, mat_id, tex_values=None, mat_types=(),
                    sub_types=None, uv=None):
    """Per-lane material parameters from the MaterialTable.  tex_values:
    the evaluated texture stack [T, N, 3] (textures.evaluate_textures), or
    None; a parameter bound to a texture (its *_tex column >= 0) takes the
    texture's value (bsdf.py:974-1063).  With MAT_MIX in mat_types, a mix
    lane's two materials are gathered too, as "sub_a" and "sub_b", and its
    amount as "mix_amount".  sub_types: the types of the mixes' materials
    (SceneArrays.mix_sub_types), required with MAT_MIX: the only types
    eval_material and sample_material run on "sub_a" and "sub_b", whose
    other lanes they discard.  uv: the hits' (u, v) [N, 2], required with
    MAT_HAIR in mat_types (hair's h = -1 + 2 v)."""
    mat = _gather_base(table, mat_id, tex_values)
    if uv is not None:
        mat["uv"] = uv
    elif MAT_HAIR in mat_types:
        raise ValueError("gather_material: MAT_HAIR in mat_types needs uv")
    if MAT_MIX in mat_types:
        if not sub_types:
            raise ValueError("gather_material: MAT_MIX in mat_types needs "
                             "sub_types (SceneArrays.mix_sub_types)")
        mat["sub_types"] = tuple(sub_types)
        is_mix = mat["type"] == MAT_MIX
        mid = torch.clamp(mat_id.to(torch.int64), 0, table.mat_type.shape[0] - 1)
        mat["sub_a"] = _gather_base(table, torch.where(is_mix, table.mix_m1[mid],
                                                       mat_id), tex_values)
        mat["sub_b"] = _gather_base(table, torch.where(is_mix, table.mix_m2[mid],
                                                       mat_id), tex_values)
        mat["mix_amount"] = table.mix_amount[mid]
    return mat


def _gather_base(table, mat_id, tex_values=None):
    """Per-lane material parameters from the MaterialTable.  tex_values:
    the evaluated texture stack [T, N, 3] (textures.evaluate_textures), or
    None; a parameter bound to a texture (its *_tex column >= 0) takes the
    texture's value (bsdf.py:1007-1063)."""
    mid = torch.clamp(mat_id.to(torch.int64), 0, table.mat_type.shape[0] - 1)
    rough = table.roughness[mid]
    remap = table.remap_roughness[mid]
    urough = table.urough[mid]
    vrough = table.vrough[mid]
    kd = table.kd[mid]
    ks = table.ks[mid]
    sigma = table.sigma[mid]
    if tex_values is not None:
        kd = gather_texture(tex_values, table.kd_tex[mid], kd)
        ks = gather_texture(tex_values, table.ks_tex[mid], ks)
        sigma = gather_texture(tex_values, table.sigma_tex[mid],
                               sigma[..., None].expand(-1, 3))[..., 0]
        rough = gather_texture(tex_values, table.rough_tex[mid],
                               rough[..., None].expand(-1, 3))[..., 0]
    opacity = table.opacity[mid]
    if tex_values is not None:
        opacity = gather_texture(tex_values, table.opacity_tex[mid], opacity)
    ur = torch.where(urough >= 0.0, urough, rough)
    vr = torch.where(vrough >= 0.0, vrough, rough)
    ax = torch.where(remap, mf.roughness_to_alpha(ur), torch.clamp(ur, min=1e-3))
    ay = torch.where(remap, mf.roughness_to_alpha(vr), torch.clamp(vr, min=1e-3))
    extra = {}
    if table.ss_sigma_t is not None:  # subsurface (bssrdf.h:117-137)
        extra.update(ss_sigma_t=table.ss_sigma_t[mid], ss_rho=table.ss_rho[mid],
                     ss_table=table.ss_table[mid])
    if table.fourier:
        extra.update(fourier_id=table.fourier_id[mid],
                     fourier_tables=table.fourier)
    return {
        **extra,
        "type": torch.where(mat_id >= 0, table.mat_type[mid], -1),
        "kd": kd,
        "ks": ks,
        "kr": table.kr[mid],
        "kt": table.kt[mid],
        "sigma": sigma,
        "ax": ax,
        "ay": ay,
        "eta": table.eta[mid],
        "metal_eta": table.metal_eta[mid],
        "metal_k": table.metal_k[mid],
        "opacity": opacity,
        # rough against specular glass: the raw (pre-remap) roughness
        "is_rough": torch.maximum(ur, vr) > 0.0,
        "raw_rough": ur,
        "disney": table.disney[mid],
        "hair": table.hair[mid],
    }
