"""BSDF lobes for matte, plastic, mirror and glass, with pbrt's mixture
sampling.

Port of the matte / plastic / mirror / glass parts of
pbrt_tpu/materials/bsdf.py (reflection.{h,cpp},
materials/{matte,plastic,mirror,glass}.cpp).  Lobes work in the local
shading frame (z = shading normal); a material is a dict of per-lane
parameters gathered from the MaterialTable, with texture-bound parameters
taken from the evaluated texture stack (textures/textures.py).
"""
from __future__ import annotations

import torch

from ..core import sampling as smp
from ..core.sampling import INV_PI
from ..core.vecmath import (abs_cos_theta, cos_phi, coordinate_system,
                            cos_theta, cross, dot, normalize, reflect, refract,
                            safe_sqrt, same_hemisphere, sin_phi, sin_theta, vec)
from ..scene import MAT_GLASS, MAT_MATTE, MAT_MIRROR, MAT_PLASTIC
from ..textures.textures import gather_texture
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


def _plastic_fresnel(c):
    # pbrt's plastic constructs FresnelDielectric(1.5, 1.0) (plastic.cpp:59).
    return fresnel_dielectric(c, 1.5, 1.0)[..., None]


# ---- material dispatch ----

def count_nonspecular(mat):
    """BSDF::NumComponents(BSDF_ALL & ~BSDF_SPECULAR) > 0 per lane; glass
    has microfacet lobes only when rough (glass.cpp:59-92)."""
    t = mat["type"]
    any_kd = torch.any(mat["kd"] > 0.0, dim=-1)
    any_ks = torch.any(mat["ks"] > 0.0, dim=-1)
    out = torch.where(t == MAT_MATTE, any_kd, False)
    out = torch.where(t == MAT_PLASTIC, any_kd | any_ks, out)
    out = torch.where(t == MAT_GLASS, mat["is_rough"] & (
        torch.any(mat["kr"] > 0.0, dim=-1) | torch.any(mat["kt"] > 0.0, dim=-1)),
        out)
    return out & (t >= 0)


def _glass_fresnel(eta):
    return lambda c: fresnel_dielectric(c, 1.0, eta)[..., None]


def eval_material(mat, wo, wi, mat_types):
    """BSDF::f and BSDF::Pdf over the non-specular lobes.  Mirror and smooth
    glass lanes give f = 0, pdf = 0."""
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
    if MAT_GLASS in mat_types:
        # Rough glass: microfacet reflection + transmission (glass.cpp:62-87).
        m = (t == MAT_GLASS) & mat["is_rough"]
        ax, ay, eta = mat["ax"], mat["ay"], mat["eta"]
        f_r = microfacet_reflection_f(mat["kr"], ax, ay, wo, wi,
                                      _glass_fresnel(eta))
        f_t = microfacet_transmission_f(mat["kt"], ax, ay, eta, wo, wi)
        pdf_m = 0.5 * (microfacet_reflection_pdf(ax, ay, wo, wi)
                       + microfacet_transmission_pdf(ax, ay, eta, wo, wi))
        f = torch.where(m[..., None], f_r + f_t, f)
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
    if MAT_GLASS in mat_types:
        # Smooth glass: FresnelSpecular (reflection.cpp:126-161), reflection
        # with probability F, else refraction, on either side.
        m = (t == MAT_GLASS) & ~mat["is_rough"]
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
        m = (t == MAT_GLASS) & mat["is_rough"]
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
    valid = (pdf > 0.0) & torch.any(f != 0.0, dim=-1)
    return {"wi": wi, "f": f, "pdf": pdf, "is_specular": is_spec, "valid": valid}


def gather_material(table, mat_id, tex_values=None):
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
    ur = torch.where(urough >= 0.0, urough, rough)
    vr = torch.where(vrough >= 0.0, vrough, rough)
    ax = torch.where(remap, mf.roughness_to_alpha(ur), torch.clamp(ur, min=1e-3))
    ay = torch.where(remap, mf.roughness_to_alpha(vr), torch.clamp(vr, min=1e-3))
    return {
        "type": torch.where(mat_id >= 0, table.mat_type[mid], -1),
        "kd": kd,
        "ks": ks,
        "kr": table.kr[mid],
        "kt": table.kt[mid],
        "sigma": sigma,
        "ax": ax,
        "ay": ay,
        "eta": table.eta[mid],
        # rough against specular glass: the raw (pre-remap) roughness
        "is_rough": torch.maximum(ur, vr) > 0.0,
    }
