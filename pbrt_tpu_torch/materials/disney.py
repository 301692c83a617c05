"""The Disney "principled" BSDF.

Port of pbrt_tpu/materials/disney.py (materials/disney.cpp:92-625, Burley
2012/2015): every lobe evaluated over the batch at once.  DisneyDiffuse,
retro-reflection and sheen (cosine sampled), anisotropic GGX reflection
with the metallic-blended DisneyFresnel, GTR1 clearcoat, microfacet
specular transmission, and the thin lobes (the flatness blend with FakeSS,
Lambertian diffuse transmission, the roughness-scaled thin transmission).

Parameters (MaterialTable.disney [M, 12]): 0 metallic, 1 specularTint,
2 anisotropic, 3 sheen, 4 sheenTint, 5 clearcoat, 6 clearcoatGloss,
7 specTrans, 8 flatness, 9 diffTrans, 10 thin (0/1), 11 pad.  The base
color is kd; eta and the raw (not remapped) roughness come from the common
columns.  Sampling follows BSDF::Sample_f (reflection.cpp:714-764) over
the lanes' present lobes.
"""
from __future__ import annotations

import math

import torch

from ..core.sampling import INV_PI
from ..core.vecmath import (abs_cos_theta, cos_theta, dot, normalize, reflect,
                            safe_sqrt, same_hemisphere, tan2_theta)
from . import bsdf as bx
from . import microfacet as mf


def _schlick_weight(cos_t):
    c = torch.clamp(1.0 - cos_t, 0.0, 1.0)
    return (c * c) * (c * c) * c


def _lerp_sp(t, a, b):
    """lerp(t, a scalar, b a spectrum)."""
    return (1.0 - t)[..., None] * a + t[..., None] * b


def _z(like):
    return torch.tensor([0.0, 0.0, 1.0], device=like.device)


def _params(mat):
    d = mat["disney"]
    rough = torch.clamp(mat["raw_rough"], min=1e-4)
    aspect = torch.sqrt(1.0 - 0.9 * d[:, 2])
    c = mat["kd"]
    lum = 0.212671 * c[:, 0] + 0.715160 * c[:, 1] + 0.072169 * c[:, 2]
    return {
        "c": c, "metallic": d[:, 0], "spec_tint": d[:, 1], "sheen": d[:, 3],
        "sheen_tint": d[:, 4], "clearcoat": d[:, 5], "cc_gloss": d[:, 6],
        "spec_trans": d[:, 7], "flatness": d[:, 8],
        "diff_trans": d[:, 9] / 2.0,  # dt in [0, 1], halved (disney.cpp:605)
        "thin": d[:, 10] > 0.5, "eta": mat["eta"], "rough": rough,
        "ax": torch.clamp(rough * rough / aspect, min=1e-3),
        "ay": torch.clamp(rough * rough * aspect, min=1e-3),
        "ctint": torch.where((lum > 0.0)[:, None],
                             c / torch.clamp(lum, min=1e-8)[:, None], 1.0),
    }


def _lobe_counts(p):
    """The diffuse weight and each lobe kind's count a lane:
    (diffuse_w, n_diff (diffuse, retro, sheen), n_dt, n_cc, n_st)."""
    diffuse_w = (1.0 - p["metallic"]) * (1.0 - p["spec_trans"])
    has_diffuse = diffuse_w > 0.0
    has_dt = p["thin"] & (p["diff_trans"] > 0.0) & has_diffuse
    return (diffuse_w, has_diffuse, torch.where(has_diffuse, 3.0, 0.0),
            has_dt.to(torch.float32), (p["clearcoat"] > 0.0).to(torch.float32),
            (p["spec_trans"] > 0.0).to(torch.float32))


def _gtr1_d(wh, alpha):
    """The GTR1 NDF (disney.cpp:409): (a^2 - 1) / (pi log(a^2) (1 + (a^2 -
    1) cos^2)); both the numerator and log(a^2) are negative for a < 1."""
    a2 = alpha * alpha
    c2 = cos_theta(wh) ** 2
    denom = math.pi * torch.log(a2) * (1.0 + (a2 - 1.0) * c2)
    safe = torch.where(torch.abs(denom) < 1e-12,
                       torch.sign(denom) * 1e-12 + 1e-30, denom)
    d = (a2 - 1.0) / safe
    return torch.where(torch.abs(a2 - 1.0) < 1e-6, 1.0 / math.pi,
                       torch.clamp(d, min=0.0))


def _smith_g_ggx(w, alpha):
    """smithG_GGX (disney.cpp:415) at a fixed alpha."""
    t2 = tan2_theta(w)
    t2 = torch.where(torch.isfinite(t2), t2, 0.0)
    return 2.0 / (1.0 + torch.sqrt(1.0 + alpha * alpha * t2))


def _disney_fresnel(p, cos_i):
    """DisneyFresnel::Evaluate (disney.cpp:376): the dielectric Fresnel
    and Schlick to Cspec0, blended by metallic."""
    r0 = ((p["eta"] - 1.0) / (p["eta"] + 1.0)) ** 2
    m = p["metallic"][:, None]
    cspec0 = ((1.0 - m) * r0[:, None] * _lerp_sp(p["spec_tint"], 1.0, p["ctint"])
              + m * p["c"])
    fd = bx.fresnel_dielectric(cos_i, torch.ones_like(p["eta"]), p["eta"])
    fs = cspec0 + _schlick_weight(cos_i)[:, None] * (1.0 - cspec0)
    return (1.0 - m) * fd[:, None] + m * fs


def _cc_alpha(p):
    return torch.clamp((1.0 - p["cc_gloss"]) * 0.1 + p["cc_gloss"] * 1e-3,
                       min=1e-3)


def _eval_lobes(p, wo, wi):
    """Every lobe at wi: (f [n, 3], the lobes' pdf sum, the matching lobe
    count, (n_diff, n_dt, n_cc, n_st))."""
    refl = same_hemisphere(wo, wi)
    co = abs_cos_theta(wo)
    ci = abs_cos_theta(wi)
    wh_r = wo + wi
    degen = torch.sum(wh_r * wh_r, -1) == 0.0
    wh = normalize(torch.where(degen[:, None], _z(wo), wh_r))
    cos_d = dot(wi, wh)
    diffuse_w, has_diffuse, n_diff, n_dt, n_cc, n_st = _lobe_counts(p)
    fo = _schlick_weight(co)
    fi = _schlick_weight(ci)
    c = p["c"]

    f_base = c * (INV_PI * (1.0 - fo / 2.0) * (1.0 - fi / 2.0))[:, None]
    # thin lanes blend flatness between the base diffuse and FakeSS
    # (disney.cpp:160, 567-573)
    fss90 = cos_d * cos_d * p["rough"]
    fss = (1.0 + (fss90 - 1.0) * fo) * (1.0 + (fss90 - 1.0) * fi)
    ss = c * (1.25 * INV_PI * (fss * (1.0 / torch.clamp(co + ci, min=1e-4) - 0.5)
                               + 0.5))[:, None]
    f_diffuse_part = torch.where(
        p["thin"][:, None],
        _lerp_sp(p["flatness"], f_base, ss) * (1.0 - p["diff_trans"])[:, None],
        f_base)
    rr = 2.0 * p["rough"] * cos_d * cos_d  # retro (disney.cpp:180)
    f_retro = c * (INV_PI * rr * (fo + fi + fo * fi * (rr - 1.0)))[:, None]
    csheen = _lerp_sp(p["sheen_tint"], 1.0, p["ctint"])  # sheen (disney.cpp:219)
    f_sheen = (p["sheen"] * _schlick_weight(cos_d))[:, None] * csheen
    # diffuseWeight scales the diffuse, retro and sheen lobes
    f_diff = diffuse_w[:, None] * (f_diffuse_part + f_retro + f_sheen)
    f_diff = torch.where((refl & has_diffuse)[:, None], f_diff, 0.0)

    d_tr = mf.tr_d(wh, p["ax"], p["ay"])
    g_tr = mf.tr_g(wo, wi, p["ax"], p["ay"])
    f_spec = _disney_fresnel(p, cos_d) * (
        d_tr * g_tr / torch.clamp(4.0 * ci * co, min=1e-12))[:, None]
    f_spec = torch.where((refl & ~degen)[:, None], f_spec, 0.0)

    # clearcoat (disney.cpp:427): Gtr1 Fr(0.04 Schlick) G(0.25) / 4
    d_cc = _gtr1_d(wh, _cc_alpha(p))
    f_cc_s = 0.04 + _schlick_weight(cos_d) * (1.0 - 0.04)
    g_cc = _smith_g_ggx(wo, 0.25) * _smith_g_ggx(wi, 0.25)
    f_cc = (p["clearcoat"] * 0.25 * d_cc * f_cc_s * g_cc)[:, None]
    f_cc = torch.where((refl & (n_cc > 0) & ~degen)[:, None], f_cc, 0.0)

    # specular transmission T = specTrans sqrt(c) (disney.cpp:586-603);
    # thin lanes take the roughness-scaled distribution
    t_spec = p["spec_trans"][:, None] * safe_sqrt(torch.abs(c))
    ax_t, ay_t = _thin_alphas(p)
    f_mt = bx.microfacet_transmission_f(t_spec, ax_t, ay_t, p["eta"], wo, wi)
    f_mt = torch.where((n_st > 0)[:, None], f_mt, 0.0)

    f_dt = (p["diff_trans"][:, None] * c * INV_PI  # thin (disney.cpp:605)
            * (1.0 - p["spec_trans"])[:, None] * (1.0 - p["metallic"])[:, None])
    f_dt = torch.where((~refl & (n_dt > 0))[:, None], f_dt, 0.0)
    f = f_diff + f_spec + f_cc + f_mt + f_dt

    pdf_mf = mf.tr_pdf_visible(wo, wh, p["ax"], p["ay"]) / torch.clamp(
        4.0 * dot(wo, wh), min=1e-12)
    pdf_mf = torch.where(refl & ~degen, pdf_mf, 0.0)
    pdf_cc = d_cc * abs_cos_theta(wh) / torch.clamp(4.0 * dot(wo, wh), min=1e-12)
    pdf_cc = torch.where(refl & ~degen, pdf_cc, 0.0)
    pdf_mt = bx.microfacet_transmission_pdf(ax_t, ay_t, p["eta"], wo, wi)
    nmatch = torch.clamp(n_diff + n_dt + 1.0 + n_cc + n_st, min=1.0)
    pdf_sum = (n_diff * bx.cosine_pdf(wo, wi) + n_dt * bx.cosine_transmit_pdf(wo, wi)
               + pdf_mf + n_cc * pdf_cc + n_st * pdf_mt)
    return f, pdf_sum, nmatch, (n_diff, n_dt, n_cc, n_st)


def _thin_alphas(p):
    """The transmission lobe's alphas: thin lanes scale the roughness by
    (0.65 eta - 0.35) (disney.cpp:590), isotropically."""
    rscaled = (0.65 * p["eta"] - 0.35) * p["rough"]
    ax_t = torch.where(p["thin"], torch.clamp(rscaled * rscaled, min=1e-3),
                       p["ax"])
    return ax_t, torch.where(p["thin"], ax_t, p["ay"])


def disney_eval(mat, wo, wi):
    """(f, pdf) for NEE: the pdf averaged over the matching lobes (none of
    them specular)."""
    f, pdf_sum, nmatch, _ = _eval_lobes(_params(mat), wo, wi)
    return f, pdf_sum / nmatch


def disney_sample(mat, wo, u):
    """BSDF::Sample_f's mixture over the lanes' present lobes, in the
    order diffuse x n_diff, diffuse transmission, microfacet, clearcoat,
    specular transmission."""
    p = _params(mat)
    _, _, n_diff, n_dt, n_cc, n_st = _lobe_counts(p)
    nmatch = torch.clamp(n_diff + n_dt + 1.0 + n_cc + n_st, min=1.0)
    idx = torch.clamp((u[:, 0] * nmatch).to(torch.int32), 0, 6)
    u0 = torch.clamp(u[:, 0] * nmatch - idx.to(torch.float32), max=1.0 - 1e-7)
    u_re = torch.stack([u0, u[:, 1]], -1)
    fidx = idx.to(torch.float32)
    c0 = n_diff
    c1 = c0 + n_dt
    c2 = c1 + 1.0
    c3 = c2 + n_cc
    pick_diff = fidx < c0
    pick_dt = ~pick_diff & (fidx < c1)
    pick_mf = ~pick_diff & ~pick_dt & (fidx < c2)
    pick_cc = ~pick_diff & ~pick_dt & ~pick_mf & (fidx < c3)
    pick_st = ~(pick_diff | pick_dt | pick_mf | pick_cc)

    wi_d = bx._cosine_sample_wi(wo, u_re)
    wi_t = bx._cosine_sample_wi_transmit(wo, u_re)
    wi_mf = reflect(wo, mf.tr_sample_wh_visible(wo, u_re, p["ax"], p["ay"]))
    # the clearcoat's half vector (disney.cpp:444): GTR1's inverse CDF
    a2 = _cc_alpha(p) ** 2
    ct2 = torch.clamp((1.0 - torch.pow(a2, 1.0 - u_re[:, 0])) / (1.0 - a2), 0.0,
                      1.0)
    ct = safe_sqrt(ct2)
    st = safe_sqrt(1.0 - ct2)
    phi = 2.0 * math.pi * u_re[:, 1]
    wh_cc = torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], -1)
    wh_cc = torch.where(same_hemisphere(wo, wh_cc)[:, None], wh_cc, -wh_cc)
    wi_cc = reflect(wo, wh_cc)
    ax_t, ay_t = _thin_alphas(p)
    wi_st, _, ok_st = bx.microfacet_transmission_sample(ax_t, ay_t, p["eta"], wo,
                                                        u_re)
    wi = torch.where(pick_diff[:, None], wi_d,
                     torch.where(pick_dt[:, None], wi_t,
                                 torch.where(pick_mf[:, None], wi_mf,
                                             torch.where(pick_cc[:, None], wi_cc,
                                                         wi_st))))
    f, pdf_sum, nmatch2, (_, _, n_cc2, _) = _eval_lobes(p, wo, wi)
    pdf = pdf_sum / nmatch2
    # below the horizon the reflection maps still put mass (eval zeroes
    # their pdfs there): count it, or the transmission lobes' f is
    # over-weighted (bsdf.microfacet_reflection_pdf_raw)
    below = ~same_hemisphere(wo, wi)
    raw_mf = bx.microfacet_reflection_pdf_raw(p["ax"], p["ay"], wo, wi)
    wh_b = normalize(wo + wi + 1e-12)
    raw_cc = _gtr1_d(wh_b, _cc_alpha(p)) * abs_cos_theta(wh_b) / torch.clamp(
        4.0 * torch.abs(dot(wo, wh_b)), min=1e-12)
    pdf = pdf + torch.where(below, (raw_mf + n_cc2 * raw_cc) / nmatch2, 0.0)
    bad = pick_st & ~ok_st  # total internal reflection on a transmission pick
    return {"wi": wi, "f": torch.where(bad[:, None], 0.0, f),
            "pdf": torch.where(bad, 0.0, pdf),
            "is_specular": torch.zeros(wo.shape[0], dtype=torch.bool,
                                       device=wo.device)}
