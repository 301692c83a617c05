"""The tabulated BSSRDF: photon-beam diffusion subsurface scattering.

Port of pbrt_tpu/materials/bssrdf.py (bssrdf.{h,cpp}).

- Host (numpy, float64, the JAX package's code): compute_beam_diffusion_
  bssrdf builds the (100 albedos x 64 radii) profile as
  ComputeBeamDiffusionBSSRDF (bssrdf.cpp:146-178) does, its rhoEff and
  CDFs; subsurface_from_diffuse inverts rhoEff for "kdsubsurface"
  (bssrdf.cpp:180-189).
- Device (torch): the profile's spline lookups and sampling
  (TabulatedBSSRDF::Sr / Sample_Sr / Pdf_Sr, bssrdf.cpp:198-392) and the
  separable terms Sw and Pdf_Sp (bssrdf.h:84-95, bssrdf.cpp:331-356).  The
  probe walk of Sample_Sp is integrators/common.py:sample_bssrdf_sp.

The tables of the scene's distinct (g, eta) pairs are stacked: profile and
cdf are [K * 100, 64], and a lane's table id becomes a row offset.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..core import interpolation as itp
from ..core.vecmath import safe_sqrt

N_RHO = 100
N_RADIUS = 64


def _moment_poly(eta, lo_c, hi_fn):
    eta2, eta3, eta4, eta5 = eta * eta, eta ** 3, eta ** 4, eta ** 5
    lo = (lo_c[0] + lo_c[1] * eta + lo_c[2] * eta2 + lo_c[3] * eta3
          + lo_c[4] * eta4 + lo_c[5] * eta5)
    hi = hi_fn(eta, eta2, eta3, eta4, eta5)
    where = torch.where if isinstance(eta, torch.Tensor) else np.where
    return where(eta < 1, lo, hi)


def fresnel_moment1(eta):
    """FresnelMoment1 (bssrdf.cpp:41-52), numpy or torch."""
    return _moment_poly(
        eta, (0.45966, -1.73965, 3.37668, -3.904945, 2.49277, -0.68441),
        lambda e, e2, e3, e4, e5: (-4.61686 + 11.1136 * e - 10.4646 * e2
                                   + 5.11455 * e3 - 1.27198 * e4 + 0.12746 * e5))


def fresnel_moment2(eta):
    """FresnelMoment2 (bssrdf.cpp:54-64), numpy or torch."""
    def hi(e, e2, e3, e4, e5):
        r = 1.0 / e
        return (-547.033 + 45.3087 * r ** 3 - 218.725 * r ** 2 + 458.843 * r
                + 404.557 * e - 189.519 * e2 + 54.9327 * e3 - 9.00603 * e4
                + 0.63942 * e5)
    return _moment_poly(
        eta, (0.27614, -0.87350, 1.12077, -0.65095, 0.07883, 0.04860), hi)


def _fr_dielectric_np(cos_i, eta_i, eta_t):
    """FrDielectric (reflection.cpp:47-64), numpy scalar/array."""
    cos_i = np.clip(cos_i, -1.0, 1.0)
    swap = cos_i <= 0.0
    ei = np.where(swap, eta_t, eta_i)
    et = np.where(swap, eta_i, eta_t)
    cos_i = np.abs(cos_i)
    sin_t = ei / et * np.sqrt(np.maximum(0.0, 1.0 - cos_i * cos_i))
    tir = sin_t >= 1.0
    cos_t = np.sqrt(np.maximum(0.0, 1.0 - sin_t * sin_t))
    r_par = (et * cos_i - ei * cos_t) / (et * cos_i + ei * cos_t)
    r_perp = (ei * cos_i - et * cos_t) / (ei * cos_i + et * cos_t)
    return np.where(tir, 1.0, 0.5 * (r_par * r_par + r_perp * r_perp))


def _phase_hg_np(cos_theta, g):
    denom = 1.0 + g * g + 2.0 * g * cos_theta
    return (1.0 / (4.0 * np.pi)) * (1.0 - g * g) / (denom * np.sqrt(np.maximum(denom, 1e-20)))


# ---- beam diffusion integrands (bssrdf.cpp:66-144), over (rho, r) ----

def beam_diffusion_ms(sigma_s, sigma_a, g, eta, r, n_samples=100):
    """Multiple-scattering dipole term E_d(r) (bssrdf.cpp:66-119)."""
    sigma_s, sigma_a, r = np.broadcast_arrays(
        np.asarray(sigma_s, np.float64), np.asarray(sigma_a, np.float64),
        np.asarray(r, np.float64))
    sigmap_s = sigma_s * (1.0 - g)
    sigmap_t = sigma_a + sigmap_s
    rhop = np.where(sigmap_t > 0, sigmap_s / np.maximum(sigmap_t, 1e-30), 0.0)
    d_g = (2.0 * sigma_a + sigmap_s) / (3.0 * np.maximum(sigmap_t, 1e-30) ** 2)
    sigma_tr = np.sqrt(sigma_a / np.maximum(d_g, 1e-30))
    fm1 = fresnel_moment1(np.float64(eta))
    fm2 = fresnel_moment2(np.float64(eta))
    ze = -2.0 * d_g * (1.0 + 3.0 * fm2) / (1.0 - 2.0 * fm1)
    c_phi = 0.25 * (1.0 - 2.0 * fm1)
    c_e = 0.5 * (1.0 - 3.0 * fm2)
    i = np.arange(n_samples, dtype=np.float64)
    # exponential depth samples of the real source (equi-spaced in CDF)
    zr = -np.log(1.0 - (i + 0.5) / n_samples)[:, None] / np.maximum(
        sigmap_t[None, :], 1e-30)
    zv = -zr + 2.0 * ze[None, :]
    rr = r[None, :]
    dr = np.sqrt(rr * rr + zr * zr)
    dv = np.sqrt(rr * rr + zv * zv)
    phi_d = (1.0 / (4.0 * np.pi)) / d_g[None, :] * (
        np.exp(-sigma_tr[None, :] * dr) / dr
        - np.exp(-sigma_tr[None, :] * dv) / dv)
    e_dn = (1.0 / (4.0 * np.pi)) * (
        zr * (1.0 + sigma_tr[None, :] * dr) * np.exp(-sigma_tr[None, :] * dr) / dr ** 3
        - zv * (1.0 + sigma_tr[None, :] * dv) * np.exp(-sigma_tr[None, :] * dv) / dv ** 3)
    e = phi_d * c_phi + e_dn * c_e
    kappa = 1.0 - np.exp(-2.0 * sigmap_t[None, :] * (dr + zr))
    ed = kappa * (rhop[None, :] ** 2) * e
    return ed.mean(axis=0)


def beam_diffusion_ss(sigma_s, sigma_a, g, eta, r, n_samples=100):
    """Single-scattering term E_ss(r) (bssrdf.cpp:121-144)."""
    sigma_s, sigma_a, r = np.broadcast_arrays(
        np.asarray(sigma_s, np.float64), np.asarray(sigma_a, np.float64),
        np.asarray(r, np.float64))
    sigma_t = sigma_a + sigma_s
    rho = np.where(sigma_t > 0, sigma_s / np.maximum(sigma_t, 1e-30), 0.0)
    t_crit = r * np.sqrt(max(eta * eta - 1.0, 0.0))
    i = np.arange(n_samples, dtype=np.float64)
    ti = t_crit[None, :] - np.log(1.0 - (i[:, None] + 0.5) / n_samples) / np.maximum(
        sigma_t[None, :], 1e-30)
    d = np.sqrt(r[None, :] ** 2 + ti * ti)
    cos_o = ti / np.maximum(d, 1e-30)
    ess = (rho[None, :] * np.exp(-sigma_t[None, :] * (d + t_crit[None, :]))
           / np.maximum(d * d, 1e-30)
           * _phase_hg_np(cos_o, g)
           * (1.0 - _fr_dielectric_np(-cos_o, 1.0, eta))
           * np.abs(cos_o))
    return ess.mean(axis=0)


# ---- table construction (bssrdf.cpp:146-189) ----

def compute_beam_diffusion_bssrdf(g, eta, n_rho=N_RHO, n_radius=N_RADIUS):
    """Build {rho, radius, profile[n_rho,n_radius], cdf, rho_eff} (float32)."""
    radius = np.zeros(n_radius, np.float64)
    radius[1] = 2.5e-3
    for i in range(2, n_radius):
        radius[i] = radius[i - 1] * 1.2
    rho = (1.0 - np.exp(-8.0 * np.arange(n_rho) / (n_rho - 1))) / (1.0 - np.exp(-8.0))

    profile = np.zeros((n_rho, n_radius), np.float64)
    for i in range(n_rho):
        profile[i] = 2.0 * np.pi * radius * (
            beam_diffusion_ss(rho[i], 1.0 - rho[i], g, eta, radius)
            + beam_diffusion_ms(rho[i], 1.0 - rho[i], g, eta, radius))
    rho_eff, cdf = itp.integrate_catmull_rom_np(radius, profile)
    return dict(
        rho=rho.astype(np.float32),
        radius=radius.astype(np.float32),
        profile=profile.astype(np.float32),
        cdf=cdf.astype(np.float32),
        rho_eff=rho_eff.astype(np.float32),
    )


@functools.lru_cache(maxsize=None)
def beam_diffusion_table(g: float, eta: float) -> dict:
    """compute_beam_diffusion_bssrdf(g, eta), built once a process (~0.14 s
    each); callers only read it."""
    return compute_beam_diffusion_bssrdf(g, eta)


def subsurface_from_diffuse(table, rho_eff_target, mfp):
    """SubsurfaceFromDiffuse (bssrdf.cpp:180-189): invert rhoEff(rho).

    rho_eff_target, mfp: [3] rgb.  Returns (sigma_a, sigma_s) [3] each.
    """
    sigma_a = np.zeros(3, np.float32)
    sigma_s = np.zeros(3, np.float32)
    for c in range(3):
        rho = itp.invert_catmull_rom_np(
            table["rho"], table["rho_eff"], float(rho_eff_target[c]))
        sigma_s[c] = rho / mfp[c]
        sigma_a[c] = (1.0 - rho) / mfp[c]
    return sigma_a, sigma_s


# ---- device lookups, over lanes; tables stacked over K ----

def sr_eval(rho_nodes, radius_nodes, profile, table_id, sigma_t, rho, r):
    """TabulatedBSSRDF::Sr (bssrdf.cpp:198-231): r [n] -> Sr [n, 3].
    profile [K * N_RHO, N_RADIUS]; table_id [n]; sigma_t and rho [n, 3]."""
    r_optical = r[:, None] * sigma_t
    row_off = (table_id.to(torch.int64) * rho_nodes.shape[0])[:, None]
    sr = itp.catmull_rom_interp_2d(rho_nodes, radius_nodes, profile, rho,
                                   r_optical, row_off)
    # cancel the 2 pi r factor of the profile's marginal
    sr = torch.where(r_optical > 0,
                     sr / (2.0 * math.pi * torch.clamp(r_optical, min=1e-20)), sr)
    return torch.clamp(sr * sigma_t * sigma_t, min=0.0)


def sample_sr(rho_nodes, radius_nodes, profile, cdf, table_id, sigma_t_ch,
              rho_ch, u):
    """TabulatedBSSRDF::Sample_Sr (bssrdf.cpp:358-365) for one channel a
    lane: sigma_t_ch, rho_ch and u [n].  Returns r [n], negative where
    invalid."""
    row_off = table_id.to(torch.int64) * rho_nodes.shape[0]
    x, _, _ = itp.sample_catmull_rom_2d(rho_nodes, radius_nodes, profile, cdf,
                                        rho_ch, u, row_off)
    r = x / torch.clamp(sigma_t_ch, min=1e-20)
    return torch.where(sigma_t_ch == 0, -1.0, r)


def pdf_sr(rho_nodes, radius_nodes, profile, rho_eff, table_id, sigma_t, rho,
           r):
    """TabulatedBSSRDF::Pdf_Sr (bssrdf.cpp:367-392), the three channels at
    once: sigma_t and rho [n, 3], r [n] or [n, 3].  Returns [n, 3]."""
    if r.dim() == sigma_t.dim() - 1:
        r = r[:, None]
    r_optical = r * sigma_t
    n_rho = rho_nodes.shape[0]
    row_off = (table_id.to(torch.int64) * n_rho)[:, None]
    sr = itp.catmull_rom_interp_2d(rho_nodes, radius_nodes, profile, rho,
                                   r_optical, row_off)
    # rhoEff interpolated along the rho axis
    off1, w1, v1 = itp.catmull_rom_weights(rho_nodes, rho)
    rows = (torch.clamp(off1[..., None] + torch.arange(4, device=rho.device), 0,
                        n_rho - 1) + row_off[..., None])
    re = torch.sum(rho_eff[rows] * w1, -1)
    sr = torch.where(r_optical > 0,
                     sr / (2.0 * math.pi * torch.clamp(r_optical, min=1e-20)), sr)
    pdf = sr * sigma_t * sigma_t / torch.clamp(re, min=1e-20)
    return torch.clamp(torch.where(v1 & (re > 0), pdf, 0.0), min=0.0)


def _fr_dielectric(cos_i, eta_i, eta_t):
    """FrDielectric (reflection.cpp:47-64), as the JAX package's bssrdf
    module writes it, its square roots guarded (safe_sqrt: the same values,
    a zero gradient at total internal reflection)."""
    cos_i = torch.clamp(cos_i, -1.0, 1.0)
    swap = cos_i <= 0.0
    ei = torch.where(swap, eta_t, eta_i)
    et = torch.where(swap, eta_i, eta_t)
    cos_i = torch.abs(cos_i)
    sin_t = ei / et * safe_sqrt(1.0 - cos_i * cos_i)
    tir = sin_t >= 1.0
    cos_t = safe_sqrt(1.0 - sin_t * sin_t)
    r_par = (et * cos_i - ei * cos_t) / torch.clamp(et * cos_i + ei * cos_t,
                                                     min=1e-20)
    r_perp = (ei * cos_i - et * cos_t) / torch.clamp(ei * cos_i + et * cos_t,
                                                      min=1e-20)
    return torch.where(tir, 1.0, 0.5 * (r_par * r_par + r_perp * r_perp))


def sw(eta, cos_theta_w):
    """The directional term Sw a lane (bssrdf.h:89-92)."""
    c = 1.0 - 2.0 * fresnel_moment1(1.0 / eta)
    fr = _fr_dielectric(cos_theta_w, torch.ones_like(eta), eta)
    return (1.0 - fr) / (c * math.pi)


def pdf_sp(rho_nodes, radius_nodes, profile, rho_eff, table_id, sigma_t, rho,
           po_p, frame_ss, frame_ts, frame_ns, pi_p, pi_ng):
    """SeparableBSSRDF::Pdf_Sp (bssrdf.cpp:331-356): MIS over the three
    projection axes and the three channels."""
    d = po_p - pi_p
    frame = (frame_ss, frame_ts, frame_ns)
    dl = [torch.sum(a * d, -1) for a in frame]
    nl = [torch.sum(a * pi_ng, -1) for a in frame]
    # safe_sqrt: a lane whose probe found no exit point has d = 0
    r_proj = (safe_sqrt(dl[1] ** 2 + dl[2] ** 2),
              safe_sqrt(dl[2] ** 2 + dl[0] ** 2),
              safe_sqrt(dl[0] ** 2 + dl[1] ** 2))
    # the three axes' Pdf_Sr in one call over the lanes three times
    p_axes = pdf_sr(rho_nodes, radius_nodes, profile, rho_eff,
                    table_id.repeat(3), sigma_t.repeat(3, 1), rho.repeat(3, 1),
                    torch.cat(r_proj)).view(3, -1, 3)
    pdf = torch.zeros(po_p.shape[:-1], dtype=torch.float32, device=po_p.device)
    for axis, prob in enumerate((0.25, 0.25, 0.5)):
        pdf = (pdf + torch.sum(p_axes[axis], -1) * torch.abs(nl[axis])
               * (1.0 / 3.0) * prob)
    return pdf
