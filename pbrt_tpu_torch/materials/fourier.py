"""The Fourier BSDF: a measured BSDF tabulated in a spline x Fourier basis.

Port of pbrt_tpu/materials/fourier.py (reflection.h:130-156
FourierBSDFTable, reflection.cpp FourierBSDF::{f, Sample_f, Pdf}, and the
'SCATFUN\\x01' reader of materials/fourier.cpp).

The table keeps pbrt's ragged layout: one flat coefficient array `a`, and
per (muI, muO) pair its series order `m` and offset `a_offset`.  The 4x4
spline neighbourhood of a lane's (muI, muO) is summed into its coefficient
series ak [n, C, m_max] one neighbour at a time, in place.  The branch
runs on the lanes of its table alone, gathered and scattered back: the
JAX package runs it on every lane, and each lane's result is the same,
bit for bit (tests/test_torch_advanced_materials.py holds the two forms
equal).  The series are summed and sampled by core/interpolation.py.  Radiance transport: the eta^2
scale applies where mu_i * mu_o > 0.
"""
from __future__ import annotations

import dataclasses
import math
import struct

import numpy as np
import torch

from ..core import interpolation as itp
from ..core.vecmath import safe_sqrt

TABLE_FIELDS = ("mu", "cdf", "a0", "m", "a_offset", "a")
TABLE_INTS = ("n_mu", "m_max", "n_channels")


@dataclasses.dataclass(frozen=True)
class FourierTable:
    """FourierBSDFTable (reflection.h:130-156) on one device."""
    mu: torch.Tensor  # [n_mu] zenith-cosine nodes
    cdf: torch.Tensor  # [n_mu, n_mu] per-muO marginal CDF over muI
    a0: torch.Tensor  # [n_mu, n_mu] 0th-order coefficients (luminance)
    m: torch.Tensor  # [n_mu * n_mu] i32 each pair's series order
    a_offset: torch.Tensor  # [n_mu * n_mu] i32 its offset into a
    a: torch.Tensor  # [n_coeffs + 3 m_max] f32 coefficients, zero tail
    n_mu: int
    m_max: int
    n_channels: int
    eta: float

    @staticmethod
    def from_numpy(fields: dict, device) -> "FourierTable":
        return FourierTable(
            **{k: torch.as_tensor(np.asarray(fields[k]), device=device)
               for k in TABLE_FIELDS},
            **{k: int(fields[k]) for k in TABLE_INTS}, eta=float(fields["eta"]))

    @property
    def nbytes(self) -> int:
        return sum(getattr(self, k).nbytes for k in TABLE_FIELDS)


def read_bsdf(path: str) -> dict:
    """A 'SCATFUN' v1 .bsdf file (materials/fourier.cpp:105-198) as numpy
    fields of a FourierTable.  Raises ValueError on the layouts pbrt
    refuses too (textured nBases != 1, harmonic extrapolation)."""
    with open(path, "rb") as fh:
        raw = fh.read()
    if raw[:8] != b"SCATFUN\x01":
        raise ValueError(f"{path}: not a SCATFUN v1 BSDF file")
    flags, n_mu, n_coeffs, m_max, n_channels, n_bases = struct.unpack(
        "<6i", raw[8:32])
    eta = struct.unpack("<f", raw[44:48])[0]
    if flags != 1 or n_channels not in (1, 3) or n_bases != 1:
        raise ValueError(f"{path}: unsupported BSDF file layout")
    off = 64
    mu = np.frombuffer(raw, np.float32, n_mu, off)
    off += 4 * n_mu
    cdf = np.frombuffer(raw, np.float32, n_mu * n_mu, off).reshape(n_mu, n_mu)
    off += 4 * n_mu * n_mu
    offset_and_length = np.frombuffer(raw, np.int32, n_mu * n_mu * 2, off)
    off += 8 * n_mu * n_mu
    a = np.frombuffer(raw, np.float32, n_coeffs, off)
    a_offset = offset_and_length[0::2].copy()
    m = offset_and_length[1::2].copy()
    a0 = np.where(m > 0, a[np.clip(a_offset, 0, n_coeffs - 1)], 0.0).reshape(
        n_mu, n_mu).astype(np.float32)
    return dict(mu=mu.copy(), cdf=cdf.copy(), a0=a0, m=m, a_offset=a_offset,
                a=np.concatenate([a, np.zeros(3 * m_max, np.float32)]),
                n_mu=int(n_mu), m_max=int(m_max), n_channels=int(n_channels),
                eta=float(eta))


def _cos_d_phi(wa, wb):
    """CosDPhi (geometry.h): the cosine of two directions' azimuth gap."""
    waxy = wa[..., 0] ** 2 + wa[..., 1] ** 2
    wbxy = wb[..., 0] ** 2 + wb[..., 1] ** 2
    num = wa[..., 0] * wb[..., 0] + wa[..., 1] * wb[..., 1]
    den = torch.sqrt(torch.clamp(waxy * wbxy, min=1e-20))
    ok = (waxy > 0) & (wbxy > 0)
    return torch.where(ok, torch.clamp(num / den, -1.0, 1.0), 1.0)


def _accumulate_ak(tbl: FourierTable, mu_i, mu_o):
    """The weighted 4x4-neighbourhood sum of coefficient series
    (FourierBSDF::f, "Accumulate weighted sums of nearby ak").  Returns
    (ak [n, C, m_max], m_active [n], valid [n])."""
    n = mu_i.shape[0]
    c = tbl.n_channels
    dev = mu_i.device
    off_i, w_i, valid_i = itp.catmull_rom_weights(tbl.mu, mu_i)
    off_o, w_o, valid_o = itp.catmull_rom_weights(tbl.mu, mu_o)
    ks = torch.arange(tbl.m_max, device=dev)
    chan = torch.arange(c, device=dev)[:, None]
    ak = torch.zeros((n, c, tbl.m_max), dtype=torch.float32, device=dev)
    m_active = torch.zeros(n, dtype=torch.int32, device=dev)
    last = tbl.a.shape[0] - 1
    for b in range(4):
        oo = torch.clamp(off_o + b, 0, tbl.n_mu - 1)
        for ai in range(4):
            oi = torch.clamp(off_i + ai, 0, tbl.n_mu - 1)
            pair = oo * tbl.n_mu + oi
            w = w_i[:, ai] * w_o[:, b]
            m_p = tbl.m[pair]
            live = w != 0.0
            m_active = torch.maximum(m_active, torch.where(live, m_p, 0))
            m_l = m_p.to(torch.int64)[:, None, None]
            idx = tbl.a_offset[pair].to(torch.int64)[:, None, None] + chan * m_l + ks
            coef = torch.where(ks < m_l, tbl.a[torch.clamp(idx, max=last)], 0.0)
            ak.add_(torch.where(live[:, None, None], w[:, None, None] * coef, 0.0))
    return ak, m_active, valid_i & valid_o


def _series_yrb(ak, m_active, cos_phi):
    """The channels' series at cos_phi: [n, C] (Y, then R and B)."""
    return itp.fourier_eval(ak, cos_phi[:, None], m_active[:, None])


def _rgb_from_series(tbl, yrb, mu_i, mu_o, radiance):
    """f and Sample_f's shared tail: series values to scaled RGB
    (reflection.cpp)."""
    y = torch.clamp(yrb[:, 0], min=0.0)
    scale = torch.where(mu_i != 0.0,
                        1.0 / torch.clamp(torch.abs(mu_i), min=1e-20), 0.0)
    if radiance and tbl.eta != 1.0:
        eta = torch.where(mu_i > 0, 1.0 / tbl.eta, tbl.eta)
        scale = scale * torch.where(mu_i * mu_o > 0, eta * eta, 1.0)
    if tbl.n_channels == 1:
        return (y * scale)[:, None].expand(-1, 3)
    r, b = yrb[:, 1], yrb[:, 2]
    g = 1.39829 * y - 0.100913 * b - 0.297375 * r
    return torch.clamp(torch.stack([r, g, b], -1) * scale[:, None], min=0.0)


def table_f(tbl: FourierTable, wo, wi, radiance: bool = True):
    """FourierBSDF::f and ::Pdf for one table: (f [n, 3], pdf [n])."""
    mu_i = -wi[:, 2]
    mu_o = wo[:, 2]
    cos_phi = _cos_d_phi(-wi, wo)
    ak, m_active, valid = _accumulate_ak(tbl, mu_i, mu_o)
    yrb = _series_yrb(ak, m_active, cos_phi)
    f = torch.where(valid[:, None],
                    _rgb_from_series(tbl, yrb, mu_i, mu_o, radiance), 0.0)
    # Pdf: Y over the weighted rho of the muO row
    off_o, w_o, _ = itp.catmull_rom_weights(tbl.mu, mu_o)
    rho = torch.zeros_like(mu_o)
    for b in range(4):
        oo = torch.clamp(off_o + b, 0, tbl.n_mu - 1)
        rho = rho + w_o[:, b] * tbl.cdf[oo, tbl.n_mu - 1] * (2.0 * math.pi)
    y = yrb[:, 0]
    pdf = torch.where(valid & (rho > 0) & (y > 0),
                      y / torch.where(rho == 0, 1.0, rho), 0.0)
    return f, pdf


def table_sample(tbl: FourierTable, wo, u, radiance: bool = True):
    """FourierBSDF::Sample_f for one table: dict(wi, f, pdf), non-specular."""
    mu_o = wo[:, 2]
    mu_i, _, pdf_mu = itp.sample_catmull_rom_2d(tbl.mu, tbl.mu, tbl.a0, tbl.cdf,
                                                mu_o, u[:, 1])
    ak, m_active, valid = _accumulate_ak(tbl, mu_i, mu_o)
    _, pdf_phi, phi = itp.sample_fourier(ak[:, 0], u[:, 0], m_active)
    pdf = torch.clamp(pdf_phi * pdf_mu, min=0.0)
    sin2_i = torch.clamp(1.0 - mu_i * mu_i, min=0.0)
    sin2_o = torch.clamp(1.0 - mu_o * mu_o, min=0.0)
    norm = safe_sqrt(sin2_i / torch.clamp(sin2_o, min=1e-20))
    norm = torch.where(sin2_o <= 0.0, 0.0, norm)
    phi64 = phi.to(torch.float64)  # correctly rounded, as XLA's mostly are
    sp, cp = torch.sin(phi64).to(torch.float32), torch.cos(phi64).to(torch.float32)
    wi = -torch.stack([norm * (cp * wo[:, 0] - sp * wo[:, 1]),
                       norm * (sp * wo[:, 0] + cp * wo[:, 1]), mu_i], -1)
    wi = wi / torch.clamp(torch.sqrt(torch.sum(wi * wi, -1, keepdim=True)),
                          min=1e-20)
    f = _rgb_from_series(tbl, _series_yrb(ak, m_active, cp), mu_i, mu_o,
                         radiance)
    ok = valid & (pdf > 0)
    return {"wi": wi, "f": torch.where(ok[:, None], f, 0.0),
            "pdf": torch.where(ok, pdf, 0.0)}


def fourier_eval(mat, wo, wi):
    """(f [n, 3], pdf [n]) over the scene's tables, each lane its own."""
    f = torch.zeros_like(wo)
    pdf = torch.zeros(wo.shape[0], dtype=torch.float32, device=wo.device)
    for ti, tbl in enumerate(mat["fourier_tables"]):
        idx = _lanes(mat["fourier_id"] == ti)
        if idx.numel():
            f[idx], pdf[idx] = table_f(tbl, wo[idx], wi[idx])
    return f, pdf


def fourier_sample(mat, wo, u):
    """The sampled dict over the scene's tables, each lane its own."""
    out = {"wi": torch.zeros_like(wo), "f": torch.zeros_like(wo),
           "pdf": torch.zeros(wo.shape[0], dtype=torch.float32, device=wo.device)}
    for ti, tbl in enumerate(mat["fourier_tables"]):
        idx = _lanes(mat["fourier_id"] == ti)
        if idx.numel():
            s = table_sample(tbl, wo[idx], u[idx])
            for k in out:
                out[k][idx] = s[k]
    return out


def _lanes(sel):
    """The lanes of one table: the branch runs on those alone (one host
    sync), each lane's result the same, bit for bit, as when every lane
    runs it, since no operation of the branch mixes lanes."""
    return torch.nonzero(sel).squeeze(1)
