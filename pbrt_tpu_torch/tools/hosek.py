"""Hosek-Wilkie analytic sky-dome radiance, from the RGB datasets.

Port of pbrt_tpu/tools/hosek.py, host numpy as in pbrt-v3 (tools/imgtool.cpp
runs it serially on the host).  The model is the SIGGRAPH 2012 one ("An
Analytic Model for Full Spectral Sky-Dome Radiance", Hosek and Wilkie); its
coefficients are the authors' public RGB tables, kept in
pbrt_tpu_torch/data/hosek_rgb.npz (the JAX package's file, byte for byte).

Used by ``imgtool makesky`` (imgtool.cpp:87-150).

Layout per channel: dataset[2 albedos][10 turbidities][6 Bezier control
points][9 coefficients]; the radiance dataset [2][10][6].  The solar
elevation is interpolated by the model's quintic Bezier over
t = (elevation / (pi/2))^(1/3).
"""
from __future__ import annotations

import os

import numpy as np

_DATA = None


def _data():
    global _DATA
    if _DATA is None:
        path = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "data", "hosek_rgb.npz",
        )
        _DATA = np.load(path)
    return _DATA


def _bezier5(ctrl, t):
    """Quintic Bezier through 6 control values; ctrl [..., 6]."""
    s = 1.0 - t
    w = np.array([
        s**5, 5 * s**4 * t, 10 * s**3 * t**2,
        10 * s**2 * t**3, 5 * s * t**4, t**5,
    ])
    return np.tensordot(ctrl, w, axes=([-1], [0]))


def _config(turbidity: float, albedo: float, elevation: float):
    """9 model coefficients + radiance scale per RGB channel.

    Mirrors ArHosekSkyModelConfigurationInit's interpolation: linear in
    turbidity and albedo, quintic Bezier in (2 elev / pi)^(1/3)."""
    d = _data()
    t_lo = int(np.clip(np.floor(turbidity), 1, 10))
    t_hi = min(t_lo + 1, 10)
    t_frac = np.clip(turbidity - t_lo, 0.0, 1.0)
    x = np.clip(2.0 * elevation / np.pi, 0.0, 1.0) ** (1.0 / 3.0)

    coefs = np.zeros((3, 9))
    rads = np.zeros(3)
    for c in range(3):
        ds = d[f"datasetRGB{c+1}"].reshape(2, 10, 6, 9)
        dr = d[f"datasetRGBRad{c+1}"].reshape(2, 10, 6)

        def at(alb, turb):
            return (
                _bezier5(np.moveaxis(ds[alb, turb - 1], 0, -1), x),
                _bezier5(dr[alb, turb - 1], x),
            )

        acc_c = np.zeros(9)
        acc_r = 0.0
        for alb, wa in ((0, 1.0 - albedo), (1, albedo)):
            for turb, wt in ((t_lo, 1.0 - t_frac), (t_hi, t_frac)):
                cc, rr = at(alb, turb)
                acc_c += wa * wt * cc
                acc_r += wa * wt * rr
        coefs[c] = acc_c
        rads[c] = acc_r
    return coefs, rads


def sky_radiance(theta, gamma, turbidity=3.0, albedo=0.2, elevation=0.5):
    """RGB sky radiance for view zenith angle theta and sun angle gamma.

    theta, gamma: arrays (radians).  Returns [..., 3]."""
    coefs, rads = _config(turbidity, albedo, elevation)
    cos_t = np.clip(np.cos(theta), 0.0, 1.0)
    cos_g = np.cos(gamma)
    out = np.zeros(np.shape(theta) + (3,))
    for c in range(3):
        A, B, C, D, E, F, G, I, H = (
            coefs[c, 0], coefs[c, 1], coefs[c, 2], coefs[c, 3],
            coefs[c, 4], coefs[c, 5], coefs[c, 6], coefs[c, 7], coefs[c, 8],
        )
        chi = (1.0 + cos_g**2) / np.power(
            1.0 + H * H - 2.0 * H * cos_g, 1.5
        )
        val = (
            (1.0 + A * np.exp(B / (cos_t + 0.01)))
            * (C + D * np.exp(E * gamma) + F * cos_g**2 + G * chi
               + I * np.sqrt(cos_t))
        )
        out[..., c] = np.maximum(val * rads[c], 0.0)
    return out


def make_sky_image(res=512, turbidity=3.0, albedo=0.2, elevation=0.5):
    """Equirect (lat-long) environment map of the sky hemisphere
    (imgtool makesky, imgtool.cpp:87-150)."""
    h, w = res // 2, res
    vs = (np.arange(h) + 0.5) / h
    us = (np.arange(w) + 0.5) / w
    theta = vs * np.pi  # zenith angle per row
    phi = us * 2.0 * np.pi
    tt, pp = np.meshgrid(theta, phi, indexing="ij")
    # Sun at azimuth 0, given elevation.
    sun_dir = np.array([
        np.cos(elevation), 0.0, np.sin(elevation)
    ])
    view = np.stack([
        np.sin(tt) * np.cos(pp), np.sin(tt) * np.sin(pp), np.cos(tt)
    ], -1)
    cos_g = np.clip(view @ sun_dir, -1.0, 1.0)
    gamma = np.arccos(cos_g)
    img = sky_radiance(tt, gamma, turbidity, albedo, elevation)
    img[tt > np.pi / 2] *= 0.0  # below the horizon
    return img.astype(np.float32)
