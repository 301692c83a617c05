"""Sampled spectra on the host, for scene compilation (numpy).

Port of the parts of pbrt_tpu/core/sampled_spectrum.py that the metal
material's default needs: SampledSpectrum::FromSampled (spectrum.h:230-247)
onto pbrt's 60 bins over 400-700 nm, then XYZ and RGB (spectrum.h:249-259),
so that copper's measured eta and k (metal.cpp:82-121) become the RGB
defaults pbrt's RGB build uses.  The arithmetic is the JAX package's, op for
op, in float64, so the result is bit-equal to its copper_eta_k_rgb().

Data: pbrt_tpu_torch/data/spectra.npz, the port's own copy of the CIE 1931
matching curves (471 samples), the Smits basis and copper's eta and k.
"""
from __future__ import annotations

import functools
from pathlib import Path

import numpy as np

SAMPLED_LAMBDA_START = 400.0
SAMPLED_LAMBDA_END = 700.0
N_SPECTRAL_SAMPLES = 60  # spectrum.h:82 nSpectralSamples
CIE_Y_INTEGRAL = 106.856895  # spectrum.h:95

# XYZ to linear sRGB (spectrum.h:56-66)
_XYZ2RGB = np.array([[3.240479, -1.537150, -0.498535],
                     [-0.969256, 1.875991, 0.041556],
                     [0.055648, -0.204043, 1.057311]])


@functools.cache
def _tables() -> dict:
    return dict(np.load(Path(__file__).resolve().parent.parent / "data"
                        / "spectra.npz"))


def average_spectrum_samples(lam, vals, l0, l1):
    """AverageSpectrumSamples (spectrum.cpp:65-98): the mean of the
    piecewise-linear SPD (lam ascending) over [l0, l1]."""
    lam = np.asarray(lam, np.float64)
    vals = np.asarray(vals, np.float64)
    l0 = np.asarray(l0, np.float64)
    l1 = np.asarray(l1, np.float64)
    out = np.zeros(np.broadcast_shapes(l0.shape, l1.shape), np.float64)
    # the constant ends (spectrum.cpp:74-79)
    out += vals[0] * np.maximum(0.0, np.minimum(l1, lam[0]) - l0)
    out += vals[-1] * np.maximum(0.0, l1 - np.maximum(l0, lam[-1]))
    for i in range(len(lam) - 1):
        sl0 = np.maximum(l0, lam[i])
        sl1 = np.minimum(l1, lam[i + 1])
        seg = np.maximum(0.0, sl1 - sl0)

        def interp(w):
            t = (w - lam[i]) / (lam[i + 1] - lam[i])
            return (1.0 - t) * vals[i] + t * vals[i + 1]

        out += 0.5 * (interp(sl0) + interp(sl1)) * seg
    return out / np.maximum(l1 - l0, 1e-30)


def sample_bin_edges(n=N_SPECTRAL_SAMPLES):
    i = np.arange(n + 1, dtype=np.float64)
    return (SAMPLED_LAMBDA_START
            + (SAMPLED_LAMBDA_END - SAMPLED_LAMBDA_START) * i / n)


def from_sampled(lam, vals, n=N_SPECTRAL_SAMPLES):
    """SampledSpectrum::FromSampled: the SPD, sorted by wavelength,
    averaged into the n uniform bins."""
    order = np.argsort(np.asarray(lam, np.float64))
    lam = np.asarray(lam, np.float64)[order]
    vals = np.asarray(vals, np.float64)[order]
    edges = sample_bin_edges(n)
    return average_spectrum_samples(lam, vals, edges[:-1], edges[1:])


@functools.cache
def cie_xyz_bins(n=N_SPECTRAL_SAMPLES):
    """The X, Y, Z matching curves averaged into the n bins
    (SampledSpectrum::Init, spectrum.h:260-280): [3, n] float64."""
    t = _tables()
    return np.stack([from_sampled(t["CIE_lambda"], t[f"CIE_{c}"], n)
                     for c in "XYZ"])


def to_xyz(s, n=None):
    """SampledSpectrum::ToXYZ.  s: [..., n]."""
    s = np.asarray(s, np.float64)
    n = n or s.shape[-1]
    scale = (SAMPLED_LAMBDA_END - SAMPLED_LAMBDA_START) / (CIE_Y_INTEGRAL * n)
    return np.einsum("...s,cs->...c", s, cie_xyz_bins(n)) * scale


def to_rgb(s, n=None):
    return np.einsum("rc,...c->...r", _XYZ2RGB, to_xyz(s, n))


def spd_to_rgb(lam, vals):
    """A sampled SPD as the RGB build takes it (paramset.cpp:378-402 via
    Spectrum::FromSampled): float32 RGB."""
    return to_rgb(from_sampled(lam, vals)).astype(np.float32)


@functools.cache
def copper_eta_k_rgb():
    """The metal material's defaults, copper's eta and k as RGB
    (metal.cpp:115-121)."""
    t = _tables()
    return (spd_to_rgb(t["CopperWavelengths"], t["CopperN"]),
            spd_to_rgb(t["CopperWavelengths"], t["CopperK"]))
