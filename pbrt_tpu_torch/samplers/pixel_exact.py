"""Bit-exact PixelSampler sample tables, host numpy.

Port (a copy) of pbrt_tpu/samplers/pixel_exact.py.  pbrt's stratified,
(0,2)-sequence and max-min-distance samplers precompute per-pixel sample
arrays in StartPixel with a stateful PCG32 that persists across the pixels
a tile-cloned sampler visits (core/sampler.cpp:101-135,
samplers/stratified.cpp:43-71, zerotwosequence.cpp:54-69, maxmin.cpp:42-66).
This module reproduces those streams one RNG operation at a time: PCG32,
the forward Shuffle (sampling.h), StratifiedSample1D/2D, the Gray-code
VanDerCorput and Sobol2D with their two shuffles, and the CMaxMinDist
generator matrix (from the port's copy of data/maxmin_dist.npy).
samplers/exact_tables.py turns them into the exact mode's tables.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..core.rng import ScalarPcg32

ONE_MINUS_EPS = np.float32(float.fromhex("0x1.fffffep-1"))


class PCG32(ScalarPcg32):
    """Scalar, sequential PCG32 with pbrt's exact semantics (rng.h:61-130):
    ScalarPcg32's stream, with pbrt's bounded draw (its rejection threshold
    taken in 32 bits) and UniformFloat in float32."""

    def uniform_uint32_b(self, b):
        threshold = ((~b + 1) & 0xFFFFFFFF) % b
        while True:
            r = self.uniform_uint32()
            if r >= threshold:
                return r % b

    def uniform_float(self):
        return min(
            np.float32(self.uniform_uint32()) * np.float32(2.3283064365386963e-10),
            ONE_MINUS_EPS,
        )


def shuffle(samp, count, n_dimensions, rng):
    """The free-function Shuffle (core/sampling.h): forward swap walk."""
    for i in range(count):
        other = i + rng.uniform_uint32_b(count - i)
        for j in range(n_dimensions):
            a = n_dimensions * i + j
            b = n_dimensions * other + j
            samp[a], samp[b] = samp[b], samp[a]


def stratified_sample_1d(n, rng, jitter=True):
    inv = np.float32(1.0) / np.float32(n)
    out = np.empty(n, np.float32)
    for i in range(n):
        delta = rng.uniform_float() if jitter else np.float32(0.5)
        out[i] = min(np.float32((np.float32(i) + delta) * inv), ONE_MINUS_EPS)
    return out


def stratified_sample_2d(nx, ny, rng, jitter=True):
    dx = np.float32(1.0) / np.float32(nx)
    dy = np.float32(1.0) / np.float32(ny)
    out = np.empty((nx * ny, 2), np.float32)
    k = 0
    for y in range(ny):
        for x in range(nx):
            jx = rng.uniform_float() if jitter else np.float32(0.5)
            jy = rng.uniform_float() if jitter else np.float32(0.5)
            out[k, 0] = min(np.float32((np.float32(x) + jx) * dx), ONE_MINUS_EPS)
            out[k, 1] = min(np.float32((np.float32(y) + jy) * dy), ONE_MINUS_EPS)
            k += 1
    return out


# Gray-code generator matrices (lowdiscrepancy.h:148-217).
CVANDERCORPUT = np.array([1 << (31 - i) for i in range(32)], np.uint64)
CSOBOL = [
    np.array([1 << (31 - i) for i in range(32)], np.uint64),
    np.array([
        0x80000000, 0xC0000000, 0xA0000000, 0xF0000000, 0x88000000,
        0xCC000000, 0xAA000000, 0xFF000000, 0x80800000, 0xC0C00000,
        0xA0A00000, 0xF0F00000, 0x88880000, 0xCCCC0000, 0xAAAA0000,
        0xFFFF0000, 0x80008000, 0xC000C000, 0xA000A000, 0xF000F000,
        0x88008800, 0xCC00CC00, 0xAA00AA00, 0xFF00FF00, 0x80808080,
        0xC0C0C0C0, 0xA0A0A0A0, 0xF0F0F0F0, 0x88888888, 0xCCCCCCCC,
        0xAAAAAAAA, 0xFFFFFFFF], np.uint64),
]


def _count_trailing_zeros(x):
    return (x & -x).bit_length() - 1


def gray_code_sample_1d(C, n, scramble):
    v = int(scramble)
    out = np.empty(n, np.float32)
    for i in range(n):
        out[i] = min(
            np.float32(v) * np.float32(2.3283064365386963e-10), ONE_MINUS_EPS
        )
        v ^= int(C[_count_trailing_zeros(i + 1)])
    return out


def van_der_corput(n_per_sample, n_pixel_samples, rng):
    """(lowdiscrepancy.h:144-201): Gray-code VdC + the two shuffles."""
    scramble = rng.uniform_uint32()
    total = n_per_sample * n_pixel_samples
    samples = gray_code_sample_1d(CVANDERCORPUT, total, scramble)
    for i in range(n_pixel_samples):
        shuffle(samples[i * n_per_sample:(i + 1) * n_per_sample],
                n_per_sample, 1, rng)
    shuffle(samples, n_pixel_samples, n_per_sample, rng)
    return samples


def sobol_2d(n_per_sample, n_pixel_samples, rng):
    """(lowdiscrepancy.h:203-227)."""
    sx = rng.uniform_uint32()
    sy = rng.uniform_uint32()
    total = n_per_sample * n_pixel_samples
    v = [int(sx), int(sy)]
    out = np.empty((total, 2), np.float32)
    for i in range(total):
        out[i, 0] = min(np.float32(v[0]) * np.float32(2.3283064365386963e-10),
                        ONE_MINUS_EPS)
        out[i, 1] = min(np.float32(v[1]) * np.float32(2.3283064365386963e-10),
                        ONE_MINUS_EPS)
        c = _count_trailing_zeros(i + 1)
        v[0] ^= int(CSOBOL[0][c])
        v[1] ^= int(CSOBOL[1][c])
    flat = out.reshape(-1)
    for i in range(n_pixel_samples):
        shuffle(flat[i * 2 * n_per_sample:(i + 1) * 2 * n_per_sample],
                n_per_sample, 2, rng)
    shuffle(flat, n_pixel_samples, 2 * n_per_sample, rng)
    return out


def _multiply_generator(C, a):
    v = 0
    i = 0
    while a:
        if a & 1:
            v ^= int(C[i])
        a >>= 1
        i += 1
    return v


def sample_generator_matrix(C, a, scramble=0):
    return min(
        np.float32(_multiply_generator(C, a) ^ scramble)
        * np.float32(2.3283064365386963e-10),
        ONE_MINUS_EPS,
    )


def _maxmin_cpixel(spp):
    table = np.load(Path(__file__).resolve().parent.parent / "data"
                    / "maxmin_dist.npy")
    return table[int(np.log2(spp))].astype(np.uint64)


def start_pixel(name, spp, n1d_dims, n2d_dims, rng, strat_xy=None):
    """One StartPixel: returns (samples1D [n1d,spp], samples2D [n2d,spp,2]),
    consuming rng exactly as the reference sampler does."""
    s1 = np.empty((n1d_dims, spp), np.float32)
    s2 = np.empty((n2d_dims, spp, 2), np.float32)
    if name == "stratified":
        nx, ny = strat_xy or (int(np.sqrt(spp)), int(np.sqrt(spp)))
        assert nx * ny == spp
        for i in range(n1d_dims):
            s1[i] = stratified_sample_1d(spp, rng)
            shuffle(s1[i], spp, 1, rng)
        for i in range(n2d_dims):
            arr = stratified_sample_2d(nx, ny, rng)
            flat = arr.reshape(-1)
            shuffle(flat, spp, 2, rng)
            s2[i] = flat.reshape(spp, 2)
    elif name == "zerotwosequence":
        for i in range(n1d_dims):
            s1[i] = van_der_corput(1, spp, rng)
        for i in range(n2d_dims):
            s2[i] = sobol_2d(1, spp, rng)
    elif name == "maxmindist":
        cpix = _maxmin_cpixel(spp)
        inv = np.float32(1.0) / np.float32(spp)
        for i in range(spp):
            s2[0, i, 0] = np.float32(i) * inv
            s2[0, i, 1] = sample_generator_matrix(cpix, i)
        flat0 = s2[0].reshape(-1)
        shuffle(flat0, spp, 2, rng)
        s2[0] = flat0.reshape(spp, 2)
        for i in range(n1d_dims):
            s1[i] = van_der_corput(1, spp, rng)
        for i in range(1, n2d_dims):
            s2[i] = sobol_2d(1, spp, rng)
    else:
        raise ValueError(name)
    return s1, s2


def exact_pixel_tables(name, pixels, spp, n1d_dims, n2d_dims, seed=None,
                       strat_xy=None):
    """Sample tables for a sequence of pixels visited by ONE sampler
    instance (pbrt's per-tile clone): seed=None reproduces the default-
    constructed RNG; an int reproduces Clone(seed).

    Returns (s1 [npix, n1d, spp], s2 [npix, n2d, spp, 2])."""
    rng = PCG32(seed)
    s1s, s2s = [], []
    for _ in range(len(pixels)):
        s1, s2 = start_pixel(name, spp, n1d_dims, n2d_dims, rng,
                             strat_xy=strat_xy)
        s1s.append(s1)
        s2s.append(s2)
    return np.stack(s1s), np.stack(s2s)
