"""Host-side bit-exact sample tables: the exact sampler mode
(PBRT_TPU_EXACT_SAMPLER=1).

Port of pbrt_tpu/samplers/exact_tables.py.  pbrt's radical inverses
accumulate reversedDigits exactly in uint64 and do the rest in float
(lowdiscrepancy.h:50-140); the in-graph halton (core/lowdiscrepancy.py)
accumulates the digits in float32, 1-2 ulp away in the returned sample.
This module computes the values as pbrt does, in numpy on the host, and
the path integrator reads them from a [D, N] table (one row per dimension)
instead of computing them:

* halton: every dimension a path draws (halton_exact_table, one table per
  spp batch);
* the PixelSamplers stratified, zerotwosequence and maxmin: the 10 linear
  dims their per-pixel arrays back (the camera's 0-4 and bounce 0's
  select, light and scatter draws), in pbrt's per-tile RNG order
  (pixel_exact_table); the path integrator draws the remaining dims
  statelessly (integrators/path.py).  The JAX package rebuilds a tile's
  arrays for every spp batch; the port builds every sample's at once, once
  a render, and takes one sample's rows a batch: the same values.

Tile origin assumption, as in the JAX package: sampleBounds equals the
cropped pixel bounds (true for the box filter of radius 0.5; a wider
filter shifts pbrt's tile grid by its radius).
"""
from __future__ import annotations

import math

import numpy as np

from ..core import lowdiscrepancy as ld

# f32 OneMinusEpsilon (pbrt.h:417): the clamp applied after the f64 math.
ONE_MINUS_EPSILON = np.float32(np.nextafter(np.float32(1.0), np.float32(0.0)))
PIXEL_EXACT_SAMPLERS = ("stratified", "zerotwosequence", "maxmindist", "maxmin")
_TILE = 16  # pbrt tileSize (integrator.cpp:243)
N_PIXEL_TABLE_DIMS = 10  # linear dims 0..9 covered by the arrays


def _radical_inverse_pbrt(base_index: int, a: np.ndarray) -> np.ndarray:
    """RadicalInverseSpecialized as pbrt computes it (Float = float):
    reversedDigits exact in uint64; invBaseN and the last multiply in f32."""
    a = a.astype(np.uint64)
    if base_index == 0:
        # ReverseBits64(a) * 0x1p-64 (a double literal), returned as Float.
        rev = np.zeros_like(a)
        x = a.copy()
        for _ in range(64):
            rev = (rev << np.uint64(1)) | (x & np.uint64(1))
            x >>= np.uint64(1)
        return (rev.astype(np.float64) * np.float64(2.0 ** -64)).astype(np.float32)
    base = int(ld.PRIMES[base_index])
    inv_base = np.float32(1.0 / np.float32(base))
    reversed_digits = np.zeros(a.shape, np.uint64)
    inv_base_n = np.ones(a.shape, np.float32)
    x = a.copy()
    while x.any():
        nxt = x // np.uint64(base)
        digit = x - nxt * np.uint64(base)
        live = x > 0
        reversed_digits = np.where(
            live, reversed_digits * np.uint64(base) + digit, reversed_digits)
        inv_base_n = np.where(live, (inv_base_n * inv_base).astype(np.float32),
                              inv_base_n)
        x = nxt
    val = (reversed_digits.astype(np.float32) * inv_base_n).astype(np.float32)
    return np.minimum(val, ONE_MINUS_EPSILON)


def _scrambled_radical_inverse_pbrt(base_index: int, a: np.ndarray,
                                    perm: np.ndarray) -> np.ndarray:
    """ScrambledRadicalInverseSpecialized (lowdiscrepancy.cpp:407), Float =
    float, reversedDigits exact in uint64."""
    base = int(ld.PRIMES[base_index])
    inv_base = np.float32(1.0 / np.float32(base))
    a = a.astype(np.uint64)
    reversed_digits = np.zeros(a.shape, np.uint64)
    inv_base_n = np.ones(a.shape, np.float32)
    x = a.copy()
    for _ in range(int(math.ceil(64 / math.log2(base))) + 1):
        nxt = x // np.uint64(base)
        digit = (x - nxt * np.uint64(base)).astype(np.int64)
        live = x > 0
        pd = perm[digit].astype(np.uint64)
        reversed_digits = np.where(
            live, reversed_digits * np.uint64(base) + pd, reversed_digits)
        inv_base_n = np.where(live, (inv_base_n * inv_base).astype(np.float32),
                              inv_base_n)
        x = nxt
    perm0 = np.float32(perm[0])
    # invBaseN * (reversedDigits + invBase * perm[0] / (1 - invBase)), every
    # operation in f32, in C++'s order.
    tail = np.float32(np.float32(inv_base * perm0)
                      / np.float32(np.float32(1.0) - inv_base))
    val = (inv_base_n * (reversed_digits.astype(np.float32) + tail)
           .astype(np.float32)).astype(np.float32)
    return np.minimum(val, ONE_MINUS_EPSILON)


def halton_indices(cfg, pixels: np.ndarray, sample_num: int) -> np.ndarray:
    """Per-lane global Halton sample index (halton.cpp:96-118), numpy."""
    base_scales, base_exps, stride, mult_inv = cfg.halton_setup()
    px = pixels[:, 0].astype(np.int64) % 128  # kMaxResolution
    py = pixels[:, 1].astype(np.int64) % 128

    def inverse_radical_inverse(base, x, n_digits):
        idx = np.zeros_like(x)
        for _ in range(n_digits):
            idx = idx * base + x % base
            x = x // base
        return idx

    off0 = inverse_radical_inverse(2, px, base_exps[0])
    off1 = inverse_radical_inverse(3, py, base_exps[1])
    offset = (off0 * (stride // base_scales[0]) * mult_inv[0]
              + off1 * (stride // base_scales[1]) * mult_inv[1]) % stride
    return (offset + np.int64(sample_num) * stride).astype(np.uint64)


def halton_exact_table(cfg, pixels: np.ndarray, sample_num: int,
                       n_dims: int) -> np.ndarray:
    """[N, n_dims] f32 table of SampleDimension(index, dim), computed as
    pbrt does (f64 accumulation, f32 cast)."""
    base_scales, base_exps, _, _ = cfg.halton_setup()
    idx = halton_indices(cfg, np.asarray(pixels), int(sample_num))
    out = np.empty((idx.shape[0], n_dims), np.float32)
    for dim in range(n_dims):
        if dim == 0:
            v = _radical_inverse_pbrt(0, idx >> np.uint64(base_exps[0]))
        elif dim == 1:
            v = _radical_inverse_pbrt(1, idx // np.uint64(base_scales[1]))
        else:
            v = _scrambled_radical_inverse_pbrt(dim, idx, ld.prime_permutation(dim))
        out[:, dim] = np.minimum(v, ONE_MINUS_EPSILON)
    return out


def pixel_exact_table(name: str, pixels, spp: int, strat_xy=None) -> np.ndarray:
    """[spp, N_PIXEL_TABLE_DIMS, n_pix] f32: for every sample number, the
    array-backed linear dims of every pixel, in pbrt's per-tile RNG order
    (a clone seeded tileY * nTilesX + tileX, pixels in x-fastest order
    within the tile, integrator.cpp:240-258).  `pixels` [N, 2] must be the
    whole cropped row-major grid."""
    from .pixel_exact import exact_pixel_tables

    name = {"maxmin": "maxmindist"}.get(name, name)
    pixels = np.asarray(pixels)
    n = pixels.shape[0]
    x0, y0 = pixels[:, 0].min(), pixels[:, 1].min()
    x1 = pixels[:, 0].max() + 1
    n_tiles_x = -(-(x1 - x0) // _TILE)
    tile_id = ((pixels[:, 1] - y0) // _TILE) * n_tiles_x + (pixels[:, 0] - x0) // _TILE
    out = np.zeros((spp, N_PIXEL_TABLE_DIMS, n), np.float32)
    for t in np.unique(tile_id):
        sel = np.nonzero(tile_id == t)[0]
        rows = sel[np.lexsort((pixels[sel, 0], pixels[sel, 1]))]
        s1, s2 = exact_pixel_tables(name, pixels[rows], spp, 4, 4, seed=int(t),
                                    strat_xy=strat_xy)
        # 2-D calls: film 0, lens 1, bounce 0's uLight 2 and uScattering 3;
        # 1-D calls: time 0, bounce 0's light select 1
        for dim, arr in ((0, s2[:, 0, :, 0]), (1, s2[:, 0, :, 1]), (2, s1[:, 0]),
                         (3, s2[:, 1, :, 0]), (4, s2[:, 1, :, 1]), (5, s1[:, 1]),
                         (6, s2[:, 2, :, 0]), (7, s2[:, 2, :, 1]),
                         (8, s2[:, 3, :, 0]), (9, s2[:, 3, :, 1])):
            out[:, dim, rows] = arr.T
    return out
