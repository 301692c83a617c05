"""Stateless samplers: (pixel, sample number, dimension) -> float.

Port of pbrt_tpu/samplers/samplers.py.  A sampler state is the per-lane
global sample index (or key), computed once per spp batch; ``get_1d`` and
``get_2d`` take a static dimension that the integrator advances in pbrt's
consumption order.  The halton ``[D, N]`` table of
pbrt_tpu/integrators/path.py:628-640 is ``halton_table``.

Samplers: sobol and halton (pbrt's GlobalSamplers, bit math), random (one
PCG32 stream a lane, drawn in call order), and the PixelSamplers
stratified, zerotwosequence and maxmin as the JAX package re-expresses them:
stateless counter hashes keyed by (pixel, dim) and Kensler's cycle-walking
permutation of the sample index, not pbrt's per-tile RNG streams (those
come from samplers/exact_tables.py in the exact mode).

uint32 quantities live in int64 tensors, masked to 32 bits after every
product or left shift.  The JAX package's ``get_1d_dyn``/``get_2d_dyn``
(a traced per-lane dimension, for its lax.scan bounce body) have no
counterpart: the port's bounce loops are unrolled with static dimensions,
and for the dims >= 5 the scan draws, the dynamic forms equal the static
ones (tests/test_torch_imaging.py holds them equal).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from pathlib import Path

import numpy as np
import torch

from ..core import lowdiscrepancy as ld
from ..core import rng as prng

K_MAX_RESOLUTION = 128  # halton.cpp:42 kMaxResolution
SUPPORTED = ("halton", "sobol", "random", "stratified", "zerotwosequence",
             "maxmin")
M32 = ld.M32
_DATA = Path(__file__).resolve().parent.parent / "data"


def _round_up_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    name: str  # one of SUPPORTED
    spp: int
    resolution: tuple  # full image resolution (x, y)
    sample_bounds_min: tuple = (0, 0)
    seed: int = 0
    # The exact-tables mode (samplers/exact_tables.py): halton's whole
    # stream, or a PixelSampler's array-backed dims, computed on the host
    # exactly as pbrt does and read from a [D, N] table.
    exact: bool = False

    def __post_init__(self):
        if self.name not in SUPPORTED:
            raise NotImplementedError(
                f"sampler {self.name!r}: the port has {SUPPORTED}")

    def halton_setup(self):
        res = (min(self.resolution[0], K_MAX_RESOLUTION),
               min(self.resolution[1], K_MAX_RESOLUTION))
        base_scales, base_exps = [], []
        for i, base in enumerate((2, 3)):
            scale, exp = 1, 0
            while scale < res[i]:
                scale *= base
                exp += 1
            base_scales.append(scale)
            base_exps.append(exp)
        stride = base_scales[0] * base_scales[1]
        mult_inv = [
            pow(base_scales[1] % base_scales[0], -1, base_scales[0]),
            pow(base_scales[0] % base_scales[1], -1, base_scales[1]),
        ]
        return base_scales, base_exps, stride, mult_inv

    @property
    def sobol_log2_resolution(self) -> int:
        return int(math.log2(_round_up_pow2(max(self.resolution))))


def _hash_combine(*xs):
    """samplers.py:_hash_combine: each term a tensor or an int."""
    h = 0x9E3779B9
    for x in xs:
        h = prng.mix32(h ^ ((x * 0x85EBCA6B) & M32))
    return h


def _kensler_permute(i, n: int, key):
    """Stateless keyed permutation of [0, n) (samplers.py:_kensler_permute):
    a balanced 4-round Feistel network over the next power-of-4 domain,
    applied again to the lanes that land outside [0, n) until none do."""
    if n <= 1:
        return torch.zeros_like(i)
    nbits = max((n - 1).bit_length(), 2)
    nbits += nbits & 1
    h = nbits // 2
    hmask = (1 << h) - 1

    def feistel(x):
        left, right = (x >> h) & hmask, x & hmask
        for r in range(4):
            f = prng.mix32(right ^ key ^ ((r * 0x9E3779B9) & M32)) & hmask
            left, right = right, left ^ f
        return (left << h) | right

    s = feistel(i)
    while bool((s >= n).any()):
        s = torch.where(s >= n, feistel(s), s)
    return s


def _strat_xy(spp: int):
    """The strata of a stratified 2-D draw: the most square factorisation
    of spp (samplers.py:_strat_xy)."""
    xs = int(math.sqrt(spp))
    while xs > 1 and spp % xs:
        xs -= 1
    return max(xs, 1), spp // max(xs, 1)


@functools.cache
def _maxmin_matrix(spp: int) -> tuple:
    """CMaxMinDist's generator matrix for spp samples (maxmin.cpp:47-72),
    from the port's copy of the JAX package's data/maxmin_dist.npy."""
    table = np.load(_DATA / "maxmin_dist.npy")
    return tuple(int(c) for c in table[min(max(spp.bit_length() - 1, 0), 16)])


@functools.cache
def _sobol02_matrices() -> tuple:
    """The two Sobol' (0,2)-sequence matrices (lowdiscrepancy.h:203-228)."""
    m = ld.sobol_tables()["sobol_matrices32"]
    return tuple(int(c) for c in m[0, :32]), tuple(int(c) for c in m[1, :32])


def _multiply_generator(c: tuple, a):
    """v = C a over GF(2): the XOR of the columns c[i] at a's set bits."""
    v = torch.zeros_like(a)
    for i in range(32):
        v = v ^ torch.where(((a >> i) & 1) != 0, c[i], 0)
    return v


def init_state(cfg: SamplerConfig, pixel_xy, sample_num):
    """Per-lane global sample indices (or keys).  pixel_xy: [N, 2] integer
    tensor; sample_num: [N] pixel-local sample number."""
    px = pixel_xy[..., 0].to(torch.int64)
    py = pixel_xy[..., 1].to(torch.int64)
    sample_num = sample_num.to(torch.int64) & M32
    if cfg.name == "sobol":
        hi, lo = ld.sobol_interval_to_index(
            cfg.sobol_log2_resolution, sample_num,
            px - cfg.sample_bounds_min[0], py - cfg.sample_bounds_min[1],
        )
        return {"hi": hi, "lo": lo, "px": px, "py": py}
    if cfg.name == "random":
        seed = ((py * cfg.resolution[0] + px) * max(cfg.spp, 1) + sample_num
                + cfg.seed) & M32
        return {"rng": prng.make(seed), "px": px, "py": py}
    if cfg.name in ("stratified", "zerotwosequence", "maxmin"):
        pixel_key = _hash_combine((py * cfg.resolution[0] + px) & M32,
                                  cfg.seed & M32)
        return {"pixel_key": pixel_key, "s": sample_num, "px": px, "py": py}
    base_scales, base_exps, stride, mult_inv = cfg.halton_setup()
    pm0 = px % K_MAX_RESOLUTION
    pm1 = py % K_MAX_RESOLUTION

    def inverse_radical_inverse(base, x, n_digits):
        idx = torch.zeros_like(x)
        for _ in range(n_digits):
            idx = idx * base + x % base
            x = x // base
        return idx

    off0 = inverse_radical_inverse(2, pm0, base_exps[0])
    off1 = inverse_radical_inverse(3, pm1, base_exps[1])
    # int32 arithmetic in the reference; these products stay far below 2^31.
    offset = (off0 * (stride // base_scales[0]) * mult_inv[0]
              + off1 * (stride // base_scales[1]) * mult_inv[1]) % stride
    index = (offset + sample_num * stride) & M32
    return {"index": index, "px": px, "py": py}


def _stratum(n: int, j, u):
    """min((j + u) / n, OneMinusEpsilon) in float32."""
    return torch.clamp((j.to(torch.float32) + u) / n, max=ld.ONE_MINUS_EPSILON)


def get_1d(cfg: SamplerConfig, state, dim: int):
    """Sampler::Get1D at a static dimension.  The random sampler draws the
    next value of each lane's stream, whatever dim is."""
    if "table" in state:
        return state["table"][dim]
    if cfg.name == "sobol":
        s = ld.sobol_sample_float64idx(state["hi"], state["lo"], dim)
        if dim < 2:
            # Pixel dims are remapped into the pixel (sobol.cpp:54-60).
            res = 1 << cfg.sobol_log2_resolution
            s = s * float(res) + float(cfg.sample_bounds_min[dim])
            pix = (state["px"] if dim == 0 else state["py"]).to(torch.float32)
            s = torch.clamp(s - pix, 0.0, ld.ONE_MINUS_EPSILON)
        return s
    if cfg.name == "random":
        state["rng"], u = prng.next_float(state["rng"])
        return u
    if cfg.name == "stratified":
        # StratifiedSample1D + Shuffle (stratified.cpp:50-73), stateless.
        spp = max(cfg.spp, 1)
        key = _hash_combine(state["pixel_key"], dim)
        j = _kensler_permute(state["s"], spp, key)
        jit = ld.bits_to_float(prng.mix32(key ^ prng.mix32(state["s"] + 0xABCD)))
        return _stratum(spp, j, jit)
    if cfg.name in ("zerotwosequence", "maxmin"):
        # van der Corput, scrambled per (pixel, dim).
        scramble = _hash_combine(state["pixel_key"], dim)
        return ld.bits_to_float(ld.reverse_bits_32(state["s"]) ^ scramble)
    index = state["index"]
    base_scales, base_exps, _, _ = cfg.halton_setup()
    if dim == 0:
        return ld.radical_inverse(0, index >> base_exps[0])
    if dim == 1:
        return ld.radical_inverse(1, index // base_scales[1])
    return ld.scrambled_radical_inverse_fast(dim, index)


def get_2d(cfg: SamplerConfig, state, dim: int):
    """Sampler::Get2D at a static dimension: dims dim and dim + 1."""
    if "table" not in state and cfg.name == "stratified":
        # StratifiedSample2D (stratified.cpp:55): xs x ys strata, shuffled.
        xs, ys = _strat_xy(max(cfg.spp, 1))
        key = _hash_combine(state["pixel_key"], dim, 77)
        j = _kensler_permute(state["s"], xs * ys, key)
        s = state["s"]
        ux = ld.bits_to_float(prng.mix32(key ^ prng.mix32(s + 0x1111)))
        uy = ld.bits_to_float(prng.mix32(key ^ prng.mix32(s + 0x2222)))
        return torch.stack([_stratum(xs, j % xs, ux), _stratum(ys, j // xs, uy)], -1)
    if "table" not in state and cfg.name in ("zerotwosequence", "maxmin"):
        s = state["s"]
        s0 = _hash_combine(state["pixel_key"], dim, 1)
        s1 = _hash_combine(state["pixel_key"], dim, 2)
        if cfg.name == "maxmin" and dim < 2:
            # CMaxMinDist for the first 2-D draw, paired with van der
            # Corput (maxmin.cpp:47-72); Sobol02 beyond.
            x = _multiply_generator(_maxmin_matrix(max(cfg.spp, 1)), s) ^ s0
            y = ld.reverse_bits_32(s) ^ s1
        else:
            # Sobol02 with per-(pixel, dim) scrambles (lowdiscrepancy.h:203-228).
            c0, c1 = _sobol02_matrices()
            x = _multiply_generator(c0, s) ^ s0
            y = _multiply_generator(c1, s) ^ s1
        return torch.stack([ld.bits_to_float(x), ld.bits_to_float(y)], -1)
    return torch.stack([get_1d(cfg, state, dim), get_1d(cfg, state, dim + 1)], -1)


def halton_table(cfg: SamplerConfig, state, n_dims: int):
    """[D, N] table of halton dims 0..D-1, one contiguous row per dim
    (pbrt_tpu/integrators/path.py:628-640); get_1d then reads rows."""
    return torch.stack([get_1d(cfg, state, dd) for dd in range(n_dims)], 0)


def get_camera_sample(cfg: SamplerConfig, state, pixel_xy):
    """Sampler::GetCameraSample (sampler.cpp:46-52): dims 0-4.
    Returns (p_film [N, 2], time [N], p_lens [N, 2])."""
    p_film = pixel_xy.to(torch.float32) + get_2d(cfg, state, 0)
    return p_film, get_1d(cfg, state, 2), get_2d(cfg, state, 3)
