"""Sobol' and scrambled-Halton sample math, port of
pbrt_tpu/core/lowdiscrepancy.py (the parts the sobol and halton samplers use).

uint32 quantities live in int64 tensors and are masked with 0xFFFFFFFF after
every shift that could carry past bit 31, because PyTorch's uint32 coverage
is partial.  The float32 arithmetic follows the JAX package's operation order
so the samples agree bit for bit.

Halton permutations: pbrt shuffles every prime's identity permutation with
one default-seeded PCG32, prime after prime (halton.cpp:69-71,
lowdiscrepancy.cpp:2490-2504).  Because the stream runs across primes in
order, the permutations of the first k primes are exact without generating
the rest; ``radical_inverse_permutations(k)`` does only that and caches the
result under build/.
"""
from __future__ import annotations

import functools
import math
import os
import tempfile
from pathlib import Path

import numpy as np
import torch

from .rng import ScalarPcg32

ONE_MINUS_EPSILON = float(np.float32(1.0) - np.finfo(np.float32).eps / 2)
INV_2_32 = 2.3283064365386963e-10
M32 = 0xFFFFFFFF
SOBOL_MATRIX_SIZE = 52
PRIME_TABLE_SIZE = 1000

_DATA = Path(__file__).resolve().parent.parent / "data" / "sobol.npz"
_BUILD = Path(__file__).resolve().parents[2] / "build"


def _gen_primes(n: int) -> np.ndarray:
    primes = []
    c = 2
    while len(primes) < n:
        if all(c % p for p in primes if p * p <= c):
            primes.append(c)
        c += 1
    return np.array(primes, dtype=np.int64)


PRIMES = _gen_primes(PRIME_TABLE_SIZE)
PRIME_SUMS = np.concatenate([[0], np.cumsum(PRIMES)[:-1]]).astype(np.int64)


def f32(x) -> float:
    """x rounded to float32, as a Python float (exact in any later cast)."""
    return float(np.float32(x))


@functools.cache
def sobol_tables() -> dict:
    z = np.load(_DATA)
    return {k: z[k].astype(np.int64) for k in z.files}


@functools.cache
def radical_inverse_permutations(n_primes: int) -> np.ndarray:
    """Digit permutations of the first `n_primes` primes, concatenated
    (offset of prime i: PRIME_SUMS[i]).  Generated once and cached in
    build/halton_perms_<n>.npy."""
    if not 1 <= n_primes <= PRIME_TABLE_SIZE:
        raise ValueError(f"n_primes must be in [1, {PRIME_TABLE_SIZE}]")
    cache = _BUILD / f"halton_perms_{n_primes}.npy"
    if cache.exists():
        return np.load(cache)
    rng = ScalarPcg32()
    perms = np.zeros(int(PRIMES[:n_primes].sum()), dtype=np.int64)
    off = 0
    for p in PRIMES[:n_primes]:
        arr = list(range(int(p)))
        rng.shuffle(arr)
        perms[off: off + p] = arr
        off += p
    _BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".npy", dir=_BUILD)
    with os.fdopen(fd, "wb") as fh:
        np.save(fh, perms)
    os.replace(tmp, cache)
    return perms


def reverse_bits_32(b):
    b = b & M32
    b = ((b << 16) | (b >> 16)) & M32
    b = ((b & 0x00FF00FF) << 8) | ((b & 0xFF00FF00) >> 8)
    b = ((b & 0x0F0F0F0F) << 4) | ((b & 0xF0F0F0F0) >> 4)
    b = ((b & 0x33333333) << 2) | ((b & 0xCCCCCCCC) >> 2)
    b = ((b & 0x55555555) << 1) | ((b & 0xAAAAAAAA) >> 1)
    return b


def bits_to_float(v):
    """uint32 bits -> [0, 1) float32 (the shared tail of the samplers)."""
    return torch.clamp(v.to(torch.float32) * INV_2_32, max=ONE_MINUS_EPSILON)


def _num_digits(base: int) -> int:
    return int(math.ceil(32 / math.log2(base))) + 1


def radical_inverse(base_index: int, a):
    """RadicalInverse (unscrambled) for uint32 indices in an int64 tensor."""
    if base_index == 0:
        return bits_to_float(reverse_bits_32(a))
    base = int(PRIMES[base_index])
    inv_base = f32(1.0 / base)
    rev = torch.zeros(a.shape, dtype=torch.float32, device=a.device)
    inv_n = torch.ones(a.shape, dtype=torch.float32, device=a.device)
    for _ in range(_num_digits(base)):
        nxt = a // base
        digit = a - nxt * base
        live = a > 0
        rev = torch.where(live, rev * base + digit.to(torch.float32), rev)
        inv_n = torch.where(live, inv_n * inv_base, inv_n)
        a = nxt
    return torch.clamp(rev * inv_n, max=ONE_MINUS_EPSILON)


def scrambled_radical_inverse(base_index: int, a, perm):
    """ScrambledRadicalInverse (lowdiscrepancy.cpp:407) with the digit
    permutation `perm` (int64 tensor of length PRIMES[base_index]).  Same
    float32 recurrence, in the same order, as the JAX package's per-digit
    and digit-pair forms."""
    base = int(PRIMES[base_index])
    inv_base = np.float32(1.0 / base)
    rev = torch.zeros(a.shape, dtype=torch.float32, device=a.device)
    inv_n = torch.ones(a.shape, dtype=torch.float32, device=a.device)
    permf = perm.to(torch.float32)
    for _ in range(_num_digits(base)):
        nxt = a // base
        digit = a - nxt * base
        live = a > 0
        rev = torch.where(live, rev * base + permf[digit], rev)
        inv_n = torch.where(live, inv_n * float(inv_base), inv_n)
        a = nxt
    perm0 = np.float32(float(perm[0]))
    tail = float(inv_base * perm0 / (np.float32(1.0) - inv_base))
    return torch.clamp(inv_n * (rev + tail), max=ONE_MINUS_EPSILON)


def prime_permutation(base_index: int) -> np.ndarray:
    """The digit permutation of prime `base_index`.  Prefixes come in
    multiples of 64 primes, so one cached table serves every dimension a
    path of depth <= 7 draws."""
    perms = radical_inverse_permutations(
        min(64 * (base_index // 64 + 1), PRIME_TABLE_SIZE))
    off = int(PRIME_SUMS[base_index])
    return perms[off: off + int(PRIMES[base_index])]


@functools.cache
def _perm_tables(base_index: int, device: torch.device):
    """(digit permutation, digit-pair table) of prime `base_index` on
    `device`, uploaded once.  Pair entry v packs perm[v % p] (bits 0-8) |
    perm[v // p] << 9."""
    perm = prime_permutation(base_index)
    p = perm.shape[0]
    v = np.arange(p * p, dtype=np.int64)
    pairs = perm[v % p] | (perm[v // p] << 9)
    return torch.as_tensor(perm, device=device), torch.as_tensor(pairs, device=device)


_PAIR_TABLE_MAX_BASE = 509  # the 9-bit packing bound


def scrambled_radical_inverse_fast(base_index: int, a):
    """scrambled_radical_inverse taking two digits per step through the
    digit-pair table, with the same float32 recurrence in the same order, so
    the bits are equal.  Bases up to 31 and above 509 take the per-digit
    form, as in the JAX package."""
    base = int(PRIMES[base_index])
    if base <= 31 or base > _PAIR_TABLE_MAX_BASE:
        perm = torch.as_tensor(prime_permutation(base_index), device=a.device)
        return scrambled_radical_inverse(base_index, a, perm)
    perm, tab = _perm_tables(base_index, a.device)
    p2 = base * base
    inv_base = np.float32(1.0 / base)
    rev = torch.zeros(a.shape, dtype=torch.float32, device=a.device)
    inv_n = torch.ones(a.shape, dtype=torch.float32, device=a.device)
    for _ in range((_num_digits(base) + 1) // 2):
        nxt2 = a // p2
        w = tab[a - nxt2 * p2]
        pd0 = (w & 511).to(torch.float32)
        pd1 = ((w >> 9) & 511).to(torch.float32)
        live0 = a > 0
        live1 = a >= base  # the second digit is live iff a // base > 0
        rev = torch.where(live0, rev * base + pd0, rev)
        inv_n = torch.where(live0, inv_n * float(inv_base), inv_n)
        rev = torch.where(live1, rev * base + pd1, rev)
        inv_n = torch.where(live1, inv_n * float(inv_base), inv_n)
        a = nxt2
    perm0 = np.float32(prime_permutation(base_index)[0])
    tail = float(inv_base * perm0 / (np.float32(1.0) - inv_base))
    return torch.clamp(inv_n * (rev + tail), max=ONE_MINUS_EPSILON)


def sobol_sample_bits64(index_hi, index_lo, dim: int):
    """XOR of generator-matrix columns for the set bits of a 64-bit
    (hi, lo) index (up to 52 bits), at a static dimension."""
    cols = sobol_tables()["sobol_matrices32"][dim].tolist()
    v = torch.zeros_like(index_lo)
    for i in range(SOBOL_MATRIX_SIZE):
        word, sh = (index_lo, i) if i < 32 else (index_hi, i - 32)
        bit = ((word >> sh) & 1) != 0
        v = v ^ torch.where(bit, cols[i], 0)
    return v


def sobol_sample_float64idx(index_hi, index_lo, dim: int):
    return bits_to_float(sobol_sample_bits64(index_hi, index_lo, dim))


def sobol_interval_to_index(m: int, frame, px, py):
    """Global Sobol index of sample `frame` in pixel (px, py)
    (lowdiscrepancy.h:229-249); returns the (hi, lo) uint32 pair."""
    if m == 0:
        return torch.zeros_like(frame), frame
    if m > 16:
        raise NotImplementedError("resolutions beyond 65536 need 64-bit "
                                  "pixel packing")
    t = sobol_tables()
    vdc_hi = t["vdc_hi"][m - 1].tolist()
    vdc_lo = t["vdc_lo"][m - 1].tolist()
    vdci_hi = t["vdc_inv_hi"][m - 1].tolist()
    vdci_lo = t["vdc_inv_lo"][m - 1].tolist()
    m2 = 2 * m
    if m2 < 32:
        index_hi = frame >> (32 - m2)
        index_lo = (frame << m2) & M32
    else:
        index_hi = (frame << (m2 - 32)) & M32
        index_lo = torch.zeros_like(frame)
    delta_hi = torch.zeros_like(frame)
    delta_lo = torch.zeros_like(frame)
    for c in range(32):
        bit = ((frame >> c) & 1) != 0
        delta_hi = delta_hi ^ torch.where(bit, vdc_hi[c], 0)
        delta_lo = delta_lo ^ torch.where(bit, vdc_lo[c], 0)
    b_lo = ((px << m) | py) ^ delta_lo
    b_hi = delta_hi
    for c in range(SOBOL_MATRIX_SIZE):
        word, sh = (b_lo, c) if c < 32 else (b_hi, c - 32)
        bit = ((word >> sh) & 1) != 0
        index_hi = index_hi ^ torch.where(bit, vdci_hi[c], 0)
        index_lo = index_lo ^ torch.where(bit, vdci_lo[c], 0)
    return index_hi, index_lo
