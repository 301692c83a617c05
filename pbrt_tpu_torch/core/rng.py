"""PCG32, port of pbrt_tpu/core/rng.py (rng.h:61-118).

``ScalarPcg32`` runs on Python integers: pbrt seeds its Halton permutation
tables from a default-seeded PCG32 (halton.cpp:69-71), and this bit-exact
scalar generator reproduces that stream host-side, including the
bounded-draw rejection loop that Shuffle uses.

``make`` / ``next_uint32`` / ``next_float`` are the vectorised generator of
the random sampler, one stream per lane.  The JAX package emulates the
64-bit state in 32-bit halves; here it is one int64 tensor holding the
uint64 bit pattern.  A product or sum of two int64 wraps to the same low
64 bits as the unsigned one, and the right shifts are arithmetic in int64,
so each is masked back to the bits a logical shift keeps.
"""
from __future__ import annotations

import torch

PCG32_DEFAULT_STATE = 0x853C49E6748FEA9B
PCG32_DEFAULT_STREAM = 0xDA3E39CB94B95BDB
PCG32_MULT = 0x5851F42D4C957F2D
_M32 = 0xFFFFFFFF
_M64 = 0xFFFFFFFFFFFFFFFF


def _i64(x: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    return x - (1 << 64) if x >= 1 << 63 else x


def mul32(x, c: int):
    """x * c mod 2^32 for x in [0, 2^32), an int or an int64 tensor: c split
    in 16-bit halves so each product stays below 2^49."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def mix32(x):
    """The 32-bit finaliser (murmur3-style) of the JAX package's counter
    hashes (samplers.py:_mix32, the media's tracking RNG), on an int or
    on uint32 values in an int64 tensor."""
    x = x & _M32
    x = x ^ (x >> 16)
    x = mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def make(seq):
    """RNG::SetSequence (rng.h:75) on a tensor of stream indices below 2^32:
    the per-lane (state, inc) pair, int64 tensors."""
    inc = ((seq.to(torch.int64) & _M32) << 1) | 1
    (s, _), _ = next_uint32((torch.zeros_like(inc), inc))
    state, _ = next_uint32((s + _i64(PCG32_DEFAULT_STATE), inc))
    return state


def next_uint32(state):
    """One PCG32 step (rng.h:85 UniformUInt32).  Returns (new_state, bits),
    the bits a uint32 in int64."""
    old, inc = state
    new = old * _i64(PCG32_MULT) + inc
    xorshifted = ((((old >> 18) & ((1 << 46) - 1)) ^ old) >> 27) & _M32
    rot = (old >> 59) & 31
    out = ((xorshifted >> rot) | (xorshifted << ((32 - rot) & 31))) & _M32
    return (new, inc), out


def next_float(state):
    """Uniform in [0, 1) (rng.h:93 UniformFloat).  Returns (new_state, u)."""
    from .lowdiscrepancy import bits_to_float

    state, bits = next_uint32(state)
    return state, bits_to_float(bits)


class ScalarPcg32:
    def __init__(self, seq: int | None = None):
        if seq is None:
            self.state = PCG32_DEFAULT_STATE
            self.inc = PCG32_DEFAULT_STREAM
        else:
            self.set_sequence(seq)

    def set_sequence(self, initseq: int):
        self.state = 0
        self.inc = ((initseq << 1) | 1) & _M64
        self.uniform_uint32()
        self.state = (self.state + PCG32_DEFAULT_STATE) & _M64
        self.uniform_uint32()

    def uniform_uint32(self) -> int:
        old = self.state
        self.state = (old * PCG32_MULT + self.inc) & _M64
        xorshifted = (((old >> 18) ^ old) >> 27) & _M32
        rot = old >> 59
        return ((xorshifted >> rot) | (xorshifted << ((~rot + 1) & 31))) & _M32

    def uniform_uint32_bounded(self, b: int) -> int:
        threshold = (~b + 1) % b if b > 0 else 0
        while True:
            r = self.uniform_uint32()
            if r >= threshold:
                return r % b

    def shuffle(self, arr):
        """pbrt's Shuffle (sampling.h:50), in place."""
        n = len(arr)
        for i in range(n):
            other = i + self.uniform_uint32_bounded(n - i)
            arr[i], arr[other] = arr[other], arr[i]
        return arr
