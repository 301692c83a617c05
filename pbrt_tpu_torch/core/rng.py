"""PCG32 on Python integers: port of pbrt_tpu/core/rng.py:ScalarPcg32.

pbrt seeds its Halton permutation tables from a default-seeded PCG32
(halton.cpp:69-71); this bit-exact scalar generator reproduces that stream
host-side (rng.h:61-118, including the bounded-draw rejection loop that
Shuffle uses).
"""
from __future__ import annotations

PCG32_DEFAULT_STATE = 0x853C49E6748FEA9B
PCG32_DEFAULT_STREAM = 0xDA3E39CB94B95BDB
PCG32_MULT = 0x5851F42D4C957F2D
_M32 = 0xFFFFFFFF
_M64 = 0xFFFFFFFFFFFFFFFF


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
