"""Stateless samplers: (pixel, sample number, dimension) -> float.

Port of pbrt_tpu/samplers/samplers.py for the ``halton`` and ``sobol``
samplers (the bit-exact ones).  A sampler state is the per-lane global sample
index, computed once per spp batch; ``get_1d``/``get_2d`` take a static
dimension that the integrator advances in pbrt's consumption order.  The
halton ``[D, N]`` table of pbrt_tpu/integrators/path.py:628-640 is
``halton_table``.  Every other sampler raises NotImplementedError.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..core import lowdiscrepancy as ld

K_MAX_RESOLUTION = 128  # halton.cpp:42 kMaxResolution
SUPPORTED = ("halton", "sobol")


def _round_up_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    name: str  # "halton" | "sobol"
    spp: int
    resolution: tuple  # full image resolution (x, y)
    sample_bounds_min: tuple = (0, 0)

    def __post_init__(self):
        if self.name not in SUPPORTED:
            raise NotImplementedError(
                f"sampler {self.name!r}: the port has {SUPPORTED} only")

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


def init_state(cfg: SamplerConfig, pixel_xy, sample_num):
    """Per-lane global sample indices.  pixel_xy: [N, 2] integer tensor;
    sample_num: [N] pixel-local sample number."""
    px = pixel_xy[..., 0].to(torch.int64)
    py = pixel_xy[..., 1].to(torch.int64)
    sample_num = sample_num.to(torch.int64) & ld.M32
    if cfg.name == "sobol":
        hi, lo = ld.sobol_interval_to_index(
            cfg.sobol_log2_resolution, sample_num,
            px - cfg.sample_bounds_min[0], py - cfg.sample_bounds_min[1],
        )
        return {"hi": hi, "lo": lo, "px": px, "py": py}
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
    index = (offset + sample_num * stride) & ld.M32
    return {"index": index, "px": px, "py": py}


def get_1d(cfg: SamplerConfig, state, dim: int):
    """Sampler::Get1D at a static dimension."""
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
    index = state["index"]
    base_scales, base_exps, _, _ = cfg.halton_setup()
    if dim == 0:
        return ld.radical_inverse(0, index >> base_exps[0])
    if dim == 1:
        return ld.radical_inverse(1, index // base_scales[1])
    return ld.scrambled_radical_inverse_fast(dim, index)


def get_2d(cfg: SamplerConfig, state, dim: int):
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
