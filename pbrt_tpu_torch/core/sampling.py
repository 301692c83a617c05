"""Sampling warps, the power heuristic and Distribution1D.

Port of pbrt_tpu/core/sampling.py (the parts the path integrator uses).
Distribution1D is built host-side in float64 exactly as the JAX package
does and stored as float32 tensors.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

PI = math.pi
INV_PI = 1.0 / PI
PI_OVER_2 = PI / 2.0
PI_OVER_4 = PI / 4.0


def _vec(x, y, z):
    return torch.stack([x, y, z], dim=-1)


def uniform_sample_sphere(u):
    z = 1.0 - 2.0 * u[..., 0]
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * PI * u[..., 1]
    return _vec(r * torch.cos(phi), r * torch.sin(phi), z)


def concentric_sample_disk(u):
    """(sampling.cpp:113 ConcentricSampleDisk), pbrt's branch order."""
    u_off = 2.0 * u - 1.0
    x = u_off[..., 0]
    y = u_off[..., 1]
    degenerate = (x == 0.0) & (y == 0.0)
    use_x = torch.abs(x) > torch.abs(y)
    r = torch.where(use_x, x, y)
    theta = torch.where(
        use_x,
        PI_OVER_4 * (y / torch.where(x == 0.0, 1.0, x)),
        PI_OVER_2 - PI_OVER_4 * (x / torch.where(y == 0.0, 1.0, y)),
    )
    p = torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)
    return torch.where(degenerate[..., None], 0.0, p)


def cosine_sample_hemisphere(u):
    d = concentric_sample_disk(u)
    z = torch.sqrt(torch.clamp(
        1.0 - d[..., 0] * d[..., 0] - d[..., 1] * d[..., 1], min=0.0))
    return _vec(d[..., 0], d[..., 1], z)


def uniform_cone_pdf(cos_theta_max):
    """1 / (2 pi (1 - cos_theta_max)): inf where cos_theta_max is 1 (a point
    4096 radii or more from the sphere), with a zero gradient there; the
    single division gave 0 * inf = NaN in the backward pass."""
    full = cos_theta_max >= 1.0
    return torch.where(full, math.inf,
                       1.0 / (2.0 * PI * (1.0 - torch.where(full, 0.0,
                                                            cos_theta_max))))


def uniform_sample_triangle(u):
    su0 = torch.sqrt(u[..., 0])
    return torch.stack([1.0 - su0, u[..., 1] * su0], dim=-1)


def power_heuristic(nf, f_pdf, ng, g_pdf):
    """(sampling.h:167-174), with the JAX package's inf guards."""
    f = nf * f_pdf
    g = ng * g_pdf
    f_inf = torch.isinf(f * f)
    g_inf = torch.isinf(g * g)
    either = f_inf | g_inf
    fs = torch.where(either, 1.0, f)
    gs = torch.where(either, 1.0, g)
    w = (fs * fs) / torch.clamp(fs * fs + gs * gs, min=1e-18)
    w = torch.where(g_inf & ~f_inf, 0.0, w)
    return torch.where(f_inf, 1.0, w)


@dataclasses.dataclass(frozen=True)
class Distribution1D:
    """CDF arrays for inverse-CDF sampling (sampling.h:55-108)."""

    func: torch.Tensor  # [n]
    cdf: torch.Tensor  # [n + 1]
    func_int: torch.Tensor  # []


def build_distribution_1d_np(f) -> dict:
    """Host-side CDF build matching Distribution1D's ctor (numpy arrays)."""
    f = np.asarray(f, np.float64)
    n = f.shape[-1]
    cdf = np.zeros(f.shape[:-1] + (n + 1,), np.float64)
    cdf[..., 1:] = np.cumsum(f / n, axis=-1)
    func_int = cdf[..., n].copy()
    zero = func_int == 0
    uniform = np.arange(1, n + 1, dtype=np.float64) / n
    cdf[..., 1:] = np.where(
        zero[..., None], uniform,
        cdf[..., 1:] / np.where(zero, 1.0, func_int)[..., None],
    )
    return {"func": f.astype(np.float32), "cdf": cdf.astype(np.float32),
            "func_int": np.asarray(func_int, np.float32)}


def distribution_from_numpy(d: dict, device) -> Distribution1D:
    return Distribution1D(*(torch.as_tensor(np.asarray(d[k], np.float32),
                                            device=device)
                            for k in ("func", "cdf", "func_int")))


def find_interval(cdf, u):
    """Largest i with cdf[i] <= u, clamped to [0, n - 2] (FindInterval)."""
    n = cdf.shape[-1]
    idx = torch.sum((cdf <= u[..., None]).to(torch.int64), dim=-1) - 1
    return torch.clamp(idx, 0, n - 2)


def sample_discrete_1d(d: Distribution1D, u):
    """Distribution1D::SampleDiscrete -> (offset, pmf)."""
    n = d.func.shape[-1]
    offset = find_interval(d.cdf, u)
    f = d.func[offset]
    pmf = torch.where(d.func_int > 0.0,
                      f / torch.clamp(d.func_int * n, min=1e-30), 0.0)
    return offset, pmf
