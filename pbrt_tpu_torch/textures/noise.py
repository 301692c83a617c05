"""Perlin gradient noise, FBm and Turbulence (core/texture.cpp:164-264).

Port of pbrt_tpu/textures/noise.py.  The permutation table is the port's
own copy of the JAX package's (data/noise_perm.npy), doubled as pbrt
doubles it; every function works over [..., 3] points.
"""
from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import torch

_DATA = Path(__file__).resolve().parent.parent / "data" / "noise_perm.npy"


@functools.cache
def _perm_np() -> np.ndarray:
    p = np.load(_DATA)
    return np.concatenate([p, p]).astype(np.int64)


_PERM: dict = {}


def _perm(device) -> torch.Tensor:
    key = str(device)
    if key not in _PERM:
        _PERM[key] = torch.as_tensor(_perm_np(), device=device)
    return _PERM[key]


def _grad(perm, ix, iy, iz, dx, dy, dz):
    h = perm[perm[perm[ix] + iy] + iz] & 15
    u = torch.where(h < 8, dx, dy)
    v = torch.where(h < 4, dy, torch.where((h == 12) | (h == 14), dx, dz))
    u = torch.where((h & 1) != 0, -u, u)
    v = torch.where((h & 2) != 0, -v, v)
    return u + v


def _noise_weight(t):
    t3 = t * t * t
    t4 = t3 * t
    return 6.0 * t4 * t - 15.0 * t4 + 10.0 * t3


def _lerp(t, a, b):
    return a + t * (b - a)


def noise(p):
    """pbrt's Noise(Point3f) (texture.cpp:160-199), in [-1, 1]."""
    perm = _perm(p.device)
    fl = torch.floor(p)
    i = fl.to(torch.int64)
    dx, dy, dz = (p - fl).unbind(-1)
    ix, iy, iz = (i & 255).unbind(-1)
    w000 = _grad(perm, ix, iy, iz, dx, dy, dz)
    w100 = _grad(perm, ix + 1, iy, iz, dx - 1, dy, dz)
    w010 = _grad(perm, ix, iy + 1, iz, dx, dy - 1, dz)
    w110 = _grad(perm, ix + 1, iy + 1, iz, dx - 1, dy - 1, dz)
    w001 = _grad(perm, ix, iy, iz + 1, dx, dy, dz - 1)
    w101 = _grad(perm, ix + 1, iy, iz + 1, dx - 1, dy, dz - 1)
    w011 = _grad(perm, ix, iy + 1, iz + 1, dx, dy - 1, dz - 1)
    w111 = _grad(perm, ix + 1, iy + 1, iz + 1, dx - 1, dy - 1, dz - 1)
    wx, wy, wz = _noise_weight(dx), _noise_weight(dy), _noise_weight(dz)
    y0 = _lerp(wy, _lerp(wx, w000, w100), _lerp(wx, w010, w110))
    y1 = _lerp(wy, _lerp(wx, w001, w101), _lerp(wx, w011, w111))
    return _lerp(wz, y0, y1)


def fbm(p, omega=0.5, max_octaves=6):
    """FBm (texture.cpp:201-219) with every octave: the JAX package takes no
    differentials here, so no antialiasing clamp."""
    total = torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device)
    lam, o = 1.0, 1.0
    for _ in range(max_octaves):
        total = total + o * noise(lam * p)
        lam *= 1.99
        o *= omega
    return total


def turbulence(p, omega=0.5, max_octaves=6):
    """Turbulence (texture.cpp:221-249): the sum of |noise|."""
    total = torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device)
    lam, o = 1.0, 1.0
    for _ in range(max_octaves):
        total = total + o * torch.abs(noise(lam * p))
        lam *= 1.99
        o *= omega
    return total
