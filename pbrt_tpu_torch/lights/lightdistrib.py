"""The spatial light distribution, the .pbrt default light-sampling strategy.

Port of pbrt_tpu/lights/lightdistrib.py (pbrt-v3 core/lightdistrib.cpp:
91-300, SpatialLightDistribution).  pbrt fills a <= 64^3 voxel grid lazily;
here, as in the JAX package, the whole grid is filled at once.  Each
voxel's per-light contribution estimate is lightdistrib.cpp:233-297 exactly:
64 voxels along the largest axis, 128 Halton points per voxel (RadicalInverse
dims 0-4), Li.y() / pdf from Sample_Li without visibility, accumulated in
float32 in pbrt's order, the 0.001 * average floor, and Distribution1D's
float32 CDF arithmetic (sampling.h:678-712).

The host parts (Halton table, voxel bounds, CDF rows) are numpy, copied
from the JAX package.  The per-point ``sample_li`` estimate runs in torch on
the scene's device, in chunks.  ``spatial_pick_light`` is the per-lane lookup
the path integrator makes at every bounce.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import lights as lt

MAX_VOXELS_PER_AXIS = 64  # lightdistrib.cpp:94 (maxVoxels = 64)
N_POINTS_PER_VOXEL = 128  # lightdistrib.cpp:255 (nSamples = 128)
CHUNK = 1 << 20  # sample points per sample_li call


def _radical_inverse_table(n, bases=(2, 3, 5, 7, 11)):
    """RadicalInverse(dim, i) for i < n (lowdiscrepancy.h:70-90), computed
    with double accumulation exactly like the reference, returned as f64."""
    out = np.zeros((len(bases), n), np.float64)
    for d, b in enumerate(bases):
        inv_base = 1.0 / b
        for i in range(n):
            a = i
            reversed_digits = 0
            inv_base_n = 1.0
            while a:
                next_a = a // b
                digit = a - next_a * b
                reversed_digits = reversed_digits * b + digit
                inv_base_n *= inv_base
                a = next_a
            out[d, i] = min(reversed_digits * inv_base_n, 1.0 - 2**-53)
    return out


def _distribution1d_rows(func):
    """pbrt Distribution1D built per row in f32 (sampling.h:678-712).

    func: [V, L] f32.  Returns (cdf [V, L+1], pmf [V, L]) with pbrt's exact
    arithmetic: cdf[i] = cdf[i-1] + func[i-1]/n, funcInt = cdf[n], then
    cdf /= funcInt; pmf[i] = func[i] / (funcInt * n) (DiscretePDF).
    """
    func = func.astype(np.float32)
    V, L = func.shape
    cdf = np.zeros((V, L + 1), np.float32)
    n32 = np.float32(L)
    for i in range(1, L + 1):
        cdf[:, i] = cdf[:, i - 1] + func[:, i - 1] / n32
    func_int = cdf[:, L].copy()
    zero = func_int == 0
    with np.errstate(divide="ignore", invalid="ignore"):
        cdf = np.where(zero[:, None], np.arange(L + 1, dtype=np.float32) / n32,
                       cdf / func_int[:, None])
    pmf = np.where(
        zero[:, None],
        np.float32(1.0 / L),
        func / np.where(zero, 1.0, func_int)[:, None] / n32,
    ).astype(np.float32)
    return cdf.astype(np.float32), pmf


def build_spatial_distribution(scene):
    """Returns (grid_res [3] i32, b0 [3], diag [3], cdf [V, L+1], pmf [V, L])
    as numpy, V = nx*ny*nz flattened x-major (x slowest).

    Per-voxel contribution estimate, lightdistrib.cpp:233-287: 128 Halton
    points p in the voxel (RadicalInverse dims 0-2), per light Li.y()/pdf
    from Sample_Li at u = (RadicalInverse 3, 4) (visibility ignored), f32
    accumulation over the points in order, then the 0.001 * avgContrib
    floor.  sample_li runs on the scene's device."""
    dev = scene.device
    b0 = scene.bvh_min[0].cpu().numpy().astype(np.float32)
    b1 = scene.bvh_max[0].cpu().numpy().astype(np.float32)
    diag = (b1 - b0).astype(np.float32)
    bmax = float(diag.max())
    res = np.maximum(1, np.round(diag.astype(np.float64) / bmax
                                 * MAX_VOXELS_PER_AXIS).astype(np.int64))
    nx, ny, nz = int(res[0]), int(res[1]), int(res[2])
    V = nx * ny * nz
    L = int(scene.lights.light_type.shape[0])
    S = N_POINTS_PER_VOXEL

    # Every voxel, in the JAX package's order.  Its occupancy pass
    # (lightdistrib.py:76-137) ends by marking the whole grid whenever the
    # scene has a medium table, and every JAX scene carries one (a
    # placeholder row), so it always fills the whole grid; so does the port.
    vox_ids = np.arange(V)
    ri = _radical_inverse_table(S)  # [5, S] f64
    # Vxel bounds via pbrt's f32 Lerp chain (lightdistrib.cpp:240-248).
    vx = (vox_ids // (ny * nz)).astype(np.float32)
    vy = ((vox_ids // nz) % ny).astype(np.float32)
    vz = (vox_ids % nz).astype(np.float32)
    vcoord = np.stack([vx, vy, vz], -1)  # [V, 3] f32
    res32 = res.astype(np.float32)
    p0 = (vcoord / res32).astype(np.float32)
    p1 = ((vcoord + np.float32(1.0)) / res32).astype(np.float32)
    # WorldBound().Lerp(t) = (1-t)*pMin + t*pMax in f32.
    vmin = torch.as_tensor(((1 - p0) * b0 + p0 * b1).astype(np.float32), device=dev)
    vmax = torch.as_tensor(((1 - p1) * b0 + p1 * b1).astype(np.float32), device=dev)
    t_pos = torch.as_tensor(ri[0:3].T.astype(np.float32), device=dev)  # [S, 3]
    u_all = torch.as_tensor(ri[3:5].T.astype(np.float32), device=dev)  # [S, 2]

    contrib = torch.zeros((V, L), dtype=torch.float32, device=dev)
    vox_per_chunk = max(1, CHUNK // S)
    with torch.no_grad():
        for l in range(L):
            parts = []
            for v0 in range(0, V, vox_per_chunk):
                v1 = min(v0 + vox_per_chunk, V)
                pts = ((1 - t_pos[None]) * vmin[v0:v1, None, :]
                       + t_pos[None] * vmax[v0:v1, None, :]).reshape(-1, 3)
                u = u_all.repeat(v1 - v0, 1)
                idx = torch.full((pts.shape[0],), l, dtype=torch.int64, device=dev)
                s = lt.sample_li(scene, idx, pts, u, scene.light_types)
                li, pdf = s["li"], s["pdf"]
                y = 0.212671 * li[:, 0] + 0.715160 * li[:, 1] + 0.072169 * li[:, 2]
                parts.append(torch.where(pdf > 0, y / torch.where(pdf > 0, pdf, 1.0),
                                         0.0))
            w = torch.cat(parts).view(V, S)
            acc = torch.zeros(V, dtype=torch.float32, device=dev)
            for i in range(S):  # f32 accumulation in pbrt's sample order
                acc = acc + w[:, i]
            contrib[:, l] = acc
    contrib = contrib.cpu().numpy()

    # Minimum-probability floor (lightdistrib.cpp:283-294), f32 arithmetic.
    sum_c = np.zeros((V,), np.float32)
    for l in range(L):
        sum_c = (sum_c + contrib[:, l]).astype(np.float32)
    avg = (sum_c / np.float32(S * L)).astype(np.float32)
    min_c = np.where(avg > 0, np.float32(0.001) * avg, np.float32(1.0))
    contrib = np.maximum(contrib, min_c[:, None]).astype(np.float32)

    cdf, pmf = _distribution1d_rows(contrib)
    return np.asarray([nx, ny, nz], np.int32), b0, diag, cdf, pmf


def spatial_pick_light(grid_res, b0, diag, cdf, pmf, p, u):
    """Per-lane lookup (SpatialLightDistribution::Lookup,
    lightdistrib.cpp:135-160, then Distribution1D::SampleDiscrete): voxel
    index -> CDF row -> largest i with cdf[i] <= u.

    Returns (light_idx [N] i64, pmf [N]).  pbrt's f32 rounding is kept:
    offset = (p - b0) / diag (a division, not a reciprocal multiply), then
    truncation of offset * nVoxels, clamped to the grid."""
    off = (p - b0) / diag
    cell = torch.nan_to_num(off * grid_res.to(off.dtype), nan=0.0)
    vi = torch.minimum(torch.clamp(cell, min=0.0),
                       (grid_res - 1).to(off.dtype)).to(torch.int64)
    flat = (vi[:, 0] * grid_res[1] + vi[:, 1]) * grid_res[2] + vi[:, 2]
    row = cdf[flat]  # [N, L+1]
    idx = (row <= u[:, None]).sum(-1) - 1
    idx = torch.clamp(idx, 0, row.shape[-1] - 2)
    prob = torch.gather(pmf[flat], 1, idx[:, None])[:, 0]
    return idx, torch.clamp(prob, min=1e-20)


# pbrt builds the grid once per scene (the integrator's Preprocess); the
# JAX package memoises it on the scene object's identity (lightdistrib.py:
# 257-289), and so does the port.
_SPATIAL_CACHE: dict = {}


def ensure_spatial_light_distribution(scene):
    """The scene with its spatial_* fields filled (on its device), built
    once per scene object; the scene itself if they are already there."""
    if scene.spatial_cdf is not None:
        return scene
    hit = _SPATIAL_CACHE.get(id(scene))
    if hit is not None and hit[0] is scene:
        return hit[1]
    res, b0, diag, cdf, pmf = build_spatial_distribution(scene)
    dev = scene.device
    out = dataclasses.replace(
        scene,
        spatial_grid_res=torch.as_tensor(res.astype(np.int64), device=dev),
        spatial_b0=torch.as_tensor(b0, device=dev),
        spatial_diag=torch.as_tensor(diag, device=dev),
        spatial_cdf=torch.as_tensor(cdf, device=dev),
        spatial_pmf=torch.as_tensor(pmf, device=dev),
    )
    if len(_SPATIAL_CACHE) > 4:
        _SPATIAL_CACHE.clear()
    _SPATIAL_CACHE[id(scene)] = (scene, out)
    return out
