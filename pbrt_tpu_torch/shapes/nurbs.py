"""NURBS surface to a triangle mesh, on the host.

Port of pbrt_tpu/shapes/nurbs.py (shapes/nurbs.cpp: pbrt also tessellates a
NURBS patch into a triangle mesh when it is created, NURBSEvaluateSurface
over a regular grid): the Cox-de Boor basis and a 30 x 30 grid, the same
float64 operations in the same order.
"""
from __future__ import annotations

import numpy as np


def _basis_funs(knots: np.ndarray, order: int, u: float):
    """All B-spline basis values of the given order at u.  Returns [n] where
    n = len(knots) - order (number of control points)."""
    n = len(knots) - order
    vals = np.zeros(n)
    # Degree-0 seed.
    deg0 = np.zeros(len(knots) - 1)
    for i in range(len(knots) - 1):
        if knots[i] <= u < knots[i + 1]:
            deg0[i] = 1.0
    # u at the end of the domain.
    if u >= knots[-order]:
        for i in range(len(knots) - 2, -1, -1):
            if knots[i] < knots[i + 1]:
                deg0[:] = 0.0
                deg0[i] = 1.0
                break
    cur = deg0
    for d in range(1, order):
        nxt = np.zeros(len(cur) - 1)
        for i in range(len(nxt)):
            a = 0.0
            if knots[i + d] > knots[i]:
                a = (u - knots[i]) / (knots[i + d] - knots[i]) * cur[i]
            bb = 0.0
            if knots[i + d + 1] > knots[i + 1]:
                bb = (
                    (knots[i + d + 1] - u)
                    / (knots[i + d + 1] - knots[i + 1])
                    * cur[i + 1]
                )
            nxt[i] = a + bb
        cur = nxt
    return cur[:n]


def tessellate_nurbs(
    nu, nv, uorder, vorder, uknots, vknots, pw, res_u=30, res_v=30
):
    """pw: [nv, nu, 4] homogeneous control points (w=1 for non-rational).

    Returns (indices [T,3], P [V,3], UV [V,2])."""
    uknots = np.asarray(uknots, np.float64)
    vknots = np.asarray(vknots, np.float64)
    pw = np.asarray(pw, np.float64).reshape(nv, nu, 4)
    u0, u1 = uknots[uorder - 1], uknots[nu]
    v0, v1 = vknots[vorder - 1], vknots[nv]
    us = np.linspace(u0, u1, res_u)
    vs = np.linspace(v0, v1, res_v)
    bu = np.stack([_basis_funs(uknots, uorder, u) for u in us])  # [res_u, nu]
    bv = np.stack([_basis_funs(vknots, vorder, v) for v in vs])  # [res_v, nv]
    # Surface points: S(v,u) = sum_ij bv_i bu_j pw_ij.
    s = np.einsum("vi,uj,ijk->vuk", bv, bu, pw)  # [res_v, res_u, 4]
    w = np.maximum(np.abs(s[..., 3:4]), 1e-12) * np.sign(
        np.where(s[..., 3:4] == 0.0, 1.0, s[..., 3:4])
    )
    p = (s[..., :3] / w).reshape(-1, 3)
    uu, vv = np.meshgrid(
        (us - u0) / max(u1 - u0, 1e-12), (vs - v0) / max(v1 - v0, 1e-12)
    )
    uv = np.stack([uu.ravel(), vv.ravel()], -1)
    qi, qj = np.meshgrid(np.arange(res_u - 1), np.arange(res_v - 1))
    v00 = (qj * res_u + qi).ravel()
    idx = np.concatenate(
        [
            np.stack([v00, v00 + 1, v00 + res_u + 1], -1),
            np.stack([v00, v00 + res_u + 1, v00 + res_u], -1),
        ]
    )
    return idx.astype(np.int64), p.astype(np.float32), uv.astype(np.float32)
