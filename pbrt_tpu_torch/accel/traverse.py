"""Ray queries over the scene and the hit record.

Port of pbrt_tpu/accel/traverse.py for triangles and spheres:

* ``intersect_closest`` / ``intersect_any`` dispatch to the BVH kernel path
  (ops/bvh.py: the 4-wide kernel, or the binary one under PBRT_TPU_BVH4=0;
  the CUDA kernel on the card, its plain version on the CPU) behind the
  ``kernel_supported`` gate;
* ``_traverse`` is the watertight oracle over the binary BVH, the JAX
  package's lockstep "if-if" walk (one node visit or one primitive test per
  ray per step), kept for the tests;
* ``hit_record`` re-derives the full surface interaction for a hit prim id
  with the watertight test, bounded by t * 1.0001 + 1e-6 (traverse.py:382).

Traversal carries no gradient here, as in the JAX package (traverse.py:
288-297).
"""
from __future__ import annotations

import math

import torch
from torch.profiler import record_function

from .. import scene as sc
from ..core import vecmath as vm
from ..core.vecmath import coordinate_system, cross, gamma
from ..ops import bvh as kb
from ..shapes import quadrics as quad
from ..shapes.triangle import intersect_triangle, triangle_geometry

STACK_DEPTH = 64  # the oracle's stack, pbrt's todo[64] (bvh.cpp:671)
_SLAB_EPS = 1.0 + 2.0 * gamma(3)


def _slab_test(nmin, nmax, o, inv_d, t_best):
    """Bounds3::IntersectP (geometry.h:1388-1423)."""
    t0 = (nmin - o) * inv_d
    t1 = (nmax - o) * inv_d
    tn = torch.minimum(t0, t1)
    tf = torch.maximum(t0, t1) * _SLAB_EPS
    t_near = torch.amax(tn, dim=-1)
    t_far = torch.amin(tf, dim=-1)
    return (t_near <= t_far) & (t_far > 0.0) & (t_near < t_best)


def _test_prim(scene, prim_id, o, d, t_best):
    """One primitive per lane; returns (hit, t)."""
    meta = scene.prim_meta[prim_id]
    ptype = meta[:, 0]
    pidx = meta[:, 1]
    v9 = scene.tri_verts[torch.clamp(pidx, 0, scene.tri_verts.shape[0] - 1)]
    tri = intersect_triangle(o, d, t_best, v9[:, 0:3], v9[:, 3:6], v9[:, 6:9])
    hit = (ptype == sc.SHAPE_TRIANGLE) & tri["hit"]
    t = torch.where(hit, tri["t"], math.inf)
    if sc.SHAPE_SPHERE in scene.quadric_types:
        qp = scene.q_packed[torch.clamp(pidx, 0, scene.q_packed.shape[0] - 1)]
        w2o = qp[:, :12].view(-1, 3, 4)
        par = qp[:, 12:16]
        s = quad.intersect_sphere_object(
            vm.xform_point(w2o, o), vm.xform_vector(w2o, d), t_best,
            par[:, 0], par[:, 1], par[:, 2], par[:, 3])
        m = (ptype == sc.SHAPE_SPHERE) & s["hit"]
        t = torch.where(m & (s["t"] < t), s["t"], t)
        hit = hit | m
    return hit, t


def _traverse(scene, o, d, t_max, any_hit: bool = False, any_mask=None):
    """Watertight closest-hit walk over the binary BVH (the oracle).
    any_hit: every lane stops at its first hit; any_mask: per-lane flags."""
    n = o.shape[0]
    dev = o.device
    inv_d = 1.0 / torch.where(d == 0.0, 1e-30, d)
    bmin, bmax = scene.bvh_min, scene.bvh_max
    offset, nprims, axis = scene.bvh_offset, scene.bvh_nprims, scene.bvh_axis
    n_prims_total = scene.prim_meta.shape[0]
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    stack = torch.zeros((n, STACK_DEPTH), dtype=torch.int64, device=dev)
    leaf_cur = torch.zeros(n, dtype=torch.int64, device=dev)
    leaf_end = torch.zeros(n, dtype=torch.int64, device=dev)
    t_best = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(n).clone()
    prim_best = torch.full((n,), -1, dtype=torch.int64, device=dev)
    lane = torch.arange(n, device=dev)

    def alive():
        live = (node >= 0) | (leaf_cur < leaf_end)
        if any_hit:
            live = live & (prim_best < 0)
        elif any_mask is not None:
            live = live & ~(any_mask & (prim_best >= 0))
        return live

    while True:
        live = alive()
        if not bool(live.any()):
            break
        in_leaf = live & (leaf_cur < leaf_end)
        at_node = live & ~in_leaf & (node >= 0)

        prim_id = torch.clamp(leaf_cur, 0, n_prims_total - 1)
        p_hit, p_t = _test_prim(scene, prim_id, o, d, t_best)
        take = in_leaf & p_hit & (p_t < t_best)
        t_best = torch.where(take, p_t, t_best)
        prim_best = torch.where(take, prim_id, prim_best)
        leaf_cur = torch.where(in_leaf, leaf_cur + 1, leaf_cur)

        nd = torch.clamp(node, 0, bmin.shape[0] - 1)
        node_hit = at_node & _slab_test(bmin[nd], bmax[nd], o, inv_d, t_best)
        off = offset[nd].to(torch.int64)
        npr = nprims[nd].to(torch.int64)
        is_leaf_node = npr > 0
        enter_leaf = node_hit & is_leaf_node
        is_push = node_hit & ~is_leaf_node
        need_pop = at_node & ~is_push
        leaf_cur = torch.where(enter_leaf, off, leaf_cur)
        leaf_end = torch.where(enter_leaf, off + npr, leaf_end)

        dir_neg = vm.component3(d, axis[nd]) < 0.0
        near = torch.where(dir_neg, off, nd + 1)
        far = torch.where(dir_neg, nd + 1, off)
        spc = torch.clamp(sp, 0, STACK_DEPTH - 1)
        stack[lane[is_push], spc[is_push]] = far[is_push]
        sp = sp + is_push.to(torch.int64)

        can_pop = sp > 0
        popped = stack[lane, torch.clamp(sp - 1, 0, STACK_DEPTH - 1)]
        node = torch.where(need_pop, torch.where(can_pop, popped, -1),
                           torch.where(is_push, near, node))
        sp = torch.where(need_pop & can_pop, sp - 1, sp)
    return t_best, prim_best.to(torch.int32)


def intersect_closest(scene, o, d, t_max, any_mask=None):
    """Closest hit (t [n], prim [n], -1 = miss).  Lanes flagged in any_mask
    stop at their first hit; only prim >= 0 means anything for them.  The
    scene goes through the BVH kernel path; scenes outside its gate
    are refused."""
    if not kb.kernel_supported(scene):
        raise NotImplementedError(
            f"scenes with more than {kb.MAX_BRUTE_QUADRICS} quadrics or a "
            f"BVH deeper than {kb.STACK_SIZE // 3} 4-wide levels (binary "
            f"BVH: {kb.BVH2_STACK_SIZE} levels)")
    with torch.no_grad(), record_function("layer: traversal incl. kernel"):
        return kb.intersect_kernel_with_quadrics(scene, o, d, t_max,
                                                 any_mask=any_mask)


def intersect_any(scene, o, d, t_max):
    """Shadow-ray query with early exit; returns occluded [n] bool."""
    mask = torch.ones(o.shape[0], dtype=torch.bool, device=o.device)
    _, prim = intersect_closest(scene, o, d, t_max, any_mask=mask)
    return prim >= 0


def hit_record(scene, o, d, t, prim_id):
    """SurfaceInteraction for each lane's hit (interaction.cpp:92,
    triangle.cpp:309-430, sphere.cpp:160-236): position, normals, uv, error
    bounds, shading tangent, material and area-light ids."""
    hit = prim_id >= 0
    pid = torch.clamp(prim_id.to(torch.int64), 0, scene.prim_meta.shape[0] - 1)
    meta = scene.prim_meta[pid]
    ptype = meta[:, 0]
    pidx = meta[:, 1].to(torch.int64)

    attr = scene.tri_attr[torch.clamp(pidx, 0, scene.tri_attr.shape[0] - 1)]
    p0, p1, p2 = attr[:, 0:3], attr[:, 3:6], attr[:, 6:9]
    t_arg = torch.where(hit, t * 1.0001 + 1e-6, math.inf)
    tri = intersect_triangle(o, d, t_arg, p0, p1, p2)
    uv0, uv1, uv2 = attr[:, 9:11], attr[:, 11:13], attr[:, 13:15]
    ng_t, dpdu_t, dpdv_t = triangle_geometry(p0, p1, p2, uv0, uv1, uv2)
    b0, b1, b2 = tri["b0"][:, None], tri["b1"][:, None], tri["b2"][:, None]
    uv_t = b0 * uv0 + b1 * uv1 + b2 * uv2
    has_n = attr[:, 24] > 0.0
    ns_raw = b0 * attr[:, 15:18] + b1 * attr[:, 18:21] + b2 * attr[:, 21:24]
    ns_len2 = vm.dot(ns_raw, ns_raw)[:, None]
    ok_ns = has_n[:, None] & (ns_len2 > 1e-16)
    ns_len = torch.sqrt(torch.where(ok_ns, ns_len2, 1.0))
    ns_t = torch.where(ok_ns, ns_raw / ns_len, ng_t)
    flip = vm.dot(ng_t, ns_t) < 0.0
    ng_t = torch.where((has_n & flip)[:, None], -ng_t, ng_t)

    # Shading tangent re-orthogonalised against the interpolated normal on
    # normal-carrying meshes (triangle.cpp:365-381).
    dp_l2 = vm.dot(dpdu_t, dpdu_t)[:, None]
    ss_raw = dpdu_t / torch.sqrt(torch.where(dp_l2 > 0, dp_l2, 1.0))
    ts_raw = cross(ss_raw, ns_t)
    ts_l2 = vm.dot(ts_raw, ts_raw)[:, None]
    ok_f = ts_l2 > 0.0
    ts_u = ts_raw / torch.sqrt(torch.where(ok_f, ts_l2, 1.0))
    fb_ss, _ = coordinate_system(ns_t)
    ss_t = torch.where(ok_f, cross(ts_u, ns_t), fb_ss)

    is_tri = (ptype == sc.SHAPE_TRIANGLE) & hit
    it = is_tri[:, None]
    unit = torch.eye(3, dtype=torch.float32, device=o.device)
    p = torch.where(it, tri["p_hit"], 0.0)
    ng = torch.where(it, ng_t, unit[2])
    ns = torch.where(it, ns_t, unit[2])
    uv = torch.where(it, uv_t, 0.0)
    p_err = torch.where(it, tri["p_error"], 0.0)
    dpdu = torch.where(it, dpdu_t, unit[0])
    dpdv = torch.where(it, dpdv_t, unit[1])
    ss_sh = torch.where((is_tri & has_n)[:, None], ss_t, dpdu)

    if sc.SHAPE_SPHERE in scene.quadric_types:
        qidx = torch.clamp(pidx, 0, scene.q_type.shape[0] - 1)
        par = scene.q_params[qidx]
        s = quad.intersect_sphere(o, d, t_arg, scene.q_w2o[qidx],
                                  scene.q_o2w[qidx], par[:, 0], par[:, 1],
                                  par[:, 2], par[:, 3])
        m = ((ptype == sc.SHAPE_SPHERE) & s["hit"])[:, None]
        ngq = torch.where(scene.q_rev[qidx][:, None], -s["ng"], s["ng"])
        p = torch.where(m, s["p_hit"], p)
        ng = torch.where(m, ngq, ng)
        ns = torch.where(m, ngq, ns)
        uv = torch.where(m, s["uv"], uv)
        p_err = torch.where(m, s["p_error"], p_err)
        tq, bq = coordinate_system(torch.where(m, ngq, ns))
        dpdu = torch.where(m, tq, dpdu)
        dpdv = torch.where(m, bq, dpdv)
        ss_sh = torch.where(m, tq, ss_sh)

    return {
        "hit": hit, "t": t, "prim_id": prim_id, "p": p, "ng": ng, "ns": ns,
        "uv": uv, "p_error": p_err, "dpdu": dpdu, "dpdv": dpdv, "ss": ss_sh,
        "wo": -d,
        "material": torch.where(hit, meta[:, 2], -1),
        "arealight": torch.where(hit, meta[:, 3], -1),
    }


def uv_differentials(rec, rx_o, rx_d, ry_o, ry_d):
    """SurfaceInteraction::ComputeDifferentials (interaction.cpp:160-220):
    the auxiliary rays meet the hit's tangent plane, and dpdx = dpdu dudx +
    dpdv dvdx is solved on the two axes where |ng| is smallest.  Returns
    (duvdx [N, 2], duvdy [N, 2]), zero on misses and degenerate frames."""
    p, n = rec["p"], rec["ng"]
    dpdu, dpdv = rec["dpdu"], rec["dpdv"]
    d_plane = vm.dot(n, p)

    def plane_dp(ro, rd):
        denom = vm.dot(n, rd)
        flat = torch.abs(denom) < 1e-12
        tx = -(vm.dot(n, ro) - d_plane) / torch.where(flat, 1.0, denom)
        return ro + tx[:, None] * rd - p, ~flat

    dpdx, okx = plane_dp(rx_o, rx_d)
    dpdy, oky = plane_dp(ry_o, ry_d)
    an = torch.abs(n)
    use_yz = (an[:, 0] > an[:, 1]) & (an[:, 0] > an[:, 2])
    use_xz = ~use_yz & (an[:, 1] > an[:, 2])
    d0 = torch.where(use_yz, 1, 0)
    d1 = torch.where(use_yz | use_xz, 2, 1)
    a00 = vm.component3(dpdu, d0)
    a01 = vm.component3(dpdv, d0)
    a10 = vm.component3(dpdu, d1)
    a11 = vm.component3(dpdv, d1)
    det = a00 * a11 - a01 * a10
    ok = torch.abs(det) >= 1e-10
    inv = 1.0 / torch.where(ok, det, 1.0)

    def solve(dp, ok_ray):
        b0 = vm.component3(dp, d0)
        b1 = vm.component3(dp, d1)
        duv = torch.stack([(a11 * b0 - a01 * b1) * inv,
                           (a00 * b1 - a10 * b0) * inv], -1)
        return torch.where((ok & ok_ray & rec["hit"])[:, None], duv, 0.0)

    return solve(dpdx, okx), solve(dpdy, oky)
