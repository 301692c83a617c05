"""Ray queries over the scene and the hit record.

Port of pbrt_tpu/accel/traverse.py for every shape type: triangles, the
six quadrics, procedural curves and instanced triangles.

* ``intersect_closest`` / ``intersect_any`` dispatch to the BVH kernel path
  (ops/bvh.py: the CUDA kernel on the card, its plain version on the CPU):
  a scene inside the JAX package's gate (``kernel_supported``) takes the
  4-wide kernel, or the binary one under PBRT_TPU_BVH4=0, with the
  brute-force quadric pass; a scene past it takes the typed build of the
  4-wide kernel, which tests every record type in the leaves;
* ``_traverse`` is the watertight oracle over the binary BVH, the JAX
  package's lockstep "if-if" walk (one node visit or one primitive test per
  ray per step), kept for the tests;
* ``hit_record`` re-derives the full surface interaction for a hit prim id
  with the watertight test, bounded by t * 1.0001 + 1e-6 (traverse.py:382);
  an instanced triangle's is built in object space and carried to world
  space by its instance's i2w (transform.cpp:415-440).

Traversal carries no gradient here, as in the JAX package (traverse.py:
288-297).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.profiler import record_function

from .. import scene as sc
from ..core import vecmath as vm
from ..core.vecmath import coordinate_system, cross, gamma
from ..ops import bvh as kb
from ..shapes import quadrics as quad
from ..shapes.curve import curve_intersect
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


def _test_prim(scene, prim_id, o, d, t_best, lanes=None):
    """One primitive per lane; returns (hit, t) (traverse.py:41-131).  Each
    shape type is tested on the lanes whose primitive has that type (and,
    given `lanes` [n] bool, that are in a leaf): the other lanes' answers
    are never read."""
    meta = scene.prim_meta[prim_id]
    ptype = meta[:, 0]
    pidx = meta[:, 1].to(torch.int64)
    n = prim_id.shape[0]
    hit = torch.zeros(n, dtype=torch.bool, device=o.device)
    t = torch.full((n,), math.inf, dtype=torch.float32, device=o.device)
    live = torch.ones_like(hit) if lanes is None else lanes

    def pick(kind):
        return torch.nonzero(live & (ptype == kind))[:, 0]

    def put(idx, res):
        h = res["hit"]
        hit[idx] = h
        t[idx] = torch.where(h, res["t"], math.inf)

    idx = pick(sc.SHAPE_TRIANGLE)
    v9 = scene.tri_verts[pidx[idx]]
    put(idx, intersect_triangle(o[idx], d[idx], t_best[idx], v9[:, 0:3],
                                v9[:, 3:6], v9[:, 6:9]))
    for qt in scene.quadric_types:
        idx = pick(qt)
        if not idx.numel():
            continue
        if qt in sc.QUADRIC_SHAPES:
            qp = scene.q_packed[pidx[idx]]
            w2o = qp[:, :12].view(-1, 3, 4)
            put(idx, quad.intersect_object(
                qt, vm.xform_point(w2o, o[idx]), vm.xform_vector(w2o, d[idx]),
                t_best[idx], qp[:, 12:24]))
        elif qt == sc.SHAPE_CURVE:
            put(idx, curve_intersect(o[idx], d[idx], t_best[idx],
                                     scene.curve_packed[pidx[idx]]))
        else:
            # TransformedPrimitive::Intersect (primitive.cpp:99-140): the
            # ray moves into object space, d not renormalised, so t stays
            # in world units, and meets the shared object-space triangle
            it = scene.inst_tri[pidx[idx]]
            w2i = _inst_w2i(scene, it)
            vi = scene.tri_verts[it[:, 0].to(torch.int64)]
            put(idx, intersect_triangle(
                vm.xform_point(w2i, o[idx]), vm.xform_vector(w2i, d[idx]),
                t_best[idx], vi[:, 0:3], vi[:, 3:6], vi[:, 6:9]))
    return hit, t


def _inst_w2i(scene, it):
    xf = scene.inst_xf[torch.clamp(it[:, 1].to(torch.int64), 0,
                                   scene.inst_xf.shape[0] - 1)]
    return xf[:, :12].view(-1, 3, 4)


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
        p_hit, p_t = _test_prim(scene, prim_id, o, d, t_best, in_leaf)
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
    scene goes through the BVH kernel path (ops/bvh.py traversal_route,
    which refuses a tree deeper than the kernel's stack)."""
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

    # Each other shape type's record is made on every lane, as in the JAX
    # package, and kept on that type's hit lanes.  A lane of another type
    # takes that shape type's benign parameter row (_BENIGN), not the row
    # its index reaches: the same values where kept, and no other row's
    # parameters (a phi_max of 0) in the backward.
    others = scene.quadric_types
    if any(q in sc.QUADRIC_SHAPES for q in others):
        qidx = torch.clamp(pidx, 0, scene.q_type.shape[0] - 1)
        par = scene.q_params[qidx]
        w2o, o2w = scene.q_w2o[qidx], scene.q_o2w[qidx]
        rev = scene.q_rev[qidx][:, None]
    for qt in others:
        mine = (ptype == qt)[:, None]
        if qt in sc.QUADRIC_SHAPES:
            r = quad.intersect_record(qt, o, d, t_arg, w2o, o2w,
                                      torch.where(mine, par, _benign(qt, par)))
            m = mine & r["hit"][:, None]
            ngq = torch.where(rev, -r["ng"], r["ng"])
            tq, bq = coordinate_system(torch.where(m, ngq, ns))
            fields = {"p": r["p_hit"], "ng": ngq, "ns": ngq, "uv": r["uv"],
                      "p_error": r["p_error"], "dpdu": tq, "dpdv": bq, "ss": tq}
        elif qt == sc.SHAPE_CURVE:
            crow = scene.curve_packed[torch.clamp(pidx, 0,
                                                  scene.curve_packed.shape[0] - 1)]
            c = curve_intersect(o, d, t_arg, torch.where(mine, crow, _benign(qt, crow)),
                                want_record=True)
            m = mine & c["hit"][:, None]
            fields = {"p": c["p_hit"], "ng": c["ng"], "ns": c["ng"], "uv": c["uv"],
                      "p_error": c["p_error"], "dpdu": c["dpdu"], "dpdv": c["dpdv"],
                      "ss": c["dpdu"]}
        else:
            r = _instanced_record(scene, o, d, t_arg, pidx)
            m = mine & (hit & r["hit"])[:, None]
            fields = {"p": r["p"], "ng": r["ng"], "ns": r["ns"], "uv": r["uv"],
                      "p_error": r["p_error"], "dpdu": r["dpdu"], "dpdv": r["dpdv"],
                      "ss": r["dpdu"]}
        p = torch.where(m, fields["p"], p)
        ng = torch.where(m, fields["ng"], ng)
        ns = torch.where(m, fields["ns"], ns)
        uv = torch.where(m, fields["uv"], uv)
        p_err = torch.where(m, fields["p_error"], p_err)
        dpdu = torch.where(m, fields["dpdu"], dpdu)
        dpdv = torch.where(m, fields["dpdv"], dpdv)
        ss_sh = torch.where(m, fields["ss"], ss_sh)

    return {
        "hit": hit, "t": t, "prim_id": prim_id, "p": p, "ng": ng, "ns": ns,
        "uv": uv, "p_error": p_err, "dpdu": dpdu, "dpdv": dpdv, "ss": ss_sh,
        "wo": -d,
        "material": torch.where(hit, meta[:, 2], -1),
        "arealight": torch.where(hit, meta[:, 3], -1),
    }


# a well-formed parameter row of each shape type (q_params, or a
# curve_packed row: a straight flat curve) for the lanes of other types
_BENIGN_ROWS = {
    sc.SHAPE_SPHERE: (1.0, -1.0, 1.0, 2 * math.pi),
    sc.SHAPE_CYLINDER: (1.0, -1.0, 1.0, 2 * math.pi),
    sc.SHAPE_DISK: (1.0, 0.0, 0.0, 2 * math.pi),
    sc.SHAPE_CONE: (1.0, 1.0, 2 * math.pi),
    sc.SHAPE_PARABOLOID: (1.0, 0.0, 1.0, 2 * math.pi),
    sc.SHAPE_HYPERBOLOID: (1.0, 1.0, -1.0, 1.0, 2 * math.pi, 1.0, 0.0, -1.0, 1.0,
                           0.0, 1.0),
    sc.SHAPE_CURVE: (0.0, 0.0, 0.0, 0.0, 0.0, 0.3, 0.0, 0.0, 0.6, 0.0, 0.0, 1.0,
                     0.1, 0.1, 0.0, 1.0),
}


_benign_cache: dict = {}


def _benign(kind, like):
    """_BENIGN_ROWS[kind] as a row like `like`'s rows, made once a device
    (no copy to the card on each call)."""
    key = (kind, like.shape[-1], like.dtype, like.device)
    if key not in _benign_cache:
        row = np.zeros(like.shape[-1], np.float32)
        row[:len(_BENIGN_ROWS[kind])] = _BENIGN_ROWS[kind]
        _benign_cache[key] = torch.as_tensor(row, dtype=like.dtype, device=like.device)
    return _benign_cache[key]


def _instanced_record(scene, o, d, t_arg, pidx):
    """An instanced triangle's SurfaceInteraction (traverse.py:538-588):
    built in object space against the shared row, then carried to world
    space (transform.cpp:415-440): the point with the abs-matrix error
    bound, dpdu and dpdv linearly, the normals by the inverse transpose
    (w2i^T), renormalised."""
    it = scene.inst_tri[torch.clamp(pidx, 0, scene.inst_tri.shape[0] - 1)]
    xf = scene.inst_xf[torch.clamp(it[:, 1].to(torch.int64), 0,
                                   scene.inst_xf.shape[0] - 1)]
    w2i = xf[:, :12].view(-1, 3, 4)
    i2w = xf[:, 12:24].view(-1, 3, 4)
    a = scene.tri_attr[torch.clamp(it[:, 0].to(torch.int64), 0,
                                   scene.tri_attr.shape[0] - 1)]
    q0, q1, q2 = a[:, 0:3], a[:, 3:6], a[:, 6:9]
    tri = intersect_triangle(vm.xform_point(w2i, o), vm.xform_vector(w2i, d),
                             t_arg, q0, q1, q2)
    ng_i, dpdu_i, dpdv_i = triangle_geometry(q0, q1, q2, a[:, 9:11],
                                             a[:, 11:13], a[:, 13:15])
    b0, b1, b2 = tri["b0"][:, None], tri["b1"][:, None], tri["b2"][:, None]
    uv_i = b0 * a[:, 9:11] + b1 * a[:, 11:13] + b2 * a[:, 13:15]
    has_n = a[:, 24] > 0.0
    ns_raw = b0 * a[:, 15:18] + b1 * a[:, 18:21] + b2 * a[:, 21:24]
    nsl2 = vm.dot(ns_raw, ns_raw)[:, None]
    okn = has_n[:, None] & (nsl2 > 1e-16)
    ns_i = torch.where(okn, ns_raw / torch.sqrt(torch.where(okn, nsl2, 1.0)), ng_i)
    flip = vm.dot(ng_i, ns_i) < 0.0
    ng_i = torch.where((has_n & flip)[:, None], -ng_i, ng_i)
    p_w = vm.xform_point(i2w, tri["p_hit"])
    g3 = gamma(3)
    p_err_w = ((g3 + 1.0) * vm.xform_vector(torch.abs(i2w[:, :, :3]), tri["p_error"])
               + g3 * torch.abs(p_w))
    ng_w = vm.xform_normal_w2o(w2i, ng_i)
    ns_w = vm.xform_normal_w2o(w2i, ns_i)
    ng_w = ng_w / torch.sqrt(torch.clamp(vm.dot(ng_w, ng_w), min=1e-30))[:, None]
    ns_w = ns_w / torch.sqrt(torch.clamp(vm.dot(ns_w, ns_w), min=1e-30))[:, None]
    return {"hit": tri["hit"], "p": p_w, "ng": ng_w, "ns": ns_w, "uv": uv_i,
            "p_error": p_err_w, "dpdu": vm.xform_vector(i2w, dpdu_i),
            "dpdv": vm.xform_vector(i2w, dpdv_i)}


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
