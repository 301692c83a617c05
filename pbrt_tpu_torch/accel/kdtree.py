"""The kd-tree accelerator (``Accelerator "kdtree"``).

Port of pbrt_tpu/accel/kdtree.py (accelerators/kdtreeaccel.{h,cpp}): the
SAH build runs on the host in numpy and Python at scene build, the port's
own copy of the JAX package's, array for array; the traversal is a
lockstep loop over the lanes with a (node, tmin, tmax) stack a lane
(KdTreeAccel::Intersect, kdtreeaccel.cpp:415-480), bit for bit the JAX
package's per-lane walk.  The JAX package leaves the traversal to XLA, so
here it is plain torch operations, on the card and on the CPU.

Node layout (kd_nodes [M, 4] f32):
  interior: [split_pos, axis (0/1/2), above_child, 0]
  leaf:     [prim_offset, 3, n_prims, 0]
A leaf's primitive ids (BVH-ordered primitive rows, as the BVH's leaves
use) are concatenated in kd_prim_ids [K] i32.

The loop stops when no lane is live; it asks the card that every
ANY_CHECK_EVERY iterations, not every iteration, since an iteration past a
lane's end changes nothing of it.  A lane pushes at most one stack entry a
level, so the build's depth limit round(8 + 1.3 log2 n) keeps the stack
within its 64 entries for any n below 2^42; build_kdtree checks that
instead of letting a push past the end overwrite the top entry, as the
JAX loop's clip would.
"""
from __future__ import annotations

import math
import sys

import numpy as np
import torch

from ..core import vecmath as vm
from ..shapes import quadrics as quad
from ..shapes.triangle import intersect_triangle

ISECT_COST = 80.0
TRAV_COST = 1.0
EMPTY_BONUS = 0.5
MAX_PRIMS_LEAF = 1
STACK_DEPTH = 64
ANY_CHECK_EVERY = 8
KD_FIELDS = ("kd_nodes", "kd_prim_ids", "kd_wb_min", "kd_wb_max")
MAX_KD_PRIMS = 200_000  # the JAX builder's cap (scene.py:970-977)


def max_depth_for(n: int) -> int:
    """The build's depth limit (kdtreeaccel.cpp:91)."""
    return int(round(8 + 1.3 * np.log2(max(n, 2))))


def build_kdtree(bmin: np.ndarray, bmax: np.ndarray, max_prims: int = MAX_PRIMS_LEAF):
    """SAH kd-tree over primitive bounds (kdtreeaccel.cpp:119-260: sorted
    bound-edge sweep, empty bonus, bad-refine cutoff), the JAX package's
    build step for step (kdtree.py:34-146).

    Returns (kd_nodes [M, 4] f32, kd_prim_ids [K] i32, wb_min [3], wb_max [3])."""
    n = bmin.shape[0]
    max_depth = max_depth_for(n)
    if max_depth >= STACK_DEPTH:
        raise ValueError(f"a kd-tree of {n} primitives may reach depth "
                         f"{max_depth}, past the traversal's {STACK_DEPTH}-entry stack")
    nodes = []
    prim_ids = []
    wb_min = bmin.min(0).astype(np.float32)
    wb_max = bmax.max(0).astype(np.float32)

    def make_leaf(prims):
        nodes.append([float(len(prim_ids)), 3.0, float(len(prims)), 0.0])
        prim_ids.extend(int(p) for p in prims)

    def rec(prims, nb0, nb1, depth, bad_refines):
        if len(prims) <= max_prims or depth == 0:
            make_leaf(prims)
            return
        # the SAH split over the widest axis, then the others if it finds
        # none (kdtreeaccel.cpp:176-232)
        d = nb1 - nb0
        inv_total_sa = 1.0 / max(2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0]),
                                 1e-12)
        old_cost = ISECT_COST * len(prims)
        best_cost, best_axis, best_split = np.inf, -1, -1.0
        axis = int(np.argmax(d))
        for attempt in range(3):
            a = (axis + attempt) % 3
            lo = bmin[prims, a]
            hi = bmax[prims, a]
            # edge events sorted by position, starts before ends on ties
            ts = np.concatenate([lo, hi])
            kind = np.concatenate([np.zeros(len(prims)), np.ones(len(prims))])
            order = np.lexsort((kind, ts))
            ts_s = ts[order]
            kind_s = kind[order]
            n_below = 0
            n_above = len(prims)
            o1, o2 = (a + 1) % 3, (a + 2) % 3
            for i in range(len(ts_s)):
                if kind_s[i] == 1:
                    n_above -= 1
                t = ts_s[i]
                if nb0[a] < t < nb1[a]:
                    below_sa = 2.0 * (d[o1] * d[o2] + (t - nb0[a]) * (d[o1] + d[o2]))
                    above_sa = 2.0 * (d[o1] * d[o2] + (nb1[a] - t) * (d[o1] + d[o2]))
                    pb = below_sa * inv_total_sa
                    pa = above_sa * inv_total_sa
                    eb = EMPTY_BONUS if (n_above == 0 or n_below == 0) else 0.0
                    cost = TRAV_COST + ISECT_COST * (1.0 - eb) * (
                        pb * n_below + pa * n_above)
                    if cost < best_cost:
                        best_cost, best_axis, best_split = cost, a, t
                if kind_s[i] == 0:
                    n_below += 1
            if best_axis >= 0:
                break
        if best_cost > old_cost:
            bad_refines += 1
        if (best_axis < 0 or (best_cost > 4.0 * old_cost and len(prims) < 16)
                or bad_refines == 3):
            make_leaf(prims)
            return
        below = [p for p in prims if bmin[p, best_axis] < best_split]
        above = [p for p in prims if bmax[p, best_axis] > best_split]
        # flat primitives lying on the plane go below
        below.extend(p for p in prims if bmin[p, best_axis] >= best_split
                     and bmax[p, best_axis] <= best_split)
        my_idx = len(nodes)
        nodes.append(None)  # filled in once the below subtree is emitted
        b0b, b1b = nb0.copy(), nb1.copy()
        b1b[best_axis] = best_split
        rec(below, b0b, b1b, depth - 1, bad_refines)
        above_child = len(nodes)
        nodes[my_idx] = [float(best_split), float(best_axis), float(above_child), 0.0]
        b0a, b1a = nb0.copy(), nb1.copy()
        b0a[best_axis] = best_split
        rec(above, b0a, b1a, depth - 1, bad_refines)

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(10000 + 4 * max_depth * 64)
    try:
        rec(list(range(n)), wb_min.astype(np.float64), wb_max.astype(np.float64),
            max_depth, 0)
    finally:
        sys.setrecursionlimit(old_limit)
    return (np.asarray(nodes, np.float32),
            np.asarray(prim_ids if prim_ids else [0], np.int32),
            wb_min, wb_max)


def _test_prims(scene, pid, o, d, t_best, in_leaf):
    """(hit, t) of one primitive a lane, for the lanes in a leaf.  On a
    scene of triangles and quadrics every lane is tested against its
    primitive's row as each shape type (the types a scene lacks are not
    tested), so no transfer from the card picks the leaf lanes; curves
    and instanced triangles take the oracle's per-type test
    (traverse._test_prim).  Either gives each lane's own test's bits."""
    from .. import scene as sc  # scene.py imports this module

    if any(qt not in sc.QUADRIC_SHAPES for qt in scene.quadric_types):
        from .traverse import _test_prim

        return _test_prim(scene, pid, o, d, t_best, in_leaf)
    meta = scene.prim_meta[pid]
    ptype = meta[:, 0]
    pidx = meta[:, 1].to(torch.int64)
    v9 = scene.tri_verts[torch.clamp(pidx, 0, scene.tri_verts.shape[0] - 1)]
    r = intersect_triangle(o, d, t_best, v9[:, 0:3], v9[:, 3:6], v9[:, 6:9])
    hit = (ptype == sc.SHAPE_TRIANGLE) & r["hit"]
    t = torch.where(hit, r["t"], math.inf)
    if scene.quadric_types:
        qp = scene.q_packed[torch.clamp(pidx, 0, scene.q_packed.shape[0] - 1)]
        w2o = qp[:, :12].view(-1, 3, 4)
        o_obj, d_obj = vm.xform_point(w2o, o), vm.xform_vector(w2o, d)
        for qt in scene.quadric_types:
            q = quad.intersect_object(qt, o_obj, d_obj, t_best, qp[:, 12:24])
            mine = (ptype == qt) & q["hit"]
            hit = hit | mine
            t = torch.where(mine, q["t"], t)
    return hit, t


def traverse_kd(scene, o, d, t_max, any_hit: bool = False):
    """Lockstep kd traversal (kdtree.py:149-289): each live lane makes one
    node visit or one leaf-primitive test an iteration.  Returns (t [n],
    prim [n] i32, -1 a miss; t is t_max on a miss).  any_hit: a lane
    stops at its first hit."""
    n = o.shape[0]
    dev = o.device
    inv_d = 1.0 / torch.where(d == 0.0, 1e-30, d)

    # the ray against the tree's bounds (kdtreeaccel.cpp:418-421)
    t0 = (scene.kd_wb_min - o) * inv_d
    t1 = (scene.kd_wb_max - o) * inv_d
    tn = torch.amax(torch.minimum(t0, t1), -1)
    tf_ = torch.amin(torch.maximum(t0, t1), -1)
    t_best = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(n).clone()
    tmin = torch.clamp(tn, min=0.0)
    tmax = torch.minimum(tf_, t_best)
    node = torch.where(tmin <= tmax, 0, -1).to(torch.int64)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    st_node = torch.zeros((n, STACK_DEPTH), dtype=torch.int64, device=dev)
    st_tmin = torch.zeros((n, STACK_DEPTH), dtype=torch.float32, device=dev)
    st_tmax = torch.zeros((n, STACK_DEPTH), dtype=torch.float32, device=dev)
    leaf_cur = torch.zeros(n, dtype=torch.int64, device=dev)
    leaf_end = torch.zeros(n, dtype=torch.int64, device=dev)
    prim_best = torch.full((n,), -1, dtype=torch.int64, device=dev)
    n_ids = scene.kd_prim_ids.shape[0]
    n_nodes = scene.kd_nodes.shape[0]

    def alive():
        live = (node >= 0) | (leaf_cur < leaf_end)
        return live & (prim_best < 0) if any_hit else live

    it = 0
    while it % ANY_CHECK_EVERY or bool(alive().any()):
        it += 1
        live = alive()
        in_leaf = live & (leaf_cur < leaf_end)
        at_node = live & ~in_leaf & (node >= 0)

        # the leaf step: one primitive a lane
        pid = scene.kd_prim_ids[torch.clamp(leaf_cur, 0, n_ids - 1)].to(torch.int64)
        p_hit, p_t = _test_prims(scene, pid, o, d, t_best, in_leaf)
        take = in_leaf & p_hit & (p_t < t_best)
        t_best = torch.where(take, p_t, t_best)
        prim_best = torch.where(take, pid, prim_best)
        leaf_cur = torch.where(in_leaf, leaf_cur + 1, leaf_cur)

        # the node step
        nd = torch.clamp(node, 0, n_nodes - 1)
        row = scene.kd_nodes[nd]
        axis = row[:, 1].to(torch.int64)
        is_leaf = axis == 3
        split = row[:, 0]
        above = row[:, 2].to(torch.int64)
        # the closest hit already lies before this node (kdtreeaccel.cpp:441)
        dead_node = at_node & (t_best < tmin)
        enter_leaf = at_node & is_leaf & ~dead_node
        real_leaf = enter_leaf & (above > 0)
        empty_leaf = enter_leaf & (above == 0)
        off = split.to(torch.int64)
        leaf_cur = torch.where(real_leaf, off, leaf_cur)
        leaf_end = torch.where(real_leaf, off + above, leaf_end)

        interior = at_node & ~is_leaf & ~dead_node
        ax = torch.clamp(axis, 0, 2)
        o_a = vm.component3(o, ax)
        t_plane = (split - o_a) * vm.component3(inv_d, ax)
        below_first = (o_a < split) | ((o_a == split) & (vm.component3(d, ax) <= 0.0))
        first = torch.where(below_first, nd + 1, above)
        second = torch.where(below_first, above, nd + 1)
        one_child = (t_plane > tmax) | (t_plane <= 0.0)
        only_second = t_plane < tmin
        push = interior & ~one_child & ~only_second

        # push (second, t_plane, tmax) on the pushing lanes' stacks
        slot = torch.clamp(sp, 0, STACK_DEPTH - 1)[:, None]
        for stack, value in ((st_node, second), (st_tmin, t_plane), (st_tmax, tmax)):
            stack.scatter_(1, slot, torch.where(push, value,
                                                stack.gather(1, slot)[:, 0])[:, None])
        sp = sp + push.to(torch.int64)
        node_int = torch.where(one_child, first, torch.where(only_second, second, first))
        tmax_int = torch.where(push, t_plane, tmax)

        # pop after a finished leaf or an empty one; a culled node ends the
        # lane (every entry left on its stack lies farther)
        finished_leaf = in_leaf & (leaf_cur >= leaf_end) & (node == -2)
        can_pop = sp > 0
        top = torch.clamp(sp - 1, 0, STACK_DEPTH - 1)[:, None]
        popped_n = st_node.gather(1, top)[:, 0]
        popped_t0 = st_tmin.gather(1, top)[:, 0]
        popped_t1 = st_tmax.gather(1, top)[:, 0]
        node = torch.where(interior, node_int, torch.where(real_leaf, -2, node))
        do_pop = finished_leaf | empty_leaf
        node = torch.where(do_pop, torch.where(can_pop, popped_n, -1), node)
        node = torch.where(dead_node, -1, node)
        popping = do_pop & can_pop
        tmin_new = torch.where(popping, popped_t0, tmin)
        tmax = torch.where(popping, popped_t1, tmax_int)
        tmin = torch.where(interior & ~push, tmin, tmin_new)
        sp = torch.where(popping, sp - 1, sp)
        sp = torch.where(dead_node, 0, sp)
    return t_best, prim_best.to(torch.int32)


def kd_arrays(bmin: np.ndarray, bmax: np.ndarray, log=None) -> dict:
    """The kd fields of a scene over its BVH-ordered primitive bounds, or
    {} past MAX_KD_PRIMS primitives, where the JAX builder warns and keeps
    the BVH (scene.py:966-985).  Adds the build's seconds to log["kd-tree
    build"] when given a dict."""
    import logging
    import time

    if bmin.shape[0] > MAX_KD_PRIMS:
        logging.getLogger("pbrt_tpu_torch").warning(
            "kdtree build capped at 200k prims; using BVH")
        return {}
    t0 = time.perf_counter()
    arrays = dict(zip(KD_FIELDS, build_kdtree(bmin, bmax)))
    if log is not None:
        log["kd-tree build"] = log.get("kd-tree build", 0.0) + time.perf_counter() - t0
    return arrays
