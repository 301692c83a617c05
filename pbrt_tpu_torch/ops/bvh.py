"""BVH traversal: the two CUDA kernels' wrappers, their plain PyTorch
versions, and the glue around them.

Replaces pbrt_tpu/ops/pallas_bvh.py, with the same ``(t, prim)`` contract:

* ``csrc/bvh4_traverse.cu`` takes the place of the Pallas kernel
  ``_make_kernel4`` (launched by ``_run_packets4``), the default;
* ``csrc/bvh2_traverse.cu`` takes the place of the binary-BVH Pallas kernel
  ``_make_kernel`` (launched by ``_run_packets``), chosen, as in the JAX
  package, by ``PBRT_TPU_BVH4=0`` for the scenes inside the gate.

See each source's note for what bounds it on an H100 and what its design
does about it.  Here:

* ``build_bvh4_table`` collapses the binary BVH two levels at a time into
  128-byte 4-wide node rows, ``build_bvh2_table`` lays the binary BVH out as
  64-byte rows, one per interior node, that hold both children's boxes (a
  virtual row 0 holds the root), and ``build_prim_records`` lays the
  triangles out contiguously in BVH order for both;
* ``bvh4_traverse`` / ``bvh2_traverse`` check their inputs and launch their
  kernel for CUDA tensors, or run the plain version for CPU tensors; both
  take the rays in the order of a permutation ``order`` and return each
  ray's result in its own place;
* ``bvh4_traverse_plain`` / ``bvh2_traverse_plain`` are the same functions in
  plain PyTorch (same tree, same visit order, same Moller-Trumbore
  arithmetic), vectorised over rays; they also count node-row fetches and
  triangle tests per ray;
* ``record_calls`` keeps the ray batches of every traversal in a block;
* ``bvh4_traverse_typed`` is the bvh4 kernel's typed-leaf build (the same
  source, a template parameter): every record type is tested in the
  leaves (triangles, instanced triangles, the six quadrics, curves), for
  the scenes past the JAX package's gate; its plain version is
  ``bvh4_traverse_plain(typed=typed_tables(scene))``;
* ``intersect_kernel_with_quadrics`` sorts the rays by (dead, direction
  octant, origin Morton code), hands the unsorted rays and the permutation
  to the kernel, and, inside the gate, tests the scene's few quadrics by
  brute force (``quadric_pass``, pallas_bvh.py:760-858);
* ``kernel_supported`` is the gate of pallas_bvh.py:861-890 and
  ``traversal_route`` picks the build.
"""
from __future__ import annotations

import contextlib
import math
import os

import numpy as np
import torch
from torch.profiler import record_function

STACK_SIZE = 128  # bvh4 per-thread stack entries; the kernel's kStackSize
BVH2_STACK_SIZE = 64  # bvh2 per-thread stack entries (pbrt's todo[64])
LEAF_FLAG = 1 << 31
MAX_LEAF_PRIMS = 127  # 7 bits of a leaf stack entry
MAX_PRIMS = 1 << 24  # 24 bits of a leaf stack entry
MAX_BRUTE_QUADRICS = 64
TYPE_CURVE = 7  # the record types of the typed leaves (scene.SHAPE_*)
TYPE_INSTANCE = 8
QUADRIC_TYPES = (1, 2, 3, 4, 5, 6)
NODE_BYTES = 128  # one 4-wide row
NODE2_BYTES = 64  # one binary row: both children of an interior node
PRIM_BYTES = 48
RAY_BYTES = 40  # o, d, t_max, mode in; t, prim out
_INF = math.inf


def use_bvh2() -> bool:
    """The JAX package's switch (pallas_bvh.py:700-702): PBRT_TPU_BVH4=0
    traverses the binary BVH in the scenes inside the gate.  Read at each
    call."""
    return os.environ.get("PBRT_TPU_BVH4", "1") == "0"


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------

def node_levels(offset, n_prims) -> np.ndarray:
    """Each binary node's level below the root (the root is level 0)."""
    offset = np.asarray(offset, np.int64)
    is_leaf = np.asarray(n_prims) > 0
    level = np.zeros(is_leaf.shape[0], np.int64)
    frontier = np.array([0])
    k = 0
    while frontier.size:
        level[frontier] = k
        inner = frontier[~is_leaf[frontier]]
        frontier = np.concatenate([inner + 1, offset[inner]])
        k += 1
    return level


def build_bvh4_table(nodes_min, nodes_max, offset, n_prims):
    """Collapse a flattened binary BVH into 4-wide node rows.

    Binary interior nodes at even depth become 4-wide nodes; each holds the
    children of its two children (a leaf child stays a single slot).  Rows
    are [M4, 32] float32: child box k at [6k:6k+6] (min xyz, max xyz), then
    4 int32 refs and 4 int32 counts stored bit for bit (count -1 empty,
    0 interior with ref = 4-wide node id, > 0 leaf with ref = first prim).
    Returns (rows, depth), depth = number of 4-wide levels."""
    offset = np.asarray(offset, np.int64)
    n_prims = np.asarray(n_prims, np.int64)
    if n_prims.max(initial=0) > MAX_LEAF_PRIMS:
        raise ValueError(f"leaves above {MAX_LEAF_PRIMS} primitives")
    if int(n_prims.sum()) >= MAX_PRIMS:
        raise ValueError(f"scenes of {MAX_PRIMS} or more primitives")
    is_leaf = n_prims > 0
    m = n_prims.shape[0]
    depth = node_levels(offset, n_prims)
    kept = np.nonzero(~is_leaf & (depth % 2 == 0))[0]
    if is_leaf[0]:
        kept = np.array([0])
        slots = np.array([[0, -1, -1, -1]])
    else:
        kept = kept[np.lexsort((kept, depth[kept]))]  # breadth-first order
        c0 = kept + 1
        c1 = offset[kept]
        l0, l1 = is_leaf[c0], is_leaf[c1]
        slots = np.stack([
            np.where(l0, c0, c0 + 1), np.where(l0, -1, offset[c0]),
            np.where(l1, c1, c1 + 1), np.where(l1, -1, offset[c1]),
        ], 1)
    id4 = np.full(m, -1, np.int64)
    id4[kept] = np.arange(kept.size)
    k = kept.size
    boxes = np.empty((k, 4, 6), np.float32)
    boxes[..., :3] = 1e30
    boxes[..., 3:] = -1e30
    refs = np.zeros((k, 4), np.int32)
    counts = np.full((k, 4), -1, np.int32)
    used = slots >= 0
    b = slots[used]
    boxes[used, :3] = np.asarray(nodes_min, np.float32)[b]
    boxes[used, 3:] = np.asarray(nodes_max, np.float32)[b]
    refs[used] = np.where(is_leaf[b], offset[b], id4[b])
    counts[used] = np.where(is_leaf[b], n_prims[b], 0)
    if (refs[used] < 0).any():
        raise AssertionError("a 4-wide child points at no node")
    rows = np.concatenate(
        [boxes.reshape(k, 24), refs.view(np.float32), counts.view(np.float32)], 1)
    n_levels = int(depth[kept].max()) // 2 + 1
    return np.ascontiguousarray(rows), n_levels


def build_bvh2_table(nodes_min, nodes_max, offset, n_prims, axis):
    """The binary BVH as [M2, 16] float32 rows, one 64-byte row per interior
    node holding both of its children: child k's box at [6k:6k+6] (min xyz,
    max xyz), then four int32 stored bit for bit: the children's refs at 12
    and 13 and their counts at 14 and 15 (as in the 4-wide table: -1 empty,
    0 interior with the ref a row id, > 0 a leaf with the ref its first
    primitive); the node's split axis sits in bits 16-17 of word 14, child
    0's count in its low 16 bits.  Child 0 is the node's first child in the
    flattened tree, child 1 its second (pbrt's secondChildOffset).  Row 0 is
    a virtual parent: child 0 the root, child 1 empty; the interior nodes
    follow in the flattened tree's depth-first order, and leaves have no
    row.  Returns (rows, depth), depth = the deepest node's level, the most
    stack entries a traversal holds."""
    offset = np.asarray(offset, np.int64)
    n_prims = np.asarray(n_prims, np.int64)
    if n_prims.max(initial=0) > 0xFFFF:
        raise ValueError("leaves above 65535 primitives")
    is_leaf = n_prims > 0
    inner = np.nonzero(~is_leaf)[0]
    row_of = np.full(offset.shape[0], -1, np.int64)
    row_of[inner] = np.arange(1, inner.size + 1)
    kids = np.stack([np.concatenate([[0], inner + 1]),
                     np.concatenate([[-1], offset[inner]])], 1)
    k = kids.shape[0]
    boxes = np.empty((k, 2, 6), np.float32)
    boxes[..., :3] = 1e30
    boxes[..., 3:] = -1e30
    refs = np.zeros((k, 2), np.int64)
    counts = np.full((k, 2), -1, np.int64)
    used = kids >= 0
    c = kids[used]
    boxes[used, :3] = np.asarray(nodes_min, np.float32)[c]
    boxes[used, 3:] = np.asarray(nodes_max, np.float32)[c]
    refs[used] = np.where(is_leaf[c], offset[c], row_of[c])
    counts[used] = np.where(is_leaf[c], n_prims[c], 0)
    if (refs[used] < 0).any():
        raise AssertionError("a binary child points at no row")
    axis = np.concatenate([[0], np.asarray(axis, np.int64)[inner]])
    counts[:, 0] |= axis << 16
    rows = np.concatenate([boxes.reshape(k, 12),
                           refs.astype(np.int32).view(np.float32),
                           counts.astype(np.int32).view(np.float32)], 1)
    return np.ascontiguousarray(rows), int(node_levels(offset, n_prims).max())


def build_prim_records(prim_type, prim_idx, tri_verts, inst_tri=None):
    """[P, 12] float32 per primitive in BVH order, 48 bytes: (v0, type),
    (e1, 0), (e2, 0) with e1 = v1 - v0, e2 = v2 - v0 for a triangle.  An
    instanced triangle (type 8) holds its shared object-space triangle the
    same way, with its instance's inst_xf row in word 7 (int32 bits); a
    quadric (types 1-6) or a curve (type 7) holds its q_packed or
    curve_packed row in word 4 (int32 bits) and zeros elsewhere."""
    prim_type = np.asarray(prim_type)
    prim_idx = np.asarray(prim_idx, np.int32)
    rec = np.zeros((prim_type.shape[0], 12), np.float32)
    rec[:, 3] = prim_type.astype(np.float32)
    bits = rec.view(np.int32)
    tri = prim_type == 0
    inst = prim_type == TYPE_INSTANCE
    rows = prim_idx[tri]
    if inst.any():
        it = np.asarray(inst_tri, np.int32)[prim_idx[inst]]
        rows = np.concatenate([rows, it[:, 0]])
    v = np.asarray(tri_verts, np.float32)[rows]
    both = tri | inst
    sel = np.concatenate([np.nonzero(tri)[0], np.nonzero(inst)[0]])
    rec[sel, 0:3] = v[:, 0:3]
    rec[sel, 4:7] = v[:, 3:6] - v[:, 0:3]
    rec[sel, 8:11] = v[:, 6:9] - v[:, 0:3]
    if inst.any():
        bits[inst, 7] = it[:, 1]
    bits[~both, 4] = prim_idx[~both]
    return rec


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------

def _slab(box, o, inv, t_best):
    """Slab test of [K, 4, 6] boxes; returns (hit, t_near) [K, 4]."""
    t0 = (box[..., 0:3] - o[:, None, :]) * inv[:, None, :]
    t1 = (box[..., 3:6] - o[:, None, :]) * inv[:, None, :]
    lo = torch.fmin(t0, t1)
    hi = torch.fmax(t0, t1)
    tn = torch.fmax(torch.fmax(lo[..., 0], lo[..., 1]), lo[..., 2])
    tf = torch.fmin(torch.fmin(hi[..., 0], hi[..., 1]), hi[..., 2]) * 1.0000004
    return (tn <= tf) & (tf > 0.0) & (tn < t_best[:, None]), tn


def moller_trumbore(o, d, v0, e1, e2, t_best):
    """The kernel's triangle test (pallas_bvh.py:_tri_hit), same operation
    order.  All [K, 3] / [K]; returns (hit, t)."""
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    e1x, e1y, e1z = e1.unbind(-1)
    e2x, e2y, e2z = e2.unbind(-1)
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    tx = ox - v0[:, 0]
    ty = oy - v0[:, 1]
    tz = oz - v0[:, 2]
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    w = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    hit = ((torch.abs(det) > 1e-12) & (u >= 0.0) & (w >= 0.0)
           & (u + w <= 1.0) & (t > 1e-4) & (t < t_best))
    return hit, t


def typed_leaf_test(rec, o, d, t_best, typed):
    """The typed build's test of one non-triangle record per ray (the same
    operations as csrc/bvh4_traverse.cu's typed leaf step).  rec [K, 12]
    records of type 1-8, o, d [K, 3], t_best [K]; typed = (q_packed,
    curve_packed, inst_xf).  Returns (hit, t, windows): hit requires
    t < t_best; windows [K] counts the curve windows a lane evaluated
    (0 off curves and on a curve whose box the ray misses)."""
    from ..core.vecmath import xform_point, xform_vector
    from ..shapes import quadrics as quad
    from ..shapes.curve import curve_intersect

    q_packed, curve_packed, inst_xf = typed
    kind = rec[:, 3]
    hit = torch.zeros(kind.shape, dtype=torch.bool, device=kind.device)
    t = torch.full(kind.shape, _INF, dtype=torch.float32, device=kind.device)
    payload = rec.view(torch.int32)[:, 4].to(torch.int64)
    windows = torch.zeros(kind.shape, dtype=torch.int64, device=kind.device)
    # the record types present, in one host read
    present = torch.bincount(kind.to(torch.int64), minlength=9).tolist()
    inst = (torch.nonzero(kind == float(TYPE_INSTANCE))[:, 0]
            if present[TYPE_INSTANCE] else kind.new_zeros(0, dtype=torch.int64))
    if inst.numel():
        r = rec[inst]
        w2i = inst_xf[r.view(torch.int32)[:, 7].to(torch.int64), :12].view(-1, 3, 4)
        h, ti = moller_trumbore(xform_point(w2i, o[inst]), xform_vector(w2i, d[inst]),
                                r[:, 0:3], r[:, 4:7], r[:, 8:11], t_best[inst])
        hit[inst] = h
        t[inst] = ti
    for qt in QUADRIC_TYPES:
        if present[qt]:
            lanes = torch.nonzero(kind == float(qt))[:, 0]
            row = q_packed[payload[lanes]]
            w2o = row[:, :12].view(-1, 3, 4)
            res = quad.intersect_object(qt, xform_point(w2o, o[lanes]),
                                        xform_vector(w2o, d[lanes]),
                                        t_best[lanes], row[:, 12:24])
            hit[lanes] = res["hit"]
            t[lanes] = res["t"]
    if present[TYPE_CURVE]:
        lanes = torch.nonzero(kind == float(TYPE_CURVE))[:, 0]
        res = curve_intersect(o[lanes], d[lanes], t_best[lanes],
                              curve_packed[payload[lanes]])
        hit[lanes] = res["hit"]
        t[lanes] = res["t"]
        windows[lanes] = res["windows"]
    return hit & (t < t_best), t, windows


def _leaf_tests(li, first, cnt, recs, o, d, any_hit, t_best, prim, prim_tests,
                typed=None):
    """Test the leaves of rays li (first prim, count each) in prim order, as
    the kernels do; updates t_best, prim and prim_tests in place.  Returns
    the any-hit rays that found a hit and stop.  Without `typed` only
    triangle records are tested, as the triangle-only kernels do, and
    prim_tests [n] counts them; with it (q_packed, curve_packed, inst_xf)
    every record type is (_typed_leaf_tests), and prim_tests [n, 10] counts
    the tests of each record type (columns 0-8) and the curve windows
    evaluated (column 9)."""
    found = torch.zeros_like(first, dtype=torch.bool)
    if not li.numel():
        return found
    if typed is not None:
        return _typed_leaf_tests(li, first, cnt, recs, o, d, any_hit, t_best, prim,
                                 prim_tests, typed)
    a = any_hit[li]
    for k in range(int(cnt.max())):
        live = (k < cnt) & ~found
        pid = torch.clamp(first + k, max=recs.shape[0] - 1)
        rec = recs[pid]
        is_tri = live & (rec[:, 3] == 0.0)
        h, t = moller_trumbore(o[li], d[li], rec[:, 0:3], rec[:, 4:7],
                               rec[:, 8:11], t_best[li])
        take = is_tri & h
        prim_tests[li] += is_tri.to(torch.int64)
        t_best[li] = torch.where(take, torch.where(a, -1e30, t), t_best[li])
        prim[li] = torch.where(take, (first + k).to(torch.int32), prim[li])
        found = found | (take & a)
    return found


def _typed_leaf_tests(li, first, cnt, recs, o, d, any_hit, t_best, prim,
                      prim_tests, typed):
    """_leaf_tests of the typed build, with the kernel's results.  Every
    record but a curve is tested once for the whole leaf against the ray's
    t_best on entering it: a triangle's, an instanced triangle's and a
    quadric's test give the same hit and t under any bound above the t
    they find, so taking them in prim order, each if its t is below t_best
    then, is the kernel's sequence.  A curve's test is not so (its last
    passing window sets t), so curves are tested in turn against t_best as
    it stands."""
    found = torch.zeros_like(first, dtype=torch.bool)
    a = any_hit[li]
    n_k = int(cnt.max())
    ks = torch.arange(n_k, device=li.device)
    rec = recs[torch.clamp(first[:, None] + ks, max=recs.shape[0] - 1)]  # [L, K, 12]
    kind = rec[..., 3]
    inleaf = ks < cnt[:, None]
    hit = torch.zeros(kind.shape, dtype=torch.bool, device=li.device)
    tt = torch.full(kind.shape, _INF, dtype=torch.float32, device=li.device)
    sel = torch.nonzero(inleaf & (kind != float(TYPE_CURVE)))
    if sel.numel():
        r = rec[sel[:, 0], sel[:, 1]]
        lane = li[sel[:, 0]]
        bound = t_best[lane]
        h, t = moller_trumbore(o[lane], d[lane], r[:, 0:3], r[:, 4:7], r[:, 8:11],
                               bound)
        is_tri = r[:, 3] == 0.0
        h = h & is_tri
        oth = torch.nonzero(~is_tri)[:, 0]
        if oth.numel():
            ho, to, _ = typed_leaf_test(r[oth], o[lane[oth]], d[lane[oth]],
                                        bound[oth], typed)
            h = h.index_put((oth,), ho)
            t = t.index_put((oth,), to)
        hit[sel[:, 0], sel[:, 1]] = h
        tt[sel[:, 0], sel[:, 1]] = t
    curves = bool((inleaf & (kind == float(TYPE_CURVE))).any())
    for k in range(n_k):
        live = inleaf[:, k] & ~found
        h, t = hit[:, k], tt[:, k]
        counts = torch.zeros((li.shape[0], 10), dtype=torch.int64, device=li.device)
        counts.scatter_(1, torch.where(live, kind[:, k].to(torch.int64), 9)[:, None], 1)
        counts[:, 9] = 0
        if curves:
            cv = torch.nonzero(live & (kind[:, k] == float(TYPE_CURVE)))[:, 0]
            if cv.numel():
                lo = li[cv]
                hc, tc, wc = typed_leaf_test(rec[cv, k], o[lo], d[lo], t_best[lo],
                                             typed)
                h = h.index_put((cv,), hc)
                t = t.index_put((cv,), tc)
                counts[cv, 9] = wc
        prim_tests[li] += counts
        take = live & h & (t < t_best[li])
        t_best[li] = torch.where(take, torch.where(a, -1e30, t), t_best[li])
        prim[li] = torch.where(take, (first + k).to(torch.int32), prim[li])
        found = found | (take & a)
    return found


def _start(o, d, t_max, stack_size, typed=False):
    """Per-ray state shared by both plain versions."""
    n = o.shape[0]
    dev = o.device
    z = torch.zeros(n, dtype=torch.int64, device=dev)
    return dict(
        t_best=t_max.clone(),
        prim=torch.full((n,), -1, dtype=torch.int32, device=dev),
        inv=1.0 / torch.where(d == 0.0, 1e-30, d),
        stack=torch.zeros((n, stack_size), dtype=torch.int64, device=dev),
        sp=z, entry=z.clone(), node_visits=z.clone(),
        prim_tests=(torch.zeros((n, 10), dtype=torch.int64, device=dev) if typed
                    else z.clone()),
        active=t_max > 0.0)


def _push(stack, sp, rows, values, stack_size):
    if rows.numel():
        if bool((sp[rows] >= stack_size).any()):
            raise RuntimeError("BVH traversal stack overflow")
        stack[rows, sp[rows]] = values
        sp[rows] += 1


def _pop(st, idx, pop, finished):
    """Rays idx[pop] take their next entry from the stack or finish."""
    sp, entry, stack, active = st["sp"], st["entry"], st["stack"], st["active"]
    pi = idx[pop]
    can = sp[pi] > 0
    pc = pi[can]
    sp[pc] -= 1
    entry[pc] = stack[pc, sp[pc]]
    active[pi[~can]] = False
    active[idx[finished]] = False


def _result(st, return_counts):
    if return_counts:
        return st["t_best"], st["prim"], st["node_visits"], st["prim_tests"]
    return st["t_best"], st["prim"]


def _in_order(plain, order, nodes, tris, o, d, t_max, mode, return_counts,
              **kw):
    """`plain` on the rays taken in `order` (a permutation), each output
    scattered back to its ray's place, as the kernels read and write."""
    idx = order.to(torch.int64)
    res = plain(nodes, tris, o[idx], d[idx], t_max[idx], mode[idx], return_counts,
                **kw)
    out = []
    for r in res:
        back = torch.empty_like(r)
        back[idx] = r
        out.append(back)
    return tuple(out)


def bvh4_traverse_plain(nodes, tris, o, d, t_max, mode, return_counts=False,
                        order=None, typed=None):
    """The bvh4 kernel's function in plain PyTorch: one loop step advances
    every unfinished ray by one node or leaf visit.  order (int32 [n], None =
    the identity) is the kernel's work list.  typed = (q_packed,
    curve_packed, inst_xf) is the typed build's function (every record type
    tested), None the triangle-only build's.  Returns (t, prim) or, with
    return_counts, (t, prim, node_visits, prim_tests)."""
    if order is not None:
        return _in_order(bvh4_traverse_plain, order, nodes, tris, o, d, t_max,
                         mode, return_counts, typed=typed)
    rows_f = nodes.view(-1, 32)
    rows_i = nodes.view(torch.int32).view(-1, 32)
    recs = tris.view(-1, 12)
    any_hit = mode > 0.0
    st = _start(o, d, t_max, STACK_SIZE, typed is not None)
    t_best, prim, inv, entry = st["t_best"], st["prim"], st["inv"], st["entry"]
    while bool(st["active"].any()):
        idx = torch.nonzero(st["active"])[:, 0]
        e = entry[idx]
        leaf = (e & LEAF_FLAG) != 0
        pop = torch.ones_like(leaf)
        finished = torch.zeros_like(leaf)

        le = e[leaf]
        found = _leaf_tests(idx[leaf], le & 0xFFFFFF, (le >> 24) & 0x7F, recs,
                            o, d, any_hit, t_best, prim, st["prim_tests"], typed)
        finished[leaf] = found
        pop[leaf] = ~found

        ni = idx[~leaf]
        if ni.numel():
            ne = e[~leaf]
            st["node_visits"][ni] += 1
            rf = rows_f[ne]
            ri = rows_i[ne].to(torch.int64)
            hit, tn = _slab(rf[:, :24].view(-1, 4, 6), o[ni], inv[ni], t_best[ni])
            cnt = ri[:, 28:32]
            hit = hit & (cnt >= 0)
            key = torch.where(hit, tn, _INF)
            ref = torch.where(cnt > 0, LEAF_FLAG | (cnt << 24) | (ri[:, 24:28] & 0xFFFFFFFF),
                              ri[:, 24:28] & 0xFFFFFFFF)
            skey, perm = torch.sort(key, dim=1, stable=True)
            sref = torch.gather(ref, 1, perm)
            shit = skey != _INF
            for c in (3, 2, 1):
                m = shit[:, c]
                _push(st["stack"], st["sp"], ni[m], sref[m, c], STACK_SIZE)
            desc = shit[:, 0]
            entry[ni[desc]] = sref[desc, 0]
            pop[~leaf] = ~desc
        _pop(st, idx, pop, finished)
    return _result(st, return_counts)


def _pop_entered(st, stack_tn, idx, pop, finished):
    """Rays idx[pop] take the next stack entry whose stored t_near is still
    below their t_best (the others are dropped with no fetch), or finish."""
    sp, entry, stack, active = st["sp"], st["entry"], st["stack"], st["active"]
    active[idx[finished]] = False
    pi = idx[pop]
    while pi.numel():
        can = sp[pi] > 0
        active[pi[~can]] = False
        pc = pi[can]
        sp[pc] -= 1
        top = sp[pc]
        take = stack_tn[pc, top] < st["t_best"][pc]
        entry[pc[take]] = stack[pc[take], top[take]]
        pi = pc[~take]


def bvh2_traverse_plain(nodes, tris, o, d, t_max, mode, return_counts=False,
                        order=None):
    """The bvh2 kernel's function in plain PyTorch (pbrt-v3's
    BVHAccel::Intersect over rows that hold both children): one loop step
    takes one item per unfinished ray.  A row is fetched (one node visit)
    and both child boxes are slab-tested; the ray enters the child nearer
    along the node's split axis by its own direction sign, pushing the other
    with its t_near, or enters the one child hit, or pops.  A leaf's
    primitives are tested with no fetch of a row.  A popped child is entered
    only if its stored t_near is below t_best then, which is what testing
    its box at that moment decided in a design of one row per node:
    the same leaves are tested in the same order.  order as for
    bvh4_traverse_plain.  Returns (t, prim) or, with return_counts, (t,
    prim, node_visits, prim_tests)."""
    if order is not None:
        return _in_order(bvh2_traverse_plain, order, nodes, tris, o, d, t_max,
                         mode, return_counts)
    rows_f = nodes.view(-1, 16)
    rows_i = nodes.view(torch.int32).view(-1, 16)
    recs = tris.view(-1, 12)
    any_hit = mode > 0.0
    st = _start(o, d, t_max, BVH2_STACK_SIZE)
    stack_tn = torch.zeros(st["stack"].shape, dtype=torch.float32, device=o.device)
    t_best, prim, inv, entry = st["t_best"], st["prim"], st["inv"], st["entry"]
    dir_is_neg = inv < 0.0
    # An entry is ref | count << 32: a row id (count 0) or a leaf's first
    # primitive and its count; the rays start at the virtual row 0.
    while bool(st["active"].any()):
        idx = torch.nonzero(st["active"])[:, 0]
        e = entry[idx]
        cnt = e >> 32
        leaf = cnt > 0
        pop = torch.ones_like(leaf)
        finished = torch.zeros_like(leaf)

        found = _leaf_tests(idx[leaf], e[leaf] & 0xFFFFFFFF, cnt[leaf], recs,
                            o, d, any_hit, t_best, prim, st["prim_tests"])
        finished[leaf] = found
        pop[leaf] = ~found

        ni = idx[~leaf]
        if ni.numel():
            st["node_visits"][ni] += 1
            row = e[~leaf]
            rf = rows_f[row]
            ri = rows_i[row].to(torch.int64)
            hit, tn = _slab(rf[:, :12].view(-1, 2, 6), o[ni], inv[ni], t_best[ni])
            counts = torch.stack([ri[:, 14] & 0xFFFF, ri[:, 15]], 1)
            hit = hit & (counts >= 0)
            kid = (ri[:, 12:14] & 0xFFFFFFFF) | (counts.clamp(min=0) << 32)
            near = dir_is_neg[ni, (ri[:, 14] >> 16) & 3].to(torch.int64)[:, None]
            far = 1 - near
            hn, hf = hit.gather(1, near)[:, 0], hit.gather(1, far)[:, 0]
            both_hit = hn & hf
            _push(st["stack"], st["sp"], ni[both_hit],
                  kid.gather(1, far)[both_hit, 0], BVH2_STACK_SIZE)
            sp_top = st["sp"][ni[both_hit]] - 1
            stack_tn[ni[both_hit], sp_top] = tn.gather(1, far)[both_hit, 0]
            go = hn | hf
            entry[ni[go]] = torch.where(hn, kid.gather(1, near)[:, 0],
                                        kid.gather(1, far)[:, 0])[go]
            pop[~leaf] = ~go
        _pop_entered(st, stack_tn, idx, pop, finished)
    return _result(st, return_counts)


# ---------------------------------------------------------------------------
# The wrappers
# ---------------------------------------------------------------------------

def _check(name, x, dtype, shape):
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


_recorders: list[list] = []


@contextlib.contextmanager
def record_calls():
    """Within the block, every call of bvh4_traverse or bvh2_traverse
    appends copies of its inputs (o, d, t_max, mode, order; order may be
    None) to the yielded list, so a caller can replay the batches a render
    traversed exactly as they were launched."""
    calls: list = []
    _recorders.append(calls)
    try:
        yield calls
    finally:
        _recorders.remove(calls)


def _traverse(kernel, width, stack_need, stack_size, plain,
              nodes, tris, o, d, t_max, mode, order, typed=None):
    """Shared body of the wrappers: record, check, then the plain version
    for CPU tensors or one launch of `kernel` for CUDA tensors (its typed
    entry point `<kernel>_typed` with the typed tables)."""
    for calls in _recorders:
        calls.append(tuple(None if x is None else x.clone()
                           for x in (o, d, t_max, mode, order)))
    n = o.shape[0]
    _check("nodes", nodes, torch.float32, (nodes.shape[0], width))
    _check("tris", tris, torch.float32, (tris.shape[0], 12))
    _check("o", o, torch.float32, (n, 3))
    _check("d", d, torch.float32, (n, 3))
    _check("t_max", t_max, torch.float32, (n,))
    _check("mode", mode, torch.float32, (n,))
    if order is not None:
        _check("order", order, torch.int32, (n,))
    if typed is not None:
        for name, x, w in zip(("q_packed", "curve_packed", "inst_xf"), typed,
                              (24, 28, 24)):
            _check(name, x, torch.float32, (x.shape[0], w))
    devs = {x.device for x in (nodes, tris, o, d, t_max, mode, order,
                               *(typed or ())) if x is not None}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    if stack_need > stack_size:
        raise ValueError(f"{kernel}: the BVH needs {stack_need} stack "
                         f"entries; the kernel has {stack_size}")
    dev = o.device
    if dev.type == "cpu":
        if typed is not None:
            return plain(nodes, tris, o, d, t_max, mode, order=order, typed=typed)
        return plain(nodes, tris, o, d, t_max, mode, order=order)
    if dev.type != "cuda":
        raise NotImplementedError(f"{kernel} on {dev.type} tensors")
    from ..native import cuda_lib

    lib = cuda_lib(kernel)
    if getattr(lib, f"{kernel}_stack_size")() != stack_size:
        raise RuntimeError(f"{kernel}: kernel stack size differs from ops/bvh.py")
    t_out = torch.empty((n,), dtype=torch.float32, device=dev)
    prim_out = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return t_out, prim_out
    tables = [] if typed is None else [x.data_ptr() for x in typed]
    name = kernel if typed is None else f"{kernel}_typed"
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, name)(
            nodes.data_ptr(), tris.data_ptr(), *tables, o.data_ptr(),
            d.data_ptr(), t_max.data_ptr(), mode.data_ptr(),
            None if order is None else order.data_ptr(), t_out.data_ptr(),
            prim_out.data_ptr(), n, stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    return t_out, prim_out


def bvh4_traverse(nodes, tris, o, d, t_max, mode, depth: int, order=None):
    """Closest/any-hit traversal of the 4-wide BVH: (t f32 [n], prim i32 [n]).

    nodes [M4, 32] f32 and tris [P, 12] f32 from build_bvh4_table /
    build_prim_records; o, d [n, 3] f32; t_max, mode [n] f32 (mode > 0 =
    any-hit).  depth: the tree's 4-wide levels, checked against the stack.
    order: int32 [n], the kernel's work list (None = the identity); it must
    be a permutation of range(n), which is not checked (on the card a
    repeated or out-of-range entry races or writes out of bounds); the
    results come back in the rays' own places whatever the order.  CUDA
    tensors launch the kernel (one launch, counted in
    bvh4_traverse.launches); CPU tensors run bvh4_traverse_plain."""
    out = _traverse("bvh4_traverse", 32, 3 * depth, STACK_SIZE,
                    bvh4_traverse_plain, nodes, tris, o, d, t_max, mode, order)
    if o.is_cuda and o.shape[0]:
        bvh4_traverse.launches += 1
    return out


bvh4_traverse.launches = 0


def bvh4_traverse_typed(nodes, tris, q_packed, curve_packed, inst_xf, o, d,
                        t_max, mode, depth: int, order=None):
    """bvh4_traverse's typed build: the same tree, stack, work list, dead
    and any-hit lanes, but every leaf record is tested by its type:
    triangles (Moller-Trumbore, as the triangle-only build), instanced
    triangles (the ray moved into the instance's object space by its
    inst_xf row, d not renormalised), the six quadrics (the object-space
    tests of shapes/quadrics.py on the record's q_packed row) and curves
    (shapes/curve.py's 16-window sweep on its curve_packed row).
    q_packed [Q, 24], curve_packed [C, 28], inst_xf [I, 24] f32 (a one-row
    placeholder when the scene has none).  CUDA tensors launch the kernel's
    typed entry point (counted in bvh4_traverse_typed.launches); CPU
    tensors run bvh4_traverse_plain(typed=...)."""
    out = _traverse("bvh4_traverse", 32, 3 * depth, STACK_SIZE,
                    bvh4_traverse_plain, nodes, tris, o, d, t_max, mode, order,
                    typed=(q_packed, curve_packed, inst_xf))
    if o.is_cuda and o.shape[0]:
        bvh4_traverse_typed.launches += 1
    return out


bvh4_traverse_typed.launches = 0


def bvh2_traverse(nodes, tris, o, d, t_max, mode, depth: int, order=None):
    """Closest/any-hit traversal of the binary BVH, the same contract as
    bvh4_traverse.  nodes [M2, 16] f32 from build_bvh2_table; depth: its
    deepest node's level, checked against the stack; order as for
    bvh4_traverse.  CUDA tensors launch the kernel (counted in
    bvh2_traverse.launches); CPU tensors run bvh2_traverse_plain."""
    out = _traverse("bvh2_traverse", 16, depth, BVH2_STACK_SIZE,
                    bvh2_traverse_plain, nodes, tris, o, d, t_max, mode, order)
    if o.is_cuda and o.shape[0]:
        bvh2_traverse.launches += 1
    return out


bvh2_traverse.launches = 0


# ---------------------------------------------------------------------------
# Ray sort, quadric pass, gate
# ---------------------------------------------------------------------------

def _morton_part(x):
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def sort_rays_key(root_min, root_max, o, d, t_max):
    """Coherence key: dead (1 bit, where t_max <= 0 as the kernels read it)
    | direction octant (3 bits) | origin Morton code (27 bits) quantised to
    the scene bounds (pallas_bvh.py:760-779 plus the dead bit).  A stable
    argsort of it lists every live ray first, in octant/Morton order, and
    every dead ray last."""
    q = torch.clamp((o - root_min) / torch.clamp(root_max - root_min, min=1e-6)
                    * 511.0, 0.0, 511.0).to(torch.int64)
    morton = ((_morton_part(q[:, 0]) << 2) | (_morton_part(q[:, 1]) << 1)
              | _morton_part(q[:, 2])) & ((1 << 27) - 1)
    octant = (((d[:, 0] < 0).to(torch.int64) << 2)
              | ((d[:, 1] < 0).to(torch.int64) << 1)
              | (d[:, 2] < 0).to(torch.int64))
    dead = (~(t_max > 0.0)).to(torch.int64)
    return (dead << 30) | (octant << 27) | morton


def kernel_supported(scene) -> bool:
    """The JAX package's gate (pallas_bvh.py:861-890): at most
    MAX_BRUTE_QUADRICS quadrics (brute-forced beside the kernel), no curve,
    no instanced triangle, and the tree of the triangle-only kernel that
    PBRT_TPU_BVH4 picks fits its stack.  Such scenes take that kernel."""
    if use_bvh2():
        fits = scene.bvh2_depth <= BVH2_STACK_SIZE
    else:
        fits = 3 * scene.bvh4_depth <= STACK_SIZE
    return (len(scene.quadric_rows) <= MAX_BRUTE_QUADRICS and fits
            and scene.curve_packed is None and scene.inst_tri is None)


def traversal_route(scene) -> str:
    """"kernel" for a scene inside the gate, "typed" for one past it, under
    either value of PBRT_TPU_BVH4: the JAX package sends such a scene to its
    XLA loop whatever the switch says (traverse.py:265-276), and the typed
    build of bvh4 is that loop's counterpart on the card.  Under the switch
    a binary tree deeper than BVH2_STACK_SIZE is past the gate too.  Raises
    NotImplementedError for a 4-wide tree deeper than the stack."""
    if kernel_supported(scene):
        return "kernel"
    if 3 * scene.bvh4_depth > STACK_SIZE:
        raise NotImplementedError(
            f"a BVH deeper than {STACK_SIZE // 3} 4-wide levels")
    return "typed"


def typed_tables(scene) -> tuple:
    """(q_packed, curve_packed, inst_xf) for bvh4_traverse_typed, with a
    one-row placeholder for an absent table."""
    def table(x, width):
        if x is not None:
            return x
        return torch.zeros((1, width), dtype=torch.float32, device=scene.device)

    return (scene.q_packed, table(scene.curve_packed, 28),
            table(scene.inst_xf, 24))


def quadric_pass(scene, o, d, t, prim):
    """The brute-force quadric pass of pallas_bvh.py:830-858: every quadric
    of the scene, in row order, tested against every ray with the kernel's
    t as its bound; a nearer hit takes the ray."""
    from ..core.vecmath import xform_point, xform_vector
    from ..shapes.quadrics import intersect_object

    for qi, prim_row, qtype in scene.quadric_rows:
        row = scene.q_packed[qi]
        w2o = row[:12].view(3, 4)
        s = intersect_object(qtype, xform_point(w2o, o), xform_vector(w2o, d), t,
                             row[12:24])
        take = s["hit"] & (s["t"] < t)
        t = torch.where(take, s["t"], t)
        prim = torch.where(take, prim_row, prim)
    return t, prim


def intersect_kernel_with_quadrics(scene, o, d, t_max, any_mask=None):
    """Closest hit (t [n], prim [n]); any-mask lanes stop at their first
    hit and only prim >= 0 means anything for them.  A scene inside the gate
    goes through bvh4_traverse (or bvh2_traverse under PBRT_TPU_BVH4=0) plus
    the brute-force quadric pass; one past it, under either value of the
    switch, through bvh4_traverse_typed, which tests every primitive in the
    leaves.  The kernel takes the rays in sorted order (live first, then by
    coherence) through `order` and writes each result in its ray's place;
    the order changes speed, never results."""
    route = traversal_route(scene)
    n = o.shape[0]
    dev = o.device
    tm = torch.as_tensor(t_max, dtype=torch.float32, device=dev)
    tm = tm.expand(n).contiguous()
    mode = (torch.zeros(n, dtype=torch.float32, device=dev) if any_mask is None
            else any_mask.expand(n).to(torch.float32).contiguous())
    o = o.contiguous()
    d = d.contiguous()
    with record_function("layer: traversal / key and argsort"):
        key = sort_rays_key(scene.bvh_min[0], scene.bvh_max[0], o, d, tm)
        order = torch.argsort(key, stable=True).to(torch.int32)
    if route == "typed":
        return bvh4_traverse_typed(scene.bvh4_nodes, scene.prim_tris,
                                   *typed_tables(scene), o, d, tm, mode,
                                   scene.bvh4_depth, order)
    if use_bvh2():
        t, prim = bvh2_traverse(scene.bvh2_nodes, scene.prim_tris, o, d, tm,
                                mode, scene.bvh2_depth, order)
    else:
        t, prim = bvh4_traverse(scene.bvh4_nodes, scene.prim_tris, o, d, tm,
                                mode, scene.bvh4_depth, order)
    with record_function("layer: traversal / quadric pass"):
        return quadric_pass(scene, o, d, t, prim)
