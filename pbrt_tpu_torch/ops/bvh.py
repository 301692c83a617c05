"""BVH traversal: the two CUDA kernels' wrappers, their plain PyTorch
versions, and the glue around them.

Replaces pbrt_tpu/ops/pallas_bvh.py, with the same ``(t, prim)`` contract:

* ``csrc/bvh4_traverse.cu`` takes the place of the Pallas kernel
  ``_make_kernel4`` (launched by ``_run_packets4``), the default;
* ``csrc/bvh2_traverse.cu`` takes the place of the binary-BVH Pallas kernel
  ``_make_kernel`` (launched by ``_run_packets``), chosen, as in the JAX
  package, by ``PBRT_TPU_BVH4=0``.

See each source's note for what bounds it on an H100 and what its design
does about it.  Here:

* ``build_bvh4_table`` collapses the binary BVH two levels at a time into
  128-byte 4-wide node rows, ``build_bvh2_table`` lays the binary BVH out as
  32-byte rows (pbrt's LinearBVHNode), and ``build_prim_records`` lays the
  triangles out contiguously in BVH order for both;
* ``bvh4_traverse`` / ``bvh2_traverse`` check their inputs and launch their
  kernel for CUDA tensors, or run the plain version for CPU tensors;
* ``bvh4_traverse_plain`` / ``bvh2_traverse_plain`` are the same functions in
  plain PyTorch (same tree, same visit order, same Moller-Trumbore
  arithmetic), vectorised over rays; they also count node visits and
  triangle tests per ray;
* ``record_calls`` keeps the ray batches of every traversal in a block;
* ``intersect_kernel_with_quadrics`` sorts the rays by (direction octant,
  origin Morton code), traverses, scatters the results back, and tests the
  scene's few quadrics by brute force (pallas_bvh.py:760-852);
* ``kernel_supported`` is the gate of pallas_bvh.py:861-885.
"""
from __future__ import annotations

import contextlib
import math
import os

import numpy as np
import torch

STACK_SIZE = 128  # bvh4 per-thread stack entries; the kernel's kStackSize
BVH2_STACK_SIZE = 64  # bvh2 per-thread stack entries (pbrt's todo[64])
LEAF_FLAG = 1 << 31
MAX_LEAF_PRIMS = 127  # 7 bits of a leaf stack entry
MAX_PRIMS = 1 << 24  # 24 bits of a leaf stack entry
MAX_BRUTE_QUADRICS = 64
NODE_BYTES = 128  # one 4-wide row
NODE2_BYTES = 32  # one binary row
PRIM_BYTES = 48
RAY_BYTES = 40  # o, d, t_max, mode in; t, prim out
_INF = math.inf


def use_bvh2() -> bool:
    """The JAX package's switch (pallas_bvh.py:700-702): PBRT_TPU_BVH4=0
    traverses the binary BVH.  Read at each call."""
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
    """The binary BVH as [M, 8] float32 rows, one 32-byte line per node
    (pbrt's LinearBVHNode): min xyz, max xyz, then two int32 stored bit for
    bit: offset (the second child of an interior node, the first primitive
    of a leaf) and n_prims | axis << 16.  Returns (rows, depth), depth = the
    deepest node's level, the most stack entries a traversal holds."""
    offset = np.asarray(offset, np.int64)
    n_prims = np.asarray(n_prims, np.int64)
    if n_prims.max(initial=0) > 0xFFFF:
        raise ValueError("leaves above 65535 primitives")
    rows = np.empty((offset.shape[0], 8), np.float32)
    rows[:, 0:3] = np.asarray(nodes_min, np.float32)
    rows[:, 3:6] = np.asarray(nodes_max, np.float32)
    rows[:, 6] = offset.astype(np.int32).view(np.float32)
    meta = n_prims | (np.asarray(axis, np.int64) << 16)
    rows[:, 7] = meta.astype(np.int32).view(np.float32)
    return rows, int(node_levels(offset, n_prims).max())


def build_prim_records(prim_type, prim_idx, tri_verts):
    """[P, 12] float32 per primitive in BVH order: (v0, type), (e1, 0),
    (e2, 0) with e1 = v1 - v0, e2 = v2 - v0; non-triangles keep zeros."""
    prim_type = np.asarray(prim_type)
    rec = np.zeros((prim_type.shape[0], 12), np.float32)
    rec[:, 3] = prim_type.astype(np.float32)
    tri = prim_type == 0
    v = np.asarray(tri_verts, np.float32)[np.asarray(prim_idx)[tri]]
    rec[tri, 0:3] = v[:, 0:3]
    rec[tri, 4:7] = v[:, 3:6] - v[:, 0:3]
    rec[tri, 8:11] = v[:, 6:9] - v[:, 0:3]
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


def _leaf_tests(li, first, cnt, recs, o, d, any_hit, t_best, prim, prim_tests):
    """Test the leaves of rays li (first prim, count each) in prim order, as
    the kernels do; updates t_best, prim and prim_tests in place.  Returns
    the any-hit rays that found a hit and stop."""
    found = torch.zeros_like(first, dtype=torch.bool)
    if not li.numel():
        return found
    a = any_hit[li]
    for k in range(int(cnt.max())):
        live = (k < cnt) & ~found
        pid = torch.clamp(first + k, max=recs.shape[0] - 1)
        rec = recs[pid]
        is_tri = live & (rec[:, 3] == 0.0)
        prim_tests[li] += is_tri.to(torch.int64)
        h, t = moller_trumbore(o[li], d[li], rec[:, 0:3], rec[:, 4:7],
                               rec[:, 8:11], t_best[li])
        take = is_tri & h
        t_best[li] = torch.where(take, torch.where(a, -1e30, t), t_best[li])
        prim[li] = torch.where(take, (first + k).to(torch.int32), prim[li])
        found = found | (take & a)
    return found


def _start(o, d, t_max, stack_size):
    """Per-ray state shared by both plain versions."""
    n = o.shape[0]
    dev = o.device
    z = torch.zeros(n, dtype=torch.int64, device=dev)
    return dict(
        t_best=t_max.clone(),
        prim=torch.full((n,), -1, dtype=torch.int32, device=dev),
        inv=1.0 / torch.where(d == 0.0, 1e-30, d),
        stack=torch.zeros((n, stack_size), dtype=torch.int64, device=dev),
        sp=z, entry=z.clone(), node_visits=z.clone(), prim_tests=z.clone(),
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


def bvh4_traverse_plain(nodes, tris, o, d, t_max, mode, return_counts=False):
    """The bvh4 kernel's function in plain PyTorch: one loop step advances
    every unfinished ray by one node or leaf visit.  Returns (t, prim) or,
    with return_counts, (t, prim, node_visits, prim_tests)."""
    rows_f = nodes.view(-1, 32)
    rows_i = nodes.view(torch.int32).view(-1, 32)
    recs = tris.view(-1, 12)
    any_hit = mode > 0.0
    st = _start(o, d, t_max, STACK_SIZE)
    t_best, prim, inv, entry = st["t_best"], st["prim"], st["inv"], st["entry"]
    while bool(st["active"].any()):
        idx = torch.nonzero(st["active"])[:, 0]
        e = entry[idx]
        leaf = (e & LEAF_FLAG) != 0
        pop = torch.ones_like(leaf)
        finished = torch.zeros_like(leaf)

        le = e[leaf]
        found = _leaf_tests(idx[leaf], le & 0xFFFFFF, (le >> 24) & 0x7F, recs,
                            o, d, any_hit, t_best, prim, st["prim_tests"])
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


def bvh2_traverse_plain(nodes, tris, o, d, t_max, mode, return_counts=False):
    """The bvh2 kernel's function in plain PyTorch (pbrt-v3's
    BVHAccel::Intersect): one loop step visits one node per unfinished ray,
    slab-tests its box and, on a hit, tests a leaf's primitives or descends
    to the child nearer along the split axis by the ray's own direction
    sign, pushing the other.  Returns (t, prim) or, with return_counts,
    (t, prim, node_visits, prim_tests)."""
    rows_f = nodes.view(-1, 8)
    rows_i = nodes.view(torch.int32).view(-1, 8)
    recs = tris.view(-1, 12)
    any_hit = mode > 0.0
    st = _start(o, d, t_max, BVH2_STACK_SIZE)
    t_best, prim, inv, entry = st["t_best"], st["prim"], st["inv"], st["entry"]
    dir_is_neg = inv < 0.0
    while bool(st["active"].any()):
        idx = torch.nonzero(st["active"])[:, 0]
        node = entry[idx]
        st["node_visits"][idx] += 1
        rf = rows_f[node]
        ri = rows_i[node].to(torch.int64)
        hit, _ = _slab(rf[:, None, 0:6], o[idx], inv[idx], t_best[idx])
        hit = hit[:, 0]
        off = ri[:, 6]
        cnt = ri[:, 7] & 0xFFFF
        axis = (ri[:, 7] >> 16) & 3
        leaf = hit & (cnt > 0)
        inner = hit & (cnt == 0)
        finished = torch.zeros_like(hit)

        found = _leaf_tests(idx[leaf], off[leaf], cnt[leaf], recs, o, d,
                            any_hit, t_best, prim, st["prim_tests"])
        finished[leaf] = found

        ii = idx[inner]
        neg = dir_is_neg[ii, axis[inner]]
        first_child = node[inner] + 1
        second_child = off[inner]
        _push(st["stack"], st["sp"], ii,
              torch.where(neg, first_child, second_child), BVH2_STACK_SIZE)
        entry[ii] = torch.where(neg, second_child, first_child)
        _pop(st, idx, ~inner & ~finished, finished)
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
    appends copies of its ray inputs (o, d, t_max, mode) to the yielded
    list, so a caller can replay the batches a render traversed."""
    calls: list = []
    _recorders.append(calls)
    try:
        yield calls
    finally:
        _recorders.remove(calls)


def _traverse(kernel, width, stack_need, stack_size, plain,
              nodes, tris, o, d, t_max, mode):
    """Shared body of the two wrappers: record, check, then the plain
    version for CPU tensors or one launch of `kernel` for CUDA tensors."""
    for calls in _recorders:
        calls.append((o.clone(), d.clone(), t_max.clone(), mode.clone()))
    n = o.shape[0]
    _check("nodes", nodes, torch.float32, (nodes.shape[0], width))
    _check("tris", tris, torch.float32, (tris.shape[0], 12))
    _check("o", o, torch.float32, (n, 3))
    _check("d", d, torch.float32, (n, 3))
    _check("t_max", t_max, torch.float32, (n,))
    _check("mode", mode, torch.float32, (n,))
    devs = {x.device for x in (nodes, tris, o, d, t_max, mode)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    if stack_need > stack_size:
        raise ValueError(f"{kernel}: the BVH needs {stack_need} stack "
                         f"entries; the kernel has {stack_size}")
    dev = o.device
    if dev.type == "cpu":
        return plain(nodes, tris, o, d, t_max, mode)
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
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, kernel)(
            nodes.data_ptr(), tris.data_ptr(), o.data_ptr(), d.data_ptr(),
            t_max.data_ptr(), mode.data_ptr(), t_out.data_ptr(),
            prim_out.data_ptr(), n, stream,
        )
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err}")
    return t_out, prim_out


def bvh4_traverse(nodes, tris, o, d, t_max, mode, depth: int):
    """Closest/any-hit traversal of the 4-wide BVH: (t f32 [n], prim i32 [n]).

    nodes [M4, 32] f32 and tris [P, 12] f32 from build_bvh4_table /
    build_prim_records; o, d [n, 3] f32; t_max, mode [n] f32 (mode > 0 =
    any-hit).  depth: the tree's 4-wide levels, checked against the stack.
    CUDA tensors launch the kernel (one launch, counted in
    bvh4_traverse.launches); CPU tensors run bvh4_traverse_plain."""
    out = _traverse("bvh4_traverse", 32, 3 * depth, STACK_SIZE,
                    bvh4_traverse_plain, nodes, tris, o, d, t_max, mode)
    if o.is_cuda and o.shape[0]:
        bvh4_traverse.launches += 1
    return out


bvh4_traverse.launches = 0


def bvh2_traverse(nodes, tris, o, d, t_max, mode, depth: int):
    """Closest/any-hit traversal of the binary BVH, the same contract as
    bvh4_traverse.  nodes [M, 8] f32 from build_bvh2_table; depth: its
    deepest node's level, checked against the stack.  CUDA tensors launch
    the kernel (counted in bvh2_traverse.launches); CPU tensors run
    bvh2_traverse_plain."""
    out = _traverse("bvh2_traverse", 8, depth, BVH2_STACK_SIZE,
                    bvh2_traverse_plain, nodes, tris, o, d, t_max, mode)
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


def sort_rays_key(root_min, root_max, o, d):
    """Coherence key: direction octant (3 bits) | origin Morton code (27
    bits) quantised to the scene bounds (pallas_bvh.py:760-779)."""
    q = torch.clamp((o - root_min) / torch.clamp(root_max - root_min, min=1e-6)
                    * 511.0, 0.0, 511.0).to(torch.int64)
    morton = ((_morton_part(q[:, 0]) << 2) | (_morton_part(q[:, 1]) << 1)
              | _morton_part(q[:, 2])) & ((1 << 27) - 1)
    octant = (((d[:, 0] < 0).to(torch.int64) << 2)
              | ((d[:, 1] < 0).to(torch.int64) << 1)
              | (d[:, 2] < 0).to(torch.int64))
    return (octant << 27) | morton


def kernel_supported(scene) -> bool:
    """The traversal gate: quadrics are brute-forced, so at most
    MAX_BRUTE_QUADRICS of them; and the tree of the kernel that will run
    must fit its stack."""
    if use_bvh2():
        fits = scene.bvh2_depth <= BVH2_STACK_SIZE
    else:
        fits = 3 * scene.bvh4_depth <= STACK_SIZE
    return len(scene.quadric_rows) <= MAX_BRUTE_QUADRICS and fits


def intersect_kernel_with_quadrics(scene, o, d, t_max, any_mask=None):
    """Closest hit through bvh4_traverse (or bvh2_traverse under
    PBRT_TPU_BVH4=0) plus the brute-force quadric pass.  Returns (t [n],
    prim [n]); any-mask lanes stop at their first hit and only prim >= 0
    means anything for them.  The rays are sorted for coherence and the
    results scattered back; the order changes speed, never results."""
    from ..shapes.quadrics import intersect_sphere_object
    from ..core.vecmath import xform_point, xform_vector

    n = o.shape[0]
    dev = o.device
    tm = torch.as_tensor(t_max, dtype=torch.float32, device=dev)
    tm = tm.expand(n).contiguous()
    mode = (torch.zeros(n, dtype=torch.float32, device=dev) if any_mask is None
            else any_mask.expand(n).to(torch.float32).contiguous())
    o = o.contiguous()
    d = d.contiguous()
    key = sort_rays_key(scene.bvh_min[0], scene.bvh_max[0], o, d)
    order = torch.argsort(key, stable=True)
    if use_bvh2():
        t_s, p_s = bvh2_traverse(scene.bvh2_nodes, scene.prim_tris, o[order],
                                 d[order], tm[order], mode[order],
                                 scene.bvh2_depth)
    else:
        t_s, p_s = bvh4_traverse(scene.bvh4_nodes, scene.prim_tris, o[order],
                                 d[order], tm[order], mode[order],
                                 scene.bvh4_depth)
    t = torch.empty_like(t_s)
    prim = torch.empty_like(p_s)
    t[order] = t_s
    prim[order] = p_s
    for qi, prim_row in scene.quadric_rows:
        row = scene.q_packed[qi]
        w2o = row[:12].view(3, 4)
        par = row[12:16]
        oo = xform_point(w2o, o)
        od = xform_vector(w2o, d)
        s = intersect_sphere_object(oo, od, t, par[0], par[1], par[2], par[3])
        take = s["hit"] & (s["t"] < t)
        t = torch.where(take, s["t"], t)
        prim = torch.where(take, prim_row, prim)
    return t, prim
