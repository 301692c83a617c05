"""Host-side BVH construction -> flattened depth-first SoA node arrays.

Port of pbrt_tpu/accel/build.py.  Layout mirrors LinearBVHNode
(bvh.cpp:95-104, 640-658):
  nodes_min/max [M,3] f32   slab bounds
  offset        [M]   i32   leaf: first ordered-prim index; interior: 2nd child
  n_prims       [M]   i32   0 marks an interior node
  axis          [M]   i32   interior split axis
plus ``order [P] i32``, the BVH-ordered primitive indices (orderedPrims).

Build: binned SAH with 12 buckets and maxPrimsInNode (bvh.cpp:236-383).  The
default builder is the port's copy of the C++ builder
(csrc/host/bvh_builder.cpp), compiled at first use by native.py; the numpy
builder gives the identical tree and runs only when asked for (method=
"numpy"), since it takes about a minute beyond 100k primitives.
"""
from __future__ import annotations

import ctypes
import dataclasses
import sys

import numpy as np

N_BUCKETS = 12
RELATIVE_TRAVERSAL_COST = 1.0


@dataclasses.dataclass
class BVHArrays:
    nodes_min: np.ndarray
    nodes_max: np.ndarray
    offset: np.ndarray
    n_prims: np.ndarray
    axis: np.ndarray
    order: np.ndarray

    @property
    def n_nodes(self) -> int:
        return self.nodes_min.shape[0]


def build_bvh(bounds_min, bounds_max, max_prims_in_node: int = 4,
              method: str = "native") -> BVHArrays:
    """Build from per-primitive world bounds [P,3].  method: "native" (the
    C++ builder; raises if it cannot be built) or "numpy"."""
    if bounds_min.shape[0] == 0:
        raise ValueError("empty scene")
    if method == "native":
        return build_bvh_native(bounds_min, bounds_max, max_prims_in_node)
    if method != "numpy":
        raise ValueError(f"unknown BVH build method {method!r}")
    return build_bvh_numpy(bounds_min, bounds_max, max_prims_in_node)


def build_bvh_native(bounds_min, bounds_max, max_prims_in_node=4) -> BVHArrays:
    from ..native import host_lib

    lib = host_lib()
    p = bounds_min.shape[0]
    bmin = np.ascontiguousarray(bounds_min, np.float64)
    bmax = np.ascontiguousarray(bounds_max, np.float64)
    max_nodes = 2 * p + 1
    nodes_min = np.empty((max_nodes, 3), np.float32)
    nodes_max = np.empty((max_nodes, 3), np.float32)
    offset = np.empty(max_nodes, np.int32)
    nprims = np.empty(max_nodes, np.int32)
    axis = np.empty(max_nodes, np.int32)
    order = np.empty(p, np.int32)

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    n_nodes = lib.bvh_build(
        ptr(bmin, ctypes.c_double), ptr(bmax, ctypes.c_double),
        p, max_prims_in_node, max_nodes,
        ptr(nodes_min, ctypes.c_float), ptr(nodes_max, ctypes.c_float),
        ptr(offset, ctypes.c_int32), ptr(nprims, ctypes.c_int32),
        ptr(axis, ctypes.c_int32), ptr(order, ctypes.c_int32),
    )
    if n_nodes < 0:
        raise RuntimeError("native BVH builder overflowed its node buffer")
    return BVHArrays(
        nodes_min=nodes_min[:n_nodes].copy(),
        nodes_max=nodes_max[:n_nodes].copy(),
        offset=offset[:n_nodes].copy(),
        n_prims=nprims[:n_nodes].copy(),
        axis=axis[:n_nodes].copy(),
        order=order,
    )


def build_bvh_numpy(bounds_min, bounds_max, max_prims_in_node=4) -> BVHArrays:
    p = bounds_min.shape[0]
    bounds_min = np.asarray(bounds_min, np.float64)
    bounds_max = np.asarray(bounds_max, np.float64)
    centroids = 0.5 * (bounds_min + bounds_max)

    # Nodes collected depth-first during an explicit-stack build so the
    # flattened layout (first child adjacent, bvh.cpp:640 flattenBVHTree)
    # falls out directly.
    nmin, nmax, offset, nprims, axis = [], [], [], [], []
    order: list[int] = []

    def emit_leaf(idxs):
        nmin.append(bounds_min[idxs].min(0))
        nmax.append(bounds_max[idxs].max(0))
        offset.append(len(order))
        nprims.append(len(idxs))
        axis.append(0)
        order.extend(idxs.tolist())

    def build_range(idxs) -> int:
        """Returns this subtree root's node id."""
        node_id = len(nmin)
        n = len(idxs)
        bmin = bounds_min[idxs].min(0)
        bmax = bounds_max[idxs].max(0)
        if n <= 1:
            emit_leaf(idxs)
            return node_id
        cmin = centroids[idxs].min(0)
        cmax = centroids[idxs].max(0)
        dim = int(np.argmax(cmax - cmin))
        if cmax[dim] == cmin[dim]:
            # Degenerate centroids: keep leaves <= max_prims (the packed-leaf
            # traversal has exactly max_prims slots) by arbitrary halving.
            if n <= max_prims_in_node:
                emit_leaf(idxs)
                return node_id
            nmin.append(bmin)
            nmax.append(bmax)
            offset.append(-1)
            nprims.append(0)
            axis.append(dim)
            build_range(idxs[: n // 2])
            offset[node_id] = build_range(idxs[n // 2 :])
            return node_id

        c = centroids[idxs, dim]
        if n <= 2:
            mid = n // 2
            part = np.argsort(c, kind="stable")
            left, right = idxs[part[:mid]], idxs[part[mid:]]
        else:
            # Binned SAH (bvh.cpp:320-383).
            b = np.minimum(
                (N_BUCKETS * (c - cmin[dim]) / (cmax[dim] - cmin[dim])).astype(int),
                N_BUCKETS - 1,
            )
            counts = np.bincount(b, minlength=N_BUCKETS)
            bucket_min = np.full((N_BUCKETS, 3), np.inf)
            bucket_max = np.full((N_BUCKETS, 3), -np.inf)
            for k in range(N_BUCKETS):
                m = b == k
                if m.any():
                    bucket_min[k] = bounds_min[idxs[m]].min(0)
                    bucket_max[k] = bounds_max[idxs[m]].max(0)

            def area(mn, mx):
                d = np.maximum(mx - mn, 0)
                return 2.0 * (d[..., 0] * d[..., 1] + d[..., 0] * d[..., 2] + d[..., 1] * d[..., 2])

            # Prefix/suffix sweep for per-split areas.
            lmin = np.minimum.accumulate(bucket_min, 0)
            lmax = np.maximum.accumulate(bucket_max, 0)
            rmin = np.minimum.accumulate(bucket_min[::-1], 0)[::-1]
            rmax = np.maximum.accumulate(bucket_max[::-1], 0)[::-1]
            lcount = np.cumsum(counts)
            rcount = np.cumsum(counts[::-1])[::-1]
            cost = np.full(N_BUCKETS - 1, np.inf)
            for k in range(N_BUCKETS - 1):
                if lcount[k] == 0 or rcount[k + 1] == 0:
                    continue
                cost[k] = RELATIVE_TRAVERSAL_COST + (
                    lcount[k] * area(lmin[k], lmax[k])
                    + rcount[k + 1] * area(rmin[k + 1], rmax[k + 1])
                ) / max(area(bmin, bmax), 1e-30)
            best = int(np.argmin(cost))
            leaf_cost = float(n)
            if n > max_prims_in_node or cost[best] < leaf_cost:
                m = b <= best
                left, right = idxs[m], idxs[~m]
                if len(left) == 0 or len(right) == 0:
                    part = np.argsort(c, kind="stable")
                    left, right = idxs[part[: n // 2]], idxs[part[n // 2 :]]
            else:
                emit_leaf(idxs)
                return node_id

        # Interior node: reserve slot, recurse depth-first.
        nmin.append(bmin)
        nmax.append(bmax)
        offset.append(-1)
        nprims.append(0)
        axis.append(dim)
        build_range(left)
        offset[node_id] = build_range(right)
        return node_id

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000 + 64))
    try:
        build_range(np.arange(p))
    finally:
        sys.setrecursionlimit(old_limit)

    return BVHArrays(
        nodes_min=np.asarray(nmin, np.float32),
        nodes_max=np.asarray(nmax, np.float32),
        offset=np.asarray(offset, np.int32),
        n_prims=np.asarray(nprims, np.int32),
        axis=np.asarray(axis, np.int32),
        order=np.asarray(order, np.int32),
    )
