"""Loop subdivision surfaces to a limit-surface triangle mesh, on the host.

Port of pbrt_tpu/shapes/loopsubdiv.py (shapes/loopsubdiv.cpp:137-467,
LoopSubdivide): the same rules (beta and loopGamma, the one-ring and
boundary rules, the 3/8-1/8 edge rule), the same push to the limit surface
and the same tangent normals, left unnormalised.  The JAX package walks
each vertex's one-ring in a Python loop; here every vertex walks at once
(numpy over vertices, one step a loop), and each formula is applied to all
vertices of one valence together, with the ring's terms summed in the
ring's order.  The float64 operations are those of the JAX package in the
same order, so the arrays are bit-equal to its.

Meshes with an edge shared by more than two faces are refused (the JAX
package picks two of the faces).
"""
from __future__ import annotations

import numpy as np


def _beta(val: int) -> float:
    return 3.0 / 16.0 if val == 3 else 3.0 / (8.0 * val)


def _edges(faces):
    """Undirected edges in order of first appearance (face by face, edges
    (a, b), (b, c), (c, a)), as the JAX package's dict.  Returns (keys
    [E, 2] with key[0] < key[1], faces [E, 2] (the first and second face,
    -1 none), edge id of each face's three edges [F, 3])."""
    nf = faces.shape[0]
    a = faces
    b = np.roll(faces, -1, axis=1)
    lo = np.minimum(a, b).reshape(-1)
    hi = np.maximum(a, b).reshape(-1)
    code = lo * (int(faces.max(initial=0)) + 1) + hi
    _, first, inverse, counts = np.unique(code, return_index=True,
                                          return_inverse=True, return_counts=True)
    if (counts > 2).any():
        raise NotImplementedError(
            "loopsubdiv: an edge shared by more than two faces")
    rank = np.empty_like(first)
    rank[np.argsort(first, kind="stable")] = np.arange(first.size)
    eid = rank[inverse.reshape(-1)]
    n_e = first.size
    keys = np.empty((n_e, 2), faces.dtype)
    keys[eid, 0] = lo
    keys[eid, 1] = hi
    face_of = np.repeat(np.arange(nf), 3)
    efaces = np.full((n_e, 2), -1, np.int64)
    # faces in increasing order: the first occurrence is the first face
    order = np.argsort(eid, kind="stable")
    se = eid[order]
    sf = face_of[order]
    start = np.r_[True, se[1:] != se[:-1]]
    efaces[se[start], 0] = sf[start]
    second = ~start
    efaces[se[second], 1] = sf[second]
    return keys, efaces, eid.reshape(nf, 3)


def _rings(faces, n_verts):
    """Each vertex's ordered one-ring (loopsubdiv.cpp:437-455) as the JAX
    package walks it: (ring [V, K] vertex ids, valence [V], boundary [V])."""
    nf = faces.shape[0]
    keys, efaces, feid = _edges(faces)
    # the first face of each vertex (faces scanned in order)
    flat = faces.reshape(-1)
    start = np.full(n_verts, nf, np.int64)
    np.minimum.at(start, flat, np.repeat(np.arange(nf), 3))
    start[start == nf] = -1
    n_faces_of = np.bincount(flat, minlength=n_verts)

    def vnum(f, v):
        tri = faces[f]
        return np.where(tri[:, 0] == v, 0, np.where(tri[:, 1] == v, 1, 2))

    def other(f, e):
        ef = efaces[e]
        return np.where(ef[:, 1] < 0, -1, np.where(ef[:, 0] == f, ef[:, 1], ef[:, 0]))

    def next_face(f, v):
        i = vnum(f, v)
        return other(f, feid[f, i])

    def prev_face(f, v):
        i = vnum(f, v)
        return other(f, feid[f, (i + 2) % 3])

    def next_vert(f, v):
        return faces[f, (vnum(f, v) + 1) % 3]

    def prev_vert(f, v):
        return faces[f, (vnum(f, v) + 2) % 3]

    used = np.nonzero(start >= 0)[0]
    boundary = np.zeros(n_verts, bool)
    # walk forward from the first face to find a boundary
    f = start[used].copy()
    walking = np.ones(used.size, bool)
    steps = np.zeros(used.size, np.int64)
    limit = n_faces_of[used] + 1
    while walking.any():
        w = np.nonzero(walking)[0]
        nf_ = next_face(f[w], used[w])
        open_ = nf_ == -1
        boundary[used[w[open_]]] = True
        walking[w[open_]] = False
        go = w[~open_]
        f[go] = nf_[~open_]
        steps[go] += 1
        walking[go] = ~((f[go] == start[used[go]]) | (steps[go] > limit[go]))
    max_k = int(n_faces_of.max(initial=0)) + 2
    ring = np.full((n_verts, max_k), -1, np.int64)
    count = np.zeros(n_verts, np.int64)

    def put(sel, vals):
        ring[sel, count[sel]] = vals
        count[sel] += 1

    inner = used[~boundary[used]]
    face = start[inner].copy()
    live = np.ones(inner.size, bool)
    while live.any():
        w = np.nonzero(live)[0]
        put(inner[w], next_vert(face[w], inner[w]))
        face[w] = next_face(face[w], inner[w])
        live[w] = face[w] != start[inner[w]]
    bsel = ~boundary[used]
    outer = used[~bsel]
    face = f[~bsel].copy()  # the last face forward
    put(outer, next_vert(face, outer))
    live = np.ones(outer.size, bool)
    while live.any():
        w = np.nonzero(live)[0]
        put(outer[w], prev_vert(face[w], outer[w]))
        face[w] = prev_face(face[w], outer[w])
        live[w] = face[w] != -1
    return ring, count, boundary, keys, efaces, feid


def _ring_sum(p, ring, k):
    """sum over the first k ring vertices of p, in ring order."""
    acc = p[ring[:, 0]]
    for j in range(1, k):
        acc = acc + p[ring[:, j]]
    return acc


def _by_valence(count, mask):
    for val in np.unique(count[mask]):
        yield int(val), np.nonzero(mask & (count == val))[0]


def _subdivide_once(faces, p):
    n_verts = p.shape[0]
    ring, count, boundary, keys, efaces, feid = _rings(faces, n_verts)
    # even vertices (loopsubdiv.cpp:243-252)
    new_even = p.copy()
    for val, vs in _by_valence(count, (count > 0) & ~boundary):
        b = 1.0 / 16.0 if val == 6 else _beta(val)
        new_even[vs] = (1 - val * b) * p[vs] + b * _ring_sum(p, ring[vs], val)
    vs = np.nonzero((count > 0) & boundary)[0]
    if vs.size:
        b = 1.0 / 8.0
        last = ring[vs, count[vs] - 1]
        new_even[vs] = (1 - 2 * b) * p[vs] + b * (p[ring[vs, 0]] + p[last])
    # odd (edge) vertices (loopsubdiv.cpp:255-286)
    a, b_ = keys[:, 0], keys[:, 1]
    f0, f1 = efaces[:, 0], efaces[:, 1]
    one = f1 < 0
    o0 = faces[f0].sum(1) - a - b_
    o1 = np.where(one, a, faces[np.maximum(f1, 0)].sum(1) - a - b_)
    odd = (3.0 / 8.0) * (p[a] + p[b_]) + (1.0 / 8.0) * (p[o0] + p[o1])
    odd[one] = 0.5 * (p[a[one]] + p[b_[one]])
    new_p = np.concatenate([new_even, odd])
    # new faces (loopsubdiv.cpp:317-330)
    e = feid + n_verts
    va, vb, vc = faces[:, 0], faces[:, 1], faces[:, 2]
    e0, e1, e2 = e[:, 0], e[:, 1], e[:, 2]
    new_faces = np.stack([np.stack([va, e0, e2], 1), np.stack([e0, vb, e1], 1),
                          np.stack([e2, e1, vc], 1), np.stack([e0, e1, e2], 1)],
                         1).reshape(-1, 3).astype(faces.dtype)
    return new_faces, new_p


def loop_subdivide(indices, p, n_levels: int):
    """(indices, limit positions, normals) of LoopSubdivide's mesh: int32,
    float32, float32 (normals unnormalised, loopsubdiv.cpp:378)."""
    faces = np.asarray(indices, np.int64).reshape(-1, 3)
    p = np.asarray(p, np.float64).reshape(-1, 3)
    for _ in range(max(n_levels, 0)):
        faces, p = _subdivide_once(faces, p)
    n_verts = p.shape[0]
    ring, count, boundary, *_ = _rings(faces, n_verts)
    # every vertex to the limit surface first (loopsubdiv.cpp:333-341)
    p_limit = p.copy()
    for val, vs in _by_valence(count, (count > 0) & ~boundary):
        g = 1.0 / (val + 3.0 / (8.0 * _beta(val)))
        p_limit[vs] = (1 - val * g) * p[vs] + g * _ring_sum(p, ring[vs], val)
    vs = np.nonzero((count > 0) & boundary)[0]
    if vs.size:
        b = 1.0 / 5.0
        last = ring[vs, count[vs] - 1]
        p_limit[vs] = (1 - 2 * b) * p[vs] + b * (p[ring[vs, 0]] + p[last])
    # then the tangents from the limit positions (loopsubdiv.cpp:344-378)
    normals = np.zeros_like(p)
    normals[count == 0] = (0, 0, 1)
    for val, vs in _by_valence(count, (count > 0) & ~boundary):
        j = np.arange(val)
        cs = np.cos(2 * np.pi * j / val)
        sn = np.sin(2 * np.pi * j / val)
        pr = p_limit[ring[vs, :val]]  # [n, val, 3]
        s = cs[0] * pr[:, 0]
        t = sn[0] * pr[:, 0]
        for k in range(1, val):
            s = s + cs[k] * pr[:, k]
            t = t + sn[k] * pr[:, k]
        normals[vs] = np.cross(s, t)
    for val, vs in _by_valence(count, (count > 0) & boundary):
        pr = p_limit[ring[vs, :val]]
        pv = p_limit[vs]
        s = pr[:, -1] - pr[:, 0]
        if val == 2:
            t = pr[:, 0] + pr[:, 1] - 2 * pv
        elif val == 3:
            t = pr[:, 1] - pv
        elif val == 4:
            t = -1 * pr[:, 0] + 2 * pr[:, 1] + 2 * pr[:, 2] - 1 * pr[:, 3] - 2 * pv
        else:
            theta = np.pi / (val - 1)
            t = np.sin(theta) * (pr[:, 0] + pr[:, -1])
            for k in range(1, val - 1):
                wt = (2 * np.cos(theta) - 2) * np.sin(k * theta)
                t = t + wt * pr[:, k]
            t = -t
        normals[vs] = np.cross(s, t)
    return faces.astype(np.int32), p_limit.astype(np.float32), normals.astype(np.float32)
