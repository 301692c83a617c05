"""The binary-BVH traversal (ops/bvh.py: build_bvh2_table, bvh2_traverse,
bvh2_traverse_plain), whose plain PyTorch version stands in for the CUDA
kernel csrc/bvh2_traverse.cu on the CPU: its 64-byte rows (both children of
an interior node in one row) against the JAX package's tree, its results
against the one-row-per-node design it replaced (kept below as the
reference), against the JAX package's watertight oracle, against the 4-wide
traversal, against the Pallas binary kernel it replaces (interpret mode),
and the PBRT_TPU_BVH4=0 switch."""
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu_torch.accel import traverse as ttv
from pbrt_tpu_torch.ops import bvh as kb
from test_torch_scene import demo, soup
from test_torch_traverse import (assert_hits_agree, both, camera_rays,
                                 coherent_rays, jax_traverse, tri_scene)
from test_torch_trees import caterpillar_rays, caterpillar_tree
import test_torch_threads  # noqa: F401  (torch's threads under xdist)

SCENES = {"tri200": tri_scene, "demo": demo, "soup": soup}


def plain2(ts, o, d, t_max=1e30, mode=None, **kw):
    n = o.shape[0]
    return kb.bvh2_traverse_plain(
        ts.bvh2_nodes, ts.prim_tris, torch.as_tensor(o), torch.as_tensor(d),
        torch.full((n,), t_max), torch.zeros(n) if mode is None else mode, **kw)


def plain4(ts, o, d, mode=None):
    n = o.shape[0]
    return kb.bvh4_traverse_plain(
        ts.bvh4_nodes, ts.prim_tris, torch.as_tensor(o), torch.as_tensor(d),
        torch.full((n,), 1e30), torch.zeros(n) if mode is None else mode)


# ---------------------------------------------------------------------------
# The reference: the binary table and traversal of the previous design, one
# 32-byte row per node (pbrt's LinearBVHNode), copied as they were.  Each
# child was fetched before its box was tested; the new rows hold the boxes
# in the parent and must reach the same leaves in the same order.
# ---------------------------------------------------------------------------

def ref_build_bvh2_table(nodes_min, nodes_max, offset, n_prims, axis):
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
    return rows, int(kb.node_levels(offset, n_prims).max())


def ref_bvh2_traverse_plain(nodes, tris, o, d, t_max, mode, return_counts=False,
                            order=None):
    """The bvh2 kernel's function in plain PyTorch (pbrt-v3's
    BVHAccel::Intersect): one loop step visits one node per unfinished ray,
    slab-tests its box and, on a hit, tests a leaf's primitives or descends
    to the child nearer along the split axis by the ray's own direction
    sign, pushing the other.  order as for bvh4_traverse_plain.  Returns
    (t, prim) or, with return_counts, (t, prim, node_visits, prim_tests)."""
    if order is not None:
        return kb._in_order(ref_bvh2_traverse_plain, order, nodes, tris, o, d,
                            t_max, mode, return_counts)
    rows_f = nodes.view(-1, 8)
    rows_i = nodes.view(torch.int32).view(-1, 8)
    recs = tris.view(-1, 12)
    any_hit = mode > 0.0
    st = kb._start(o, d, t_max, kb.BVH2_STACK_SIZE)
    t_best, prim, inv, entry = st["t_best"], st["prim"], st["inv"], st["entry"]
    dir_is_neg = inv < 0.0
    while bool(st["active"].any()):
        idx = torch.nonzero(st["active"])[:, 0]
        node = entry[idx]
        st["node_visits"][idx] += 1
        rf = rows_f[node]
        ri = rows_i[node].to(torch.int64)
        hit, _ = kb._slab(rf[:, None, 0:6], o[idx], inv[idx], t_best[idx])
        hit = hit[:, 0]
        off = ri[:, 6]
        cnt = ri[:, 7] & 0xFFFF
        axis = (ri[:, 7] >> 16) & 3
        leaf = hit & (cnt > 0)
        inner = hit & (cnt == 0)
        finished = torch.zeros_like(hit)

        found = kb._leaf_tests(idx[leaf], off[leaf], cnt[leaf], recs, o, d,
                               any_hit, t_best, prim, st["prim_tests"])
        finished[leaf] = found

        ii = idx[inner]
        neg = dir_is_neg[ii, axis[inner]]
        first_child = node[inner] + 1
        second_child = off[inner]
        kb._push(st["stack"], st["sp"], ii,
                 torch.where(neg, first_child, second_child), kb.BVH2_STACK_SIZE)
        entry[ii] = torch.where(neg, second_child, first_child)
        kb._pop(st, idx, ~inner & ~finished, finished)
    return kb._result(st, return_counts)


@functools.cache
def case_tables(name):
    """(tree arrays, prim records, o, d) of one scene of the equality test."""
    if name == "caterpillar64":  # a tree at the stack's cap
        tree, recs = caterpillar_tree(kb.BVH2_STACK_SIZE)
        o, d = caterpillar_rays(1500, 9, "cpu")
        return tree, torch.as_tensor(recs), o, d
    _, ts = both(SCENES[name])
    tree = tuple(getattr(ts, f).numpy() for f in
                 ("bvh_min", "bvh_max", "bvh_offset", "bvh_nprims", "bvh_axis"))
    o, d = camera_rays(2000, 31)
    return tree, ts.prim_tris, o, d


@pytest.mark.parametrize("work", ["identity", "random-order"])
@pytest.mark.parametrize("lanes", ["closest", "any-hit-mask"])
@pytest.mark.parametrize("name", [*SCENES, "caterpillar64"])
def test_child_box_rows_equal_the_one_row_per_node_design(name, lanes, work):
    """The new rows and visit order against the reference above, bit for
    bit: t, prim and triangle tests on every lane (a fifth of them dead);
    a closest-hit lane fetches (old visits + 1) / 2 rows, since each entered
    node's two children were two fetches and are now one row."""
    tree, recs, o, d = case_tables(name)
    old, old_depth = ref_build_bvh2_table(*tree)
    new, new_depth = kb.build_bvh2_table(*tree)
    assert new_depth == old_depth
    n = o.shape[0]
    rs = np.random.RandomState(n)
    t_max = torch.full((n,), 1e30)
    t_max[::5] = 0.0
    mode = (torch.as_tensor(rs.rand(n) < 0.5).float() if lanes == "any-hit-mask"
            else torch.zeros(n))
    order = (torch.as_tensor(rs.permutation(n).astype(np.int32))
             if work == "random-order" else None)
    args = (torch.as_tensor(o), torch.as_tensor(d), t_max, mode)
    t_o, p_o, v_o, k_o = ref_bvh2_traverse_plain(torch.as_tensor(old), recs, *args,
                                                 return_counts=True, order=order)
    t_n, p_n, v_n, k_n = kb.bvh2_traverse_plain(torch.as_tensor(new), recs, *args,
                                                return_counts=True, order=order)
    assert torch.equal(t_n, t_o) and torch.equal(p_n, p_o)
    assert torch.equal(k_n, k_o)
    closest = (t_max > 0) & (mode == 0)
    assert torch.equal(2 * v_n[closest] - 1, v_o[closest])
    assert bool((v_n[t_max <= 0] == 0).all())
    assert (p_n >= 0).float().mean() > 0.2


def one_triangle(sc, tf):
    b = sc.SceneBuilder()
    m = b.add_material(sc.MAT_MATTE)
    b.add_triangle_mesh([[0, 1, 2]], [[0, 0, 0], [1, 0, 0], [0, 1, 0]], material=m)
    b.add_point_light(tf.translate(0, 0, 5), (1, 1, 1))
    return b


@pytest.mark.parametrize("name", [*SCENES, "one-triangle"])
def test_table_layout(name):
    """One 64-byte row per interior node plus the virtual row 0: each row's
    two child boxes are the JAX package's boxes of that node's children,
    bit for bit; interior children point at their rows, leaf children at
    their first primitive with their count; the split axis sits above child
    0's count; the leaves cover every prim once; the depth is the deepest
    node's level.  A root that is a leaf is row 0's child 0."""
    js, ts = both(one_triangle if name == "one-triangle" else SCENES[name])
    bmin, bmax = np.asarray(js.bvh_min), np.asarray(js.bvh_max)
    offset, nprims = np.asarray(js.bvh_offset), np.asarray(js.bvh_nprims)
    axis = np.asarray(js.bvh_axis)
    rows = ts.bvh2_nodes.numpy()
    inner = np.nonzero(nprims == 0)[0]
    assert rows.shape == (inner.size + 1, 16)
    assert rows.itemsize * 16 == kb.NODE2_BYTES
    ints = rows.view(np.int32)
    kids = np.stack([np.concatenate([[0], inner + 1]),
                     np.concatenate([[-1], offset[inner]])], 1)
    for k in (0, 1):
        c = kids[:, k]
        used = c >= 0
        np.testing.assert_array_equal(rows[used, 6 * k:6 * k + 3], bmin[c[used]])
        np.testing.assert_array_equal(rows[used, 6 * k + 3:6 * k + 6], bmax[c[used]])
        cnt = ints[:, 14 + k] & 0xFFFF if k == 0 else ints[:, 15]
        ref = ints[:, 12 + k]
        leaf = used & (nprims[np.maximum(c, 0)] > 0)
        np.testing.assert_array_equal(cnt[leaf], nprims[c[leaf]])
        np.testing.assert_array_equal(ref[leaf], offset[c[leaf]])
        mid = used & ~leaf
        assert bool((cnt[mid] == 0).all())
        np.testing.assert_array_equal(inner[ref[mid] - 1], c[mid])
    assert ints[0, 15] == -1  # row 0: the root and an empty child
    np.testing.assert_array_equal(ints[1:, 14] >> 16, axis[inner])
    assert (nprims[0] > 0) == (name == "one-triangle")
    leaf_refs = [(ints[:, 12 + k], ints[:, 14 + k] & (0xFFFF if k == 0 else -1))
                 for k in (0, 1)]
    covered = np.concatenate([np.arange(r, r + c) for refs, cnts in leaf_refs
                              for r, c in zip(refs, cnts) if c > 0])
    np.testing.assert_array_equal(np.sort(covered), np.arange(ts.prim_meta.shape[0]))
    levels = kb.node_levels(offset, nprims)
    assert ts.bvh2_depth == levels.max() and ts.bvh2_depth <= kb.BVH2_STACK_SIZE


@pytest.mark.parametrize("name", list(SCENES))
def test_plain_matches_bvh4_plain(name):
    """Same Moller-Trumbore test on the same records, another tree walk:
    hit flags equal, t equal wherever the prims agree, and the prims agree
    on all but ties (>= 99.9% of the hits)."""
    _, ts = both(SCENES[name])
    o, d = camera_rays(3000, 11)
    t2, p2 = plain2(ts, o, d)
    t4, p4 = plain4(ts, o, d)
    assert torch.equal(p2 >= 0, p4 >= 0)
    same = (p2 == p4) & (p2 >= 0)
    assert same.sum() >= 0.999 * (p2 >= 0).sum()
    assert torch.equal(t2[same], t4[same])
    assert (p2 >= 0).float().mean() > 0.2


@pytest.mark.parametrize("name", list(SCENES))
def test_plain_matches_jax_oracle(name):
    """Against the watertight oracle at the bars of
    tests/test_pallas_bvh.py:56-69 (Moller-Trumbore differs from the
    watertight test on grazing hits).  The brute-force quadric pass is not
    part of the kernel, so scenes with spheres go through
    intersect_kernel_with_quadrics."""
    js, ts = both(SCENES[name])
    o, d = camera_rays(3000, 12)
    t_ref, p_ref = jax_traverse(js, o, d)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PBRT_TPU_BVH4", "0")
        t_got, p_got = ttv.intersect_closest(ts, torch.as_tensor(o),
                                             torch.as_tensor(d), 1e30)
    assert_hits_agree(t_ref, p_ref, t_got.numpy(), p_got.numpy(), 0.99, 1e-3)


def test_any_hit_and_dead_lanes():
    """Any-hit lanes report the closest hit's occlusion and return -1e30;
    unflagged lanes are unchanged; t_max = 0 lanes exit at the root with no
    visit; the counts match the visits a lane makes."""
    _, ts = both(tri_scene, 200, 2)
    o, d = coherent_rays(4096, 5)
    n = o.shape[0]
    mask = torch.as_tensor(np.random.RandomState(5).rand(n) < 0.5)
    t_c, p_c = plain2(ts, o, d)
    t_m, p_m = plain2(ts, o, d, mode=mask.float())
    assert torch.equal((p_m >= 0)[mask], (p_c >= 0)[mask])
    assert torch.equal(p_m[~mask], p_c[~mask]) and torch.equal(t_m[~mask], t_c[~mask])
    assert bool((t_m[mask & (p_m >= 0)] == -1e30).all())
    t_max = torch.full((n,), 1e30)
    t_max[::2] = 0.0
    t, p, visits, tests = kb.bvh2_traverse_plain(
        ts.bvh2_nodes, ts.prim_tris, torch.as_tensor(o), torch.as_tensor(d),
        t_max, torch.zeros(n), return_counts=True)
    assert bool((p[::2] == -1).all()) and bool((t[::2] == 0.0).all())
    assert bool((visits[::2] == 0).all()) and bool((visits[1::2] >= 1).all())
    assert bool((tests[::2] == 0).all())
    assert torch.equal(p[1::2], p_c[1::2])


def test_wrapper_on_cpu_and_its_checks():
    """CPU tensors take the plain version and count no launch; bad inputs
    and a tree deeper than the stack raise."""
    _, ts = both(tri_scene)
    o, d = (torch.as_tensor(x) for x in coherent_rays(256, 6))
    t_max, mode = torch.full((256,), 1e30), torch.zeros(256)
    before = kb.bvh2_traverse.launches
    t, p = kb.bvh2_traverse(ts.bvh2_nodes, ts.prim_tris, o, d, t_max, mode,
                            ts.bvh2_depth)
    assert kb.bvh2_traverse.launches == before
    t_p, p_p = kb.bvh2_traverse_plain(ts.bvh2_nodes, ts.prim_tris, o, d, t_max, mode)
    assert torch.equal(t, t_p) and torch.equal(p, p_p)
    with pytest.raises(ValueError, match="shape"):
        kb.bvh2_traverse(ts.bvh4_nodes, ts.prim_tris, o, d, t_max, mode,
                         ts.bvh2_depth)
    with pytest.raises(TypeError):
        kb.bvh2_traverse(ts.bvh2_nodes, ts.prim_tris, o.double(), d, t_max,
                         mode, ts.bvh2_depth)
    with pytest.raises(ValueError, match="stack"):
        kb.bvh2_traverse(ts.bvh2_nodes, ts.prim_tris, o, d, t_max, mode,
                         kb.BVH2_STACK_SIZE + 1)


def test_switch_selects_the_binary_kernel(monkeypatch):
    """PBRT_TPU_BVH4=0, read at each call, routes intersect_closest through
    bvh2_traverse, with the results of the 4-wide path; the gate checks the
    selected tree's depth."""
    _, ts = both(demo)
    o, d = (torch.as_tensor(x) for x in camera_rays(2000, 13))
    calls = []
    orig2, orig4 = kb.bvh2_traverse, kb.bvh4_traverse
    monkeypatch.setattr(kb, "bvh2_traverse",
                        lambda *a: calls.append(2) or orig2(*a))
    monkeypatch.setattr(kb, "bvh4_traverse",
                        lambda *a: calls.append(4) or orig4(*a))
    t4, p4 = ttv.intersect_closest(ts, o, d, 1e30)
    monkeypatch.setenv("PBRT_TPU_BVH4", "0")
    t2, p2 = ttv.intersect_closest(ts, o, d, 1e30)
    assert calls == [4, 2]
    assert torch.equal(p2 >= 0, p4 >= 0)
    same = p2 == p4
    assert same.float().mean() >= 0.999 and torch.equal(t2[same], t4[same])
    assert kb.kernel_supported(ts)
    import dataclasses
    deep = dataclasses.replace(ts, bvh2_depth=kb.BVH2_STACK_SIZE + 1)
    assert not kb.kernel_supported(deep)
    monkeypatch.setenv("PBRT_TPU_BVH4", "1")
    assert kb.kernel_supported(deep)


@pytest.mark.slow
def test_plain_matches_pallas_binary_kernel_interpret():
    """The plain version against the Pallas kernel it replaces
    (pallas_bvh._run_packets, PBRT_TPU_BVH4=0's path), interpret mode, one
    4096-ray packet."""
    import pbrt_tpu.ops.pallas_bvh as pk

    js, ts = both(tri_scene)
    tables = pk.pack_scene_for_kernel(js)
    o, d = coherent_rays(pk.PACKET, 1)
    orig_call, orig_bvh4 = pk.pl.pallas_call, pk._USE_BVH4

    def interp_call(*args, **kw):
        kw["interpret"] = True
        return orig_call(*args, **kw)

    pk.pl.pallas_call = interp_call
    pk._USE_BVH4 = False
    try:
        t_ref, p_ref = pk.intersect_closest_packets(js, tables, jnp.asarray(o),
                                                    jnp.asarray(d), 1e30)
    finally:
        pk.pl.pallas_call = orig_call
        pk._USE_BVH4 = orig_bvh4
    t_got, p_got = plain2(ts, o, d)
    assert_hits_agree(np.asarray(t_ref), np.asarray(p_ref), t_got.numpy(),
                      p_got.numpy(), 0.999, 1e-5)
