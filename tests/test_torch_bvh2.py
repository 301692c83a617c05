"""The binary-BVH traversal (ops/bvh.py: build_bvh2_table, bvh2_traverse,
bvh2_traverse_plain), whose plain PyTorch version stands in for the CUDA
kernel csrc/bvh2_traverse.cu on the CPU: against the JAX package's
watertight oracle, against the 4-wide traversal, against the Pallas binary
kernel it replaces (interpret mode), and the PBRT_TPU_BVH4=0 switch."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu_torch.accel import traverse as ttv
from pbrt_tpu_torch.ops import bvh as kb
from test_torch_scene import demo, soup
from test_torch_traverse import (assert_hits_agree, both, camera_rays,
                                 coherent_rays, jax_traverse, tri_scene)

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


def test_table_layout():
    """One 32-byte row per binary node: the bounds, the offset and the
    packed count and axis bit for bit; leaves cover every prim once."""
    _, ts = both(soup)
    rows = ts.bvh2_nodes.numpy()
    assert rows.shape == (ts.bvh_min.shape[0], 8) and rows.itemsize * 8 == kb.NODE2_BYTES
    np.testing.assert_array_equal(rows[:, 0:3], ts.bvh_min.numpy())
    np.testing.assert_array_equal(rows[:, 3:6], ts.bvh_max.numpy())
    ints = rows.view(np.int32)
    np.testing.assert_array_equal(ints[:, 6], ts.bvh_offset.numpy())
    np.testing.assert_array_equal(ints[:, 7] & 0xFFFF, ts.bvh_nprims.numpy())
    cnt = ints[:, 7] & 0xFFFF
    np.testing.assert_array_equal((ints[:, 7] >> 16)[cnt == 0],
                                  ts.bvh_axis.numpy()[cnt == 0])
    covered = np.concatenate([np.arange(o, o + c) for o, c in
                              zip(ints[cnt > 0, 6], cnt[cnt > 0])])
    np.testing.assert_array_equal(np.sort(covered), np.arange(ts.prim_meta.shape[0]))
    levels = kb.node_levels(ts.bvh_offset.numpy(), ts.bvh_nprims.numpy())
    assert ts.bvh2_depth == levels.max() and 1 <= ts.bvh2_depth <= kb.BVH2_STACK_SIZE


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
