"""The BVH kernels' work list (ops/bvh.py): the sort key that puts dead
lanes last, the `order` indirection of bvh4_traverse / bvh2_traverse and of
their plain versions, the traversal glue that hands the order to the kernel
against the JAX package, and the wrappers' refusal of a tree deeper than
their stacks.  On the CPU the wrappers run the plain versions, which apply
the order as a gather and a scatter, so a result never depends on it."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu.accel import traverse as jtv
from pbrt_tpu_torch.ops import bvh as kb
from test_torch_scene import demo, soup
from test_torch_traverse import assert_hits_agree, both, camera_rays, tri_scene
from jax_traversal_jit import jit_jax_traversal  # noqa: F401  (autouse)
import test_torch_threads  # noqa: F401  (torch's threads under xdist)

KERNELS = {
    "bvh4": (kb.bvh4_traverse, kb.bvh4_traverse_plain, "bvh4_nodes", "bvh4_depth"),
    "bvh2": (kb.bvh2_traverse, kb.bvh2_traverse_plain, "bvh2_nodes", "bvh2_depth"),
}


def lanes(n, seed, dead=0.3):
    """t_max with a share `dead` of dead lanes (0, and a few negative) and
    any-hit modes on ~1/3 of the lanes, from a numpy seed."""
    rs = np.random.RandomState(seed)
    t_max = np.where(rs.rand(n) < dead, 0.0, 1e30).astype(np.float32)
    if dead:
        t_max[:5] = -1.0
    mode = (rs.rand(n) < 0.33).astype(np.float32)
    return torch.as_tensor(t_max), torch.as_tensor(mode)


@pytest.mark.parametrize("dead", [0.3, 0.9, 0.0, 1.0])
def test_sort_key_puts_dead_lanes_last(dead):
    """A stable argsort lists every live lane before every dead one; within
    each group the lanes keep the order of the key of all-live lanes (the
    octant/Morton key), which the dead bit leaves as it was; with no dead
    lane, or no live one, the order is that of the all-live key."""
    _, ts = both(tri_scene)
    o, d = (torch.as_tensor(x) for x in camera_rays(3000, 21))
    t_max, _ = lanes(3000, 21, dead)
    lo, hi = ts.bvh_min[0], ts.bvh_max[0]
    key = kb.sort_rays_key(lo, hi, o, d, t_max)
    order = torch.argsort(key, stable=True)
    live = t_max > 0
    n_live = int(live.sum())
    assert n_live == {0.0: 3000, 1.0: 0}.get(dead, n_live)
    assert 0 < n_live < 3000 or dead in (0.0, 1.0)
    assert bool(live[order[:n_live]].all()) and not bool(live[order[n_live:]].any())
    all_live = kb.sort_rays_key(lo, hi, o, d, torch.full((3000,), 1e30))
    assert torch.equal(all_live, key & ~(1 << 30))
    before = torch.argsort(all_live, stable=True)
    assert torch.equal(order[:n_live], before[live[before]])
    assert torch.equal(order[n_live:], before[~live[before]])


@pytest.mark.parametrize("scene", [soup, tri_scene, demo],
                         ids=["soup", "tri_scene", "demo"])
@pytest.mark.parametrize("kind", list(KERNELS))
def test_order_changes_no_bit(kind, scene):
    """A random order, the identity, the glue's sorted order and None give
    the same (t, prim) bit for bit, dead and any-hit lanes included, through
    the wrapper (the plain version on the CPU, no launch counted) and the
    plain version's counts alike."""
    wrapper, plain, nodes_field, depth_field = KERNELS[kind]
    _, ts = both(scene)
    n = 1500
    o, d = (torch.as_tensor(x) for x in camera_rays(n, 22))
    t_max, mode = lanes(n, 22)
    nodes, depth = getattr(ts, nodes_field), getattr(ts, depth_field)
    args = (nodes, ts.prim_tris, o, d, t_max, mode)
    t_ref, p_ref, v_ref, x_ref = plain(*args, return_counts=True)
    assert bool((p_ref >= 0).any()) and bool((p_ref[t_max <= 0] == -1).all())
    orders = {
        "random": torch.as_tensor(np.random.RandomState(22).permutation(n).astype(np.int32)),
        "identity": torch.arange(n, dtype=torch.int32),
        "sorted": torch.argsort(kb.sort_rays_key(ts.bvh_min[0], ts.bvh_max[0],
                                                 o, d, t_max), stable=True).to(torch.int32),
        "none": None,
    }
    before = wrapper.launches
    for name, order in orders.items():
        t, p = wrapper(*args, depth, order)
        assert torch.equal(t, t_ref) and torch.equal(p, p_ref), name
        t, p, v, x = plain(*args, return_counts=True, order=order)
        assert torch.equal(t, t_ref) and torch.equal(p, p_ref), name
        assert torch.equal(v, v_ref) and torch.equal(x, x_ref), name
    assert wrapper.launches == before
    with pytest.raises(TypeError):
        wrapper(*args, depth, orders["random"].long())
    with pytest.raises(ValueError, match="shape"):
        wrapper(*args, depth, orders["random"][:-1])


@pytest.mark.parametrize("switch", ["1", "0"], ids=["bvh4", "bvh2"])
def test_glue_matches_jax_on_demo(switch, monkeypatch):
    """intersect_kernel_with_quadrics, which now hands the unsorted rays and
    the permutation to the kernel, against the JAX package's plain reference
    (the watertight traversal that its intersect_kernel_with_quadrics stands
    for on the CPU), per lane t_max with dead lanes, closest hit at the bars
    of tests/test_torch_traverse.py's kernel-path test, and the any-hit
    lanes' occlusion."""
    monkeypatch.setenv("PBRT_TPU_BVH4", switch)
    js, ts = both(demo)
    n = 3000
    o, d = camera_rays(n, 23)
    t_max, mode = lanes(n, 23)
    live = t_max.numpy() > 0
    mask = mode.numpy() > 0
    t_ref, p_ref = (np.asarray(x) for x in jtv._traverse(
        jtv._device_scene(js), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(t_max.numpy()), jtv.scene_quadric_types(js), False))
    t_got, p_got = kb.intersect_kernel_with_quadrics(
        ts, torch.as_tensor(o), torch.as_tensor(d), t_max)
    t_got, p_got = t_got.numpy(), p_got.numpy()
    assert (p_got[~live] == -1).all() and (p_ref[~live] == -1).all()
    np.testing.assert_array_equal(t_got[~live], t_max.numpy()[~live])
    assert_hits_agree(t_ref[live], p_ref[live], t_got[live], p_got[live], 0.99, 1e-3)
    assert (p_ref[live] >= 0).mean() > 0.2
    _, p_any = kb.intersect_kernel_with_quadrics(
        ts, torch.as_tensor(o), torch.as_tensor(d), t_max, any_mask=mode > 0)
    p_any = p_any.numpy()
    assert ((p_any >= 0) == (p_ref >= 0))[mask].mean() >= 0.99
    np.testing.assert_array_equal(p_any[~mask], p_got[~mask])


@pytest.mark.parametrize("kind", list(KERNELS))
def test_wrapper_refuses_a_tree_deeper_than_its_stack(kind):
    """A depth whose worst-case stack passes the kernel's entries is refused
    before anything runs, on the CPU as on the card."""
    wrapper, _, nodes_field, _ = KERNELS[kind]
    _, ts = both(tri_scene)
    o, d = (torch.as_tensor(x) for x in camera_rays(64, 24))
    args = (getattr(ts, nodes_field), ts.prim_tris, o, d,
            torch.full((64,), 1e30), torch.zeros(64))
    too_deep = {"bvh4": kb.STACK_SIZE // 3 + 1, "bvh2": kb.BVH2_STACK_SIZE + 1}[kind]
    with pytest.raises(ValueError, match="stack"):
        wrapper(*args, too_deep)
    wrapper(*args, too_deep - 1)
