"""Port traversal against the JAX package: the watertight oracle
(accel/traverse._traverse), the hit record, and the 4-wide BVH traversal
(ops/bvh.py) whose plain PyTorch version stands in for the CUDA kernel on the
CPU.  JAX runs on its CPU backend, so its intersect_closest is _traverse."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu import scene as jsc
from pbrt_tpu.accel import traverse as jtv
from pbrt_tpu.core import transform as jtf
from pbrt_tpu.shapes import triangle as jtri
from pbrt_tpu_torch import bridge
from pbrt_tpu_torch.accel import traverse as ttv
from pbrt_tpu_torch.ops import bvh as kb
from pbrt_tpu_torch.shapes import triangle as ttri
from test_torch_scene import demo, soup
import test_torch_threads  # noqa: F401  (torch's threads under xdist)


def tri_scene(sc, tf, n_tris=200, seed=0):
    """tests/test_pallas_bvh.py:_tri_scene."""
    rs = np.random.RandomState(seed)
    b = sc.SceneBuilder()
    m = b.add_material(sc.MAT_MATTE)
    c = rs.randn(n_tris, 1, 3) * 2.0
    v = c + rs.randn(n_tris, 3, 3) * 0.5
    b.add_triangle_mesh(np.arange(3 * n_tris).reshape(-1, 3), v.reshape(-1, 3),
                        material=m)
    b.add_point_light(tf.translate(0, 0, 5), (1, 1, 1))
    return b


def both(make, *args):
    """(JAX SceneArrays, the port's SceneArrays on the CPU via bridge)."""
    j = make(jsc, jtf, *args).build()
    return j, bridge.scene_from_numpy(bridge.as_numpy_fields(j), "cpu")


def coherent_rays(n, seed):
    """A pinhole cone down +z (tests/test_pallas_bvh.py:35-37)."""
    rs = np.random.RandomState(seed)
    o = np.tile(np.array([[0.0, 0.0, -8.0]], np.float32), (n, 1))
    d = np.array([[0, 0, 1]], np.float32) + rs.randn(n, 3).astype(np.float32) * 0.3
    return o, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def camera_rays(n, seed):
    """Rays from the demo camera's eye toward the scene, half of them
    starting inside it."""
    rs = np.random.RandomState(seed)
    o = np.tile(np.array([[0.0, -8.0, 4.0]], np.float32), (n, 1))
    o[n // 2:] = rs.randn(n - n // 2, 3) * 2 + np.array([0, 0, 3])
    d = (np.array([0.0, 0.0, 2.5]) + rs.randn(n, 3) * 2.5) - o
    return (o.astype(np.float32),
            (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32))


def jax_traverse(scene, o, d, any_mask=None):
    t, p = jtv._traverse(jtv._device_scene(scene), jnp.asarray(o), jnp.asarray(d), 1e30,
                         jtv.scene_quadric_types(scene), False,
                         None if any_mask is None else jnp.asarray(any_mask))
    return np.asarray(t), np.asarray(p)


def assert_hits_agree(t_ref, p_ref, t_got, p_got, frac, rtol):
    hit_ref, hit_got = p_ref >= 0, p_got >= 0
    assert (hit_ref == hit_got).mean() >= frac
    b = hit_ref & hit_got
    same = p_ref[b] == p_got[b]
    assert same.mean() >= frac
    np.testing.assert_allclose(t_got[b][same], t_ref[b][same], rtol=rtol)


@pytest.mark.parametrize("make", [demo, soup], ids=["demo", "soup"])
def test_oracle_matches_jax(make):
    """Against jitted JAX: XLA:CPU fuses and contracts the watertight test's
    multiply-adds, which moves t by a few ulps on ~1% of lanes (up to 3e-5
    relative where the edge functions cancel); the eager comparison below
    is bit for bit."""
    js, ts = both(make)
    o, d = camera_rays(2000, 1)
    t_ref, p_ref = jax_traverse(js, o, d)
    t_got, p_got = ttv._traverse(ts, torch.as_tensor(o), torch.as_tensor(d), 1e30)
    t_got = t_got.numpy()
    np.testing.assert_array_equal(p_got.numpy(), p_ref)
    assert np.isclose(t_got, t_ref, rtol=1e-6, atol=0).mean() >= 0.99
    np.testing.assert_allclose(t_got, t_ref, rtol=1e-4)
    assert (p_ref >= 0).mean() > 0.2


def test_oracle_bit_equal_to_eager_jax():
    """With jit disabled every JAX op rounds on its own, as torch's do: the
    oracle's (t, prim) are then bit-equal, spheres included."""
    js, ts = both(demo)
    o, d = camera_rays(500, 9)
    with jax.disable_jit():
        t_ref, p_ref = jax_traverse(js, o, d)
    t_got, p_got = ttv._traverse(ts, torch.as_tensor(o), torch.as_tensor(d), 1e30)
    np.testing.assert_array_equal(p_got.numpy(), p_ref)
    np.testing.assert_array_equal(t_got.numpy(), t_ref)


def test_watertight_triangle_bit_equal_to_eager_jax():
    rs = np.random.RandomState(0)
    n = 20000
    o = (rs.randn(n, 3) * 5).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    v = (rs.randn(n, 9) * 10 + np.tile(o + d * rs.rand(n, 1) * 20, 3)).astype(np.float32)
    args = [o, d, np.full(n, 1e30, np.float32), v[:, 0:3], v[:, 3:6], v[:, 6:9]]
    with jax.disable_jit():
        ref = jtri.intersect_triangle(*map(jnp.asarray, args))
    got = ttri.intersect_triangle(*map(torch.as_tensor, args))
    assert 0.05 < got["hit"].float().mean() < 0.95
    for k in ("hit", "t", "b0", "b1", "b2", "p_hit", "p_error"):
        np.testing.assert_array_equal(np.asarray(ref[k]), got[k].numpy(), err_msg=k)


@pytest.mark.parametrize("make", [demo, soup], ids=["demo", "soup"])
def test_hit_record_matches_jax(make):
    js, ts = both(make)
    o, d = camera_rays(2000, 2)
    t, p = jax_traverse(js, o, d)
    ref = jtv.hit_record(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t),
                         jnp.asarray(p), jtv.scene_quadric_types(js))
    got = ttv.hit_record(ts, torch.as_tensor(o), torch.as_tensor(d),
                         torch.as_tensor(t), torch.as_tensor(p))
    for k in ("hit", "prim_id", "material", "arealight"):
        np.testing.assert_array_equal(np.asarray(ref[k]), got[k].numpy(), err_msg=k)
    for k in ("p", "ng", "ns", "uv", "p_error", "dpdu", "dpdv", "ss", "wo"):
        np.testing.assert_allclose(np.asarray(ref[k]), got[k].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_bvh4_plain_matches_jax_oracle():
    """The kernel's CPU version against the watertight oracle, at the bars of
    tests/test_pallas_bvh.py:56-69."""
    js, ts = both(tri_scene)
    o, d = coherent_rays(4096, 1)
    t_ref, p_ref = jax_traverse(js, o, d)
    n = o.shape[0]
    t_got, p_got = kb.bvh4_traverse_plain(
        ts.bvh4_nodes, ts.prim_tris, torch.as_tensor(o), torch.as_tensor(d),
        torch.full((n,), 1e30), torch.zeros(n))
    assert_hits_agree(t_ref, p_ref, t_got.numpy(), p_got.numpy(), 0.99, 1e-3)
    assert (p_ref >= 0).mean() > 0.2


@pytest.mark.parametrize("make", [demo, soup], ids=["demo", "soup"])
def test_kernel_path_with_quadrics_matches_jax(make):
    """intersect_closest (sort, 4-wide traversal, scatter back, quadric
    pass) against the JAX oracle on scenes with spheres and emitters."""
    js, ts = both(make)
    o, d = camera_rays(3000, 3)
    t_ref, p_ref = jax_traverse(js, o, d)
    t_got, p_got = ttv.intersect_closest(ts, torch.as_tensor(o),
                                         torch.as_tensor(d), 1e30)
    assert_hits_agree(t_ref, p_ref, t_got.numpy(), p_got.numpy(), 0.99, 1e-3)


def test_any_mask_lanes():
    """tests/test_pallas_bvh.py:105-110: flagged lanes report the closest
    hit's occlusion; unflagged lanes are unchanged."""
    _, ts = both(tri_scene, 200, 2)
    o, d = (torch.as_tensor(x) for x in coherent_rays(4096, 5))
    n = o.shape[0]
    mask = torch.as_tensor(np.random.RandomState(5).rand(n) < 0.5)
    args = (ts.bvh4_nodes, ts.prim_tris, o, d, torch.full((n,), 1e30))
    t_c, p_c = kb.bvh4_traverse_plain(*args, torch.zeros(n))
    t_m, p_m = kb.bvh4_traverse_plain(*args, mask.float())
    assert torch.equal((p_m >= 0)[mask], (p_c >= 0)[mask])
    assert torch.equal(p_m[~mask], p_c[~mask])
    assert torch.equal(t_m[~mask], t_c[~mask])
    assert bool((t_m[mask & (p_m >= 0)] == -1e30).all())


def test_any_mask_matches_jax_oracle():
    js, ts = both(soup)
    o, d = camera_rays(2000, 4)
    mask = np.random.RandomState(4).rand(2000) < 0.5
    _, p_ref = jax_traverse(js, o, d, any_mask=mask)
    _, p_got = ttv.intersect_closest(ts, torch.as_tensor(o), torch.as_tensor(d),
                                     1e30, any_mask=torch.as_tensor(mask))
    p_got = p_got.numpy()
    assert ((p_ref >= 0) == (p_got >= 0))[mask].mean() >= 0.99


def test_dead_lanes_and_wrapper_on_cpu():
    """t_max = 0 lanes exit at the root; CPU tensors take the plain version
    and count no kernel launch; bad inputs raise."""
    _, ts = both(tri_scene)
    o, d = (torch.as_tensor(x) for x in coherent_rays(256, 6))
    t_max = torch.full((256,), 1e30)
    t_max[::2] = 0.0
    mode = torch.zeros(256)
    before = kb.bvh4_traverse.launches
    t, p = kb.bvh4_traverse(ts.bvh4_nodes, ts.prim_tris, o, d, t_max, mode,
                            ts.bvh4_depth)
    assert kb.bvh4_traverse.launches == before
    assert bool((p[::2] == -1).all()) and bool((t[::2] == 0.0).all())
    t_p, p_p, visits, tests = kb.bvh4_traverse_plain(
        ts.bvh4_nodes, ts.prim_tris, o, d, t_max, mode, return_counts=True)
    assert torch.equal(t, t_p) and torch.equal(p, p_p)
    assert bool((visits[::2] == 0).all()) and bool((visits[1::2] > 0).all())
    assert bool((tests[::2] == 0).all())
    with pytest.raises(TypeError):
        kb.bvh4_traverse(ts.bvh4_nodes, ts.prim_tris, o.double(), d, t_max, mode,
                         ts.bvh4_depth)
    with pytest.raises(ValueError):
        kb.bvh4_traverse(ts.bvh4_nodes, ts.prim_tris, o.t().contiguous().t(), d,
                         t_max, mode, ts.bvh4_depth)
    with pytest.raises(ValueError, match="stack"):
        kb.bvh4_traverse(ts.bvh4_nodes, ts.prim_tris, o, d, t_max, mode,
                         kb.STACK_SIZE)


def test_sort_changes_no_result():
    """The ray sort and scatter-back of intersect_kernel_with_quadrics give
    each ray the result of an unsorted traversal."""
    _, ts = both(tri_scene)
    o, d = (torch.as_tensor(x) for x in camera_rays(2000, 7))
    n = o.shape[0]
    key = kb.sort_rays_key(ts.bvh_min[0], ts.bvh_max[0], o, d,
                           torch.full((n,), 1e30))
    assert not bool((key[1:] >= key[:-1]).all())  # the sort reorders
    t, p = kb.intersect_kernel_with_quadrics(ts, o, d, 1e30)
    t_u, p_u = kb.bvh4_traverse_plain(ts.bvh4_nodes, ts.prim_tris, o, d,
                                      torch.full((n,), 1e30), torch.zeros(n))
    assert torch.equal(t, t_u) and torch.equal(p, p_u)


# two triangles in z = 0 sharing the edge (1, 0, 0)-(0, 1, 0)
TIE_TRIS = np.array([[0, 0, 0, 1, 0, 0, 0, 1, 0],
                     [1, 0, 0, 1, 1, 0, 0, 1, 0]], np.float32)


def tie_tables(tris, one_leaf):
    """bvh4 tables for `tris` (records in this order), every box the
    triangles' bounds grown by 1: one leaf holding them all, or (two
    triangles) each in a leaf of its own, side by side in one 4-wide node
    under the same box, so their t_near tie and the slot decides."""
    n = tris.shape[0]
    corners = tris.reshape(n, 3, 3)
    lo, hi = corners.min((0, 1)) - 1.0, corners.max((0, 1)) + 1.0
    if one_leaf:
        tree = ([lo], [hi], [0], [n])
    else:  # the root (its second child is node 2), then the two leaves
        tree = ([lo] * 3, [hi] * 3, [2, 0, 1], [0, 1, 1])
    rows, _ = kb.build_bvh4_table(*(np.array(x) for x in tree))
    recs = kb.build_prim_records(np.zeros(n), np.arange(n), tris)
    return torch.as_tensor(rows), torch.as_tensor(recs)


@pytest.mark.parametrize("one_leaf", [True, False], ids=["one-leaf", "two-leaves"])
def test_tie_goes_to_the_first_record_tested(one_leaf):
    """The contract the bvh4 kernel keeps with its plain version: a record
    is taken only at t < t_best, so when two triangles are hit at the same
    t (rays through their shared edge and their two shared vertices) the
    first record the visit order tests wins: in one leaf the lower index,
    across two leaves whose boxes tie in t_near the lower slot.  Either
    triangle alone is hit at that very t, and swapping the records swaps
    the winner."""
    o = torch.tensor([[0.5, 0.5, 2.0], [1.0, 0.0, 2.0], [0.0, 1.0, 2.0]])
    d = torch.tensor([[0.0, 0.0, -1.0]] * 3)
    t_max, mode = torch.full((3,), 1e30), torch.zeros(3)
    alone = [kb.bvh4_traverse_plain(*tie_tables(TIE_TRIS[k:k + 1], True), o, d,
                                    t_max, mode) for k in range(2)]
    assert all(bool((p == 0).all()) for _, p in alone)
    assert torch.equal(alone[0][0], alone[1][0])  # the same t: a tie
    for tris in (TIE_TRIS, TIE_TRIS[::-1].copy()):
        nodes, recs = tie_tables(tris, one_leaf)
        assert nodes.shape[0] == 1  # one 4-wide row: the leaf, or both leaves
        t, p = kb.bvh4_traverse_plain(nodes, recs, o, d, t_max, mode)
        assert bool((p == 0).all())
        assert torch.equal(t, alone[0][0])


@pytest.mark.slow
def test_bvh4_plain_matches_pallas_kernel_interpret():
    """The plain version against the Pallas kernel it replaces
    (pallas_bvh._run_packets4), interpret mode, one 4096-ray packet."""
    import pbrt_tpu.ops.pallas_bvh as pk

    assert pk._USE_BVH4
    js, ts = both(tri_scene)
    tables = pk.pack_scene_for_kernel(js)
    o, d = coherent_rays(pk.PACKET, 1)
    orig = pk.pl.pallas_call

    def interp_call(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    pk.pl.pallas_call = interp_call
    try:
        t_ref, p_ref = pk.intersect_closest_packets(js, tables, jnp.asarray(o),
                                                    jnp.asarray(d), 1e30)
    finally:
        pk.pl.pallas_call = orig
    n = o.shape[0]
    t_got, p_got = kb.bvh4_traverse_plain(
        ts.bvh4_nodes, ts.prim_tris, torch.as_tensor(o), torch.as_tensor(d),
        torch.full((n,), 1e30), torch.zeros(n))
    assert_hits_agree(np.asarray(t_ref), np.asarray(p_ref), t_got.numpy(),
                      p_got.numpy(), 0.999, 1e-5)
