"""The typed build of the bvh4 kernel (ops/bvh.py bvh4_traverse_typed) in
its plain version, on the CPU: bvh4_traverse_plain(typed=...) against the
port's watertight oracle accel/traverse._traverse on scenes with every
record type (more than 64 quadrics of all six types, curves of the three
types, instanced triangles, all at once), with closest and any-hit lanes,
dead lanes and a random work list; the gate and the route that picks the
build, also under PBRT_TPU_BVH4=0 (past the gate, or with a binary tree
deeper than the binary kernel's stack, the typed build).

The scenes here are made with the port's SceneBuilder alone (the module
imports neither JAX nor the JAX package), so tests/test_torch_cuda.py
holds the CUDA typed build against the same plain version on them.

Tolerances: the kernel's triangle test is Moller-Trumbore with the Pallas
kernel's constants, the oracle's is the watertight test, so t agrees to
rtol 1e-4 (tests/test_torch_traverse.py's bar) and the hit prims on at
least 99.9% of the lanes (an edge can fall either way); quadrics and
curves run the very same functions in both, so their t agree bit for bit
wherever the prims do."""
import numpy as np
import pytest
import torch

from pbrt_tpu_torch import scene as sc
from pbrt_tpu_torch.accel import traverse as ttv
from pbrt_tpu_torch.core import transform as tf
from pbrt_tpu_torch.ops import bvh as kb
import test_torch_threads  # noqa: F401  (torch's threads under xdist)


def _floor(b, m):
    b.add_triangle_mesh([0, 1, 2, 0, 2, 3],
                        [[-5, -5, -1], [5, -5, -1], [5, 5, -1], [-5, 5, -1]],
                        material=m)


def add_quadrics(b, m, n, seed):
    """n quadrics, the six types in turn, phi-clipped, with inner radii
    and reversed orientations among them, seeded placements."""
    rs = np.random.RandomState(seed)
    for i in range(n):
        t = (tf.translate(*(rs.randn(3) * 2)) @ tf.rotate(rs.uniform(0, 360), 1, 1, 0))
        rev = bool(i % 4 == 1)
        k = i % 6
        if k == 0:
            b.add_sphere(t, 0.3, material=m, phimax_deg=300, reverse_orientation=rev)
        elif k == 1:
            b.add_quadric(sc.SHAPE_CYLINDER, t, (0.2, -0.3, 0.3, np.deg2rad(330)),
                          m, -1, rev)
        elif k == 2:
            b.add_quadric(sc.SHAPE_DISK, t, (0.4, 0.1, 0.05, np.deg2rad(300)),
                          m, -1, rev)
        elif k == 3:
            b.add_cone(t, 0.3, 0.5, material=m, phimax_deg=320,
                       reverse_orientation=rev)
        elif k == 4:
            b.add_paraboloid(t, 0.3, 0.05, 0.4, material=m, reverse_orientation=rev)
        else:
            b.add_hyperboloid(t, (0.2, 0, -0.2), (0.3, 0.1, 0.25), material=m,
                              phimax_deg=340, reverse_orientation=rev)


def add_curves(b, m, n, seed):
    """n cubic curves, flat, ribbon and cylinder in turn, splitdepths 0-3."""
    rs = np.random.RandomState(seed)
    kinds = ("flat", "ribbon", "cylinder")
    for i in range(n):
        base = rs.randn(3) * 1.5
        cp = base + np.cumsum(rs.randn(4, 3) * 0.4 + [0, 0, 0.4], 0)
        kind = kinds[i % 3]
        b.add_curve(cp, 0.15, 0.05, kind, rs.randn(2, 3) if kind == "ribbon" else None,
                    tf.rotate(10 * i, 0, 0, 1), m, splitdepth=i % 4)


def add_instances(b, m, n, seed):
    """n instances of a 20-triangle template with normals and uv."""
    rs = np.random.RandomState(seed)
    b.begin_mesh_template()
    b.add_triangle_mesh(np.arange(60).reshape(-1, 3), rs.randn(60, 3) * 0.5,
                        n=rs.randn(60, 3), uv=rs.rand(60, 2), material=m)
    t = b.end_mesh_template()
    for i in range(n):
        b.add_mesh_instance(t, tf.translate(*(rs.randn(3) * 1.5))
                            @ tf.rotate(40 * i, 0, 1, 1) @ tf.scale(1, 1.5, 0.7))


def quadrics_scene(seed=0):
    b = sc.SceneBuilder()
    m = b.add_material(sc.MAT_MATTE)
    _floor(b, m)
    add_quadrics(b, m, 70, seed)
    return b


def curves_scene(seed=0):
    b = sc.SceneBuilder()
    m = b.add_material(sc.MAT_HAIR)
    _floor(b, m)
    add_curves(b, m, 30, seed)
    return b


def instances_scene(seed=0):
    b = sc.SceneBuilder()
    m = b.add_material(sc.MAT_MATTE)
    _floor(b, m)
    add_instances(b, m, 6, seed)
    return b


def mixed_scene(seed=0):
    b = instances_scene(seed)
    add_quadrics(b, 0, 12, seed + 1)
    add_curves(b, 0, 6, seed + 2)
    b.add_emissive_sphere(tf.translate(0, 0, 5), 0.5, L=(10.0, 10.0, 10.0))
    return b


SCENES = {"quadrics": quadrics_scene, "curves": curves_scene,
          "instances": instances_scene, "mixed": mixed_scene}


def typed_rays(n, seed, device="cpu"):
    """Half from above the scene toward it, half from inside it."""
    rs = np.random.RandomState(seed)
    o = np.tile(np.array([[0.0, -6.0, 4.0]]), (n, 1))
    o[n // 2:] = rs.randn(n - n // 2, 3) * 2
    d = rs.randn(n, 3) * 1.5 - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (torch.as_tensor(o.astype(np.float32), device=device),
            torch.as_tensor(d.astype(np.float32), device=device))


def lanes(n, seed, device="cpu"):
    """t_max with every 5th lane dead (0, a few negative), any-hit mode on
    every 3rd."""
    t_max = torch.full((n,), 1e30, device=device)
    t_max[::5] = 0.0
    t_max[::35] = -1.0
    mode = (torch.arange(n, device=device) % 3 == 0).float()
    return t_max, mode


@pytest.fixture(scope="module")
def scenes():
    return {k: make().build(device="cpu") for k, make in SCENES.items()}


@pytest.mark.parametrize("name", list(SCENES))
def test_typed_plain_matches_the_oracle(scenes, name):
    s = scenes[name]
    assert not kb.kernel_supported(s) and kb.traversal_route(s) == "typed"
    n = 600
    o, d = typed_rays(n, 3)
    t_max, mode = lanes(n, 4)
    order = torch.as_tensor(np.random.RandomState(5).permutation(n).astype(np.int32))
    t_c, p_c = kb.bvh4_traverse_plain(s.bvh4_nodes, s.prim_tris, o, d, t_max,
                                      torch.zeros(n), order=order,
                                      typed=kb.typed_tables(s))
    t_ref, p_ref = ttv._traverse(s, o, d, torch.clamp(t_max, min=0.0))
    live = t_max > 0
    t, p = t_c, p_c
    assert bool((p[~live] == -1).all()) and torch.equal(t[~live], t_max[~live])
    p, t, p_ref, t_ref = p[live], t[live], p_ref[live], t_ref[live]
    assert float((p == p_ref).float().mean()) >= 0.999
    same = (p == p_ref) & (p >= 0)
    types = s.prim_meta[p[same].long(), 0]
    torch.testing.assert_close(t[same], t_ref[same], rtol=1e-4, atol=0)
    other = (types != sc.SHAPE_TRIANGLE) & (types != sc.SHAPE_TRIANGLE_INST)
    assert torch.equal(t[same][other], t_ref[same][other])
    assert float((p >= 0).float().mean()) > 0.3
    hit_types = set(torch.unique(s.prim_meta[p[p >= 0].long(), 0]).tolist())
    want = {"quadrics": set(sc.QUADRIC_SHAPES), "curves": {sc.SHAPE_CURVE},
            "instances": {sc.SHAPE_TRIANGLE_INST}}.get(name, {
                sc.SHAPE_CURVE, sc.SHAPE_TRIANGLE_INST})
    assert want <= hit_types
    # any-hit lanes: the oracle's occlusion
    tm, pm = kb.bvh4_traverse_plain(s.bvh4_nodes, s.prim_tris, o, d, t_max, mode,
                                    typed=kb.typed_tables(s))
    a = (mode > 0) & live
    _, p_any = ttv._traverse(s, o, d, torch.clamp(t_max, min=0.0), any_hit=True)
    assert float(((pm[a] >= 0) == (p_any[a] >= 0)).float().mean()) >= 0.999
    assert bool((tm[a & (pm >= 0)] == -1e30).all())
    # unflagged lanes give the closest-hit run's bits under the mask
    b = ~(mode > 0)
    assert torch.equal(pm[b], p_c[b]) and torch.equal(tm[b], t_c[b])


@pytest.mark.parametrize("name", ["quadrics", "mixed"])
def test_typed_work_list_changes_no_bit(scenes, name):
    """Through the wrapper (the plain version on the CPU, no launch
    counted): a random order and the identity give the same bits, and the
    counts split by record type sum to the tests."""
    s = scenes[name]
    n = 400
    o, d = typed_rays(n, 6)
    t_max, mode = lanes(n, 7)
    order = torch.as_tensor(np.random.RandomState(8).permutation(n).astype(np.int32))
    before = kb.bvh4_traverse_typed.launches
    a = kb.bvh4_traverse_typed(s.bvh4_nodes, s.prim_tris, *kb.typed_tables(s), o, d,
                               t_max, mode, s.bvh4_depth, order)
    b = kb.bvh4_traverse_typed(s.bvh4_nodes, s.prim_tris, *kb.typed_tables(s), o, d,
                               t_max, mode, s.bvh4_depth)
    assert kb.bvh4_traverse_typed.launches == before
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    t, p, visits, tests = kb.bvh4_traverse_plain(
        s.bvh4_nodes, s.prim_tris, o, d, t_max, mode, return_counts=True,
        typed=kb.typed_tables(s))
    assert torch.equal(t, a[0]) and tests.shape == (n, 10)
    assert int(tests[:, sc.QUADRIC_SHAPES[0]:sc.QUADRIC_SHAPES[-1] + 1].sum()) > 0
    assert bool((tests[t_max <= 0] == 0).all()) and bool((visits[t_max <= 0] == 0).all())


def test_triangle_only_build_skips_typed_records(scenes):
    """The triangle-only plain version on a typed scene tests the triangles
    alone: its hits are the typed build's wherever that one hit a
    triangle nearer than every other record."""
    s = scenes["mixed"]
    n = 800
    o, d = typed_rays(n, 9)
    t_max = torch.full((n,), 1e30)
    t0, p0 = kb.bvh4_traverse_plain(s.bvh4_nodes, s.prim_tris, o, d, t_max,
                                    torch.zeros(n))
    assert bool((s.prim_meta[p0[p0 >= 0].long(), 0] == sc.SHAPE_TRIANGLE).all())
    t1, p1 = kb.bvh4_traverse_plain(s.bvh4_nodes, s.prim_tris, o, d, t_max,
                                    torch.zeros(n), typed=kb.typed_tables(s))
    tri = (p1 >= 0) & (s.prim_meta[p1.clamp(min=0).long(), 0] == sc.SHAPE_TRIANGLE)
    assert bool(tri.any()) and torch.equal(p0[tri], p1[tri])
    assert torch.equal(t0[tri], t1[tri])


def test_gate_and_route():
    """At most 64 quadrics, no curve and no instance: inside the gate (the
    triangle-only kernel and the quadric pass); a 65th quadric, a curve or
    an instance sends the scene to the typed build."""
    b = sc.SceneBuilder()
    m = b.add_material(sc.MAT_MATTE)
    _floor(b, m)
    add_quadrics(b, m, 64, 1)
    s = b.build(device="cpu")
    assert len(s.quadric_rows) == 64 and kb.kernel_supported(s)
    assert kb.traversal_route(s) == "kernel"
    add_quadrics(b, m, 1, 2)
    assert kb.traversal_route(b.build(device="cpu")) == "typed"
    for add in (add_curves, add_instances):
        b = sc.SceneBuilder()
        _floor(b, b.add_material(sc.MAT_MATTE))
        add(b, 0, 1, 3)
        s = b.build(device="cpu")
        assert not kb.kernel_supported(s) and kb.traversal_route(s) == "typed"


def test_bvh2_switch_refuses_scenes_past_the_gate(scenes, monkeypatch):
    """PBRT_TPU_BVH4=0 no longer refuses a scene past the gate: as the JAX
    package sends such a scene to its XLA loop under either value of the
    switch, the port sends it to the typed build of bvh4, with the default
    route's (t, prim) bit for bit, closest and any-hit lanes alike; a scene
    inside the gate still takes the binary kernel."""
    calls = spy_kernels(monkeypatch)
    o, d = typed_rays(256, 1)
    t_max, mode = lanes(256, 2)
    for name, s in scenes.items():
        monkeypatch.setenv("PBRT_TPU_BVH4", "1")
        want = ttv.intersect_closest(s, o, d, t_max, mode > 0)
        monkeypatch.setenv("PBRT_TPU_BVH4", "0")
        assert kb.traversal_route(s) == "typed", name
        got = ttv.intersect_closest(s, o, d, t_max, mode > 0)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), name
        assert bool((got[1] >= 0).any())
    assert calls == ["typed"] * 2 * len(scenes)
    inside = sc.SceneBuilder()
    _floor(inside, inside.add_material(sc.MAT_MATTE))
    add_quadrics(inside, 0, 6, 4)
    si = inside.build(device="cpu")
    assert kb.traversal_route(si) == "kernel"
    t, p = ttv.intersect_closest(si, o, d, 1e30)
    assert calls[-1] == "bvh2" and bool((p >= 0).any())


def spy_kernels(monkeypatch) -> list:
    """The kernels' wrappers that ops/bvh.py calls, named in call order."""
    calls = []
    for name, label in (("bvh4_traverse", "bvh4"), ("bvh2_traverse", "bvh2"),
                        ("bvh4_traverse_typed", "typed")):
        orig = getattr(kb, name)
        monkeypatch.setattr(kb, name, lambda *a, _o=orig, _l=label:
                            calls.append(_l) or _o(*a))
    return calls


def test_bvh2_switch_sends_a_deep_binary_tree_to_the_typed_build(monkeypatch):
    """Under PBRT_TPU_BVH4=0 a binary tree deeper than the binary kernel's
    stack (a caterpillar of 65 levels, tests/test_torch_trees.py, in a
    triangle scene's tables) is past the gate: it takes the typed build of
    bvh4, with the default route's (t, prim) bit for bit."""
    import dataclasses

    from test_torch_trees import caterpillar_rays, caterpillar_tree

    m = kb.BVH2_STACK_SIZE + 1
    tree, recs = caterpillar_tree(m)
    rows4, depth4 = kb.build_bvh4_table(*tree[:4])
    rows2, depth2 = kb.build_bvh2_table(*tree)
    b = sc.SceneBuilder()
    _floor(b, b.add_material(sc.MAT_MATTE))
    s = dataclasses.replace(
        b.build(device="cpu"), bvh_min=torch.as_tensor(tree[0]),
        bvh_max=torch.as_tensor(tree[1]), bvh4_nodes=torch.as_tensor(rows4),
        bvh2_nodes=torch.as_tensor(rows2), prim_tris=torch.as_tensor(recs),
        bvh4_depth=depth4, bvh2_depth=depth2)
    assert depth2 > kb.BVH2_STACK_SIZE and 3 * depth4 <= kb.STACK_SIZE
    calls = spy_kernels(monkeypatch)
    o, d = caterpillar_rays(512, 3, device="cpu")
    t_max, mode = lanes(512, 4)
    want = ttv.intersect_closest(s, o, d, t_max, mode > 0)
    monkeypatch.setenv("PBRT_TPU_BVH4", "0")
    assert not kb.kernel_supported(s) and kb.traversal_route(s) == "typed"
    got = ttv.intersect_closest(s, o, d, t_max, mode > 0)
    assert calls == ["bvh4", "typed"]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool((got[1] >= 0).any())
