"""The kernels on the card: bvh4_traverse and bvh2_traverse against their
plain PyTorch versions (bit for bit, under a random work list, all-dead
batches, and a tree at each kernel's stack cap; one deeper refused) and
against each other, the layout probe's Triton chain against its plain form
B (at its size and at a ragged one), the launch counts, a render on the
card against one on the CPU, the CLI on the card against a pbrt-v3
golden, a differentiable render step on the card against one on the
CPU and under each BVH kernel, and the config-3 file (textures, glass, the
infinite light), the direct-lighting integrator, the volumetric path
integrator on d_media_volpath, the Whitted and AO integrators, and the
breadth file (pbrt-v3's classic materials and lights) on the card against
the CPU (and under each BVH kernel), with their launch counts; each kernel
against its plain version on every batch of a volpath, a Whitted, an AO
and a breadth sample; and the metal, substrate, uber, translucent and mix
materials and the spot, distant, projection and goniometric lights on the
card against the CPU, lane by lane; and the advanced file (disney, hair,
fourier, subsurface and kdsubsurface) on the card against the CPU and
under each BVH kernel, with its launch count, and each kernel against its
plain version on every batch of an advanced sample (the NEE batch without
the extension ray, the probe walk's segments, the exit point's NEE, the
separate next-bounce launch); and the film under the gaussian and sinc
filters (repeats bit-identical, the card equal to the CPU) and the
orthographic, environment and realistic cameras' rays on the card against
the CPU; and the typed build of bvh4 against its plain version on scenes
with every record type (quadrics past the gate, curves, instances), under
a random work list and at the stack cap, PBRT_TPU_BVH4=0 past the gate
(the typed build, as with the switch unset), and small copies of chip_smoke.py's geometry and instances
files on the card against the CPU, with their launch counts and a grad
step; and bdpt, mlt and sppm on the card against the CPU, bdpt under each
BVH kernel, and each kernel against its plain version on every batch of a
bdpt sample and an sppm iteration; and the wavefront engine on the card
against the CPU under each BVH kernel, with each of its launches through
the kernel and its plain version, and the kd-tree on the card against
the CPU and the BVH.

These need a CUDA card and skip without one.  The file imports neither JAX
nor the JAX package, so on a machine without JAX it runs with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from pbrt_tpu_torch import cameras
from pbrt_tpu_torch import scene as sc
from pbrt_tpu_torch.core import transform as tf
from pbrt_tpu_torch.film import FilmConfig
from pbrt_tpu_torch.integrators import direct, path
from pbrt_tpu_torch.ops import bvh as kb
from pbrt_tpu_torch.parallel import diff
from pbrt_tpu_torch.samplers.samplers import SamplerConfig
from pbrt_tpu_torch.sceneio import parse_pbrt_file
from pbrt_tpu_torch.tools import bench_layout_probe as bp
from pbrt_tpu_torch.utils.imageio import read_pfm
from test_torch_trees import caterpillar_rays, caterpillar_tree
from chip_smoke import (bvh_switch, write_advanced_pbrt, write_breadth_pbrt,
                        write_config3_pbrt, write_geometry_pbrt,
                        write_instances_pbrt)
from test_torch_typed import SCENES as TYPED_SCENES
from test_torch_typed import lanes as typed_lanes
from test_torch_typed import typed_rays
import test_torch_threads  # noqa: F401  (torch's threads under xdist)

ROOT = pathlib.Path(__file__).resolve().parent.parent

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def card():
    """Decided per test, not at import, so every worker collects the same
    tests."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel needs a card")


def soup(n_tris, seed):
    rs = np.random.RandomState(seed)
    b = sc.SceneBuilder()
    m = b.add_material(sc.MAT_MATTE)
    c = rs.randn(n_tris, 1, 3) * 2.0
    v = c + rs.randn(n_tris, 3, 3) * 0.5
    b.add_triangle_mesh(np.arange(3 * n_tris).reshape(-1, 3), v.reshape(-1, 3),
                        material=m)
    b.add_sphere(tf.translate(0, 0, 1), 0.7, material=m)
    b.add_emissive_sphere(tf.translate(0, 3, 6), 0.5, L=(20.0, 20.0, 20.0),
                          material=m)
    return b


def rays(n, seed, device):
    rs = np.random.RandomState(seed)
    o = (rs.randn(n, 3) * 4).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.as_tensor(o, device=device), torch.as_tensor(d, device=device)


def random_order(n, seed):
    rs = np.random.RandomState(seed)
    return torch.as_tensor(rs.permutation(n).astype(np.int32), device="cuda")


def assert_bvh4_equals_plain(nodes, tris, o, d, t_max, mode, depth, order):
    args = (nodes, tris, o, d, t_max, mode)
    before = kb.bvh4_traverse.launches
    t_k, p_k = kb.bvh4_traverse(*args, depth, order)
    torch.cuda.synchronize()
    assert kb.bvh4_traverse.launches == before + 1
    t_p, p_p = kb.bvh4_traverse_plain(*args)
    assert torch.equal(p_k, p_p)
    assert torch.equal(t_k, t_p)
    return p_k


# (work list, dead lanes)
BVH4_CASES = {
    "identity": (None, "every 5th"),
    "random-order": ("random", "every 5th"),
    "all-dead": ("random", "all"),
}


@pytest.mark.parametrize("case", list(BVH4_CASES))
@pytest.mark.parametrize("n", [1, 127, 128, 8193])
def test_kernel_equals_plain(n, case):
    work, dead = BVH4_CASES[case]
    s = soup(2000, 3).build(device="cuda")
    o, d = rays(n, n, "cuda")
    t_max = torch.full((n,), 1e30, device="cuda")
    if dead == "all":
        t_max[:] = 0.0
        t_max[::7] = -1.0
    else:
        t_max[::5] = 0.0
    mode = (torch.arange(n, device="cuda") % 3 == 0).float()
    order = random_order(n, n) if work == "random" else None
    p = assert_bvh4_equals_plain(s.bvh4_nodes, s.prim_tris, o, d, t_max, mode,
                                 s.bvh4_depth, order)
    if dead == "all":
        assert bool((p == -1).all())


def caterpillar(m):
    """caterpillar_tree(m) on the card: {kind: (nodes, depth)} and the
    triangle records; build_bvh4_table makes a 4-wide tree of (m - 1) // 2
    + 1 levels, build_bvh2_table a binary one of depth m."""
    tree, recs = caterpillar_tree(m)
    rows4, depth4 = kb.build_bvh4_table(*tree[:4])
    rows2, depth2 = kb.build_bvh2_table(*tree)
    tables = {"bvh4": (torch.as_tensor(rows4, device="cuda"), depth4),
              "bvh2": (torch.as_tensor(rows2, device="cuda"), depth2)}
    return tables, torch.as_tensor(recs, device="cuda")


# kind: (caterpillar length, the stack entries its deepest walk needs)
STACK_CAP = {"bvh4": (84, lambda depth: 3 * depth), "bvh2": (64, lambda depth: depth)}


@pytest.mark.parametrize("work", ["identity", "random-order"])
@pytest.mark.parametrize("kind", list(STACK_CAP))
def test_kernel_equals_plain_at_the_stack_cap(kind, work):
    """A tree at the kernel's stack cap: bvh4 within 3 of its 128 entries,
    bvh2 at its 64 (binary depth 64); the kernel equals its plain version
    bit for bit."""
    m, need = STACK_CAP[kind]
    tables, tris = caterpillar(m)
    nodes, depth = tables[kind]
    cap = {"bvh4": kb.STACK_SIZE, "bvh2": kb.BVH2_STACK_SIZE}[kind]
    assert cap - 3 < need(depth) <= cap
    n = 4099
    o, d = caterpillar_rays(n, 7)
    t_max = torch.full((n,), 1e30, device="cuda")
    t_max[::11] = 0.0
    mode = (torch.arange(n, device="cuda") % 4 == 0).float()
    order = random_order(n, 8) if work == "random-order" else None
    if kind == "bvh4":
        p = assert_bvh4_equals_plain(nodes, tris, o, d, t_max, mode, depth, order)
    else:
        before = kb.bvh2_traverse.launches
        t_k, p = kb.bvh2_traverse(nodes, tris, o, d, t_max, mode, depth, order)
        torch.cuda.synchronize()
        assert kb.bvh2_traverse.launches == before + 1
        t_p, p_p = kb.bvh2_traverse_plain(nodes, tris, o, d, t_max, mode)
        assert torch.equal(p, p_p) and torch.equal(t_k, t_p)
    assert float((p >= 0).float().mean()) > 0.5


def tie_grid(g):
    """A g x g grid of unit cells in z = 0, two triangles a cell, and an
    instanced copy of it beside it (x + g + 1, type-8 records): integer
    vertices, so a ray in a dyadic direction through a vertex or an edge
    meets every triangle there at exactly the same t, and the visit order
    alone decides its prim."""
    b = sc.SceneBuilder()
    m = b.add_material(sc.MAT_MATTE)
    i, j = np.meshgrid(np.arange(g + 1), np.arange(g + 1), indexing="ij")
    v = np.stack([i.ravel(), j.ravel(), np.zeros(i.size)], 1).astype(np.float32)
    a = (np.arange(g)[:, None] * (g + 1) + np.arange(g)[None, :]).ravel()
    idx = np.concatenate([np.stack([a, a + g + 1, a + g + 2], 1),
                          np.stack([a, a + g + 2, a + 1], 1)])
    b.add_triangle_mesh(idx, v, material=m)
    b.begin_mesh_template()
    b.add_triangle_mesh(idx, v, material=m)
    b.add_mesh_instance(b.end_mesh_template(), tf.translate(g + 1, 0, 0))
    b.add_point_light(tf.translate(0, 0, 5), (1, 1, 1))
    return b


def tie_rays(n, g, seed, device="cuda"):
    """Rays through the tie grid's vertices (lane % 4 == 0), the midpoints
    of its axis edges (1) and of its diagonals (2) from z = 3, in directions
    whose components are 0 or +-1/16, 1/8, 1/4 (every product in the
    triangle and slab tests exact); lane % 4 == 3 a random ray."""
    rs = np.random.RandomState(seed)
    kind = np.arange(n) % 4
    x = rs.randint(0, 2 * g + 2, n).astype(np.float64)
    y = rs.randint(0, g + 1, n).astype(np.float64)
    x[kind == 1] += 0.5
    x[kind == 2] += 0.5
    y[kind == 2] += 0.5
    steps = np.array([-0.25, -0.125, -0.0625, 0.0, 0.0625, 0.125, 0.25])
    d = np.stack([rs.choice(steps, n), rs.choice(steps, n), -np.ones(n)], 1)
    o = np.stack([x, y, np.zeros(n)], 1) - 3.0 * d
    r = kind == 3
    o[r] = rs.randn(r.sum(), 3) * g / 2 + [g, g / 2, 4]
    dr = rs.randn(r.sum(), 3)
    dr[:, 2] = -np.abs(dr[:, 2]) - 0.2
    d[r] = dr / np.linalg.norm(dr, axis=1, keepdims=True)
    return (torch.as_tensor(o.astype(np.float32), device=device),
            torch.as_tensor(d.astype(np.float32), device=device))


def tied_share(s, o, d, lanes=2048):
    """Of the first `lanes` rays aimed at the grid (lane % 4 != 3), the
    share that meets two or more of its triangles (type 0) at their nearest
    t: brute force over every record with the kernel's triangle test."""
    rec = s.prim_tris[s.prim_tris[:, 3] == 0]
    o, d = o[:4 * lanes][torch.arange(4 * lanes, device=o.device) % 4 != 3][:lanes], \
        d[:4 * lanes][torch.arange(4 * lanes, device=d.device) % 4 != 3][:lanes]
    L, P = o.shape[0], rec.shape[0]
    hit, t = kb.moller_trumbore(o[:, None].expand(L, P, 3).reshape(-1, 3),
                                d[:, None].expand(L, P, 3).reshape(-1, 3),
                                rec[None, :, 0:3].expand(L, P, 3).reshape(-1, 3),
                                rec[None, :, 4:7].expand(L, P, 3).reshape(-1, 3),
                                rec[None, :, 8:11].expand(L, P, 3).reshape(-1, 3),
                                torch.full((L * P,), 1e30, device=o.device))
    t = torch.where(hit, t, torch.inf).view(L, P)
    near = t.min(1, keepdim=True).values
    return float(((t == near) & torch.isfinite(near)).sum(1).ge(2).float().mean())


@pytest.mark.parametrize("build", ["triangles", "typed"])
@pytest.mark.parametrize("n", [1, 31, 128, 8193, 200_000])
def test_kernel_equals_plain_on_ties(n, build):
    """Rays through a mesh's shared vertices and edges, where the order of
    the visits decides prim (tests/test_torch_traverse.py pins that
    contract on the CPU): closest-hit and any-hit lanes, dead lanes, a
    random work list, from one lane to past one wave of the card (200,000
    lanes are 1,563 blocks of 128); the triangle-only build (the instanced
    copy skipped) and the typed build (its type-8 records tested), each
    bit for bit its plain version."""
    g = 24
    s = tie_grid(g).build(device="cuda")
    o, d = tie_rays(n, g, 21)
    t_max, mode = typed_lanes(n, 22, "cuda")
    order = random_order(n, 23)
    if n >= 8193:
        assert tied_share(s, o, d) > 0.3
    typed = kb.typed_tables(s) if build == "typed" else None
    wrapper = kb.bvh4_traverse_typed if typed else kb.bvh4_traverse
    before = wrapper.launches
    for m in (torch.zeros(n, device="cuda"), mode):
        args = (s.bvh4_nodes, s.prim_tris, *(typed or ()), o, d, t_max, m)
        t_k, p_k = wrapper(*args, s.bvh4_depth, order)
        torch.cuda.synchronize()
        t_p, p_p = kb.bvh4_traverse_plain(s.bvh4_nodes, s.prim_tris, o, d, t_max, m,
                                          order=order, typed=typed)
        assert torch.equal(p_k, p_p)
        assert torch.equal(t_k, t_p)
    assert wrapper.launches == before + 2
    if n >= 128:
        assert float((p_k >= 0).float().mean()) > 0.2


@pytest.mark.parametrize("n", [1, 31, 128, 8193, 200_000])
def test_typed_kernel_equals_plain_at_sizes(n):
    """The typed build on the scene with every record type, from one lane
    to past one wave, a random work list, closest-hit and any-hit lanes and
    dead lanes: bit for bit its plain version."""
    s = TYPED_SCENES["mixed"]().build(device="cuda")
    o, d = typed_rays(n, 31, "cuda")
    t_max, mode = typed_lanes(n, 32, "cuda")
    order = random_order(n, 33)
    tables = kb.typed_tables(s)
    for m in (torch.zeros(n, device="cuda"), mode):
        t_k, p_k = kb.bvh4_traverse_typed(s.bvh4_nodes, s.prim_tris, *tables, o, d,
                                          t_max, m, s.bvh4_depth, order)
        torch.cuda.synchronize()
        t_p, p_p = kb.bvh4_traverse_plain(s.bvh4_nodes, s.prim_tris, o, d, t_max, m,
                                          order=order, typed=tables)
        assert torch.equal(p_k, p_p)
        assert torch.equal(t_k, t_p)


def test_bvh2_refuses_a_tree_deeper_than_its_stack():
    """Binary depth 65 needs 65 entries of the kernel's 64: refused before
    any launch."""
    tables, tris = caterpillar(kb.BVH2_STACK_SIZE + 1)
    nodes, depth = tables["bvh2"]
    assert depth == kb.BVH2_STACK_SIZE + 1
    o, d = caterpillar_rays(64, 3)
    before = kb.bvh2_traverse.launches
    with pytest.raises(ValueError, match="stack"):
        kb.bvh2_traverse(nodes, tris, o, d, torch.full((64,), 1e30, device="cuda"),
                         torch.zeros(64, device="cuda"), depth)
    assert kb.bvh2_traverse.launches == before


def test_wrapper_refuses_mixed_devices():
    s = soup(50, 1).build(device="cuda")
    o, d = rays(64, 0, "cpu")
    with pytest.raises(ValueError, match="devices"):
        kb.bvh4_traverse(s.bvh4_nodes, s.prim_tris, o, d, torch.full((64,), 1e30),
                         torch.zeros(64), s.bvh4_depth)


def test_render_on_card_matches_cpu():
    fields = soup(300, 2).build_numpy()
    res = (24, 24)
    cam = cameras.make_perspective_camera(
        tf.look_at([0, -8, 4], [0, 0, 1], [0, 0, 1]), res, fov_deg=45.0)
    kw = dict(film_cfg=FilmConfig(full_resolution=res),
              sampler_cfg=SamplerConfig("sobol", 2, res),
              cfg=path.PathConfig(max_depth=1))
    kb.bvh4_traverse.launches = 0
    a = path.render(sc.SceneArrays.from_numpy(fields, "cuda"), cam, **kw)
    assert kb.bvh4_traverse.launches == 2 * (1 + 1)
    b = path.render(sc.SceneArrays.from_numpy(fields, "cpu"), cam, device="cpu", **kw)
    rel = (a.cpu() - b).abs() / b.abs().clamp(min=1e-2)
    assert (rel <= 1e-3).all(-1).float().mean() >= 0.995


@pytest.mark.parametrize("work", ["identity", "random-order"])
@pytest.mark.parametrize("n", [1, 127, 128, 8193])
def test_bvh2_kernel_equals_plain_and_agrees_with_bvh4(n, work):
    s = soup(2000, 4).build(device="cuda")
    o, d = rays(n, n + 1, "cuda")
    t_max = torch.full((n,), 1e30, device="cuda")
    t_max[::5] = 0.0
    mode = (torch.arange(n, device="cuda") % 3 == 0).float()
    args = (s.bvh2_nodes, s.prim_tris, o, d, t_max, mode)
    order = random_order(n, n + 1) if work == "random-order" else None
    before = kb.bvh2_traverse.launches
    t_k, p_k = kb.bvh2_traverse(*args, s.bvh2_depth, order)
    assert kb.bvh2_traverse.launches == before + 1
    t_p, p_p = kb.bvh2_traverse_plain(*args)
    assert torch.equal(p_k, p_p) and torch.equal(t_k, t_p)
    zeros = torch.zeros(n, device="cuda")
    t2, p2 = kb.bvh2_traverse(*args[:5], zeros, s.bvh2_depth)
    t4, p4 = kb.bvh4_traverse(s.bvh4_nodes, s.prim_tris, o, d, t_max, zeros,
                              s.bvh4_depth)
    assert torch.equal(p2 >= 0, p4 >= 0)
    same = p2 == p4
    assert same.float().mean() >= 0.999 and torch.equal(t2[same], t4[same])
    any_lane = mode > 0
    assert torch.equal((p_k >= 0)[any_lane], (p4 >= 0)[any_lane])


@pytest.mark.parametrize("n", [bp.N, bp.N + 3 * bp.BLOCK // 2 + 7])
def test_chain_fused_matches_form_b(n):
    """The Triton chain against form B at the probe's size and at a ragged
    size (not a multiple of BLOCK): 1e-5 relative (plus 1e-6 absolute) on
    >= 99.9% of elements."""
    assert (n % bp.BLOCK == 0) == (n == bp.N)
    p, d, ns, t = bp.inputs(n, "cuda")
    pT, dT, nsT = (x.t().contiguous() for x in (p, d, ns))
    before = bp.chain_fused.launches
    got = bp.chain_fused(pT, dT, nsT, t)
    assert bp.chain_fused.launches == before + 1
    ref = bp.chain_planar(pT, dT, nsT, t)
    for g, r in zip(got, ref):
        ok = (g - r).abs() <= 1e-5 * r.abs() + 1e-6
        assert ok.float().mean() >= 0.999


def test_chain_fused_counts_graph_replays_not_captures():
    """chain_fused.launches counts the chain kernels the card ran: one an
    eager call, none for a call captured into a CUDA graph, and one for each
    captured call at each replay (device_ms: a warm-up call, two replays)."""
    p, d, ns, t = bp.inputs(4096, "cuda")
    args = tuple(x.t().contiguous() for x in (p, d, ns)) + (t,)
    before = bp.chain_fused.launches
    bp.device_ms(bp.chain_fused, [args], reps=5)
    assert bp.chain_fused.launches == before + 1 + 2 * 5


def test_cli_on_card_matches_golden(tmp_path):
    """python -m pbrt_tpu_torch on a_floor_point, on the card by default, at
    tests/test_parity_images.py:36's bars."""
    out = tmp_path / "a.pfm"
    r = subprocess.run([sys.executable, "-m", "pbrt_tpu_torch",
                        str(ROOT / "refgold/parity/a_floor_point.pbrt"), "-o",
                        str(out)], cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr
    ref = read_pfm(str(ROOT / "refgold/goldens/parity/a_floor_point.pfm"))
    got = read_pfm(str(out))
    rel = np.abs(ref - got) / np.maximum(np.abs(ref), 1e-2)
    assert np.all(rel <= 1e-3, -1).mean() >= 0.995
    assert abs(got.mean() - ref.mean()) / ref.mean() <= 5e-3


def demo():
    """__graft_entry__._demo_scene, call for call."""
    b = sc.SceneBuilder()
    matte = b.add_material(sc.MAT_MATTE, kd=(0.5, 0.5, 0.8))
    plastic = b.add_material(sc.MAT_PLASTIC, kd=(0.4, 0.2, 0.2),
                             ks=(0.5, 0.5, 0.5), roughness=0.025)
    b.add_triangle_mesh([[0, 1, 2], [2, 3, 0]],
                        [[-10, -10, 0], [10, -10, 0], [10, 10, 0], [-10, 10, 0]],
                        material=matte)
    rs = np.random.RandomState(0)
    c = rs.randn(64, 1, 3) * 1.5 + np.array([0, 0, 3.0])
    v = c + rs.randn(64, 3, 3) * 0.4
    b.add_triangle_mesh(np.arange(192).reshape(-1, 3), v.reshape(-1, 3),
                        material=plastic)
    b.add_sphere(tf.translate(2, 0, 2), 0.8, material=plastic)
    b.add_emissive_sphere(tf.translate(0, 5, 8), 0.5, L=(40.0, 40.0, 40.0),
                          material=matte)
    return b


def grad_step(device, remat=True, res=(24, 24), depth=3):
    """A grad step on the demo scene (halton, seeded weights) on `device`:
    (L, the gradient leaves as a flat dict of CPU tensors)."""
    scene = sc.SceneArrays.from_numpy(demo().build_numpy(), device)
    cam = cameras.make_perspective_camera(
        tf.look_at([0, -8, 4], [0, 0, 2], [0, 0, 1]), res, fov_deg=45.0)
    pixels = torch.as_tensor(path.make_pixel_grid(FilmConfig(full_resolution=res)),
                             device=device)
    w = torch.as_tensor(np.random.RandomState(7).uniform(
        0.5, 1.5, (pixels.shape[0], 3)).astype(np.float32), device=device)
    L, g = diff.render_grad_step(scene, cam, pixels, 0, w,
                                 SamplerConfig("halton", 1, res),
                                 path.PathConfig(max_depth=depth), remat=remat,
                                 device=device)
    cam_g = g.pop("camera")
    g.update({f"camera.{k}": v for k, v in cam_g.items()})
    return L.cpu(), {k: v.cpu() for k, v in g.items()}


def assert_leaves_close(got, ref, rtol):
    """Each leaf within rtol of the reference leaf's largest entry."""
    for k, r in ref.items():
        assert torch.isfinite(got[k]).all(), k
        bar = rtol * float(r.abs().max()) + 1e-6
        assert float((got[k] - r).abs().max()) <= bar, k


def test_grad_step_on_card_matches_cpu():
    L_c, g_c = grad_step("cuda")
    L_h, g_h = grad_step("cpu")
    rel = (L_c - L_h).abs() / L_h.abs().clamp(min=1e-2)
    assert (rel <= 1e-3).all(-1).float().mean() >= 0.995
    assert_leaves_close(g_c, g_h, 1e-3)
    assert float(g_c["kd"].abs().sum()) > 0


def launched_step(monkeypatch, switch, remat):
    """grad_step at depth 5 under PBRT_TPU_BVH4=switch, with the launches
    of each kernel it made."""
    monkeypatch.setenv("PBRT_TPU_BVH4", switch)
    kb.bvh4_traverse.launches = kb.bvh2_traverse.launches = 0
    _, g = grad_step("cuda", remat=remat, depth=5)
    return g, (kb.bvh4_traverse.launches, kb.bvh2_traverse.launches)


def test_grad_step_launches(monkeypatch):
    """A remat step launches the kernel 1 + depth times forward and depth
    times more in the replayed bounces; without remat 1 + depth."""
    g_on, n_on = launched_step(monkeypatch, "1", True)
    g_off, n_off = launched_step(monkeypatch, "1", False)
    assert n_on == (11, 0) and n_off == (6, 0)
    assert launched_step(monkeypatch, "0", True)[1] == (0, 11)
    assert_leaves_close(g_off, g_on, 1e-4)


def test_grad_step_bvh2_matches_bvh4(monkeypatch):
    g4, _ = launched_step(monkeypatch, "1", True)
    g2, _ = launched_step(monkeypatch, "0", True)
    assert_leaves_close(g2, g4, 1e-4)


def assert_image_bars(got, ref):
    """tests/test_torch_path.py:58-59's bars."""
    rel = (got - ref).abs() / ref.abs().clamp(min=1e-2)
    assert (rel <= 1e-3).all(-1).float().mean() >= 0.995
    assert abs(float(got.mean()) - float(ref.mean())) <= 5e-3 * float(ref.mean())


def config3_render(tmp_path, device, switch="1"):
    """The small config-3 file (tests/test_torch_config3.py's) rendered on
    `device` under PBRT_TPU_BVH4=switch: (image, bvh4 and bvh2 launches)."""
    from pbrt_tpu_torch.render import render_file

    p = write_config3_pbrt(tmp_path, res=(32, 32), spp=2, blob=(64, 32),
                           skin=(64, 64), env=(32, 16))
    kb.bvh4_traverse.launches = kb.bvh2_traverse.launches = 0
    with bvh_switch(switch):
        img, _ = render_file(str(p), out=str(tmp_path / f"{device}.pfm"),
                             device=device)
    return (torch.as_tensor(img),
            (kb.bvh4_traverse.launches, kb.bvh2_traverse.launches))


def test_config3_on_card_matches_cpu_and_bvh2(tmp_path):
    card, n4 = config3_render(tmp_path, "cuda")
    assert n4 == (2 * (1 + 5), 0)
    cpu, _ = config3_render(tmp_path, "cpu")
    assert torch.isfinite(card).all() and float(card.mean()) > 0
    assert_image_bars(card, cpu)
    card2, n2 = config3_render(tmp_path, "cuda", "0")
    assert n2 == (0, 2 * (1 + 5))
    assert_image_bars(card2, card)
    assert torch.equal(config3_render(tmp_path, "cuda")[0], card)


def two_lights():
    """A matte floor, a glass sphere, and two area lights of nsamples 1 and
    2 (tests/test_torch_direct.py's scene)."""
    b = sc.SceneBuilder()
    matte = b.add_material(sc.MAT_MATTE, kd=(0.5, 0.6, 0.7))
    glass = b.add_material(sc.MAT_GLASS, eta=1.5, roughness=0.0)
    b.add_triangle_mesh([[0, 1, 2], [2, 3, 0]],
                        [[-10, -10, 0], [10, -10, 0], [10, 10, 0], [-10, 10, 0]],
                        material=matte)
    b.add_sphere(tf.translate(1.3, -0.5, 0.8), 0.8, material=glass)
    b.add_emissive_sphere(tf.translate(0, 4, 6), 0.6, L=(30.0, 30.0, 30.0),
                          material=matte, n_samples=1)
    b.add_emissive_sphere(tf.translate(-4, -2, 3), 0.3, L=(60.0, 40.0, 20.0),
                          material=matte, n_samples=2)
    return b


def direct_render(device, strategy, switch="1"):
    res = (32, 32)
    scene = sc.SceneArrays.from_numpy(two_lights().build_numpy(), device)
    cam = cameras.make_perspective_camera(
        tf.look_at([0, -7, 4], [0, 0, 1], [0, 0, 1]), res, fov_deg=45.0)
    kb.bvh4_traverse.launches = kb.bvh2_traverse.launches = 0
    with bvh_switch(switch):
        img = direct.render(scene, cam, FilmConfig(full_resolution=res),
                            SamplerConfig("halton", 2, res),
                            direct.DirectLightingConfig(3, strategy),
                            device=device)
    return img.cpu(), (kb.bvh4_traverse.launches, kb.bvh2_traverse.launches)


@pytest.mark.parametrize("strategy", ["one", "all"])
def test_direct_on_card_matches_cpu_and_bvh2(strategy):
    """Launches a sample at depth 3: 4 closest-hit, then NEE: one a vertex
    for "one"; for "all" 1 + 2 at the first vertex, 2 at each later one."""
    card, n4 = direct_render("cuda", strategy)
    per_spp = 4 + (3 if strategy == "one" else 3 + 2 + 2)
    assert n4 == (2 * per_spp, 0)
    cpu, _ = direct_render("cpu", strategy)
    assert torch.isfinite(card).all() and float(card.mean()) > 0
    assert_image_bars(card, cpu)
    card2, n2 = direct_render("cuda", strategy, "0")
    assert n2 == (0, 2 * per_spp)
    assert_image_bars(card2, card)


def parity_file(tmp_path, name, res, spp, integrator=None):
    """refgold/parity/<name>.pbrt at res x res and spp, its Integrator line
    replaced by `integrator` when given."""
    import re

    src = (ROOT / "refgold/parity" / f"{name}.pbrt").read_text()
    src = re.sub(r'"integer xresolution" \[\d+\] "integer yresolution" \[\d+\]',
                 f'"integer xresolution" [{res}] "integer yresolution" [{res}]', src)
    src = re.sub(r'"integer pixelsamples" \[\d+\]', f'"integer pixelsamples" [{spp}]',
                 src)
    if integrator is not None:
        src = re.sub(r'Integrator "[a-z]+"[^\n]*', f"Integrator {integrator}", src)
    path = tmp_path / f"{name}_{res}.pbrt"
    path.write_text(src)
    return path


def file_render(path, device, switch="1"):
    """render_file on `device` under PBRT_TPU_BVH4=switch: (image, bvh4 and
    bvh2 launches)."""
    from pbrt_tpu_torch.render import render_file

    kb.bvh4_traverse.launches = kb.bvh2_traverse.launches = 0
    with bvh_switch(switch):
        img, _ = render_file(str(path), out=str(path.with_suffix(f".{device}.pfm")),
                             device=device)
    return (torch.as_tensor(img),
            (kb.bvh4_traverse.launches, kb.bvh2_traverse.launches))


def assert_media_bars(got, ref):
    """tests/test_parity_images.py:48's bars for media scenes."""
    rel = (got - ref).abs() / ref.abs().clamp(min=1e-2)
    assert (rel <= 1e-3).all(-1).float().mean() >= 0.60
    assert abs(float(got.mean()) - float(ref.mean())) <= 4e-2 * float(ref.mean())


MEDIA_VOLPATH = '"volpath" "integer maxdepth" [3]'


def test_volpath_on_card_matches_cpu_and_bvh2(tmp_path):
    """d_media_volpath at 32x32 @ 2 spp, depth 3: 3 x (1 + 16) + 1 launches
    a sample; a bit-identical repeat."""
    path = parity_file(tmp_path, "d_media_volpath", 32, 2, MEDIA_VOLPATH)
    card, n4 = file_render(path, "cuda")
    assert n4 == (2 * (3 * 17 + 1), 0)
    assert torch.isfinite(card).all() and float(card.mean()) > 0
    assert_media_bars(card, file_render(path, "cpu")[0])
    card2, n2 = file_render(path, "cuda", "0")
    assert n2 == (0, 2 * (3 * 17 + 1))
    assert_image_bars(card2, card)
    assert torch.equal(file_render(path, "cuda")[0], card)


def assert_batches_equal_plain(path, kind, n_calls):
    """Every batch one sample of `path` launches through `kind`'s kernel and
    its plain version, bit for bit; returns the live lanes."""
    from pbrt_tpu_torch.render import render_file

    with bvh_switch("1" if kind == "bvh4" else "0"), kb.record_calls() as calls:
        render_file(str(path), out=str(path.with_suffix(".o.pfm")), device="cuda")
    assert len(calls) == n_calls
    scene = parse_pbrt_file(str(path)).build_scene("cuda")
    wrapper = getattr(kb, f"{kind}_traverse")
    plain = getattr(kb, f"{kind}_traverse_plain")
    nodes, depth = getattr(scene, f"{kind}_nodes"), getattr(scene, f"{kind}_depth")
    live = 0
    for o, d, t_max, mode, order in calls:
        t_k, p_k = wrapper(nodes, scene.prim_tris, o, d, t_max, mode, depth, order)
        t_p, p_p = plain(nodes, scene.prim_tris, o, d, t_max, mode, order=order)
        assert torch.equal(p_k, p_p) and torch.equal(t_k, t_p)
        live += int((t_max > 0).sum())
    return live


@pytest.mark.parametrize("kind", ["bvh4", "bvh2"])
def test_volpath_batches_kernel_equals_plain(tmp_path, kind):
    """Every batch one volpath sample launches (the closest hits and the
    medium walks' segments, dead lanes at t_max = 0) through the kernel and
    its plain version, bit for bit."""
    path = parity_file(tmp_path, "d_media_volpath", 32, 1, MEDIA_VOLPATH)
    assert assert_batches_equal_plain(path, kind, 3 * 17 + 1) > 32 * 32


@pytest.mark.parametrize("integrator,per_spp", [
    ('"whitted" "integer maxdepth" [3]', (1 + 1) * 3 + 1),
    ('"ao" "integer nsamples" [8]', 1 + 8),
])
def test_whitted_and_ao_on_card_match_cpu(tmp_path, integrator, per_spp):
    """c4_mirror_d3 (one point light) at 32x32 @ 2 spp under each
    integrator: the launches, the CPU at tests/test_torch_path.py:58-59's
    bars, a bit-identical repeat."""
    path = parity_file(tmp_path, "c4_mirror_d3", 32, 2, integrator)
    card, n4 = file_render(path, "cuda")
    assert n4 == (2 * per_spp, 0)
    assert torch.isfinite(card).all() and float(card.mean()) > 0
    assert_image_bars(card, file_render(path, "cpu")[0])
    assert torch.equal(file_render(path, "cuda")[0], card)


@pytest.mark.parametrize("kind", ["bvh4", "bvh2"])
@pytest.mark.parametrize("integrator,per_spp", [
    ('"whitted" "integer maxdepth" [3]', (1 + 1) * 3 + 1),
    ('"ao" "integer nsamples" [8]', 1 + 8),
])
def test_whitted_and_ao_batches_kernel_equals_plain(tmp_path, integrator,
                                                    per_spp, kind):
    """Every batch one whitted or ao sample launches (camera rays, shadow
    rays, the specular continuation, ao's unbounded any-hit probes) through
    the kernel and its plain version, bit for bit."""
    path = parity_file(tmp_path, "c4_mirror_d3", 32, 1, integrator)
    assert assert_batches_equal_plain(path, kind, per_spp) > 32 * 32


# the spatial grid at the breadth scene's extent costs ~30 s on the CPU
BREADTH = dict(res=(32, 32), blob=(64, 32), depth=3,
               extra=' "string lightsamplestrategy" "uniform"')


def test_breadth_on_card_matches_cpu_and_bvh2(tmp_path):
    """write_breadth_pbrt at 32x32 @ 2 spp, depth 3: 2 x (1 + 3) launches,
    the CPU at tests/test_torch_path.py:58-59's bars, bvh2 against bvh4, a
    bit-identical repeat."""
    path = write_breadth_pbrt(tmp_path, spp=2, **BREADTH)
    card, n4 = file_render(path, "cuda")
    assert n4 == (2 * 4, 0)
    assert torch.isfinite(card).all() and float(card.mean()) > 0
    assert_image_bars(card, file_render(path, "cpu")[0])
    card2, n2 = file_render(path, "cuda", "0")
    assert n2 == (0, 2 * 4)
    assert_image_bars(card2, card)
    assert torch.equal(file_render(path, "cuda")[0], card)


@pytest.mark.parametrize("kind", ["bvh4", "bvh2"])
def test_breadth_batches_kernel_equals_plain(tmp_path, kind):
    """Every batch one breadth sample launches (the camera rays, then the
    merged [shadow | MIS | extension] batches, whose shadow lanes reach the
    spot, distant, projection and goniometric lights) through the kernel
    and its plain version, bit for bit."""
    path = write_breadth_pbrt(tmp_path, spp=1, **BREADTH)
    assert assert_batches_equal_plain(path, kind, 1 + 3) > 32 * 32


def breadth_functions_scene(device):
    """Each new material (uber at opacity 0.5 with Kr and Kt, mix of matte
    and metal) and each new light, with a point light."""
    b = sc.SceneBuilder()
    matte = b.add_material(sc.MAT_MATTE, kd=(0.2, 0.6, 0.3))
    metal = b.add_material(sc.MAT_METAL, roughness=0.05)
    b.add_material(sc.MAT_SUBSTRATE, kd=(0.5, 0.5, 0.7), ks=(0.3, 0.3, 0.3),
                   urough=0.05, vrough=0.2)
    b.add_material(sc.MAT_UBER, kd=(0.3, 0.3, 0.3), ks=(0.2, 0.2, 0.2),
                   kr=(0.1, 0.1, 0.1), kt=(0.4, 0.5, 0.6), roughness=0.05,
                   opacity=(0.5, 0.5, 0.5))
    b.add_material(sc.MAT_TRANSLUCENT, kd=(0.6, 0.5, 0.4), ks=(0.2, 0.2, 0.2),
                   kr=(0.5, 0.5, 0.5), kt=(0.5, 0.5, 0.5), roughness=0.1)
    b.add_material(sc.MAT_MIX, mix_m1=matte, mix_m2=metal,
                   mix_amount=(0.3, 0.3, 0.3))
    b.add_triangle_mesh([[0, 1, 2]], [[-3, -3, 0], [3, -3, 0], [0, 3, 0]],
                        material=matte)
    rs = np.random.RandomState(5)
    b.add_point_light(tf.translate(1, -2, 6), (30.0, 20.0, 10.0))
    b.add_spot_light(tf.translate(0, 0, 7) @ tf.rotate(170, 1, 0, 0),
                     (60.0, 50.0, 40.0), cone_angle_deg=35.0, cone_delta_deg=10.0)
    b.add_distant_light((-1.0, -0.6, 2.0), (1.2, 1.1, 0.9))
    b.add_projection_light(tf.translate(0, -1, 8) @ tf.rotate(180, 1, 0, 0),
                           (80.0, 80.0, 80.0), fov_deg=50.0,
                           image=(0.2 + 0.8 * rs.rand(24, 32, 3)).astype(np.float32))
    b.add_gonio_light(tf.translate(-3, 2, 4), (25.0, 25.0, 25.0),
                      image=(0.3 + rs.rand(16, 32, 3)).astype(np.float32))
    return b.build(device=device)


def assert_lanes_close(ref, got, what):
    """tests/test_torch_shading.py's bars: rtol 1e-5, atol 1e-6 on 99.9% of
    lanes, rtol 1e-3 on all; booleans exact."""
    ref, got = ref.cpu(), got.cpu()
    if ref.dtype == torch.bool:
        assert torch.equal(ref, got), what
        return
    ok = torch.isclose(got, ref, rtol=1e-5, atol=1e-6).reshape(ref.shape[0], -1)
    assert ok.all(-1).float().mean() >= 0.999, what
    assert torch.allclose(got, ref, rtol=1e-3, atol=1e-6), what


def test_breadth_materials_and_lights_on_card_match_cpu():
    from pbrt_tpu_torch.lights import lights as lt
    from pbrt_tpu_torch.materials import bsdf as bx

    n = 4096
    rs = np.random.RandomState(9)
    ids = torch.as_tensor(rs.randint(1, 6, n).astype(np.int32))
    wo, wi = (torch.as_tensor(v / np.linalg.norm(v, axis=-1, keepdims=True),
                              dtype=torch.float32)
              for v in (rs.randn(n, 3), rs.randn(n, 3)))
    u = torch.as_tensor(rs.rand(n, 2).astype(np.float32))
    lidx = torch.as_tensor(rs.randint(0, 5, n))
    ref_p = torch.as_tensor((rs.randn(n, 3) * [3.0, 3.0, 0.5]).astype(np.float32))
    out = {}
    for device in ("cpu", "cuda"):
        scene = breadth_functions_scene(device)
        mt = scene.mat_types
        m = bx.gather_material(scene.materials, ids.to(device), mat_types=mt,
                               sub_types=scene.mix_sub_types)
        a, b_, c, p = (x.to(device) for x in (wo, wi, u, ref_p))
        f, pdf = bx.eval_material(m, a, b_, mt)
        s = bx.sample_material(m, a, c, mt)
        li = lt.sample_li(scene, lidx.to(device), p, c, scene.light_types)
        out[device] = dict(f=f, pdf=pdf, count=bx.count_nonspecular(m),
                           **{f"s_{k}": v for k, v in s.items()},
                           **{f"li_{k}": v for k, v in li.items()},
                           pdf_li=lt.pdf_li(scene, lidx.to(device), p, b_,
                                            scene.light_types))
    for k, ref in out["cpu"].items():
        assert_lanes_close(ref, out["cuda"][k], k)
    assert out["cpu"]["s_valid"].float().mean() > 0.3


# the advanced file: a sample launches the camera rays, then a bounce the
# NEE, 4 probe segments, the exit point's NEE and the next closest hit
ADVANCED = dict(res=(32, 32), blob=(64, 32), depth=3,
                extra=' "string lightsamplestrategy" "uniform"')
ADVANCED_PER_SPP = 1 + 3 * (3 + 4)


def test_advanced_on_card_matches_cpu_and_bvh2(tmp_path):
    """write_advanced_pbrt at 32x32 @ 2 spp, depth 3: 2 x 22 launches, the
    CPU at tests/test_torch_path.py:58-59's bars, bvh2 against bvh4, a
    bit-identical repeat."""
    path = write_advanced_pbrt(tmp_path, spp=2, **ADVANCED)
    card, n4 = file_render(path, "cuda")
    assert n4 == (2 * ADVANCED_PER_SPP, 0)
    assert torch.isfinite(card).all() and float(card.mean()) > 0
    assert_image_bars(card, file_render(path, "cpu")[0])
    card2, n2 = file_render(path, "cuda", "0")
    assert n2 == (0, 2 * ADVANCED_PER_SPP)
    assert_image_bars(card2, card)
    assert torch.equal(file_render(path, "cuda")[0], card)


@pytest.mark.parametrize("kind", ["bvh4", "bvh2"])
def test_advanced_batches_kernel_equals_plain(tmp_path, kind):
    """Every batch one advanced sample launches through the kernel and its
    plain version, bit for bit: the probe segments' lanes that do not walk
    at t_max = 0 from a finite ray."""
    path = write_advanced_pbrt(tmp_path, spp=1, **ADVANCED)
    assert assert_batches_equal_plain(path, kind, ADVANCED_PER_SPP) > 32 * 32


# image formation: the ordered film under filters whose footprints overlap,
# and the orthographic, environment and realistic cameras

@pytest.mark.parametrize("filter_name", ["gaussian", "sinc"])
def test_overlapping_film_on_card_repeats_and_matches_cpu(filter_name):
    """Two batches of one sample per pixel of a 64x48 film and a batch of
    20000 samples anywhere: two card films bit-identical, and equal to the
    CPU's bit for bit (each pixel's contributions added in one order)."""
    from pbrt_tpu_torch import film as fm
    from pbrt_tpu_torch.filters import make_filter

    res = (64, 48)
    rs = np.random.RandomState(11)
    pix = path.make_pixel_grid(FilmConfig(full_resolution=res)).astype(np.float32)
    batches = [(pix + rs.rand(*pix.shape).astype(np.float32),
                rs.rand(pix.shape[0], 3).astype(np.float32) * 2.0,
                rs.rand(pix.shape[0]).astype(np.float32)) for _ in range(2)]
    batches.append(((rs.rand(20000, 2) * np.array(res)).astype(np.float32),
                    rs.rand(20000, 3).astype(np.float32),
                    rs.rand(20000).astype(np.float32)))
    filt = make_filter(filter_name)
    cfg = FilmConfig(full_resolution=res, filter_name=filter_name,
                     filter_radius=filt.radius)
    out = []
    for device in ("cuda", "cuda", "cpu"):
        state = fm.make_film_state(cfg, filt, device)
        for p, L, w in batches:
            fm.add_samples(state, *(torch.as_tensor(x, device=device) for x in (p, L, w)))
        out.append([x.cpu() for x in (state.weighted_sum, state.weight_sum,
                                      fm.to_image(state))])
    for a, b, c in zip(*out):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("kind", ["orthographic", "environment", "realistic"])
def test_new_cameras_on_card_match_cpu(kind):
    """Rays and weights of each new camera on the card against the CPU's
    at tests/test_torch_imaging.py's rtol 1e-5 (sin, cos and sqrt differ
    in the last bit between the card and the CPU), the realistic camera's
    at rtol 1e-4: its walk through ten refracting surfaces amplifies such
    a bit, to 4e-5 on one lane of 50,000 in the first run on the card;
    vignetting alike but for a lane on an aperture's rim."""
    look = tf.look_at([0, -8, 4], [0, 0, 2], [0, 0, 1])
    res = (96, 64)
    make = {"orthographic": lambda: cameras.make_orthographic_camera(
                look, res, lens_radius=0.2, focal_distance=6.0),
            "environment": lambda: cameras.make_environment_camera(look, res),
            "realistic": lambda: cameras.make_realistic_camera(
                look, res, focus_distance=8.0)}[kind]
    cam = make()
    rs = np.random.RandomState(12)
    n = 50000
    args = [torch.as_tensor((rs.rand(n, 2) * np.array(res)).astype(np.float32)),
            torch.as_tensor(rs.rand(n, 2).astype(np.float32)),
            torch.as_tensor(rs.rand(n).astype(np.float32))]
    ref = cameras.generate_rays(cam, *args)
    got = [x.cpu() for x in cameras.generate_rays(cam.to("cuda"),
                                                  *(x.cuda() for x in args))]
    # a lane on an aperture's rim may pass on one device and not the other
    agree = (ref[3] > 0) == (got[3] > 0)
    assert agree.float().mean() >= 0.9999 and (ref[3] > 0).float().mean() > 0.3
    rtol = 1e-4 if kind == "realistic" else 1e-5
    for a, b in zip(ref, got):
        np.testing.assert_allclose(b[agree].numpy(), a[agree].numpy(), rtol=rtol,
                                   atol=1e-6)


# ---- the grad step on every family (tests/test_torch_grad_groups.py) ----

GRAD_GROUPS = [("config3", "perspective", "halton"),
               ("classic", "perspective", "halton"),
               ("advanced", "perspective", "halton"),
               ("imaging", "orthographic", "stratified"),
               ("imaging", "environment", "zerotwosequence"),
               ("imaging", "realistic", "maxmin"),
               ("imaging", "orthographic", "random")]


@pytest.mark.parametrize("case", GRAD_GROUPS, ids="-".join)
def test_grad_group_on_card_matches_cpu(case):
    """Each group's step (12x12, depth 2, sample 1; the random sampler
    without remat) on the card against the CPU: L at
    tests/test_torch_path.py:58's bar, each leaf within 1e-3 of the CPU
    leaf's largest entry, every leaf finite."""
    from test_torch_grad_groups import device_step

    remat = case[2] != "random"
    L_c, g_c = device_step(case, "cuda", remat)
    L_h, g_h = device_step(case, "cpu", remat)
    rel = (L_c - L_h).abs() / L_h.abs().clamp(min=1e-2)
    assert (rel <= 1e-3).all(-1).float().mean() >= 0.995
    assert_leaves_close(g_c, g_h, 1e-3)


@pytest.mark.parametrize("case", GRAD_GROUPS[:4], ids="-".join)
def test_grad_group_bvh2_matches_bvh4(monkeypatch, case):
    """Each group's remat step under PBRT_TPU_BVH4=0 against bvh4, each
    leaf within 1e-4 of bvh4's largest entry."""
    from test_torch_grad_groups import device_step

    monkeypatch.setenv("PBRT_TPU_BVH4", "1")
    L4, g4 = device_step(case, "cuda")
    monkeypatch.setenv("PBRT_TPU_BVH4", "0")
    kb.bvh2_traverse.launches = 0
    L2, g2 = device_step(case, "cuda")
    assert kb.bvh2_traverse.launches > 0
    assert_leaves_close(g2, g4, 1e-4)


@pytest.mark.parametrize("work", ["identity", "random-order"])
@pytest.mark.parametrize("name", list(TYPED_SCENES))
def test_typed_kernel_equals_plain(name, work):
    """The typed build against bvh4_traverse_plain(typed=...) bit for bit,
    closest-hit and with any-hit lanes, every 5th lane dead."""
    s = TYPED_SCENES[name]().build(device="cuda")
    n = 4099
    o, d = typed_rays(n, 12, "cuda")
    t_max, mode = typed_lanes(n, 13, "cuda")
    order = random_order(n, 14) if work == "random-order" else None
    tables = kb.typed_tables(s)
    before = kb.bvh4_traverse_typed.launches
    for m in (torch.zeros(n, device="cuda"), mode):
        t_k, p_k = kb.bvh4_traverse_typed(s.bvh4_nodes, s.prim_tris, *tables, o, d,
                                          t_max, m, s.bvh4_depth, order)
        torch.cuda.synchronize()
        t_p, p_p = kb.bvh4_traverse_plain(s.bvh4_nodes, s.prim_tris, o, d, t_max, m,
                                          order=order, typed=tables)
        assert torch.equal(p_k, p_p)
        assert torch.equal(t_k, t_p)
    assert kb.bvh4_traverse_typed.launches == before + 2
    assert float((p_k >= 0).float().mean()) > 0.2


@pytest.mark.parametrize("work", ["identity", "random-order"])
def test_typed_kernel_equals_plain_at_the_stack_cap(work):
    """The caterpillar tree at bvh4's stack cap with every 4th record an
    instanced triangle (an identity instance): the typed build equals its
    plain version bit for bit; one level deeper is refused."""
    m, need = STACK_CAP["bvh4"]
    tree, recs = caterpillar_tree(m)
    recs = recs.copy()
    recs[::4, 3] = float(kb.TYPE_INSTANCE)
    recs.view(np.int32)[::4, 7] = 0
    rows4, depth = kb.build_bvh4_table(*tree[:4])
    assert kb.STACK_SIZE - 3 < need(depth) <= kb.STACK_SIZE
    eye = np.concatenate([np.eye(4, dtype=np.float32)[:3].ravel()] * 2)[None]
    tables = (torch.zeros((1, 24), device="cuda"), torch.zeros((1, 28), device="cuda"),
              torch.as_tensor(eye, device="cuda"))
    nodes = torch.as_tensor(rows4, device="cuda")
    tris = torch.as_tensor(recs, device="cuda")
    n = 4099
    o, d = caterpillar_rays(n, 7)
    t_max = torch.full((n,), 1e30, device="cuda")
    t_max[::11] = 0.0
    mode = (torch.arange(n, device="cuda") % 4 == 0).float()
    order = random_order(n, 8) if work == "random-order" else None
    t_k, p_k = kb.bvh4_traverse_typed(nodes, tris, *tables, o, d, t_max, mode,
                                      depth, order)
    t_p, p_p = kb.bvh4_traverse_plain(nodes, tris, o, d, t_max, mode, order=order,
                                      typed=tables)
    assert torch.equal(p_k, p_p) and torch.equal(t_k, t_p)
    assert bool((recs[p_k[p_k >= 0].cpu().numpy(), 3] == kb.TYPE_INSTANCE).any())
    deeper, _ = caterpillar_tree(m + 2)
    rows5, depth5 = kb.build_bvh4_table(*deeper[:4])
    assert need(depth5) > kb.STACK_SIZE
    with pytest.raises(ValueError, match="stack"):
        kb.bvh4_traverse_typed(torch.as_tensor(rows5, device="cuda"), tris, *tables,
                               o, d, t_max, mode, depth5)


def test_typed_route_refused_under_bvh2(monkeypatch):
    """PBRT_TPU_BVH4=0 no longer refuses a scene past the gate: on the card
    it launches the typed build of bvh4 (its counter grows, bvh2's does
    not), with the results of the switch unset bit for bit."""
    from pbrt_tpu_torch.accel import traverse

    s = TYPED_SCENES["mixed"]().build(device="cuda")
    o, d = typed_rays(256, 1, "cuda")
    t_max, mode = typed_lanes(256, 2, "cuda")
    monkeypatch.setenv("PBRT_TPU_BVH4", "1")
    want = traverse.intersect_closest(s, o, d, t_max, mode > 0)
    monkeypatch.setenv("PBRT_TPU_BVH4", "0")
    before = (kb.bvh2_traverse.launches, kb.bvh4_traverse_typed.launches)
    got = traverse.intersect_closest(s, o, d, t_max, mode > 0)
    assert kb.bvh2_traverse.launches == before[0]
    assert kb.bvh4_traverse_typed.launches == before[1] + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool((got[1] >= 0).any())


def _small_geometry(tmp_path, label):
    if label == "geometry":
        return write_geometry_pbrt(tmp_path / label, res=(32, 32), spp=2, depth=2,
                                   hf=64, levels=2)
    return write_instances_pbrt(tmp_path / label, res=(32, 32), spp=2, depth=2,
                                blob=(32, 16), n_blobs=4, n_quads=9, n_curves=96)


@pytest.mark.parametrize("label,kernel", [("geometry", "bvh4_traverse"),
                                          ("instances", "bvh4_traverse_typed")])
def test_geometry_files_on_card_match_cpu(tmp_path, label, kernel):
    """Small copies of chip_smoke.py's two phase-18 files (uniform light
    distribution) at 32x32 @ 2 spp, depth 2: the card's render against the
    CPU's at tests/test_torch_path.py:58-59's bars (99.5% of pixels within
    rel 1e-3, means within 5e-3), (1 + 2) launches a spp of the one build
    and none of the others, a bit-identical repeat, and a grad step: L
    equal to the forward, every leaf finite."""
    file = _small_geometry(tmp_path, label)
    setup = parse_pbrt_file(str(file))
    setup.integrator_params.set("lightsamplestrategy", "string", ["uniform"])
    film_cfg, filt = setup.make_film_config()
    camera = setup.make_camera()
    cfg = setup.make_integrator_config()
    scfg = setup.make_sampler_config()
    counts = {k: getattr(kb, k) for k in ("bvh4_traverse", "bvh2_traverse",
                                          "bvh4_traverse_typed")}
    before = {k: f.launches for k, f in counts.items()}
    card = setup.scene_builder.build(device="cuda")
    a = path.render(card, camera, film_cfg, scfg, cfg, filt, device="cuda")
    spent = {k: f.launches - before[k] for k, f in counts.items()}
    assert spent == {k: (2 * 3 if k == kernel else 0) for k in counts}
    assert torch.equal(a, path.render(card, camera, film_cfg, scfg, cfg, filt,
                                      device="cuda"))
    b = path.render(setup.scene_builder.build(device="cpu"), camera, film_cfg, scfg,
                    cfg, filt, device="cpu")
    a, b = a.cpu().numpy(), b.numpy()
    assert np.isfinite(a).all() and a.mean() > 0
    rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-2)
    assert float(np.all(rel <= 1e-3, -1).mean()) >= 0.995
    assert abs(float(a.mean()) - float(b.mean())) <= 5e-3 * float(b.mean())
    pixels = torch.as_tensor(path.make_pixel_grid(film_cfg), device="cuda")
    w = torch.ones((pixels.shape[0], 3), device="cuda")
    cam = camera.to("cuda")
    L, g = diff.render_grad_step(card, cam, pixels, 1, w, scfg, cfg, device="cuda")
    with torch.no_grad():
        L_fwd = diff.render_batch_radiance(card, cam, pixels, 1, scfg, cfg)
    assert torch.equal(L, L_fwd)
    leaves = [x for v in g.values()
              for x in (v.values() if isinstance(v, dict) else [v])]
    assert all(bool(torch.isfinite(x).all()) for x in leaves
               if isinstance(x, torch.Tensor))


# bdpt, mlt and sppm on c4_mirror_d3 (a point light and a mirror: the
# caustic) with the integrator's parameters; launches a spp (bdpt at depth
# 3: 4 + 3 + 3 + 3 + 3) or an iteration (sppm: 3 a bounce)
TRANSPORT = {
    "bdpt": ('"bdpt" "integer maxdepth" [3]', 16),
    "mlt": ('"mlt" "integer maxdepth" [2] "integer chains" [256] '
            '"integer mutationsperpixel" [2] "integer bootstrapsamples" [768]', None),
    "sppm": ('"sppm" "integer maxdepth" [3] "integer numiterations" [2] '
             '"float radius" [0.2]', 9),
}


def transport_file(tmp_path, name, spp=2):
    return parity_file(tmp_path, "c4_mirror_d3", 32, spp, TRANSPORT[name][0])


@pytest.mark.parametrize("name", sorted(TRANSPORT))
def test_transport_on_card_matches_cpu(tmp_path, name):
    """bdpt (2 spp), mlt (the same CPU draws on both) and sppm (2
    iterations) at 32x32: the launches, a bit-identical repeat, and the CPU
    at tests/test_torch_path.py:58-59's bars (bdpt, sppm) or
    tests/test_mlt_sppm_tools.py's MLT bars (means within 15%, correlation
    above 0.9: a chain pick can turn on the last bit of a luminance)."""
    path = transport_file(tmp_path, name)
    card, n4 = file_render(path, "cuda")
    per = TRANSPORT[name][1]
    if per is not None:
        assert n4 == (2 * per, 0)
    assert torch.isfinite(card).all() and float(card.mean()) > 0
    assert torch.equal(file_render(path, "cuda")[0], card)
    cpu = file_render(path, "cpu")[0]
    if name == "mlt":
        corr = np.corrcoef(card.numpy().ravel(), cpu.numpy().ravel())[0, 1]
        assert abs(float(card.mean()) - float(cpu.mean())) < 0.15 * float(cpu.mean())
        assert corr > 0.9
    else:
        assert_image_bars(card, cpu)


def test_bdpt_bvh2_matches_bvh4(tmp_path):
    path = transport_file(tmp_path, "bdpt")
    card, _ = file_render(path, "cuda")
    card2, n2 = file_render(path, "cuda", "0")
    assert n2 == (0, 2 * TRANSPORT["bdpt"][1])
    assert_image_bars(card2, card)


@pytest.mark.parametrize("kind", ["bvh4", "bvh2"])
@pytest.mark.parametrize("name", ["bdpt", "sppm"])
def test_transport_batches_kernel_equals_plain(tmp_path, name, kind):
    """Every batch one bdpt sample (walks and connections) or one sppm
    iteration (camera pass, NEE, photon walk) launches, through the kernel
    and its plain version, bit for bit."""
    path = transport_file(tmp_path, name, spp=1)
    if name == "sppm":
        path.write_text(path.read_text().replace('"integer numiterations" [2]',
                                                 '"integer numiterations" [1]'))
    assert assert_batches_equal_plain(path, kind, TRANSPORT[name][1]) > 32 * 32


UNIFORM_PATH = '"path" "integer maxdepth" [5] "string lightsamplestrategy" "uniform"'


def wavefront_file(tmp_path, spp=2):
    return parity_file(tmp_path, "c1_matte_point_d5", 32, spp, UNIFORM_PATH)


@pytest.mark.parametrize("switch", ["1", "0"])
def test_wavefront_on_card_matches_cpu(tmp_path, monkeypatch, switch):
    """PBRT_TPU_ENGINE=wavefront on c1_matte_point_d5 at 32x32 @ 2 spp,
    under each BVH kernel: 1 + 2 launches an iteration of that kernel
    alone, a bit-identical repeat, the CPU at tests/test_torch_path.py:
    58-59's bars."""
    monkeypatch.setenv("PBRT_TPU_ENGINE", "wavefront")
    path = wavefront_file(tmp_path)
    card, (n4, n2) = file_render(path, "cuda", switch)
    n = n4 if switch == "1" else n2
    assert n % 2 == 1 and n >= 3 and (n2 if switch == "1" else n4) == 0
    assert torch.isfinite(card).all() and float(card.mean()) > 0
    assert torch.equal(file_render(path, "cuda", switch)[0], card)
    assert_image_bars(card, file_render(path, "cpu", switch)[0])


@pytest.mark.parametrize("kind", ["bvh4", "bvh2"])
def test_wavefront_batches_kernel_equals_plain(tmp_path, monkeypatch, kind):
    """Every launch of a wavefront render (launch A's shadow and MIS rays,
    launch B's extension and refilled camera rays) through the kernel and
    its plain version, bit for bit."""
    from pbrt_tpu_torch.render import render_file

    monkeypatch.setenv("PBRT_TPU_ENGINE", "wavefront")
    path = wavefront_file(tmp_path, spp=1)
    with bvh_switch("1" if kind == "bvh4" else "0"), kb.record_calls() as calls:
        render_file(str(path), out=str(path.with_suffix(".o.pfm")), device="cuda")
    assert len(calls) % 2 == 1 and len(calls) >= 3
    scene = parse_pbrt_file(str(path)).build_scene("cuda")
    wrapper = getattr(kb, f"{kind}_traverse")
    plain = getattr(kb, f"{kind}_traverse_plain")
    nodes, depth = getattr(scene, f"{kind}_nodes"), getattr(scene, f"{kind}_depth")
    for o, d, t_max, mode, order in calls:
        t_k, p_k = wrapper(nodes, scene.prim_tris, o, d, t_max, mode, depth, order)
        t_p, p_p = plain(nodes, scene.prim_tris, o, d, t_max, mode, order=order)
        assert torch.equal(p_k, p_p) and torch.equal(t_k, t_p)


def test_kdtree_on_card_matches_cpu(tmp_path):
    """c1_matte_point_d5 at 32x32 @ 2 spp under Accelerator "kdtree": no
    kernel launches, a bit-identical repeat, the CPU and the card's BVH
    render at tests/test_torch_path.py:58-59's bars."""
    bvh_path = wavefront_file(tmp_path)
    path = tmp_path / "kd.pbrt"
    path.write_text(bvh_path.read_text().replace(
        "WorldBegin", 'Accelerator "kdtree"\nWorldBegin', 1))
    card, n = file_render(path, "cuda")
    assert n == (0, 0)
    assert torch.isfinite(card).all() and float(card.mean()) > 0
    assert torch.equal(file_render(path, "cuda")[0], card)
    assert_image_bars(card, file_render(path, "cpu")[0])
    assert_image_bars(card, file_render(bvh_path, "cuda")[0])
