"""The kernels on the card: bvh4_traverse and bvh2_traverse against their
plain PyTorch versions (bit for bit, under a random work list, all-dead
batches, and a tree at each kernel's stack cap; one deeper refused) and
against each other, the layout probe's Triton chain against its plain form
B (at its size and at a ragged one), the launch counts, a render on the
card against one on the CPU, the CLI on the card against a pbrt-v3
golden, and a differentiable render step on the card against one on the
CPU and under each BVH kernel.

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
from pbrt_tpu_torch.integrators import path
from pbrt_tpu_torch.ops import bvh as kb
from pbrt_tpu_torch.parallel import diff
from pbrt_tpu_torch.samplers.samplers import SamplerConfig
from pbrt_tpu_torch.tools import bench_layout_probe as bp
from pbrt_tpu_torch.utils.imageio import read_pfm
from test_torch_trees import caterpillar_rays, caterpillar_tree

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
