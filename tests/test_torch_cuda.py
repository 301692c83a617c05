"""The kernels on the card: bvh4_traverse and bvh2_traverse against their
plain PyTorch versions and against each other, the layout probe's Triton
chain against its plain form B, the launch counts, a render on the card
against one on the CPU, and the CLI on the card against a pbrt-v3 golden.

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
from pbrt_tpu_torch.samplers.samplers import SamplerConfig
from pbrt_tpu_torch.tools import bench_layout_probe as bp
from pbrt_tpu_torch.utils.imageio import read_pfm

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


@pytest.mark.parametrize("n", [1, 127, 128, 8193])
def test_kernel_equals_plain(n):
    s = soup(2000, 3).build(device="cuda")
    o, d = rays(n, n, "cuda")
    t_max = torch.full((n,), 1e30, device="cuda")
    t_max[::5] = 0.0
    mode = (torch.arange(n, device="cuda") % 3 == 0).float()
    args = (s.bvh4_nodes, s.prim_tris, o, d, t_max, mode)
    before = kb.bvh4_traverse.launches
    t_k, p_k = kb.bvh4_traverse(*args, s.bvh4_depth)
    assert kb.bvh4_traverse.launches == before + 1
    t_p, p_p = kb.bvh4_traverse_plain(*args)
    assert torch.equal(p_k, p_p)
    assert torch.equal(t_k, t_p)


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


@pytest.mark.parametrize("n", [1, 127, 128, 8193])
def test_bvh2_kernel_equals_plain_and_agrees_with_bvh4(n):
    s = soup(2000, 4).build(device="cuda")
    o, d = rays(n, n + 1, "cuda")
    t_max = torch.full((n,), 1e30, device="cuda")
    t_max[::5] = 0.0
    mode = (torch.arange(n, device="cuda") % 3 == 0).float()
    args = (s.bvh2_nodes, s.prim_tris, o, d, t_max, mode)
    before = kb.bvh2_traverse.launches
    t_k, p_k = kb.bvh2_traverse(*args, s.bvh2_depth)
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


def test_chain_fused_matches_form_b():
    """The Triton chain against form B at the probe's size: 1e-5 relative
    (plus 1e-6 absolute) on >= 99.9% of elements."""
    p, d, ns, t = bp.inputs(bp.N, "cuda")
    pT, dT, nsT = (x.t().contiguous() for x in (p, d, ns))
    before = bp.chain_fused.launches
    got = bp.chain_fused(pT, dT, nsT, t)
    assert bp.chain_fused.launches == before + 1
    ref = bp.chain_planar(pT, dT, nsT, t)
    for g, r in zip(got, ref):
        ok = (g - r).abs() <= 1e-5 * r.abs() + 1e-6
        assert ok.float().mean() >= 0.999


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
