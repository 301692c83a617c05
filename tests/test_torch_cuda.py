"""The CUDA kernel on the card: bvh4_traverse against its plain PyTorch
version, the launch count, and a render on the card against one on the CPU.

These need a CUDA card and skip without one.  The file imports neither JAX
nor the JAX package, so on a machine without JAX it runs with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
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
