"""The slice as a whole: the JAX package's scene and camera carried over by
bridge, rendered by both packages with the path integrator (the port on the
CPU, through the plain version of its traversal kernel).

Bars of tests/test_parity_images.py:36 (a_floor_point): at depth 1, at least
99.5% of pixels within rel 1e-3 and image means within 5e-3; they allow for
Moller-Trumbore against watertight at grazing hits and for XLA:CPU FMA
contraction.  Deeper paths decohere through ulp differences, so depth 3 is
held at the mean level."""
import numpy as np
import pytest
import torch

from pbrt_tpu import film as jfm
from pbrt_tpu.cameras import make_perspective_camera as jcamera
from pbrt_tpu.core import transform as jtf
from pbrt_tpu.integrators import path as jpath
from pbrt_tpu.samplers.samplers import SamplerConfig as JSampler
from pbrt_tpu_torch import bridge
from pbrt_tpu_torch import film as tfm
from pbrt_tpu_torch.integrators import path as tpath
from pbrt_tpu_torch.samplers.samplers import SamplerConfig as TSampler
from test_torch_traverse import both
from test_torch_scene import demo
from jax_traversal_jit import jit_jax_traversal  # noqa: F401  (autouse)
import test_torch_threads  # noqa: F401  (torch's threads under xdist)

RES = (16, 16)
SPP = 2


def render_both(name, depth):
    js, ts = both(demo)
    jc = jcamera(jtf.look_at([0, -8, 4], [0, 0, 2], [0, 0, 1]), RES, fov_deg=45.0)
    tc = bridge.camera_from_numpy(bridge.as_numpy_fields(jc), "cpu")
    ref, ref_rays = jpath.render(js, jc, jfm.FilmConfig(full_resolution=RES),
                                 JSampler(name, SPP, RES),
                                 jpath.PathConfig(max_depth=depth), count_rays=True)
    got, got_rays = tpath.render(ts, tc, tfm.FilmConfig(full_resolution=RES),
                                 TSampler(name, SPP, RES),
                                 tpath.PathConfig(max_depth=depth),
                                 count_rays=True, device="cpu")
    return np.asarray(ref), got.numpy(), float(ref_rays), float(got_rays)


def match_frac(ref, got, tol=1e-3):
    rel = np.abs(ref - got) / np.maximum(np.abs(ref), 1e-2)
    return float(np.all(rel <= tol, -1).mean())


def mean_rel(ref, got):
    return abs(float(got.mean()) - float(ref.mean())) / max(float(ref.mean()), 1e-6)


@pytest.mark.parametrize("name", ["halton", "sobol"])
def test_depth1_image_matches_jax(name):
    ref, got, ref_rays, got_rays = render_both(name, 1)
    assert got.shape == ref.shape == (RES[1], RES[0], 3)
    assert np.isfinite(got).all() and got.mean() > 0
    assert match_frac(ref, got) >= 0.995
    assert mean_rel(ref, got) <= 5e-3
    assert abs(got_rays - ref_rays) <= 1e-3 * ref_rays


@pytest.mark.slow
@pytest.mark.parametrize("name", ["halton", "sobol"])
def test_depth3_image_mean_matches_jax(name):
    ref, got, ref_rays, got_rays = render_both(name, 3)
    assert np.isfinite(got).all()
    assert mean_rel(ref, got) <= 5e-3
    assert abs(got_rays - ref_rays) <= 5e-3 * ref_rays


def test_render_needs_the_card_unless_asked(monkeypatch):
    _, ts = both(demo)
    cam = bridge.camera_from_numpy(bridge.as_numpy_fields(
        jcamera(jtf.look_at([0, -8, 4], [0, 0, 2], [0, 0, 1]), (4, 4))), "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpath.render(ts, cam, tfm.FilmConfig(full_resolution=(4, 4)),
                     TSampler("halton", 1, (4, 4)))


def test_launches_per_sample_and_repeat():
    """Traversal calls per sample: 1 + max_depth (the camera rays, then one
    merged [shadow | MIS | extension] batch per bounce); a second render is
    bit-identical."""
    _, ts = both(demo)
    cam = bridge.camera_from_numpy(bridge.as_numpy_fields(
        jcamera(jtf.look_at([0, -8, 4], [0, 0, 2], [0, 0, 1]), (8, 8))), "cpu")
    args = (ts, cam, tfm.FilmConfig(full_resolution=(8, 8)),
            TSampler("sobol", 3, (8, 8)), tpath.PathConfig(max_depth=4))
    with tpath.tv.kb.record_calls() as calls:
        a = tpath.render(*args, device="cpu")
    sizes = [o.shape[0] for o, *_ in calls]
    assert len(sizes) == 3 * (1 + 4)
    assert sizes[:5] == [64, 192, 192, 192, 192]
    assert torch.equal(a, tpath.render(*args, device="cpu"))
