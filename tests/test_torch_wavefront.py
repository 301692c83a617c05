"""The wavefront engine (integrators/wavefront.py) against the JAX
package's, on the CPU: tests/test_wavefront.py's matte scene at 16x16, at
1 spp and 4 spp, the image and every counter; a scene with a mirror, where
the per-lane dim cursors skip the NEE dims at the specular vertex and part
from the lockstep schedule; a pool of 64 lanes refilled many times; and
what the engine refuses or hands to the lockstep engine.

Bars: JAX's own between its engines (tests/test_wavefront.py), 1e-6 at
1 spp, where a pixel takes one sample, and 2e-6 at 4 spp, where the film's
add order may differ; the counters exactly.  Each JAX render compiles its
superstep once and is shared by the tests through a module cache."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from pbrt_tpu import film as jfm
from pbrt_tpu import scene as jsc
from pbrt_tpu.cameras import make_perspective_camera as jcamera
from pbrt_tpu.core import transform as jtf
from pbrt_tpu.integrators import path as jpath
from pbrt_tpu.integrators import wavefront as jwf
from pbrt_tpu.samplers.samplers import SamplerConfig as JSampler
from pbrt_tpu_torch import bridge
from pbrt_tpu_torch import film as tfm
from pbrt_tpu_torch.integrators import path as tpath
from pbrt_tpu_torch.integrators import wavefront as twf
from pbrt_tpu_torch.samplers.samplers import SamplerConfig as TSampler
from pbrt_tpu_torch.utils import stats as tst
from jax_traversal_jit import jit_jax_traversal  # noqa: F401  (autouse)
import test_torch_threads  # noqa: F401  (torch's threads under xdist)

RES = (16, 16)


def matte_scene(mirror: bool = False):
    """tests/test_wavefront.py:_matte_scene; with mirror, a mirror sphere
    beside the matte one."""
    b = jsc.SceneBuilder()
    m = b.add_material(jsc.MAT_MATTE, kd=(0.5, 0.4, 0.3), sigma=0.0)
    b.add_sphere(jtf.identity(), 1.0, material=m)
    b.add_point_light(jtf.identity(), (np.pi, np.pi, np.pi))
    m2 = b.add_material(jsc.MAT_MATTE, kd=(0.0, 0.0, 0.0))
    b.add_emissive_sphere(jtf.translate(0.0, 0.4, 0.3), 0.2, L=(3.0, 2.0, 1.0),
                          material=m2)
    if mirror:
        mm = b.add_material(jsc.MAT_MIRROR, kr=(0.9, 0.9, 0.9))
        b.add_sphere(jtf.translate(0.25, -0.2, 0.6), 0.15, material=mm)
    return b.build()


@functools.cache
def setup(mirror: bool):
    j = matte_scene(mirror)
    jc = jcamera(jtf.look_at([0, 0, 0], [0, 0, 1], [0, 1, 0]), RES, fov_deg=45.0)
    return (j, jc, bridge.scene_from_numpy(bridge.as_numpy_fields(j), "cpu"),
            bridge.camera_from_numpy(bridge.as_numpy_fields(jc), "cpu"))


@functools.cache
def jax_render(spp: int, mirror: bool = False):
    j, jc, _, _ = setup(mirror)
    img, counters = jwf.render(j, jc, jfm.FilmConfig(full_resolution=RES),
                               JSampler("halton", spp, RES),
                               jpath.PathConfig(max_depth=5), n_lanes=1024,
                               stats_out=True)
    return np.asarray(img), np.asarray(counters)


@functools.cache
def port_render(spp: int, mirror: bool = False, n_lanes: int = 1024,
                iters_per_step: int = 8):
    _, _, t, tc = setup(mirror)
    img, counters = twf.render(t, tc, tfm.FilmConfig(full_resolution=RES),
                               TSampler("halton", spp, RES),
                               tpath.PathConfig(max_depth=5), stats_out=True,
                               device="cpu", n_lanes=n_lanes,
                               iters_per_step=iters_per_step)
    return img.numpy(), counters.numpy()


def test_wavefront_matches_jax_1spp():
    ref, _ = jax_render(1)
    got, _ = port_render(1)
    assert got.shape == (RES[1], RES[0], 3) and got.mean() > 0
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_wavefront_matches_jax_4spp():
    ref, _ = jax_render(4)
    got, _ = port_render(4)
    np.testing.assert_allclose(got, ref, rtol=2e-6, atol=2e-6)


def test_counters_match_jax():
    """Every counter of the 4 spp render, and the rays traced."""
    _, ref = jax_render(4)
    _, got = port_render(4)
    assert ref.shape == got.shape == (len(tst.COUNTERS),)
    np.testing.assert_array_equal(got, ref)


def test_small_pool_refills():
    """64 lanes for 1,024 paths, 3 iterations a superstep: the same work
    ids, so the JAX package's image (its pool holds every path at once)."""
    ref, ref_c = jax_render(4)
    got, got_c = port_render(4, n_lanes=64, iters_per_step=3)
    np.testing.assert_allclose(got, ref, rtol=2e-6, atol=2e-6)
    np.testing.assert_array_equal(got_c, ref_c)


def test_specular_vertex_matches_jax():
    """A mirror sphere: the wavefront skips the NEE dims at its vertices,
    which the lockstep schedule draws, so the lockstep image differs."""
    ref, ref_c = jax_render(1, mirror=True)
    got, got_c = port_render(1, mirror=True)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got_c, ref_c)
    _, _, t, tc = setup(True)
    lock = tpath.render(t, tc, tfm.FilmConfig(full_resolution=RES),
                        TSampler("halton", 1, RES), tpath.PathConfig(max_depth=5),
                        device="cpu").numpy()
    assert np.abs(lock - got).max() > 1e-3


def test_wavefront_refusals(monkeypatch):
    """The exact sampler mode raises (the JAX wavefront ignores it); a
    scene with a subsurface material renders with the lockstep engine, as
    in the JAX package (wavefront.py:364-370)."""
    _, _, t, tc = setup(False)
    film = tfm.FilmConfig(full_resolution=RES)
    exact = dataclasses.replace(TSampler("halton", 1, RES), exact=True)
    with pytest.raises(NotImplementedError, match="exact sampler"):
        twf.render(t, tc, film, exact, device="cpu")
    seen = []
    monkeypatch.setattr(tpath, "render", lambda *a, **kw: seen.append(kw) or "lockstep")
    ss = dataclasses.replace(t, mat_types=t.mat_types + (twf.MAT_SUBSURFACE,))
    assert twf.render(ss, tc, film, TSampler("halton", 1, RES), device="cpu",
                      stats_out=True) == "lockstep"
    assert seen and seen[0]["stats_out"] and seen[0]["device"] == torch.device("cpu")
