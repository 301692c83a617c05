"""The port's direct-lighting integrator (pbrt_tpu_torch.integrators.direct)
held against the JAX package's (pbrt_tpu.integrators.direct), and through
the .pbrt front end against pbrt_tpu.render.

* li_direct through render, strategies "one" (maxdepth 2) and "all"
  (maxdepth 1), on a scene with two area lights of nsamples 1 and 2 and a
  glass sphere for the specular chain; marked slow, "all" at maxdepth 3
  with sobol (nsamples 3 rounds to 4), a point light and plastic, which
  also takes the exhausted-array draws past the first vertex;
* "all" equals "one" in mean on the furnace of
  tests/test_render_analytic.py:179.

The JAX package compiles each estimate_direct call of its unrolled loop
(about 8 s each on the CPU), which sets the sizes here.  The .pbrt
directlighting renders are in tests/test_torch_config3.py.

Bars: tests/test_torch_path.py:58-59's, at least 99.5% of pixels within
rel 1e-3 and image means within 5e-3 (Moller-Trumbore against the
watertight test at grazing hits, XLA:CPU FMA contraction)."""
import numpy as np
import pytest

from pbrt_tpu import film as jfm
from pbrt_tpu import scene as jsc
from pbrt_tpu.cameras import make_perspective_camera as jcamera
from pbrt_tpu.core import transform as jtf
from pbrt_tpu.integrators import direct as jdirect
from pbrt_tpu.samplers.samplers import SamplerConfig as JSampler
from pbrt_tpu_torch import bridge
from pbrt_tpu_torch import film as tfm
from pbrt_tpu_torch import scene as tsc
from pbrt_tpu_torch.cameras import make_perspective_camera
from pbrt_tpu_torch.core import transform as ttf
from pbrt_tpu_torch.integrators import direct as tdirect
from pbrt_tpu_torch.samplers.samplers import SamplerConfig as TSampler
from test_torch_path import match_frac, mean_rel
from jax_traversal_jit import jit_jax_traversal  # noqa: F401  (autouse)
import test_torch_threads  # noqa: F401  (torch's threads under xdist)

RES = (16, 16)


def two_lights(sc, tf):
    """A matte floor, a glass sphere and two area lights, nsamples 1 and 2."""
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


def three_lights(sc, tf):
    """two_lights' kind with plastic, nsamples 1 and 3, and a point light."""
    b = sc.SceneBuilder()
    matte = b.add_material(sc.MAT_MATTE, kd=(0.5, 0.6, 0.7))
    plastic = b.add_material(sc.MAT_PLASTIC, kd=(0.4, 0.2, 0.2),
                             ks=(0.4, 0.4, 0.4), roughness=0.05)
    glass = b.add_material(sc.MAT_GLASS, eta=1.5, roughness=0.0)
    b.add_triangle_mesh([[0, 1, 2], [2, 3, 0]],
                        [[-10, -10, 0], [10, -10, 0], [10, 10, 0], [-10, 10, 0]],
                        material=matte)
    b.add_sphere(tf.translate(-1.2, 0, 1), 1.0, material=plastic)
    b.add_sphere(tf.translate(1.3, -0.5, 0.8), 0.8, material=glass)
    b.add_emissive_sphere(tf.translate(0, 4, 6), 0.6, L=(30.0, 30.0, 30.0),
                          material=matte, n_samples=1)
    b.add_emissive_sphere(tf.translate(-4, -2, 3), 0.3, L=(60.0, 40.0, 20.0),
                          material=matte, n_samples=3)
    b.add_point_light(tf.translate(3, -3, 5), (10.0, 10.0, 10.0))
    return b


def _render_both(make, sampler, cfg_kw, counts):
    j = make(jsc, jtf).build()
    ts = bridge.scene_from_numpy(bridge.as_numpy_fields(j), "cpu")
    assert tdirect.light_sample_counts(ts, TSampler(sampler, 1, RES)) == counts
    jc = jcamera(jtf.look_at([0, -7, 4], [0, 0, 1], [0, 0, 1]), RES, fov_deg=45.0)
    tc = bridge.camera_from_numpy(bridge.as_numpy_fields(jc), "cpu")
    ref = np.asarray(jdirect.render(
        j, jc, jfm.FilmConfig(full_resolution=RES), JSampler(sampler, 2, RES),
        jdirect.DirectLightingConfig(**cfg_kw)))
    got, rays = tdirect.render(
        ts, tc, tfm.FilmConfig(full_resolution=RES), TSampler(sampler, 2, RES),
        tdirect.DirectLightingConfig(**cfg_kw), count_rays=True, device="cpu")
    got = got.numpy()
    assert np.isfinite(got).all() and got.mean() > 0 and rays > 2 * RES[0] * RES[1]
    assert match_frac(ref, got) >= 0.995
    assert mean_rel(ref, got) <= 5e-3


@pytest.mark.parametrize("strategy,depth", [("one", 2), ("all", 1)])
def test_li_direct_matches_jax(strategy, depth):
    _render_both(two_lights, "halton", dict(max_depth=depth, strategy=strategy),
                 (1, 2))


@pytest.mark.slow
def test_li_direct_all_matches_jax_deep():
    _render_both(three_lights, "sobol", dict(max_depth=3, strategy="all"),
                 (1, 4, 1))


def test_all_equals_one_in_mean_on_the_furnace():
    """tests/test_render_analytic.py:179: an interior point light at the
    centre of a matte (kd 0.5) sphere, seen from inside: 0.5 either way."""
    b = tsc.SceneBuilder()
    m = b.add_material(tsc.MAT_MATTE, kd=(0.5, 0.5, 0.5), sigma=0.0)
    b.add_sphere(ttf.identity(), 1.0, material=m)
    b.add_point_light(ttf.identity(), (np.pi, np.pi, np.pi))
    scene = b.build(device="cpu")
    cam = make_perspective_camera(ttf.look_at([0, 0, 0], [0, 0, 1], [0, 1, 0]),
                                  RES, fov_deg=45.0)
    means = []
    for strategy in ("one", "all"):
        img = tdirect.render(scene, cam, tfm.FilmConfig(full_resolution=RES),
                             TSampler("sobol", 8, RES),
                             tdirect.DirectLightingConfig(1, strategy),
                             device="cpu")
        means.append(float(img.mean()))
    assert abs(means[0] - 0.5) < 0.02 and abs(means[1] - 0.5) < 0.02
