"""The spectral render mode (integrators/spectral.py, with
core/sampled_spectrum.py's lift) and the animated-transform library
(core/animated.py) against the JAX package on the CPU.

Bars: the lifted spectra bit for bit (float64 numpy, the same operations);
the 8x8 spectral render, every pixel to rtol 1e-3 and 95% of them to
rtol 1e-5 with atol 1e-6 (the JAX package's XLA loop tests the floor's
triangles watertight, the BVH kernel's plain version with Moller-Trumbore,
and XLA:CPU and torch sum the 60 bins of the XYZ projection in different
orders); the furnace
as tests/test_spectrum_sampled.py holds the JAX package's (the RGB render
within 0.03 of 1 - 0.5^6, the spectral render within 0.08 of it, the
channels within 1.35 of each other); the animated transforms' host
decomposition bit for bit, their interpolation outside the shutter (the
keyframes) bit for bit and inside it to rtol 1e-5 with atol 1e-6 (the
slerp's arccos, sin and cos differ in the last bit between XLA and
torch), the inverse and the motion bounds to 1e-5."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu import film as jfm
from pbrt_tpu import scene as jsc
from pbrt_tpu.cameras import make_perspective_camera as jcamera
from pbrt_tpu.core import animated as jan
from pbrt_tpu.core import sampled_spectrum as jss
from pbrt_tpu.core import transform as jtf
from pbrt_tpu.integrators import spectral as jsp
from pbrt_tpu.samplers.samplers import SamplerConfig as JSampler
from pbrt_tpu_torch import bridge
from pbrt_tpu_torch import film as tfm
from pbrt_tpu_torch import scene as tsc
from pbrt_tpu_torch.cameras import make_perspective_camera as tcamera
from pbrt_tpu_torch.core import animated as tan
from pbrt_tpu_torch.core import sampled_spectrum as tss
from pbrt_tpu_torch.core import transform as ttf
from pbrt_tpu_torch.integrators import path as tpath
from pbrt_tpu_torch.integrators import spectral as tsp
from pbrt_tpu_torch.samplers.samplers import SamplerConfig as TSampler
from jax_traversal_jit import jit_jax_traversal  # noqa: F401  (autouse)
import test_torch_threads  # noqa: F401  (torch's threads under xdist)

RES = (8, 8)


def _scene(sc, tf):
    b = sc.SceneBuilder()
    m = b.add_material(sc.MAT_MATTE, kd=(0.6, 0.4, 0.2), sigma=0.0)
    b.add_sphere(tf.identity(), 1.0, material=m)
    g = b.add_material(sc.MAT_MATTE, kd=(0.2, 0.5, 0.7))
    b.add_triangle_mesh([[0, 1, 2], [2, 3, 0]],
                        [[-3, -0.8, -3], [3, -0.8, -3], [3, -0.8, 3], [-3, -0.8, 3]],
                        material=g)
    b.add_point_light(tf.translate(0.2, 0.3, 0.1), (2.0, 3.0, 4.0))
    e = b.add_material(sc.MAT_MATTE, kd=(0.0, 0.0, 0.0))
    b.add_emissive_sphere(tf.translate(0.0, 0.4, 0.5), 0.2, L=(3.0, 2.0, 1.0),
                          material=e)
    return b


def test_lift_and_spectral_render_match_jax():
    j = _scene(jsc, jtf).build()
    t = bridge.scene_from_numpy(bridge.as_numpy_fields(j), "cpu")
    for ref, got in zip(jsp.lift_scene_spectra(j, 60), tsp.lift_scene_spectra(t, 60)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    rgb = np.random.RandomState(0).rand(16, 3)
    for kind in ("reflectance", "illuminant"):
        np.testing.assert_array_equal(tss.from_rgb(rgb, kind, 60), jss.from_rgb(rgb, kind, 60))
    jc = jcamera(jtf.look_at([0, 0.2, -0.5], [0, 0, 1], [0, 1, 0]), RES, fov_deg=60.0)
    tc = bridge.camera_from_numpy(bridge.as_numpy_fields(jc), "cpu")
    ref = np.asarray(jsp.render(j, jc, jfm.FilmConfig(full_resolution=RES),
                                JSampler("sobol", 2, RES), jsp.SpectralConfig(max_depth=3)))
    got = tsp.render(t, tc, tfm.FilmConfig(full_resolution=RES), TSampler("sobol", 2, RES),
                     tsp.SpectralConfig(max_depth=3), device="cpu").numpy()
    assert got.shape == (RES[1], RES[0], 3) and got.mean() > 0
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-6)
    assert np.all(np.isclose(got, ref, rtol=1e-5, atol=1e-6), -1).mean() >= 0.95


def test_spectral_furnace_matches_rgb():
    """tests/test_spectrum_sampled.py's furnace: a matte sphere seen from
    inside, lit by a point light at its centre."""
    res = (12, 12)
    b = tsc.SceneBuilder()
    m = b.add_material(tsc.MAT_MATTE, kd=(0.5, 0.5, 0.5), sigma=0.0)
    b.add_sphere(ttf.identity(), 1.0, material=m)
    b.add_point_light(ttf.identity(), (np.pi, np.pi, np.pi))
    scene = b.build(device="cpu")
    cam = tcamera(ttf.look_at([0, 0, 0], [0, 0, 1], [0, 1, 0]), res, fov_deg=60.0)
    film = tfm.FilmConfig(full_resolution=res)
    scfg = TSampler("sobol", 16, res)
    img_rgb = tpath.render(scene, cam, film, scfg, tpath.PathConfig(max_depth=6),
                           device="cpu").numpy()
    img_spec = tsp.render(scene, cam, film, scfg, tsp.SpectralConfig(max_depth=6),
                          device="cpu").numpy()
    expected = 1.0 - 0.5 ** 6
    assert abs(img_rgb.mean() - expected) < 0.03
    assert abs(img_spec.mean() - img_rgb.mean()) < 0.08
    ch = img_spec.reshape(-1, 3).mean(0)
    assert ch.max() / max(ch.min(), 1e-6) < 1.35, ch


def test_spectral_scope_refusals():
    cam = tcamera(ttf.look_at([0, 0, -3], [0, 0, 0], [0, 1, 0]), (4, 4))
    film = tfm.FilmConfig(full_resolution=(4, 4))
    scfg = TSampler("sobol", 1, (4, 4))
    cases = (
        (lambda b: b.add_material(tsc.MAT_PLASTIC), None, "material type"),
        (lambda b: b.add_material(tsc.MAT_MATTE, sigma=20.0), None, "sigma"),
        (lambda b: b.add_material(tsc.MAT_MATTE),
         lambda b: b.add_distant_light((0, 0, 1), (1, 1, 1)), "light type"),
    )
    for mat, light, what in cases:
        b = tsc.SceneBuilder()
        b.add_sphere(ttf.identity(), 1.0, material=mat(b))
        (light or (lambda b: b.add_point_light(ttf.translate(0, 0, -2), (1, 1, 1))))(b)
        with pytest.raises(NotImplementedError, match=what):
            tsp.render(b.build(device="cpu"), cam, film, scfg, device="cpu")


def _trs(tf, tx, ty, tz, deg, ax, ay, az, s):
    return tf.translate(tx, ty, tz).m @ tf.rotate(deg, ax, ay, az).m @ tf.scale(s, s, s).m


def test_animated_matches_jax():
    rs = np.random.RandomState(4)
    times = rs.uniform(-0.2, 1.2, 257).astype(np.float32)
    for k in range(4):
        args = [(*rs.uniform(-3, 3, 3), rs.uniform(-170, 170), *rs.normal(size=3),
                 rs.uniform(0.3, 2.0)) for _ in range(2)]
        m0, m1 = (_trs(jtf, *a) for a in args)
        np.testing.assert_array_equal(_trs(ttf, *args[0]), m0)
        for ref, got in zip(jan.decompose(m1), tan.decompose(m1)):
            np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(tan.quat_from_matrix(m0), jan.quat_from_matrix(m0))
        t0, t1 = (0.0, 1.0) if k % 2 else (0.25, 0.75)
        ja, ta = jan.make_animated(m0, m1, t0, t1), tan.make_animated(m0, m1, t0, t1)
        assert tan.is_animated(m0, m1) and not tan.is_animated(m0, m0.copy())
        ref = np.asarray(jan.interpolate(ja, jnp.asarray(times)))
        got = tan.interpolate(ta, torch.as_tensor(times)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
        out = (times <= t0) | (times >= t1)
        assert out.any()
        np.testing.assert_array_equal(got[out], ref[out])
        np.testing.assert_allclose(
            tan.interpolate_inverse(ta, torch.as_tensor(times)).numpy(),
            np.asarray(jan.interpolate_inverse(ja, jnp.asarray(times))),
            rtol=1e-5, atol=1e-5)
        for ref, got in zip(jan.motion_bounds(ja, [-1, 0, -2], [1, 2, 0.5]),
                            tan.motion_bounds(ta, [-1, 0, -2], [1, 2, 0.5])):
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
        q = rs.normal(size=(5, 4)).astype(np.float32)
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        np.testing.assert_allclose(tan.quat_to_matrix(torch.as_tensor(q)).numpy(),
                                   np.asarray(jan.quat_to_matrix(jnp.asarray(q))),
                                   rtol=1e-6, atol=1e-7)
