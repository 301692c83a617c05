"""The port's Distribution2D and infinite light (pbrt_tpu_torch.core.sampling,
pbrt_tpu_torch.lights.lights) held against the JAX package on shared inputs,
and the constant-environment furnace of tests/test_env_light.py:14.

Bars: the host tables are numpy in both packages and bit-equal; the
Distribution2D sample is bit-equal in its cell indices and within rtol
1e-6 in its values and pdf (the 1-D version's bar, tests/test_torch_core.py).
sample_li, pdf_li and escaped_radiance: tests/test_torch_shading.py's bar
(rtol 1e-5, atol 1e-6 on 99.9% of lanes, rtol 1e-3 on all): XLA:CPU's
sin, cos, acos and atan2 differ from torch's in the last bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu import scene as jsc
from pbrt_tpu.accel import traverse as jtv
from pbrt_tpu.core import sampling as jsmp
from pbrt_tpu.core import transform as jtf
from pbrt_tpu.lights import lights as jlt
from pbrt_tpu_torch import bridge
from pbrt_tpu_torch import film as tfm
from pbrt_tpu_torch import scene as tsc
from pbrt_tpu_torch.cameras import make_perspective_camera
from pbrt_tpu_torch.core import sampling as tsmp
from pbrt_tpu_torch.core import transform as ttf
from pbrt_tpu_torch.integrators import path as tpath
from pbrt_tpu_torch.lights import lights as tlt
from pbrt_tpu_torch.samplers.samplers import SamplerConfig as TSampler
from test_torch_shading import _close, _unit, assert_lanes_close
from jax_traversal_jit import jit_jax_traversal  # noqa: F401  (autouse)
import test_torch_threads  # noqa: F401  (torch's threads under xdist)

N = 4000


def test_distribution2d_matches():
    rs = np.random.RandomState(0)
    f = rs.rand(7, 11) * (rs.rand(7, 11) < 0.7)
    f[2] = 0.0  # an all-zero row takes the uniform CDF
    jd = jsmp.build_distribution_2d(f)
    host = tsmp.build_distribution_2d_np(f)
    for k in tsmp.DISTRIBUTION_2D_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jd, k)), host[k], err_msg=k)
    td = tsmp.distribution_2d_from_numpy(host, "cpu")
    u = rs.rand(N, 2).astype(np.float32)
    u[:3] = [[0.0, 0.0], [0.999999, 0.999999], [0.5, 0.0]]
    ref_uv, ref_pdf = jsmp.sample_continuous_2d(jd, jnp.asarray(u))
    got_uv, got_pdf = tsmp.sample_continuous_2d(td, torch.as_tensor(u))
    ref_uv, got_uv = np.asarray(ref_uv), got_uv.numpy()
    np.testing.assert_array_equal(np.floor(ref_uv * [11, 7]), np.floor(got_uv * [11, 7]))
    np.testing.assert_allclose(got_uv, ref_uv, rtol=1e-6)
    np.testing.assert_allclose(got_pdf.numpy(), np.asarray(ref_pdf), rtol=1e-6)
    p = rs.rand(N, 2).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(jsmp.pdf_2d(jd, jnp.asarray(p))),
        tsmp.pdf_2d(td, torch.as_tensor(p)).numpy())


def _env_image(h=16, w=32):
    rs = np.random.RandomState(1)
    return (rs.rand(h, w, 3) * np.array([1.0, 2.0, 0.5])).astype(np.float32)


def env_scene(sc, tf, with_map=True):
    """A matte floor, an emissive sphere, a constant infinite light and, with
    a map, a rotated env-map light."""
    b = sc.SceneBuilder()
    m = b.add_material(sc.MAT_MATTE, kd=(0.6, 0.5, 0.4))
    b.add_triangle_mesh([[0, 1, 2], [2, 3, 0]],
                        [[-10, -10, 0], [10, -10, 0], [10, 10, 0], [-10, 10, 0]],
                        material=m)
    b.add_emissive_sphere(tf.translate(0, 2, 3), 0.5, L=(4.0, 4.0, 4.0),
                          material=m)
    b.add_infinite_light(L=(0.2, 0.3, 0.4))
    if with_map:
        b.add_infinite_light(L=(1.0, 1.0, 1.0), image=_env_image(),
                             world_to_light=tf.rotate(30.0, 1.0, 1.0, 0.0).m)
    return b


@pytest.mark.parametrize("with_map", [True, False], ids=["map", "constant"])
def test_builder_env_payload_bit_equal(with_map):
    ref = bridge.as_numpy_fields(env_scene(jsc, jtf, with_map).build())["lights"]
    got = env_scene(tsc, ttf, with_map).build_numpy()["lights"]
    for k in tsc.LIGHT_FIELDS + tsc.ENV_FIELDS + ("env_light_idx",):
        np.testing.assert_array_equal(np.asarray(ref[k]), got[k], err_msg=k)
    for k in tsmp.DISTRIBUTION_2D_FIELDS:
        np.testing.assert_array_equal(ref["env_distr"][k], got["env_distr"][k],
                                      err_msg=k)


def _both(with_map):
    j = env_scene(jsc, jtf, with_map).build()
    return jtv._device_scene(j), bridge.scene_from_numpy(
        bridge.as_numpy_fields(j), "cpu")


@pytest.mark.parametrize("with_map", [True, False], ids=["map", "constant"])
def test_infinite_sample_li_pdf_li_escaped_match(with_map):
    js, ts = _both(with_map)
    assert ts.env_light_idx == (2 if with_map else -1)
    rs = np.random.RandomState(2)
    n_lights = ts.lights.light_type.shape[0]
    idx = rs.randint(0, n_lights, N).astype(np.int32)
    idx[: N // 2] = n_lights - 1  # half on the last infinite light
    ref_p = (rs.randn(N, 3) * 2.0 + [0, 0, 1]).astype(np.float32)
    u = rs.rand(N, 2).astype(np.float32)
    ref = jlt.sample_li(js, jnp.asarray(idx), jnp.asarray(ref_p), jnp.asarray(u),
                        ts.light_types)
    got = tlt.sample_li(ts, torch.as_tensor(idx), torch.as_tensor(ref_p),
                        torch.as_tensor(u), ts.light_types)
    _close(ref, got, ("wi", "li", "pdf", "p_light", "is_delta"))
    assert (got["pdf"][: N // 2] > 0).all()

    wi = np.where(rs.rand(N, 1) < 0.5, got["wi"].numpy(), _unit(rs, N))
    ref = jlt.pdf_li(js, jnp.asarray(idx), jnp.asarray(ref_p), jnp.asarray(wi),
                     ts.light_types)
    got_pdf = tlt.pdf_li(ts, torch.as_tensor(idx), torch.as_tensor(ref_p),
                         torch.as_tensor(wi), ts.light_types)
    assert_lanes_close(ref, got_pdf, "pdf_li")
    # pdf_li agrees with the pdf sample_li gave for its own direction
    same = slice(0, N // 2)
    np.testing.assert_allclose(
        tlt.pdf_li(ts, torch.as_tensor(idx[same]), torch.as_tensor(ref_p[same]),
                   got["wi"][same], ts.light_types).numpy(),
        got["pdf"][same].numpy(), rtol=2e-2 if with_map else 1e-6)

    d = _unit(rs, N)
    ref = jlt.escaped_radiance(js, jnp.asarray(d), ts.light_types)
    got = tlt.escaped_radiance(ts, torch.as_tensor(d), ts.light_types)
    assert_lanes_close(ref, got, "escaped_radiance")
    assert (got > 0).all()


def test_constant_env_furnace_plane():
    """A matte plane (kd 0.6) under a constant environment of L = 1 reflects
    0.6 (tests/test_env_light.py:14, its scene, sampler and bar)."""
    b = tsc.SceneBuilder()
    m = b.add_material(tsc.MAT_MATTE, kd=(0.6, 0.6, 0.6))
    b.add_triangle_mesh([[0, 1, 2], [2, 3, 0]],
                        [[-50, 0, -50], [50, 0, -50], [50, 0, 50], [-50, 0, 50]],
                        material=m)
    b.add_infinite_light(L=(1.0, 1.0, 1.0))
    scene = b.build(device="cpu")
    cam = make_perspective_camera(ttf.look_at([0, 5, 0.01], [0, 0, 0], [0, 1, 0]),
                                  (8, 8), fov_deg=30.0)
    img = tpath.render(scene, cam, tfm.FilmConfig(full_resolution=(8, 8)),
                       TSampler("sobol", 64, (8, 8)), tpath.PathConfig(max_depth=3),
                       device="cpu")
    np.testing.assert_allclose(float(img.mean()), 0.6, atol=0.03)
