"""Port samplers, camera and film against the JAX package: sample values
bit-equal, rays and film sums to rtol 1e-6."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu import film as jfm
from pbrt_tpu.cameras import cameras as jcam
from pbrt_tpu.core import transform as jtf
from pbrt_tpu.filters import make_filter as jmake_filter
from pbrt_tpu.samplers import samplers as jsa
from pbrt_tpu_torch import film as tfm
from pbrt_tpu_torch.cameras import cameras as tcam
from pbrt_tpu_torch.core import transform as ttf
from pbrt_tpu_torch.filters import make_filter as tmake_filter
from pbrt_tpu_torch.samplers import samplers as tsa
import test_torch_threads  # noqa: F401  (torch's threads under xdist)

RES = (16, 16)
SPP = 4


def _pixels():
    xs, ys = np.meshgrid(np.arange(RES[0]), np.arange(RES[1]))
    return np.stack([xs.ravel(), ys.ravel()], -1).astype(np.int32)


def _states(name, s):
    pix = _pixels()
    n = pix.shape[0]
    jc, tc = jsa.SamplerConfig(name, SPP, RES), tsa.SamplerConfig(name, SPP, RES)
    js = jsa.init_state(jc, jnp.asarray(pix), jnp.full((n,), s, jnp.uint32))
    ts = tsa.init_state(tc, torch.as_tensor(pix), torch.full((n,), s))
    return jc, js, tc, ts, pix


def _bits(x):
    return np.asarray(x).view(np.uint32)


@pytest.mark.parametrize("name", ["halton", "sobol"])
def test_get_1d_2d_bit_equal(name):
    for s in range(SPP):
        jc, js, tc, ts, _ = _states(name, s)
        for dim in range(46):
            np.testing.assert_array_equal(
                _bits(jsa.get_1d(jc, js, dim)), _bits(tsa.get_1d(tc, ts, dim).numpy()),
                err_msg=f"{name} sample {s} dim {dim}")
        for dim in (0, 3, 5, 13, 40, 44):
            np.testing.assert_array_equal(
                _bits(jsa.get_2d(jc, js, dim)), _bits(tsa.get_2d(tc, ts, dim).numpy()))


@pytest.mark.parametrize("name", ["halton", "sobol"])
def test_camera_sample_bit_equal(name):
    jc, js, tc, ts, pix = _states(name, 2)
    ref = jsa.get_camera_sample(jc, js, jnp.asarray(pix))
    got = tsa.get_camera_sample(tc, ts, torch.as_tensor(pix))
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(_bits(a), _bits(b.numpy()))


def test_halton_table_rows_equal_get_1d():
    _, _, tc, ts, _ = _states("halton", 1)
    tab = tsa.halton_table(tc, ts, 12)
    for dim in range(12):
        assert torch.equal(tab[dim], tsa.get_1d(tc, ts, dim))


def test_other_samplers_refused():
    """The samplers the JAX package renders with are ported
    (tests/test_torch_imaging.py holds their draws); what it refuses or
    keeps for MLT (pss) the port refuses."""
    for name in ("random", "stratified", "zerotwosequence", "maxmin"):
        assert tsa.SamplerConfig(name, 4, RES).name == name
    for name in ("pss", "maxmindist"):
        with pytest.raises(NotImplementedError):
            tsa.SamplerConfig(name, 4, RES)


@pytest.mark.parametrize("res,fov,lens", [((16, 16), 45.0, 0.0),
                                          ((24, 12), 60.0, 0.0),
                                          ((16, 16), 45.0, 0.2)])
def test_perspective_rays_match(res, fov, lens):
    kw = dict(fov_deg=fov, lens_radius=lens, focal_distance=5.0)
    jc = jcam.make_perspective_camera(jtf.look_at([0, -8, 4], [0, 0, 2], [0, 0, 1]),
                                      res, **kw)
    tc = tcam.make_perspective_camera(ttf.look_at([0, -8, 4], [0, 0, 2], [0, 0, 1]),
                                      res, **kw)
    np.testing.assert_array_equal(np.asarray(jc.raster_to_camera),
                                  tc.raster_to_camera.numpy())
    rs = np.random.RandomState(0)
    p_film = (rs.rand(500, 2) * np.array(res)).astype(np.float32)
    p_lens = rs.rand(500, 2).astype(np.float32)
    time_u = rs.rand(500).astype(np.float32)
    ref = jcam.generate_rays(jc, jnp.asarray(p_film), jnp.asarray(p_lens),
                             jnp.asarray(time_u))
    got = tcam.generate_rays(tc, torch.as_tensor(p_film), torch.as_tensor(p_lens),
                             torch.as_tensor(time_u))
    for a, b in zip(ref, got):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-6, atol=1e-6)


def test_add_samples_to_image_match():
    res = (12, 10)
    rs = np.random.RandomState(3)
    n = 3000
    p_film = (rs.rand(n, 2) * np.array(res)).astype(np.float32)
    p_film[:5] = [[0.5, 0.5], [3.0, 4.0], [11.99, 9.99], [0.0, 0.0], [6.5, 2.0]]
    L = (rs.rand(n, 3) * 2).astype(np.float32)
    L[7] = np.nan
    w = rs.rand(n).astype(np.float32)
    jst = jfm.make_film_state(jfm.FilmConfig(full_resolution=res), jmake_filter("box"))
    jst = jfm.add_samples(jst, jnp.asarray(p_film), jnp.asarray(L), jnp.asarray(w))
    tst = tfm.make_film_state(tfm.FilmConfig(full_resolution=res),
                              tmake_filter("box"), "cpu")
    tst = tfm.add_samples(tst, torch.as_tensor(p_film), torch.as_tensor(L),
                          torch.as_tensor(w))
    np.testing.assert_allclose(np.asarray(jst.weight_sum), tst.weight_sum.numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(jst.weighted_sum),
                               tst.weighted_sum.numpy(), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(jfm.to_image(jst, scale=2.0)),
                               tfm.to_image(tst, scale=2.0).numpy(), rtol=1e-6)


def test_crop_window_and_other_filters():
    cfg = tfm.FilmConfig(full_resolution=(20, 10), crop_window=(0.25, 0.75, 0.0, 0.5))
    assert cfg.cropped_pixel_bounds == jfm.FilmConfig(
        full_resolution=(20, 10), crop_window=(0.25, 0.75, 0.0, 0.5)).cropped_pixel_bounds
    for name in ("triangle", "gaussian", "mitchell", "sinc", "lanczossinc"):
        assert tmake_filter(name).radius == jmake_filter(name).radius
    with pytest.raises(ValueError, match="unknown filter"):
        tmake_filter("blackman")
