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
from jax_traversal_jit import jit_jax_traversal  # noqa: F401  (autouse)
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


def test_camera_importance_matches_jax():
    """camera_pdf_we and camera_sample_wi (perspective.cpp:185-260) on
    seeded rays and points, on and off the film.  The JAX package inverts
    camera_to_world and raster_to_camera in float32 on each call, the port
    in float64 once a call: they agree to rtol 1e-4 (atol 1e-6), on_film
    flags on all but lanes at the film's edge."""
    look = ([0, -8, 4], [0, 0, 2], [0, 0, 1])
    jc = jcam.make_perspective_camera(jtf.look_at(*look), (24, 16), fov_deg=50.0)
    tc = tcam.make_perspective_camera(ttf.look_at(*look), (24, 16), fov_deg=50.0)
    rs = np.random.RandomState(8)
    n = 2000
    d = (np.array([0.0, 8.0, -2.0]) + rs.randn(n, 3) * 3.0).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.tile(np.float32([[0, -8, 4]]), (n, 1))
    ref = jcam.camera_pdf_we(jc, jnp.asarray(o), jnp.asarray(d))
    got = tcam.camera_pdf_we(tc, torch.as_tensor(o), torch.as_tensor(d))
    for a, b in zip(ref, got):
        assert (np.asarray(a) > 0).mean() > 0.2 and (np.asarray(a) == 0).mean() > 0.2
        assert ((np.asarray(a) > 0) == (b.numpy() > 0)).mean() >= 0.995
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4, atol=1e-6)
    p = (rs.randn(n, 3) * np.array([4.0, 3.0, 2.0]) + [0, 2, 1]).astype(np.float32)
    ref = jcam.camera_sample_wi(jc, jnp.asarray(p))
    got = tcam.camera_sample_wi(tc, torch.as_tensor(p))
    both_on = np.asarray(ref["valid"]) & got["valid"].numpy()
    assert (np.asarray(ref["valid"]) == got["valid"].numpy()).mean() >= 0.995
    assert both_on.mean() > 0.3
    for k in ("wi", "p_cam"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-5,
                                   atol=1e-6)
    for k in ("pdf", "we", "p_raster"):
        np.testing.assert_allclose(got[k].numpy()[both_on], np.asarray(ref[k])[both_on],
                                   rtol=1e-4, atol=1e-6)


def test_add_splats_bit_equal():
    """add_splats (film.cpp:142) and to_image's splat_scale against the
    JAX package's, bit for bit: a pixel's splats added in the call's order
    (many onto a few pixels, as MLT's pile onto bright ones), lanes off the
    film or not finite dropped."""
    res = (12, 10)
    rs = np.random.RandomState(4)
    n = 3000
    p_film = (rs.rand(n, 2) * np.array([14.0, 12.0]) - 1.0).astype(np.float32)
    p_film[: n // 2] = (rs.rand(n // 2, 2) * 2.0 + 4.0).astype(np.float32)
    v = (rs.rand(n, 3) * 3).astype(np.float32)
    v[::7] = 0.0
    v[5] = np.inf
    jst = jfm.make_film_state(jfm.FilmConfig(full_resolution=res), jmake_filter("box"))
    tst = tfm.make_film_state(tfm.FilmConfig(full_resolution=res),
                              tmake_filter("box"), "cpu")
    ranks = tfm.add_splats.ranks
    for lo, hi in ((0, n // 3), (n // 3, n)):
        jst = jfm.add_splats(jst, jnp.asarray(p_film[lo:hi]), jnp.asarray(v[lo:hi]))
        tfm.add_splats(tst, torch.as_tensor(p_film[lo:hi]), torch.as_tensor(v[lo:hi]))
    assert tfm.add_splats.ranks - ranks > 20
    np.testing.assert_array_equal(np.asarray(jst.splat), tst.splat.numpy())
    np.testing.assert_array_equal(
        np.asarray(jfm.to_image(jst, scale=2.0, splat_scale=0.25)),
        tfm.to_image(tst, scale=2.0, splat_scale=0.25).numpy())


def test_pss_draws_bit_equal():
    """The "pss" passthrough (samplers.py:229-237, :286-289): dims of the
    vector, and the counter hash past it (one value for every lane)."""
    rs = np.random.RandomState(2)
    x = rs.rand(64, 12).astype(np.float32)
    jc = jsa.SamplerConfig("pss", 1, RES)
    tc = tsa.SamplerConfig.pss(RES)
    js = {"x": jnp.asarray(x), "chain_key": jnp.uint32(7932)}
    ts = {"x": torch.as_tensor(x), "chain_key": 7932}
    for dim in (0, 3, 11, 12, 40, 221):
        np.testing.assert_array_equal(
            _bits(jnp.broadcast_to(jsa.get_1d(jc, js, dim), (64,))),
            _bits(tsa.get_1d(tc, ts, dim).numpy()))
    # (a 2-D draw across the vector's end is ragged in the JAX package)
    for dim in (2, 10, 30):
        np.testing.assert_array_equal(
            _bits(jnp.broadcast_to(jsa.get_2d(jc, js, dim), (64, 2))),
            _bits(tsa.get_2d(tc, ts, dim).numpy()))
    ref = jsa.get_camera_sample(jc, js, jnp.zeros((64, 2), jnp.int32))
    got = tsa.get_camera_sample(tc, ts, torch.zeros((64, 2), dtype=torch.int32))
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(_bits(a), _bits(b.numpy()))
