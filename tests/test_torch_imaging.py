"""Image formation in the port against the JAX package, on the CPU: the
vectorised PCG32, the random, stratified, zerotwosequence and maxmin
samplers, the exact mode's host tables, the triangle, gaussian, mitchell
and sinc filters, the film under overlapping footprints, and the
orthographic, environment and realistic cameras.

Bars: PCG32 streams, sampler draws, exact tables, filter LUTs and film
sums bit for bit (the film adds each pixel's contributions in XLA:CPU's
scatter order, tests/test_torch_sampling_film.py held it at rtol 1e-6);
the exact tables also bit for bit against pbrt-v3's own dumps where
tests/test_sampler_goldens.py compares the JAX package's.  Camera rays
and weights to rtol 1e-5 with atol 1e-6: the transcendental functions of
XLA and torch differ in the last bit, and the realistic camera's lens walk
compounds a few of them.  The JAX package's own test_realistic_camera_focus
holds its camera to a focus within 0.4 of the focus distance and at least
30% of the lanes unvignetted, a check held here on the port's camera too."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu import film as jfm
from pbrt_tpu.cameras import cameras as jcam
from pbrt_tpu.cameras import realistic as jreal
from pbrt_tpu.core import rng as jrng
from pbrt_tpu.core import transform as jtf
from pbrt_tpu.filters import make_filter as jmake_filter
from pbrt_tpu.integrators.path import make_pixel_grid
from pbrt_tpu.samplers import exact_tables as jxt
from pbrt_tpu.samplers import samplers as jsa
from pbrt_tpu_torch import bridge
from pbrt_tpu_torch import film as tfm
from pbrt_tpu_torch.cameras import cameras as tcam
from pbrt_tpu_torch.cameras import realistic as treal
from pbrt_tpu_torch.core import rng as trng
from pbrt_tpu_torch.core import transform as ttf
from pbrt_tpu_torch.filters import make_filter as tmake_filter
from pbrt_tpu_torch.samplers import exact_tables as txt
from pbrt_tpu_torch.samplers import pixel_exact as tpx
from pbrt_tpu_torch.samplers import samplers as tsa
from pbrt_tpu_torch.core import lowdiscrepancy as ld
from test_sampler_goldens import GOLD, NUM1D, NUM2D, PIXELS, SPP as GOLD_SPP, STRIDE, _load
import test_torch_threads  # noqa: F401  (torch's threads under xdist)

NEW_SAMPLERS = ("random", "stratified", "zerotwosequence", "maxmin")
FILTERS = ("box", "triangle", "gaussian", "mitchell", "sinc")


def _bits(x):
    return np.asarray(x).view(np.uint32)


def test_pcg32_streams_bit_equal():
    seq = np.random.RandomState(0).randint(0, 2 ** 32, size=4096, dtype=np.uint64)
    js = jrng.make(jnp.asarray(seq.astype(np.uint32)))
    ts = trng.make(torch.as_tensor(seq.astype(np.int64)))
    for i in range(16):
        js, jb = jrng.next_uint32(js)
        ts, tb = trng.next_uint32(ts)
        np.testing.assert_array_equal(np.asarray(jb).astype(np.int64), tb.numpy(),
                                      err_msg=f"draw {i}")
        js, jf = jrng.next_float(js)
        ts, tf = trng.next_float(ts)
        np.testing.assert_array_equal(_bits(jf), _bits(tf.numpy()))


def _all_samples(res=(64, 64), spp=16):
    """Every (pixel, sample number) of a res image at spp, as lanes."""
    pix = np.repeat(make_pixel_grid(jfm.FilmConfig(full_resolution=res)), spp, 0)
    snum = np.tile(np.arange(spp), res[0] * res[1])
    return pix, snum


@pytest.mark.parametrize("name", NEW_SAMPLERS)
def test_sampler_draws_bit_equal(name):
    """A 64x64 image at 16 spp, all at once: the camera sample, then 1-D
    and 2-D draws at dims a path takes (the random sampler draws in call
    order, so both sides make the same calls in the same order)."""
    pix, snum = _all_samples()
    jc = jsa.SamplerConfig(name, 16, (64, 64), seed=5)
    tc = tsa.SamplerConfig(name, 16, (64, 64), seed=5)
    js = jsa.init_state(jc, jnp.asarray(pix), jnp.asarray(snum.astype(np.uint32)))
    ts = tsa.init_state(tc, torch.as_tensor(pix), torch.as_tensor(snum))
    for a, b in zip(jsa.get_camera_sample(jc, js, jnp.asarray(pix)),
                    tsa.get_camera_sample(tc, ts, torch.as_tensor(pix))):
        np.testing.assert_array_equal(_bits(a), _bits(b.numpy()))
    for dim in (5, 6, 8, 10, 12, 19, 40):
        np.testing.assert_array_equal(_bits(jsa.get_1d(jc, js, dim)),
                                      _bits(tsa.get_1d(tc, ts, dim).numpy()),
                                      err_msg=f"get_1d dim {dim}")
        np.testing.assert_array_equal(_bits(jsa.get_2d(jc, js, dim)),
                                      _bits(tsa.get_2d(tc, ts, dim).numpy()),
                                      err_msg=f"get_2d dim {dim}")


@pytest.mark.parametrize("name", ["stratified", "zerotwosequence", "maxmin"])
def test_dyn_draws_equal_the_static_ones(name):
    """The JAX package's lax.scan bounce body draws dims >= 5 through
    get_1d_dyn/get_2d_dyn; the port's unrolled bounces draw them through
    get_1d/get_2d at static dims, bit for bit the same values."""
    pix, snum = _all_samples()
    jc = jsa.SamplerConfig(name, 16, (64, 64))
    tc = tsa.SamplerConfig(name, 16, (64, 64))
    js = jsa.init_state(jc, jnp.asarray(pix), jnp.asarray(snum.astype(np.uint32)))
    ts = tsa.init_state(tc, torch.as_tensor(pix), torch.as_tensor(snum))
    for dim in (5, 7, 12, 26):
        d = jnp.int32(dim)
        np.testing.assert_array_equal(_bits(jsa.get_1d_dyn(jc, js, d)),
                                      _bits(tsa.get_1d(tc, ts, dim).numpy()))
        np.testing.assert_array_equal(_bits(jsa.get_2d_dyn(jc, js, d)),
                                      _bits(tsa.get_2d(tc, ts, dim).numpy()))


def test_samplers_the_port_refuses():
    for name in ("pss", "maxmindist", "lowdiscrepancy"):
        with pytest.raises(NotImplementedError, match=name):
            tsa.SamplerConfig(name, 4, (8, 8))


@pytest.mark.parametrize("name,spp", [("stratified", 4), ("zerotwosequence", 4),
                                      ("maxmin", 4)])
def test_pixel_exact_table_matches_jax(name, spp):
    """2x2 tiles, ragged at the right and the bottom: every sample's table
    at once equals the JAX package's table of that sample number."""
    pix = make_pixel_grid(jfm.FilmConfig(full_resolution=(24, 20)))
    got = txt.pixel_exact_table(name, pix, spp)
    assert got.shape == (spp, txt.N_PIXEL_TABLE_DIMS, pix.shape[0])
    for s in range(spp):
        np.testing.assert_array_equal(_bits(jxt.pixel_exact_table(name, pix, s, spp)),
                                      _bits(got[s]), err_msg=f"sample {s}")


@pytest.mark.parametrize("name", ["stratified", "zerotwosequence", "maxmindist",
                                  "random"])
def test_pixel_exact_stream_matches_pbrt(name):
    """The port's PixelSampler emulator against pbrt-v3's dumped stream
    (tests/test_sampler_goldens.py:_exact_stream, on the port's module)."""
    gold = _load(name)
    out = np.empty_like(gold)
    if name == "random":
        rng = tpx.PCG32(0)  # RandomSampler(SPP): rng(seed = 0)
        for i, (x, y) in enumerate(PIXELS):
            for s in range(GOLD_SPP):
                vals = [rng.uniform_float() for _ in range(STRIDE)]
                vals[0] = np.float32(np.float32(x) + vals[0])
                vals[1] = np.float32(np.float32(y) + vals[1])
                out[i, s] = vals
    else:
        n = NUM1D + 2 * NUM2D + 5
        s1, s2 = tpx.exact_pixel_tables(name, PIXELS, GOLD_SPP, n, n,
                                        strat_xy=(4, 4))
        for i, (x, y) in enumerate(PIXELS):
            for s in range(GOLD_SPP):
                cols = [np.float32(np.float32(x) + s2[i, 0, s, 0]),
                        np.float32(np.float32(y) + s2[i, 0, s, 1]),
                        s1[i, 0, s], s2[i, 1, s, 0], s2[i, 1, s, 1]]
                for d in range(NUM2D):
                    cols += [s2[i, 2 + d, s, 0], s2[i, 2 + d, s, 1]]
                cols += [s1[i, 1 + d, s] for d in range(NUM1D)]
                out[i, s] = cols
    np.testing.assert_array_equal(_bits(out), _bits(gold))


def test_halton_exact_table_matches_jax_and_pbrt():
    cfg_j = jsa.SamplerConfig("halton", GOLD_SPP, (64, 64))
    cfg_t = tsa.SamplerConfig("halton", GOLD_SPP, (64, 64))
    gold = _load("halton")
    for s in range(GOLD_SPP):
        got = txt.halton_exact_table(cfg_t, PIXELS, s, STRIDE)
        np.testing.assert_array_equal(
            _bits(jxt.halton_exact_table(cfg_j, PIXELS, s, STRIDE)), _bits(got))
        got[:, 0] += PIXELS[:, 0]  # pFilm = pixel + Get2D (sampler.cpp:46)
        got[:, 1] += PIXELS[:, 1]
        np.testing.assert_array_equal(_bits(got), _bits(gold[:, s]))
    # SampleDimension(index, dim) for dims 2..31, index 0..255
    dims = np.fromfile(GOLD / "halton_dims.f32", "<f4").reshape(32, 256)
    idx = np.arange(256, dtype=np.uint64)
    for dim in range(2, 32):
        v = txt._scrambled_radical_inverse_pbrt(dim, idx, ld.prime_permutation(dim))
        np.testing.assert_array_equal(_bits(v), _bits(dims[dim]), err_msg=f"dim {dim}")


@pytest.mark.parametrize("name,params", [
    ("box", {}), ("triangle", {}), ("gaussian", {}), ("mitchell", {}),
    ("sinc", {}), ("lanczossinc", {"tau": 2.0}),
    ("gaussian", {"xwidth": 1.5, "ywidth": 2.5, "alpha": 3.0}),
    ("mitchell", {"B": 0.5, "C": 0.25, "xwidth": 1.0}),
])
def test_filter_lut_bit_equal(name, params):
    jf, tf = jmake_filter(name, params), tmake_filter(name, params)
    assert jf.radius == tf.radius and jf.name == tf.name
    np.testing.assert_array_equal(_bits(jfm.build_filter_table(jf)),
                                  _bits(tfm.build_filter_table(tf)))


def _films(name, res):
    jf, tf = jmake_filter(name), tmake_filter(name)
    js = jfm.make_film_state(jfm.FilmConfig(full_resolution=res,
                                            filter_radius=jf.radius), jf)
    ts = tfm.make_film_state(tfm.FilmConfig(full_resolution=res,
                                            filter_radius=tf.radius), tf, "cpu")
    return js, ts


_jax_add_samples = jax.jit(jfm.add_samples)


def _add(js, ts, p_film, L, w):
    js = _jax_add_samples(js, jnp.asarray(p_film), jnp.asarray(L), jnp.asarray(w))
    tfm.add_samples(ts, torch.as_tensor(p_film), torch.as_tensor(L),
                    torch.as_tensor(w))
    return js, ts


def _assert_films_equal(js, ts):
    np.testing.assert_array_equal(_bits(js.weight_sum), _bits(ts.weight_sum.numpy()))
    np.testing.assert_array_equal(_bits(js.weighted_sum),
                                  _bits(ts.weighted_sum.numpy()))
    np.testing.assert_array_equal(_bits(jfm.to_image(js, scale=2.0)),
                                  _bits(tfm.to_image(ts, scale=2.0).numpy()))


@pytest.mark.parametrize("name", FILTERS)
def test_add_samples_one_and_two_in_a_footprint(name):
    """Two samples whose footprints do not overlap, then two whose
    footprints overlap each other's and the first two's, then a batch of
    3000 random samples twice, on pixel edges too."""
    res = (12, 10)
    js, ts = _films(name, res)
    apart = (np.array([[5.3, 4.6], [0.2, 9.5]], np.float32),
             np.array([[1.0, 2.0, 3.0], [0.0, 1.0, 0.5]], np.float32),
             np.array([0.7, 1.0], np.float32))
    js, ts = _add(js, ts, *apart)
    _assert_films_equal(js, ts)
    two = (np.array([[5.9, 4.1], [6.2, 5.0]], np.float32),
           np.array([[0.5, 0.25, 2.0], [3.0, 0.1, 0.2]], np.float32),
           np.array([1.0, 0.3], np.float32))
    js, ts = _add(js, ts, *two)
    _assert_films_equal(js, ts)
    rs = np.random.RandomState(3)
    p_film = (rs.rand(3000, 2) * np.array(res)).astype(np.float32)
    p_film[:5] = [[0.5, 0.5], [3.0, 4.0], [11.99, 9.99], [0.0, 0.0], [6.5, 2.0]]
    L = (rs.rand(3000, 3) * 2).astype(np.float32)
    L[7] = np.nan
    w = rs.rand(3000).astype(np.float32)
    for _ in range(2):
        js, ts = _add(js, ts, p_film, L, w)
    _assert_films_equal(js, ts)


def _unordered_box_scatter(state, p_film, L):
    """The film's scatter before wider filters came: every footprint cell
    of every sample, weight 0 where the box does not reach, clamped into
    the film, in one index_put_(accumulate=True)."""
    h, w = state.weight_sum.shape
    pd = p_film - 0.5
    p0 = torch.ceil(pd - 0.5).to(torch.int64)
    fo = torch.arange(2)
    px, py = p0[:, 0:1] + fo, p0[:, 1:2] + fo  # [N, 2]
    in_x = (px.float() - pd[:, 0:1]).abs() <= 0.5
    in_y = (py.float() - pd[:, 1:2]).abs() <= 0.5
    ix, iy = px[:, None, :], py[:, :, None]
    valid = (in_x[:, None, :] & in_y[:, :, None] & (ix >= 0) & (ix < w)
             & (iy >= 0) & (iy < h))
    wgt = torch.where(valid, 1.0, 0.0)
    flat = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).reshape(-1)
    state.weighted_sum.view(-1, 3).index_put_(
        (flat,), (wgt[..., None] * L[:, None, None, :]).reshape(-1, 3),
        accumulate=True)
    state.weight_sum.view(-1).index_put_((flat,), wgt.reshape(-1), accumulate=True)


def test_box_film_bit_equal_to_the_unordered_scatter():
    """With the box filter the ordered film equals the one
    index_put_(accumulate=True) scatter the film ran before (on the CPU
    that scatter adds in index order), over two batches of one sample per
    pixel with pixel edges among them, so a box render keeps its bits."""
    res = (16, 12)
    pix = make_pixel_grid(jfm.FilmConfig(full_resolution=res)).astype(np.float32)
    rs = np.random.RandomState(4)
    filt = tmake_filter("box")
    ts = tfm.make_film_state(tfm.FilmConfig(full_resolution=res), filt, "cpu")
    ref = tfm.make_film_state(tfm.FilmConfig(full_resolution=res), filt, "cpu")
    for _ in range(2):
        u = rs.rand(*pix.shape).astype(np.float32)
        u[::7] = 0.0
        p_film = torch.as_tensor(pix + u)
        L = torch.as_tensor(rs.rand(pix.shape[0], 3).astype(np.float32))
        tfm.add_samples(ts, p_film, L)
        _unordered_box_scatter(ref, p_film, L)
    assert torch.equal(ts.weight_sum, ref.weight_sum)
    assert torch.equal(ts.weighted_sum, ref.weighted_sum)


LOOK = ([0, -8, 4], [0, 0, 2], [0, 0, 1])


def _camera_batch(res, n=2000):
    rs = np.random.RandomState(0)
    return ((rs.rand(n, 2) * np.array(res)).astype(np.float32),
            rs.rand(n, 2).astype(np.float32), rs.rand(n).astype(np.float32))


def _assert_rays_close(ref, got):
    for a, b in zip(ref, got):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind,lens", [("orthographic", 0.0), ("orthographic", 0.3),
                                       ("environment", 0.0)])
def test_projective_and_environment_rays_match(kind, lens):
    res = (24, 16)
    if kind == "orthographic":
        jc = jcam.make_orthographic_camera(jtf.look_at(*LOOK), res, lens_radius=lens,
                                           focal_distance=4.0)
        tc = tcam.make_orthographic_camera(ttf.look_at(*LOOK), res, lens_radius=lens,
                                           focal_distance=4.0)
        np.testing.assert_array_equal(np.asarray(jc.raster_to_camera),
                                      tc.raster_to_camera.numpy())
    else:
        jc = jcam.make_environment_camera(jtf.look_at(*LOOK), res)
        tc = tcam.make_environment_camera(ttf.look_at(*LOOK), res)
    p_film, p_lens, time_u = _camera_batch(res)
    ref = jcam.generate_rays(jc, jnp.asarray(p_film), jnp.asarray(p_lens),
                             jnp.asarray(time_u))
    got = tcam.generate_rays(tc, torch.as_tensor(p_film), torch.as_tensor(p_lens),
                             torch.as_tensor(time_u))
    _assert_rays_close(ref, got)
    assert np.all(got[3].numpy() == 1.0)
    carried = bridge.camera_from_numpy(bridge.as_numpy_fields(jc), "cpu")
    assert carried.cam_type == tc.cam_type
    _assert_rays_close(ref, tcam.generate_rays(carried, torch.as_tensor(p_film),
                                               torch.as_tensor(p_lens),
                                               torch.as_tensor(time_u)))


REALISTIC_RES = (24, 16)


def _jax_realistic(cam):
    """The JAX package's RealisticParams holding the port camera's numbers."""
    lens = np.stack([cam.curvature, np.zeros_like(cam.curvature), cam.eta,
                     cam.aperture_r], -1).astype(np.float64)
    return jreal._to_params(lens, cam.element_z.astype(np.float64),
                            cam.exit_pupil.numpy(), cam.film_diag,
                            c2w=cam.camera_to_world.numpy(),
                            res=cam.full_resolution,
                            shutter=(cam.shutter_open, cam.shutter_close))


def test_realistic_camera_matches_jax(monkeypatch):
    """The port's build (the focus, then the exit-pupil table from the lens
    walk of 64 x 1024 seeded rays) equals the same build with the JAX
    package's lens walk in place of the port's; rays and weights agree at
    rtol 1e-5 with the JAX package's generate_rays_realistic on the same
    camera; and the port's camera passes the JAX package's
    test_realistic_camera_focus checks."""
    res = REALISTIC_RES
    tc = treal.make_realistic_camera(ttf.look_at(*LOOK), res, focus_distance=3.0)
    jax_trace = jax.jit(jreal._trace_film_to_scene)

    def trace_with_jax(cam, o, d):
        ok, oo, dd = jax_trace(_jax_realistic(cam), jnp.asarray(o.numpy()),
                               jnp.asarray(d.numpy()))
        return (torch.as_tensor(np.asarray(ok)), torch.as_tensor(np.asarray(oo)),
                torch.as_tensor(np.asarray(dd)))

    port_trace = treal._trace_film_to_scene
    with monkeypatch.context() as m:
        m.setattr(treal, "_trace_film_to_scene", trace_with_jax)
        ref_cam = treal.make_realistic_camera(ttf.look_at(*LOOK), res,
                                              focus_distance=3.0)
    assert treal._trace_film_to_scene is port_trace
    for k in ("curvature", "element_z", "eta", "aperture_r"):
        np.testing.assert_array_equal(getattr(ref_cam, k), getattr(tc, k))
    np.testing.assert_array_equal(ref_cam.exit_pupil.numpy(), tc.exit_pupil.numpy())
    assert ref_cam.rear_z == tc.rear_z
    p_film, p_lens, time_u = _camera_batch(res)
    ref = jreal.generate_rays_realistic(_jax_realistic(tc), jnp.asarray(p_film),
                                        jnp.asarray(p_lens), jnp.asarray(time_u))
    args = (torch.as_tensor(p_film), torch.as_tensor(p_lens), torch.as_tensor(time_u))
    got = tcam.generate_rays(tc, *args)
    _assert_rays_close(ref, got)
    np.testing.assert_array_equal(np.asarray(ref[3]) > 0, got[3].numpy() > 0)
    carried = bridge.camera_from_numpy(bridge.as_numpy_fields(_jax_realistic(tc)), "cpu")
    _assert_rays_close(ref, tcam.generate_rays(carried, *args))

    # tests/test_shapes_cameras_new.py:test_realistic_camera_focus
    fd = 2.0
    cam = treal.make_realistic_camera(ttf.identity(), (64, 64), focus_distance=fd)
    n = 512
    pl = torch.as_tensor(np.random.RandomState(1).rand(n, 2).astype(np.float32))
    o, d, _, w = tcam.generate_rays(cam, torch.tensor([[45.0, 32.0]]).expand(n, 2),
                                    pl, torch.zeros(n))
    o, d, w = o.numpy(), d.numpy(), w.numpy()
    m = w > 0
    assert m.mean() > 0.3 and np.isfinite(o).all() and np.isfinite(d).all()
    ts = np.linspace(0.3, 8, 400)
    spread = [np.mean(np.var(o[m, :2] + t * d[m, :2] / d[m, 2:3], axis=0)) for t in ts]
    assert abs(ts[int(np.argmin(spread))] - fd) < 0.4


def test_ray_differentials_follow_the_new_cameras():
    """generate_ray_differentials calls generate_rays twice more, so it
    serves every camera; held against the JAX package's."""
    res = REALISTIC_RES
    p_film, p_lens, time_u = _camera_batch(res, 300)
    for jc, tc in ((jcam.make_environment_camera(jtf.look_at(*LOOK), res),
                    tcam.make_environment_camera(ttf.look_at(*LOOK), res)),
                   (jcam.make_orthographic_camera(jtf.look_at(*LOOK), res,
                                                  lens_radius=0.2),
                    tcam.make_orthographic_camera(ttf.look_at(*LOOK), res,
                                                  lens_radius=0.2))):
        ref = jcam.generate_ray_differentials(jc, jnp.asarray(p_film),
                                              jnp.asarray(p_lens),
                                              jnp.asarray(time_u), spp=4)
        got = tcam.generate_ray_differentials(tc, torch.as_tensor(p_film),
                                              torch.as_tensor(p_lens),
                                              torch.as_tensor(time_u), spp=4)
        _assert_rays_close(ref, got)
