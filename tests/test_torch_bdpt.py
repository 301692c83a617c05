"""The port's bidirectional path tracer (pbrt_tpu_torch.integrators.bdpt)
held against the JAX package's.

* both subpaths' vertex arrays and every (s, t) strategy of ConnectBDPT
  (contribution, MIS weight, raster) at depth 2 on 256 lanes of a scene
  with a matte floor, ceiling and wall, a mirror sphere (specular
  vertices), a plastic sphere, an emissive sphere and triangle and a
  point light.  The JAX functions run eagerly (outside jax.jit), but for
  its traversal loop, jitted (tests/jax_traversal_jit.py), and the port's
  s = 1 weights take the JAX package's light-normal stand-in
  (BDPTConfig.light_normal "stand-in").  Bars: every boolean exact on
  at least 99% of lanes; the values at rtol 1e-4 / atol 1e-6 on at least
  99% of the lanes where both vertices exist (a lane whose hit moved by an
  ulp samples another direction a bounce later);
* one image against pbrt_tpu.integrators.bdpt.render (jitted; 16x16, 2
  spp, depth 2, sobol; the stand-in) at tests/test_torch_path.py:58-59's bars (99.5% of
  pixels within rel 1e-3, means within 5e-3), with 10 traversal launches a
  spp ((D + 1) + D + D + D + D (D - 1) / 2 at depth D: 31 at depth 5);
* the port against its own path integrator on tests/test_bdpt.py's
  area-light scene at that file's bars (means within 5%, the mean
  per-pixel difference within 15% of the mean), and with the light's own
  normal (pbrt-v3's, the port's default) where the stand-in is 9% dark;
The refusals and the parsed setups are in
tests/test_torch_transport_front.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu import film as jfm
from pbrt_tpu.accel import traverse as jtv
from pbrt_tpu.cameras import make_perspective_camera as jcamera
from pbrt_tpu.core import transform as jtf
from pbrt_tpu.integrators import bdpt as jbd
from pbrt_tpu.samplers import samplers as jsa
from pbrt_tpu.statics import scene_statics
from pbrt_tpu_torch import bridge
from pbrt_tpu_torch import film as tfm
from pbrt_tpu_torch import scene as tsc
from pbrt_tpu_torch.cameras import cameras as tcam
from pbrt_tpu_torch.core import transform as ttf
from pbrt_tpu_torch.integrators import bdpt as tbd
from pbrt_tpu_torch.integrators import path as tpath
from pbrt_tpu_torch.ops import bvh as kb
from pbrt_tpu_torch.samplers import samplers as tsa
from pbrt_tpu_torch.utils import stats as st
from jax_traversal_jit import jit_jax_traversal  # noqa: F401  (autouse)
from test_torch_path import match_frac, mean_rel
from test_torch_traverse import both
import test_torch_threads  # noqa: F401  (torch's threads under xdist)

RES = (16, 16)
LOOK = ([0, -9, 2], [0, 0, 1], [0, 0, 1])
RTOL, ATOL, FRAC = 1e-4, 1e-6, 0.99


def area_scene(sc, tf):
    """tests/test_mlt_sppm_tools.py's scene: a matte floor under an
    emissive sphere."""
    b = sc.SceneBuilder()
    m = b.add_material(sc.MAT_MATTE, kd=(0.6, 0.6, 0.6))
    b.add_triangle_mesh([[0, 1, 2], [2, 3, 0]],
                        [[-6, -6, 0], [6, -6, 0], [6, 6, 0], [-6, 6, 0]], material=m)
    b.add_emissive_sphere(tf.translate(0, 0, 4), 0.6, L=(12, 12, 12), material=m)
    return b


def parts_scene(sc, tf):
    """area_scene with a ceiling and a back wall (the light walks' upward
    rays come down again), a mirror and a plastic sphere, an emissive
    triangle and a point light."""
    b = area_scene(sc, tf)
    m = b.add_material(sc.MAT_MATTE, kd=(0.5, 0.6, 0.4))
    b.add_triangle_mesh([[0, 1, 2], [2, 3, 0], [4, 5, 6], [6, 7, 4]],
                        [[-6, -6, 7], [6, -6, 7], [6, 6, 7], [-6, 6, 7],
                         [-6, 6, 0], [6, 6, 0], [6, 6, 7], [-6, 6, 7]], material=m)
    mirror = b.add_material(sc.MAT_MIRROR, kr=(0.9, 0.9, 0.9))
    b.add_sphere(tf.translate(1.8, 0.5, 1.0), 1.0, material=mirror)
    plastic = b.add_material(sc.MAT_PLASTIC, kd=(0.4, 0.2, 0.1), ks=(0.3, 0.3, 0.3),
                             roughness=0.1)
    b.add_sphere(tf.translate(-1.8, 0.0, 0.8), 0.8, material=plastic)
    b.add_emissive_triangle_mesh([[0, 1, 2]], [[-1, 2, 5], [1, 2, 5], [0, 3, 5.5]],
                                 L=(4, 4, 4), two_sided=True)
    b.add_point_light(tf.translate(0, -3, 4), (6, 6, 6))
    return b


def cameras(res=RES):
    jc = jcamera(jtf.look_at(*LOOK), res, fov_deg=55.0)
    return jc, bridge.camera_from_numpy(bridge.as_numpy_fields(jc), "cpu")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def lanes_close(ref, got, lanes, what):
    """At least FRAC of `lanes` within RTOL / ATOL."""
    ref, got = _np(ref)[lanes], _np(got)[lanes]
    ok = np.isclose(got, ref, rtol=RTOL, atol=ATOL)
    ok = ok.reshape(ok.shape[0], -1).all(-1)
    assert ok.size == 0 or ok.mean() >= FRAC, (what, ok.mean())


def bools_equal(ref, got, what):
    assert (_np(ref) == _np(got)).mean() >= FRAC, what


@pytest.fixture(scope="module")
def parts():
    """Both packages' subpaths of one sobol sample at depth 2 (the JAX
    package's eager), and their connections."""
    js, ts = both(parts_scene)
    jc, tc = cameras()
    statics = scene_statics(js)
    js = jtv._device_scene(js)
    pix = tpath.make_pixel_grid(tfm.FilmConfig(full_resolution=RES))
    n = pix.shape[0]
    jcfg, tcfg = jsa.SamplerConfig("sobol", 2, RES), tsa.SamplerConfig("sobol", 2, RES)
    jstate = jsa.init_state(jcfg, jnp.asarray(pix), jnp.zeros((n,), jnp.uint32))
    tstate = tsa.init_state(tcfg, torch.as_tensor(pix),
                            torch.zeros(n, dtype=torch.int64))
    bj, bt = jbd.BDPTConfig(max_depth=2), tbd.BDPTConfig(max_depth=2)
    counters = st.zeros("cpu")
    jcam_vs, jdim, jp_film = jbd.generate_camera_subpath(js, jc, jnp.asarray(pix),
                                                         jcfg, jstate, bj, statics)
    jlight_vs, _ = jbd.generate_light_subpath(js, n, jcfg, jstate, bj, statics, jdim)
    tcam_vs, tdim, tp_film = tbd.generate_camera_subpath(
        ts, tc, torch.as_tensor(pix), tcfg, tstate, bt, counters)
    tlight_vs, _ = tbd.generate_light_subpath(ts, n, tcfg, tstate, bt, tdim, counters,
                                              "cpu")
    assert jdim == tdim == 5 + 2 * 3
    np.testing.assert_array_equal(np.asarray(jp_film), tp_film.numpy())
    conns = {}
    for s, t in tbd.strategies(2):
        ref = jbd._connect(js, jc, jcam_vs, jlight_vs, s, t, jcfg, jstate, bj, statics,
                           statics.quadric_types)
        got = tbd.connect(ts, tc, tcam_vs, tlight_vs, s, t, tcfg, tstate, counters,
                          "stand-in")
        conns[(s, t)] = (ref, got)
    return {"cam": (jcam_vs, tcam_vs), "light": (jlight_vs, tlight_vs),
            "conns": conns}


@pytest.mark.parametrize("side", ["cam", "light"])
def test_subpaths_match_jax(parts, side):
    ref_vs, got_vs = parts[side]
    assert len(ref_vs) == len(got_vs) == (4 if side == "cam" else 3)
    for i, (a, b) in enumerate(zip(ref_vs, got_vs)):
        for k in ("exists", "delta", "is_surface"):
            bools_equal(a[k], b[k], f"{side}[{i}].{k}")
        live = _np(a["exists"]) & _np(b["exists"])
        if i > 0:
            assert live.sum() > 0, (side, i)
        for k in ("p", "beta", "pdf_fwd", "pdf_rev"):
            lanes_close(a[k], b[k], live, f"{side}[{i}].{k}")
    assert _np(got_vs[2]["delta"]).any()  # the mirror


def test_every_strategy_matches_jax(parts):
    assert sorted(parts["conns"]) == sorted(
        [(0, 2), (0, 3), (0, 4), (2, 1), (3, 1), (1, 2), (1, 3), (2, 2)])
    for (s, t), (ref, got) in parts["conns"].items():
        wc_ref = _np(ref[0]) * _np(ref[1])[:, None]
        wc_got = _np(got[0]) * _np(got[1])[:, None]
        every = np.ones(wc_ref.shape[0], bool)
        lanes_close(wc_ref, wc_got, every, f"({s}, {t}) weighted contribution")
        lit = np.any(_np(ref[0]) != 0, -1) & np.any(_np(got[0]) != 0, -1)
        assert lit.sum() > 0, (s, t)
        lanes_close(ref[1], got[1], lit, f"({s}, {t}) weight")
        if t == 1:
            lanes_close(ref[2], got[2], lit, f"({s}, {t}) raster")
        else:
            assert ref[2] is None and got[2] is None


def test_image_matches_jax():
    js, ts = both(area_scene)
    jc, tc = cameras()
    ref = np.asarray(jbd.render(js, jc, jfm.FilmConfig(full_resolution=RES),
                                jsa.SamplerConfig("sobol", 2, RES),
                                jbd.BDPTConfig(max_depth=2)))
    with kb.record_calls() as calls:
        got = tbd.render(ts, tc, tfm.FilmConfig(full_resolution=RES),
                         tsa.SamplerConfig("sobol", 2, RES),
                         tbd.BDPTConfig(max_depth=2, light_normal="stand-in"),
                         device="cpu").numpy()
    assert len(calls) == 2 * 10
    assert got.shape == ref.shape == (16, 16, 3)
    assert np.isfinite(got).all() and got.mean() > 0
    assert match_frac(ref, got) >= 0.995
    assert mean_rel(ref, got) <= 5e-3


def test_image_matches_the_path_integrator():
    """tests/test_bdpt.py's bars on its area-light scene, at 16x16 and
    depth 2 (8 spp each)."""
    ts = area_scene(tsc, ttf).build(device="cpu")
    _, tc = cameras()
    fc = tfm.FilmConfig(full_resolution=RES)
    img_p = tpath.render(ts, tc, fc, tsa.SamplerConfig("sobol", 8, RES),
                         tpath.PathConfig(max_depth=2), device="cpu").numpy()
    img_b, counters = tbd.render(ts, tc, fc, tsa.SamplerConfig("sobol", 8, RES),
                                 tbd.BDPTConfig(max_depth=2), device="cpu",
                                 stats_out=True)
    img_b = img_b.numpy()
    assert abs(img_p.mean() - img_b.mean()) / img_p.mean() < 0.05
    assert np.abs(img_p - img_b).mean() / img_p.mean() < 0.15
    # every camera ray is live; the ray count is the live traversal lanes
    assert st.ray_total(counters) >= 8 * 256


def test_surface_normal_meets_the_path_bars_where_the_stand_in_misses():
    """The s = 1 strategies' MIS weight with the sampled light point's own
    normal (pbrt-v3) against -wi (the JAX package's stand-in): at depth 1
    on a floor and wall under chip_smoke.py's main light (a 0.5 sphere at
    L = 40, far off), 8 spp each, the first meets tests/test_bdpt.py's 5%
    bar on the means against the path integrator; the stand-in is 9% dark."""
    b = tsc.SceneBuilder()
    m = b.add_material(tsc.MAT_MATTE, kd=(0.5, 0.5, 0.8))
    b.add_triangle_mesh([[0, 1, 2], [2, 3, 0], [4, 5, 6], [6, 7, 4]],
                        [[-10, -10, 0], [10, -10, 0], [10, 10, 0], [-10, 10, 0],
                         [-10, 6, 0], [10, 6, 0], [10, 6, 12], [-10, 6, 12]],
                        material=m)
    b.add_emissive_sphere(ttf.translate(0, 5, 8), 0.5, L=(40, 40, 40), material=m)
    ts = b.build(device="cpu")
    tc = tcam.make_perspective_camera(ttf.look_at([0, -8, 4], [0, 0, 2], [0, 0, 1]),
                                      RES, fov_deg=45.0)
    fc = tfm.FilmConfig(full_resolution=RES)
    sampler = tsa.SamplerConfig("sobol", 8, RES)
    ref = tpath.render(ts, tc, fc, sampler, tpath.PathConfig(max_depth=1),
                       device="cpu").numpy().mean()
    rel = {n: tbd.render(ts, tc, fc, sampler, tbd.BDPTConfig(1, n),
                         device="cpu").numpy().mean() / ref - 1.0
           for n in ("surface", "stand-in")}
    assert abs(rel["surface"]) < 0.05 and rel["stand-in"] < -0.05, rel
