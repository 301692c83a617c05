"""The port's Metropolis light transport and stochastic progressive photon
mapping (pbrt_tpu_torch.integrators.mlt, .sppm) held against the JAX
package's, part by part, and against the port's path integrator.

* MLT: L(X) (mlt.py:_eval_L) and the bootstrap's luminances on the JAX
  package's bootstrap vectors at each depth of max_depth 2, and the chain
  picks and b from them; one mutation step of those 256 chains fed the
  JAX package's threefry draws (the step of mlt.py:186-224, composed here
  from its _eval_L and _splat);
* SPPM: the camera pass (visible points, Ld), the photon pass fed the JAX
  package's draws, the gather on the JAX package's visible points and
  photons, and the radius and flux update;
* both renders against the path integrator on tests/test_mlt_sppm_tools.py's
  scene at that file's bars (SPPM: means within 12%, correlation above
  0.95; MLT: within 15%, above 0.9).

The JAX functions run eagerly (outside jax.jit; their traversal loop
jitted, tests/jax_traversal_jit.py; the gather jitted
whole) on the 256 lanes of a
16x16 image at depth 2, on tests/test_torch_bdpt.py's parts scene, the
port's MLT with the JAX package's light-normal stand-in.  Bars:
booleans exact on at least 99% of lanes; values at rtol 1e-4 / atol 1e-6
on at least 99% of lanes (tests/test_torch_bdpt.py's); the chain picks
exact; the splat image and the gather's Phi at rtol 1e-4 / atol 1e-6 on
99% of pixels (the port adds each pixel's and each visible point's values
in the JAX package's order: what differs is the values, by the BSDF's
float32 rounding).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.accel import traverse as jtv
from pbrt_tpu.integrators import mlt as jmlt
from pbrt_tpu.integrators import sppm as jsppm
from pbrt_tpu.samplers import samplers as jsa
from pbrt_tpu.statics import scene_statics
from pbrt_tpu_torch import film as tfm
from pbrt_tpu_torch import scene as tsc
from pbrt_tpu_torch.core import transform as ttf
from pbrt_tpu_torch.integrators import mlt as tmlt
from pbrt_tpu_torch.integrators import path as tpath
from pbrt_tpu_torch.integrators import sppm as tsppm
from pbrt_tpu_torch.samplers import samplers as tsa
from pbrt_tpu_torch.utils import stats as st
from jax_traversal_jit import jit_jax_traversal  # noqa: F401  (autouse)
from test_torch_bdpt import (RES, _np, area_scene, bools_equal, cameras, lanes_close,
                             parts_scene)
from test_torch_traverse import both
import test_torch_threads  # noqa: F401  (torch's threads under xdist)

DEPTH = 2
EVERY = np.ones(RES[0] * RES[1], bool)
# the JAX package's light-normal stand-in in the s = 1 weights
STAND_IN = tmlt.MLTConfig(max_depth=DEPTH, light_normal="stand-in")


@pytest.fixture(scope="module")
def scenes():
    js, ts = both(parts_scene)
    statics = scene_statics(js)
    jc, tc = cameras()
    return jtv._device_scene(js), ts, statics, jc, tc


def _t(x):
    return torch.as_tensor(np.array(x))


# ---- MLT ----

@pytest.fixture(scope="module")
def mlt_parts(scenes):
    """L(X) of both packages on the JAX package's bootstrap vectors at each
    depth (jax.random.uniform of fold_in(PRNGKey(3), depth), mlt.py:128-
    140), 256 lanes each."""
    js, ts, statics, jc, tc = scenes
    key0 = jax.random.PRNGKey(3)
    out = {}
    for depth in range(DEPTH + 1):
        X = jax.random.uniform(jax.random.fold_in(key0, depth), (256, tmlt.n_dims(DEPTH)))
        ref = jmlt._eval_L(js, jc, X, jnp.uint32(tmlt.chain_key(depth)), depth,
                           jmlt.MLTConfig(max_depth=DEPTH), statics, RES)
        got = tmlt.eval_L(ts, tc, _t(X), depth, STAND_IN, RES, st.zeros("cpu"))
        out[depth] = (X, ref, got)
    return out


def test_eval_L_matches_jax(mlt_parts):
    """Every depth's rasters, values and luminance (this file keeps to six
    tests: xdist's loadfile scheduling dispatches files with more first)."""
    assert tmlt.n_dims(DEPTH) == jmlt._n_dims(DEPTH)
    for depth, (_, (r_ref, v_ref, lum_ref), (r_got, v_got, lum_got)) in \
            mlt_parts.items():
        assert len(r_ref) == len(r_got) == len(v_got) == (1 if depth == 0 else 2)
        for a, b, va, vb in zip(r_ref, r_got, v_ref, v_got):
            lit = np.any(_np(va) != 0, -1) & np.any(_np(vb) != 0, -1)
            lanes_close(a, b, lit, f"depth {depth} raster")
            lanes_close(va, vb, EVERY, f"depth {depth} value")
        lanes_close(lum_ref, lum_got, EVERY, f"depth {depth} luminance")
        assert (_np(lum_got) > 0).sum() > 0


def test_bootstrap_and_chain_picks_match_jax(mlt_parts):
    """bootstrap_luminance of the JAX package's bootstrap vectors, and
    pick_chains' b and picks from the JAX package's luminances exactly as
    mlt.py:148-163 makes them."""
    lums_ref = []
    for depth, (X, ref, got) in mlt_parts.items():
        lum = np.array(ref[2])
        lums_ref.append(np.where(np.isfinite(lum), lum, 0.0))
        lanes_close(lums_ref[-1], tmlt.bootstrap_luminance(got[2]), EVERY,
                    f"bootstrap depth {depth}")
    b, depth_of, row_of = tmlt.pick_chains(lums_ref, 64, 3)
    b_ref = 0.0
    for lum in lums_ref:
        b_ref += lum.mean()
    all_lum = np.concatenate(lums_ref)
    picks = np.random.RandomState(4).choice(len(all_lum), size=64,
                                            p=all_lum / max(all_lum.sum(), 1e-12))
    np.testing.assert_array_equal(depth_of, picks // 256)
    np.testing.assert_array_equal(row_of, picks % 256)
    assert b == b_ref


def test_mutation_step_matches_jax(mlt_parts, scenes):
    """One step of 256 chains at depth 1 (the bootstrap vectors as the
    chains' states) fed the JAX package's draws: the next X and luminance,
    and the splat image of both candidates."""
    js, ts, statics, jc, tc = scenes
    depth = 1
    X, (r0, v0, lum0), got0 = mlt_parts[depth]
    jcfg = jmlt.MLTConfig(max_depth=DEPTH)
    # the draws and the step of mlt.py:186-224
    _, k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(6), 5)
    u_large = jax.random.uniform(k1, (X.shape[0],))
    fresh = jax.random.uniform(k2, X.shape)
    normal = jax.random.normal(k3, X.shape)
    u_accept = jax.random.uniform(k4, (X.shape[0],))
    large = u_large < jcfg.large_step_prob
    perturb = X + jcfg.sigma * normal
    perturb = perturb - jnp.floor(perturb)
    Xp = jnp.where(large[:, None], fresh, perturb)
    r_p, v_p, lum_p = jmlt._eval_L(js, jc, Xp, jnp.uint32(tmlt.chain_key(depth)), depth,
                                   jcfg, statics, RES)
    a = jnp.clip(lum_p / jnp.maximum(lum0, 1e-12), 0.0, 1.0)
    accept = u_accept < a
    splat = jnp.zeros((RES[1], RES[0], 3), jnp.float32)
    w_p = (a / jnp.maximum(lum_p, 1e-12))[:, None]
    w_c = ((1.0 - a) / jnp.maximum(lum0, 1e-12))[:, None]
    for rr, vv in zip(r_p, v_p):
        splat = jmlt._splat(splat, rr, vv * w_p, RES)
    for rr, vv in zip(r0, v0):
        splat = jmlt._splat(splat, rr, vv * w_c, RES)

    cfg = STAND_IN
    chain = (_t(X), got0[2], got0[0], got0[1])
    t_splat = torch.zeros((RES[1], RES[0], 3))
    (X_got, lum_got, _, _), rounds = tmlt.mutation_step(
        ts, tc, chain, tuple(_t(x) for x in (u_large, fresh, normal, u_accept)), depth,
        cfg, RES, t_splat, st.zeros("cpu"))
    assert rounds >= 1
    every = np.ones(X.shape[0], bool)
    lanes_close(jnp.where(accept[:, None], Xp, X), X_got, every, "X")
    lanes_close(jnp.where(accept, lum_p, lum0), lum_got, every, "lum")
    lanes_close(np.asarray(splat).reshape(-1, 3), t_splat.reshape(-1, 3), EVERY,
                "splat")
    assert t_splat.sum() > 0


# ---- SPPM ----

@pytest.fixture(scope="module")
def sppm_parts(scenes):
    """The JAX package's camera pass, photon pass and gather (eager), with
    the port's camera and photon passes beside them."""
    js, ts, statics, jc, tc = scenes
    jcfg = jsppm.SPPMConfig(max_depth=DEPTH, n_iterations=4, initial_radius=1.0)
    cfg = tsppm.SPPMConfig(max_depth=DEPTH, n_iterations=4, initial_radius=1.0)
    pix = tpath.make_pixel_grid(tfm.FilmConfig(full_resolution=RES))
    n = pix.shape[0]
    s_cfg = jsa.SamplerConfig("halton", 4, RES)
    vp_ref, ld_ref = jsppm._camera_pass(js, jc, jnp.asarray(pix), s_cfg, jnp.uint32(1),
                                        jcfg, statics)
    counters = st.zeros("cpu")
    vp_got, ld_got = tsppm.camera_pass(ts, tc, torch.as_tensor(pix),
                                       tsa.SamplerConfig("halton", 4, RES), 1, cfg,
                                       counters)
    key = jax.random.PRNGKey(0)
    ph_ref = jsppm._photon_pass(js, n, 1, jcfg, statics, key)
    k = jax.random.fold_in(key, 1)
    u = jax.random.uniform(k, (n, 5 + 2 * DEPTH))
    u_rr = jnp.stack([jax.random.uniform(jax.random.fold_in(k, 1000 + b), (n,))
                      for b in range(DEPTH)])
    ph_got = tsppm.photon_pass(ts, _t(u), _t(u_rr), cfg, counters)
    radius = np.full(n, 1.0, np.float32)
    radius[::3] = 0.5  # radii shrink between iterations
    inv_cell = 1.0 / (2.0 * cfg.initial_radius)
    # jitted: eagerly, each of the 27 cells' fori_loop is compiled again
    # (its body closes over the arrays), 32 s here against 17 s
    gather_ref = jax.jit(jsppm._gather, static_argnums=(4, 5))(
        js, vp_ref, jnp.asarray(radius), ph_ref, inv_cell, statics)
    return dict(vp=(vp_ref, vp_got), ld=(ld_ref, ld_got), ph=(ph_ref, ph_got),
                radius=radius, inv_cell=inv_cell, gather_ref=gather_ref, ts=ts)


def test_camera_and_photon_passes_match_jax(sppm_parts):
    vp_ref, vp_got = sppm_parts["vp"]
    bools_equal(vp_ref["exists"], vp_got["exists"], "exists")
    live = _np(vp_ref["exists"]) & _np(vp_got["exists"])
    assert live.sum() > 100
    for k in ("p", "wo", "beta", "ns"):
        lanes_close(vp_ref[k], vp_got[k], live, k)
    assert (_np(vp_ref["mat_id"])[live] == _np(vp_got["mat_id"])[live]).mean() >= 0.99
    lanes_close(*sppm_parts["ld"], EVERY, "Ld")

    ref, got = sppm_parts["ph"]
    assert got["p"].shape == (256 * (DEPTH - 1), 3)
    hit_ref, hit_got = _np(ref["p"])[:, 0] < 1e17, _np(got["p"])[:, 0] < 1e17
    bools_equal(hit_ref, hit_got, "photon hits")
    assert hit_got.sum() > 20
    both_hit = hit_ref & hit_got
    for k in ("p", "wo", "beta"):
        lanes_close(ref[k], got[k], both_hit, k)


def test_gather_and_update_match_jax(sppm_parts):
    """The gather on the JAX package's visible points and photons, then
    the update of sppm.py:304-315 from its Phi and M."""
    vp_ref = sppm_parts["vp"][0]
    vp = {k: _t(v) for k, v in vp_ref.items()}
    photons = {k: _t(v) for k, v in sppm_parts["ph"][0].items()}
    radius = sppm_parts["radius"]
    info = {}
    Phi, M = tsppm.gather(sppm_parts["ts"], vp, _t(radius), photons,
                          sppm_parts["inv_cell"], info)
    Phi_ref, M_ref = (np.asarray(x) for x in sppm_parts["gather_ref"])
    np.testing.assert_array_equal(M.numpy(), M_ref)
    assert M_ref.sum() > 50 and info["found"] == M_ref.sum()
    lanes_close(Phi_ref, Phi, EVERY, "Phi")

    rs = np.random.RandomState(7)
    n_vp = (rs.rand(radius.shape[0]) * 20).astype(np.float32)
    tau = rs.rand(radius.shape[0], 3).astype(np.float32)
    beta = np.asarray(vp_ref["beta"])
    r_new, n_new, tau_new = tsppm.update(_t(radius), _t(n_vp), _t(tau), _t(beta),
                                         _t(Phi_ref), _t(M_ref), 0.6666667)
    # sppm.py:304-315
    has = M_ref > 0
    nn = n_vp + np.float32(0.6666667) * M_ref
    rr = np.where(has, radius * np.sqrt(nn / np.maximum(n_vp + M_ref, 1e-6)), radius)
    tt = np.where(has[:, None], (tau + beta * Phi_ref)
                  * (rr * rr / np.maximum(radius * radius, 1e-12))[:, None], tau)
    np.testing.assert_allclose(r_new.numpy(), rr, rtol=1e-6)
    np.testing.assert_allclose(n_new.numpy(), np.where(has, nn, n_vp), rtol=1e-6)
    np.testing.assert_allclose(tau_new.numpy(), tt, rtol=1e-5)


# ---- the renders against the path integrator ----

@pytest.fixture(scope="module")
def area():
    ts = area_scene(tsc, ttf).build(device="cpu")
    _, tc = cameras()
    fc = tfm.FilmConfig(full_resolution=RES)
    ref = tpath.render(ts, tc, fc, tsa.SamplerConfig("sobol", 32, RES),
                       tpath.PathConfig(max_depth=DEPTH), device="cpu").numpy()
    return ts, tc, fc, ref


def _mean_corr(img, ref):
    return (abs(img.mean() - ref.mean()) / ref.mean(),
            np.corrcoef(img.ravel(), ref.ravel())[0, 1])


def test_sppm_and_mlt_match_the_path_integrator(area):
    ts, tc, fc, ref = area
    img = tsppm.render(ts, tc, fc, None, tsppm.SPPMConfig(
        max_depth=DEPTH, n_iterations=10, initial_radius=0.5), device="cpu").numpy()
    rel, corr = _mean_corr(img, ref)
    assert rel < 0.12 and corr > 0.95, (rel, corr)
    info = {}
    img = tmlt.render(ts, tc, fc, None, tmlt.MLTConfig(
        max_depth=DEPTH, n_bootstrap=6144, n_chains=384, mutations_per_pixel=16),
        device="cpu", seed=3, info=info).numpy()
    rel, corr = _mean_corr(img, ref)
    assert rel < 0.15 and corr > 0.9, (rel, corr)
    assert sum(info["chains"]) == 384 and info["steps"] == 10
