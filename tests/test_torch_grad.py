"""Differentiable rendering in the port (pbrt_tpu_torch.parallel.diff) held
against the JAX package's (pbrt_tpu.parallel.diff) on the scenes of
tests/test_grad.py: a matte or plastic ground plane lit by an emissive
sphere behind the camera, 24x24, sobol, sample 0, the same seeded weights.

* the port's AD against JAX's AD at depth 1 (JAX jitted on its CPU backend,
  which takes the watertight oracle, no Pallas), on one set of parameter
  values put into both packages (bridge.params_from_numpy);
* the port's AD against its own central finite differences, at
  test_grad.py's epsilons and tolerances;
* path replay (remat) against no remat, finite and non-zero leaves at depth
  3, the counted rays of a grad step, and the device rule;
* the gradient guards at their edges, and the input that showed the cone
  pdf's fault;
* the step on a one-triangle scene with a texture, glass or an infinite
  light, and its three refusals (the steps the JAX package cannot take).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu import film as jfm
from pbrt_tpu.integrators.path import PathConfig as JPath
from pbrt_tpu.integrators.path import make_pixel_grid
from pbrt_tpu.parallel import diff as jdiff
from pbrt_tpu.samplers.samplers import SamplerConfig as JSampler
from pbrt_tpu.statics import scene_statics
from chip_smoke import blob_mesh
from pbrt_tpu_torch import bridge
from pbrt_tpu_torch import film as tfm
from pbrt_tpu_torch import scene as tsc
from pbrt_tpu_torch.cameras.cameras import (make_perspective_camera,
                                            perspective_raster_to_camera)
from pbrt_tpu_torch.core import transform as ttf
from pbrt_tpu_torch.core.sampling import uniform_cone_pdf
from pbrt_tpu_torch.core.vecmath import offset_ray_origin, safe_sqrt
from pbrt_tpu_torch.integrators import path as tpath
from pbrt_tpu_torch.parallel import diff
from pbrt_tpu_torch.samplers.samplers import SamplerConfig as TSampler
from pbrt_tpu_torch.utils import stats as st
from test_grad import RES, _camera, _plane_scene
from test_torch_path import match_frac
from jax_traversal_jit import jit_jax_traversal  # noqa: F401  (autouse)
import test_torch_threads  # noqa: F401  (torch's threads under xdist)

LEAVES = ("kd", "ks", "roughness", "light_L")


def _weights():
    rng = np.random.RandomState(7)
    return rng.uniform(0.5, 1.5, (RES[0] * RES[1], 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _port(plastic=False, depth=1):
    """The port's (scene, camera, pixels, weights, sampler, path config) on
    the CPU, the scene and camera carried over from the JAX package."""
    scene = bridge.scene_from_numpy(bridge.as_numpy_fields(_plane_scene(plastic)),
                                    "cpu")
    camera = bridge.camera_from_numpy(bridge.as_numpy_fields(_camera()), "cpu")
    pixels = torch.as_tensor(make_pixel_grid(jfm.FilmConfig(full_resolution=RES)))
    return (scene, camera, pixels, torch.as_tensor(_weights()),
            TSampler("sobol", 4, RES), tpath.PathConfig(max_depth=depth))


def _step(plastic=False, depth=1, **kw):
    scene, camera, pixels, w, scfg, pcfg = _port(plastic, depth)
    return diff.render_grad_step(scene, camera, pixels, 0, w, scfg, pcfg,
                                 device="cpu", **kw)


def _loss(scene, camera, plastic=False, depth=1):
    _, _, pixels, w, scfg, pcfg = _port(plastic, depth)
    with torch.no_grad():
        L = diff.render_batch_radiance(scene, camera, pixels, 0, scfg, pcfg)
    return float(torch.sum(L * w))


def _seeded_values(scene, camera):
    """One set of parameter values, as numpy in the JAX package's
    extract_params layout: the scene's own, with kd, ks, roughness and L
    moved by seeded amounts."""
    vals = jax.tree_util.tree_map(np.asarray, jdiff.extract_params(scene, camera))
    rs = np.random.RandomState(11)
    for k in ("kd", "ks"):
        vals[k] = (vals[k] * rs.uniform(0.8, 1.2, vals[k].shape)).astype(np.float32)
    vals["roughness"] = rs.uniform(0.2, 0.4, vals["roughness"].shape).astype(np.float32)
    vals["light_L"] = (vals["light_L"] * rs.uniform(0.8, 1.2, vals["light_L"].shape)
                       ).astype(np.float32)
    return vals


@functools.lru_cache(maxsize=None)
def _jax_step():
    """The JAX package's depth-1 grad step, jitted once for both scenes:
    the statics of the plastic scene, whose material types (matte and
    plastic) hold the matte scene's, and whose arrays have the matte
    scene's shapes; a type absent from a scene only adds masked lanes."""
    pixels = jnp.asarray(make_pixel_grid(jfm.FilmConfig(full_resolution=RES)))
    w, statics = jnp.asarray(_weights()), scene_statics(_plane_scene(True))
    # pixels and weights as constants of the trace: XLA compiles it faster.
    return jax.jit(lambda s, c: jdiff.render_grad_step(
        s, c, pixels, jnp.uint32(0), w, JSampler("sobol", 4, RES),
        JPath(max_depth=1), statics, remat=False))


@functools.lru_cache(maxsize=None)
def _jax_and_port(plastic):
    """Depth-1 (L, grads) of both packages on the same parameter values."""
    js, jc = _plane_scene(plastic), _camera()
    vals = _seeded_values(js, jc)
    js2, jc2 = jdiff.apply_params(js, jc, vals)
    jL, jg = _jax_step()(js2, jc2)
    jg = jax.tree_util.tree_map(np.asarray, jg)

    scene, camera, tpix, w, scfg, pcfg = _port(plastic, 1)
    scene, camera = diff.apply_params(scene, camera,
                                      bridge.params_from_numpy(vals, "cpu"))
    L, g = diff.render_grad_step(scene, camera, tpix, 0, w, scfg, pcfg,
                                 device="cpu")
    return np.asarray(jL), jg, L.numpy(), g


@pytest.mark.parametrize("plastic", [False, True], ids=["matte", "plastic"])
def test_grads_match_jax_at_depth1(plastic):
    jL, jg, L, g = _jax_and_port(plastic)
    assert match_frac(jL, L) >= 0.995
    pairs = [(k, jg[k], g[k]) for k in LEAVES]
    pairs += [(f"camera.{k}", jg["camera"][k], g["camera"][k])
              for k in diff.CAMERA_LEAVES]
    for name, ref, got in pairs:
        ref = np.asarray(ref, np.float32)
        got = got.numpy()
        assert got.shape == ref.shape, name
        bar = 1e-3 * np.abs(ref).max() + 1e-6
        assert np.abs(got - ref).max() <= bar, name
    assert np.abs(g["kd"].numpy()).max() > 1e-3


def _with_material(scene, key, idx, e):
    v = getattr(scene.materials, key).clone()
    v[idx] += e
    return dataclasses.replace(
        scene, materials=dataclasses.replace(scene.materials, **{key: v}))


def _with_light(scene, idx, e):
    v = scene.lights.L.clone()
    v[idx] += e
    return dataclasses.replace(scene, lights=dataclasses.replace(scene.lights, L=v))


def _with_pose(camera, idx, e):
    m = camera.camera_to_world.clone()
    m[idx] += e
    return dataclasses.replace(camera, camera_to_world=m)


# (AD leaf, perturbation, plastic scene, eps, rtol): tests/test_grad.py's cases.
FD_CASES = {
    "kd": (lambda g: g["kd"][0, 0],
           lambda s, c, e: (_with_material(s, "kd", (0, 0), e), c), False, 5e-3, 0.02),
    "light_L": (lambda g: g["light_L"][0, 1],
                lambda s, c, e: (_with_light(s, (0, 1), e), c), False, 0.5, 0.02),
    "roughness": (lambda g: g["roughness"][0],
                  lambda s, c, e: (_with_material(s, "roughness", (0,), e), c),
                  True, 5e-3, 0.05),
    "camera_pose": (lambda g: g["camera"]["camera_to_world"][0, 3],
                    lambda s, c, e: (s, _with_pose(c, (0, 3), e)), False, 5e-2, 0.05),
}


def _check(ad, fd, rtol):
    denom = max(abs(ad), abs(fd), 1e-6)
    assert abs(ad) > 1e-3  # non-degenerate
    assert abs(ad - fd) / denom < rtol, f"AD {ad:.6g} vs FD {fd:.6g}"


def _fov_ad_fd(e=0.05):
    scene, camera, pixels, w, scfg, pcfg = _port()

    def cam(fov):
        return dataclasses.replace(
            camera, raster_to_camera=perspective_raster_to_camera(fov, RES))

    fov = torch.tensor(40.0, requires_grad=True)
    L = diff.render_batch_radiance(scene, cam(fov), pixels, 0, scfg, pcfg)
    (ad,) = torch.autograd.grad(torch.sum(L * w), fov)
    fd = (_loss(scene, cam(40.0 + e)) - _loss(scene, cam(40.0 - e))) / (2 * e)
    return float(ad), fd


@pytest.mark.parametrize("case", list(FD_CASES) + ["fov"])
def test_port_ad_matches_fd(case):
    if case == "fov":
        ad, fd = _fov_ad_fd()
        _check(ad, fd, 0.05)
        return
    leaf, perturb, plastic, eps, rtol = FD_CASES[case]
    _, g = _step(plastic)
    scene, camera = _port(plastic)[:2]
    fd = (_loss(*perturb(scene, camera, eps), plastic)
          - _loss(*perturb(scene, camera, -eps), plastic)) / (2 * eps)
    _check(float(leaf(g)), fd, rtol)


@functools.lru_cache(maxsize=None)
def _deep(remat):
    counters = st.zeros("cpu")
    L, g = _step(True, 3, remat=remat, counters=counters)
    return L, g, counters


def test_remat_grads_match_no_remat():
    """Path replay (a checkpoint per bounce) does not change the gradients
    (tests/test_grad.py:189-204's tolerances)."""
    L1, g1, _ = _deep(True)
    L2, g2, _ = _deep(False)
    np.testing.assert_allclose(L1.numpy(), L2.numpy(), atol=1e-6)
    for k in LEAVES:
        np.testing.assert_allclose(g1[k].numpy(), g2[k].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(g1["camera"]["camera_to_world"].numpy(),
                               g2["camera"]["camera_to_world"].numpy(),
                               rtol=1e-4, atol=1e-6)


def test_depth3_leaves_finite_and_nonzero():
    _, g, _ = _deep(True)
    flat = [g[k] for k in LEAVES] + list(g["camera"].values())
    assert len(flat) == 8
    for leaf in flat:
        assert torch.isfinite(leaf).all()
    assert float(g["kd"].abs().sum()) > 1e-4
    assert float(g["camera"]["camera_to_world"].abs().sum()) > 1e-4


def test_grad_step_counts_the_forward_rays_once():
    """A remat step replays every bounce but the last; its counters still
    equal those of a forward render of the same batch."""
    _, _, counters = _deep(True)
    scene, camera, pixels, _, scfg, pcfg = _port(True, 3)
    ref = st.zeros("cpu")
    film_cfg = tfm.FilmConfig(full_resolution=RES)
    film = tfm.make_film_state(film_cfg, tpath.make_filter(film_cfg.filter_name),
                               "cpu")
    with torch.no_grad():
        tpath.sample_batch(tpath.path_li(scene, scfg, pcfg), tpath.n_path_dims(pcfg),
                           scene, camera, film, pixels, 0, scfg, ref)
    assert st.ray_total(ref) > 0
    assert torch.equal(counters, ref)


def test_grad_step_needs_the_card_unless_asked(monkeypatch):
    scene, camera, pixels, w, scfg, pcfg = _port()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        diff.render_grad_step(scene, camera, pixels, 0, w, scfg, pcfg)


def test_guards_give_zero_gradients_at_their_edges():
    """safe_sqrt at 0 and below, uniform_cone_pdf at cos_theta_max = 1 and
    the one-ulp nudge of offset_ray_origin: the forward values of the plain
    formulas, finite derivatives."""
    x = torch.tensor([0.0, -1.0, 4.0], requires_grad=True)
    y = safe_sqrt(x)
    (g,) = torch.autograd.grad(y.sum(), x)
    assert torch.equal(y, torch.tensor([0.0, 0.0, 2.0]))
    assert torch.equal(g, torch.tensor([0.0, 0.0, 0.25]))

    c = torch.tensor([1.0, 0.5], requires_grad=True)
    pdf = uniform_cone_pdf(c)
    assert pdf[0] == float("inf") and pdf[1] == 1.0 / (2.0 * np.pi * 0.5)
    (g,) = torch.autograd.grad(torch.where(c < 1.0, pdf, 0.0).sum(), c)
    assert torch.isfinite(g).all() and g[0] == 0.0

    rs = np.random.RandomState(3)
    p, err, n, w = (torch.as_tensor(rs.randn(64, 3).astype(np.float32))
                    for _ in range(4))
    p.requires_grad_(True)
    o = offset_ray_origin(p, err.abs() * 1e-4, n / n.norm(dim=-1, keepdim=True), w)
    with torch.no_grad():
        assert torch.equal(o, offset_ray_origin(p, err.abs() * 1e-4,
                                                n / n.norm(dim=-1, keepdim=True), w))
    (g,) = torch.autograd.grad(o.sum(), p)
    assert torch.equal(g, torch.ones_like(p))


def test_far_hit_point_keeps_camera_gradients_finite():
    """chip_smoke.py's main scene with a 128x64 blob, 64x64, halton sample
    6: one lane's Moller-Trumbore hit is missed by hit_record's watertight
    re-test, whose barycentrics put p ~141,000 units away, where the light
    sphere's cone pdf is infinite."""
    b = tsc.SceneBuilder()
    matte = b.add_material(tsc.MAT_MATTE, kd=(0.5, 0.5, 0.8))
    plastic = b.add_material(tsc.MAT_PLASTIC, kd=(0.4, 0.2, 0.2),
                             ks=(0.5, 0.5, 0.5), roughness=0.025)
    mirror = b.add_material(tsc.MAT_MIRROR, kr=(0.9, 0.9, 0.9))
    b.add_triangle_mesh([[0, 1, 2], [2, 3, 0]],
                        [[-10, -10, 0], [10, -10, 0], [10, 10, 0], [-10, 10, 0]],
                        material=matte)
    b.add_triangle_mesh([[0, 1, 2], [2, 3, 0]],
                        [[-10, 6, 0], [10, 6, 0], [10, 6, 12], [-10, 6, 12]],
                        material=matte)
    idx, v = blob_mesh(128, 64, seed=0, center=(0.0, 0.0, 2.2), radius=2.0)
    b.add_triangle_mesh(idx, v, material=plastic)
    b.add_sphere(ttf.translate(3.7, -0.5, 1.2), 1.2, material=mirror)
    b.add_emissive_sphere(ttf.translate(0, 5, 8), 0.5, L=(40.0, 40.0, 40.0),
                          material=matte)
    scene = b.build(device="cpu")
    res = (64, 64)
    camera = make_perspective_camera(
        ttf.look_at([0, -8, 4], [0, 0, 2], [0, 0, 1]), res, fov_deg=45.0)
    pixels = torch.as_tensor(tpath.make_pixel_grid(tfm.FilmConfig(full_resolution=res)))
    _, g = diff.render_grad_step(scene, camera, pixels, 6,
                                 torch.ones((pixels.shape[0], 3)),
                                 TSampler("halton", 1, res),
                                 tpath.PathConfig(max_depth=5), device="cpu")
    for leaf in [g[k] for k in LEAVES] + list(g["camera"].values()):
        assert torch.isfinite(leaf).all()


def test_apply_params_lens_radius_sets_the_thin_lens_branch():
    """A lens radius put in by apply_params takes effect: a pinhole camera
    (identity pose, 8x8, fov 60) given lens_radius 0.5 and focal_distance
    2.0 as tensors generates the JAX package's thin-lens rays (origins
    (0.283, -0.283, 0) and (-0.260, 0.150, 0)), at the camera tests'
    tolerance (rtol = atol = 1e-6)."""
    from pbrt_tpu.cameras import cameras as jcam
    from pbrt_tpu.core import transform as jtf
    from pbrt_tpu_torch.cameras import generate_rays

    res = (8, 8)
    jc = jcam.make_perspective_camera(jtf.identity(), res, fov_deg=60.0)
    jc = dataclasses.replace(jc, lens_radius=jnp.float32(0.5),
                             focal_distance=jnp.float32(2.0))
    tc = make_perspective_camera(ttf.identity(), res, fov_deg=60.0)
    _, tc = diff.apply_params(None, tc, {"camera": {
        "lens_radius": torch.tensor(0.5), "focal_distance": torch.tensor(2.0)}})
    assert tc.host_lens_radius == 0.5
    p_film = np.array([[1.0, 2.0], [5.0, 6.0]], np.float32)
    p_lens = np.array([[0.9, 0.1], [0.2, 0.7]], np.float32)
    time_u = np.zeros(2, np.float32)
    ref = jcam.generate_rays(jc, jnp.asarray(p_film), jnp.asarray(p_lens),
                             jnp.asarray(time_u))
    got = generate_rays(tc, torch.as_tensor(p_film), torch.as_tensor(p_lens),
                        torch.as_tensor(time_u))
    for a, b in zip(ref, got):
        np.testing.assert_allclose(np.asarray(a), b.detach().numpy(),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[0].detach().numpy(),
                               [[0.283, -0.283, 0.0], [-0.260, 0.150, 0.0]],
                               atol=1e-3)


@pytest.mark.parametrize("what", ["textures", "glass", "infinite lights"])
def test_grad_step_refuses_what_it_does_not_check(what):
    """A one-triangle scene with a checkerboard texture, glass or an
    infinite light: the JAX package's step differentiates each, and the
    port's, held against it in tests/test_torch_grad_config3.py, runs here
    too: L is the no-grad forward's and every leaf is finite."""
    from pbrt_tpu_torch.textures import textures as ttx
    from test_torch_grad_groups import assert_step_runs

    b = tsc.SceneBuilder()
    kw = {}
    if what == "textures":
        kw = dict(kd_tex=b.textures.add(ttx.TEX_CHECKER, c1=(1, 1, 1)))
    m = b.add_material(tsc.MAT_GLASS if what == "glass" else tsc.MAT_MATTE, **kw)
    b.add_triangle_mesh([[0, 1, 2]], [[-1, -1, 0], [1, -1, 0], [0, 1, 0]],
                        material=m)
    if what == "infinite lights":
        b.add_infinite_light()
    else:
        b.add_point_light(ttf.translate(0, 0, 2), (1.0, 1.0, 1.0))
    res = (4, 4)
    camera = make_perspective_camera(ttf.look_at([0, 0, 3], [0, 0, 0], [0, 1, 0]),
                                     res)
    assert_step_runs(b.build(device="cpu"), camera, res)


@pytest.mark.parametrize("case", ["realistic camera leaves", "random with remat",
                                  "exact mode"])
def test_grad_step_refuses_what_the_jax_step_cannot_take(case):
    """The three steps left refused, each named in the message:
    * the realistic camera with "camera" among the leaves: the JAX
      package's extract_params raises AttributeError (RealisticParams has
      no raster_to_camera, lens_radius or focal_distance);
    * the random sampler with remat: the JAX package raises
      UnexpectedTracerError (the PCG32 stream written inside jax.checkpoint
      escapes it); the port's replay would redraw other numbers;
    * the exact sampler mode: the JAX package's step ignores it and draws
      the plain stream, which the port does not do silently.
    The same steps without those leaves, without remat or without the exact
    mode run."""
    import dataclasses as dc

    from pbrt_tpu_torch.cameras.realistic import make_realistic_camera

    scene, camera, pixels, w, scfg, pcfg = _port()
    kw, ok_kw = {}, {}
    if case == "realistic camera leaves":
        camera = make_realistic_camera(ttf.look_at([0, -10, 6], [0, 4, 0], [0, 0, 1]),
                                       RES, focus_distance=10.0)
        ok_kw = dict(param_names=diff.MATERIAL_PARAMS + diff.LIGHT_PARAMS)
        match = "realistic camera"
    elif case == "random with remat":
        scfg = TSampler("random", 4, RES)
        ok_kw = dict(remat=False)
        match = "random sampler with remat"
    else:
        scfg = dc.replace(scfg, exact=True)
        match = "exact sampler mode"
    with pytest.raises(NotImplementedError, match=match):
        diff.render_grad_step(scene, camera, pixels, 0, w, scfg, pcfg,
                              device="cpu", **kw)
    if ok_kw:
        _, g = diff.render_grad_step(scene, camera, pixels, 0, w, scfg, pcfg,
                                     device="cpu", **ok_kw)
        assert torch.isfinite(g["kd"]).all()
