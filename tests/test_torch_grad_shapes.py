"""Differentiable rendering (parallel/diff.py render_grad_step) on the new
shapes: a quadric scene (the five new quadrics and a phi-clipped sphere),
an instanced scene and a curve scene under the hair material, each a
plastic floor lit by an emissive sphere behind the camera, 12x12, sobol.

Tier-1 (the port alone): at depth 2 the step's L equals the no_grad
forward bit for bit, every leaf is finite, and the step with path replay
equals the one without to 1e-4 of each leaf's largest entry.

Slow (-m slow; the JAX package's jitted step takes ~70 s on the instances,
~100 s on the quadrics and ~13 min on the curves, XLA compiling the
traversal loop's curve test under autodiff): the port's step against the
JAX package's at depth 1, on one set of parameter values put into both,
each leaf within 1e-3 of its largest entry (tests/test_torch_grad.py's
bar), the lanes whose L differs by more than 1e-3 weighted 0 on both sides
(chip_smoke.py's grad_card_cpu rule: XLA:CPU contracts the records'
multiply-adds under jit, so a lane can take another path).  The disk is
left out of the JAX comparison: its hits carry no error bound (disk.cpp),
so its shadow rays' self-intersection flips with the last bit of the hit
point."""
import functools

import numpy as np
import pytest
import torch

from pbrt_tpu_torch import bridge
from pbrt_tpu_torch import scene as tsc
from pbrt_tpu_torch.cameras.cameras import make_perspective_camera
from pbrt_tpu_torch.core import transform as ttf
from pbrt_tpu_torch.integrators import path as tpath
from pbrt_tpu_torch.parallel import diff
from pbrt_tpu_torch.samplers.samplers import SamplerConfig
import test_torch_threads  # noqa: F401  (torch's threads under xdist)

RES = (12, 12)


def _base(sc, tf, kind):
    b = sc.SceneBuilder()
    floor = b.add_material(sc.MAT_PLASTIC, kd=(0.4, 0.3, 0.2), ks=(0.5, 0.5, 0.5),
                           roughness=0.3)
    b.add_triangle_mesh([[0, 1, 2], [2, 3, 0]],
                        [[-50, -50, -1], [50, -50, -1], [50, 50, -1], [-50, 50, -1]],
                        material=floor)
    dark = b.add_material(sc.MAT_MATTE, kd=(0.0, 0.0, 0.0))
    b.add_emissive_sphere(tf.translate(0, -14, 10), 1.5, L=(60.0, 60.0, 60.0),
                          material=dark)
    m = b.add_material(sc.MAT_HAIR if kind == "curves" else sc.MAT_MATTE,
                       kd=(0.6, 0.4, 0.3))
    return b, m


def shape_scene(sc, tf, kind, disk=True):
    b, m = _base(sc, tf, kind)
    rs = np.random.RandomState(4)
    if kind == "quadrics":
        b.add_sphere(tf.translate(-2, 0, 0), 0.8, material=m, phimax_deg=270)
        b.add_quadric(sc.SHAPE_CYLINDER, tf.translate(2, 0, 0) @ tf.rotate(30, 1, 0, 0),
                      (0.5, -0.5, 0.8, np.deg2rad(360)), m, -1, False)
        b.add_cone(tf.translate(0, 2, -0.5), 0.7, 1.2, material=m, phimax_deg=320)
        b.add_paraboloid(tf.translate(0, 0, 0), 0.6, 0.1, 0.9, material=m,
                         reverse_orientation=True)
        b.add_hyperboloid(tf.translate(2, 2, 0), (0.3, 0, -0.5), (0.6, 0.2, 0.6),
                          material=m, phimax_deg=350)
        if disk:
            b.add_quadric(sc.SHAPE_DISK, tf.translate(0, -2, 0.5),
                          (1.0, 0.3, 0.0, np.deg2rad(300)), m, -1, True)
    elif kind == "instances":
        b.begin_mesh_template()
        b.add_triangle_mesh(np.arange(60).reshape(-1, 3), rs.randn(60, 3) * 0.7,
                            n=rs.randn(60, 3), uv=rs.rand(60, 2), material=m)
        t = b.end_mesh_template()
        for i in range(4):
            b.add_mesh_instance(t, tf.translate(rs.randn() * 1.5, rs.randn() * 1.5, 0)
                                @ tf.rotate(40.0 * i, 0, 1, 1))
    else:
        rs = np.random.RandomState(3)
        for i in range(15):
            cp = np.array([rs.randn() * 1.5, rs.randn() * 1.5, -1.0]) + np.cumsum(
                rs.randn(4, 3) * 0.3 + [0, 0, 0.6], 0)
            ctype = ("flat", "ribbon", "cylinder")[i % 3]
            b.add_curve(cp, 0.3, 0.1, ctype,
                        rs.randn(2, 3) if ctype == "ribbon" else None, None, m)
    return b


KINDS = ["quadrics", "instances", "curves"]


def _camera(cameras_mod, tf):
    return cameras_mod(tf.look_at([0, -8, 5], [0, 0, 0], [0, 0, 1]), RES, fov_deg=40.0)


def _weights():
    return np.random.RandomState(7).uniform(0.5, 1.5, (RES[0] * RES[1], 3)).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _port(kind, depth):
    scene = shape_scene(tsc, ttf, kind).build(device="cpu")
    camera = _camera(make_perspective_camera, ttf)
    pixels = torch.as_tensor(tpath.make_pixel_grid(_film()))
    return scene, camera, pixels, SamplerConfig("sobol", 4, RES), tpath.PathConfig(
        max_depth=depth)


def _film():
    from pbrt_tpu_torch.film import FilmConfig

    return FilmConfig(full_resolution=RES)


def _flat(g):
    out = {}
    for k, v in g.items():
        for kk, x in (v.items() if isinstance(v, dict) else [(k, v)]):
            if isinstance(x, torch.Tensor):
                out[kk] = x
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_step_runs_on_the_new_shapes(kind):
    scene, camera, pixels, scfg, pcfg = _port(kind, 2)
    assert tpath is not None and scene.quadric_types
    w = torch.as_tensor(_weights())
    L, g = diff.render_grad_step(scene, camera, pixels, 0, w, scfg, pcfg, device="cpu")
    with torch.no_grad():
        L_fwd = diff.render_batch_radiance(scene, camera, pixels, 0, scfg, pcfg)
    assert torch.equal(L, L_fwd) and float(L.mean()) > 0
    leaves = _flat(g)
    for k, v in leaves.items():
        assert bool(torch.isfinite(v).all()), k
    assert float(leaves["kd"].abs().max()) > 0
    _, g2 = diff.render_grad_step(scene, camera, pixels, 0, w, scfg, pcfg,
                                  remat=False, device="cpu")
    for k, v in _flat(g2).items():
        bar = 1e-4 * float(v.abs().max()) + 1e-12
        assert float((leaves[k] - v).abs().max()) <= bar, k


@functools.lru_cache(maxsize=None)
def _jax_step(kind):
    import jax
    import jax.numpy as jnp

    from pbrt_tpu import film as jfm
    from pbrt_tpu import scene as jsc
    from pbrt_tpu.cameras import make_perspective_camera as jcam
    from pbrt_tpu.core import transform as jtf
    from pbrt_tpu.integrators.path import PathConfig as JPath
    from pbrt_tpu.integrators.path import make_pixel_grid
    from pbrt_tpu.parallel import diff as jdiff
    from pbrt_tpu.samplers.samplers import SamplerConfig as JSampler
    from pbrt_tpu.statics import scene_statics

    js = shape_scene(jsc, jtf, kind, disk=False).build()
    jc = _camera(jcam, jtf)
    pixels = jnp.asarray(make_pixel_grid(jfm.FilmConfig(full_resolution=RES)))
    statics = scene_statics(js)
    step = jax.jit(lambda s, c, w: jdiff.render_grad_step(
        s, c, pixels, jnp.uint32(0), w, JSampler("sobol", 4, RES), JPath(max_depth=1),
        statics, remat=False))
    return js, jc, step


@pytest.mark.slow
@pytest.mark.parametrize("kind", KINDS)
def test_step_matches_jax_at_depth1(kind):
    import jax

    js, jc, step = _jax_step(kind)
    scene = bridge.scene_from_numpy(bridge.as_numpy_fields(js), "cpu")
    camera = bridge.camera_from_numpy(bridge.as_numpy_fields(jc), "cpu")
    _, _, pixels, scfg, _ = _port(kind, 1)
    pcfg = tpath.PathConfig(max_depth=1)
    w = _weights()
    jL, _ = step(js, jc, w)
    with torch.no_grad():
        L = diff.render_batch_radiance(scene, camera, pixels, 0, scfg, pcfg).numpy()
    rel = np.abs(L - np.asarray(jL)) / np.maximum(np.abs(np.asarray(jL)), 1e-2)
    same = np.all(rel <= 1e-3, -1)
    assert same.mean() >= 0.95
    w = w * same[:, None].astype(np.float32)
    _, jg = step(js, jc, w)
    jg = _flat({k: (v if not isinstance(v, dict) else v)
                for k, v in jax.tree_util.tree_map(
                    lambda x: torch.as_tensor(np.asarray(x)), jg).items()})
    _, g = diff.render_grad_step(scene, camera, pixels, 0, torch.as_tensor(w), scfg,
                                 pcfg, device="cpu")
    g = _flat(g)
    for k in ("kd", "ks", "roughness", "light_L", "camera_to_world",
              "raster_to_camera"):
        ref, got = jg[k], g[k]
        assert bool(torch.isfinite(ref).all()), k
        bar = 1e-3 * float(ref.abs().max()) + 1e-6
        assert float((got - ref).abs().max()) <= bar, k
