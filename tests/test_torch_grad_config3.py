"""BASELINE config 3's families through the port's grad step held against
the JAX package's (pbrt_tpu.parallel.diff.render_grad_step) on the CPU:
tests/test_torch_grad_groups.py's config3 scene (a checkerboard floor and
an imagemap floor, a smooth and a rough glass sphere, an env map, a point
light), 12x12, halton, depth 2, sample 1, on one set of seeded parameter
values put into both packages with bridge.params_from_numpy.

Bars (tests/test_torch_grad.py:127-139): L at match_frac >= 0.995, and
each leaf within 1e-3 of the JAX leaf's largest entry plus 1e-6.  The
step looks textures up at level 0 in both packages: neither passes ray
differentials to its step.

The JAX step is jitted once (~40 one-process seconds to compile) in a
module-level cache; tests/test_torch_grad_{classic,advanced,imaging}.py
reuse this file's helpers.
"""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pbrt_tpu import scene as jsc
from pbrt_tpu.cameras import cameras as jcam
from pbrt_tpu.cameras import realistic as jreal
from pbrt_tpu.core import transform as jtf
from pbrt_tpu.integrators import path as jpath
from pbrt_tpu.integrators.path import PathConfig as JPath
from pbrt_tpu.parallel import diff as jdiff
from pbrt_tpu.samplers.samplers import SamplerConfig as JSampler
from pbrt_tpu.statics import scene_statics
from pbrt_tpu.textures import textures as jtx
from pbrt_tpu_torch import bridge
from pbrt_tpu_torch.parallel import diff
from pbrt_tpu_torch.integrators.path import PathConfig as TPath
from pbrt_tpu_torch.samplers.samplers import SamplerConfig as TSampler
from test_torch_grad_groups import (DEPTH, FD_CASES, NO_CAMERA, RES, SAMPLE,
                                    SCENES, flat_leaves, make_camera, pixels,
                                    step, weights)
from test_torch_path import match_frac
from jax_traversal_jit import jit_jax_traversal  # noqa: F401  (autouse)
import test_torch_threads  # noqa: F401  (torch's threads under xdist)

JAX_CAMERAS = {"perspective": jcam.make_perspective_camera,
               "orthographic": jcam.make_orthographic_camera,
               "environment": jcam.make_environment_camera,
               "realistic": jreal.make_realistic_camera}


def seeded_values(scene, camera, names):
    """One set of parameter values, as numpy in the JAX package's
    extract_params layout: the scene's own with kd, ks, roughness and L
    scaled by seeded factors in [0.8, 1.2] (a smooth surface stays
    smooth)."""
    vals = jax.tree_util.tree_map(np.asarray,
                                  jdiff.extract_params(scene, camera, names))
    rs = np.random.RandomState(11)
    for k in ("kd", "ks", "roughness", "light_L"):
        vals[k] = (vals[k] * rs.uniform(0.8, 1.2, vals[k].shape)).astype(np.float32)
    return vals


@contextlib.contextmanager
def eager_jax():
    """jax.jit as the identity and the bounce loop unrolled
    (pbrt_tpu/integrators/path.py _FORCE_UNROLL, the reference its scan is
    held against): the JAX package's step runs op by op, for a scene whose
    jitted step, or scan body, takes XLA many minutes to compile."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", lambda fn=None, **kw: fn if fn is not None
                   else (lambda f: f))
        mp.setattr(jpath, "_FORCE_UNROLL", True)
        yield


@functools.lru_cache(maxsize=None)
def jax_and_port(group, kind="perspective", sampler="halton", depth=DEPTH,
                 eager=False):
    """(L, leaves) of the JAX package's step (remat off; jitted, or op by op
    when eager) and of the port's (remat on, but for the random sampler),
    flat as test_torch_grad_groups.flat_leaves gives them, on the same
    parameter values, at sample 1 with the seeded weights."""
    js = SCENES[group](jsc, jtf, jtx).build()
    jc = make_camera(kind, jtf, JAX_CAMERAS)
    names = NO_CAMERA if kind == "realistic" else diff.DEFAULT_PARAMS
    vals = seeded_values(js, jc, names)
    js2, jc2 = jdiff.apply_params(js, jc, vals)
    jpix = jnp.asarray(pixels().numpy())
    w, statics = jnp.asarray(weights()), scene_statics(js)

    def jstep(s, c):
        return jdiff.render_grad_step(
            s, c, jpix, jnp.uint32(SAMPLE), w, JSampler(sampler, 4, RES),
            JPath(max_depth=depth), statics, param_names=names, remat=False)

    if eager:
        with eager_jax():
            jL, jg = jstep(js2, jc2)
    else:
        jL, jg = jax.jit(jstep)(js2, jc2)
    jflat = {}
    for k, v in jg.items():
        if k == "camera":
            jflat.update({f"camera.{c}": np.asarray(x, np.float32)
                          for c, x in v.items()})
        else:
            jflat[k] = np.asarray(v, np.float32)

    ts = bridge.scene_from_numpy(bridge.as_numpy_fields(js), "cpu")
    tc = bridge.camera_from_numpy(bridge.as_numpy_fields(jc), "cpu")
    L, g = step(ts, tc, TSampler(sampler, 4, RES), TPath(max_depth=depth), names,
                remat=sampler != "random",
                params=bridge.params_from_numpy(vals, "cpu"))
    return np.asarray(jL), jflat, L.numpy(), flat_leaves(g)


def assert_matches_jax(result, fd_checked=()):
    """L at match_frac >= 0.995; every leaf the JAX package gives finite
    within 1e-3 of its largest entry plus 1e-6; every port leaf finite; the
    leaves the JAX package gives non-finite exactly fd_checked (each held
    against the port's central differences in test_torch_grad_groups.py)."""
    jL, jflat, L, flat = result
    assert match_frac(jL, L) >= 0.995
    assert set(jflat) == set(flat)
    bad = set()
    for k, ref in jflat.items():
        got = flat[k]
        assert got.shape == ref.shape, k
        assert np.isfinite(got).all(), k
        if not np.isfinite(ref).all():
            bad.add(k)
            continue
        bar = 1e-3 * float(np.abs(ref).max()) + 1e-6
        assert float(np.abs(got - ref).max()) <= bar, (k, np.abs(got - ref).max(), bar)
    assert bad == set(fd_checked), bad
    assert max(float(np.abs(v).max()) for v in flat.values()) > 0


def fd_leaves(group):
    """The leaves test_torch_grad_groups.FD_CASES holds for a group."""
    return {leaf for g, leaf, _ in FD_CASES if g == group}


def test_grads_match_jax_at_depth1():
    """Depth 1: the camera rays' glass, texture and env-map hits and the
    specular bounce's escape; every leaf finite in both packages."""
    assert_matches_jax(jax_and_port("config3", depth=1))


@pytest.mark.slow
def test_grads_match_jax_at_depth2():
    """Depth 2, glass's inside bounce: the JAX package's camera_to_world,
    raster_to_camera and roughness leaves are NaN there (its refract and
    Fresnel square roots past total internal reflection,
    sqrt(max(0, x))' = inf times 0; pbrt_tpu/core/vecmath.py:240); the
    port's are finite and held against its central differences.  Jitted:
    ~130 one-process seconds, most of them XLA compiling the glass
    branch."""
    assert_matches_jax(jax_and_port("config3"), fd_leaves("config3"))
