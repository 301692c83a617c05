"""The port's differentiable rendering step (pbrt_tpu_torch.parallel.diff)
against the JAX package's (pbrt_tpu.parallel.diff) at depth 1 on the scenes
of tests/test_grad.py (tests/test_torch_grad.py holds the rest): the
port's AD against JAX's AD (JAX jitted on its CPU backend, which takes the
watertight oracle, no Pallas), on one set of parameter values put into
both packages (bridge.params_from_numpy).  The JAX step's compile is the
costly part; the file keeps to six tests or fewer so that xdist's loadfile
scheduling hands it out after tests/test_media.py."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pbrt_tpu import film as jfm
from pbrt_tpu.integrators.path import PathConfig as JPath
from pbrt_tpu.integrators.path import make_pixel_grid
from pbrt_tpu.parallel import diff as jdiff
from pbrt_tpu.samplers.samplers import SamplerConfig as JSampler
from pbrt_tpu.statics import scene_statics
from pbrt_tpu_torch import bridge
from pbrt_tpu_torch.parallel import diff
from test_grad import RES, _camera, _plane_scene
from test_torch_grad import LEAVES, _port, _seeded_values, _weights
from test_torch_path import match_frac
from jax_traversal_jit import jit_jax_traversal  # noqa: F401  (autouse)
import test_torch_threads  # noqa: F401  (torch's threads under xdist)


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
