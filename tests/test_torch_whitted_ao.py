"""The port's Whitted and ambient-occlusion integrators
(pbrt_tpu_torch.integrators.whitted, .ao) held against the JAX package's
through both packages' render_file, and the path integrator on a scene with
media against the JAX package's path integrator.

Scenes: refgold/parity/c4_mirror_d3.pbrt (a mirror, so Whitted's specular
chain runs) with its Integrator line swapped, at 16x16 @ 2 spp, depth 2;
d_media_volpath.pbrt under Integrator "path" at 16x16 @ 1 spp, depth 2.
Bars: tests/test_torch_path.py:58-59's, at least 99.5% of pixels within
rel 1e-3 and image means within 5e-3; the parsed setups agree through
bridge.compare_setups; the traversal calls a sample are (1 + lights)
maxdepth + 1 for Whitted and 1 + nsamples for AO.  (bdpt, mlt and sppm
on the mirror file with an infinite light: tests/test_torch_transport_front.py.)
"""
import re

import numpy as np
import pytest

from pbrt_tpu import render as jrender
from pbrt_tpu import sceneio as jio
from pbrt_tpu_torch import bridge
from pbrt_tpu_torch import render as trender
from pbrt_tpu_torch import sceneio as tio
from pbrt_tpu_torch.integrators.ao import AOConfig
from pbrt_tpu_torch.integrators.direct import DirectLightingConfig
from pbrt_tpu_torch.ops import bvh as kb
from test_torch_path import match_frac, mean_rel
from test_torch_volpath import small_d_media
from jax_traversal_jit import jit_jax_traversal  # noqa: F401  (autouse)
import test_torch_threads  # noqa: F401  (torch's threads under xdist)

MIRROR = "refgold/parity/c4_mirror_d3.pbrt"


def mirror_file(tmp_path, integrator):
    src = open(MIRROR).read()
    src = re.sub(r'Integrator "path"[^\n]*', f"Integrator {integrator}", src)
    src = src.replace('"integer xresolution" [64] "integer yresolution" [64]',
                      '"integer xresolution" [16] "integer yresolution" [16]')
    src = src.replace('"integer pixelsamples" [4]', '"integer pixelsamples" [2]')
    path = tmp_path / "scene.pbrt"
    path.write_text(src)
    return str(path)


def render_both(path, tmp_path):
    ref, _ = jrender.render_file(path, out=str(tmp_path / "jax.pfm"))
    with kb.record_calls() as calls:
        got, _ = trender.render_file(path, out=str(tmp_path / "port.pfm"),
                                     device="cpu")
    ref = np.asarray(ref)
    assert got.shape == ref.shape == (16, 16, 3)
    assert np.isfinite(got).all() and got.mean() > 0
    assert match_frac(ref, got) >= 0.995
    assert mean_rel(ref, got) <= 5e-3
    return len(calls)


def test_whitted_matches_jax(tmp_path):
    path = mirror_file(tmp_path, '"whitted" "integer maxdepth" [2]')
    setup = tio.parse_pbrt_file(path)
    assert bridge.compare_setups(jio.parse_pbrt_file(path), setup) == []
    assert setup.make_integrator_config() == DirectLightingConfig(max_depth=2)
    n_lights = setup.build_scene("cpu").lights.light_type.shape[0]
    assert render_both(path, tmp_path) == 2 * ((1 + n_lights) * 2 + 1)


@pytest.mark.parametrize("cos_sample", ["true", "false"])
def test_ao_matches_jax(tmp_path, cos_sample):
    path = mirror_file(tmp_path, f'"ao" "integer nsamples" [4] "bool cossample" '
                                 f'"{cos_sample}"')
    setup = tio.parse_pbrt_file(path)
    assert bridge.compare_setups(jio.parse_pbrt_file(path), setup) == []
    assert setup.make_integrator_config() == AOConfig(
        cos_sample=cos_sample == "true", n_samples=4)
    assert render_both(path, tmp_path) == 2 * (1 + 4)


def test_path_on_a_media_scene_matches_jax(tmp_path):
    """The path integrator ignores media, as the JAX package's does: a
    material-less boundary ends the path."""
    path = small_d_media(tmp_path, spp=1, integrator="path")
    ref, _ = jrender.render_file(path, out=str(tmp_path / "jax.pfm"))
    got, _ = trender.render_file(path, out=str(tmp_path / "port.pfm"), device="cpu")
    ref = np.asarray(ref)
    assert np.isfinite(got).all() and got.mean() > 0
    assert match_frac(ref, got) >= 0.995
    assert mean_rel(ref, got) <= 5e-3


