"""Image formation through the .pbrt front end: every new sampler, filter
and camera and the exact sampler mode rendered by `python -m
pbrt_tpu_torch --device cpu`; a file with a gaussian filter, an
orthographic camera and the stratified sampler against the JAX package's
render of it; and directlighting "all" under zerotwosequence, where a
light's sample count rounds up to a power of two as in the JAX package
(the comparisons of that render, ~25 s, and of two exact-mode renders,
~7 s each, with the JAX package's are marked slow: most of each is XLA
compiling the JAX package's render).

Bars: tests/test_torch_path.py:58-59's, at least 99.5% of pixels within
rel 1e-3 and image means within 5e-3."""
import pathlib

import numpy as np
import pytest

from pbrt_tpu import render as jrender
from pbrt_tpu_torch import __main__ as cli
from pbrt_tpu_torch.integrators import direct as tdirect
from pbrt_tpu_torch.samplers.samplers import SamplerConfig
from pbrt_tpu_torch.sceneio import parse_pbrt_file
from pbrt_tpu_torch.utils.imageio import read_pfm
from test_torch_path import match_frac, mean_rel
from jax_traversal_jit import jit_jax_traversal  # noqa: F401  (autouse)
import test_torch_threads  # noqa: F401  (torch's threads under xdist)

ROOT = pathlib.Path(__file__).resolve().parent.parent
FLOOR = ROOT / "refgold" / "parity" / "a_floor_point.pbrt"
AREALIGHT = ROOT / "refgold" / "parity" / "b_arealight.pbrt"
CAMERA = 'Camera "perspective" "float fov" [60]'
SAMPLER = 'Sampler "halton" "integer pixelsamples" [1]'


def scene_file(out_dir, name, camera=CAMERA, filt="", sampler=SAMPLER,
               integrator='Integrator "path" "integer maxdepth" [1]', src=FLOOR):
    """A copy of a parity scene with its camera, filter, sampler and
    integrator lines swapped."""
    text = src.read_text()
    for old in (CAMERA, 'Integrator "path" "integer maxdepth" [1]'):
        assert old in text
    text = text.replace(CAMERA, f"{camera}\n{filt}").replace(
        'Integrator "path" "integer maxdepth" [1]', integrator)
    text = "\n".join(sampler if ln.startswith("Sampler") else ln
                     for ln in text.splitlines())
    path = pathlib.Path(out_dir) / f"{name}.pbrt"
    path.write_text(text)
    return str(path)


OPTIONS = {
    "random": dict(sampler='Sampler "random" "integer pixelsamples" [2]'),
    "stratified": dict(sampler='Sampler "stratified" "integer pixelsamples" [2]'),
    "lowdiscrepancy": dict(sampler='Sampler "lowdiscrepancy" "integer pixelsamples" [2]'),
    "maxmin": dict(sampler='Sampler "maxmin" "integer pixelsamples" [2]'),
    "triangle": dict(filt='PixelFilter "triangle"'),
    "gaussian": dict(filt='PixelFilter "gaussian"'),
    "mitchell": dict(filt='PixelFilter "mitchell"'),
    "sinc": dict(filt='PixelFilter "sinc"'),
    "orthographic": dict(camera='Camera "orthographic"'),
    "environment": dict(camera='Camera "environment"'),
    "realistic": dict(camera='Camera "realistic" "float focusdistance" [5]'),
    "exact-halton": dict(sampler='Sampler "halton" "integer pixelsamples" [2]'),
    "exact-stratified": dict(sampler='Sampler "stratified" "integer pixelsamples" [4]'),
    "exact-zerotwosequence": dict(
        sampler='Sampler "zerotwosequence" "integer pixelsamples" [2]'),
}


@pytest.mark.parametrize("option", list(OPTIONS))
def test_cli_renders_each_option(tmp_path, monkeypatch, option):
    if option.startswith("exact-"):
        monkeypatch.setenv("PBRT_TPU_EXACT_SAMPLER", "1")
    path = scene_file(tmp_path, option, **OPTIONS[option])
    if option.startswith("exact-"):
        assert parse_pbrt_file(path).make_sampler_config().exact
    out = str(tmp_path / "out.pfm")
    assert cli.main([path, "--device", "cpu", "-o", out, "--res", "12", "8",
                     "--quiet"]) == 0
    img = read_pfm(out)
    assert img.shape == (8, 12, 3) and np.isfinite(img).all() and img.mean() > 0


def test_file_render_matches_jax(tmp_path):
    """A 16x16 @ 2 spp, depth-2 file with a gaussian filter, an orthographic
    camera and the stratified sampler: the port's render against the JAX
    package's."""
    path = scene_file(
        tmp_path, "imaging", filt='PixelFilter "gaussian"',
        camera='Camera "orthographic"',
        sampler='Sampler "stratified" "integer pixelsamples" [2]',
        integrator='Integrator "path" "integer maxdepth" [2]')
    ref, _ = jrender.render_file(path, out=str(tmp_path / "j.pfm"), res=(16, 16))
    out = str(tmp_path / "t.pfm")
    assert cli.main([path, "--device", "cpu", "-o", out, "--res", "16", "16",
                     "--quiet"]) == 0
    got = read_pfm(out)
    ref = np.asarray(ref)
    assert got.shape == (16, 16, 3) and np.isfinite(got).all() and got.mean() > 0
    assert match_frac(ref, got) >= 0.995
    assert mean_rel(ref, got) <= 5e-3


def _direct_all_file(tmp_path, sampler):
    """b_arealight with "integer nsamples" [3] on its light, under
    directlighting "all" at maxdepth 1."""
    src = AREALIGHT.read_text().replace(
        'AreaLightSource "area" "color L" [40 40 40]',
        'AreaLightSource "area" "color L" [40 40 40] "integer nsamples" [3]')
    light_file = pathlib.Path(tmp_path) / "area3.pbrt"
    light_file.write_text(src)
    return scene_file(tmp_path, "direct_all", src=light_file, sampler=sampler,
                      integrator='Integrator "directlighting" "integer maxdepth" '
                                 '[1] "string strategy" "all"')


def test_light_sample_counts_round_as_in_jax(tmp_path):
    """pbrt's RoundCount gives a light with nsamples 3 an array of 4 under
    sobol, zerotwosequence and maxmin (pbrt_tpu/integrators/direct.py:
    173-178) and of 3 under the others, and the render draws that many:
    one closest-hit launch, then one shadow launch an array sample."""
    from pbrt_tpu_torch.ops import bvh

    path = _direct_all_file(tmp_path,
                            'Sampler "lowdiscrepancy" "integer pixelsamples" [1]')
    setup = parse_pbrt_file(path)
    scene = setup.build_scene("cpu")
    counts = {name: tdirect.light_sample_counts(scene, SamplerConfig(name, 2, (8, 8)))
              for name in ("sobol", "zerotwosequence", "maxmin", "halton",
                           "stratified", "random")}
    assert counts == {"sobol": (4,), "zerotwosequence": (4,), "maxmin": (4,),
                      "halton": (3,), "stratified": (3,), "random": (3,)}
    film_cfg, filt = setup.make_film_config()
    with bvh.record_calls() as calls:
        img = tdirect.render(scene, setup.make_camera(), film_cfg,
                             setup.make_sampler_config(),
                             setup.make_integrator_config(), filt, device="cpu")
    assert len(calls) == 2 + 4 and float(img.mean()) > 0


@pytest.mark.slow
def test_direct_all_under_zerotwosequence_matches_jax(tmp_path):
    """The 8x8 directlighting "all" render of that file at 2 spp against
    the JAX package's, which draws 4 array samples (~25 s, most of it
    XLA compiling the JAX package's four unrolled estimate_direct calls)."""
    path = _direct_all_file(tmp_path,
                            'Sampler "lowdiscrepancy" "integer pixelsamples" [2]')
    ref, _ = jrender.render_file(path, out=str(tmp_path / "j.pfm"), res=(8, 8))
    out = str(tmp_path / "t.pfm")
    assert cli.main([path, "--device", "cpu", "-o", out, "--res", "8", "8",
                     "--quiet"]) == 0
    got = read_pfm(out)
    ref = np.asarray(ref)
    assert np.isfinite(got).all() and got.mean() > 0
    assert match_frac(ref, got) >= 0.995
    assert mean_rel(ref, got) <= 5e-3


@pytest.mark.slow
@pytest.mark.parametrize("sampler", [
    'Sampler "halton" "integer pixelsamples" [2]',
    'Sampler "stratified" "integer pixelsamples" [4]'])
def test_exact_mode_render_matches_jax(tmp_path, monkeypatch, sampler):
    """PBRT_TPU_EXACT_SAMPLER=1 at 24x20 (2x2 tiles of 16, ragged), depth 2:
    the port's render against the JAX package's."""
    monkeypatch.setenv("PBRT_TPU_EXACT_SAMPLER", "1")
    path = scene_file(tmp_path, "exact", sampler=sampler,
                      integrator='Integrator "path" "integer maxdepth" [2]')
    ref, _ = jrender.render_file(path, out=str(tmp_path / "j.pfm"), res=(24, 20))
    out = str(tmp_path / "t.pfm")
    assert cli.main([path, "--device", "cpu", "-o", out, "--res", "24", "20",
                     "--quiet"]) == 0
    got = read_pfm(out)
    ref = np.asarray(ref)
    assert match_frac(ref, got) >= 0.995
    assert mean_rel(ref, got) <= 5e-3
