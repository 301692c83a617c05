"""The slice as a whole: a small BASELINE config 3 file (chip_smoke.py's
config3 scene: an imagemap-textured plastic blob from a PLY with uv, a
checkerboard floor, a smooth and a rough glass sphere, an infinite light
with an equirect map beside the emissive sphere; halton, depth 5) written
to tmp_path, parsed by both packages, and rendered, with the uniform light
distribution, by pbrt_tpu.render and by `python -m pbrt_tpu_torch --device
cpu`.

Bars: the parsed setups agree through bridge.compare_setups (integer fields
exactly, float fields to 1e-6 relative), the texture table, the env map
payload, nsamples and the glass columns among them; the images meet
tests/test_torch_path.py:58-59's bars, at least 99.5% of pixels within
rel 1e-3 and image means within 5e-3."""
import numpy as np

from pbrt_tpu import render as jrender
from pbrt_tpu import sceneio as jio
from chip_smoke import write_config3_pbrt
from pbrt_tpu_torch import __main__ as cli
from pbrt_tpu_torch import bridge
from pbrt_tpu_torch import sceneio as tio
from pbrt_tpu_torch.utils.imageio import read_pfm
from test_torch_path import match_frac, mean_rel

SMALL = dict(res=(32, 32), spp=2, blob=(16, 8), skin=(64, 64), env=(32, 16))
# the uniform light distribution: the spatial one's CPU build would double
# the test's time (chip_smoke.py's config3 phase renders with it on the card)
UNIFORM = ' "string lightsamplestrategy" "uniform"'


def test_config3_setup_matches_jax(tmp_path):
    path = str(write_config3_pbrt(tmp_path, **SMALL))
    ref, got = jio.parse_pbrt_file(path), tio.parse_pbrt_file(path)
    assert bridge.compare_setups(ref, got) == []
    scene = got.build_scene("cpu")
    assert scene.tex_ids == (0, 1) and scene.env_light_idx == 0
    assert scene.textures.n_levels.tolist() == [0, 7]
    assert scene.mat_types == (0, 1, 3) and scene.light_types == (3, 4)
    rough = (scene.materials.roughness > 0) & (scene.materials.mat_type == 3)
    assert int(rough.sum()) == 1


def test_config3_cli_matches_jax(tmp_path, capsys):
    path = str(write_config3_pbrt(tmp_path, **SMALL, extra=UNIFORM))
    ref, _ = jrender.render_file(path, out=str(tmp_path / "jax.pfm"))
    ref = np.asarray(ref)
    out = str(tmp_path / "port.pfm")
    assert cli.main([path, "--device", "cpu", "-o", out, "--quiet"]) == 0
    assert "Mrays/s" in capsys.readouterr().out
    got = read_pfm(out)
    assert got.shape == ref.shape == (32, 32, 3)
    assert np.isfinite(got).all() and got.mean() > 0
    assert match_frac(ref, got) >= 0.995
    assert mean_rel(ref, got) <= 5e-3
