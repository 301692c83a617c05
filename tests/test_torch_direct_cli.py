"""Integrator "directlighting" through the .pbrt front end:
refgold/parity/b_arealight.pbrt with its Integrator line swapped, rendered
by pbrt_tpu.render and by `python -m pbrt_tpu_torch --device cpu`, for
strategies "one" and "all"; and the "one" render at maxdepth 1 against the
port's path render of the original file, which draws the same sampler dims
5-9 and so gives the same image (the check behind chip_smoke.py's direct
phase).

Bars: tests/test_torch_path.py:58-59's, at least 99.5% of pixels within
rel 1e-3 and image means within 5e-3; the depth-1 identity bit for bit."""
import pathlib

import numpy as np
import pytest

from pbrt_tpu import render as jrender
from pbrt_tpu_torch import __main__ as cli
from pbrt_tpu_torch import render as trender
from pbrt_tpu_torch.utils.imageio import read_pfm
from test_torch_path import match_frac, mean_rel
from jax_traversal_jit import jit_jax_traversal  # noqa: F401  (autouse)
import test_torch_threads  # noqa: F401  (torch's threads under xdist)

ROOT = pathlib.Path(__file__).resolve().parent.parent
AREALIGHT = ROOT / "refgold" / "parity" / "b_arealight.pbrt"
PATH_LINE = 'Integrator "path" "integer maxdepth" [1]'


def direct_file(out_dir, strategy):
    """b_arealight.pbrt with Integrator "directlighting" in a copy."""
    src = AREALIGHT.read_text()
    assert PATH_LINE in src
    path = pathlib.Path(out_dir) / f"b_direct_{strategy}.pbrt"
    path.write_text(src.replace(
        PATH_LINE, f'Integrator "directlighting" "integer maxdepth" [1] '
                   f'"string strategy" "{strategy}"'))
    return str(path)


@pytest.mark.parametrize("strategy", ["one", "all"])
def test_directlighting_file_matches_jax(tmp_path, strategy):
    path = direct_file(tmp_path, strategy)
    ref, _ = jrender.render_file(path, out=str(tmp_path / "j.pfm"), res=(32, 32),
                                 spp=2)
    out = str(tmp_path / "t.pfm")
    assert cli.main([path, "--device", "cpu", "-o", out, "--res", "32", "32",
                     "--spp", "2", "--quiet"]) == 0
    got = read_pfm(out)
    assert np.isfinite(got).all() and got.mean() > 0
    assert match_frac(np.asarray(ref), got) >= 0.995
    assert mean_rel(np.asarray(ref), got) <= 5e-3


def test_direct_one_at_depth1_is_the_path_render(tmp_path):
    kw = dict(res=(32, 32), spp=2, device="cpu")
    direct, stats = trender.render_file(direct_file(tmp_path, "one"),
                                        out=str(tmp_path / "d.pfm"), **kw)
    path, _ = trender.render_file(str(AREALIGHT), out=str(tmp_path / "p.pfm"),
                                  **kw)
    assert direct.shape == (32, 32, 3) and stats["rays_traced"] > 0
    np.testing.assert_array_equal(direct, path)
