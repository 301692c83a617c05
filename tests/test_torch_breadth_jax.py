"""pbrt-v3's classic material and light set through the port's entry
points, held against the JAX package on chip_smoke.write_breadth_pbrt's
scene (tests/test_torch_breadth.py builds it and holds the refusals):

* the .pbrt parse against the JAX package's, column by column
  (bridge.compare_setups), with the "uniform" light strategy (the spatial
  one is held in tests/test_torch_lights.py: its grid costs minutes on the
  CPU at this scene's extent);
* its path render through render_file (2 spp, depth 3) against the JAX
  package's render of the file;
* the same scene from SceneBuilder: the port's path render bit-equal to
  its .pbrt render, and directlighting "all" (maxdepth 1, 16x16, 1 spp)
  against the JAX package's;
* `python -m pbrt_tpu_torch FILE --device cpu`.

Bars: tests/test_torch_path.py:58-60's, at least 99.5% of pixels within
rel 1e-3 and image means within 5e-3.  The two JAX renders are the costly
part (XLA compiles them on the CPU); each runs once, in a module fixture.
The file keeps to six tests or fewer: xdist's loadfile scheduling hands
out files with more tests first, and this one's ~250 s ahead of
tests/test_media.py (six tests, ~1,000 s) made the whole run end later."""
import subprocess
import sys

import jax
import numpy as np
import pytest

from chip_smoke import write_breadth_pbrt
from pbrt_tpu import film as jfm
from pbrt_tpu import render as jrender
from pbrt_tpu import scene as jsc
from pbrt_tpu import sceneio as jio
from pbrt_tpu.cameras import make_perspective_camera as jcamera
from pbrt_tpu.core import transform as jtf
from pbrt_tpu.integrators import direct as jdirect
from pbrt_tpu.samplers.samplers import SamplerConfig as JSampler
from pbrt_tpu.textures import textures as jtx
from pbrt_tpu_torch import bridge
from pbrt_tpu_torch import film as tfm
from pbrt_tpu_torch import render as trender
from pbrt_tpu_torch import scene as tsc
from pbrt_tpu_torch import sceneio as tio
from pbrt_tpu_torch.core import transform as ttf
from pbrt_tpu_torch.integrators import direct as tdirect
from pbrt_tpu_torch.samplers.samplers import SamplerConfig as TSampler
from pbrt_tpu_torch.textures import textures as ttx
from pbrt_tpu_torch.utils.imageio import read_image
from test_torch_breadth import BLOB, DEPTH, REPO, RES, SPP, UNIFORM, breadth_scene
from test_torch_path import match_frac, mean_rel
from jax_traversal_jit import jit_jax_traversal  # noqa: F401  (autouse)
import test_torch_threads  # noqa: F401  (torch's threads under xdist)


@pytest.fixture(scope="module")
def breadth(tmp_path_factory):
    """The file (uniform strategy), the port's render of it and the JAX
    package's (the first of the two JAX renders)."""
    out = tmp_path_factory.mktemp("breadth")
    path = write_breadth_pbrt(out, res=RES, spp=SPP, blob=BLOB, depth=DEPTH,
                              extra=UNIFORM)
    ref, _ = jrender.render_setup(jio.parse_pbrt_file(str(path)))
    got, stats = trender.render_file(str(path), out=str(out / "port.pfm"),
                                     device="cpu")
    return out, path, np.asarray(ref), got, stats


def test_parse_matches_jax(breadth):
    out, path = breadth[:2]
    setup = tio.parse_pbrt_file(str(path))
    assert bridge.compare_setups(jio.parse_pbrt_file(str(path)), setup) == []
    fields = setup.scene_builder.build_numpy()
    assert set(fields["materials"]["mat_type"].tolist()) == {0, 4, 5, 6, 7, 10}
    assert set(fields["lights"]["light_type"].tolist()) == {1, 2, 3, 5, 6}
    assert (fields["materials"]["opacity_tex"] >= 0).sum() == 1


def test_path_render_matches_jax(breadth):
    _, _, ref, got, stats = breadth
    assert got.shape == ref.shape == (RES[1], RES[0], 3)
    assert np.isfinite(got).all() and got.mean() > 0
    assert match_frac(ref, got) >= 0.995
    assert mean_rel(ref, got) <= 5e-3
    assert "Light distribution" not in stats["phases"]  # none to build


def test_builder_render_equals_pbrt_render(breadth):
    """The port's SceneBuilder scene in place of the parsed one: the same
    arrays, the same image, bit for bit."""
    out, path, _, got, _ = breadth
    setup = tio.parse_pbrt_file(str(path))
    built = breadth_scene(tsc, ttf, ttx, out)
    ref_fields = setup.scene_builder.build_numpy()
    fields = built.build_numpy()
    for k in tsc.SCENE_FIELDS:
        np.testing.assert_array_equal(fields[k], ref_fields[k], err_msg=k)
    setup.scene_builder = built
    img, _ = trender.render_setup(setup, device="cpu")
    np.testing.assert_array_equal(img, got)


@pytest.fixture(scope="module")
def direct_all(breadth):
    """directlighting "all" (maxdepth 1, 16x16, 1 spp, halton) on the
    SceneBuilder scene in both packages (the second JAX render).  The JAX
    package's render runs its sample step without its outer jax.jit, op by
    op (each traversal loop still one compiled XLA loop): XLA takes ~8
    minutes to compile the step whole, with one estimate_direct unrolled a
    light for seven lights, and the eager step ~40 s."""
    out = breadth[0]
    res = (16, 16)
    j = breadth_scene(jsc, jtf, jtx, out).build()
    ts = bridge.scene_from_numpy(bridge.as_numpy_fields(j), "cpu")
    jc = jcamera(jtf.look_at([0, -8, 4], [0, 0, 2], [0, 0, 1]), res, fov_deg=45.0)
    tc = bridge.camera_from_numpy(bridge.as_numpy_fields(jc), "cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", lambda fn, **kw: fn)
        ref = np.asarray(jdirect.render(
            j, jc, jfm.FilmConfig(full_resolution=res), JSampler("halton", 1, res),
            jdirect.DirectLightingConfig(max_depth=1, strategy="all")))
    got = tdirect.render(ts, tc, tfm.FilmConfig(full_resolution=res),
                         TSampler("halton", 1, res),
                         tdirect.DirectLightingConfig(1, "all"), device="cpu")
    return ref, got.numpy()


def test_direct_all_matches_jax(direct_all):
    ref, got = direct_all
    assert np.isfinite(got).all() and got.mean() > 0
    assert match_frac(ref, got) >= 0.995
    assert mean_rel(ref, got) <= 5e-3


def test_cli_renders_on_the_cpu(breadth, tmp_path):
    out, path = breadth[:2]
    r = subprocess.run([sys.executable, "-m", "pbrt_tpu_torch", str(path),
                        "--device", "cpu", "--quiet", "--res", "8", "8",
                        "--spp", "1", "-o", str(tmp_path / "cli.pfm")],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    img = read_image(str(tmp_path / "cli.pfm"))
    assert img.shape == (8, 8, 3) and np.isfinite(img).all() and img.mean() > 0
