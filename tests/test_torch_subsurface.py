"""pbrt-v3's remaining materials through the port's entry points, held
against the JAX package: chip_smoke.write_advanced_pbrt's scene
(kdsubsurface blob, a subsurface "Skin1" sphere, a fourier floor, a disney
and a hair sphere, a matte wall, the emissive sphere) at 24x24, 1 spp,
depth 3, a 16x8 blob and the "uniform" light strategy.

* the .pbrt parse against the JAX package's, column by column
  (bridge.compare_setups), the Fourier and BSSRDF tables among them;
* its path render through render_file against the JAX package's render of
  the file (the subsurface branch: the probe walk, the exit point's NEE,
  the Sw continuation and the separate next-bounce launch);
* the same scene from SceneBuilder: the port's render bit-equal to its
  .pbrt render;
* `python -m pbrt_tpu_torch FILE --device cpu`;
* the path integrator's dims a bounce against the JAX package's, with and
  without subsurface;
* directlighting "all" (maxdepth 1, 24x24, 1 spp), subsurface as its
  surface BSDF, against the JAX package's;
* the refusals: a fourier without "bsdffile", an unknown measured
  subsurface name, volpath with subsurface and a mix of hair; and the
  grad step on a one-triangle scene of each of disney, hair, fourier,
  subsurface and kdsubsurface.

Bars: tests/test_torch_path.py:58-60's, at least 99.5% of pixels within
rel 1e-3 and image means within 5e-3.  The JAX renders run without the
outer jax.jit, op by op (XLA takes ~3 minutes to compile the unrolled
subsurface bounce loop whole, and the op-by-op path render ~90 s, most of
it compiling each loop once; its directlighting render ~45 s).  Both
comparisons are marked slow: with the path render the four test files of
this slice take ~200 one-process seconds, against their Tier-1 budget of
120, and with the direct render alone the Tier-1 run of the whole repo
took 1405 s of its 1470 s cut (the direct test 55 s of a loaded
worker).  The direct render is at 24x24, the path render's size, so run
together (-m slow) the JAX package reuses the loops compiled for the path
render's camera batch."""
import contextlib
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from chip_smoke import blob_mesh, write_advanced_pbrt
from pbrt_tpu import film as jfm
from pbrt_tpu import render as jrender
from pbrt_tpu import scene as jsc
from pbrt_tpu import sceneio as jio
from pbrt_tpu.cameras import make_perspective_camera as jcamera
from pbrt_tpu.core import transform as jtf
from pbrt_tpu.integrators import direct as jdirect
from pbrt_tpu.integrators import path as jpath
from pbrt_tpu.samplers.samplers import SamplerConfig as JSampler
from pbrt_tpu_torch import bridge
from pbrt_tpu_torch import film as tfm
from pbrt_tpu_torch import render as trender
from pbrt_tpu_torch import scene as tsc
from pbrt_tpu_torch import sceneio as tio
from pbrt_tpu_torch.cameras import make_perspective_camera
from pbrt_tpu_torch.core import transform as ttf
from pbrt_tpu_torch.integrators import direct as tdirect
from pbrt_tpu_torch.integrators import path as tpath
from pbrt_tpu_torch.integrators import volpath as tvolpath
from pbrt_tpu_torch.materials import bssrdf as tbs
from pbrt_tpu_torch.materials.measuredss import get_medium_scattering_properties
from pbrt_tpu_torch.samplers.samplers import SamplerConfig as TSampler
from pbrt_tpu_torch.utils.imageio import read_image
from pbrt_tpu_torch.utils.stats import COUNTERS
from test_torch_path import match_frac, mean_rel
import test_torch_threads  # noqa: F401  (torch's threads under xdist)

RES, SPP, DEPTH, BLOB = (24, 24), 1, 3, (16, 8)
UNIFORM = ' "string lightsamplestrategy" "uniform"'
REPO = Path(__file__).resolve().parent.parent


@contextlib.contextmanager
def _eager_jax():
    """jax.jit as the identity: the JAX package's render runs op by op."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", lambda fn=None, **kw: fn if fn is not None
                   else (lambda f: f))
        yield


def advanced_scene(sc, tf, out_dir: Path):
    """write_advanced_pbrt's scene through SceneBuilder, call for call as
    the .pbrt front end makes it: the default matte first, then each
    Material as it comes, kdsubsurface's coefficients inverted from Kd and
    the mean free path, Skin1's from the measured table times its scale."""
    b = sc.SceneBuilder()
    default = b.add_material(sc.MAT_MATTE, kd=(0.5, 0.5, 0.5))
    floor = b.add_material(sc.MAT_FOURIER,
                           fourier_file=str(out_dir / "roughgold_alpha_0.2.bsdf"))
    b.add_triangle_mesh([[0, 1, 2], [2, 3, 0]],
                        [[-10, -10, 0], [10, -10, 0], [10, 10, 0], [-10, 10, 0]],
                        material=floor)
    wall = b.add_material(sc.MAT_MATTE, kd=(0.5, 0.5, 0.8))
    b.add_triangle_mesh([[0, 1, 2], [2, 3, 0]],
                        [[-10, 6, 0], [10, 6, 0], [10, 6, 12], [-10, 6, 12]],
                        material=wall)
    surface = dict(kr=(1.0,) * 3, kt=(1.0,) * 3, roughness=0.0, urough=0.0,
                   vrough=0.0, eta=1.33, remap_roughness=True, ss_g=0.0)
    sig_a, sig_s = tbs.subsurface_from_diffuse(
        tbs.compute_beam_diffusion_bssrdf(0.0, 1.33),
        np.float32([0.8, 0.55, 0.45]).astype(np.float64),
        np.full(3, np.float32(0.05)).astype(np.float64))
    blob = b.add_material(sc.MAT_SUBSURFACE, ss_sigma_a=tuple(sig_a.tolist()),
                          ss_sigma_s=tuple(sig_s.tolist()), ss_scale=1.0, **surface)
    idx, v = blob_mesh(*BLOB, seed=0, center=(0.0, 0.0, 2.2), radius=2.0)
    b.add_triangle_mesh(idx, v, material=blob)
    sig_s, sig_a = get_medium_scattering_properties("Skin1")
    skin = b.add_material(sc.MAT_SUBSURFACE, ss_sigma_a=sig_a, ss_sigma_s=sig_s,
                          ss_scale=40.0, **surface)
    b.add_sphere(tf.translate(3.7, -0.5, 1.2), 1.2, material=skin)
    disney = b.add_material(
        sc.MAT_DISNEY, kd=(0.3, 0.5, 0.8), roughness=0.3, eta=1.5,
        remap_roughness=False,
        disney=(0.3, 0.0, 0.0, 0.3, 0.5, 0.5, 1.0, 0.2, 0.0, 1.0, 0.0, 0.0))
    b.add_sphere(tf.translate(2.2, -3.2, 0.8), 0.8, material=disney)
    hair = b.add_material(sc.MAT_HAIR, eta=1.55, hair=tuple(
        (1.3 * np.array([0.419, 0.697, 1.37])).tolist()) + (0.3, 0.3, 2.0))
    b.add_sphere(tf.translate(-3.4, -1.5, 1.0), 1.0, material=hair)
    b.add_emissive_sphere(tf.translate(0, 5, 8), 0.5, L=(40.0, 40.0, 40.0),
                          material=default)
    return b


@pytest.fixture(scope="module")
def advanced(tmp_path_factory):
    """The file (uniform strategy) and the port's render of it."""
    out = tmp_path_factory.mktemp("advanced")
    path = write_advanced_pbrt(out, res=RES, spp=SPP, blob=BLOB, depth=DEPTH,
                               extra=UNIFORM)
    got, stats = trender.render_file(str(path), out=str(out / "port.pfm"),
                                     device="cpu")
    return out, path, got, stats


def test_parse_matches_jax(advanced):
    out, path = advanced[:2]
    setup = tio.parse_pbrt_file(str(path))
    assert bridge.compare_setups(jio.parse_pbrt_file(str(path)), setup) == []
    fields = setup.scene_builder.build_numpy()
    mats = fields["materials"]
    assert set(mats["mat_type"].tolist()) == {0, 8, 9, 11, 12}
    assert mats["ss_table"].tolist() == [0, 0, 0, 0, 0, 0, 0]  # one (g, eta)
    assert fields["bssrdf_profile"].shape == (100, 64)
    assert len(mats["fourier"]) == 1 and mats["fourier_id"].max() == 0


def test_path_render_runs_the_subsurface_branch(advanced):
    _, _, got, stats = advanced
    assert got.shape == (RES[1], RES[0], 3)
    assert np.isfinite(got).all() and got.mean() > 0
    probes = stats["counters"][COUNTERS.index("Intersections/BSSRDF probe rays")]
    assert probes > 0 and probes % 4 == 0  # 4 segments a walking lane


@pytest.mark.slow
def test_path_render_matches_jax(advanced):
    """The JAX package's render of the file, op by op (~90 s, most of it
    compiling each loop once): marked slow, it alone would take most of the
    Tier-1 budget of this slice's four test files (the module docstring)."""
    _, path, got, _ = advanced
    with _eager_jax():
        ref, _ = jrender.render_setup(jio.parse_pbrt_file(str(path)))
    ref = np.asarray(ref)
    assert got.shape == ref.shape == (RES[1], RES[0], 3)
    assert match_frac(ref, got) >= 0.995
    assert mean_rel(ref, got) <= 5e-3


def test_builder_render_equals_pbrt_render(advanced):
    out, path, got, _ = advanced
    setup = tio.parse_pbrt_file(str(path))
    built = advanced_scene(tsc, ttf, out)
    ref_fields = setup.scene_builder.build_numpy()
    fields = built.build_numpy()
    for k in tsc.SCENE_FIELDS + tsc.BSSRDF_FIELDS:
        np.testing.assert_array_equal(fields[k], ref_fields[k], err_msg=k)
    for k in tsc.MATERIAL_FIELDS + tsc.SUBSURFACE_FIELDS + ("fourier_id",):
        np.testing.assert_array_equal(fields["materials"][k],
                                      ref_fields["materials"][k], err_msg=k)
    setup.scene_builder = built
    img, _ = trender.render_setup(setup, device="cpu")
    np.testing.assert_array_equal(img, got)


def test_cli_renders_on_the_cpu(advanced, tmp_path):
    out, path = advanced[:2]
    r = subprocess.run([sys.executable, "-m", "pbrt_tpu_torch", str(path),
                        "--device", "cpu", "--quiet", "--res", "8", "8",
                        "--spp", "1", "-o", str(tmp_path / "cli.pfm")],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    img = read_image(str(tmp_path / "cli.pfm"))
    assert img.shape == (8, 8, 3) and np.isfinite(img).all() and img.mean() > 0


@pytest.mark.parametrize("types", [(0, 1), (0, 12), (8, 9, 11, 12)])
def test_dims_per_bounce_match_jax(types):
    for bounce in range(7):
        assert tpath.dims_per_bounce(bounce, types) == jpath._dims_per_bounce(
            bounce, types)
    cfg = tpath.PathConfig(max_depth=5)
    assert tpath.n_path_dims(cfg, types) == 5 + sum(
        jpath._dims_per_bounce(b, types) for b in range(5)) + 1
    assert tpath.n_path_dims(cfg, types) == (92 if 12 in types else 42)


@pytest.mark.slow
def test_direct_all_matches_jax(advanced):
    """directlighting "all" on the SceneBuilder scene in both packages:
    subsurface renders as its surface BSDF there, as in pbrt.  Marked slow
    (the module docstring)."""
    out = advanced[0]
    j = advanced_scene(jsc, jtf, out).build()
    ts = bridge.scene_from_numpy(bridge.as_numpy_fields(j), "cpu")
    jc = jcamera(jtf.look_at([0, -8, 4], [0, 0, 2], [0, 0, 1]), RES, fov_deg=45.0)
    tc = bridge.camera_from_numpy(bridge.as_numpy_fields(jc), "cpu")
    with _eager_jax():
        ref = np.asarray(jdirect.render(
            j, jc, jfm.FilmConfig(full_resolution=RES), JSampler("halton", 1, RES),
            jdirect.DirectLightingConfig(max_depth=1, strategy="all")))
    got = tdirect.render(ts, tc, tfm.FilmConfig(full_resolution=RES),
                         TSampler("halton", 1, RES),
                         tdirect.DirectLightingConfig(1, "all"), device="cpu").numpy()
    assert np.isfinite(got).all() and got.mean() > 0
    assert match_frac(ref, got) >= 0.995
    assert mean_rel(ref, got) <= 5e-3


# ---- the JAX package's liberties, refused ----

def _file(tmp_path, body):
    path = tmp_path / "f.pbrt"
    path.write_text(f"WorldBegin\n{body}\nShape \"sphere\"\nWorldEnd\n")
    return path


@pytest.mark.parametrize("body,err,what", [
    ('Material "fourier"', ValueError, "bsdffile"),
    ('Material "subsurface" "string name" "Skin7"', ValueError, "Skin7"),
    ('Material "velvet"', NotImplementedError, "velvet"),
    ('MakeNamedMaterial "h" "string type" "hair"\n'
     'MakeNamedMaterial "m" "string type" "matte"\n'
     'Material "mix" "string namedmaterial1" "h" "string namedmaterial2" "m"',
     NotImplementedError, "mix of hair"),
])
def test_liberties_raise(tmp_path, body, err, what):
    path = _file(tmp_path, body)
    with pytest.raises(err, match=what):
        tio.parse_pbrt_file(str(path)).scene_builder.build(device="cpu")


def _one_material_scene(what, out_dir):
    b = tsc.SceneBuilder()
    if what == "disney":
        m = b.add_material(tsc.MAT_DISNEY)
    elif what == "hair":
        m = b.add_material(tsc.MAT_HAIR)
    elif what == "fourier":
        m = b.add_material(tsc.MAT_FOURIER, fourier_file=str(
            REPO / "pbrt_tpu_torch" / "data" / "roughgold_alpha_0.2.bsdf"))
    else:  # subsurface and kdsubsurface: the coefficients given or inverted
        kw = {}
        if what == "kdsubsurface":
            sig_a, sig_s = tbs.subsurface_from_diffuse(
                tbs.beam_diffusion_table(0.0, 1.33), np.full(3, 0.5), np.ones(3))
            kw = dict(ss_sigma_a=tuple(sig_a.tolist()),
                      ss_sigma_s=tuple(sig_s.tolist()))
        m = b.add_material(tsc.MAT_SUBSURFACE, roughness=0.0, eta=1.33, **kw)
    b.add_triangle_mesh([[0, 1, 2]], [[-1, -1, 0], [1, -1, 0], [0, 1, 0]],
                        material=m)
    b.add_point_light(ttf.translate(0, 0, 2), (1.0, 1.0, 1.0))
    return b.build(device="cpu")


def test_volpath_refuses_subsurface():
    scene = _one_material_scene("subsurface", None)
    res = (4, 4)
    camera = make_perspective_camera(ttf.look_at([0, 0, 3], [0, 0, 0], [0, 1, 0]),
                                     res)
    with pytest.raises(NotImplementedError, match="volpath"):
        tvolpath.render(scene, camera, tfm.FilmConfig(full_resolution=res),
                        TSampler("halton", 1, res), tpath.PathConfig(max_depth=1),
                        device="cpu")


@pytest.mark.parametrize("what", ["disney", "hair", "fourier", "subsurface",
                                  "kdsubsurface"])
def test_grad_step_refuses_the_new_types(what):
    """A one-triangle scene of disney, hair, fourier, subsurface or
    kdsubsurface: the step, held against the JAX package's in
    tests/test_torch_grad_advanced.py, runs, L is the no-grad forward's
    and every leaf is finite."""
    from test_torch_grad_groups import assert_step_runs

    scene = _one_material_scene(what, None)
    res = (4, 4)
    camera = make_perspective_camera(ttf.look_at([0, 0, 3], [0, 0, 0], [0, 1, 0]),
                                     res)
    assert_step_runs(scene, camera, res)
