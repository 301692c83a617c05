"""Procedural cubic curves (shapes/curve.py, SceneBuilder.add_curve, the
Shape "curve" statement) against the JAX package (pbrt_tpu.shapes.curve,
pbrt_tpu.scene, pbrt_tpu.sceneio) on the CPU.

* The builder's rows (split_curve_for_build, pack_curve_rows, the bounds)
  and a file of flat, ribbon and cylinder chains parse to the same arrays,
  bit for bit.
* curve_intersect with and without want_record on 4,096 rays aimed at the
  curves (hits, t_max cuts and misses), against the JAX function run
  eagerly: hit flags on at least 99.9% of the lanes and t to rtol 1e-5 on
  the lanes both hit (torch's CPU square root and sine are not XLA's: a
  ulp moves a width test's edge), the record's point, uv, normals and
  tangents to 1e-4 relative (absolute on unit vectors).
* The hair material reads h = -1 + 2v from the curve's own uv: a render of
  a hair patch on curves is finite and non-zero, twice bit for bit; the
  image against the JAX package's is slow (-m slow)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu import render as jrender
from pbrt_tpu import scene as jsc
from pbrt_tpu import sceneio as jio
from pbrt_tpu.core import transform as jtf
from pbrt_tpu.shapes import curve as jcurve
from pbrt_tpu_torch import __main__ as cli
from pbrt_tpu_torch import bridge
from pbrt_tpu_torch import scene as tsc
from pbrt_tpu_torch import sceneio as tio
from pbrt_tpu_torch.core import transform as ttf
from pbrt_tpu_torch.shapes import curve as tcurve
from pbrt_tpu_torch.utils.imageio import read_pfm
from test_torch_path import match_frac, mean_rel
from jax_traversal_jit import jit_jax_traversal  # noqa: F401  (autouse)
import test_torch_threads  # noqa: F401  (torch's threads under xdist)


def curve_scene(sc, tf, n=24, seed=3):
    """n curves, flat, ribbon (two end normals) and cylinder in turn, under
    rotations, splitdepths 0-3, over a floor."""
    b = sc.SceneBuilder()
    m = b.add_material(sc.MAT_HAIR if hasattr(sc, "MAT_HAIR") else sc.MAT_MATTE)
    b.add_triangle_mesh([0, 1, 2, 0, 2, 3],
                        [[-5, -5, -1], [5, -5, -1], [5, 5, -1], [-5, 5, -1]],
                        material=m)
    rs = np.random.RandomState(seed)
    kinds = ("flat", "ribbon", "cylinder")
    for i in range(n):
        base = np.array([rs.randn() * 1.5, rs.randn() * 1.5, -1.0])
        cp = base + np.cumsum(rs.randn(4, 3) * 0.4 + [0, 0, 0.5], 0)
        kind = kinds[i % 3]
        b.add_curve(cp, 0.15, 0.05, kind, rs.randn(2, 3) if kind == "ribbon" else None,
                    tf.rotate(10.0 * i, 0.0, 0.0, 1.0), m, splitdepth=i % 4)
    return b


@pytest.fixture(scope="module")
def both():
    js = curve_scene(jsc, jtf).build()
    return js, bridge.scene_from_numpy(bridge.as_numpy_fields(js), "cpu")


def test_builder_matches_jax(both):
    js, _ = both
    ref = bridge.as_numpy_fields(js)
    got = curve_scene(tsc, ttf).build_numpy()
    for k in tsc.SCENE_FIELDS + ("curve_packed", "bvh_min", "bvh_max"):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]), err_msg=k)
    assert set(got["curve_packed"][:, 24].tolist()) == {0.0, 1.0, 2.0}


CURVE_FILE = """WorldBegin
Material "hair"
Shape "curve" "point P" [0 0 -1 0.2 0.1 0 -0.1 0.2 0.5 0.1 0.1 1
  0.3 0 1.4 0.2 -0.2 1.8 0.4 0 2.0] "float width0" [0.1] "float width1" [0.02]
  "string type" "cylinder"
Shape "curve" "point P" [1 1 -1 1.2 1.1 0 0.9 1.2 0.5 1.1 1.1 1] "float width" [0.08]
  "string type" "ribbon" "normal N" [0 1 0 1 0 0]
Shape "curve" "point P" [1 1 -1 1.2 1.1 0 0.9 1.2 0.5 1.1 1.1 1
  1.3 1 1.2 1.2 1.1 1.4 1.3 1.0 1.6] "float width" [0.05] "string type" "ribbon"
  "normal N" [0 1 0 1 0 0]
Shape "curve" "point P" [-1 1 -1 -1.2 1.1 0 -0.9 1.2 0.5 -1.1 1.1 1] "float width" [0.06]
  "integer splitdepth" [1]
AttributeBegin
  Translate 0.5 -0.5 0
  Rotate 30 0 0 1
  Shape "curve" "point P" [0 0 0 0.3 0 0.3 0.1 0.2 0.6 0 0 0.9]
    "float width0" [0.04] "float width1" [0.01] "integer splitdepth" [5]
AttributeEnd
WorldEnd
"""


def test_curve_statements_match_jax():
    """Chained segments with their widths lerped along the chain, the three
    types, a ribbon chain of two segments with two normals (each segment
    gets them, as in the JAX package), splitdepths 1-5 and a transformed
    curve: every array bit for bit."""
    ref, got = jio.parse_pbrt_string(CURVE_FILE), tio.parse_pbrt_string(CURVE_FILE)
    assert bridge.compare_setups(ref, got, rtol=0.0) == []
    assert got.scene_builder.build_numpy()["curve_packed"].shape[0] > 40


def _curve_rays(scene, n, seed):
    """Rays aimed at points of the curves (their control hulls' midpoints
    jittered by the widths), from random directions: hits, grazes and
    misses; every 5th lane's t_max cut short of its target."""
    rs = np.random.RandomState(seed)
    rows = scene.curve_packed.numpy()
    pick = rs.randint(0, rows.shape[0], n)
    cp = rows[pick, :12].reshape(n, 4, 3)
    u = rs.rand(n)[:, None]
    target = ((1 - u) ** 3)[:, None] * cp[:, 0:1] + (3 * u * (1 - u) ** 2)[:, None] * cp[:, 1:2] \
        + (3 * u ** 2 * (1 - u))[:, None] * cp[:, 2:3] + (u ** 3)[:, None] * cp[:, 3:4]
    target = target[:, 0] + rs.randn(n, 3) * 0.04
    o = target + rs.randn(n, 3) * 2.0
    d = target - o
    dist = np.linalg.norm(d, axis=-1)
    d /= dist[:, None]
    t_max = np.where(np.arange(n) % 5 == 0, 0.9 * dist, 1e30)
    return (o.astype(np.float32), d.astype(np.float32), t_max.astype(np.float32),
            rows[pick])


@pytest.mark.parametrize("want_record", [False, True])
def test_curve_intersect_matches_jax(both, want_record):
    _, ts = both
    o, d, t_max, rows = _curve_rays(ts, 4096, 5)
    with jax.disable_jit():
        ref = jcurve.curve_intersect(*map(jnp.asarray, (o, d, t_max, rows)),
                                     want_record=want_record)
    got = tcurve.curve_intersect(*map(torch.as_tensor, (o, d, t_max, rows)),
                                 want_record=want_record)
    h_ref, h = np.asarray(ref["hit"]), got["hit"].numpy()
    assert 0.2 < h_ref.mean() < 0.9
    assert (h == h_ref).mean() >= 0.999
    both_hit = h & h_ref
    np.testing.assert_allclose(got["t"].numpy()[both_hit], np.asarray(ref["t"])[both_hit],
                               rtol=1e-5)
    ctype = rows[:, 24]
    assert all(both_hit[ctype == k].sum() > 50 for k in (0, 1, 2))
    if want_record:
        for k in ("p_hit", "uv", "ng", "dpdu", "dpdv", "p_error"):
            np.testing.assert_allclose(got[k].numpy()[both_hit],
                                       np.asarray(ref[k])[both_hit], rtol=1e-4,
                                       atol=1e-4, err_msg=k)


HAIR_FILE = """LookAt 0 -5 2  0 0 0.5  0 0 1
Camera "perspective" "float fov" [40]
Sampler "halton" "integer pixelsamples" [2]
Film "image" "integer xresolution" [{res}] "integer yresolution" [{res}]
Integrator "path" "integer maxdepth" [2] "string lightsamplestrategy" "uniform"
WorldBegin
LightSource "point" "rgb I" [10 10 10] "point from" [1 -3 4]
Material "matte" "rgb Kd" [0.4 0.4 0.4]
Shape "trianglemesh" "point P" [-5 -5 0 5 -5 0 5 5 0 -5 5 0] "integer indices" [0 1 2 0 2 3]
Material "hair" "float eumelanin" [1.3]
{curves}
WorldEnd
"""


def _hair_file(tmp_path, res=16):
    rs = np.random.RandomState(2)
    lines = []
    for i in range(60):
        base = np.array([rs.uniform(-1, 1), rs.uniform(-0.5, 0.5), 0.0])
        pts = base + np.cumsum(rs.randn(4, 3) * 0.05 + [0, 0, 0.3], 0)
        kind = ("flat", "ribbon", "cylinder")[i % 3]
        extra = ' "normal N" [0 -1 0 0 -1 0.3]' if kind == "ribbon" else ""
        lines.append(f'Shape "curve" "point P" [{" ".join(f"{x:.4f}" for x in pts.ravel())}] '
                     f'"string type" "{kind}" "float width0" [0.06] "float width1" [0.02]'
                     + extra)
    path = tmp_path / "hair.pbrt"
    path.write_text(HAIR_FILE.format(res=res, curves="\n".join(lines)))
    return str(path)


def test_hair_on_curves_renders(tmp_path):
    path = _hair_file(tmp_path, res=10)
    imgs = []
    for k in range(2):
        out = str(tmp_path / f"h{k}.pfm")
        assert cli.main([path, "--device", "cpu", "-o", out, "--quiet"]) == 0
        imgs.append(read_pfm(out))
    assert np.isfinite(imgs[0]).all() and imgs[0].mean() > 0
    np.testing.assert_array_equal(imgs[0], imgs[1])


@pytest.mark.slow
def test_hair_render_matches_jax(tmp_path):
    """The hair patch's render (16x16 @ 2 spp, depth 2) against the JAX
    package's at tests/test_torch_path.py:58-59's bars (~2 min: XLA
    compiles the traversal loop with the curve test)."""
    path = _hair_file(tmp_path)
    ref, _ = jrender.render_file(path, out=str(tmp_path / "j.pfm"), res=(16, 16))
    out = str(tmp_path / "t.pfm")
    assert cli.main([path, "--device", "cpu", "-o", out, "--quiet"]) == 0
    got, ref = read_pfm(out), np.asarray(ref)
    assert match_frac(ref, got) >= 0.995 and mean_rel(ref, got) <= 5e-3
