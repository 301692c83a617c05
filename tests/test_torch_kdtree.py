"""The kd-tree accelerator (accel/kdtree.py) against the JAX package's, on
the CPU: the build's arrays equal, array for array; the traversal's prims
equal and its t within tests/test_torch_traverse.py's oracle bars (the
JAX loop is jitted here, and XLA's fusion moves a hit's t by an ulp) on
random rays over a triangle soup and a soup with spheres; a .pbrt file
with Accelerator "kdtree" renders as its BVH twin at tests/test_kdtree.py's
bars (the kd-tree tests triangles watertight, the BVH kernel with
Moller-Trumbore); the 200k-primitive cap keeps the BVH, as in the JAX
package."""
import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu import scene as jsc
from pbrt_tpu.accel import kdtree as jkd
from pbrt_tpu.accel import traverse as jtv
from pbrt_tpu.core import transform as jtf
from pbrt_tpu_torch import bridge
from pbrt_tpu_torch import render as trender
from pbrt_tpu_torch import scene as tsc
from pbrt_tpu_torch.accel import kdtree as tkd
from pbrt_tpu_torch.accel import traverse as ttv
from pbrt_tpu_torch.core import transform as ttf
from test_torch_traverse import tri_scene
import test_torch_threads  # noqa: F401  (torch's threads under xdist)


def soup(sc, tf, spheres: bool):
    b = tri_scene(sc, tf, 150)
    if spheres:
        m = b.add_material(sc.MAT_MATTE)
        b.add_sphere(tf.translate(0, 0, 4), 1.0, material=m)
        b.add_sphere(tf.translate(1, -2, 0), 0.7, material=m)
    return b


def test_build_equals_jax():
    rs = np.random.RandomState(0)
    lo = rs.rand(400, 3).astype(np.float32) * 10
    hi = lo + rs.rand(400, 3).astype(np.float32)
    hi[::7, 1] = lo[::7, 1]  # flat boxes
    for ref, got in zip(jkd.build_kdtree(lo, hi), tkd.build_kdtree(lo, hi)):
        assert ref.dtype == got.dtype
        np.testing.assert_array_equal(got, ref)
    # through the scene builders: the kd arrays over BVH-ordered bounds
    j = soup(jsc, jtf, True).build(accelerator="kdtree")
    t = soup(tsc, ttf, True).build(device="cpu", accelerator="kdtree")
    for k in tkd.KD_FIELDS:
        np.testing.assert_array_equal(getattr(t, k).numpy(), np.asarray(getattr(j, k)))
    # the stack bound the build checks
    assert tkd.max_depth_for(2 ** 42 - 1) < tkd.STACK_DEPTH <= tkd.max_depth_for(2 ** 43)


@functools.cache
def rays(n=4096):
    rs = np.random.RandomState(1)
    o = (rs.randn(n, 3) * 4).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("spheres", [False, True])
def test_traverse_matches_jax(spheres):
    j = soup(jsc, jtf, spheres).build(accelerator="kdtree")
    t = bridge.scene_from_numpy(bridge.as_numpy_fields(j), "cpu")
    o, d = rays()
    qt = jtv.scene_quadric_types(j)
    run = jax.jit(lambda s, o, d, tm: jkd.traverse_kd(s, o, d, tm, qt, False))
    t_ref, p_ref = (np.asarray(x) for x in run(j, jnp.asarray(o), jnp.asarray(d), 1e30))
    t_got, p_got = tkd.traverse_kd(t, torch.as_tensor(o), torch.as_tensor(d), 1e30)
    np.testing.assert_array_equal(p_got.numpy(), p_ref)
    assert 0.05 < (p_ref >= 0).mean() < 0.95
    assert np.isclose(t_got.numpy(), t_ref, rtol=1e-6, atol=0).mean() >= 0.99
    np.testing.assert_allclose(t_got.numpy(), t_ref, rtol=1e-4)
    # any-hit queries (JAX's intersect_any walks the kd-tree with any_hit)
    occ_ref = np.asarray(jax.jit(lambda s, o, d: jtv.intersect_any(s, o, d, 10.0, qt))(
        j, jnp.asarray(o), jnp.asarray(d)))
    occ = ttv.intersect_any(t, torch.as_tensor(o), torch.as_tensor(d), 10.0)
    np.testing.assert_array_equal(occ.numpy(), occ_ref)
    # intersect_closest takes the kd-tree and ignores an any mask
    t_c, p_c = ttv.intersect_closest(t, torch.as_tensor(o), torch.as_tensor(d), 1e30,
                                     any_mask=torch.ones(o.shape[0], dtype=torch.bool))
    assert torch.equal(p_c, p_got) and torch.equal(t_c, t_got)


KD_SCENE = """LookAt 0 2 6  0 1 0  0 1 0
Camera "perspective" "float fov" [55]
Film "image" "integer xresolution" [32] "integer yresolution" [24]
Sampler "halton" "integer pixelsamples" [2]
Integrator "path" "integer maxdepth" [3] "string lightsamplestrategy" "uniform"
{accel}
WorldBegin
LightSource "point" "color I" [30 30 30] "point from" [0 6 2]
Material "matte" "color Kd" [.6 .55 .5]
Shape "trianglemesh" "point P" [-12 0 -12  12 0 -12  12 0 12  -12 0 12] "integer indices" [0 1 2 2 3 0]
Material "plastic" "color Kd" [.3 .5 .3]
Shape "trianglemesh" "point P" [{soup}] "integer indices" [{idx}]
AttributeBegin
  Material "matte" "color Kd" [.4 .2 .2]
  Translate 1 1 0
  Shape "sphere" "float radius" [1]
AttributeEnd
WorldEnd
"""


def test_kdtree_file_renders_as_bvh(tmp_path):
    rs = np.random.RandomState(2)
    v = (rs.randn(80, 1, 3) * 1.2 + [-1.0, 1.5, 0.0] + rs.randn(80, 3, 3) * 0.3)
    soup_text = " ".join(f"{x:.5f}" for x in v.ravel())
    idx = " ".join(str(i) for i in range(240))
    imgs = {}
    for accel in ("bvh", "kdtree"):
        path = tmp_path / f"{accel}.pbrt"
        path.write_text(KD_SCENE.format(accel=f'Accelerator "{accel}"',
                                        soup=soup_text, idx=idx))
        imgs[accel], stats = trender.render_file(str(path), out=str(tmp_path / "o.pfm"),
                                                 device="cpu")
    assert "kd-tree build" in stats["setup_split"]
    bvh, kd = imgs["bvh"], imgs["kdtree"]
    assert np.isfinite(kd).all() and kd.mean() > 0
    close = np.all(np.isclose(kd, bvh, rtol=1e-4, atol=1e-5), -1)
    assert close.mean() >= 0.999
    assert abs(kd.mean() - bvh.mean()) <= 1e-3 * bvh.mean()


def test_kd_cap_keeps_the_bvh(monkeypatch, caplog):
    monkeypatch.setattr(tkd, "MAX_KD_PRIMS", 100)
    with caplog.at_level(logging.WARNING):
        big = soup(tsc, ttf, False).build(device="cpu", accelerator="kdtree")
    assert big.kd_nodes is None and "capped" in caplog.text
    small = soup(tsc, ttf, False)
    small.accelerator = "kdtree"
    assert small.build(device="cpu", max_prims_in_node=7).kd_nodes is None  # 150 > 100
    with pytest.raises(NotImplementedError, match="grid"):
        soup(tsc, ttf, False).build(device="cpu", accelerator="grid")
