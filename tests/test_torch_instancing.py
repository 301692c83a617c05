"""Object instancing (TransformedPrimitive, core/primitive.h:99-127) in the
port, against the JAX package: mesh templates shared by the instances
(SceneBuilder.begin_mesh_template / add_mesh_instance; one
SHAPE_TRIANGLE_INST primitive per triangle and instance, the instance's
rows in inst_xf), ObjectBegin / ObjectEnd / ObjectInstance in the reader,
the oracle's traversal and the hit record (the ray moved into object space,
the record carried back by i2w).

Tolerances: the oracle's prims equal to the JAX package's jitted _traverse
and its t to tests/test_torch_traverse.py's bars (XLA:CPU contracts the
watertight test's multiply-adds under jit: rtol 1e-6 on 99% of the lanes,
1e-4 on all); the hit record of the same hits (eager JAX) bit for bit in
its points, uv and error bounds, its normals within 2.4e-7 (two ulps of 1:
the JAX package normalises with a reduction); the instanced image against the flattened scene's to
tests/test_instancing.py:75's rtol 2e-3, atol 2e-4 (the ray transformed
against the vertices transformed: the same surface, another rounding)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu import scene as jsc
from pbrt_tpu import sceneio as jio
from pbrt_tpu.accel import traverse as jtv
from pbrt_tpu.core import transform as jtf
from pbrt_tpu_torch import bridge
from pbrt_tpu_torch import cameras as tcam
from pbrt_tpu_torch import scene as tsc
from pbrt_tpu_torch import sceneio as tio
from pbrt_tpu_torch.accel import traverse as ttv
from pbrt_tpu_torch.core import transform as ttf
from pbrt_tpu_torch.film import FilmConfig
from pbrt_tpu_torch.integrators import path as tpath
from pbrt_tpu_torch.samplers.samplers import SamplerConfig
from jax_traversal_jit import jit_jax_traversal  # noqa: F401  (autouse)
import test_torch_threads  # noqa: F401  (torch's threads under xdist)

RES = (32, 32)
QUAD_I = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
QUAD_P = np.array([[-0.5, -0.5, 0], [0.5, -0.5, 0], [0.5, 0.5, 0], [-0.5, 0.5, 0]],
                  np.float32)


def _xfs(tf):
    """tests/test_instancing.py's three instances."""
    return [tf.translate(-0.9, 0.0, 3.0),
            tf.translate(0.9, 0.3, 3.5) @ tf.rotate(40.0, 0.0, 0.0, 1.0),
            tf.translate(0.0, -0.6, 4.0) @ tf.scale(1.5, 0.7, 1.0)]


def _common(b):
    mf = b.add_material(tsc.MAT_MATTE, kd=(0.4, 0.4, 0.4))
    b.add_triangle_mesh(np.array([[0, 1, 2], [0, 2, 3]]),
                        np.array([[-6, -6, 6], [6, -6, 6], [6, 6, 6], [-6, 6, 6]],
                                 np.float32), material=mf)
    b.add_point_light(ttf.translate(0.0, 2.0, 0.0), (30.0, 30.0, 30.0))


def _built(instanced: bool):
    b = tsc.SceneBuilder()
    m = b.add_material(tsc.MAT_MATTE, kd=(0.7, 0.3, 0.2))
    if instanced:
        b.begin_mesh_template()
        b.add_triangle_mesh(QUAD_I, QUAD_P, material=m)
        tmpl = b.end_mesh_template()
        for x in _xfs(ttf):
            b.add_mesh_instance(tmpl, x)
    else:
        for x in _xfs(ttf):
            b.add_triangle_mesh(QUAD_I, QUAD_P, object_to_world=x, material=m)
    _common(b)
    return b.build(device="cpu")


def _render(scene):
    cam = tcam.make_perspective_camera(
        ttf.look_at([0, 0, 0], [0, 0, 1], [0, 1, 0]), RES, fov_deg=60.0)
    return tpath.render(scene, cam, FilmConfig(full_resolution=RES),
                        SamplerConfig("halton", 2, RES), tpath.PathConfig(max_depth=2),
                        device="cpu").numpy()


def test_instanced_matches_flattened_image():
    """tests/test_instancing.py:75 for the port: the instances' image and
    the flattened scene's agree; the instanced one went through the typed
    leaves."""
    si, sf = _built(True), _built(False)
    assert ttv.kb.traversal_route(si) == "typed"
    assert ttv.kb.traversal_route(sf) == "kernel"
    img_i, img_f = _render(si), _render(sf)
    assert img_i.mean() > 0
    np.testing.assert_allclose(img_i, img_f, rtol=2e-3, atol=2e-4)


def test_instancing_shares_vertex_rows():
    si, sf = _built(True), _built(False)
    assert si.tri_attr.shape[0] == sf.tri_attr.shape[0] - 4
    assert tuple(si.inst_tri.shape) == (6, 2)
    assert tuple(si.inst_xf.shape) == (3, 24)


OBJECT_FILE = """LookAt 0 -4 3  0 0 0.5  0 0 1
Camera "perspective" "float fov" [50]
Sampler "halton" "integer pixelsamples" [2]
Film "image" "integer xresolution" [16] "integer yresolution" [16]
WorldBegin
LightSource "point" "rgb I" [20 20 20] "point from" [0 -2 4]
Material "matte" "rgb Kd" [.4 .4 .4]
Shape "trianglemesh" "point P" [-6 -6 0  6 -6 0  6 6 0  -6 6 0]
  "integer indices" [0 1 2 0 2 3]
ObjectBegin "thing"
  Material "plastic" "rgb Kd" [.6 .3 .2]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3 0 3 1 1 3 2]
    "point P" [0 0 0.6 0.5 0 0 -0.3 0.4 0 -0.3 -0.4 0]
    "normal N" [0 0 1 1 0 0.2 -0.5 0.8 0.2 -0.5 -0.8 0.2]
  Translate 0 0 0.8
  Shape "cone" "float radius" [0.2] "float height" [0.4]
  Shape "curve" "point P" [0 0 0 0.1 0 0.2 -0.1 0.1 0.4 0 0 0.6]
    "float width" [0.05]
  AttributeBegin
    AreaLightSource "diffuse" "rgb L" [2 2 2]
    Translate 0 0 0.7
    Shape "sphere" "float radius" [0.05]
  AttributeEnd
ObjectEnd
AttributeBegin
  Translate -1 0 0
  ObjectInstance "thing"
AttributeEnd
AttributeBegin
  Translate 1 0.5 0
  Rotate 60 0 0 1
  Scale 1.2 1 0.8
  ObjectInstance "thing"
AttributeEnd
WorldEnd
"""


def test_object_instance_file_matches_jax(tmp_path):
    """ObjectBegin / ObjectInstance: the mesh built once into a template
    (one inst_xf row an instance), the cone, the curve and the emissive
    sphere made again under each instance's transform; every scene array
    bit for bit."""
    path = tmp_path / "objects.pbrt"
    path.write_text(OBJECT_FILE)
    ref, got = jio.parse_pbrt_file(str(path)), tio.parse_pbrt_file(str(path))
    assert bridge.compare_setups(ref, got, rtol=0.0) == []
    fields = got.scene_builder.build_numpy()
    assert fields["inst_xf"].shape == (2, 24) and fields["inst_tri"].shape == (8, 2)
    assert (fields["lights"]["light_type"] == tsc.LIGHT_AREA).sum() == 2
    with pytest.raises(ValueError, match="no such object"):
        tio.parse_pbrt_string('WorldBegin\nObjectInstance "none"\nWorldEnd\n')


def instanced_scene(sc, tf):
    """Two templates (one with normals and uv), five instances with
    rotations and non-uniform scales, over a floor."""
    b = sc.SceneBuilder()
    m = b.add_material(sc.MAT_MATTE)
    b.add_triangle_mesh([0, 1, 2, 0, 2, 3],
                        [[-5, -5, -1], [5, -5, -1], [5, 5, -1], [-5, 5, -1]],
                        material=m)
    rs = np.random.RandomState(4)
    b.begin_mesh_template()
    b.add_triangle_mesh(np.arange(60).reshape(-1, 3), rs.randn(60, 3) * 0.5,
                        n=rs.randn(60, 3), uv=rs.rand(60, 2), material=m)
    t1 = b.end_mesh_template()
    b.begin_mesh_template()
    b.add_triangle_mesh(np.arange(30).reshape(-1, 3), rs.randn(30, 3) * 0.6,
                        material=m)
    t2 = b.end_mesh_template()
    for i in range(5):
        b.add_mesh_instance(t1 if i % 2 else t2,
                            tf.translate(*(rs.randn(3) * 1.5))
                            @ tf.rotate(40.0 * i, 0.0, 1.0, 1.0)
                            @ tf.scale(1.0, 1.5, 0.7))
    return b


def test_oracle_and_hit_record_match_jax():
    js = instanced_scene(jsc, jtf).build()
    ts = bridge.scene_from_numpy(bridge.as_numpy_fields(js), "cpu")
    own = instanced_scene(tsc, ttf).build_numpy()
    for k in tsc.SCENE_FIELDS + tsc.GEOMETRY_FIELDS:
        np.testing.assert_array_equal(own[k], bridge.as_numpy_fields(js)[k], err_msg=k)
    rs = np.random.RandomState(0)
    n = 600
    o = np.tile(np.array([[0.0, -6.0, 4.0]], np.float32), (n, 1))
    o[n // 2:] = rs.randn(n - n // 2, 3) * 2
    d = rs.randn(n, 3) * 1.5 - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o = o.astype(np.float32)
    jd = jtv._device_scene(js)
    qt = jtv.scene_quadric_types(js)
    tj, pj = jax.jit(lambda s, o, d: jtv._traverse(s, o, d, 1e30, qt, False))(
        jd, jnp.asarray(o), jnp.asarray(d))
    t, p = ttv._traverse(ts, torch.as_tensor(o), torch.as_tensor(d), 1e30)
    np.testing.assert_array_equal(p.numpy(), np.asarray(pj))
    assert np.isclose(t.numpy(), np.asarray(tj), rtol=1e-6, atol=0).mean() >= 0.99
    np.testing.assert_allclose(t.numpy(), np.asarray(tj), rtol=1e-4)
    with jax.disable_jit():
        rj = jtv.hit_record(jd, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t.numpy()),
                            jnp.asarray(p.numpy()), qt)
    assert (ts.prim_meta[p[p >= 0].long(), 0] == tsc.SHAPE_TRIANGLE_INST).sum() > 50
    rt = ttv.hit_record(ts, torch.as_tensor(o), torch.as_tensor(d), t, p)
    for k in ("p", "uv", "p_error", "dpdu", "dpdv", "material"):
        np.testing.assert_array_equal(rt[k].numpy(), np.asarray(rj[k]), err_msg=k)
    for k in ("ng", "ns", "ss"):
        np.testing.assert_allclose(rt[k].numpy(), np.asarray(rj[k]), rtol=0,
                                   atol=2.4e-7, err_msg=k)
