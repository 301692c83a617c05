"""The five other quadrics (cylinder, disk, cone, paraboloid, hyperboloid)
and the sphere, in the port (shapes/quadrics.py, scene.py add_*,
accel/traverse.py) against the JAX package (pbrt_tpu.shapes.quadrics,
pbrt_tpu.scene, pbrt_tpu.accel.traverse) on the CPU.

With jit disabled every JAX operation rounds on its own, as torch's do, so
the object-space tests and the records' points and error bounds are held
bit for bit (the oracle's traversal against the jitted XLA loop, at
tests/test_torch_traverse.py's bars); normals and uv within 2.4e-7 (two ulps
of 1): the JAX package transforms a normal with a reduction over the
matrix's column and divides phi by phi_max in XLA:CPU, each an ulp from
torch's written-out sums and division on some lanes.  The cases: phi
clipped below 360 degrees, the disk's inner radius, reversed orientation
(q_rev, which flips the normal in the hit record), grazing rays (tangent
to within 1e-4 of the radius) and the hyperboloid's degenerate profile
(p1.z = p2.z, where v divides by 1e-12).

The whole-image comparison with the JAX package's jitted render is slow
(-m slow): XLA:CPU contracts the records' multiply-adds under jit, so
their points and normals move by an ulp and a few percent of paths take
another bounce; the disk, whose hits carry no error bound (disk.cpp), is
left out of it, as its shadow rays' self-intersection flips with the last
bit of the hit point."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu import render as jrender
from pbrt_tpu import scene as jsc
from pbrt_tpu.accel import traverse as jtv
from pbrt_tpu.core import transform as jtf
from pbrt_tpu.shapes import quadrics as jq
from pbrt_tpu_torch import __main__ as cli
from pbrt_tpu_torch import bridge
from pbrt_tpu_torch import scene as tsc
from pbrt_tpu_torch.accel import traverse as ttv
from pbrt_tpu_torch.core import transform as ttf
from pbrt_tpu_torch.shapes import quadrics as tq
from pbrt_tpu_torch.utils.imageio import read_pfm
from test_torch_path import match_frac, mean_rel
from jax_traversal_jit import jit_jax_traversal  # noqa: F401  (autouse)
import test_torch_threads  # noqa: F401  (torch's threads under xdist)

# (name, JAX object test, JAX record, q_params): phi clipped, an inner
# radius, a cone, a paraboloid and a hyperboloid of two sheets
CASES = {
    "sphere": (jq.intersect_sphere_object, jq.intersect_sphere,
               (1.0, -0.6, 0.8, np.deg2rad(270.0))),
    "cylinder": (jq.intersect_cylinder_object, jq.intersect_cylinder,
                 (0.8, -0.5, 0.9, np.deg2rad(300.0))),
    "disk": (jq.intersect_disk_object, jq.intersect_disk,
             (1.0, 0.35, 0.2, np.deg2rad(320.0))),
    "cone": (jq.intersect_cone_object, jq.intersect_cone,
             (0.9, 1.4, np.deg2rad(290.0))),
    "paraboloid": (jq.intersect_paraboloid_object, jq.intersect_paraboloid,
                   (0.8, 0.1, 1.2, np.deg2rad(330.0))),
}
SHAPE = {"sphere": 1, "cylinder": 2, "disk": 3, "cone": 4, "paraboloid": 5,
         "hyperboloid": 6}
UV_ATOL = 2.4e-7


def _hyperboloid_params(p1, p2, phimax=350.0):
    """The q_params row of add_hyperboloid (both builders solve ah and ch
    alike; held equal in test_builders_match_jax)."""
    b = tsc.SceneBuilder()
    qi = b.add_hyperboloid(ttf.identity(), p1, p2, phimax_deg=phimax)
    return tuple(float(x) for x in b.quadrics[qi][2])


HYPERBOLOIDS = {
    "hyperboloid": _hyperboloid_params((0.4, 0.0, -0.6), (0.7, 0.3, 0.8)),
    # p1.z = p2.z: the profile's v divides by 1e-12
    "hyperboloid-flat": _hyperboloid_params((0.4, 0.0, 0.5), (0.8, 0.2, 0.5)),
}


def _rays(n, seed, radius=1.0, grazing=0.25):
    """Object-space rays toward the unit-ish quadrics: origins on a shell,
    directions at the surface; a share `grazing` tangent to the cylinder of
    `radius` about z to within 1e-4."""
    rs = np.random.RandomState(seed)
    o = rs.randn(n, 3)
    o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = rs.randn(n, 3) * 0.6 - o
    g = int(n * grazing)
    phi = rs.uniform(0, 2 * np.pi, g)
    o[:g] = np.stack([(radius + rs.uniform(-1e-4, 1e-4, g)) * np.cos(phi),
                      (radius + rs.uniform(-1e-4, 1e-4, g)) * np.sin(phi),
                      rs.uniform(-0.4, 0.6, g)], -1) + 3.0 * np.stack(
        [-np.sin(phi), np.cos(phi), np.zeros(g)], -1)
    d[:g] = np.stack([np.sin(phi), -np.cos(phi), rs.uniform(-0.05, 0.05, g)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _xform():
    return (ttf.translate(0.3, -0.2, 0.5) @ ttf.rotate(35.0, 1.0, 0.5, 0.2)
            @ ttf.scale(1.2, 0.9, 1.1))


def _case(name):
    if name.startswith("hyperboloid"):
        return (jq.intersect_hyperboloid_object, jq.intersect_hyperboloid,
                HYPERBOLOIDS[name])
    return CASES[name]


ALL = list(CASES) + list(HYPERBOLOIDS)


def _jax_object(name, oo, od, t_max, par):
    fn = _case(name)[0]
    if name in ("sphere", "cylinder", "disk"):
        return fn(oo, od, t_max, *(jnp.float32(p) for p in par[:4]))
    return fn(oo, od, t_max, jnp.asarray(np.pad(np.float32(par), (0, 12 - len(par)))))


@pytest.mark.parametrize("name", ALL)
def test_object_test_matches_jax(name):
    """The t-only object-space test (the traversal's leaf step and the
    quadric pass), bit for bit, t_max cutting some hits."""
    par = _case(name)[2]
    n = 4000
    o, d = _rays(n, 1, radius=float(par[0]) if name != "hyperboloid" else 0.7)
    t_max = np.where(np.arange(n) % 7 == 0, 3.5, 1e30).astype(np.float32)
    with jax.disable_jit():
        ref = _jax_object(name, *map(jnp.asarray, (o, d, t_max)), par)
    got = tq.intersect_object(SHAPE[name.split("-")[0]], *map(torch.as_tensor, (o, d, t_max)),
                              torch.as_tensor(np.pad(np.float32(par), (0, 12 - len(par)))))
    assert 0.1 < float(got["hit"].float().mean()) < 0.9
    np.testing.assert_array_equal(got["hit"].numpy(), np.asarray(ref["hit"]))
    np.testing.assert_array_equal(got["t"].numpy(), np.asarray(ref["t"]))


@pytest.mark.parametrize("name", ALL)
def test_record_matches_jax(name):
    """The full test with its world-space record under a rotated, scaled
    transform: hit, t, the point and the error bound bit for bit, the
    normal and uv to UV_ATOL."""
    par = _case(name)[2]
    xf = _xform()
    n = 3000
    o, d = _rays(n, 2, radius=float(par[0]) if name != "hyperboloid" else 0.7)
    o = xf.apply_point(o).astype(np.float32)
    d = xf.apply_vector(d).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.full(n, 1e30, np.float32)
    w2o = np.broadcast_to(np.float32(xf.m_inv), (n, 4, 4))
    o2w = np.broadcast_to(np.float32(xf.m), (n, 4, 4))
    p12 = np.pad(np.float32(par), (0, 12 - len(par)))
    with jax.disable_jit():
        args = [jnp.asarray(x) for x in (o, d, t_max, w2o, o2w)]
        fn = _case(name)[1]
        if name in ("sphere", "cylinder", "disk"):
            ref = fn(*args, *(jnp.float32(p) for p in par[:4]))
        else:
            ref = fn(*args, jnp.asarray(np.broadcast_to(p12, (n, 12))))
    got = tq.intersect_record(SHAPE[name.split("-")[0]],
                              *map(torch.as_tensor, (o, d, t_max, w2o, o2w)),
                              torch.as_tensor(np.broadcast_to(p12, (n, 12)).copy()))
    hit = np.asarray(ref["hit"])
    assert 0.1 < hit.mean() < 0.9
    np.testing.assert_array_equal(got["hit"].numpy(), hit)
    for k in ("t", "p_hit", "p_error"):
        np.testing.assert_array_equal(got[k].numpy()[hit], np.asarray(ref[k])[hit],
                                      err_msg=k)
    for k in ("ng", "uv"):
        np.testing.assert_allclose(got[k].numpy()[hit], np.asarray(ref[k])[hit],
                                   rtol=0, atol=UV_ATOL, err_msg=k)


def quadric_scene(sc, tf):
    """Every quadric type, phi-clipped, one disk with an inner radius, two
    reversed, over a floor, with a point light and a sphere light."""
    b = sc.SceneBuilder()
    m = b.add_material(sc.MAT_MATTE, kd=(0.6, 0.5, 0.4))
    p = b.add_material(sc.MAT_PLASTIC, kd=(0.3, 0.3, 0.6), ks=(0.4, 0.4, 0.4),
                       roughness=0.1)
    b.add_triangle_mesh([0, 1, 2, 0, 2, 3],
                        [[-6, -6, -1], [6, -6, -1], [6, 6, -1], [-6, 6, -1]],
                        material=m)
    b.add_sphere(tf.translate(-2, 0, 0), 0.8, material=p, phimax_deg=270)
    b.add_quadric(sc.SHAPE_DISK, tf.translate(0, -2, 0.5), (1.0, 0.3, 0.0,
                                                            np.deg2rad(300)),
                  m, -1, True)
    b.add_quadric(sc.SHAPE_CYLINDER, tf.translate(2, 0, 0) @ tf.rotate(30, 1, 0, 0),
                  (0.5, -0.5, 0.8, np.deg2rad(360)), p, -1, False)
    b.add_cone(tf.translate(0, 2, -0.5), 0.7, 1.2, material=p, phimax_deg=320)
    b.add_paraboloid(tf.translate(0, 0, 0), 0.6, 0.1, 0.9, material=m,
                     reverse_orientation=True)
    b.add_hyperboloid(tf.translate(2, 2, 0), (0.3, 0, -0.5), (0.6, 0.2, 0.6),
                      material=p, phimax_deg=350)
    b.add_hyperboloid(tf.translate(-2, 2, 0), (0.5, 0, 0.0), (0.3, 0.2, 0.7),
                      material=m)
    b.add_point_light(tf.translate(0, -3, 5), (6.0, 6.0, 6.0))
    b.add_emissive_sphere(tf.translate(0, 4, 5), 0.4, L=(10.0, 10.0, 10.0))
    return b


@pytest.fixture(scope="module")
def both():
    js = quadric_scene(jsc, jtf).build()
    return js, bridge.scene_from_numpy(bridge.as_numpy_fields(js), "cpu")


def test_builders_match_jax():
    """add_quadric, add_cone, add_paraboloid and add_hyperboloid: every
    scene array (q_params, q_packed, q_rev, q_prim_id, the bounds and so the
    BVH) bit for bit."""
    ref = bridge.as_numpy_fields(quadric_scene(jsc, jtf).build())
    got = quadric_scene(tsc, ttf).build_numpy()
    for k in tsc.SCENE_FIELDS + ("bvh_min", "bvh_max"):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]),
                                      err_msg=k)
    assert set(got["prim_meta"][:, 0]) == {0, 1, 2, 3, 4, 5, 6}
    assert got["q_rev"].sum() == 2


def _camera_rays(n, seed):
    rs = np.random.RandomState(seed)
    o = np.tile(np.array([[0.0, -6.0, 4.0]], np.float32), (n, 1))
    o[n // 2:] = rs.randn(n - n // 2, 3) * 2
    d = rs.randn(n, 3) * 1.5 - o
    return o.astype(np.float32), (d / np.linalg.norm(d, axis=1, keepdims=True)
                                  ).astype(np.float32)


def test_oracle_and_hit_record_match_jax(both):
    """The oracle's prims equal to the JAX package's jitted _traverse, every
    type hit, and its t within rtol 1e-4 on every lane and 1e-6 on 95% of
    them (XLA:CPU contracts multiply-adds under jit, in the watertight test
    as tests/test_torch_traverse.py notes, and in the quadrics' double-single
    discriminant, whose error term that moves: the object tests are bit for
    bit in eager JAX above); the hit record of the same hits (eager
    JAX; reversed normals flipped) bit for bit in its points and error
    bounds, its normals, shading tangents, dpdu/dpdv and uv to UV_ATOL (an
    ulp: the cone's and paraboloid's normal is normalize(cross(dpdu,
    dpdv)), which XLA's eager cross rounds apart from torch's on a few
    lanes)."""
    js, ts = both
    o, d = _camera_rays(1000, 3)
    jd = jtv._device_scene(js)
    qt = jtv.scene_quadric_types(js)
    tj, pj = jax.jit(lambda s, o, d: jtv._traverse(s, o, d, 1e30, qt, False))(
        jd, jnp.asarray(o), jnp.asarray(d))
    t, p = ttv._traverse(ts, torch.as_tensor(o), torch.as_tensor(d), 1e30)
    np.testing.assert_array_equal(p.numpy(), np.asarray(pj))
    assert np.isclose(t.numpy(), np.asarray(tj), rtol=1e-6, atol=0).mean() >= 0.95
    np.testing.assert_allclose(t.numpy(), np.asarray(tj), rtol=1e-4)
    with jax.disable_jit():
        rj = jtv.hit_record(jd, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t.numpy()),
                            jnp.asarray(p.numpy()), qt)
    types = ts.prim_meta[p.clamp(min=0).long(), 0].numpy()
    assert set(types[p.numpy() >= 0]) == {0, 1, 2, 3, 4, 5, 6}
    rt = ttv.hit_record(ts, torch.as_tensor(o), torch.as_tensor(d), t, p)
    for k in ("p", "p_error", "material", "arealight"):
        np.testing.assert_array_equal(rt[k].numpy(), np.asarray(rj[k]), err_msg=k)
    for k in ("ng", "ns", "dpdu", "dpdv", "ss", "uv"):
        np.testing.assert_allclose(rt[k].numpy(), np.asarray(rj[k]), rtol=0,
                                   atol=UV_ATOL, err_msg=k)
    rev = ts.q_rev[ts.prim_meta[p.clamp(min=0).long(), 1].long().clamp(
        max=ts.q_rev.shape[0] - 1)] & (p >= 0) & torch.as_tensor(types > 0)
    assert bool(rev.any())


def test_quadric_pass_matches_the_oracle(both):
    """Inside the gate: the triangle-only kernel's plain version and the
    brute-force pass over the six types against the oracle: the prims
    agree on 99.9% of the lanes (the floor's Moller-Trumbore against the
    watertight test can settle an edge the other way), t to
    tests/test_torch_traverse.py's rtol 1e-4, the quadrics' t bit for
    bit."""
    from pbrt_tpu_torch.ops import bvh as kb

    _, ts = both
    o, d = (torch.as_tensor(x) for x in _camera_rays(2000, 4))
    assert kb.kernel_supported(ts)
    t, p = kb.intersect_kernel_with_quadrics(ts, o, d, 1e30)
    t_ref, p_ref = ttv._traverse(ts, o, d, 1e30)
    assert float((p == p_ref).float().mean()) >= 0.999
    same = (p == p_ref) & (p >= 0)
    quad = same & (ts.prim_meta[p.clamp(min=0).long(), 0] > 0)
    assert bool(quad.any()) and torch.equal(t[quad], t_ref[quad])
    torch.testing.assert_close(t[same], t_ref[same], rtol=1e-4, atol=0)


def test_quadric_scene_renders(tmp_path):
    """The port alone, through the CLI: a file of every quadric renders
    finite and non-zero, twice bit for bit."""
    path = _quadric_file(tmp_path)
    imgs = []
    for k in range(2):
        out = str(tmp_path / f"q{k}.pfm")
        assert cli.main([path, "--device", "cpu", "-o", out, "--quiet"]) == 0
        imgs.append(read_pfm(out))
    assert np.isfinite(imgs[0]).all() and imgs[0].mean() > 0
    np.testing.assert_array_equal(imgs[0], imgs[1])


QUADRIC_FILE = """LookAt 0 -6 4  0 0 0  0 0 1
Camera "perspective" "float fov" [45]
Sampler "halton" "integer pixelsamples" [2]
Film "image" "integer xresolution" [16] "integer yresolution" [16]
Integrator "path" "integer maxdepth" [2] "string lightsamplestrategy" "uniform"
WorldBegin
LightSource "point" "rgb I" [6 6 6] "point from" [0 -3 5]
Material "matte" "rgb Kd" [0.6 0.5 0.4]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [-6 -6 -1 6 -6 -1 6 6 -1 -6 6 -1]
Material "plastic" "rgb Kd" [0.3 0.3 0.6] "rgb Ks" [0.4 0.4 0.4]
AttributeBegin
  Translate -2 0 0
  Shape "sphere" "float radius" [0.8] "float phimax" [270]
AttributeEnd
AttributeBegin
  Translate 2 0 0
  Rotate 30 1 0 0
  Shape "cylinder" "float radius" [0.5] "float zmin" [-0.5] "float zmax" [0.8]
AttributeEnd
AttributeBegin
  Translate 0 2 -0.5
  ReverseOrientation
  Shape "cone" "float radius" [0.7] "float height" [1.2] "float phimax" [320]
AttributeEnd
AttributeBegin
  Shape "paraboloid" "float radius" [0.6] "float zmin" [0.1] "float zmax" [0.9]
AttributeEnd
AttributeBegin
  Translate 2 2 0
  Shape "hyperboloid" "point p1" [0.3 0 -0.5] "point p2" [0.6 0.2 0.6]
AttributeEnd
{disk}
WorldEnd
"""
DISK = """AttributeBegin
  Translate 0 -2 0.5
  ReverseOrientation
  Shape "disk" "float radius" [1] "float innerradius" [0.3] "float phimax" [300]
AttributeEnd"""


def _quadric_file(tmp_path, disk=True):
    path = tmp_path / "quadrics.pbrt"
    path.write_text(QUADRIC_FILE.format(disk=DISK if disk else ""))
    return str(path)


@pytest.mark.slow
def test_quadric_render_matches_jax(tmp_path):
    """The file without its disk at 16x16 @ 2 spp, depth 2, against the JAX
    package's jitted render (~100 s, most of it XLA compiling the
    traversal loop over six quadric types): at least 95% of pixels within
    rel 1e-3 and the means within 2e-2 (jit moves the records by an ulp,
    see the module's note)."""
    path = _quadric_file(tmp_path, disk=False)
    ref, _ = jrender.render_file(path, out=str(tmp_path / "j.pfm"), res=(16, 16))
    out = str(tmp_path / "t.pfm")
    assert cli.main([path, "--device", "cpu", "-o", out, "--quiet"]) == 0
    got, ref = read_pfm(out), np.asarray(ref)
    assert np.isfinite(got).all() and got.mean() > 0
    assert match_frac(ref, got) >= 0.95
    assert mean_rel(ref, got) <= 2e-2
