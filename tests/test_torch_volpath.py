"""The port's volumetric path integrator (pbrt_tpu_torch.integrators.volpath)
and its media front end held against the JAX package's, on the CPU.

* refgold/parity/d_media_volpath.pbrt parsed by both packages: the setups
  agree through bridge.compare_setups, the medium table, the per-prim
  medium ids and the camera medium among them; the camera medium set by
  MediumInterface in the options block likewise;
* the boundary-crossing walks, _tr_walk_to (VisibilityTester::Tr) and
  _intersect_tr (Scene::IntersectTr), on the d_media scene with 1024 seeded
  rays: occlusion and prim equal on >= 99.5% of the lanes, Tr within 1e-4
  where they agree (Moller-Trumbore against the JAX package's watertight
  test on grazing hits; a last-bit log difference can flip a tracking
  step);
* estimate_direct with the walks as tr_fn / isect_tr_fn on the
  homogeneous-shell scene of tests/test_volpath_tr.py, within 1e-4;
* the slice as a whole: d_media_volpath at 16x16 @ 2 spp, maxdepth 2,
  through both packages' render_file, at the media bars of
  tests/test_parity_images.py:48 (>= 60% of pixels within rel 1e-3, means
  within 4e-2), with its 70 traversal launches, each given finite rays
  (dead lanes included); and the Beer-Lambert case
  of tests/test_media.py:54-85 on the port alone;
* marked slow: the full d_media_volpath file against its golden.

The JAX package's volpath render of that file takes ~40 s on this CPU (it
compiles each call); it runs once, in a module fixture.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu import render as jrender
from pbrt_tpu import scene as jsc
from pbrt_tpu import sceneio as jio
from pbrt_tpu.core import transform as jtf
from pbrt_tpu.core.vecmath import offset_ray_origin as j_offset
from pbrt_tpu.integrators import common as jcommon
from pbrt_tpu.integrators import volpath as jvp
from pbrt_tpu.statics import scene_statics
from pbrt_tpu_torch import bridge
from pbrt_tpu_torch import cameras
from pbrt_tpu_torch import film as tfm
from pbrt_tpu_torch import render as trender
from pbrt_tpu_torch import scene as tsc
from pbrt_tpu_torch import sceneio as tio
from pbrt_tpu_torch.accel import traverse as ttv
from pbrt_tpu_torch.core import transform as ttf
from pbrt_tpu_torch.integrators import common as tcommon
from pbrt_tpu_torch.integrators import volpath as tvp
from pbrt_tpu_torch.integrators.path import PathConfig
from pbrt_tpu_torch.materials import bsdf as tbx
from pbrt_tpu_torch.media import media as tmd
from pbrt_tpu_torch.ops import bvh as kb
from pbrt_tpu_torch.samplers.samplers import SamplerConfig
from pbrt_tpu_torch.utils import stats as tst
from pbrt_tpu_torch.utils.imageio import read_pfm
from test_torch_path import match_frac, mean_rel
from jax_traversal_jit import jit_jax_traversal  # noqa: F401  (autouse)
import test_torch_threads  # noqa: F401  (torch's threads under xdist)

D_MEDIA = "refgold/parity/d_media_volpath.pbrt"
N_RAYS = 1024


def media_bars(ref, got):
    assert match_frac(ref, got) >= 0.60
    assert mean_rel(ref, got) <= 4e-2


def small_d_media(tmp_path, res=16, spp=2, depth=2, integrator="volpath"):
    src = open(D_MEDIA).read()
    src = re.sub(r'"integer xresolution" \[64\] "integer yresolution" \[64\]',
                 f'"integer xresolution" [{res}] "integer yresolution" [{res}]', src)
    src = src.replace('"integer pixelsamples" [4]', f'"integer pixelsamples" [{spp}]')
    src = src.replace('Integrator "volpath" "integer maxdepth" [5]',
                      f'Integrator "{integrator}" "integer maxdepth" [{depth}]')
    path = tmp_path / f"d_media_{integrator}.pbrt"
    path.write_text(src)
    return str(path)


def test_d_media_setup_matches_jax():
    ref, got = jio.parse_pbrt_file(D_MEDIA), tio.parse_pbrt_file(D_MEDIA)
    assert bridge.compare_setups(ref, got) == []
    scene = got.build_scene("cpu")
    assert scene.medium_types == (tmd.MEDIUM_HOMOGENEOUS, tmd.MEDIUM_GRID)
    assert scene.has_media and scene.camera_medium == -1
    assert scene.media.med_type.tolist() == [0, 1]
    assert scene.media.density_atlas.shape == (1 + 8,)
    # the fog sphere (1 prim) and the smoke box (12 triangles) carry media
    assert int((scene.prim_medium_inside >= 0).sum()) == 13
    assert int((scene.prim_medium_outside >= 0).sum()) == 0


CAMERA_MEDIUM = """LookAt 0 0 0  0 0 1  0 1 0
Camera "perspective" "float fov" [30]
MakeNamedMedium "air" "string type" "homogeneous" "rgb sigma_a" [0.7 0.7 0.7]
  "rgb sigma_s" [0 0 0] "float scale" [2]
MediumInterface "air" "air"
Film "image" "integer xresolution" [8] "integer yresolution" [8]
Sampler "sobol" "integer pixelsamples" [4]
Integrator "volpath" "integer maxdepth" [2]
WorldBegin
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [4 4 4] "bool twosided" "true"
  Shape "sphere" "float radius" [2]
AttributeEnd
WorldEnd
"""


def test_camera_medium_from_the_options_block():
    ref = jio.parse_pbrt_string(CAMERA_MEDIUM)
    got = tio.parse_pbrt_string(CAMERA_MEDIUM)
    assert bridge.compare_setups(ref, got) == []
    scene = got.build_scene("cpu")
    assert scene.camera_medium == 0 and scene.has_media
    assert scene.media.sigma_a[0].tolist() == pytest.approx([1.4] * 3)


def test_beer_lambert():
    """tests/test_media.py:54-85 on the port: the camera in an absorbing
    medium looking at an emissive shell at distance 2: L = Le exp(-2
    sigma_a)."""
    b = tsc.SceneBuilder()
    m = b.add_material(tsc.MAT_MATTE, kd=(0.0, 0.0, 0.0))
    b.add_emissive_sphere(ttf.identity(), 2.0, L=(4.0, 4.0, 4.0), material=m,
                          two_sided=True)
    b.camera_medium = b.media.add_homogeneous((0.7,) * 3, (0.0,) * 3, 0.0)
    scene = b.build(device="cpu")
    cam = cameras.make_perspective_camera(
        ttf.look_at([0, 0, 0], [0, 0, 1], [0, 1, 0]), (8, 8), fov_deg=30.0)
    img = tvp.render(scene, cam, tfm.FilmConfig(full_resolution=(8, 8)),
                     SamplerConfig("sobol", 16, (8, 8)), PathConfig(max_depth=2),
                     device="cpu")
    np.testing.assert_allclose(float(img.mean()), 4.0 * np.exp(-0.7 * 2.0),
                               rtol=0.03)


def d_media_scenes():
    ref = jio.parse_pbrt_file(D_MEDIA).build_scene()
    return ref, bridge.scene_from_numpy(bridge.as_numpy_fields(ref), "cpu")


def walk_rays(seed):
    """Rays from outside the media toward them, from inside the fog sphere
    and from inside the smoke box, with their current medium."""
    rs = np.random.RandomState(seed)
    k = N_RAYS // 4
    o = np.concatenate([
        np.array([0.0, 1.2, 5.5]) + rs.randn(2 * k, 3) * 0.3,
        np.array([-1.1, 1.0, 0.0]) + rs.randn(k, 3) * 0.25,
        np.array([1.0, 1.0, 0.6]) + rs.randn(k, 3) * 0.15]).astype(np.float32)
    target = np.array([0.0, 0.8, 0.0]) + rs.randn(N_RAYS, 3) * np.array([1.5, 0.6, 1.5])
    target[::5] = np.array([0.0, 5.0, 3.0])  # toward the point light
    d = target - o
    dist = np.linalg.norm(d, axis=-1).astype(np.float32)
    d = (d / dist[:, None]).astype(np.float32)
    cur = np.concatenate([np.full(2 * k, -1), np.zeros(k), np.ones(k)]).astype(np.int32)
    key = ((np.arange(N_RAYS, dtype=np.uint64) * 0x9E3779B9 + 13)
           & 0xFFFFFFFF).astype(np.uint32)
    return o, d, dist, cur, key


def test_tr_walk_and_intersect_tr_match_jax():
    js, ts = d_media_scenes()
    statics = scene_statics(js)
    o, d, dist, cur, key = walk_rays(7)
    counters = tst.zeros("cpu")
    j_occ, j_tr = jvp._tr_walk_to(js, jnp.asarray(o), jnp.asarray(d),
                                  jnp.asarray(dist), jnp.asarray(cur),
                                  jnp.asarray(key), statics)
    t_occ, t_tr = tvp._tr_walk_to(ts, torch.as_tensor(o), torch.as_tensor(d),
                                  torch.as_tensor(dist), torch.as_tensor(cur),
                                  torch.as_tensor(key.astype(np.int64)), counters)
    j_occ, j_tr = np.asarray(j_occ), np.asarray(j_tr)
    agree = j_occ == t_occ.numpy()
    assert agree.mean() >= 0.995
    assert 0.1 < j_occ.mean() < 0.9
    assert (j_tr[~j_occ, 0] < 0.99).mean() > 0.2  # the media attenuate
    np.testing.assert_allclose(t_tr.numpy()[agree], j_tr[agree], rtol=1e-4, atol=1e-6)

    jt, jp, jtr = jvp._intersect_tr(js, jnp.asarray(o), jnp.asarray(d),
                                    jnp.asarray(cur), jnp.asarray(key), statics)
    tt, tp, ttr = tvp._intersect_tr(ts, torch.as_tensor(o), torch.as_tensor(d),
                                    torch.as_tensor(cur),
                                    torch.as_tensor(key.astype(np.int64)), counters)
    jp, jt, jtr = np.asarray(jp), np.asarray(jt), np.asarray(jtr)
    same = jp == tp.numpy()
    assert same.mean() >= 0.995 and (jp >= 0).mean() > 0.3
    hit = same & (jp >= 0)
    np.testing.assert_allclose(tt.numpy()[hit], jt[hit], rtol=1e-4)
    np.testing.assert_allclose(ttr.numpy()[same], jtr[same], rtol=1e-4, atol=1e-6)
    # 4 + 4 closest-hit launches, every lane live in the first of each
    regular = counters[tst.COUNTERS.index("Intersections/Regular ray intersection tests")]
    assert float(regular) >= 2 * N_RAYS


def shell_scene(sc, tf):
    """tests/test_volpath_tr.py:16-33: a matte sphere r 0.2 inside a
    material-less shell r 1 of absorbing homogeneous medium, a point light
    above the shell."""
    b = sc.SceneBuilder()
    med = b.media.add_homogeneous((0.5,) * 3, (0.0, 0.0, 0.0), 0.0)
    m = b.add_material(sc.MAT_MATTE, kd=(0.6,) * 3)
    b.add_sphere(tf.identity(), 0.2, material=m, medium_outside=med,
                 medium_inside=med)
    b.add_sphere(tf.identity(), 1.0, material=-1, medium_inside=med,
                 medium_outside=-1)
    b.add_point_light(tf.translate(0.0, 0.0, 5.0), (10.0,) * 3)
    b.add_emissive_sphere(tf.translate(2.0, 0.0, 3.0), 0.3, L=(5.0, 5.0, 5.0),
                          material=m)
    return b


def test_estimate_direct_with_tr_fns_matches_jax():
    from pbrt_tpu.accel import traverse as jtv
    from pbrt_tpu.materials import bsdf as jbx

    js = shell_scene(jsc, jtf).build()
    statics = scene_statics(js)
    ts = bridge.scene_from_numpy(bridge.as_numpy_fields(js), "cpu")
    rs = np.random.RandomState(8)
    n = 512
    o = np.tile(np.array([[0.0, 0.0, 0.8]], np.float32), (n, 1))  # in the shell
    d = np.array([0.0, 0.0, -1.0]) + rs.randn(n, 3) * 0.12
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    u_sel = rs.rand(n).astype(np.float32)
    u_l, u_s = rs.rand(n, 2).astype(np.float32), rs.rand(n, 2).astype(np.float32)
    cur = np.zeros(n, np.int32)
    key = ((np.arange(n, dtype=np.uint64) * 0x9E3779B9) & 0xFFFFFFFF).astype(np.uint32)

    t, prim = jtv.intersect_closest(js, jnp.asarray(o), jnp.asarray(d), 1e30,
                                    statics.quadric_types)
    rec = jtv.hit_record(js, jnp.asarray(o), jnp.asarray(d), t, prim,
                         statics.quadric_types)
    mat = jbx.gather_material(js.materials, rec["material"], None, statics.mat_types,
                              uv=rec["uv"])
    frame = jbx.frame_from_rec(rec)
    mask = rec["hit"] & (rec["material"] >= 0)
    jcur, jkey = jnp.asarray(cur), jnp.asarray(key)

    def tr_fn(p_, perr_, ng_, p_light_):
        o_ = j_offset(p_, perr_, ng_, p_light_ - p_)
        dvec = p_light_ - o_
        dist_ = jnp.sqrt(jnp.maximum(jnp.sum(dvec * dvec, -1), 1e-20))
        return jvp._tr_walk_to(js, o_, dvec / dist_[..., None], dist_ * (1.0 - 1e-4),
                               jcur, jkey + jnp.uint32(41), statics)

    def isect_tr_fn(o_, d_):
        return jvp._intersect_tr(js, o_, d_, jcur, jkey + jnp.uint32(43), statics)

    ref = jcommon.sample_one_light(
        js, rec, frame, mat, jbx.to_local(*frame, rec["wo"]), jnp.asarray(u_sel),
        jnp.asarray(u_l), jnp.asarray(u_s), mask, statics.mat_types,
        statics.light_types, statics.quadric_types, tr_fn=tr_fn,
        isect_tr_fn=isect_tr_fn)

    to = torch.as_tensor
    t2, prim2 = ttv.intersect_closest(ts, to(o), to(d), 1e30)
    trec = ttv.hit_record(ts, to(o), to(d), t2, prim2)
    tmat = tbx.gather_material(ts.materials, trec["material"], None)
    tframe = tbx.frame_from_rec(trec)
    tmask = trec["hit"] & (trec["material"] >= 0)
    counters = tst.zeros("cpu")
    tr_fn_t, isect_t = tvp._surface_tr_fns(ts, to(cur), to(key.astype(np.int64)),
                                           counters)
    got, extra = tcommon.sample_one_light(
        ts, trec, tframe, tmat, tbx.to_local(*tframe, trec["wo"]), to(u_sel),
        to(u_l), to(u_s), tmask, tr_fn=tr_fn_t, isect_tr_fn=isect_t)
    assert extra is None
    ref = np.asarray(ref)
    assert np.array_equal(np.asarray(mask), tmask.numpy()) and mask.sum() > n // 2
    within = np.all(np.abs(got.numpy() - ref) <= 1e-4 * np.abs(ref) + 1e-6, -1)
    assert within.mean() >= 0.995
    assert (ref.max(-1) > 0).mean() > 0.3  # light reaches through the medium


@pytest.fixture(scope="module")
def d_media_renders(tmp_path_factory):
    """d_media_volpath at 16x16 @ 2 spp, maxdepth 2: the JAX package's
    render and the port's, with the port's traversal calls."""
    tmp = tmp_path_factory.mktemp("d_media")
    path = small_d_media(tmp)
    ref, _ = jrender.render_file(path, out=str(tmp / "jax.pfm"))
    with kb.record_calls() as calls:
        got, stats = trender.render_file(path, out=str(tmp / "port.pfm"), device="cpu")
    return np.asarray(ref), got, stats, calls, tmp


def test_volpath_render_matches_jax(d_media_renders):
    ref, got, stats, calls, tmp = d_media_renders
    assert got.shape == ref.shape == (16, 16, 3)
    assert np.isfinite(got).all() and got.mean() > 0
    media_bars(ref, got)
    assert np.array_equal(read_pfm(str(tmp / "port.pfm")), got)
    # 2 spp x (2 bounces x (1 + 16 walk segments) + the last closest hit)
    assert len(calls) == 2 * (2 * 17 + 1)
    # every lane the kernel is given is finite, the dead ones included
    for o, d, t_max, _, _ in calls:
        assert torch.isfinite(o).all() and torch.isfinite(d).all()
        assert torch.isfinite(t_max).all()
    assert stats["rays_traced"] > 2 * 16 * 16


@pytest.mark.slow
def test_d_media_meets_its_golden(tmp_path):
    """The full file (64x64 @ 4 spp, maxdepth 5) on the CPU against its
    pbrt-v3 golden at the media bars."""
    got, _ = trender.render_file(D_MEDIA, out=str(tmp_path / "d.pfm"), device="cpu")
    media_bars(read_pfm("refgold/goldens/parity/d_media_volpath.pfm"), got)
