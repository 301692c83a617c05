"""The port's spot, distant, projection and goniometric lights
(pbrt_tpu_torch.lights.lights) held against the JAX package's: sample_li and
pdf_li on seeded lanes beside the point light, each light's power ("power"
strategy), and the spatial light distribution of a scene with all of them
and an area light.

Bars: tests/test_torch_shading.py's for lane-wise values (rtol 1e-5 and
atol 1e-6 on at least 99.9% of lanes, rtol 1e-3 on all, booleans exact);
the power distribution to 1e-6; the spatial grid exactly and its CDF and
pmf rows to 1e-5 absolute, as tests/test_torch_lightdistrib.py."""
import jax.numpy as jnp
import numpy as np
import torch

from pbrt_tpu.accel import traverse as jtv
from pbrt_tpu.lights import lightdistrib as jld
from pbrt_tpu.lights import lights as jlt
from pbrt_tpu.statics import scene_statics
from pbrt_tpu_torch.lights import lightdistrib as tld
from pbrt_tpu_torch.lights import lights as tlt
from test_torch_shading import _close, _unit, assert_lanes_close
from test_torch_traverse import both
from jax_traversal_jit import jit_jax_traversal  # noqa: F401  (autouse)
import test_torch_threads  # noqa: F401  (torch's threads under xdist)

N = 4000


def _maps():
    rs = np.random.RandomState(5)
    slide = (0.2 + 0.8 * rs.rand(24, 32, 3)).astype(np.float32)
    gonio = (0.3 + rs.rand(16, 32, 3)).astype(np.float32)
    return slide, gonio


def lights_scene(sc, tf, strategy="uniform"):
    """A few small spheres and triangles along a thin strip (a voxel grid
    of about 64 x 8 x 5: the JAX package marks every voxel of the grid)
    lit by a point light, an emissive sphere and the four delta lights of
    this slice, each aimed at the strip."""
    slide, gonio = _maps()
    b = sc.SceneBuilder()
    b.light_strategy = strategy
    m = b.add_material(sc.MAT_MATTE, kd=(0.5, 0.5, 0.5))
    rs = np.random.RandomState(2)
    for x in rs.uniform(-3.5, 3.5, 4):
        b.add_sphere(tf.translate(x, 0.0, 0.3), 0.25, material=m)
    c = np.stack([rs.uniform(-3.5, 3.5, 6), np.zeros(6), np.full(6, 0.3)],
                 -1)[:, None]
    v = c + rs.randn(6, 3, 3) * np.array([0.3, 0.1, 0.05])
    b.add_triangle_mesh(np.arange(18).reshape(-1, 3), v.reshape(-1, 3), material=m)
    b.add_point_light(tf.translate(1, -2, 6), (30.0, 20.0, 10.0))
    b.add_spot_light(tf.translate(0, 0, 7) @ tf.rotate(170, 1, 0, 0),
                     (60.0, 50.0, 40.0), cone_angle_deg=35.0, cone_delta_deg=10.0)
    b.add_distant_light((-1.0, -0.6, 2.0), (1.2, 1.1, 0.9))
    b.add_projection_light(tf.translate(0, -1, 8) @ tf.rotate(180, 1, 0, 0),
                           (80.0, 80.0, 80.0), fov_deg=50.0, image=slide)
    b.add_gonio_light(tf.translate(-3, 2, 4) @ tf.rotate(30, 0, 1, 0),
                      (25.0, 25.0, 25.0), image=gonio)
    b.add_emissive_sphere(tf.translate(2.0, 0.0, 0.3), 0.25, L=(40.0, 40.0, 40.0),
                          material=m)
    return b


def _inputs(seed):
    """Lanes of the point light and the four new lights (the area light's
    cone sampling, ill-conditioned at a small far sphere's silhouette, is
    held in tests/test_torch_shading.py)."""
    js, ts = both(lights_scene)
    rs = np.random.RandomState(seed)
    rows = np.nonzero(ts.lights.light_type.numpy() != 3)[0]
    idx = rows[rs.randint(0, rows.shape[0], N)].astype(np.int32)
    ref_p = (rs.randn(N, 3) * np.array([3.0, 0.5, 0.3]) + [0, 0, 0.3]).astype(np.float32)
    return jtv._device_scene(js), ts, idx, ref_p, rs


def test_sample_li_matches_jax():
    js, ts, idx, ref_p, rs = _inputs(3)
    assert set(ts.light_types) == {0, 1, 2, 3, 5, 6}
    assert set(ts.lights.light_type[torch.as_tensor(idx).long()].tolist()) == {
        0, 1, 2, 5, 6}
    u = rs.rand(N, 2).astype(np.float32)
    ref = jlt.sample_li(js, jnp.asarray(idx), jnp.asarray(ref_p), jnp.asarray(u),
                        ts.light_types)
    got = tlt.sample_li(ts, torch.as_tensor(idx), torch.as_tensor(ref_p),
                        torch.as_tensor(u), ts.light_types)
    _close(ref, got, ("wi", "li", "pdf", "p_light", "is_delta"))
    lt = ts.lights.light_type[torch.as_tensor(idx).long()]
    lit = torch.any(got["li"] > 0, -1)
    for t in (1, 5):  # the spot's cone and the slide's frustum cut off
        assert 0.02 < lit[lt == t].float().mean() < 1.0, t
    assert lit[lt == 6].all()  # the goniometric map is positive
    far = got["p_light"][lt == 2] - torch.as_tensor(ref_p)[lt == 2]
    np.testing.assert_allclose(far.norm(dim=-1).numpy(),
                               2.0 * float(ts.lights.world_radius), rtol=1e-5)


def test_pdf_li_matches_jax():
    js, ts, idx, ref_p, rs = _inputs(4)
    wi = _unit(rs, N)
    ref = jlt.pdf_li(js, jnp.asarray(idx), jnp.asarray(ref_p), jnp.asarray(wi),
                     ts.light_types)
    got = tlt.pdf_li(ts, torch.as_tensor(idx), torch.as_tensor(ref_p),
                     torch.as_tensor(wi), ts.light_types)
    assert_lanes_close(ref, got, "pdf")
    assert torch.all(got == 0)  # delta lights all


def test_power_distribution_matches_jax():
    """_light_power of every light type ("power" strategy): the scene's
    Distribution1D."""
    js, ts = both(lights_scene, "power")
    jd = jtv._device_scene(js).light_distr
    np.testing.assert_allclose(ts.light_distr.func.numpy(), np.asarray(jd.func),
                               rtol=1e-6)
    np.testing.assert_allclose(ts.light_distr.cdf.numpy(), np.asarray(jd.cdf),
                               rtol=1e-6, atol=1e-7)
    assert len(set(np.asarray(jd.func).tolist())) == 6  # every power differs


def test_spatial_distribution_matches_jax():
    js, ts = both(lights_scene)
    ref = jld.build_spatial_distribution(js, scene_statics(js).light_types)
    got = tld.build_spatial_distribution(ts)
    for a, b in zip(ref[:3], got[:3]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ref[3:], got[3:]):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)
    # the delta lights take part: each light is likeliest in some voxel
    assert len(set(np.argmax(got[4], -1).tolist())) >= 4


def le_scene(sc, tf):
    """lights_scene with a one-sided and a two-sided emissive triangle:
    every light type sample_le covers (point, spot, distant, area sphere
    and triangle), and the two it leaves dark (projection, goniometric)."""
    b = lights_scene(sc, tf)
    b.add_emissive_triangle_mesh([[0, 1, 2]], [[-1, 1, 3], [1, 1, 3], [0, 2, 3.5]],
                                 L=(5.0, 4.0, 3.0))
    b.add_emissive_triangle_mesh([[0, 1, 2]], [[2, -1, 2], [3, -1, 2], [2, 0, 2.5]],
                                 L=(2.0, 2.0, 2.0), two_sided=True)
    return b


def test_sample_le_and_pdf_le_match_jax():
    """Light::Sample_Le and Pdf_Le (the light subpaths of bdpt, mlt and
    sppm) on seeded lanes of every light, at tests/test_torch_shading.py's
    bars; pdf_le at the sampled point, normal and direction gives
    sample_le's own pdfs."""
    js, ts = both(le_scene)
    js = jtv._device_scene(js)
    rs = np.random.RandomState(11)
    idx = rs.randint(0, ts.lights.light_type.shape[0], N).astype(np.int32)
    u1, u2 = rs.rand(N, 2).astype(np.float32), rs.rand(N, 2).astype(np.float32)
    ref = jlt.sample_le(js, jnp.asarray(idx), jnp.asarray(u1), jnp.asarray(u2),
                        ts.light_types)
    got = tlt.sample_le(ts, torch.as_tensor(idx), torch.as_tensor(u1),
                        torch.as_tensor(u2), ts.light_types)
    _close(ref, got, ("o", "d", "n_light", "pdf_pos", "pdf_dir", "le", "is_delta_pos"))
    lt = ts.lights.light_type[torch.as_tensor(idx).long()]
    assert set(lt.tolist()) == {0, 1, 2, 3, 5, 6}
    lit = torch.any(got["le"] > 0, -1)
    assert not lit[(lt == 5) | (lt == 6)].any()  # left dark, as in the JAX package
    assert lit[lt == 3].all() and lit[lt == 0].all()
    args = [got["o"], got["n_light"], got["d"]]
    ref_pdf = jlt.pdf_le(js, jnp.asarray(idx), *(jnp.asarray(x.numpy()) for x in args),
                         ts.light_types)
    got_pdf = tlt.pdf_le(ts, torch.as_tensor(idx), *args, ts.light_types)
    for a, b in zip(ref_pdf, got_pdf):
        assert_lanes_close(a, b, "pdf_le")
    area = lt == 3
    assert_lanes_close(got["pdf_dir"][area], got_pdf[1][area], "pdf_dir")
