"""Port shading against the JAX package on shared inputs: the matte, plastic
and mirror BSDFs, point and area light sampling, and estimate_direct with
its merged [shadow | MIS | extension] traversal.

Bar: rtol 1e-5, atol 1e-6 on at least 99.9% of lanes, and rtol 1e-3 on
all.  XLA:CPU's sin, cos, sqrt, atan2 and exp differ from torch's in the
last bit on 0.6-18% of f32 inputs; ill-conditioned lanes (a cone sample at
the sphere's silhouette, a microfacet sample under a grazing wo) amplify
that to ~2e-5."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu.accel import traverse as jtv
from pbrt_tpu.integrators import common as jcommon
from pbrt_tpu.lights import lights as jlt
from pbrt_tpu.materials import bsdf as jbx
from pbrt_tpu_torch.accel import traverse as ttv
from pbrt_tpu_torch.integrators import common as tcommon
from pbrt_tpu_torch.lights import lights as tlt
from pbrt_tpu_torch.materials import bsdf as tbx
from test_torch_traverse import both, camera_rays, jax_traverse
from jax_traversal_jit import jit_jax_traversal  # noqa: F401  (autouse)
import test_torch_threads  # noqa: F401  (torch's threads under xdist)

RTOL, ATOL = 1e-5, 1e-6
LANE_FRAC = 0.999
RTOL_ALL = 1e-3


def lit(sc, tf):
    """Every material and light this slice renders: a matte floor, a plastic
    triangle blob, Oren-Nayar and unremapped-roughness variants, a mirror
    sphere; a point light, a small and a large emissive sphere, and a
    one-sided emissive quad."""
    b = sc.SceneBuilder()
    matte = b.add_material(sc.MAT_MATTE, kd=(0.5, 0.5, 0.8))
    rough = b.add_material(sc.MAT_MATTE, kd=(0.7, 0.3, 0.2), sigma=20.0)
    plastic = b.add_material(sc.MAT_PLASTIC, kd=(0.4, 0.2, 0.2),
                             ks=(0.5, 0.5, 0.5), roughness=0.025)
    plastic2 = b.add_material(sc.MAT_PLASTIC, kd=(0.1, 0.3, 0.2),
                              ks=(0.3, 0.4, 0.5), roughness=0.2,
                              remap_roughness=False)
    mirror = b.add_material(sc.MAT_MIRROR, kr=(0.9, 0.8, 0.7))
    b.add_triangle_mesh([[0, 1, 2], [2, 3, 0]],
                        [[-10, -10, 0], [10, -10, 0], [10, 10, 0], [-10, 10, 0]],
                        material=matte)
    rs = np.random.RandomState(0)
    for k, m in enumerate((plastic, rough, plastic2)):
        c = rs.randn(24, 1, 3) * 1.2 + np.array([k - 1.0, 0, 3.0])
        v = c + rs.randn(24, 3, 3) * 0.4
        b.add_triangle_mesh(np.arange(72).reshape(-1, 3), v.reshape(-1, 3),
                            material=m)
    b.add_sphere(tf.translate(2, 0, 2), 0.8, material=mirror)
    b.add_point_light(tf.translate(1, -2, 6), (30.0, 20.0, 10.0))
    b.add_emissive_sphere(tf.translate(0, 5, 8), 0.5, L=(40.0, 40.0, 40.0),
                          material=matte)
    b.add_emissive_sphere(tf.translate(-1, 0, 2.5), 3.5, L=(0.2, 0.3, 0.4),
                          material=matte, two_sided=True)
    b.add_emissive_triangle_mesh([[0, 1, 2], [2, 3, 0]],
                                 [[-1, -1, 7], [1, -1, 7], [1, 1, 7], [-1, 1, 7]],
                                 L=(3.0, 2.0, 1.0), material=matte)
    return b


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_lanes_close(ref, got, err_msg="", frac=LANE_FRAC):
    ref, got = _np(ref), _np(got)
    ok = np.isclose(got, ref, rtol=RTOL, atol=ATOL)
    ok = ok.reshape(ok.shape[0], -1).all(-1)
    assert ok.mean() >= frac, (err_msg, np.nonzero(~ok)[0])
    np.testing.assert_allclose(got, ref, rtol=RTOL_ALL, atol=ATOL, err_msg=err_msg)


def _close(ref: dict, got: dict, keys):
    for k in keys:
        a, b = _np(ref[k]), _np(got[k])
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            assert_lanes_close(a, b, k)


def _unit(rs, n):
    v = rs.randn(n, 3)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _materials(seed, n=4000):
    js, ts = both(lit)
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, ts.materials.mat_type.shape[0], n).astype(np.int32)
    jm = jbx.gather_material(jtv._device_scene(js).materials, jnp.asarray(ids),
                             mat_types=ts.mat_types)
    tm = tbx.gather_material(ts.materials, torch.as_tensor(ids))
    wo = _unit(rs, n)
    wo[:, 2] = np.where(rs.rand(n) < 0.85, np.abs(wo[:, 2]), wo[:, 2])
    return ts.mat_types, jm, tm, wo, rs


def test_gather_material_matches():
    _, jm, tm, _, _ = _materials(0)
    _close(jm, tm, ("kd", "ks", "kr", "sigma", "ax", "ay", "eta"))
    np.testing.assert_array_equal(np.asarray(jm["type"]), tm["type"].numpy())


def test_sample_material_matches():
    mat_types, jm, tm, wo, rs = _materials(1)
    u = rs.rand(wo.shape[0], 2).astype(np.float32)
    ref = jbx.sample_material(jm, jnp.asarray(wo), jnp.asarray(u), mat_types)
    got = tbx.sample_material(tm, torch.as_tensor(wo), torch.as_tensor(u), mat_types)
    _close(ref, got, ("wi", "f", "pdf", "is_specular", "valid"))
    assert 0.5 < got["valid"].float().mean() < 1.0


def test_eval_material_matches():
    mat_types, jm, tm, wo, rs = _materials(2)
    wi = _unit(rs, wo.shape[0])
    ref = jbx.eval_material(jm, jnp.asarray(wo), jnp.asarray(wi), mat_types)
    got = tbx.eval_material(tm, torch.as_tensor(wo), torch.as_tensor(wi), mat_types)
    _close(dict(zip("fp", ref)), dict(zip("fp", got)), "fp")
    np.testing.assert_array_equal(jbx.count_nonspecular(jm, mat_types),
                                  tbx.count_nonspecular(tm).numpy())


def _light_inputs(seed, n=4000):
    js, ts = both(lit)
    rs = np.random.RandomState(seed)
    idx = rs.randint(0, ts.lights.light_type.shape[0], n).astype(np.int32)
    ref_p = (rs.randn(n, 3) * np.array([4.0, 4.0, 2.0]) + [0, 0, 3]).astype(np.float32)
    return jtv._device_scene(js), ts, idx, ref_p, rs


def test_sample_li_matches():
    js, ts, idx, ref_p, rs = _light_inputs(3)
    u = rs.rand(idx.shape[0], 2).astype(np.float32)
    ref = jlt.sample_li(js, jnp.asarray(idx), jnp.asarray(ref_p), jnp.asarray(u),
                        ts.light_types)
    got = tlt.sample_li(ts, torch.as_tensor(idx), torch.as_tensor(ref_p),
                        torch.as_tensor(u), ts.light_types)
    _close(ref, got, ("wi", "li", "pdf", "p_light", "is_delta"))
    assert set(ts.light_types) == {0, 3}


def test_pdf_li_and_emission_match():
    js, ts, idx, ref_p, rs = _light_inputs(4)
    n = idx.shape[0]
    u = rs.rand(n, 2).astype(np.float32)
    # half toward a sampled light point (so the light is hit), half anywhere
    s = tlt.sample_li(ts, torch.as_tensor(idx), torch.as_tensor(ref_p),
                      torch.as_tensor(u), ts.light_types)
    wi = np.where(rs.rand(n, 1) < 0.5, s["wi"].numpy(), _unit(rs, n))
    ref = jlt.pdf_li(js, jnp.asarray(idx), jnp.asarray(ref_p), jnp.asarray(wi),
                     ts.light_types)
    got = tlt.pdf_li(ts, torch.as_tensor(idx), torch.as_tensor(ref_p),
                     torch.as_tensor(wi), ts.light_types)
    assert_lanes_close(ref, got, "pdf")
    assert (got > 0).float().mean() > 0.2
    ng = _unit(rs, n)
    ref = jlt.area_light_emission(js, jnp.asarray(idx), jnp.asarray(ng), jnp.asarray(wi))
    got = tlt.area_light_emission(ts, torch.as_tensor(idx), torch.as_tensor(ng),
                                  torch.as_tensor(wi))
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


def _oracle(scene, o, d, t_max, any_mask=None):
    return ttv._traverse(scene, o, d, t_max, any_mask=any_mask)


@pytest.mark.parametrize("oracle", [True, False], ids=["oracle", "kernel-path"])
def test_estimate_direct_matches(oracle, monkeypatch):
    """Shared inputs: the JAX hit record of the same camera rays.  With the
    port's traversal swapped for its watertight oracle (the JAX package's
    CPU traversal) the estimates agree lane for lane; through the port's
    own 4-wide Moller-Trumbore path, grazing shadow rays may differ, so
    99% of lanes."""
    if oracle:
        monkeypatch.setattr(ttv, "intersect_closest", _oracle)
    js, ts = both(lit)
    jd = jtv._device_scene(js)
    o, d = camera_rays(3000, 10)
    n = o.shape[0]
    t, p = jax_traverse(js, o, d)
    qt = jtv.scene_quadric_types(js)
    rec_j = jtv.hit_record(jd, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t),
                           jnp.asarray(p), qt)
    rec_t = {k: torch.as_tensor(np.array(v)) for k, v in rec_j.items()}
    rs = np.random.RandomState(11)
    u_sel = rs.rand(n).astype(np.float32)
    u_light = rs.rand(n, 2).astype(np.float32)
    u_scat = rs.rand(n, 2).astype(np.float32)
    o3 = (o + rs.randn(n, 3) * 0.5).astype(np.float32)
    d3 = _unit(rs, n)
    mask = np.asarray(rec_j["hit"]) & (np.asarray(rec_j["material"]) >= 0)

    jm = jbx.gather_material(jd.materials, rec_j["material"], mat_types=ts.mat_types)
    jf = jbx.frame_from_rec(rec_j)
    jwo = jbx.to_local(*jf, rec_j["wo"])
    ld_j, (t3_j, p3_j) = jcommon.sample_one_light(
        jd, rec_j, jf, jm, jwo, jnp.asarray(u_sel), jnp.asarray(u_light),
        jnp.asarray(u_scat), jnp.asarray(mask), ts.mat_types, ts.light_types, qt,
        extra_ray=(jnp.asarray(o3), jnp.asarray(d3)))

    tm = tbx.gather_material(ts.materials, rec_t["material"])
    tf_ = tbx.frame_from_rec(rec_t)
    two = tbx.to_local(*tf_, rec_t["wo"])
    ld_t, (t3_t, p3_t) = tcommon.sample_one_light(
        ts, rec_t, tf_, tm, two, torch.as_tensor(u_sel), torch.as_tensor(u_light),
        torch.as_tensor(u_scat), torch.as_tensor(mask),
        extra_ray=(torch.as_tensor(o3), torch.as_tensor(d3)))

    ld_j, ld_t = np.asarray(ld_j), ld_t.numpy()
    assert (ld_j > 0).any(-1).mean() > 0.1
    close = np.isclose(ld_t, ld_j, rtol=RTOL, atol=ATOL).all(-1)
    p3_j, p3_t = np.asarray(p3_j), p3_t.numpy()
    if oracle:
        assert close.all(), np.nonzero(~close)
        np.testing.assert_array_equal(p3_t, p3_j)
    else:
        assert close.mean() >= 0.99
        assert (p3_t == p3_j).mean() >= 0.99
    hit = (p3_t >= 0) & (p3_t == p3_j)
    np.testing.assert_allclose(t3_t.numpy()[hit], np.asarray(t3_j)[hit], rtol=1e-3)


def test_occluded_matches_jax():
    """VisibilityTester::Unoccluded: the port's any-hit kernel path against
    the JAX watertight any-hit walk (grazing shadow rays may differ)."""
    js, ts = both(lit)
    rs = np.random.RandomState(12)
    n = 3000
    p = (rs.randn(n, 3) * np.array([4.0, 4.0, 2.0]) + [0, 0, 3]).astype(np.float32)
    p_err = np.full((n, 3), 1e-5, np.float32)
    ng = _unit(rs, n)
    p_light = (rs.randn(n, 3) * 3 + [0, 0, 6]).astype(np.float32)
    ref = np.asarray(jcommon.occluded(jtv._device_scene(js), *map(jnp.asarray, (
        p, p_err, ng, p_light)), jtv.scene_quadric_types(js)))
    got = tcommon.occluded(ts, *map(torch.as_tensor, (p, p_err, ng, p_light))).numpy()
    assert 0.2 < ref.mean() < 0.9
    assert (ref == got).mean() >= 0.99
