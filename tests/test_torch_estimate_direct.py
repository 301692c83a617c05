"""The port's estimate_direct (integrators/common.py sample_one_light, with
its merged [shadow | MIS | extension] traversal) against the JAX package's
on shared inputs, the scene and bars of tests/test_torch_shading.py.  The
JAX side's compile is the costly part; the file keeps to six tests or
fewer so that xdist's loadfile scheduling hands it out after
tests/test_media.py."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu.accel import traverse as jtv
from pbrt_tpu.integrators import common as jcommon
from pbrt_tpu.materials import bsdf as jbx
from pbrt_tpu_torch.accel import traverse as ttv
from pbrt_tpu_torch.integrators import common as tcommon
from pbrt_tpu_torch.materials import bsdf as tbx
from test_torch_shading import ATOL, RTOL, _unit, lit
from test_torch_traverse import both, camera_rays, jax_traverse
from jax_traversal_jit import jit_jax_traversal  # noqa: F401  (autouse)
import test_torch_threads  # noqa: F401  (torch's threads under xdist)


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
