"""The port's glass (pbrt_tpu_torch.materials.bsdf) held against the JAX
package's: smooth glass (FresnelSpecular) and rough glass (microfacet
reflection plus transmission), with wo on both sides of the surface, through
gather_material, sample_material, eval_material and count_nonspecular, and
refract (core/vecmath).

Bar: tests/test_torch_shading.py's, rtol 1e-5 and atol 1e-6 on at least
99.9% of lanes and rtol 1e-3 on all, booleans exact: XLA:CPU's sqrt, sin,
cos and atan2 differ from torch's in the last bit, and a microfacet sample
under a grazing wo amplifies that."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.accel import traverse as jtv
from pbrt_tpu.core import vecmath as jvm
from pbrt_tpu.materials import bsdf as jbx
from pbrt_tpu_torch.core import vecmath as tvm
from pbrt_tpu_torch.materials import bsdf as tbx
from test_torch_shading import _close, _unit, assert_lanes_close
from test_torch_traverse import both
from jax_traversal_jit import jit_jax_traversal  # noqa: F401  (autouse)
import test_torch_threads  # noqa: F401  (torch's threads under xdist)

N = 4000


def glass(sc, tf):
    """Smooth glass, rough glass (remapped roughness 0.1), tinted rough glass
    (unremapped 0.3, eta 1.33), and a matte floor."""
    b = sc.SceneBuilder()
    b.add_material(sc.MAT_GLASS, kr=(1.0, 1.0, 1.0), kt=(1.0, 1.0, 1.0),
                   eta=1.5, roughness=0.0)
    b.add_material(sc.MAT_GLASS, kr=(1.0, 1.0, 1.0), kt=(1.0, 1.0, 1.0),
                   eta=1.5, roughness=0.1)
    b.add_material(sc.MAT_GLASS, kr=(0.9, 0.8, 0.7), kt=(0.6, 0.9, 0.8),
                   eta=1.33, roughness=0.3, remap_roughness=False)
    m = b.add_material(sc.MAT_MATTE, kd=(0.5, 0.5, 0.5))
    b.add_triangle_mesh([[0, 1, 2]], [[0, 0, 0], [1, 0, 0], [0, 1, 0]], material=m)
    return b


@pytest.fixture(scope="module")
def mats():
    js, ts = both(glass)
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 3, N).astype(np.int32)
    jm = jbx.gather_material(jtv._device_scene(js).materials, jnp.asarray(ids),
                             mat_types=ts.mat_types)
    tm = tbx.gather_material(ts.materials, torch.as_tensor(ids))
    wo = _unit(rs, N)  # both sides of the surface, half each
    assert 0.4 < (wo[:, 2] > 0).mean() < 0.6
    return ts.mat_types, jm, tm, wo, rs


def test_gather_glass_columns(mats):
    _, jm, tm, _, _ = mats
    _close(jm, tm, ("kr", "kt", "ax", "ay", "eta", "is_rough"))
    assert 0 < tm["is_rough"].float().mean() < 1


def test_sample_glass_matches(mats):
    mat_types, jm, tm, wo, rs = mats
    u = rs.rand(N, 2).astype(np.float32)
    ref = jbx.sample_material(jm, jnp.asarray(wo), jnp.asarray(u), mat_types)
    got = tbx.sample_material(tm, torch.as_tensor(wo), torch.as_tensor(u), mat_types)
    _close(ref, got, ("wi", "f", "pdf", "is_specular", "valid"))
    np.testing.assert_array_equal(got["is_specular"].numpy(), ~tm["is_rough"].numpy())
    crossed = got["wi"][:, 2] * torch.as_tensor(wo)[:, 2] < 0
    for rough in (False, True):  # each kind both reflects and transmits
        sel = (tm["is_rough"] == rough) & got["valid"]
        assert 0.05 < crossed[sel].float().mean() < 0.95


def test_eval_glass_matches(mats):
    mat_types, jm, tm, wo, rs = mats
    wi = _unit(rs, N)
    ref = jbx.eval_material(jm, jnp.asarray(wo), jnp.asarray(wi), mat_types)
    got = tbx.eval_material(tm, torch.as_tensor(wo), torch.as_tensor(wi), mat_types)
    _close(dict(zip("fp", ref)), dict(zip("fp", got)), "fp")
    smooth = ~tm["is_rough"]
    assert (got[0][smooth] == 0).all() and (got[1][smooth] == 0).all()
    assert (got[1][~smooth] > 0).float().mean() > 0.5
    np.testing.assert_array_equal(np.asarray(jbx.count_nonspecular(jm, mat_types)),
                                  tbx.count_nonspecular(tm).numpy())


def test_refract_matches():
    rs = np.random.RandomState(3)
    wi = _unit(rs, N)
    n = _unit(rs, N)
    eta = rs.uniform(0.5, 2.0, N).astype(np.float32)
    ok_j, wt_j = jvm.refract(jnp.asarray(wi), jnp.asarray(n), jnp.asarray(eta))
    ok_t, wt_t = tvm.refract(torch.as_tensor(wi), torch.as_tensor(n),
                             torch.as_tensor(eta))
    np.testing.assert_array_equal(np.asarray(ok_j), ok_t.numpy())
    assert_lanes_close(wt_j, wt_t, "refract")
    assert 0.1 < (~ok_t).float().mean() < 0.9  # total internal reflection
