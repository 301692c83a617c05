"""The port's metal, substrate, uber, translucent and mix materials
(pbrt_tpu_torch.materials.bsdf) held against the JAX package's: for each
case, gather_material, eval_material, sample_material and
count_nonspecular on 4,096 seeded lanes, wo on both sides of the surface;
copper's RGB defaults; and the path integrator's sampler-dimension schedule
on scenes of these materials.

Bar: tests/test_torch_shading.py's, rtol 1e-5 and atol 1e-6 on at least
99.9% of lanes and rtol 1e-3 on all, booleans exact.  A sampled direction wi
takes the all-lanes bar on its length, not per component: a component near
0 is ill-conditioned (a cosine sample at the concentric disk's rim has
z = sqrt(1 - x^2 - y^2), which cancels), so the last-bit sin/cos
differences between XLA and torch move it by up to ~1e-2 relative while
the direction moves by ~2e-5 rad."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.accel import traverse as jtv
from pbrt_tpu.core import sampled_spectrum as jspec
from pbrt_tpu.integrators import path as jpath
from pbrt_tpu.materials import bsdf as jbx
from pbrt_tpu_torch import scene as tsc
from pbrt_tpu_torch.core import sampled_spectrum as tspec
from pbrt_tpu_torch.integrators import path as tpath
from pbrt_tpu_torch.materials import bsdf as tbx
from test_torch_shading import ATOL, LANE_FRAC, RTOL, RTOL_ALL, _close, _unit
from test_torch_traverse import both
from jax_traversal_jit import jit_jax_traversal  # noqa: F401  (autouse)
import test_torch_threads  # noqa: F401  (torch's threads under xdist)

N = 4096
GATHERED = ("kd", "ks", "kr", "kt", "ax", "ay", "eta", "metal_eta", "metal_k",
            "opacity", "is_rough", "type")


def _metal(b, sc):
    b.add_material(sc.MAT_METAL, roughness=0.05)
    b.add_material(sc.MAT_METAL, metal_eta=(1.5, 0.9, 0.4),
                   metal_k=(2.0, 3.0, 4.0), roughness=0.3, remap_roughness=False)


def _substrate(b, sc):
    b.add_material(sc.MAT_SUBSTRATE, kd=(0.5, 0.5, 0.7), ks=(0.3, 0.3, 0.3),
                   urough=0.05, vrough=0.2)
    b.add_material(sc.MAT_SUBSTRATE, kd=(0.2, 0.6, 0.1), ks=(0.1, 0.2, 0.3),
                   urough=0.3, vrough=0.3, remap_roughness=False)


def _uber_opaque(b, sc):
    b.add_material(sc.MAT_UBER, kd=(0.3, 0.3, 0.3), ks=(0.2, 0.2, 0.2),
                   kr=(0.0, 0.0, 0.0), kt=(0.0, 0.0, 0.0), roughness=0.05)


def _uber_half(b, sc):
    """Opacity 0.5 with Kr and Kt > 0: all five lobes; and one with no
    diffuse lobe and a coloured opacity."""
    b.add_material(sc.MAT_UBER, kd=(0.3, 0.3, 0.3), ks=(0.2, 0.2, 0.2),
                   kr=(0.1, 0.1, 0.1), kt=(0.4, 0.5, 0.6), roughness=0.05,
                   opacity=(0.5, 0.5, 0.5), eta=1.33)
    b.add_material(sc.MAT_UBER, kd=(0.0, 0.0, 0.0), ks=(0.5, 0.4, 0.3),
                   kr=(0.2, 0.2, 0.2), kt=(0.3, 0.3, 0.3), roughness=0.2,
                   opacity=(1.0, 0.5, 0.25))


def _translucent(b, sc):
    b.add_material(sc.MAT_TRANSLUCENT, kd=(0.6, 0.5, 0.4), ks=(0.2, 0.2, 0.2),
                   kr=(0.5, 0.5, 0.5), kt=(0.5, 0.5, 0.5), roughness=0.1)
    b.add_material(sc.MAT_TRANSLUCENT, kd=(0.25, 0.25, 0.25),
                   ks=(0.5, 0.5, 0.5), kr=(0.3, 0.6, 0.2), kt=(0.7, 0.2, 0.4),
                   roughness=0.3, remap_roughness=False)


def _mix_matte_metal(b, sc):
    a = b.add_material(sc.MAT_MATTE, kd=(0.2, 0.6, 0.3))
    m = b.add_material(sc.MAT_METAL, roughness=0.05)
    b.add_material(sc.MAT_MIX, mix_m1=a, mix_m2=m, mix_amount=(0.3, 0.3, 0.3))


def _mix_plastic_uber(b, sc):
    p = b.add_material(sc.MAT_PLASTIC, kd=(0.4, 0.2, 0.2), ks=(0.5, 0.5, 0.5),
                       roughness=0.025)
    u = b.add_material(sc.MAT_UBER, kd=(0.3, 0.3, 0.3), ks=(0.2, 0.2, 0.2),
                       kr=(0.1, 0.1, 0.1), kt=(0.2, 0.2, 0.2), roughness=0.05,
                       opacity=(0.5, 0.5, 0.5))
    b.add_material(sc.MAT_MIX, mix_m1=p, mix_m2=u, mix_amount=(0.6, 0.5, 0.4))


CASES = {"metal": _metal, "substrate": _substrate, "uber-opaque": _uber_opaque,
         "uber-half-opacity": _uber_half, "translucent": _translucent,
         "mix-matte-metal": _mix_matte_metal,
         "mix-plastic-uber": _mix_plastic_uber}


def _close_direction(ref, got, err_msg):
    """Unit directions [N, 3]: the tight bar per component on 99.9% of
    lanes, and on every lane |got - ref| <= RTOL_ALL |ref| + ATOL."""
    ref, got = np.asarray(ref), got.numpy()
    ok = np.isclose(got, ref, rtol=RTOL, atol=ATOL).all(-1)
    assert ok.mean() >= LANE_FRAC, (err_msg, np.nonzero(~ok)[0])
    err = np.linalg.norm(got - ref, axis=-1)
    bar = RTOL_ALL * np.linalg.norm(ref, axis=-1) + ATOL
    assert np.all(err <= bar), (err_msg, np.nonzero(err > bar)[0], err.max())


def _scene(add):
    def make(sc, tf):
        b = sc.SceneBuilder()
        add(b, sc)
        b.add_triangle_mesh([[0, 1, 2]], [[0, 0, 0], [1, 0, 0], [0, 1, 0]],
                            material=0)
        b.add_point_light(tf.translate(0, 0, 5), (1, 1, 1))
        return b
    return make


@pytest.mark.parametrize("case", list(CASES))
def test_material_matches_jax(case):
    js, ts = both(_scene(CASES[case]))
    mat_types = ts.mat_types
    rs = np.random.RandomState(sorted(CASES).index(case))
    n_mat = ts.materials.mat_type.shape[0]
    ids = rs.randint(0, n_mat, N).astype(np.int32)
    if case.startswith("mix"):  # mostly the mix row, some of its materials
        ids = np.where(rs.rand(N) < 0.8, n_mat - 1, ids).astype(np.int32)
    jm = jbx.gather_material(jtv._device_scene(js).materials, jnp.asarray(ids),
                             mat_types=mat_types)
    tm = tbx.gather_material(ts.materials, torch.as_tensor(ids),
                             mat_types=mat_types, sub_types=ts.mix_sub_types)
    _close(jm, tm, GATHERED)
    if case.startswith("mix"):
        for sub in ("sub_a", "sub_b"):
            _close(jm[sub], tm[sub], GATHERED)
        _close(jm, tm, ("mix_amount",))
    np.testing.assert_array_equal(np.asarray(jbx.count_nonspecular(jm, mat_types)),
                                  tbx.count_nonspecular(tm).numpy())

    wo = _unit(rs, N)  # both sides of the surface, half each
    wi = _unit(rs, N)
    ref = jbx.eval_material(jm, jnp.asarray(wo), jnp.asarray(wi), mat_types)
    got = tbx.eval_material(tm, torch.as_tensor(wo), torch.as_tensor(wi), mat_types)
    _close(dict(zip("fp", ref)), dict(zip("fp", got)), "fp")
    assert (got[1] > 0).float().mean() > 0.2

    u = rs.rand(N, 2).astype(np.float32)
    ref = jbx.sample_material(jm, jnp.asarray(wo), jnp.asarray(u), mat_types)
    got = tbx.sample_material(tm, torch.as_tensor(wo), torch.as_tensor(u), mat_types)
    _close_direction(ref["wi"], got["wi"], "wi")
    _close(ref, got, ("f", "pdf", "is_specular", "valid"))
    assert got["valid"].float().mean() > 0.3
    if case == "uber-half-opacity":  # the pass-through lobe: wi = -wo
        through = got["is_specular"] & torch.all(got["wi"] == -torch.as_tensor(wo), -1)
        assert through.float().mean() > 0.05


def test_copper_defaults_bit_equal():
    ref, got = jspec.copper_eta_k_rgb(), tspec.copper_eta_k_rgb()
    for a, b in zip(ref, got):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_dimension_schedule_unchanged():
    """No type of this slice changes the dims a bounce draws: 7, plus the
    Russian-roulette dim after bounce 3 (pbrt_tpu/integrators/path.py:
    187-195)."""
    new = tuple(sorted((tsc.MAT_METAL, tsc.MAT_SUBSTRATE, tsc.MAT_UBER,
                        tsc.MAT_TRANSLUCENT, tsc.MAT_MIX, tsc.MAT_MATTE)))
    for bounce in range(8):
        assert tpath.dims_per_bounce(bounce) == jpath._dims_per_bounce(bounce, new)
    for depth in (1, 3, 5):
        cfg = tpath.PathConfig(max_depth=depth)
        assert tpath.n_path_dims(cfg) == 5 + sum(
            jpath._dims_per_bounce(b, new) for b in range(depth)) + 1
