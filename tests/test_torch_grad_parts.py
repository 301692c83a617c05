"""Gradients of the parts the grad step newly reaches, held against the JAX
package's jax.grad of the same function on the same seeded inputs (the
new gradient guards at their edges are held in tests/test_torch_grad.py):

* the Fourier series (core/interpolation.py fourier_eval, whose backward
  is the float32 recurrence's adjoint) with respect to its coefficients
  and cos phi, and sample_fourier's 40 Newton steps with respect to the
  coefficients, on the in-repo table's series;
* image-texture lookups (bilinear, trilinear, EWA) under the three wraps,
  with respect to uv (and the footprint);
* the infinite light's env-map lookup along escaped rays, with respect to
  the direction.

Bar: each gradient within 1e-3 of the JAX gradient's largest entry (plus
1e-6) on every lane, the step's leaf bar
(tests/test_torch_grad_jax.py:test_grads_match_jax_at_depth1), but
sample_fourier's, which is held on the lanes whose phi
agrees with the JAX package's to 1e-5: the two Newton solves stop an
iteration apart on a few lanes (tests/test_torch_interpolation.py's
docstring), and there the derivative of the unrolled solve differs too.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu import scene as jsc
from pbrt_tpu.accel import traverse as jtv
from pbrt_tpu.core import interpolation as jitp
from pbrt_tpu.core import transform as jtf
from pbrt_tpu.lights import lights as jlt
from pbrt_tpu.materials import fourier as jfz
from pbrt_tpu.textures import textures as jtx
from pbrt_tpu_torch import bridge
from pbrt_tpu_torch.core import interpolation as titp
from pbrt_tpu_torch.lights import lights as tlt
from pbrt_tpu_torch.textures import textures as ttx
from test_torch_envlight import env_scene
from test_torch_textures import _image, _lookup_inputs, _tables
from jax_traversal_jit import jit_jax_traversal  # noqa: F401  (autouse)
import test_torch_threads  # noqa: F401  (torch's threads under xdist)

N = 2048
BSDF = str(Path(__file__).resolve().parent.parent / "pbrt_tpu" / "data"
           / "roughgold_alpha_0.2.bsdf")


def assert_grad_close(ref, got, what, lanes=None):
    ref = np.asarray(ref, np.float32)
    got = got.detach().numpy()
    assert ref.shape == got.shape, what
    assert np.isfinite(got).all(), what
    if lanes is not None:
        ref, got = ref[lanes], got[lanes]
    assert np.isfinite(ref).all(), what
    bar = 1e-3 * np.abs(ref).max() + 1e-6
    assert np.abs(got - ref).max() <= bar, (what, np.abs(got - ref).max(), bar)


@pytest.fixture(scope="module")
def series():
    """Coefficient series of the in-repo table at seeded (mu_i, mu_o),
    with each lane's order, and seeded weights."""
    tbl = jfz.read_bsdf(BSDF)
    rs = np.random.RandomState(3)
    mu_i = rs.uniform(-1, 1, N).astype(np.float32)
    mu_o = rs.uniform(0, 1, N).astype(np.float32)
    ak, m, _ = jfz._accumulate_ak(tbl, jnp.asarray(mu_i), jnp.asarray(mu_o))
    return np.asarray(ak[:, 0]), np.asarray(m), rs


def test_fourier_eval_gradients_match_jax(series):
    ak, m, rs = series
    cos_phi = rs.uniform(-1, 1, N).astype(np.float32)
    cos_phi[:4] = (-1.0, 1.0, 0.0, 0.9999)
    w = rs.uniform(0.5, 1.5, N).astype(np.float32)
    ref = jax.grad(lambda a, c: jnp.sum(w * jitp.fourier_eval(a, c, m)), (0, 1))(
        jnp.asarray(ak), jnp.asarray(cos_phi))
    a, c = (torch.tensor(x, requires_grad=True) for x in (ak, cos_phi))
    val = titp.fourier_eval(a, c, torch.as_tensor(m))
    got = torch.autograd.grad(torch.sum(torch.as_tensor(w) * val), (a, c))
    assert_grad_close(ref[0], got[0], "d/d ak")
    assert_grad_close(ref[1], got[1], "d/d cos_phi")
    # the forward through the autograd function stays the plain one, bit
    # for bit the JAX package's
    np.testing.assert_array_equal(val.detach().numpy(), np.asarray(
        jitp.fourier_eval(jnp.asarray(ak), jnp.asarray(cos_phi), jnp.asarray(m))))


def test_sample_fourier_gradients_match_jax(series):
    ak, m, rs = series
    u = rs.rand(N).astype(np.float32)
    w = rs.uniform(0.5, 1.5, (2, N)).astype(np.float32)

    def jloss(a):
        f, pdf, phi = jitp.sample_fourier(a, jnp.asarray(u), jnp.asarray(m))
        return jnp.sum(w[0] * phi + w[1] * pdf), phi

    (_, jphi), ref = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(ak))
    a = torch.tensor(ak, requires_grad=True)
    _, pdf, phi = titp.sample_fourier(a, torch.as_tensor(u), torch.as_tensor(m))
    w_t = torch.as_tensor(w)
    (got,) = torch.autograd.grad(torch.sum(w_t[0] * phi + w_t[1] * pdf), a)
    same = np.abs(phi.detach().numpy() - np.asarray(jphi)) <= 1e-5
    assert same.mean() >= 0.99, same.mean()
    # the JAX package's row is NaN where its solve ends with cos(phi)
    # rounded to +-1: sqrt(max(0, 1 - cos^2))' = inf there
    # (pbrt_tpu/core/interpolation.py:101); the port's safe_sqrt is finite
    jax_ok = np.isfinite(np.asarray(ref)).all(-1)
    assert jax_ok.mean() >= 0.9, jax_ok.mean()
    assert_grad_close(ref, got, "d/d ak", lanes=same & jax_ok)


@pytest.mark.parametrize("wrap", [ttx.WRAP_REPEAT, ttx.WRAP_BLACK,
                                  ttx.WRAP_CLAMP], ids=["repeat", "black", "clamp"])
def test_texture_lookup_gradients_match_jax(wrap):
    """d/d uv of the level-0 bilinear lookup (the grad step's), and of the
    trilinear and EWA lookups with d/d footprint, against jax.grad."""
    jt, tt, fields, _ = _tables([(jtx.TEX_IMAGEMAP, dict(image=_image(1)))])
    nl = int(fields["n_levels"][0])
    uv, d0, d1 = _lookup_inputs(2 + wrap)
    width = (np.abs(d0).max(-1) * 2.0).astype(np.float32)
    wts = np.random.RandomState(9).uniform(0.5, 1.5, (uv.shape[0], 3)).astype(
        np.float32)
    cases = {
        "bilinear": (lambda x: jtx._bilinear_lookup(jt, 0, x[0], wrap),
                     lambda x: ttx._bilinear_at(tt, tt.img_offset[0], tt.img_w[0],
                                                tt.img_h[0], x[0], wrap), (uv,)),
        "trilinear": (lambda x: jtx._trilinear_lookup(jt, 0, x[0], x[1], nl, wrap),
                      lambda x: ttx._trilinear_lookup(tt, 0, x[0], x[1], nl, wrap),
                      (uv, width)),
        "ewa": (lambda x: jtx._aniso_lookup(jt, 0, x[0], x[1], x[2], nl, wrap, 8.0),
                lambda x: ttx._aniso_lookup(tt, 0, x[0], x[1], x[2], nl, wrap, 8.0),
                (uv, d0, d1)),
    }
    for what, (jf, tf, args) in cases.items():
        ref = jax.grad(lambda *x: jnp.sum(wts * jf(x)), tuple(range(len(args))))(
            *(jnp.asarray(x) for x in args))
        ts = [torch.tensor(x, requires_grad=True) for x in args]
        got = torch.autograd.grad(torch.sum(torch.as_tensor(wts) * tf(ts)), ts)
        for i, (r, g) in enumerate(zip(ref, got)):
            assert_grad_close(r, g, f"{what} d/d arg {i}")
        assert float(got[0].abs().max()) > 0, what


def test_env_map_gradient_matches_jax():
    """d/d direction of the escaped radiance of a rotated env map beside a
    constant infinite light (tests/test_torch_envlight.py's scene)."""
    j = env_scene(jsc, jtf).build()
    js = jtv._device_scene(j)
    ts = bridge.scene_from_numpy(bridge.as_numpy_fields(j), "cpu")
    rs = np.random.RandomState(4)
    d = rs.randn(N, 3).astype(np.float32)
    d[:2] = ((0, 0, 1), (0, 0, -1))  # the map's poles in world space differ
    wts = rs.uniform(0.5, 1.5, (N, 3)).astype(np.float32)
    ref = jax.grad(lambda x: jnp.sum(wts * jlt.escaped_radiance(js, x, ts.light_types)))(
        jnp.asarray(d))
    x = torch.tensor(d, requires_grad=True)
    (got,) = torch.autograd.grad(
        torch.sum(torch.as_tensor(wts) * tlt.escaped_radiance(ts, x, ts.light_types)), x)
    assert_grad_close(ref, got, "d/d direction")


