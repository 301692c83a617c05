"""The per-lane dimension draws the wavefront engine takes
(samplers.get_1d_dyn/get_2d_dyn, with lowdiscrepancy's
scrambled_radical_inverse_dyn and sobol_sample_float64idx_dyn) against
the JAX package's, on the CPU: every sampler, each lane at its own random
dimension, bit for bit; the pss sampler raises in both."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu.samplers import samplers as jsa
from pbrt_tpu_torch.samplers import samplers as tsa
import test_torch_threads  # noqa: F401  (torch's threads under xdist)

SAMPLERS = ("halton", "sobol", "random", "stratified", "zerotwosequence", "maxmin")
RES = (24, 20)
SPP = 8
MAX_DIM = 200  # the halton lanes' dims stay within the permutations read


def _bits(x):
    return np.asarray(x).view(np.uint32)


def _lanes():
    """Every (pixel, sample) of a RES image at SPP, and a dim a lane:
    5 to MAX_DIM, and for the hashing samplers also past 1021, where the
    JAX package clamps."""
    rs = np.random.RandomState(3)
    xs, ys = np.meshgrid(np.arange(RES[0]), np.arange(RES[1]))
    pix = np.repeat(np.stack([xs.ravel(), ys.ravel()], -1), SPP, 0).astype(np.int32)
    snum = np.tile(np.arange(SPP), RES[0] * RES[1])
    dims = rs.randint(5, MAX_DIM - 1, size=snum.shape[0])
    far = rs.randint(900, 1200, size=snum.shape[0])
    return pix, snum, dims, far


@pytest.mark.parametrize("name", SAMPLERS)
def test_dyn_draws_bit_equal(name):
    pix, snum, dims, far = _lanes()
    jc = jsa.SamplerConfig(name, SPP, RES, seed=7)
    tc = tsa.SamplerConfig(name, SPP, RES, seed=7)
    js = jsa.init_state(jc, jnp.asarray(pix), jnp.asarray(snum.astype(np.uint32)))
    ts = tsa.init_state(tc, torch.as_tensor(pix), torch.as_tensor(snum))
    cases = [dims, dims + 1] + ([] if name in ("halton", "sobol") else [far])
    for d in cases:
        jd, td = jnp.asarray(d.astype(np.int32)), torch.as_tensor(d)
        np.testing.assert_array_equal(
            _bits(jsa.get_1d_dyn(jc, js, jd)),
            _bits(tsa.get_1d_dyn(tc, ts, td, MAX_DIM).numpy()), err_msg="1d")
        np.testing.assert_array_equal(
            _bits(jsa.get_2d_dyn(jc, js, jd)),
            _bits(tsa.get_2d_dyn(tc, ts, td, MAX_DIM).numpy()), err_msg="2d")
    if name == "sobol":  # sobol's table has 1024 dims: far ones too
        jd, td = jnp.asarray(far.astype(np.int32)), torch.as_tensor(far)
        np.testing.assert_array_equal(_bits(jsa.get_1d_dyn(jc, js, jd)),
                                      _bits(tsa.get_1d_dyn(tc, ts, td).numpy()))


def test_dyn_draws_at_static_dims_equal_static_draws():
    """A dim tensor holding one value draws what get_1d/get_2d draw there
    (the wavefront on a non-specular scene follows the lockstep schedule)."""
    pix, snum, _, _ = _lanes()
    for name in ("halton", "sobol"):
        tc = tsa.SamplerConfig(name, SPP, RES)
        ts = tsa.init_state(tc, torch.as_tensor(pix), torch.as_tensor(snum))
        for dim in (5, 12, 40):
            d = torch.full((pix.shape[0],), dim, dtype=torch.int64)
            assert torch.equal(tsa.get_1d_dyn(tc, ts, d, MAX_DIM), tsa.get_1d(tc, ts, dim))
            assert torch.equal(tsa.get_2d_dyn(tc, ts, d, MAX_DIM), tsa.get_2d(tc, ts, dim))


def test_pss_raises_as_in_jax():
    d = np.full(4, 6)
    jc = jsa.SamplerConfig("pss", 1, (2, 2))
    with pytest.raises(ValueError, match="pss"):
        jsa.get_1d_dyn(jc, {"x": jnp.zeros((4, 8))}, jnp.asarray(d))
    tc = tsa.SamplerConfig.pss((2, 2))
    with pytest.raises(ValueError, match="pss"):
        tsa.get_1d_dyn(tc, {"x": torch.zeros((4, 8))}, torch.as_tensor(d))
    with pytest.raises(ValueError, match="pss"):
        tsa.get_2d_dyn(tc, {"x": torch.zeros((4, 8))}, torch.as_tensor(d))
