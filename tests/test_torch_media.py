"""The port's participating media (pbrt_tpu_torch.media.media) held against
the JAX package's (pbrt_tpu.media.media) on the same seeded inputs.

Bars: the counter hash (_mix, _rand) and the lane keys bit-equal over 2^16
seeded pairs; the medium table equal to the JAX builder's; hg_p, hg_sample,
homogeneous_tr, homogeneous_sample and _grid_density within rtol 1e-6
(atol 1e-7; XLA's transcendentals and torch's differ in the last bit);
grid_sample (delta tracking, with and without the sampler-dim table) and
grid_tr (ratio tracking) on 4096 seeded lanes through an 8^3 grid under a
non-identity world-to-medium matrix: sampled_medium equal on >= 99.5% of
the lanes and t, weight and Tr within rtol 1e-5 where the decisions agree
(a last-bit difference in log can flip a step's decision on a rare lane).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.media import media as jm
from pbrt_tpu_torch.core import rng as trng
from pbrt_tpu_torch.media import media as tm
from jax_traversal_jit import jit_jax_traversal  # noqa: F401  (autouse)
import test_torch_threads  # noqa: F401  (torch's threads under xdist)

N = 4096
W2M = np.array([[0.5, 0.1, 0.0, 0.3], [0.0, 0.4, 0.1, 0.2],
                [0.05, 0.0, 0.45, 0.25], [0.0, 0.0, 0.0, 1.0]], np.float32)


def u32(rs, n):
    return rs.randint(0, 2 ** 32, size=n, dtype=np.uint64).astype(np.uint32)


def t64(x):
    return torch.as_tensor(np.asarray(x).astype(np.int64))


def test_mix_and_rand_bit_equal():
    rs = np.random.RandomState(0)
    key, ctr = u32(rs, 1 << 16), u32(rs, 1 << 16)
    ref = np.asarray(jm._mix(jnp.asarray(key)))
    assert np.array_equal(trng.mix32(t64(key)).numpy(), ref.astype(np.int64))
    ref = np.asarray(jm._rand(jnp.asarray(key), jnp.asarray(ctr)))
    got = tm._rand(t64(key), t64(ctr)).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))
    # a counter shared by every lane, as the tracking loops pass it
    ref = np.asarray(jm._rand(jnp.asarray(key), jnp.uint32(0x5555 + 77)))
    got = tm._rand(t64(key), 0x5555 + 77).numpy()
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_lane_keys_and_offsets_wrap_as_uint32():
    """lane * 0x9E3779B9 and the key offsets modulo 2^32 (volpath.py:249)."""
    n = 1 << 20
    ref = np.asarray(jnp.arange(n, dtype=jnp.uint32) * jnp.uint32(0x9E3779B9))
    got = tm.lane_keys(n, "cpu")
    assert np.array_equal(got.numpy(), ref.astype(np.int64))
    ref2 = np.asarray(jnp.asarray(ref) + jnp.uint32(4 * 0x101) + jnp.uint32(43))
    got2 = tm.key_add(tm.key_add(got, 4 * 0x101), 43)
    assert np.array_equal(got2.numpy(), ref2.astype(np.int64))


def tables(rs):
    """One homogeneous and one 8^3 grid medium in both packages."""
    density = (rs.rand(8 ** 3) * 2.0).astype(np.float32)
    j, t = jm.HostMediumTable(), tm.HostMediumTable()
    for h in (j, t):
        h.add_homogeneous((0.1, 0.2, 0.3), (0.5, 0.5, 0.5), 0.3)
        h.add_grid((0.4,) * 3, (2.0,) * 3, 0.0, 8, 8, 8, density, W2M)
    return j.freeze(), tm.MediumTable.from_numpy(t.to_numpy(), "cpu")


def test_medium_table_equals_jax():
    jt, tt = tables(np.random.RandomState(1))
    for k in tm.MEDIUM_FIELDS:
        ref, got = np.asarray(getattr(jt, k)), getattr(tt, k).numpy()
        assert ref.dtype == got.dtype and np.array_equal(ref, got), k
    empty = tm.HostMediumTable().to_numpy()
    ref = jm.HostMediumTable().freeze()
    for k in tm.MEDIUM_FIELDS:
        assert np.array_equal(np.asarray(getattr(ref, k)), empty[k]), k


def close(ref, got, rtol=1e-6, atol=1e-7):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol, atol=atol)


def unit(rs, n):
    d = rs.randn(n, 3).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("g", [-0.7, 0.0, 0.2, 0.9])
def test_hg_p_and_sample(g):
    rs = np.random.RandomState(2)
    wo, u = unit(rs, N), rs.rand(N, 2).astype(np.float32)
    gs = np.full(N, g, np.float32)
    cos_t = (rs.rand(N) * 2 - 1).astype(np.float32)
    close(jm.hg_p(jnp.asarray(cos_t), jnp.asarray(gs)),
          tm.hg_p(torch.as_tensor(cos_t), torch.as_tensor(gs)))
    jw, jp = jm.hg_sample(jnp.asarray(wo), jnp.asarray(u), jnp.asarray(gs))
    tw, tp = tm.hg_sample(torch.as_tensor(wo), torch.as_tensor(u),
                          torch.as_tensor(gs))
    close(jw, tw, atol=1e-6)
    close(jp, tp)


def test_homogeneous_tr_and_sample():
    rs = np.random.RandomState(3)
    sa = (rs.rand(N, 3) * 0.5).astype(np.float32)
    ss = (rs.rand(N, 3) * 2.0).astype(np.float32)
    ss[::7] = 0.0
    sa[::7] = 0.0  # sigma_t = 0: no medium event
    t_max = (rs.rand(N) * 3.0).astype(np.float32)
    u1, u2 = rs.rand(N).astype(np.float32), rs.rand(N).astype(np.float32)
    close(jm.homogeneous_tr(jnp.asarray(sa + ss), jnp.asarray(t_max)),
          tm.homogeneous_tr(torch.as_tensor(sa + ss), torch.as_tensor(t_max)))
    ref = jm.homogeneous_sample(*map(jnp.asarray, (sa, ss, t_max, u1, u2)))
    got = tm.homogeneous_sample(*map(torch.as_tensor, (sa, ss, t_max, u1, u2)))
    assert np.array_equal(np.asarray(ref["sampled_medium"]),
                          got["sampled_medium"].numpy())
    close(ref["t"], got["t"])
    close(ref["weight"], got["weight"])


def test_grid_density():
    rs = np.random.RandomState(4)
    jt, tt = tables(rs)
    p = (rs.rand(N, 3) * 1.2 - 0.1).astype(np.float32)  # some outside
    mid = np.ones(N, np.int32)
    close(jm._grid_density(jt, jnp.asarray(mid), jnp.asarray(p)),
          tm._grid_density(tt, torch.as_tensor(mid), torch.as_tensor(p)))


def tracking_inputs(seed):
    rs = np.random.RandomState(seed)
    jt, tt = tables(rs)
    o = (rs.rand(N, 3) * 4 - 2).astype(np.float32)
    d = unit(rs, N)
    t_max = (rs.rand(N) * 6).astype(np.float32)
    mid = np.ones(N, np.int32)
    key = (np.arange(N, dtype=np.uint64) * 0x9E3779B9 & 0xFFFFFFFF).astype(np.uint32)
    u_tab = rs.rand(N, 10).astype(np.float32)
    j = dict(mid=jnp.asarray(mid), o=jnp.asarray(o), dvec=jnp.asarray(d),
             t_max=jnp.asarray(t_max), key=jnp.asarray(key))
    t = dict(mid=torch.as_tensor(mid), o=torch.as_tensor(o),
             dvec=torch.as_tensor(d), t_max=torch.as_tensor(t_max), key=t64(key))
    return jt, tt, j, t, u_tab


@pytest.mark.parametrize("with_table", [False, True])
def test_grid_sample_delta_tracking(with_table):
    jt, tt, j, t, u_tab = tracking_inputs(5)
    ref = jm.grid_sample(jt, **j, u_tab=jnp.asarray(u_tab) if with_table else None)
    got = tm.grid_sample(tt, **t, u_tab=torch.as_tensor(u_tab) if with_table else None)
    rs_, gs_ = np.asarray(ref["sampled_medium"]), got["sampled_medium"].numpy()
    agree = rs_ == gs_
    assert agree.mean() >= 0.995
    assert 0.05 < rs_.mean() < 0.95  # both outcomes occur
    close(np.asarray(ref["t"])[agree], got["t"].numpy()[agree], rtol=1e-5, atol=1e-6)
    close(np.asarray(ref["weight"])[agree], got["weight"].numpy()[agree],
          rtol=1e-5, atol=1e-6)


def test_grid_tr_ratio_tracking():
    jt, tt, j, t, _ = tracking_inputs(6)
    ref = np.asarray(jm.grid_tr(jt, **j))
    got = tm.grid_tr(tt, **t).numpy()
    assert got.shape == ref.shape == (N, 3)
    within = np.all(np.abs(got - ref) <= 1e-5 * np.abs(ref) + 1e-6, -1)
    assert within.mean() >= 0.995
    assert (ref[:, 0] < 1.0).mean() > 0.1  # the grid attenuates many lanes
