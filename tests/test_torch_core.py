"""Port core math against the JAX package: vecmath, transforms, warps,
Distribution1D, PCG32, Halton permutations, Sobol and Halton sample bits."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu.core import lowdiscrepancy as jld
from pbrt_tpu.core import rng as jrng
from pbrt_tpu.core import sampling as jsmp
from pbrt_tpu.core import transform as jtf
from pbrt_tpu.core import vecmath as jvm
from pbrt_tpu_torch.core import lowdiscrepancy as tld
from pbrt_tpu_torch.core import rng as trng
from pbrt_tpu_torch.core import sampling as tsmp
from pbrt_tpu_torch.core import transform as ttf
from pbrt_tpu_torch.core import vecmath as tvm

RTOL = 1e-6


def _vecs(n, seed):
    rs = np.random.RandomState(seed)
    return rs.randn(n, 3).astype(np.float32)


def _close(a, b, rtol=RTOL, atol=1e-7):
    np.testing.assert_allclose(np.asarray(a), b.numpy() if hasattr(b, "numpy") else b,
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("fn", ["dot", "cross", "normalize", "length",
                                "coordinate_system", "reflect"])
def test_vecmath_matches(fn):
    a, b = _vecs(257, 0), _vecs(257, 1)
    ja, jb, ta, tb = jnp.asarray(a), jnp.asarray(b), torch.as_tensor(a), torch.as_tensor(b)
    if fn == "coordinate_system":
        jn = jvm.normalize(ja)
        for x, y in zip(jvm.coordinate_system(jn), tvm.coordinate_system(tvm.normalize(ta))):
            _close(x, y)
    elif fn in ("normalize", "length"):
        _close(getattr(jvm, fn)(ja), getattr(tvm, fn)(ta))
    else:
        _close(getattr(jvm, fn)(ja, jb), getattr(tvm, fn)(ta, tb))


def test_offset_ray_origin_and_xforms():
    p, e, n, w = (_vecs(300, s) for s in range(4))
    e = np.abs(e) * 1e-4
    ref = jvm.offset_ray_origin(*(jnp.asarray(x) for x in (p, e, n, w)))
    got = tvm.offset_ray_origin(*(torch.as_tensor(x) for x in (p, e, n, w)))
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())
    m = (jtf.translate(1, 2, 3) @ jtf.rotate(30, 1, 1, 0)).m
    _close(jvm.xform_point(jnp.asarray(m), jnp.asarray(p)),
           tvm.xform_point(torch.as_tensor(m), torch.as_tensor(p)))
    _close(jvm.xform_vector(jnp.asarray(m), jnp.asarray(p)),
           tvm.xform_vector(torch.as_tensor(m), torch.as_tensor(p)))


@pytest.mark.parametrize("make", [
    lambda tf: tf.look_at([0, -8, 4], [0, 0, 2], [0, 0, 1]),
    lambda tf: tf.perspective(45.0, 1e-2, 1000.0),
    lambda tf: tf.rotate(33.0, 0.2, 1.0, -0.4) @ tf.scale(2, 3, 4),
    lambda tf: tf.translate(1, -2, 5).inverse,
])
def test_transform_matches(make):
    a, b = make(jtf), make(ttf)
    _close(a.m, b.m)
    _close(a.m_inv, b.m_inv)
    pts = _vecs(50, 3)
    _close(a.apply_point(pts), b.apply_point(pts), rtol=1e-6, atol=1e-6)
    assert a.swaps_handedness() == b.swaps_handedness()


@pytest.mark.parametrize("warp", ["concentric_sample_disk",
                                  "cosine_sample_hemisphere",
                                  "uniform_sample_sphere",
                                  "uniform_sample_triangle"])
def test_warps_match(warp):
    u = np.random.RandomState(4).rand(1000, 2).astype(np.float32)
    u[:3] = [[0.5, 0.5], [0.0, 0.0], [0.999, 0.25]]
    # atol: the warps' values are O(1), and sqrt(1 - x^2 - y^2) near the
    # horizon turns one-ulp differences of the two libraries' cos/sin into
    # relative errors above 1e-6.
    _close(getattr(jsmp, warp)(jnp.asarray(u)), getattr(tsmp, warp)(torch.as_tensor(u)),
           atol=1e-6)


def test_power_heuristic_and_cone_pdf():
    rs = np.random.RandomState(5)
    f = rs.rand(500).astype(np.float32) * 10
    g = rs.rand(500).astype(np.float32) * 10
    f[:4] = [np.inf, 0.0, 1.0, np.inf]
    g[:4] = [1.0, 0.0, np.inf, np.inf]
    _close(jsmp.power_heuristic(1.0, jnp.asarray(f), 1.0, jnp.asarray(g)),
           tsmp.power_heuristic(1.0, torch.as_tensor(f), 1.0, torch.as_tensor(g)))
    c = rs.rand(100).astype(np.float32) * 0.99
    _close(jsmp.uniform_cone_pdf(jnp.asarray(c)), tsmp.uniform_cone_pdf(torch.as_tensor(c)))


@pytest.mark.parametrize("weights", [[1.0, 1.0, 1.0], [0.1, 5.0, 0.0, 2.5],
                                     [0.0, 0.0]])
def test_distribution1d_matches(weights):
    jd = jsmp.build_distribution_1d(np.asarray(weights))
    td = tsmp.distribution_from_numpy(tsmp.build_distribution_1d_np(weights), "cpu")
    _close(jd.cdf, td.cdf)
    _close(jd.func_int, td.func_int)
    u = np.random.RandomState(6).rand(400).astype(np.float32)
    j_off, j_pmf, _ = jsmp.sample_discrete_1d(jd, jnp.asarray(u))
    t_off, t_pmf = tsmp.sample_discrete_1d(td, torch.as_tensor(u))
    np.testing.assert_array_equal(np.asarray(j_off), t_off.numpy())
    _close(j_pmf, t_pmf)


@pytest.mark.parametrize("seq", [None, 0, 7, 123456789])
def test_pcg32_stream_equal(seq):
    a, b = jrng.ScalarPcg32(seq), trng.ScalarPcg32(seq)
    assert [a.uniform_uint32() for _ in range(200)] == \
        [b.uniform_uint32() for _ in range(200)]
    assert [a.uniform_uint32_bounded(97) for _ in range(50)] == \
        [b.uniform_uint32_bounded(97) for _ in range(50)]


def test_halton_permutation_prefix(tmp_path, monkeypatch):
    monkeypatch.setattr(tld, "_BUILD", tmp_path)
    tld.radical_inverse_permutations.cache_clear()
    try:
        k = 64
        got = tld.radical_inverse_permutations(k)
        ref = jld.radical_inverse_permutations()[: int(jld.PRIMES[:k].sum())]
        np.testing.assert_array_equal(got, ref)
        assert (tmp_path / f"halton_perms_{k}.npy").exists()
        np.testing.assert_array_equal(tld.radical_inverse_permutations(3),
                                      ref[: 2 + 3 + 5])
    finally:
        tld.radical_inverse_permutations.cache_clear()


def _bits(x):
    return np.asarray(x).view(np.uint32)


@pytest.mark.parametrize("dim", [0, 1, 2, 5, 11, 17, 40, 63, 97])
def test_halton_radical_inverse_bits_equal(dim):
    a = np.random.RandomState(dim).randint(0, 2**32 - 1, 3000, dtype=np.uint64)
    a[:4] = [0, 1, 2**32 - 1, 12345]
    ja = jnp.asarray(a.astype(np.uint32))
    ta = torch.as_tensor(a.astype(np.int64))
    if dim < 2:
        ref, got = jld.radical_inverse(dim, ja), tld.radical_inverse(dim, ta)
    else:
        off = int(jld.PRIME_SUMS[dim])
        perm = jld.radical_inverse_permutations()[off: off + int(jld.PRIMES[dim])]
        ref = jld.scrambled_radical_inverse_fast(dim, ja)
        got = tld.scrambled_radical_inverse(dim, ta, torch.as_tensor(perm.astype(np.int64)))
        np.testing.assert_array_equal(
            _bits(ref), _bits(tld.scrambled_radical_inverse_fast(dim, ta).numpy()))
    np.testing.assert_array_equal(_bits(ref), _bits(got.numpy()))


@pytest.mark.parametrize("dim", [0, 1, 3, 30, 200])
def test_sobol_bits_equal(dim):
    rs = np.random.RandomState(dim + 1)
    hi = rs.randint(0, 2**20, 2000).astype(np.uint32)
    lo = rs.randint(0, 2**32 - 1, 2000, dtype=np.uint64).astype(np.uint32)
    ref = jld.sobol_sample_bits64(jnp.asarray(hi), jnp.asarray(lo), dim)
    got = tld.sobol_sample_bits64(torch.as_tensor(hi.astype(np.int64)),
                                  torch.as_tensor(lo.astype(np.int64)), dim)
    np.testing.assert_array_equal(np.asarray(ref).astype(np.int64), got.numpy())


@pytest.mark.parametrize("m", [1, 4, 7, 9])
def test_sobol_interval_to_index_equal(m):
    rs = np.random.RandomState(m)
    frame = rs.randint(0, 64, 500).astype(np.uint32)
    px = rs.randint(0, 1 << m, 500).astype(np.uint32)
    py = rs.randint(0, 1 << m, 500).astype(np.uint32)
    jh, jl = jld.sobol_interval_to_index(m, *(jnp.asarray(x) for x in (frame, px, py)))
    th, tl = tld.sobol_interval_to_index(m, *(torch.as_tensor(x.astype(np.int64))
                                              for x in (frame, px, py)))
    np.testing.assert_array_equal(np.asarray(jh).astype(np.int64), th.numpy())
    np.testing.assert_array_equal(np.asarray(jl).astype(np.int64), tl.numpy())
