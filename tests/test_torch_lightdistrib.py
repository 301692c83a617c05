"""The spatial light distribution (pbrt_tpu_torch.lights.lightdistrib)
against the JAX package's (pbrt_tpu.lights.lightdistrib), and a render that
picks its lights from it against the JAX package's render.

Tolerances: the grid (resolution, origin, extent) is equal.  The per-voxel
estimates go through sample_li, whose sqrt/sin/cos round differently in
XLA:CPU and torch in the last bit (tests/test_torch_shading.py), so the CDF
and pmf rows, values in [0, 1], are held to 1e-5 absolute, and the pick to
>= 99.9% of lanes."""
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu import render as jrender
from pbrt_tpu import sceneio as jio
from pbrt_tpu.integrators.path import scene_statics
from pbrt_tpu.lights import lightdistrib as jld
from pbrt_tpu_torch import render as trender
from pbrt_tpu_torch import sceneio as tio
from pbrt_tpu_torch.lights import lightdistrib as tld
from jax_traversal_jit import jit_jax_traversal  # noqa: F401  (autouse)
import test_torch_threads  # noqa: F401  (torch's threads under xdist)

PARITY = pathlib.Path(__file__).resolve().parent.parent / "refgold" / "parity"


def both(name):
    path = str(PARITY / f"{name}.pbrt")
    js = jio.parse_pbrt_file(path).build_scene()
    ts = tio.parse_pbrt_file(path).build_scene("cpu")
    return js, ts


SPATIAL = ("spatial_grid_res", "spatial_b0", "spatial_diag", "spatial_cdf",
           "spatial_pmf")


@pytest.fixture(scope="module")
def c2_setups():
    """c2_twolights_d2 parsed by both packages, each scene built once (the
    setups keep it) and its spatial distribution built once through the
    package's own per-scene cache, which the render below hits again."""
    path = str(PARITY / "c2_twolights_d2.pbrt")
    jsetup, tsetup = jio.parse_pbrt_file(path), tio.parse_pbrt_file(path)
    js, ts = jsetup.build_scene(), tsetup.build_scene("cpu")
    js = jld.ensure_spatial_light_distribution(js, scene_statics(js).light_types)
    ts = tld.ensure_spatial_light_distribution(ts)
    return jsetup, tsetup, js, ts


def _distributions(name, c2_setups):
    """(the JAX package's, the port's) (grid_res, b0, diag, cdf, pmf)."""
    if name == "c2_twolights_d2":
        _, _, js, ts = c2_setups
        return ([np.asarray(getattr(js, k)) for k in SPATIAL],
                [getattr(ts, k).numpy() for k in SPATIAL])
    js, ts = both(name)
    return (jld.build_spatial_distribution(js, scene_statics(js).light_types),
            tld.build_spatial_distribution(ts))


@pytest.mark.parametrize("name", ["b_arealight", "c2_twolights_d2"])
def test_distribution_matches_jax(name, c2_setups):
    ref, got = _distributions(name, c2_setups)
    for a, b in zip(ref[:3], got[:3]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ref[3:], got[3:]):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)

    rs = np.random.RandomState(7)
    n = 20000
    p = (ref[1] + rs.rand(n, 3) * ref[2]).astype(np.float32)
    u = rs.rand(n).astype(np.float32)
    j_idx, j_pmf = jld.spatial_pick_light(*(jnp.asarray(x) for x in ref),
                                          jnp.asarray(p), jnp.asarray(u))
    g = [torch.as_tensor(x) for x in got]
    t_idx, t_pmf = tld.spatial_pick_light(g[0].long(), *g[1:], torch.as_tensor(p),
                                          torch.as_tensor(u))
    same = np.asarray(j_idx) == t_idx.numpy()
    assert same.mean() >= 0.999
    np.testing.assert_allclose(t_pmf.numpy()[same], np.asarray(j_pmf)[same],
                               rtol=1e-4)
    if name == "c2_twolights_d2":
        assert 0.05 < t_idx.float().mean() < 0.95  # both lights get picked


def test_built_once_per_scene():
    _, ts = both("a_floor_point")
    a = tld.ensure_spatial_light_distribution(ts)
    assert a is not ts and a.spatial_cdf is not None
    assert tld.ensure_spatial_light_distribution(ts) is a
    assert tld.ensure_spatial_light_distribution(a) is a


def test_spatial_render_matches_jax(c2_setups):
    """c2_twolights_d2 (a point light and an area light, the default
    "spatial" strategy) at 32x32, 2 spp, depth 2, rendered by both packages,
    at test_parity_images.py's bars for that scene; each render takes the
    distribution c2_setups built."""
    jsetup, tsetup = c2_setups[:2]
    kw = dict(spp_override=2, res_override=(32, 32))
    ref, _ = jrender.render_setup(jsetup, **kw)
    got, stats = trender.render_setup(tsetup, device="cpu", **kw)
    ref = np.asarray(ref)
    assert got.shape == ref.shape == (32, 32, 3)
    rel = np.abs(ref - got) / np.maximum(np.abs(ref), 1e-2)
    assert np.all(rel <= 1e-3, -1).mean() >= 0.995
    assert abs(got.mean() - ref.mean()) / ref.mean() <= 1e-3
    assert stats["phases"]["Light distribution"] > 0.0
