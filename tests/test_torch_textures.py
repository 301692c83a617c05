"""The port's texture table (pbrt_tpu_torch.textures), uv differentials and
camera ray differentials held against the JAX package on shared inputs.

Bars: the host pyramid and table are numpy in both packages and must be
bit-equal.  Lookups and the texture DAG: rtol 1e-5, atol 1e-6 on at least
99.9% of lanes and rtol 1e-3 on all (tests/test_torch_shading.py's bar:
XLA:CPU's log2, sin and exp differ from torch's in the last bit, and a
mip level or texel index that rounds the other way moves a lookup by a
texel's interpolation weight, which stays continuous).  Differentials:
rtol 1e-5, atol 1e-6; camera rays at the camera tests' rtol = atol =
1e-6."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.accel import traverse as jtv
from pbrt_tpu.cameras import cameras as jcam
from pbrt_tpu.core import transform as jtf
from pbrt_tpu.textures import textures as jtx
from pbrt_tpu_torch import bridge
from pbrt_tpu_torch.accel import traverse as ttv
from pbrt_tpu_torch.cameras import cameras as tcam
from pbrt_tpu_torch.core import transform as ttf
from pbrt_tpu_torch.textures import textures as ttx
from test_torch_shading import assert_lanes_close
from jax_traversal_jit import jit_jax_traversal  # noqa: F401  (autouse)
import test_torch_threads  # noqa: F401  (torch's threads under xdist)

N = 3000


def _image(seed, h=13, w=21):
    return np.random.RandomState(seed).rand(h, w, 3).astype(np.float32)


def test_build_pyramid_non_power_of_two_bit_equal():
    img = _image(0, 13, 21)
    ref = jtx.build_pyramid(img)
    got = ttx.build_pyramid(img)
    assert len(got) == len(ref) == 6 and got[0].shape == (16, 32, 3)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)


def _tables(adds):
    """The same rows added to both packages' host tables: (JAX table, the
    port's table from the JAX one's numpy fields, the port's own numpy)."""
    jh, th = jtx.HostTextureTable(), ttx.HostTextureTable()
    for kind, kw in adds:
        assert jh.add(kind, **kw) == th.add(kind, **kw)
    jt = jh.freeze()
    fields = bridge.as_numpy_fields(jt)
    return jt, ttx.TextureTable.from_numpy(fields, "cpu"), fields, th.to_numpy()


def _lookup_inputs(seed):
    rs = np.random.RandomState(seed)
    uv = (rs.rand(N, 2) * 2.0 - 0.5).astype(np.float32)
    # footprints from sub-texel to a quarter of the image, some stretched
    d0 = (rs.randn(N, 2) * np.exp(rs.uniform(-7, -1, (N, 1)))).astype(np.float32)
    d1 = (rs.randn(N, 2) * np.exp(rs.uniform(-7, -1, (N, 1)))).astype(np.float32)
    return uv, d0, d1


@pytest.mark.parametrize("wrap", [ttx.WRAP_REPEAT, ttx.WRAP_BLACK,
                                  ttx.WRAP_CLAMP], ids=["repeat", "black", "clamp"])
def test_bilinear_trilinear_ewa_lookups_match(wrap):
    jt, tt, fields, host = _tables([(jtx.TEX_IMAGEMAP, dict(image=_image(1)))])
    for k in ttx.TEXTURE_FIELDS:
        np.testing.assert_array_equal(np.asarray(fields[k]), host[k], err_msg=k)
    nl = int(fields["n_levels"][0])
    uv, d0, d1 = _lookup_inputs(2 + wrap)
    juv, tuv = jnp.asarray(uv), torch.as_tensor(uv)
    ref = jtx._bilinear_lookup(jt, 0, juv, wrap)
    got = ttx._bilinear_at(tt, tt.img_offset[0], tt.img_w[0], tt.img_h[0], tuv,
                           wrap)
    assert_lanes_close(ref, got, "bilinear")
    width = np.abs(d0).max(-1) * 2.0
    ref = jtx._trilinear_lookup(jt, 0, juv, jnp.asarray(width), nl, wrap)
    got = ttx._trilinear_lookup(tt, 0, tuv, torch.as_tensor(width), nl, wrap)
    assert_lanes_close(ref, got, "trilinear")
    ref = jtx._aniso_lookup(jt, 0, juv, jnp.asarray(d0), jnp.asarray(d1), nl,
                            wrap, 8.0)
    got = ttx._aniso_lookup(tt, 0, tuv, torch.as_tensor(d0), torch.as_tensor(d1),
                            nl, wrap, 8.0)
    assert_lanes_close(ref, got, "ewa")
    if wrap == ttx.WRAP_BLACK:
        assert (got == 0).all(-1).any()  # lookups outside the image are black


def _dag():
    """Every texture type, with children before parents; texture space a
    power-of-two scale so both packages' 3D mappings round alike."""
    w2t = np.diag([2.0, 0.5, 1.0, 1.0]).astype(np.float32)
    return [
        (jtx.TEX_CONSTANT, dict(c1=(0.3, 0.5, 0.7))),  # 0
        (jtx.TEX_UV, dict(map2d=(2.0, 3.0, 0.25, 0.5))),  # 1
        (jtx.TEX_SCALE, dict(child1=0, child2=1)),  # 2
        (jtx.TEX_MIX, dict(child1=2, c2=(0.9, 0.1, 0.4), fparams=(0.3, 0, 0, 0))),
        (jtx.TEX_CHECKER, dict(c1=(1, 1, 1), child2=3, map2d=(8, 8, 0, 0))),
        (jtx.TEX_FBM, dict(fparams=(5, 0.6, 0, 0), w2t=w2t)),  # 5
        (jtx.TEX_WRINKLED, dict(fparams=(4, 0.5, 0, 0), w2t=w2t)),
        (jtx.TEX_WINDY, dict(w2t=w2t)),
        (jtx.TEX_MARBLE, dict(fparams=(6, 0.5, 2.0, 0.3), w2t=w2t)),
        (jtx.TEX_DOTS, dict(child1=4, c2=(0.1, 0.2, 0.3), map2d=(6, 6, 0, 0))),
        (jtx.TEX_IMAGEMAP, dict(image=_image(3), c1=(2, 2, 2),
                                fparams=(1.0, 8.0, 0.0, 0.0))),  # 10: trilinear
        (jtx.TEX_IMAGEMAP, dict(image=_image(4, 9, 9), map2d=(3, 2, 0, 0),
                                fparams=(0.0, 4.0, 2.0, 0.0))),  # 11: EWA
        (jtx.TEX_BILERP, dict(c1=(0.1, 0.2, 0.3), c2=(0.9, 0.8, 0.7),
                              map2d=(2, 2, 0.1, 0))),
    ]


@pytest.mark.parametrize("diffs", [False, True], ids=["level0", "differentials"])
def test_evaluate_textures_dag_matches(diffs):
    jt, tt, fields, _ = _tables(_dag())
    rs = np.random.RandomState(5)
    uv = (rs.rand(N, 2) * 1.2 - 0.1).astype(np.float32)
    p = (rs.randn(N, 3) * 3.0).astype(np.float32)
    _, d0, d1 = _lookup_inputs(6)
    kw_j = dict(duvdx=jnp.asarray(d0), duvdy=jnp.asarray(d1)) if diffs else {}
    kw_t = dict(duvdx=torch.as_tensor(d0), duvdy=torch.as_tensor(d1)) if diffs else {}
    ref = jtx.evaluate_textures(jt, jnp.asarray(uv), jnp.asarray(p), **kw_j)
    got = ttx.evaluate_textures(tt, torch.as_tensor(uv), torch.as_tensor(p),
                                ttx.texture_meta(fields), **kw_t)
    assert got.shape == (13, N, 3)
    for t in range(13):
        assert_lanes_close(np.asarray(ref[t]), got[t], f"texture row {t}")
    # only the rows asked for (and their children) are evaluated
    part = ttx.evaluate_textures(tt, torch.as_tensor(uv), torch.as_tensor(p),
                                 ttx.texture_meta(fields), active_ids=(3,))
    assert torch.equal(part[3], got[3]) and (part[4] == 0).all()
    ids = rs.randint(-1, 13, N).astype(np.int32)
    const = rs.rand(N, 3).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(jtx.gather_texture(ref, jnp.asarray(ids), jnp.asarray(const))),
        ttx.gather_texture(torch.as_tensor(np.array(ref)), torch.as_tensor(ids),
                           torch.as_tensor(const)).numpy())


def test_uv_differentials_match():
    rs = np.random.RandomState(7)
    n = N
    ng = rs.randn(n, 3).astype(np.float32)
    ng /= np.linalg.norm(ng, axis=-1, keepdims=True)
    rec = {"p": rs.randn(n, 3).astype(np.float32), "ng": ng,
           "dpdu": rs.randn(n, 3).astype(np.float32),
           "dpdv": rs.randn(n, 3).astype(np.float32),
           "hit": rs.rand(n) < 0.9}
    rec["dpdv"][:5] = rec["dpdu"][:5]  # degenerate frames give zero
    rays = [rs.randn(n, 3).astype(np.float32) for _ in range(4)]
    ref = jtv.uv_differentials({k: jnp.asarray(v) for k, v in rec.items()},
                               *map(jnp.asarray, rays))
    got = ttv.uv_differentials({k: torch.as_tensor(v) for k, v in rec.items()},
                               *map(torch.as_tensor, rays))
    for a, b in zip(ref, got):
        assert_lanes_close(a, b, "duv")
        assert (b[:5] == 0).all() and (b[~torch.as_tensor(rec["hit"])] == 0).all()


@pytest.mark.parametrize("lens", [0.0, 0.2])
def test_generate_ray_differentials_match(lens):
    res = (16, 12)
    kw = dict(fov_deg=50.0, lens_radius=lens, focal_distance=5.0)
    jc = jcam.make_perspective_camera(
        jtf.look_at([0, -8, 4], [0, 0, 2], [0, 0, 1]), res, **kw)
    tc = tcam.make_perspective_camera(
        ttf.look_at([0, -8, 4], [0, 0, 2], [0, 0, 1]), res, **kw)
    rs = np.random.RandomState(8)
    p_film = (rs.rand(500, 2) * np.array(res)).astype(np.float32)
    p_lens = rs.rand(500, 2).astype(np.float32)
    time_u = rs.rand(500).astype(np.float32)
    ref = jcam.generate_ray_differentials(jc, jnp.asarray(p_film),
                                          jnp.asarray(p_lens),
                                          jnp.asarray(time_u), spp=4)
    got = tcam.generate_ray_differentials(tc, torch.as_tensor(p_film),
                                          torch.as_tensor(p_lens),
                                          torch.as_tensor(time_u), spp=4)
    assert len(got) == 8
    for a, b in zip(ref, got):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-6, atol=1e-6)
