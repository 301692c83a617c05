"""The shapes the port makes into triangle meshes on the host, against the
JAX package: loop subdivision (shapes/loopsubdiv.py, vectorised over the
vertices, against pbrt_tpu.shapes.loopsubdiv's per-vertex walk), NURBS
(shapes/nurbs.py against pbrt_tpu.shapes.nurbs) and the heightfield
(sceneio/api.py heightfield_mesh against the JAX package's reader), each
bit for bit: both compute in float64 and round to float32 at the end, with
the same operations in the same order.  The files that use them parse to
the same scene arrays (bridge.compare_setups at rtol 0) and render on the
CPU; the image against the JAX package's is slow (-m slow, ~100 s of XLA
compiling its render)."""
import numpy as np
import pytest

from pbrt_tpu import render as jrender
from pbrt_tpu import sceneio as jio
from pbrt_tpu.shapes import loopsubdiv as jloop
from pbrt_tpu.shapes import nurbs as jnurbs
from pbrt_tpu_torch import __main__ as cli
from pbrt_tpu_torch import bridge
from pbrt_tpu_torch import sceneio as tio
from pbrt_tpu_torch.shapes import loopsubdiv as tloop
from pbrt_tpu_torch.shapes import nurbs as tnurbs
from pbrt_tpu_torch.utils.imageio import read_pfm
from chip_smoke import icosphere
from test_torch_path import match_frac, mean_rel
import test_torch_threads  # noqa: F401  (torch's threads under xdist)

GRID = np.array([[0, 1, 4], [0, 4, 3], [1, 2, 5], [1, 5, 4], [3, 4, 7],
                 [3, 7, 6], [4, 5, 8], [4, 8, 7]])


def _meshes():
    """A closed icosphere split twice (320 faces, valences 5 and 6), the
    same with a seeded displacement, a 3x3 grid patch (boundary valences 2,
    3 and 4) and an icosahedron with a cap removed (a boundary of valence
    5 and more)."""
    f2, v2 = icosphere(2)
    rs = np.random.RandomState(3)
    f0, v0 = icosphere(0)
    keep = ~np.any(f0 == 0, axis=1)
    return {
        "closed": (f2, v2),
        "displaced": (f2, v2 * (1 + 0.1 * rs.rand(len(v2), 1))),
        "grid": (GRID, rs.rand(9, 3)),
        "open": (f0[keep], v0),
    }


MESHES = _meshes()


@pytest.mark.parametrize("name,levels", [
    ("closed", 0), ("closed", 2), ("displaced", 1), ("displaced", 2),
    ("grid", 1), ("grid", 3), ("open", 1), ("open", 2)])
def test_loop_subdivision_matches_jax(name, levels):
    """(indices, limit points, limit normals) bit for bit."""
    faces, p = MESHES[name]
    ref = jloop.loop_subdivide(faces, p, levels)
    got = tloop.loop_subdivide(faces, p, levels)
    for a, b, what in zip(ref, got, ("indices", "P", "N")):
        assert a.dtype == b.dtype and a.shape == b.shape, what
        np.testing.assert_array_equal(b, a, err_msg=what)


def test_loop_subdivision_refuses_nonmanifold_edges():
    faces = np.array([[0, 1, 2], [0, 1, 3], [0, 1, 4]])
    with pytest.raises(NotImplementedError, match="more than two faces"):
        tloop.loop_subdivide(faces, np.random.RandomState(0).rand(5, 3), 1)


def _clamped(n, order):
    inner = np.linspace(0, 1, n - order + 2)[1:-1]
    return np.concatenate([[0.0] * order, inner, [1.0] * order])


@pytest.mark.parametrize("rational", [False, True])
@pytest.mark.parametrize("orders", [(4, 4), (3, 2)])
def test_nurbs_matches_jax(orders, rational):
    """Cox-de Boor on a 30 x 30 grid, a 6 x 5 net: (indices, P, uv) bit for
    bit; rational nets with seeded weights."""
    rs = np.random.RandomState(5)
    nu, nv = 6, 5
    pw = np.concatenate([rs.rand(nv, nu, 3), np.ones((nv, nu, 1))], -1)
    if rational:
        w = rs.uniform(0.5, 2.0, (nv, nu, 1))
        pw = np.concatenate([pw[..., :3] * w, w], -1)
    args = (nu, nv, orders[0], orders[1], _clamped(nu, orders[0]),
            _clamped(nv, orders[1]), pw.astype(np.float32))
    for a, b in zip(jnurbs.tessellate_nurbs(*args), tnurbs.tessellate_nurbs(*args)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)


MESH_FILE = """LookAt 0 -5 3  0 0 0.5  0 0 1
Camera "perspective" "float fov" [45]
Sampler "halton" "integer pixelsamples" [2]
Film "image" "integer xresolution" [16] "integer yresolution" [16]
Integrator "path" "integer maxdepth" [2] "string lightsamplestrategy" "uniform"
WorldBegin
LightSource "point" "rgb I" [8 8 8] "point from" [1 -3 5]
AttributeBegin
  Material "matte" "rgb Kd" [0.5 0.6 0.4]
  Translate -4 -3 -0.5
  Scale 8 7 1
  Shape "heightfield" "integer nu" [5] "integer nv" [4]
    "float Pz" [0 0.1 0.2 0.1 0 0.3 0.5 0.2 0.1 0.2 0.4 0.1 0 0.3 0.1 0 0.2 0.3 0.1 0]
AttributeEnd
AttributeBegin
  Material "plastic" "rgb Kd" [0.6 0.3 0.2]
  Translate 0.8 0 0.6
  Shape "loopsubdiv" "integer levels" [2] "integer indices" [{li}] "point P" [{lp}]
AttributeEnd
AttributeBegin
  Material "matte" "rgb Kd" [0.3 0.4 0.7]
  Translate -2 1 0
  Scale 1.5 1 1.5
  Shape "nurbs" "integer nu" [4] "integer nv" [4] "integer uorder" [3]
    "integer vorder" [3] "float uknots" [0 0 0 0.5 1 1 1]
    "float vknots" [0 0 0 0.5 1 1 1] "point P" [{np}]
AttributeEnd
WorldEnd
"""


def _mesh_file(tmp_path):
    f, v = icosphere(1)
    rs = np.random.RandomState(7)
    u, w = np.meshgrid(np.linspace(0, 1, 4), np.linspace(0, 1, 4))
    net = np.stack([u, 0.3 * rs.rand(4, 4), w], -1)
    path = tmp_path / "meshes.pbrt"
    path.write_text(MESH_FILE.format(
        li=" ".join(map(str, f.ravel())),
        lp=" ".join(f"{x:.6f}" for x in (0.6 * v).ravel()),
        np=" ".join(f"{x:.6f}" for x in net.ravel())))
    return str(path)


def test_mesh_file_parses_as_in_jax(tmp_path):
    """A heightfield, a loopsubdiv body and a NURBS patch through the two
    readers: every scene array bit for bit."""
    path = _mesh_file(tmp_path)
    assert bridge.compare_setups(jio.parse_pbrt_file(path), tio.parse_pbrt_file(path),
                                 rtol=0.0) == []
    fields = tio.parse_pbrt_file(path).scene_builder.build_numpy()
    assert fields["tri_indices"].shape[0] == 2 * 4 * 3 + 80 * 16 + 2 * 29 * 29


def test_mesh_file_renders(tmp_path):
    path = _mesh_file(tmp_path)
    out = str(tmp_path / "t.pfm")
    assert cli.main([path, "--device", "cpu", "-o", out, "--quiet"]) == 0
    img = read_pfm(out)
    assert img.shape == (16, 16, 3) and np.isfinite(img).all() and img.mean() > 0


@pytest.mark.slow
def test_mesh_file_render_matches_jax(tmp_path):
    """The file's render (16x16 @ 2 spp, depth 2) against the JAX
    package's at tests/test_torch_path.py:58-59's bars."""
    path = _mesh_file(tmp_path)
    ref, _ = jrender.render_file(path, out=str(tmp_path / "j.pfm"), res=(16, 16))
    out = str(tmp_path / "t.pfm")
    assert cli.main([path, "--device", "cpu", "-o", out, "--quiet"]) == 0
    got, ref = read_pfm(out), np.asarray(ref)
    assert match_frac(ref, got) >= 0.995 and mean_rel(ref, got) <= 5e-3
