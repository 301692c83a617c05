"""The port's .pbrt front end (pbrt_tpu_torch.sceneio) against the JAX
package's (pbrt_tpu.sceneio): the same file gives the same camera, film,
sampler and integrator configs and the same scene arrays (bridge.
compare_setups: integer fields exactly, float fields to 1e-6 relative, the
tolerance of tests/test_torch_scene.py), and every directive the port does
not render is refused."""
import pathlib

import numpy as np
import pytest

from pbrt_tpu import sceneio as jio
from pbrt_tpu.sceneio import plyload as jply
from pbrt_tpu_torch import bridge
from pbrt_tpu_torch import sceneio as tio
from pbrt_tpu_torch.sceneio import plyload as tply
from test_sceneio import SIMPLE_SCENE
import test_torch_threads  # noqa: F401  (torch's threads under xdist)

PARITY = pathlib.Path(__file__).resolve().parent.parent / "refgold" / "parity"
LADDER = ["a_floor_point", "c3_plastic_d1", "b_arealight", "c2_twolights_d2",
          "c2u_uniform", "c4_mirror_d3", "c1_matte_point_d5", "c_indirect"]


def test_simple_scene_matches_jax():
    assert bridge.compare_setups(jio.parse_pbrt_string(SIMPLE_SCENE),
                                 tio.parse_pbrt_string(SIMPLE_SCENE)) == []
    setup = tio.parse_pbrt_string(SIMPLE_SCENE)
    assert setup.resolution == (32, 24) and setup.sampler_name == "sobol"
    assert setup.make_integrator_config().max_depth == 3
    assert setup.make_integrator_config().light_strategy == "spatial"


@pytest.mark.parametrize("name", LADDER)
def test_ladder_scene_matches_jax(name):
    path = str(PARITY / f"{name}.pbrt")
    assert bridge.compare_setups(jio.parse_pbrt_file(path),
                                 tio.parse_pbrt_file(path)) == []


def test_compare_setups_sees_a_difference():
    ref = jio.parse_pbrt_string(SIMPLE_SCENE)
    got = tio.parse_pbrt_string(SIMPLE_SCENE.replace("[.5 .4 .3]", "[.5 .4 .2]"))
    diff = bridge.compare_setups(ref, got)
    assert len(diff) == 1 and diff[0].startswith("scene.materials.kd")


def _write_ply(path, fmt, verts, faces, normals=None):
    """A PLY of `verts` (+ normals) and polygon `faces` in format fmt."""
    props = ["x", "y", "z"] + (["nx", "ny", "nz"] if normals is not None else [])
    head = [b"ply", f"format {fmt} 1.0".encode(),
            f"element vertex {len(verts)}".encode()]
    head += [f"property float {p}".encode() for p in props]
    head += [f"element face {len(faces)}".encode(),
             b"property list uchar int vertex_indices", b"end_header"]
    cols = verts if normals is None else np.concatenate([verts, normals], 1)
    with open(path, "wb") as f:
        f.write(b"\n".join(head) + b"\n")
        if fmt == "ascii":
            for row in cols:
                f.write((" ".join(f"{x:.9g}" for x in row) + "\n").encode())
            for face in faces:
                f.write((f"{len(face)} " + " ".join(map(str, face)) + "\n").encode())
        else:
            bo = "<" if fmt == "binary_little_endian" else ">"
            f.write(cols.astype(bo + "f4").tobytes())
            for face in faces:
                f.write(np.asarray([len(face)], "u1").tobytes())
                f.write(np.asarray(face, bo + "i4").tobytes())


def _mesh(rs, quads: bool):
    verts = rs.randn(12, 3).astype(np.float32)
    normals = rs.randn(12, 3).astype(np.float32)
    faces = [[i, i + 1, i + 2, i + 3] if quads else [i, i + 1, i + 2]
             for i in range(0, 8)]
    return verts, normals, faces


@pytest.mark.parametrize("fmt", ["ascii", "binary_little_endian",
                                 "binary_big_endian"])
@pytest.mark.parametrize("quads", [False, True], ids=["tris", "quads"])
def test_plyload_matches_jax(tmp_path, fmt, quads):
    verts, normals, faces = _mesh(np.random.RandomState(3), quads)
    path = str(tmp_path / "m.ply")
    _write_ply(path, fmt, verts, faces, normals)
    ref, got = jply.load_ply(path), tply.load_ply(path)
    for a, b in zip(ref, got):
        if a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(np.asarray(a), b)
    assert got[0].shape == (len(faces) * (2 if quads else 1), 3)


def test_include_and_plymesh_match_jax(tmp_path):
    """An Include relative to the including file, which holds a plymesh
    under a transform and a material.  The plymesh's file name resolves
    against the top-level scene's directory, as pbrt-v3's search directory
    does and as the JAX package does."""
    verts, _, faces = _mesh(np.random.RandomState(4), True)
    sub = tmp_path / "geometry"
    sub.mkdir()
    _write_ply(str(sub / "blob.ply"), "binary_little_endian", verts, faces)
    (sub / "blob.pbrt").write_text(
        'AttributeBegin\n  Translate 0 0 1\n  Rotate 30 0 1 0\n'
        '  Material "plastic" "rgb Kd" [.3 .2 .1] "float roughness" [.05]\n'
        '  Shape "plymesh" "string filename" "geometry/blob.ply"\n'
        'AttributeEnd\n')
    main = SIMPLE_SCENE.replace("WorldEnd", 'Include "geometry/blob.pbrt"\nWorldEnd')
    path = tmp_path / "scene.pbrt"
    path.write_text(main)
    ref, got = jio.parse_pbrt_file(str(path)), tio.parse_pbrt_file(str(path))
    assert bridge.compare_setups(ref, got) == []
    assert got.scene_builder._n_tris == 2 + 2 * len(faces)


@pytest.mark.parametrize("body,what", [
    ('Texture "t" "spectrum" "ptex"\n', "ptex"),
    ('Texture "t" "spectrum" "checkerboard" "integer dimension" [3]\n', "3D"),
    ('Texture "t" "spectrum" "checkerboard" "string mapping" "spherical"\n',
     "mapping"),
    ('Texture "t" "spectrum" "constant"\nMaterial "mirror" "texture Kr" "t"\n',
     "texture Kr"),
    ('Material "disney"\n', "disney"),
    ('LightSource "distant" "spectrum L" [400 1 700 1]\n', "spectrum L"),
    ('Material "matte" "spectrum Kd" [400 .5 700 .5]\n', "spectrum Kd"),
    ('ObjectBegin "o"\nObjectEnd\n', "instancing"),
    ('MakeNamedMedium "m" "string type" "cloud"\n', "cloud"),
    ('Shape "curve"\n', "curve"),
    ('LightSource "spot" "point from" [0 0 1]\n', "from"),
    ('Shape "cylinder"\n', "cylinder"),
    ('AreaLightSource "diffuse"\nShape "plymesh" "string filename" "x.ply"\n',
     "plymesh"),
    ('ActiveTransform StartTime\n', "animated"),
])
def test_world_refusals(body, what):
    with pytest.raises(NotImplementedError, match=what):
        tio.parse_pbrt_string(f"WorldBegin\n{body}WorldEnd\n")


def test_media_directives_parse():
    """MakeNamedMedium and MediumInterface (no longer refused): the shapes
    after the interface carry its media, an emissive shape none; a medium
    never made is an error."""
    got = tio.parse_pbrt_string(
        'WorldBegin\nMakeNamedMedium "fog" "string type" "homogeneous"\n'
        'MediumInterface "fog" ""\nShape "sphere"\n'
        'AttributeBegin\nAreaLightSource "diffuse"\nShape "sphere"\nAttributeEnd\n'
        'WorldEnd\n')
    fields = got.scene_builder.build_numpy()
    assert sorted(fields["prim_medium_inside"].tolist()) == [-1, 0]
    assert fields["prim_medium_outside"].tolist() == [-1, -1]
    assert int(fields["camera_medium"]) == -1
    with pytest.raises(ValueError, match="never made"):
        tio.parse_pbrt_string('WorldBegin\nMediumInterface "fog" ""\nWorldEnd\n')


@pytest.mark.parametrize("options,call,what", [
    ('Camera "orthographic"', "make_camera", "orthographic"),
    ('Sampler "stratified"', "make_sampler_config", "stratified"),
    ('PixelFilter "gaussian"', "make_film_config", "gaussian"),
    ('Integrator "path" "string lightsamplestrategy" "spatialx"',
     "make_integrator_config", "spatialx"),
])
def test_option_refusals(options, call, what):
    setup = tio.parse_pbrt_string(f"{options}\nWorldBegin\nWorldEnd\n")
    with pytest.raises(NotImplementedError, match=what):
        getattr(setup, call)()


def test_kdtree_and_exact_sampler_refused(monkeypatch):
    with pytest.raises(NotImplementedError, match="kdtree"):
        tio.parse_pbrt_string('Accelerator "kdtree"\nWorldBegin\nWorldEnd\n')
    setup = tio.parse_pbrt_string("WorldBegin\nWorldEnd\n")
    monkeypatch.setenv("PBRT_TPU_EXACT_SAMPLER", "1")
    with pytest.raises(NotImplementedError, match="EXACT_SAMPLER"):
        setup.make_sampler_config()


def test_missing_image_raises(tmp_path):
    """The JAX package puts a gray placeholder in for an image it cannot
    read (api.py:392-395); the port raises."""
    scene = tmp_path / "s.pbrt"
    scene.write_text('WorldBegin\nTexture "t" "spectrum" "imagemap" '
                     '"string filename" "missing.pfm"\nWorldEnd\n')
    with pytest.raises(FileNotFoundError):
        tio.parse_pbrt_file(str(scene))
