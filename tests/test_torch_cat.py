"""The port's --cat/--toply scene reformatter (pbrt_tpu_torch/sceneio/cat.py)
against the JAX package's (pbrt_tpu/sceneio/cat.py), byte for byte: the
text on tests/test_cat.py's scene, on every parity-ladder file the repo
holds whole (killeroo_64_4spp Includes files from outside it), on a list
of an int and a float, on ActiveTransform, and on a file that Includes
another with every other directive; --toply's text and its .ply sidecars;
and the port's --toply output parsed back through the port's own front end
to the same triangles (tests/test_cat.py:58-70's check)."""
import io
import pathlib

import numpy as np
import pytest
import torch

from pbrt_tpu.sceneio import cat as jcat
from pbrt_tpu_torch.sceneio import cat as tcat
from pbrt_tpu_torch.sceneio import parse_pbrt_string
from test_cat import SCENE
import test_torch_threads  # noqa: F401  (torch's threads under xdist)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PARITY = sorted(p for p in (ROOT / "refgold" / "parity").glob("*.pbrt")
                if p.name != "killeroo_64_4spp.pbrt")

# one list of an int and a float: the JAX parser types each token on its
# own, so 1000000 prints as an int there (and 1e+06 if the list were read
# as floats)
MIXED = """Film "image" "integer xresolution" [1000000] "float cropwindow" [1000000 0.5 0 1]
Shape "trianglemesh" "point P" [1000000 0.5 0  0 1 0  1 0 0] "integer indices" [0 1 2]
Shape "sphere" "float radius" 2
"""

ACTIVE = """ActiveTransform StartTime
Translate 1 2 3
ActiveTransform EndTime
Rotate 90 0 0 1
ActiveTransform All
Scale 1.5 1.5 1.5
"""

# every directive CatAPI prints, through an Include.  Transform and
# ConcatTransform go without brackets: both parsers read a statement's
# numbers and leave its "]" behind (parser.py's numeric statements)
PART = """TransformBegin
  Transform 1 0 0 0  0 1 0 0  0 0 1 0  0.25 0 0 1
  ConcatTransform 2 0 0 0  0 2 0 0  0 0 2 0  0 0 0 1
  CoordinateSystem "mine"
TransformEnd
CoordSysTransform "mine"
TransformTimes 0 1
Identity
ReverseOrientation
Texture "checks" "spectrum" "checkerboard" "float uscale" [8] "rgb tex1" [0.1 0.2 0.3]
Texture "plain" "float" "constant"
MakeNamedMaterial "red" "string type" "matte" "texture Kd" "checks"
NamedMaterial "red"
MakeNamedMedium "fog" "string type" "homogeneous" "rgb sigma_a" [0.1 0.1 0.1]
MediumInterface "fog" ""
MediumInterface "fog"
ObjectBegin "thing"
  Shape "disk" "float radius" [0.5] "bool alpha" "false"
ObjectEnd
ObjectInstance "thing"
"""

INCLUDE = """Accelerator "kdtree" "integer maxprims" [4]
PixelFilter "gaussian" "float xwidth" [2]
Filter "box"
Sampler "halton" "integer pixelsamples" [16]
Camera "perspective" "float fov" [45] "float lensradius" [0.0]
LookAt 0 0 5  0 0 0  0 1 0
WorldBegin
LightSource "point" "rgb I" [10 10 10] "point from" [0 4 0]
Include "part.pbrt"
AttributeBegin
  Material "plastic" "spectrum Kd" [400 0.5 700 0.25]
  Shape "trianglemesh" "point P" [0 0 0  1 0 0  1 1 0  0 1 0]
    "integer indices" [0 1 2  0 2 3] "normal N" [0 0 1 0 0 1 0 0 1 0 0 1]
    "float uv" [0 0 1 0 1 1 0 1] "vector S" [1 0 0 1 0 0 1 0 0 1 0 0]
    "integer faceIndices" [0 1] "float alpha" [1]
AttributeEnd
WorldEnd
"""

INPUTS = {"test_cat_scene": SCENE, "mixed": MIXED, "active_transform": ACTIVE,
          "include": INCLUDE, **{p.stem: p for p in PARITY}}


def scene_file(tmp_path, name):
    src = INPUTS[name]
    if isinstance(src, pathlib.Path):
        return str(src)
    (tmp_path / "part.pbrt").write_text(PART)
    path = tmp_path / f"{name}.pbrt"
    path.write_text(src)
    return str(path)


def cat(module, path, to_ply=False):
    out = io.StringIO()
    module.cat_file(path, out=out, to_ply=to_ply)
    return out.getvalue()


@pytest.mark.parametrize("name", list(INPUTS))
def test_cat_matches_jax(tmp_path, name):
    path = scene_file(tmp_path, name)
    ours = cat(tcat, path)
    assert ours == cat(jcat, path)
    assert "#" not in ours and ours.endswith("\n")
    if name == "mixed":
        assert '"float cropwindow" [ 1000000 0.5 0 1 ]' in ours


@pytest.mark.parametrize("name", ["test_cat_scene", "mixed", "include"])
def test_toply_matches_jax(tmp_path, monkeypatch, name):
    """--toply's text and every sidecar, each written to the working
    directory, byte for byte; S and faceIndices dropped."""
    path = scene_file(tmp_path, name)
    texts, plys = [], []
    for module, where in ((jcat, "jax"), (tcat, "port")):
        (tmp_path / where).mkdir()
        monkeypatch.chdir(tmp_path / where)
        texts.append(cat(module, path, to_ply=True))
        plys.append({p.name: p.read_bytes()
                     for p in sorted((tmp_path / where).glob("*.ply"))})
    assert texts[0] == texts[1] and plys[0] == plys[1]
    assert list(plys[1]) == ["mesh_00001.ply"]
    assert "plymesh" in texts[1] and "trianglemesh" not in texts[1]
    assert "faceIndices" not in texts[1] and '"vector S"' not in texts[1]


def test_toply_parses_back_to_the_same_triangles(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    formatted = cat(tcat, scene_file(tmp_path, "test_cat_scene"), to_ply=True)
    s1 = parse_pbrt_string(SCENE).build_scene(device="cpu")
    s2 = parse_pbrt_string(formatted, cwd=str(tmp_path)).build_scene(device="cpu")
    assert s1.tri_indices.shape == s2.tri_indices.shape
    np.testing.assert_allclose(np.sort(s1.tri_p.numpy(), 0),
                               np.sort(s2.tri_p.numpy(), 0), rtol=1e-5)
    assert torch.equal(s1.prim_meta[:, 0], s2.prim_meta[:, 0])


def test_cat_writes_to_stdout(tmp_path, capsys):
    path = scene_file(tmp_path, "test_cat_scene")
    tcat.cat_file(path)
    assert capsys.readouterr().out == cat(jcat, path)
    assert not any(p.suffix == ".ply" for p in tmp_path.iterdir())
