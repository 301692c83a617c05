"""The port's host tools (pbrt_tpu_torch/tools/: imgtool with the Hosek sky,
obj2pbrt, cyhair2pbrt) against the JAX package's (pbrt_tpu/tools/), on
tests/test_mlt_sppm_tools.py:71-140's inputs and a few wider ones: each
tool runs in a directory of its own on the same inputs, named alike, and
its printed lines, exit code and files must be the JAX tool's byte for
byte, but the makesky image, held at rtol 1e-6; the converters' .pbrt
files parse through the port's own front end."""
import shutil
import struct

import numpy as np
import pytest

from pbrt_tpu.tools import cyhair2pbrt as jhair
from pbrt_tpu.tools import imgtool as jimg
from pbrt_tpu.tools import obj2pbrt as jobj
from pbrt_tpu.utils import imageio as jio
from pbrt_tpu_torch.sceneio import parse_pbrt_string
from pbrt_tpu_torch.tools import cyhair2pbrt as thair
from pbrt_tpu_torch.tools import imgtool as timg
from pbrt_tpu_torch.tools import obj2pbrt as tobj
from pbrt_tpu_torch.utils import imageio as tio
import test_torch_threads  # noqa: F401  (torch's threads under xdist)


def write_images(where):
    """test_mlt_sppm_tools.py:71-83's a and a + 0.25, two crops of a, and a
    smaller image."""
    a = np.random.RandomState(0).rand(8, 8, 3).astype(np.float32)
    jio.write_image(str(where / "a.pfm"), a)
    jio.write_image(str(where / "b.pfm"), a + 0.25)
    left, right = a.copy(), a.copy()
    left[:, 4:] = 0.0
    right[:, :4] = 0.0
    right[0, 0] = 5.0  # a pixel both crops fill: the first file keeps it
    jio.write_image(str(where / "left.pfm"), left)
    jio.write_image(str(where / "right.pfm"), right)
    jio.write_image(str(where / "small.pfm"), a[:4])


def run_both(tmp_path, monkeypatch, capsys, inputs, call):
    """call(module side) in tmp_path/jax and tmp_path/port, each holding a
    copy of `inputs`: [(exit code, stdout, {file: bytes}) for each]."""
    out = []
    for side in ("jax", "port"):
        where = tmp_path / side
        shutil.copytree(inputs, where)
        before = set(p.name for p in where.iterdir())
        monkeypatch.chdir(where)
        rc = call(side)
        files = {p.name: p.read_bytes() for p in sorted(where.iterdir())
                 if p.name not in before}
        out.append((rc, capsys.readouterr().out, files))
    return out


IMGTOOL = {
    "info": ["info", "a.pfm"],
    "cat": ["cat", "a.pfm"],
    "diff same": ["diff", "a.pfm", "a.pfm"],
    "diff count": ["diff", "a.pfm", "b.pfm", "--tolerance", "0.1"],
    "diff mse": ["diff", "a.pfm", "b.pfm", "--tolerance", "0.1", "--metric", "mse",
                 "--outfile", "d.pfm"],
    "diff size": ["diff", "a.pfm", "small.pfm"],
    "convert scale": ["convert", "a.pfm", "c.pfm", "--scale", "2.0"],
    "convert all": ["convert", "b.pfm", "c.pfm", "--scale", "1.5", "--despike", "1.2",
                    "--bloom-level", "0.9", "--bloom-width", "2", "--bloom-scale",
                    "0.5", "--tonemap", "--max-luminance", "2", "--flipy"],
    "convert npy": ["convert", "a.pfm", "c.npy", "--tonemap"],
    "assemble": ["assemble", "--outfile", "m.pfm", "left.pfm", "right.pfm"],
    "assemble size": ["assemble", "--outfile", "m.pfm", "a.pfm", "small.pfm"],
}


@pytest.mark.parametrize("case", list(IMGTOOL))
def test_imgtool_matches_jax(tmp_path, monkeypatch, capsys, case):
    inputs = tmp_path / "in"
    inputs.mkdir()
    write_images(inputs)
    args = IMGTOOL[case]
    (jrc, jout, jfiles), (rc, out, files) = run_both(
        tmp_path, monkeypatch, capsys, inputs,
        lambda side: (jimg if side == "jax" else timg).main(args))
    assert (rc, out, files) == (jrc, jout, jfiles)
    assert rc == (1 if case in ("diff count", "diff size", "assemble size") else 0)


def test_imgtool_makesky_matches_jax(tmp_path, monkeypatch, capsys):
    args = ["makesky", "--outfile", "sky.pfm", "--resolution", "64", "--elevation", "30"]
    inputs = tmp_path / "in"
    inputs.mkdir()
    (jrc, jout, _), (rc, out, _) = run_both(
        tmp_path, monkeypatch, capsys, inputs,
        lambda side: (jimg if side == "jax" else timg).main(args))
    assert (rc, out) == (jrc, jout) == (0, "wrote sky.pfm (64x32)\n")
    ours = tio.read_image(str(tmp_path / "port" / "sky.pfm"))
    theirs = jio.read_image(str(tmp_path / "jax" / "sky.pfm"))
    assert ours.shape == (32, 64, 3) and np.isfinite(ours).all() and ours.max() > 0
    np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=0)


QUAD = "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3\nf 1 3 4\n"

# two materials from an .mtl (one plastic, one matte), normals and uv,
# negative indices, a pentagon fanned into three triangles, and faces with
# no material
RICH = """# a comment
mtllib r.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0.5 1.5 0.25
vn 0 0 1
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vt 0.5 1
f 1 2 3
usemtl shiny
f 1/1/1 2/2/1 3/3/1 4/4/1 5/5/1
usemtl dull
f -5/-5/-1 -4/-4/-1 -3/-3/-1
"""
MTL = """newmtl shiny
Kd 0.2 0.3 0.4
Ks 0.5 0.5 0.5
Ns 250
newmtl dull
Kd 0.7 0.6 0.5
d 1
map_Kd tex.png
"""


@pytest.mark.parametrize("case", ["quad", "rich"])
def test_obj2pbrt_matches_jax(tmp_path, monkeypatch, capsys, case):
    inputs = tmp_path / "in"
    inputs.mkdir()
    (inputs / "q.obj").write_text(QUAD if case == "quad" else RICH)
    (inputs / "r.mtl").write_text(MTL)
    (jrc, jout, jfiles), (rc, out, files) = run_both(
        tmp_path, monkeypatch, capsys, inputs,
        lambda side: (jobj if side == "jax" else tobj).main(["q.obj", "q.pbrt"]))
    assert (rc, out, files) == (jrc, jout, jfiles)
    assert list(files) == ["q.pbrt"]
    scene = parse_pbrt_string(files["q.pbrt"].decode()).build_scene(device="cpu")
    assert scene.tri_indices.shape[0] == (2 if case == "quad" else 5)


def write_hair(path, segments=None, color=False):
    """test_mlt_sppm_tools.py:122-133's file: one strand of 3 segments with
    points and thicknesses; with `segments`, a strand per entry and their
    counts in the file, and colors."""
    n_strands = 1 if segments is None else len(segments)
    n_pts = 4 if segments is None else int(sum(s + 1 for s in segments))
    flags = 2 | 4 | (1 if segments is not None else 0) | (16 if color else 0)
    rs = np.random.RandomState(2)
    with open(path, "wb") as f:
        f.write(b"HAIR")
        f.write(struct.pack("<IIIIff", n_strands, n_pts, flags, 3, 0.1, 0.5))
        f.write(struct.pack("<fff", 0.5, 0.3, 0.1))
        f.write(b"\0" * 88)
        if segments is not None:
            f.write(np.asarray(segments, "<u2").tobytes())
        pts = (np.arange(12, dtype="<f4").reshape(4, 3) * 0.1 if segments is None
               else rs.randn(n_pts, 3).astype("<f4"))
        f.write(pts.tobytes())
        f.write((np.ones(n_pts, "<f4") * 0.05).tobytes())
        if color:
            f.write(rs.rand(n_pts, 3).astype("<f4").tobytes())


@pytest.mark.parametrize("case", ["one strand", "strands"])
def test_cyhair2pbrt_matches_jax(tmp_path, monkeypatch, capsys, case):
    inputs = tmp_path / "in"
    inputs.mkdir()
    if case == "one strand":
        write_hair(inputs / "t.hair")
        args = ["t.hair", "t.pbrt"]
    else:
        write_hair(inputs / "t.hair", segments=[3, 0, 5, 2], color=True)
        args = ["t.hair", "t.pbrt", "--scale", "2.5", "--max-strands", "3"]
    (jrc, jout, jfiles), (rc, out, files) = run_both(
        tmp_path, monkeypatch, capsys, inputs,
        lambda side: (jhair if side == "jax" else thair).main(args))
    assert (rc, out, files) == (jrc, jout, jfiles)
    assert list(files) == ["t.pbrt"]
    text = files["t.pbrt"].decode()
    assert text.count('Shape "curve"') == (3 if case == "one strand" else 3 + 5)
    scene = parse_pbrt_string(text).build_scene(device="cpu")
    assert scene.curve_packed is not None
