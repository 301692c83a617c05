"""The port's .pbrt front end (pbrt_tpu_torch.sceneio) against the JAX
package's (pbrt_tpu.sceneio): the same file gives the same camera, film,
sampler and integrator configs and the same scene arrays (bridge.
compare_setups: integer fields exactly, float fields to 1e-6 relative, the
tolerance of tests/test_torch_scene.py), and every directive the port does
not render is refused."""
import dataclasses
import pathlib

import numpy as np
import pytest

from pbrt_tpu import sceneio as jio
from pbrt_tpu.sceneio import plyload as jply
from pbrt_tpu_torch import bridge
from pbrt_tpu_torch import sceneio as tio
from pbrt_tpu_torch.sceneio import plyload as tply
from test_sceneio import SIMPLE_SCENE
from jax_traversal_jit import jit_jax_traversal  # noqa: F401  (autouse)
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
    ('Material "velvet"\n', "velvet"),
    ('LightSource "distant" "xyz L" [1 1 1]\n', "xyz L"),
    ('Material "matte" "xyz Kd" [.5 .5 .5]\n', "xyz Kd"),
    ('ObjectBegin "o"\nAreaLightSource "diffuse"\nShape "trianglemesh" '
     '"integer indices" [0 1 2] "point P" [0 0 0 1 0 0 0 1 0]\nObjectEnd\n',
     "inside an object"),
    ('MakeNamedMedium "m" "string type" "cloud"\n', "cloud"),
    ('Shape "curve" "point P" [0 0 0 1 0 0 1 1 0 0 1 1] "integer degree" [2]\n',
     "degree"),
    ('LightSource "spot" "point from" [0 0 1]\n', "from"),
    ('AreaLightSource "diffuse"\nShape "cylinder"\n', "cylinder"),
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
    ('Camera "fisheye"', "make_camera", "fisheye"),
    ('Sampler "pss"', "make_sampler_config", "pss"),
    ('Integrator "path" "string lightsamplestrategy" "spatialx"',
     "make_integrator_config", "spatialx"),
])
def test_option_refusals(options, call, what):
    setup = tio.parse_pbrt_string(f"{options}\nWorldBegin\nWorldEnd\n")
    with pytest.raises(NotImplementedError, match=what):
        getattr(setup, call)()


@pytest.mark.parametrize("options", [
    'Camera "orthographic" "float lensradius" [0.1] "float focaldistance" [3]',
    'Camera "orthographic"',
    'Camera "environment" "float shutterclose" [0.5]',
    # no lens file: the built-in 50 mm double Gauss
    'Camera "realistic" "float filmdiag" [30] "float focusdistance" [4]',
    'Sampler "stratified" "integer pixelsamples" [4]',
    'Sampler "lowdiscrepancy" "integer pixelsamples" [8]',
    'Sampler "random"',
    'Sampler "maxmin" "integer pixelsamples" [4]',
    'PixelFilter "gaussian"',
    'PixelFilter "gaussian" "float xwidth" [1.5] "float alpha" [3]',
    'PixelFilter "mitchell" "float B" [0.5] "float C" [0.25]',
    'PixelFilter "triangle" "float ywidth" [1]',
    'PixelFilter "sinc" "float tau" [2]',
])
def test_imaging_options_match_jax(options):
    """The cameras, filters and samplers a file names: the port's setup
    held against the JAX package's (bridge.compare_setups: the camera, the
    film with its filter's radius, the sampler)."""
    text = (f'{options}\nWorldBegin\nLightSource "point" "color I" [1 1 1]\n'
            'Shape "sphere" "float radius" [1]\nWorldEnd\n')
    assert bridge.compare_setups(jio.parse_pbrt_string(text),
                                 tio.parse_pbrt_string(text)) == []


def test_kdtree_and_exact_sampler_refused(monkeypatch):
    """Accelerator "kdtree" reaches the builder (the port has the kd-tree;
    an unknown name means the BVH, as in the JAX package).
    PBRT_TPU_EXACT_SAMPLER=1 turns the exact
    tables on for halton and the PixelSamplers, as in the JAX package, and
    leaves sobol and random as they are; a render asking random or sobol
    for the exact mode raises the JAX package's message, and so does any
    integrator but path."""
    import torch

    from pbrt_tpu_torch.integrators import path as tpath
    from pbrt_tpu_torch.integrators import whitted as twhitted
    from pbrt_tpu_torch.integrators.direct import DirectLightingConfig
    from pbrt_tpu_torch.samplers.samplers import SamplerConfig

    for name, kind in (("kdtree", "kdtree"), ("bvh", "bvh"), ("grid", "bvh")):
        setup = tio.parse_pbrt_string(f'Accelerator "{name}"\nWorldBegin\nWorldEnd\n')
        assert setup.scene_builder.accelerator == kind, name
    monkeypatch.setenv("PBRT_TPU_EXACT_SAMPLER", "1")
    for name, exact in (("halton", True), ("stratified", True),
                        ("lowdiscrepancy", True), ("maxmin", True),
                        ("sobol", False), ("random", False)):
        setup = tio.parse_pbrt_string(f'Sampler "{name}"\nWorldBegin\nWorldEnd\n')
        assert setup.make_sampler_config().exact is exact, name
    setup = tio.parse_pbrt_string(
        'Sampler "halton" "integer pixelsamples" [1]\nWorldBegin\n'
        'LightSource "point" "color I" [1 1 1]\n'
        'Shape "sphere" "float radius" [1]\nWorldEnd\n')
    scene = setup.build_scene("cpu")
    film_cfg, filt = setup.make_film_config()
    film_cfg = dataclasses.replace(film_cfg, full_resolution=(4, 4))
    camera = setup.make_camera()
    for name in ("random", "sobol"):
        with pytest.raises(NotImplementedError, match="exact-tables render mode"):
            tpath.render(scene, camera, film_cfg,
                         SamplerConfig(name, 1, (4, 4), exact=True),
                         tpath.PathConfig(max_depth=1), filt, device="cpu")
    with pytest.raises(NotImplementedError, match="exact sampler mode"):
        twhitted.render(scene, camera, film_cfg,
                        SamplerConfig("halton", 1, (4, 4), exact=True),
                        DirectLightingConfig(max_depth=1), filt, device="cpu")
    img = tpath.render(scene, camera, film_cfg,
                       SamplerConfig("halton", 1, (4, 4), exact=True),
                       tpath.PathConfig(max_depth=1), filt, device="cpu")
    assert img.shape == (4, 4, 3) and bool(torch.isfinite(img).all())


def test_missing_image_raises(tmp_path):
    """The JAX package puts a gray placeholder in for an image it cannot
    read (api.py:392-395); the port raises."""
    scene = tmp_path / "s.pbrt"
    scene.write_text('WorldBegin\nTexture "t" "spectrum" "imagemap" '
                     '"string filename" "missing.pfm"\nWorldEnd\n')
    with pytest.raises(FileNotFoundError):
        tio.parse_pbrt_file(str(scene))


SPD = "# a test spd\n400 0.2\n500 0.6  # inline comment\n600 0.4\n700 0.9\n"
SPECTRUM_DECLS = {
    "blackbody": ("blackbody I", [6500, 2]),
    "blackbody, no scale": ("blackbody I", [3000]),
    "pairs": ("spectrum Kd", [400, 0.2, 500, 0.6, 600, 0.4, 700, 0.9]),
    "pairs, unsorted range": ("spectrum Kd", [380.0, 0.5, 720.0, 0.1]),
    "file": ("spectrum Kd", None),
}


@pytest.mark.parametrize("name", list(SPECTRUM_DECLS))
def test_spectrum_forms_match_jax(tmp_path, name):
    """The blackbody and spectrum forms (sampled_spectrum.py: FromSampled,
    BlackbodyNormalized, .spd files) against the JAX package's
    ParamSet.find_one_spectrum, float32 bit for bit; the .spd file named by
    its absolute path (the JAX package opens a relative name from the
    process's directory)."""
    from pbrt_tpu.sceneio.paramset import ParamSet as JParamSet
    from pbrt_tpu_torch.sceneio.paramset import ParamSet as TParamSet

    decl, vals = SPECTRUM_DECLS[name]
    if vals is None:
        (tmp_path / "kd.spd").write_text(SPD)
        vals = [str(tmp_path / "kd.spd")]
    key = decl.split()[1]
    ref = JParamSet.from_decls([(decl, vals)]).find_one_spectrum(key, 1.0)
    got = TParamSet.from_decls([(decl, vals)]).find_one_spectrum(key, 1.0)
    assert ref.dtype == got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


def test_spd_file_is_found_beside_the_scene(tmp_path):
    """A relative .spd name is resolved against the scene file's directory,
    as image maps are; the same file by its absolute path gives the same
    material row."""
    sub = tmp_path / "s"
    sub.mkdir()
    (sub / "kd.spd").write_text(SPD)
    body = ('WorldBegin\nMaterial "matte" "spectrum Kd" "{}"\n'
            'Shape "sphere"\nWorldEnd\n')
    (sub / "rel.pbrt").write_text(body.format("kd.spd"))
    (sub / "abs.pbrt").write_text(body.format(sub / "kd.spd"))
    rel = tio.parse_pbrt_file(str(sub / "rel.pbrt")).scene_builder.materials
    ab = tio.parse_pbrt_file(str(sub / "abs.pbrt")).scene_builder.materials
    np.testing.assert_array_equal(rel[-1]["kd"], ab[-1]["kd"])
    assert float(np.asarray(rel[-1]["kd"]).max()) > 0.3


def test_spectrum_forms_in_a_file_match_jax(tmp_path):
    """A whole file with a blackbody point light and spectrum materials:
    the port's setup against the JAX package's, arrays bit for bit."""
    (tmp_path / "kd.spd").write_text(SPD)
    text = SIMPLE_SCENE.replace(
        "WorldBegin",
        'WorldBegin\nLightSource "point" "blackbody I" [4500 3] "rgb scale" [2 2 2]\n'
        f'Material "plastic" "spectrum Kd" "{tmp_path / "kd.spd"}"\n'
        '  "spectrum Ks" [400 0.1 550 0.3 700 0.2]\nShape "sphere"', 1)
    assert bridge.compare_setups(jio.parse_pbrt_string(text),
                                 tio.parse_pbrt_string(text), rtol=0.0) == []


def test_maxmindist_is_maxmin():
    """Sampler "maxmindist", pbrt-v3's name, is the maxmin sampler: the
    JAX package's SamplerConfig reads it as an unknown name (the port's
    liberty: the name pbrt-v3 documents)."""
    setup = tio.parse_pbrt_string('Sampler "maxmindist" "integer pixelsamples" [4]\n'
                                  'WorldBegin\nWorldEnd\n')
    cfg = setup.make_sampler_config()
    assert cfg.name == "maxmin" and cfg.spp == 4


@pytest.mark.parametrize("param", ['"integer xsamples" [2]', '"integer ysamples" [2]',
                                   '"bool jitter" "false"'])
def test_stratified_strata_parameters_refused(param):
    """The JAX package's stratified sampler draws pixelsamples jittered
    strata and ignores xsamples, ysamples and jitter; the port refuses
    them rather than render another sampler than the file asks for."""
    setup = tio.parse_pbrt_string(f'Sampler "stratified" {param}\n'
                                  'WorldBegin\nWorldEnd\n')
    with pytest.raises(NotImplementedError, match="stratified"):
        setup.make_sampler_config()


LENS = """# a two-element lens: radius thickness eta aperture
  29.475 3.76 1.67 25.2
  -84.83 20 1 25.2
"""


def test_lensfile_is_found_beside_the_scene(tmp_path):
    """The realistic camera's lensfile is read from the scene file's
    directory: the port's camera from the relative name equals the JAX
    package's from the absolute path (which it opens from the process's
    directory); an unreadable lens file is refused (the JAX package falls
    back to its built-in lens with a warning)."""
    (tmp_path / "two.dat").write_text(LENS)
    cam = ('Camera "realistic" "string lensfile" "{}" "float filmdiag" [30] '
           '"float focusdistance" [4]\nWorldBegin\nShape "sphere"\nWorldEnd\n')
    (tmp_path / "rel.pbrt").write_text(cam.format("two.dat"))
    ref = jio.parse_pbrt_string(cam.format(tmp_path / "two.dat"))
    got = tio.parse_pbrt_file(str(tmp_path / "rel.pbrt"))
    assert bridge.compare_setups(ref, got) == []
    assert got.make_camera().curvature.shape == (2,)
    (tmp_path / "bad.pbrt").write_text(cam.format("missing.dat"))
    with pytest.raises(NotImplementedError, match="lensfile"):
        tio.parse_pbrt_file(str(tmp_path / "bad.pbrt")).make_camera()


@pytest.mark.parametrize("body,what", [
    ('AreaLightSource "diffuse"\nShape "disk"\n', "disk"),
    ('AreaLightSource "diffuse"\nShape "cone"\n', "cone"),
    ('AreaLightSource "diffuse"\nShape "paraboloid"\n', "paraboloid"),
    ('AreaLightSource "diffuse"\nShape "hyperboloid"\n', "hyperboloid"),
    ('AreaLightSource "diffuse"\nShape "heightfield" "integer nu" [2] '
     '"integer nv" [2] "float Pz" [0 0 0 0]\n', "heightfield"),
    ('AreaLightSource "diffuse"\nShape "curve" "point P" [0 0 0 1 0 0 1 1 0 0 1 1]\n',
     "curve"),
    ('Shape "curve" "point P" [0 0 0 1 0 0 1 1 0 0 1 1] "string basis" "bspline"\n',
     "basis"),
    ('Shape "curve" "point P" [0 0 0 1 0 0 1 1 0 0 1 1 2 1 0 2 0 0 3 0 0] '
     '"string type" "ribbon" "normal N" [0 0 1 0 0 1 0 0 1]\n', "first two"),
    ('ObjectBegin "o"\nAreaLightSource "diffuse"\nShape "loopsubdiv" '
     '"integer indices" [0 1 2] "point P" [0 0 0 1 0 0 0 1 0]\nObjectEnd\n',
     "inside an object"),
])
def test_new_shape_refusals(body, what):
    """Where the JAX package drops or misreads what a file asks for, the
    port refuses it: an area light on a shape other than a triangle mesh or
    a sphere (the JAX package drops its emission), an emissive mesh inside
    an object (dropped there too), a curve of another basis (read as a
    Bezier) and a ribbon chain of several segments with its own normals
    (each segment gets the first two)."""
    with pytest.raises(NotImplementedError, match=what):
        tio.parse_pbrt_string(f"WorldBegin\n{body}WorldEnd\n")
