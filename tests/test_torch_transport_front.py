"""The front end of the light-transport integrators (bdpt, mlt, sppm):
their parameters read as the JAX package's render.py reads them, held
through bridge.compare_setups, and every refusal: media, subsurface, a
bound texture, an infinite, projection or goniometric light, a camera
other than the perspective pinhole (bdpt and mlt; sppm takes any camera)
and the exact sampler mode, each raising NotImplementedError naming the
integrator and the feature (the JAX package renders each of them unlike
pbrt-v3; ROADMAP.md §3), also on refgold's mirror file with an infinite
light.  Cheap, and kept apart from
tests/test_torch_bdpt.py's JAX comparisons so that file holds few tests:
xdist's loadfile scheduling dispatches files with many tests first."""
import numpy as np
import pytest

from pbrt_tpu import sceneio as jio
from pbrt_tpu_torch import bridge
from pbrt_tpu_torch import film as tfm
from pbrt_tpu_torch import render as trender
from pbrt_tpu_torch import scene as tsc
from pbrt_tpu_torch import sceneio as tio
from pbrt_tpu_torch.cameras import cameras as tcam
from pbrt_tpu_torch.core import transform as ttf
from pbrt_tpu_torch.integrators import bdpt as tbd
from pbrt_tpu_torch.integrators import mlt as tmlt
from pbrt_tpu_torch.integrators import sppm as tsppm
from pbrt_tpu_torch.samplers import samplers as tsa
from test_torch_bdpt import LOOK, area_scene
from test_torch_whitted_ao import mirror_file
import test_torch_threads  # noqa: F401  (torch's threads under xdist)

BASE = """LookAt 0 -9 2  0 0 1  0 0 1
Camera "perspective" "float fov" [55]
Film "image" "integer xresolution" [8] "integer yresolution" [8]
Sampler "halton" "integer pixelsamples" [1]
Integrator "{integrator}" "integer maxdepth" [2]
WorldBegin
LightSource "point" "color I" [10 10 10] "point from" [0 -2 4]
{extra}
Material "matte" "color Kd" [.5 .5 .5]
Shape "trianglemesh" "point P" [-6 -6 0  6 -6 0  6 6 0  -6 6 0]
  "integer indices" [0 1 2 2 3 0]
"""
FILE_FEATURES = {
    "media": ('MakeNamedMedium "fog" "string type" "homogeneous"\n'
              'AttributeBegin\nMaterial ""\nMediumInterface "fog" ""\n'
              'Shape "sphere" "float radius" [0.5]\nAttributeEnd', "media"),
    "subsurface": ('AttributeBegin\nMaterial "kdsubsurface"\n'
                   'Shape "sphere" "float radius" [0.5]\nAttributeEnd', "subsurface"),
    "texture": ('Texture "c" "spectrum" "checkerboard"\nAttributeBegin\n'
                'Material "matte" "texture Kd" "c"\nShape "sphere" "float radius" [0.5]\n'
                'AttributeEnd', "texture"),
    "infinite": ('LightSource "infinite" "color L" [0.2 0.2 0.2]', "infinite light"),
}


@pytest.mark.parametrize("integrator", ["bdpt", "mlt", "sppm"])
@pytest.mark.parametrize("feature", sorted(FILE_FEATURES))
def test_file_refusals(integrator, feature):
    extra, words = FILE_FEATURES[feature]
    setup = tio.parse_pbrt_string(BASE.format(integrator=integrator, extra=extra))
    with pytest.raises(NotImplementedError, match=f"(?s){integrator}.*{words}"):
        trender.render_setup(setup, device="cpu")


def _builder_scene(feature):
    b = area_scene(tsc, ttf)
    rs = np.random.RandomState(0)
    if feature == "projection light":
        b.add_projection_light(ttf.translate(0, 0, 6), (5.0, 5.0, 5.0), fov_deg=40.0,
                               image=rs.rand(8, 8, 3).astype(np.float32))
    elif feature == "goniometric light":
        b.add_gonio_light(ttf.translate(0, 0, 6), (5.0, 5.0, 5.0),
                          image=rs.rand(8, 16, 3).astype(np.float32))
    return b.build(device="cpu")


RENDERS = {"bdpt": tbd.render, "mlt": tmlt.render, "sppm": tsppm.render}


@pytest.mark.parametrize("integrator", ["bdpt", "mlt", "sppm"])
@pytest.mark.parametrize("feature", ["projection light", "goniometric light",
                                     "camera other than perspective",
                                     "lens radius", "exact sampler mode"])
def test_builder_refusals(integrator, feature):
    look = ttf.look_at(*LOOK)
    camera = {
        "camera other than perspective": tcam.make_orthographic_camera(look, (8, 8)),
        "lens radius": tcam.make_perspective_camera(look, (8, 8), lens_radius=0.1,
                                                    focal_distance=5.0),
    }.get(feature, tcam.make_perspective_camera(look, (8, 8), fov_deg=55.0))
    sampler = tsa.SamplerConfig("halton", 1, (8, 8),
                                exact=feature == "exact sampler mode")
    scene = _builder_scene(feature)
    cfg = {"sppm": tsppm.SPPMConfig(max_depth=1, n_iterations=1)}.get(integrator)
    kw = {} if cfg is None else {"cfg": cfg}
    run = lambda: RENDERS[integrator](  # noqa: E731
        scene, camera, tfm.FilmConfig(full_resolution=(8, 8)), sampler, device="cpu",
        **kw)
    if integrator == "sppm" and feature in ("camera other than perspective",
                                            "lens radius"):
        assert np.isfinite(run().numpy()).all()  # sppm only generates rays
        return
    with pytest.raises(NotImplementedError, match=f"{integrator}.*{feature}"):
        run()


@pytest.mark.parametrize("integrator,config", [
    ('bdpt" "integer maxdepth" [3', tbd.BDPTConfig(max_depth=3)),
    ('mlt" "integer maxdepth" [3] "integer bootstrapsamples" [1000] '
     '"integer chains" [64] "integer mutationsperpixel" [8] "float sigma" [0.02] '
     '"float largestepprobability" [0.2',
     tmlt.MLTConfig(3, 1000, 64, 8, 0.02, 0.2)),
    ('sppm" "integer maxdepth" [4] "integer numiterations" [3] '
     '"integer photonsperiteration" [500] "float radius" [0.25',
     tsppm.SPPMConfig(4, 3, 500, 0.25)),
])
def test_setup_matches_jax(integrator, config):
    """make_integrator_config reads pbrt-v3's parameters with the JAX
    package's defaults (render.py:121-153); bridge.compare_setups holds the
    whole parsed setup, the three configurations field by field."""
    text = BASE.replace('"{integrator}" "integer maxdepth" [2]',
                        f'"{integrator}]').format(extra="")
    setup = tio.parse_pbrt_string(text)
    assert setup.make_integrator_config() == config
    assert bridge.compare_setups(jio.parse_pbrt_string(text), setup) == []
    bare = BASE.replace('"{integrator}" "integer maxdepth" [2]',
                        f'"{integrator.split(chr(34))[0]}"').format(extra="")
    # the JAX package's defaults (render.py:121-153) are the classes' own
    assert tio.parse_pbrt_string(bare).make_integrator_config() == type(config)()
    assert bridge.compare_setups(jio.parse_pbrt_string(bare),
                                 tio.parse_pbrt_string(bare)) == []


@pytest.mark.parametrize("name", ["bdpt", "mlt", "sppm"])
def test_unported_integrators_raise(tmp_path, name):
    """bdpt, mlt and sppm render the mirror file (tests/test_torch_bdpt.py,
    test_torch_mlt_sppm.py); with an infinite light, which the JAX
    package's light subpaths leave dark, each raises naming itself."""
    path = mirror_file(tmp_path, f'"{name}"')
    text = open(path).read().replace(
        "WorldBegin", 'WorldBegin\nLightSource "infinite" "color L" [0.1 0.1 0.1]')
    open(path, "w").write(text)
    with pytest.raises(NotImplementedError, match=f"{name}.*infinite light"):
        trender.render_file(path, out=str(tmp_path / "o.pfm"), device="cpu")
