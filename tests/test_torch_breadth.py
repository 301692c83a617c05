"""pbrt-v3's classic material and light set through the port's entry
points: chip_smoke.write_breadth_pbrt's scene (uber, substrate,
translucent, metal, mix and uber with an imagemap opacity; spot, distant,
projection and goniometric lights beside the emissive sphere) at 32x32 and
a 16x8 blob, made here with SceneBuilder call for call (breadth_scene).
tests/test_torch_breadth_jax.py holds the file's parse and renders against
the JAX package's; this file holds

* the refusals of the JAX package's liberties: a nested or dangling mix, a
  spot light's "from" and "to", a second projection or goniometric light
  with its own map, a map that does not load, an opacity map that no Kd,
  Ks, sigma or roughness binding reaches, and bump_tex;
* the grad step on a one-triangle scene of each new material and light."""
from pathlib import Path

import numpy as np
import pytest

from chip_smoke import blob_mesh
from pbrt_tpu import scene as jsc
from pbrt_tpu.textures import textures as jtx
from pbrt_tpu_torch import bridge
from pbrt_tpu_torch import scene as tsc
from pbrt_tpu_torch import sceneio as tio
from pbrt_tpu_torch.core import transform as ttf
from pbrt_tpu_torch.utils.imageio import read_image, write_pfm
import test_torch_threads  # noqa: F401  (torch's threads under xdist)

RES, SPP, DEPTH, BLOB = (32, 32), 2, 3, (16, 8)
UNIFORM = ' "string lightsamplestrategy" "uniform"'
REPO = Path(__file__).resolve().parent.parent


def breadth_scene(sc, tf, tx, out_dir: Path):
    """write_breadth_pbrt's scene through SceneBuilder, call for call as
    the .pbrt front end makes it (the default matte first, then the named
    materials, each Material as it comes), reading the same PFMs."""
    b = sc.SceneBuilder()
    img = {k: read_image(str(out_dir / f"{k}.pfm"))
           for k in ("slide", "gonio", "opacity")}
    default = b.add_material(sc.MAT_MATTE, kd=(0.5, 0.5, 0.5))
    b.add_distant_light(np.float32([-1.0, -0.6, 2.0]), (1.2, 1.1, 0.9))
    b.add_spot_light(tf.translate(0, 9, 4) @ tf.rotate(90, 1, 0, 0),
                     (90.0, 80.0, 60.0), cone_angle_deg=40.0, cone_delta_deg=10.0)
    b.add_projection_light(tf.translate(0, -2, 9) @ tf.rotate(180, 1, 0, 0),
                           (120.0, 120.0, 120.0), fov_deg=60.0, image=img["slide"])
    b.add_gonio_light(tf.translate(-3, -3, 5), (25.0, 25.0, 25.0),
                      image=img["gonio"])
    op = b.textures.add(tx.TEX_IMAGEMAP, c1=(1.0, 1.0, 1.0), image=img["opacity"],
                        fparams=(0.0, 8.0, float(tx.WRAP_REPEAT), 0.0))
    mixa = b.add_material(sc.MAT_MATTE, kd=(0.2, 0.6, 0.3))
    mixb = b.add_material(sc.MAT_METAL, metal_eta=_copper()[0],
                          metal_k=_copper()[1], roughness=0.05)
    floor = b.add_material(sc.MAT_SUBSTRATE, kd=(0.5, 0.5, 0.7), ks=(0.3, 0.3, 0.3),
                           urough=0.05, vrough=0.2)
    b.add_triangle_mesh([[0, 1, 2], [2, 3, 0]],
                        [[-10, -10, 0], [10, -10, 0], [10, 10, 0], [-10, 10, 0]],
                        material=floor)
    wall = b.add_material(sc.MAT_TRANSLUCENT, kd=(0.6, 0.5, 0.4), ks=(0.2, 0.2, 0.2),
                          kr=(0.5, 0.5, 0.5), kt=(0.5, 0.5, 0.5), roughness=0.1)
    b.add_triangle_mesh([[0, 1, 2], [2, 3, 0]],
                        [[-10, 6, 0], [10, 6, 0], [10, 6, 12], [-10, 6, 12]],
                        material=wall)
    blob = b.add_material(sc.MAT_UBER, kd=(0.3, 0.3, 0.3), ks=(0.2, 0.2, 0.2),
                          kr=(0.1, 0.1, 0.1), kt=(0.0, 0.0, 0.0), roughness=0.05)
    idx, v = blob_mesh(*BLOB, seed=0, center=(0.0, 0.0, 2.2), radius=2.0)
    b.add_triangle_mesh(idx, v, material=blob)
    metal = b.add_material(sc.MAT_METAL, metal_eta=_copper()[0],
                           metal_k=_copper()[1], roughness=0.05)
    b.add_sphere(tf.translate(3.7, -0.5, 1.2), 1.2, material=metal)
    mix = b.add_material(sc.MAT_MIX, mix_m1=mixa, mix_m2=mixb,
                         mix_amount=(0.3, 0.3, 0.3))
    b.add_sphere(tf.translate(2.2, -3.2, 0.8), 0.8, material=mix)
    uber = b.add_material(sc.MAT_UBER, kd=(0.6, 0.3, 0.2), ks=(0.0, 0.0, 0.0),
                          ks_tex=op, kr=(0.0, 0.0, 0.0), kt=(0.0, 0.0, 0.0),
                          roughness=0.1, opacity=(0.0, 0.0, 0.0), opacity_tex=op)
    b.add_sphere(tf.translate(-3.4, -1.5, 1.0), 1.0, material=uber)
    b.add_emissive_sphere(tf.translate(0, 5, 8), 0.5, L=(40.0, 40.0, 40.0),
                          material=default)
    return b


def _copper():
    from pbrt_tpu_torch.core.sampled_spectrum import copper_eta_k_rgb

    return copper_eta_k_rgb()


# ---- the JAX package's liberties, refused ----

def _file(tmp_path, body, images=()):
    for name in images:
        write_pfm(str(tmp_path / name), np.full((4, 8, 3), 0.5, np.float32))
    path = tmp_path / "f.pbrt"
    path.write_text(f"WorldBegin\n{body}\nShape \"sphere\"\nWorldEnd\n")
    return path


@pytest.mark.parametrize("body,err,what", [
    ('MakeNamedMaterial "a" "string type" "matte"\n'
     'MakeNamedMaterial "m" "string type" "mix" "string namedmaterial1" "a"'
     ' "string namedmaterial2" "a"\n'
     'Material "mix" "string namedmaterial1" "m" "string namedmaterial2" "a"',
     NotImplementedError, "itself a mix"),
    ('MakeNamedMaterial "a" "string type" "matte"\n'
     'Material "mix" "string namedmaterial1" "a" "string namedmaterial2" "b"',
     ValueError, "never made"),
    ('LightSource "spot" "point from" [0 0 2]', NotImplementedError, "from"),
    ('LightSource "spot" "point to" [1 0 0]', NotImplementedError, "to"),
    ('LightSource "projection" "string mapname" "a.pfm"\n'
     'LightSource "projection" "string mapname" "b.pfm" "float fov" [30]',
     NotImplementedError, "second projection"),
    ('LightSource "goniometric" "string mapname" "a.pfm"\n'
     'Translate 0 0 1\nLightSource "goniometric" "string mapname" "a.pfm"',
     NotImplementedError, "second goniometric"),
    ('LightSource "projection" "string mapname" "missing.pfm"',
     FileNotFoundError, "missing"),
    ('LightSource "goniometric" "string mapname" "missing.pfm"',
     FileNotFoundError, "missing"),
    ('Texture "op" "spectrum" "imagemap" "string filename" "a.pfm"\n'
     'Material "uber" "texture opacity" "op"',
     NotImplementedError, "opacity texture"),
])
def test_liberties_raise(tmp_path, body, err, what):
    path = _file(tmp_path, body, images=("a.pfm", "b.pfm"))
    with pytest.raises(err, match=what):
        tio.parse_pbrt_file(str(path)).scene_builder.build(device="cpu")


def test_second_map_light_sharing_the_first_ones_payload_builds(tmp_path):
    """Two projection lights with one map and one transform render as the
    JAX package renders them, and so are accepted."""
    path = _file(tmp_path, 'LightSource "projection" "string mapname" "a.pfm"\n'
                 'LightSource "projection" "string mapname" "a.pfm" "rgb I" [2 2 2]',
                 images=("a.pfm",))
    fields = tio.parse_pbrt_file(str(path)).scene_builder.build_numpy()
    assert fields["lights"]["light_type"].tolist() == [5, 5]
    assert int(fields["lights"]["proj_light_idx"]) == 0


def test_opacity_map_reached_through_a_child_builds(tmp_path):
    """An opacity map that a Kd texture reaches as its child is one the JAX
    package evaluates, and so is accepted."""
    path = _file(tmp_path, 'Texture "op" "spectrum" "imagemap" '
                 '"string filename" "a.pfm"\n'
                 'Texture "s" "spectrum" "scale" "texture tex1" "op"\n'
                 'Material "uber" "texture Kd" "s" "texture opacity" "op"',
                 images=("a.pfm",))
    scene = tio.parse_pbrt_file(str(path)).scene_builder.build(device="cpu")
    assert int(scene.materials.opacity_tex.max()) >= 0


def test_builder_mix_rows_and_bump_tex_raise():
    def scene(sc, **mix):
        b = sc.SceneBuilder()
        a = b.add_material(sc.MAT_MATTE)
        b.add_material(sc.MAT_MIX, mix_m1=a, mix_m2=a)
        m = b.add_material(sc.MAT_MIX, **mix)
        b.add_triangle_mesh([[0, 1, 2]], [[0, 0, 0], [1, 0, 0], [0, 1, 0]],
                            material=m)
        return b

    with pytest.raises(NotImplementedError, match="itself a mix"):
        scene(tsc, mix_m1=0, mix_m2=1).build(device="cpu")
    with pytest.raises(ValueError, match="names no material"):
        scene(tsc, mix_m1=0).build(device="cpu")
    j = jsc.SceneBuilder()
    m = j.add_material(jsc.MAT_MATTE, bump_tex=j.textures.add(jtx.TEX_CONSTANT))
    j.add_triangle_mesh([[0, 1, 2]], [[0, 0, 0], [1, 0, 0], [0, 1, 0]], material=m)
    with pytest.raises(NotImplementedError, match="bump mapping"):
        bridge.scene_from_numpy(bridge.as_numpy_fields(j.build()), "cpu")


@pytest.mark.parametrize("what", ["metal", "substrate", "uber", "translucent",
                                  "mix", "spot lights", "distant lights",
                                  "projection lights", "goniometric lights"])
def test_grad_step_refuses_the_new_types(what):
    """A one-triangle scene of one classic material or light: the step,
    held against the JAX package's in tests/test_torch_grad_classic.py,
    runs, L is the no-grad forward's and every leaf is finite."""
    from test_torch_grad_groups import assert_step_runs

    b = tsc.SceneBuilder()
    mt = {"metal": tsc.MAT_METAL, "substrate": tsc.MAT_SUBSTRATE,
          "uber": tsc.MAT_UBER, "translucent": tsc.MAT_TRANSLUCENT}.get(what)
    m = b.add_material(tsc.MAT_MATTE)
    if what == "mix":
        m = b.add_material(tsc.MAT_MIX, mix_m1=m, mix_m2=m)
    elif mt is not None:
        m = b.add_material(mt)
    b.add_triangle_mesh([[0, 1, 2]], [[-1, -1, 0], [1, -1, 0], [0, 1, 0]],
                        material=m)
    light = ttf.translate(0, 0, 2)
    {"spot lights": lambda: b.add_spot_light(light, (1.0, 1.0, 1.0)),
     "distant lights": lambda: b.add_distant_light((0, 0, 1), (1.0, 1.0, 1.0)),
     "projection lights": lambda: b.add_projection_light(light, (1.0, 1.0, 1.0)),
     "goniometric lights": lambda: b.add_gonio_light(light, (1.0, 1.0, 1.0)),
     }.get(what, lambda: b.add_point_light(light, (1.0, 1.0, 1.0)))()
    from pbrt_tpu_torch.cameras import make_perspective_camera
    from pbrt_tpu_torch.integrators import path as tpath

    res = (4, 4)
    camera = make_perspective_camera(ttf.look_at([0, 0, 3], [0, 0, 0], [0, 1, 0]),
                                     res)
    assert_step_runs(b.build(device="cpu"), camera, res)
