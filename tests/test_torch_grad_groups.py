"""The port's grad step (pbrt_tpu_torch.parallel.diff.render_grad_step) on
every family it renders, in four small scenes, without the JAX package:
the scenes and step helpers that tests/test_torch_grad_{config3,classic,
advanced,imaging}.py hold against pbrt_tpu.parallel.diff, and on each
group the checks that need no JAX:

* config3: a checkerboard-textured and an imagemap-textured floor, smooth
  and rough glass spheres, a small env map and a point light;
* classic: metal, substrate, uber at opacity 0.5, translucent and a
  matte/metal mix under spot, distant, projection and goniometric lights;
* advanced: disney, hair, fourier (the port's roughgold_alpha_0.2.bsdf),
  subsurface "Skin1" and kdsubsurface under a point light;
* imaging: the orthographic camera with a thin lens, the environment
  camera and the realistic camera (material and light leaves only), each
  under the stratified, zerotwosequence, maxmin and random samplers (the
  random sampler without remat).

Each at 12x12, depth 2 (glass's inside bounce is reached), sample 1, one
set of seeded weights.  Checks: the step's L equals the no-grad forward
(render_batch_radiance) bit for bit, every leaf is finite, remat against
no remat at rtol 1e-4, the replayed bounces' traversal launches equal the
forward's bit for bit (ops.bvh.record_calls), the probe walk's too, and,
for the leaves the JAX package's step gives NaN on these scenes, the
port's AD against its own central differences (FD_CASES).  Also
assert_step_runs, the check of the one-family scenes of
tests/test_torch_{grad,breadth,subsurface}.py.
"""
import dataclasses
import functools
from pathlib import Path

import numpy as np
import pytest
import torch

from pbrt_tpu_torch import film as tfm
from pbrt_tpu_torch import scene as tsc
from pbrt_tpu_torch.cameras import cameras as tcam
from pbrt_tpu_torch.cameras.cameras import perspective_raster_to_camera
from pbrt_tpu_torch.cameras import realistic as treal
from pbrt_tpu_torch.core import transform as ttf
from pbrt_tpu_torch.integrators import path as tpath
from pbrt_tpu_torch.materials import bssrdf as tbs
from pbrt_tpu_torch.materials.measuredss import get_medium_scattering_properties
from pbrt_tpu_torch.ops import bvh
from pbrt_tpu_torch.parallel import diff
from pbrt_tpu_torch.samplers.samplers import SamplerConfig as TSampler
from pbrt_tpu_torch.textures import textures as ttx
from pbrt_tpu_torch.utils import stats as st
import test_torch_threads  # noqa: F401  (torch's threads under xdist)

RES, DEPTH, SAMPLE = (12, 12), 2, 1
FOURIER = (Path(__file__).resolve().parent.parent / "pbrt_tpu_torch" / "data"
           / "roughgold_alpha_0.2.bsdf")
LOOK = ([0.0, -7.0, 4.5], [0.0, 0.0, 0.8], [0.0, 0.0, 1.0])
LEAVES = ("kd", "ks", "roughness", "light_L")
NO_CAMERA = diff.MATERIAL_PARAMS + diff.LIGHT_PARAMS
# (camera, sampler) cases of the imaging group
IMAGING = [(c, s) for c in ("orthographic", "environment", "realistic")
           for s in ("stratified", "zerotwosequence", "maxmin", "random")]


def _floor(b, material, x0=-6.0, x1=6.0, uv=None):
    b.add_triangle_mesh([[0, 1, 2], [2, 3, 0]],
                        [[x0, -6, 0], [x1, -6, 0], [x1, 6, 0], [x0, 6, 0]],
                        uv=uv, material=material)


def _image(seed, h, w, scale=(1.0, 1.0, 1.0)):
    rs = np.random.RandomState(seed)
    return (rs.rand(h, w, 3) * np.asarray(scale)).astype(np.float32)


def config3_scene(sc, tf, tx):
    """BASELINE config 3's families: a checkerboard floor and an imagemap
    floor side by side, a smooth and a rough glass sphere, an env map and a
    point light."""
    b = sc.SceneBuilder()
    uv = [[0, 0], [1, 0], [1, 1], [0, 1]]
    chk = b.textures.add(tx.TEX_CHECKER, c1=(0.8, 0.7, 0.6), c2=(0.2, 0.3, 0.1),
                         map2d=(6.0, 6.0, 0.0, 0.0))
    img = b.textures.add(tx.TEX_IMAGEMAP, c1=(1.0, 1.0, 1.0),
                         image=_image(5, 16, 16),
                         fparams=(0.0, 8.0, float(tx.WRAP_REPEAT), 0.0),
                         map2d=(2.0, 2.0, 0.0, 0.0))
    _floor(b, b.add_material(sc.MAT_MATTE, kd=(0.5, 0.5, 0.5), kd_tex=chk),
           x1=0.0, uv=uv)
    _floor(b, b.add_material(sc.MAT_MATTE, kd=(0.5, 0.5, 0.5), kd_tex=img),
           x0=0.0, uv=uv)
    smooth = b.add_material(sc.MAT_GLASS, kr=(1.0, 1.0, 1.0), kt=(1.0, 1.0, 1.0),
                            eta=1.5, roughness=0.0)
    rough = b.add_material(sc.MAT_GLASS, kr=(0.9, 0.9, 0.9), kt=(0.9, 0.9, 0.9),
                           eta=1.5, roughness=0.1)
    b.add_sphere(tf.translate(-1.2, 0.0, 1.0), 1.0, material=smooth)
    b.add_sphere(tf.translate(1.3, 0.5, 0.9), 0.9, material=rough)
    b.add_infinite_light(L=(1.0, 1.0, 1.0), image=_image(6, 8, 16, (1.0, 1.5, 2.0)),
                         world_to_light=tf.rotate(30.0, 1.0, 1.0, 0.0).m)
    b.add_point_light(tf.translate(1.0, -3.0, 5.0), (20.0, 20.0, 20.0))
    return b


def classic_scene(sc, tf, tx):
    """pbrt-v3's classic set: a substrate floor, a translucent wall, metal,
    uber at opacity 0.5 and a matte/metal mix; spot, distant, projection
    and goniometric lights."""
    from pbrt_tpu_torch.core.sampled_spectrum import copper_eta_k_rgb

    eta, k = copper_eta_k_rgb()
    b = sc.SceneBuilder()
    b.add_distant_light(np.float32([-1.0, -0.6, 2.0]), (1.2, 1.1, 0.9))
    b.add_spot_light(tf.translate(0, -2, 6) @ tf.rotate(180, 1, 0, 0),
                     (40.0, 36.0, 30.0), cone_angle_deg=40.0, cone_delta_deg=10.0)
    b.add_projection_light(tf.translate(2, -2, 6) @ tf.rotate(180, 1, 0, 0),
                           (50.0, 50.0, 50.0), fov_deg=60.0,
                           image=_image(7, 8, 8, (1.0, 0.8, 0.6)))
    b.add_gonio_light(tf.translate(-3, -3, 5), (25.0, 25.0, 25.0),
                      image=_image(8, 8, 16))
    _floor(b, b.add_material(sc.MAT_SUBSTRATE, kd=(0.5, 0.5, 0.7),
                             ks=(0.3, 0.3, 0.3), urough=0.05, vrough=0.2))
    wall = b.add_material(sc.MAT_TRANSLUCENT, kd=(0.6, 0.5, 0.4), ks=(0.2, 0.2, 0.2),
                          kr=(0.5, 0.5, 0.5), kt=(0.5, 0.5, 0.5), roughness=0.1)
    b.add_triangle_mesh([[0, 1, 2], [2, 3, 0]],
                        [[-6, 3, 0], [6, 3, 0], [6, 3, 6], [-6, 3, 6]],
                        material=wall)
    metal = b.add_material(sc.MAT_METAL, metal_eta=eta, metal_k=k, roughness=0.05)
    b.add_sphere(tf.translate(1.6, -0.5, 0.8), 0.8, material=metal)
    uber = b.add_material(sc.MAT_UBER, kd=(0.6, 0.3, 0.2), ks=(0.2, 0.2, 0.2),
                          kr=(0.1, 0.1, 0.1), kt=(0.0, 0.0, 0.0), roughness=0.1,
                          opacity=(0.5, 0.5, 0.5))
    b.add_sphere(tf.translate(-1.6, -0.5, 0.8), 0.8, material=uber)
    mixa = b.add_material(sc.MAT_MATTE, kd=(0.2, 0.6, 0.3))
    mixb = b.add_material(sc.MAT_METAL, metal_eta=eta, metal_k=k, roughness=0.05)
    mix = b.add_material(sc.MAT_MIX, mix_m1=mixa, mix_m2=mixb,
                         mix_amount=(0.3, 0.3, 0.3))
    b.add_sphere(tf.translate(0.0, 1.0, 0.7), 0.7, material=mix)
    return b


def advanced_scene(sc, tf, tx):
    """pbrt-v3's remaining materials: a fourier floor, disney and hair
    spheres, a subsurface "Skin1" sphere and a kdsubsurface one (its
    coefficients inverted from Kd 0.8, 0.55, 0.45 and mfp 0.05 on the host,
    as the scene file's reader inverts them), under a point light."""
    b = sc.SceneBuilder()
    b.add_point_light(tf.translate(1.0, -4.0, 6.0), (40.0, 40.0, 40.0))
    _floor(b, b.add_material(sc.MAT_FOURIER, fourier_file=str(FOURIER)))
    b.add_sphere(tf.translate(1.8, -1.0, 0.7), 0.7, material=b.add_material(
        sc.MAT_DISNEY, kd=(0.3, 0.5, 0.8), roughness=0.3, eta=1.5,
        remap_roughness=False,
        disney=(0.3, 0.0, 0.0, 0.3, 0.5, 0.5, 1.0, 0.2, 0.0, 1.0, 0.0, 0.0)))
    b.add_sphere(tf.translate(-1.8, -1.0, 0.7), 0.7, material=b.add_material(
        sc.MAT_HAIR, eta=1.55,
        hair=tuple((1.3 * np.array([0.419, 0.697, 1.37])).tolist()) + (0.3, 0.3, 2.0)))
    surface = dict(kr=(1.0,) * 3, kt=(1.0,) * 3, roughness=0.0, urough=0.0,
                   vrough=0.0, eta=1.33, remap_roughness=True, ss_g=0.0)
    sig_s, sig_a = get_medium_scattering_properties("Skin1")
    b.add_sphere(tf.translate(-0.6, 1.0, 0.9), 0.9, material=b.add_material(
        sc.MAT_SUBSURFACE, ss_sigma_a=sig_a, ss_sigma_s=sig_s, ss_scale=40.0,
        **surface))
    sig_a, sig_s = tbs.subsurface_from_diffuse(
        tbs.compute_beam_diffusion_bssrdf(0.0, 1.33),
        np.float32([0.8, 0.55, 0.45]).astype(np.float64),
        np.full(3, np.float32(0.05)).astype(np.float64))
    b.add_sphere(tf.translate(1.0, 1.2, 0.6), 0.6, material=b.add_material(
        sc.MAT_SUBSURFACE, kd=(0.8, 0.55, 0.45), ss_sigma_a=tuple(sig_a.tolist()),
        ss_sigma_s=tuple(sig_s.tolist()), ss_scale=1.0, **surface))
    return b


def imaging_scene(sc, tf, tx):
    """A plastic floor, a matte and a plastic sphere, a point light and a
    constant infinite light (the environment camera's escaping rays see
    it)."""
    b = sc.SceneBuilder()
    _floor(b, b.add_material(sc.MAT_PLASTIC, kd=(0.4, 0.3, 0.2), ks=(0.4, 0.4, 0.4),
                             roughness=0.2))
    b.add_sphere(tf.translate(-1.0, 0.0, 0.9), 0.9,
                 material=b.add_material(sc.MAT_MATTE, kd=(0.6, 0.4, 0.3)))
    b.add_sphere(tf.translate(1.2, 0.5, 0.8), 0.8, material=b.add_material(
        sc.MAT_PLASTIC, kd=(0.2, 0.3, 0.5), ks=(0.5, 0.5, 0.5), roughness=0.1))
    b.add_point_light(tf.translate(1.0, -3.0, 5.0), (30.0, 30.0, 30.0))
    b.add_infinite_light(L=(0.2, 0.25, 0.3))
    return b


SCENES = {"config3": config3_scene, "classic": classic_scene,
          "advanced": advanced_scene, "imaging": imaging_scene}


def make_camera(kind: str, tf, makers: dict):
    """The group's camera, 12x12, from a package's transform module and its
    camera constructors (makers, keyed by kind): perspective (fov 45),
    orthographic (screen +-4, a thin lens of radius 0.1 focused at 8),
    environment (from (0, 0, 1.5)), or realistic (the built-in 50 mm lens
    focused at 8)."""
    c2w = tf.look_at(*LOOK)
    make = makers[kind]
    if kind == "perspective":
        return make(c2w, RES, fov_deg=45.0)
    if kind == "orthographic":
        return make(c2w, RES, screen=(-4.0, 4.0, -4.0, 4.0), lens_radius=0.1,
                    focal_distance=8.0)
    if kind == "environment":
        return make(tf.translate(0.0, 0.0, 1.5), RES)
    return make(c2w, RES, focus_distance=8.0)


PORT_CAMERAS = {"perspective": tcam.make_perspective_camera,
                "orthographic": tcam.make_orthographic_camera,
                "environment": tcam.make_environment_camera,
                "realistic": treal.make_realistic_camera}


def weights():
    return np.random.RandomState(7).uniform(
        0.5, 1.5, (RES[0] * RES[1], 3)).astype(np.float32)


def pixels():
    return torch.as_tensor(tpath.make_pixel_grid(tfm.FilmConfig(full_resolution=RES)))


@functools.lru_cache(maxsize=None)
def port_scene(group: str):
    """The group's scene built by the port's SceneBuilder, on the CPU."""
    return SCENES[group](tsc, ttf, ttx).build(device="cpu")


def port_camera(kind: str):
    return make_camera(kind, ttf, PORT_CAMERAS)


def group_case(group: str, kind: str = "perspective", sampler: str = "halton"):
    """(scene, camera, sampler config, path config, param names) of one
    case: the realistic camera without its "camera" leaves."""
    names = NO_CAMERA if kind == "realistic" else diff.DEFAULT_PARAMS
    return (port_scene(group), port_camera(kind), TSampler(sampler, 4, RES),
            tpath.PathConfig(max_depth=DEPTH), names)


def device_step(case, device, remat=True):
    """One case's step on `device` (the scene built there): (L, flat
    leaves as tensors), both on the CPU."""
    group, kind, sampler = case
    scene = SCENES[group](tsc, ttf, ttx).build(device=device)
    names = NO_CAMERA if kind == "realistic" else diff.DEFAULT_PARAMS
    L, g = diff.render_grad_step(scene, port_camera(kind), pixels().to(device),
                                 SAMPLE, torch.as_tensor(weights(), device=device),
                                 TSampler(sampler, 4, RES),
                                 tpath.PathConfig(max_depth=DEPTH),
                                 param_names=names, remat=remat, device=device)
    return L.cpu(), {k: torch.as_tensor(v) for k, v in flat_leaves(g).items()}


def step(scene, camera, scfg, pcfg, names, remat=True, params=None):
    """render_grad_step on the CPU at SAMPLE with the seeded weights;
    params: values put in first (diff.apply_params), or None."""
    if params is not None:
        scene, camera = diff.apply_params(scene, camera, params)
    return diff.render_grad_step(scene, camera, pixels(), SAMPLE,
                                 torch.as_tensor(weights()), scfg, pcfg,
                                 param_names=names, remat=remat, device="cpu")


def forward(scene, camera, scfg, pcfg):
    with torch.no_grad():
        return diff.render_batch_radiance(scene, camera, pixels(), SAMPLE, scfg,
                                          pcfg)


def flat_leaves(g) -> dict:
    """{name: numpy} of every leaf, the camera's as camera.<leaf>."""
    out = {}
    for k, v in g.items():
        if k == "camera":
            out.update({f"camera.{c}": x.detach().cpu().numpy()
                        for c, x in v.items()})
        else:
            out[k] = v.detach().cpu().numpy()
    return out


def _cases():
    return ([("config3", "perspective", "halton"),
             ("classic", "perspective", "halton"),
             ("advanced", "perspective", "halton")]
            + [("imaging", c, s) for c, s in IMAGING])


def _id(case):
    return "-".join(case)


@functools.lru_cache(maxsize=None)
def _steps(case):
    """(L with remat, grads with remat, L without, grads without, forward
    L) of one case; the random sampler only without remat."""
    scene, camera, scfg, pcfg, names = group_case(*case)
    Lf = forward(scene, camera, scfg, pcfg)
    L0, g0 = step(scene, camera, scfg, pcfg, names, remat=False)
    if scfg.name == "random":
        return None, None, L0, g0, Lf
    L1, g1 = step(scene, camera, scfg, pcfg, names, remat=True)
    return L1, g1, L0, g0, Lf


@pytest.mark.parametrize("case", _cases(), ids=_id)
def test_step_runs_with_finite_leaves_and_the_forward_L(case):
    """The step runs on every family, its L is the no-grad forward's bit
    for bit, and every leaf is finite and some non-zero."""
    L1, g1, L0, g0, Lf = _steps(case)
    assert torch.isfinite(Lf).all() and float(Lf.abs().sum()) > 0
    for L, g in ((L1, g1), (L0, g0)):
        if L is None:
            continue
        assert torch.equal(L, Lf)
        leaves = flat_leaves(g)
        for name, v in leaves.items():
            assert np.isfinite(v).all(), name
        assert max(float(np.abs(v).max()) for v in leaves.values()) > 0


@pytest.mark.parametrize("case", [c for c in _cases() if c[2] != "random"],
                         ids=_id)
def test_remat_matches_no_remat(case):
    """Path replay changes no leaf beyond rtol 1e-4 (tests/test_grad.py:
    189-204's tolerance), atol 1e-4 of the leaf's largest entry."""
    L1, g1, L0, g0, _ = _steps(case)
    assert torch.equal(L1, L0)
    a, b = flat_leaves(g1), flat_leaves(g0)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-4,
                                   atol=1e-4 * np.abs(b[k]).max() + 1e-8,
                                   err_msg=k)


@pytest.mark.parametrize("group", ["config3", "classic", "advanced"])
def test_replayed_bounces_launch_the_forward_batches(group):
    """A remat step launches the forward's batches (the camera's, then
    each bounce's: advanced's 7 are its NEE, 4 probe segments, the exit
    point's NEE and the next closest hit), then replays each bounce but the
    last, last first: every replayed launch's (o, d, t_max, mode, order)
    equals its forward launch's bit for bit, the probe walk's segments
    too, and the step's counters are the forward's, added once."""
    scene, camera, scfg, pcfg, names = group_case(group)
    counters = st.zeros("cpu")
    with bvh.record_calls() as fwd:
        with torch.no_grad():
            diff.render_batch_radiance(scene, camera, pixels(), SAMPLE, scfg,
                                       pcfg, counters=counters)
    step_counters = st.zeros("cpu")
    with bvh.record_calls() as calls:
        diff.render_grad_step(scene, camera, pixels(), SAMPLE,
                              torch.as_tensor(weights()), scfg, pcfg,
                              param_names=names, device="cpu",
                              counters=step_counters)
    n = len(fwd)
    k = (n - 1) // DEPTH  # launches a bounce
    assert n == 1 + DEPTH * k and k == (3 + pcfg.ss_probe_depth
                                        if group == "advanced" else 1)
    # the replay of a bounce stops once the backward has what it needs
    # (torch.utils.checkpoint's early stop): with subsurface, before the
    # next bounce's closest hit, the body's last launch
    per = (len(calls) - n) // DEPTH
    assert len(calls) == n + DEPTH * per
    assert per == (2 + pcfg.ss_probe_depth if group == "advanced" else 1)
    replay = [fwd[1 + b * k + i] for b in reversed(range(DEPTH)) for i in range(per)]
    for got, ref in zip(calls, fwd + replay):
        assert _same(got, ref)
    assert torch.equal(step_counters, counters)


def _same(a, b):
    """Two recorded launches, bit for bit (order may be None)."""
    return len(a) == len(b) and all(
        (x is None and y is None) or (x is not None and y is not None
                                      and x.shape == y.shape and torch.equal(x, y))
        for x, y in zip(a, b))


# ---- the port's AD against its central differences ----

def _pose(idx):
    def perturb(scene, camera, e):
        m = camera.camera_to_world.clone()
        m[idx] += e
        return scene, dataclasses.replace(camera, camera_to_world=m)
    return perturb, lambda g: g["camera"]["camera_to_world"][idx]


def _fov(fov0=45.0):
    """raster_to_camera moved along d/dfov of perspective_raster_to_camera
    (tests/test_torch_grad.py's fov case): the AD side is the leaf's
    gradient dotted with that direction."""
    def perturb(scene, camera, e):
        return scene, dataclasses.replace(
            camera, raster_to_camera=perspective_raster_to_camera(fov0 + e, RES))
    _, d_r = torch.autograd.functional.jvp(
        lambda f: perspective_raster_to_camera(f, RES), torch.tensor(fov0),
        torch.tensor(1.0))
    return perturb, lambda g: torch.sum(g["camera"]["raster_to_camera"] * d_r)


def _material(key, idx):
    def perturb(scene, camera, e):
        v = getattr(scene.materials, key).clone()
        v[idx] += e
        return dataclasses.replace(scene, materials=dataclasses.replace(
            scene.materials, **{key: v})), camera
    return perturb, lambda g: g[key][idx]


# (group, leaf, entry): (perturbation and AD side, eps, rtol), at
# tests/test_grad.py's eps and rtol (the camera pose's, the fov's,
# roughness's), for the leaves the JAX package's step gives non-finite on
# these scenes (tests/test_torch_grad_config3.py, _classic.py,
# _advanced.py): the rough glass's roughness (row 3), metal's (row 2),
# disney's (row 1)
FD_CASES = {
    ("config3", "camera.camera_to_world", "0,3"): (_pose((0, 3)), 5e-2, 0.05),
    ("config3", "camera.camera_to_world", "2,3"): (_pose((2, 3)), 5e-2, 0.05),
    ("config3", "camera.raster_to_camera", "fov"): (_fov(), 0.05, 0.05),
    ("config3", "roughness", "3"): (_material("roughness", (3,)), 5e-3, 0.05),
    # the metal sphere's 0.05-roughness lobe bends the render within 5e-2
    # of camera motion (one lane: 5.72 by central differences at 5e-2,
    # 8.02 at 5e-3, 8.04 by AD), so the pose is stepped by 5e-3 here
    ("classic", "camera.camera_to_world", "0,3"): (_pose((0, 3)), 5e-3, 0.05),
    ("classic", "camera.raster_to_camera", "fov"): (_fov(), 0.05, 0.05),
    ("classic", "roughness", "2"): (_material("roughness", (2,)), 5e-3, 0.05),
    ("advanced", "camera.camera_to_world", "0,3"): (_pose((0, 3)), 5e-2, 0.05),
    ("advanced", "camera.raster_to_camera", "fov"): (_fov(), 0.05, 0.05),
    ("advanced", "roughness", "1"): (_material("roughness", (1,)), 5e-3, 0.05),
}


def fd_against_ad(group, perturb, ad_of, eps):
    """(AD, FD, the lanes' summed |FD|, share of smooth lanes) of one
    direction at depth 2.  A lane is smooth at eps when its two one-sided
    differences agree (within 10% of their sizes plus float32 noise): a
    lane whose hit, lobe or texel changes between the three renders is
    left out of both sides (its weight 0 in the step and in the sum)."""
    scene, camera, scfg, pcfg, names = group_case(group)
    scene, camera = perturb(scene, camera, 0.0)
    w = torch.as_tensor(weights())
    L0 = forward(scene, camera, scfg, pcfg)
    Lp = forward(*perturb(scene, camera, eps), scfg, pcfg)
    Lm = forward(*perturb(scene, camera, -eps), scfg, pcfg)
    sp, sm = (Lp - L0) / eps, (L0 - Lm) / eps
    noise = 1e-5 * (L0.abs() + 1e-2) / eps
    smooth = torch.all((sp - sm).abs() <= 0.1 * (sp.abs() + sm.abs()) + noise, -1)
    _, g = diff.render_grad_step(scene, camera, pixels(), SAMPLE,
                                 w * smooth[:, None], scfg, pcfg,
                                 param_names=names, device="cpu")
    lanes = torch.sum(w * smooth[:, None] * (Lp - Lm), -1) / (2 * eps)
    return (float(ad_of(g)), float(lanes.sum()), float(lanes.abs().sum()),
            float(smooth.float().mean()))


@pytest.mark.parametrize("case", list(FD_CASES), ids=lambda c: "-".join(c))
def test_port_ad_matches_central_differences(case):
    """Where the JAX package's leaf is non-finite, the port's is held
    against its own central differences over the lanes smooth at eps.
    The lanes' sum can cancel (advanced, camera_to_world[0,3]: rows of
    +0.50, -0.27 and -0.21), so the bar is rtol of the larger of |AD|,
    |FD| and the lanes' summed |FD|."""
    (perturb, ad_of), eps, rtol = FD_CASES[case]
    ad, fd, scale, frac = fd_against_ad(case[0], perturb, ad_of, eps)
    assert frac >= 0.3 and scale > 1e-3, (frac, scale)
    assert abs(ad - fd) <= rtol * max(abs(ad), abs(fd), scale), (ad, fd, scale)


def assert_step_runs(scene, camera, res):
    """A grad step (halton, sample 0, depth 1) on a small one-family scene
    runs, its L is the no-grad forward's bit for bit and every leaf is
    finite."""
    pix = torch.as_tensor(tpath.make_pixel_grid(tfm.FilmConfig(full_resolution=res)))
    scfg, pcfg = TSampler("halton", 1, res), tpath.PathConfig(max_depth=1)
    L, g = diff.render_grad_step(scene, camera, pix, 0,
                                 torch.ones((pix.shape[0], 3)), scfg, pcfg,
                                 device="cpu")
    with torch.no_grad():
        ref = diff.render_batch_radiance(scene, camera, pix, 0, scfg, pcfg)
    assert torch.equal(L, ref)
    for name, v in flat_leaves(g).items():
        assert np.isfinite(v).all(), name
