"""Graphics-state machine: .pbrt directives -> SceneBuilder + render config.

Port of pbrt_tpu/sceneio/api.py (pbrt-v3 core/api.cpp) for what the path
and direct-lighting integrators render:

* the options/world phases, the CTM and its stacks, named coordinate
  systems (api.cpp:899-1186);
* ``Camera "perspective"`` and ``"orthographic"`` (with ``lensradius``/
  ``focaldistance``), ``"environment"`` and ``"realistic"`` (``lensfile``,
  resolved against the scene file's directory, ``filmdiag``,
  ``focusdistance``), the image film, the box, triangle, gaussian, mitchell
  and sinc filters with their parameters, the halton, sobol, random,
  stratified, zerotwosequence ("lowdiscrepancy") and maxmin ("maxmindist")
  samplers, ``Integrator "path"`` and ``"directlighting"``;
* matte, plastic, mirror, glass, metal (copper by default), substrate,
  uber, translucent, mix, disney, hair, fourier (a .bsdf file beside the
  scene), subsurface (its own coefficients or a measured "name") and
  kdsubsurface materials, named materials and the default matte
  material; Kd, Ks, matte's sigma, plastic's roughness, uber's opacity
  and disney's color bind to textures, as the JAX package binds them;
* ``Texture``: constant, scale, mix, checkerboard (2D), uv, bilerp, fbm,
  wrinkled, windy, marble, dots and imagemap, with uv mapping;
* point, spot, distant, projection and goniometric lights, infinite
  lights (constant or with ``mapname``) and diffuse area lights on
  triangle meshes and spheres;
* every pbrt-v3 shape: ``trianglemesh``, ``plymesh``, the six quadrics
  (``sphere``, ``disk``, ``cylinder``, ``cone``, ``paraboloid``,
  ``hyperboloid``), ``heightfield``, ``loopsubdiv`` and ``nurbs`` (made
  into triangle meshes on the host) and cubic Bezier ``curve``s (flat,
  ribbon, cylinder); ``ObjectBegin``/``ObjectEnd``/``ObjectInstance``
  (mesh shapes shared by the instances, quadrics and curves made again
  under each instance's transform);
* spectra given as rgb/color, ``spectrum`` (pairs or an .spd file) or
  ``blackbody`` (sceneio/paramset.py);
* ``MakeNamedMedium`` (homogeneous and heterogeneous) and
  ``MediumInterface``: in the options block it sets the camera's medium,
  in the world block the media of the shapes that follow (non-emissive
  trianglemeshes and spheres, cones, paraboloids and hyperboloids, as in
  the JAX package: a plymesh, a disk, a cylinder, a mesh shape made on the
  host, a curve or an emissive shape gets none);
* ``Integrator "volpath"``, ``"whitted"`` and ``"ao"``.

Everything else raises NotImplementedError naming what is missing: other
lights, materials, medium types, texture classes and mappings, and
kd-trees.  Unlike the JAX package, nothing degrades to a stand-in: a
missing image or lens file raises, and so do a mix naming an unknown or a
mix material, a spot light's "from" or "to" (which the JAX package does not
read), a fourier material without "bsdffile", a subsurface "name" the
measured table lacks, an area light on a shape other than a trianglemesh
or a sphere or on a mesh inside an object, a curve of another degree or
basis, a ribbon chain of several segments with more than two normals, xyz
spectra, and stratified's xsamples, ysamples and jitter.

Output: ``RenderSetup``, everything render.py needs.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import logging
import os
import time

import numpy as np

from .. import scene as sc
from ..core import transform as tf
from .paramset import ParamSet

log = logging.getLogger("pbrt_tpu_torch")

# the shapes made into triangle meshes on the host, which instancing shares
_MESH_SHAPES = ("trianglemesh", "plymesh", "loopsubdiv", "heightfield", "nurbs")
_SHAPES = ("trianglemesh", "sphere", "disk", "cylinder", "cone", "paraboloid",
           "hyperboloid", "loopsubdiv", "heightfield", "plymesh", "curve",
           "nurbs")


def heightfield_mesh(nu: int, nv: int, pz):
    """Shape "heightfield" (heightfield.cpp, pbrt_tpu/sceneio/api.py:
    841-864): nu x nv heights over the unit square, two triangles a cell.
    Returns (indices, P, uv)."""
    xs, ys = np.meshgrid(np.linspace(0, 1, nu), np.linspace(0, 1, nv))
    p = np.stack([xs.ravel(), ys.ravel(), np.asarray(pz)], -1)
    qi, qj = np.meshgrid(np.arange(nu - 1), np.arange(nv - 1), indexing="xy")
    v00 = (qj * nu + qi).ravel()
    v10 = v00 + 1
    v01 = v00 + nu
    v11 = v01 + 1
    idx = np.concatenate([np.stack([v00, v10, v11], -1),
                          np.stack([v00, v11, v01], -1)])
    return idx, p, np.stack([xs.ravel(), ys.ravel()], -1)


@dataclasses.dataclass
class RenderSetup:
    scene_builder: sc.SceneBuilder
    camera_name: str = "perspective"
    camera_params: ParamSet = None
    camera_to_world: tf.Transform = None
    film_name: str = "image"
    film_params: ParamSet = None
    sampler_name: str = "halton"
    sampler_params: ParamSet = None
    integrator_name: str = "path"
    integrator_params: ParamSet = None
    filter_name: str = "box"
    filter_params: ParamSet = None

    cwd: str = "."  # the scene file's directory
    _scene_cache: object = None

    def build_scene(self, device="cuda"):
        """SceneArrays on `device` (the card unless the caller asks for the
        CPU), built once."""
        device = sc.resolve_device(device)
        if self._scene_cache is None or self._scene_cache.device != device:
            self._scene_cache = self.scene_builder.build(device=device)
        return self._scene_cache

    @property
    def resolution(self):
        p = self.film_params or ParamSet()
        return (p.find_one_int("xresolution", 1280),
                p.find_one_int("yresolution", 720))

    def make_camera(self):
        """The scene's camera: perspective, orthographic, environment or
        realistic, with the JAX package's parameters (api.py:57-107)."""
        from .. import cameras

        p = self.camera_params or ParamSet()
        c2w = self.camera_to_world or tf.identity()
        shutter = dict(shutter_open=p.find_one_float("shutteropen", 0.0),
                       shutter_close=p.find_one_float("shutterclose", 1.0))
        lens = dict(lens_radius=p.find_one_float("lensradius", 0.0),
                    focal_distance=p.find_one_float("focaldistance", 1e6))
        if self.camera_name == "perspective":
            return cameras.make_perspective_camera(
                c2w, self.resolution, fov_deg=p.find_one_float("fov", 90.0),
                **lens, **shutter)
        if self.camera_name == "orthographic":
            return cameras.make_orthographic_camera(c2w, self.resolution,
                                                    **lens, **shutter)
        if self.camera_name == "environment":
            return cameras.make_environment_camera(c2w, self.resolution, **shutter)
        if self.camera_name == "realistic":
            lens_data = None
            lf = p.find_one_string("lensfile", "")
            if lf:
                path = lf if os.path.isabs(lf) else os.path.join(self.cwd, lf)
                try:
                    lens_data = np.loadtxt(path, comments="#")
                except (OSError, ValueError) as e:
                    raise NotImplementedError(
                        f"lensfile {lf!r} cannot be read ({e}); the JAX "
                        "package falls back to a 50 mm double Gauss") from e
            return cameras.make_realistic_camera(
                c2w, self.resolution, lens_data=lens_data,
                film_diag_mm=p.find_one_float("filmdiag", 35.0),
                focus_distance=p.find_one_float("focusdistance", 10.0), **shutter)
        raise NotImplementedError(
            f"camera {self.camera_name!r}: the port has 'perspective', "
            "'orthographic', 'environment' and 'realistic'")

    def make_film_config(self):
        from ..film import FilmConfig
        from ..filters import make_filter

        p = self.film_params or ParamSet()
        fp = self.filter_params or ParamSet()
        filt = make_filter(self.filter_name,
                           {k: fp.find_one_float(k, 0.0) for k in fp.keys()})
        crop = p.find_floats("cropwindow")
        cfg = FilmConfig(
            full_resolution=self.resolution,
            crop_window=tuple(crop) if crop is not None else (0.0, 1.0, 0.0, 1.0),
            filter_name=self.filter_name,
            filter_radius=filt.radius,
            scale=p.find_one_float("scale", 1.0),
            max_sample_luminance=p.find_one_float("maxsampleluminance",
                                                  float("inf")),
        )
        return cfg, filt

    def make_sampler_config(self):
        """PBRT_TPU_EXACT_SAMPLER=1 turns on the exact tables for halton and
        the PixelSamplers (api.py:130-151); "lowdiscrepancy" is read as
        "zerotwosequence"."""
        from ..samplers.exact_tables import PIXEL_EXACT_SAMPLERS
        from ..samplers.samplers import SamplerConfig

        p = self.sampler_params or ParamSet()
        name = {"lowdiscrepancy": "zerotwosequence", "maxmindist": "maxmin"}.get(
            self.sampler_name, self.sampler_name)
        if name == "stratified":
            given = [k for k in ("xsamples", "ysamples", "jitter") if k in p.keys()]
            if given:
                raise NotImplementedError(
                    f"stratified sampler {given}: the port draws pixelsamples "
                    "jittered strata as the JAX package does, which ignores "
                    "these")
        exact = (os.environ.get("PBRT_TPU_EXACT_SAMPLER", "0") == "1"
                 and (name == "halton" or name in PIXEL_EXACT_SAMPLERS))
        return SamplerConfig(name, p.find_one_int("pixelsamples", 16),
                             self.resolution, exact=exact)

    def make_integrator_config(self):
        """PathConfig for "path" and "volpath", DirectLightingConfig for
        "directlighting" (maxdepth; strategy, by default "all") and
        "whitted" (maxdepth), AOConfig for "ao" (cossample, nsamples),
        BDPTConfig, MLTConfig and SPPMConfig for "bdpt", "mlt" and "sppm";
        the JAX package's parameters and defaults (render.py:55-153)."""
        from ..integrators.path import PathConfig

        p = self.integrator_params or ParamSet()
        if self.integrator_name in ("directlighting", "whitted"):
            from ..integrators.direct import DirectLightingConfig

            if self.integrator_name == "whitted":
                return DirectLightingConfig(max_depth=p.find_one_int("maxdepth", 5))
            return DirectLightingConfig(
                max_depth=p.find_one_int("maxdepth", 5),
                strategy=p.find_one_string("strategy", "all"))
        if self.integrator_name == "ao":
            from ..integrators.ao import AOConfig

            return AOConfig(cos_sample=p.find_one_bool("cossample", True),
                            n_samples=p.find_one_int("nsamples", 64))
        if self.integrator_name == "bdpt":
            from ..integrators.bdpt import BDPTConfig

            return BDPTConfig(max_depth=p.find_one_int("maxdepth", 5))
        if self.integrator_name == "mlt":
            from ..integrators.mlt import MLTConfig

            return MLTConfig(
                max_depth=p.find_one_int("maxdepth", 5),
                n_bootstrap=p.find_one_int("bootstrapsamples", 4096),
                n_chains=p.find_one_int("chains", 1024),
                mutations_per_pixel=p.find_one_int("mutationsperpixel", 4),
                sigma=p.find_one_float("sigma", 0.01),
                large_step_prob=p.find_one_float("largestepprobability", 0.3))
        if self.integrator_name == "sppm":
            from ..integrators.sppm import SPPMConfig

            return SPPMConfig(
                max_depth=p.find_one_int("maxdepth", 5),
                n_iterations=p.find_one_int("numiterations",
                                            p.find_one_int("iterations", 16)),
                photons_per_iteration=p.find_one_int("photonsperiteration", -1),
                initial_radius=p.find_one_float("radius", 1.0))
        return PathConfig(
            max_depth=p.find_one_int("maxdepth", 5),
            rr_threshold=p.find_one_float("rrthreshold", 1.0),
            light_strategy=p.find_one_string("lightsamplestrategy", "spatial"),
        )


@dataclasses.dataclass
class _GraphicsState:
    material: int = -1  # index into builder.materials
    area_light: ParamSet | None = None
    reverse_orientation: bool = False
    named_materials: dict = dataclasses.field(default_factory=dict)
    float_textures: dict = dataclasses.field(default_factory=dict)
    spectrum_textures: dict = dataclasses.field(default_factory=dict)
    medium_inside: int = -1  # rows of the builder's medium table, -1 none
    medium_outside: int = -1


class PbrtApi:
    """The state of one parse.  Method names are snake_cased directives."""

    def __init__(self):
        self.setup = RenderSetup(scene_builder=sc.SceneBuilder())
        self.ctm = tf.identity()
        self.named_coordinate_systems: dict = {}
        self.ctm_stack: list = []
        self.gs = _GraphicsState()
        self.gs_stack: list = []
        self.cwd = "."
        self.in_world = False
        self.named_media: dict = {}
        self.objects: dict = {}  # name -> [(shape, params, o2w, material, gs)]
        self.current_object = None
        self._mesh_templates: dict = {}
        # Default material: matte (api.cpp GraphicsState constructor).
        self.gs.material = self.setup.scene_builder.add_material(
            sc.MAT_MATTE, kd=(0.5, 0.5, 0.5))

    # ---- transforms (api.cpp:899-1019) ----
    def identity(self):
        self.ctm = tf.identity()

    def translate(self, x, y, z):
        self.ctm = self.ctm @ tf.translate(x, y, z)

    def scale(self, x, y, z):
        self.ctm = self.ctm @ tf.scale(x, y, z)

    def rotate(self, a, x, y, z):
        self.ctm = self.ctm @ tf.rotate(a, x, y, z)

    def look_at(self, *v):
        la = tf.look_at(v[0:3], v[3:6], v[6:9])
        self.ctm = self.ctm @ la.inverse

    def transform(self, *m):
        self.ctm = tf.from_matrix(np.asarray(m).reshape(4, 4).T)

    def concat_transform(self, *m):
        self.ctm = self.ctm @ tf.from_matrix(np.asarray(m).reshape(4, 4).T)

    def transform_times(self, start, end):
        pass  # shutter times of animated transforms; nothing is animated

    def active_transform(self, which):
        if which != "All":
            raise NotImplementedError(
                f"ActiveTransform {which}: animated transforms are not ported")

    def coordinate_system(self, name, params=None):
        self.named_coordinate_systems[name] = self.ctm

    def coord_sys_transform(self, name, params=None):
        if name in self.named_coordinate_systems:
            self.ctm = self.named_coordinate_systems[name]

    # ---- options directives ----
    def camera(self, name, params):
        self.setup.camera_name = name
        self.setup.camera_params = ParamSet.from_decls(params, self.cwd)
        self.setup.camera_to_world = self.ctm.inverse
        self.named_coordinate_systems["camera"] = self.ctm.inverse

    def film(self, name, params):
        self.setup.film_name = name
        self.setup.film_params = ParamSet.from_decls(params, self.cwd)

    def sampler(self, name, params):
        self.setup.sampler_name = name
        self.setup.sampler_params = ParamSet.from_decls(params, self.cwd)

    def integrator(self, name, params):
        self.setup.integrator_name = name
        self.setup.integrator_params = ParamSet.from_decls(params, self.cwd)

    def filter(self, name, params):
        self.setup.filter_name = name
        self.setup.filter_params = ParamSet.from_decls(params, self.cwd)

    pixel_filter = filter

    def accelerator(self, name, params):
        # MakeAccelerator (api.cpp:770): "bvh" (the default) or "kdtree";
        # the JAX package takes any other name as "bvh" (api.py:259-263)
        self.setup.scene_builder.accelerator = name if name in (
            "bvh", "kdtree") else "bvh"

    # ---- world block ----
    def world_begin(self):
        self.in_world = True
        self.ctm = tf.identity()
        self.named_coordinate_systems["world"] = self.ctm

    def world_end(self):
        pass

    def attribute_begin(self):
        self.gs_stack.append(copy.deepcopy(self.gs))
        self.ctm_stack.append(self.ctm)

    def attribute_end(self):
        self.gs = self.gs_stack.pop()
        self.ctm = self.ctm_stack.pop()

    def transform_begin(self):
        self.ctm_stack.append(self.ctm)

    def transform_end(self):
        self.ctm = self.ctm_stack.pop()

    def reverse_orientation(self):
        self.gs.reverse_orientation = not self.gs.reverse_orientation

    # ---- textures (api.cpp:1058-1093) ----
    def texture(self, name, ttype, tclass, params):
        """The texture row is made at declaration, so children precede
        their parents in the table."""
        tid = self._make_texture(tclass, ParamSet.from_decls(params, self.cwd))
        if ttype == "float":
            self.gs.float_textures[name] = tid
        else:
            self.gs.spectrum_textures[name] = tid

    def _texture_id(self, tname, float_first=False):
        tables = (self.gs.float_textures, self.gs.spectrum_textures)
        for table in (tables if float_first else tables[::-1]):
            if tname in table:
                return table[tname]
        raise ValueError(f"texture {tname!r} was never declared")

    def _tex_child(self, ps: ParamSet, pname, default):
        """A texture-or-constant parameter as (child id, constant rgb)."""
        tname = ps.find_texture(pname)
        if tname is not None:
            return self._texture_id(tname), np.zeros(3, np.float32)
        return -1, ps.find_one_spectrum(pname, default)

    def _make_texture(self, tclass, ps: ParamSet) -> int:
        from ..textures import textures as tx
        from ..utils.imageio import read_image

        tt = self.setup.scene_builder.textures
        mapping = ps.find_one_string("mapping", "uv")
        if mapping != "uv":
            raise NotImplementedError(
                f'texture mapping {mapping!r}: the port has "uv"')
        if ps.find_one_int("dimension", 2) != 2:
            raise NotImplementedError("3D checkerboards are not ported")
        map2d = (ps.find_one_float("uscale", 1.0),
                 ps.find_one_float("vscale", 1.0),
                 ps.find_one_float("udelta", 0.0),
                 ps.find_one_float("vdelta", 0.0))
        w2t = self.ctm.m_inv  # world to texture space (TextureMapping3D)
        if tclass == "constant":
            return tt.add(tx.TEX_CONSTANT, c1=ps.find_one_spectrum("value", 1.0))
        if tclass in ("scale", "mix", "checkerboard"):
            ttype = {"scale": tx.TEX_SCALE, "mix": tx.TEX_MIX,
                     "checkerboard": tx.TEX_CHECKER}[tclass]
            defaults = {"scale": (1.0, 1.0), "mix": (0.0, 1.0),
                        "checkerboard": (1.0, 0.0)}[tclass]
            c1id, c1 = self._tex_child(ps, "tex1", defaults[0])
            c2id, c2 = self._tex_child(ps, "tex2", defaults[1])
            kw = dict(c1=c1, c2=c2, child1=c1id, child2=c2id)
            if tclass == "mix":
                kw["fparams"] = (ps.find_one_float("amount", 0.5), 0, 0, 0)
            if tclass == "checkerboard":
                kw.update(map2d=map2d, w2t=w2t)
            return tt.add(ttype, **kw)
        if tclass == "uv":
            return tt.add(tx.TEX_UV, map2d=map2d)
        if tclass in ("fbm", "wrinkled"):
            return tt.add(tx.TEX_FBM if tclass == "fbm" else tx.TEX_WRINKLED,
                          fparams=(ps.find_one_int("octaves", 8),
                                   ps.find_one_float("roughness", 0.5), 0, 0),
                          w2t=w2t)
        if tclass == "windy":
            return tt.add(tx.TEX_WINDY, w2t=w2t)
        if tclass == "marble":
            return tt.add(tx.TEX_MARBLE, w2t=w2t, fparams=(
                ps.find_one_int("octaves", 8), ps.find_one_float("roughness", 0.5),
                ps.find_one_float("scale", 1.0),
                ps.find_one_float("variation", 0.2)))
        if tclass == "dots":
            c1id, c1 = self._tex_child(ps, "inside", 1.0)
            c2id, c2 = self._tex_child(ps, "outside", 0.0)
            return tt.add(tx.TEX_DOTS, c1=c1, c2=c2, child1=c1id, child2=c2id,
                          map2d=map2d)
        if tclass == "bilerp":
            return tt.add(tx.TEX_BILERP, c1=ps.find_one_spectrum("v00", 0.0),
                          c2=ps.find_one_spectrum("v11", 1.0), map2d=map2d)
        if tclass == "imagemap":
            fname = ps.find_one_string("filename", "")
            if not fname:
                raise ValueError('imagemap texture without "filename"')
            scale = ps.find_one_float("scale", 1.0)
            wrap_s = ps.find_one_string("wrap", "repeat")
            wraps = {"repeat": tx.WRAP_REPEAT, "black": tx.WRAP_BLACK,
                     "clamp": tx.WRAP_CLAMP}
            if wrap_s not in wraps:
                raise NotImplementedError(f"imagemap wrap {wrap_s!r}")
            return tt.add(
                tx.TEX_IMAGEMAP, c1=(scale, scale, scale), map2d=map2d,
                image=read_image(self._path(fname)),
                fparams=(1.0 if ps.find_one_bool("trilinear", False) else 0.0,
                         ps.find_one_float("maxanisotropy", 8.0),
                         float(wraps[wrap_s]), 0.0))
        raise NotImplementedError(f"texture class {tclass!r}")

    # ---- media (api.cpp:724-768, 1492-1512) ----
    def _medium_id(self, name) -> int:
        if not name:
            return -1
        if name not in self.named_media:
            raise ValueError(f"medium {name!r} was never made")
        return self.named_media[name]

    def medium_interface(self, inside, outside):
        """The media of the shapes that follow; in the options block, the
        camera's medium (the inside one)."""
        self.gs.medium_inside = self._medium_id(inside)
        self.gs.medium_outside = self._medium_id(outside)
        if not self.in_world:
            self.setup.scene_builder.camera_medium = self.gs.medium_inside

    def make_named_medium(self, name, params):
        """MakeMedium (api.cpp:724-768): homogeneous, or heterogeneous
        with its density grid filling the box p0-p1 under the CTM."""
        ps = ParamSet.from_decls(params, self.cwd)
        mtype = ps.find_one_string("type", "homogeneous")
        if mtype not in ("homogeneous", "heterogeneous"):
            raise NotImplementedError(
                f"medium type {mtype!r}: the port has homogeneous and "
                "heterogeneous")
        if ps.find_one_string("preset", ""):
            raise NotImplementedError("medium \"preset\": the named "
                                      "scattering tables are not ported")
        media = self.setup.scene_builder.media
        scale = ps.find_one_float("scale", 1.0)
        sigma_a = ps.find_one_spectrum("sigma_a", (0.0011, 0.0024, 0.014)) * scale
        sigma_s = ps.find_one_spectrum("sigma_s", (2.55, 3.21, 3.77)) * scale
        g = ps.find_one_float("g", 0.0)
        if mtype == "homogeneous":
            mid = media.add_homogeneous(sigma_a, sigma_s, g)
        else:
            density = ps.find_floats("density")
            if density is None:
                raise ValueError(f'heterogeneous medium {name!r} without "density"')
            p0 = ps.find_one_point("p0", (0, 0, 0))
            p1 = ps.find_one_point("p1", (1, 1, 1))
            # medium to world = CTM * Translate(p0) * Scale(p1 - p0)
            m2w = self.ctm @ tf.translate(*p0) @ tf.scale(*np.maximum(p1 - p0, 1e-9))
            mid = media.add_grid(sigma_a, sigma_s, g, ps.find_one_int("nx", 1),
                                 ps.find_one_int("ny", 1), ps.find_one_int("nz", 1),
                                 density, w2m=m2w.m_inv)
        self.named_media[name] = mid

    # ---- materials (api.cpp:560-640) ----
    def _path(self, fname):
        return fname if os.path.isabs(fname) else os.path.join(self.cwd, fname)

    def material(self, name, params):
        self.gs.material = self._make_material(name, ParamSet.from_decls(params, self.cwd))

    def make_named_material(self, name, params):
        ps = ParamSet.from_decls(params, self.cwd)
        mtype = ps.find_one_string("type", "matte")
        self.gs.named_materials[name] = self._make_material(mtype, ps)

    def named_material(self, name, params=None):
        if name not in self.gs.named_materials:
            raise ValueError(f"NamedMaterial {name!r} was never made")
        self.gs.material = self.gs.named_materials[name]

    def _bind(self, ps, kw, pname, key, default, spectrum=True):
        """A material parameter bound to a texture (kw[key + "_tex"], the
        constant zeroed) or given as a constant (api.py:435-454)."""
        tname = ps.find_texture(pname)
        if tname is not None:
            kw[key + "_tex"] = self._texture_id(tname, float_first=not spectrum)
            kw[key] = (0.0, 0.0, 0.0) if spectrum else 0.0
        elif spectrum:
            kw[key] = ps.find_one_spectrum(pname, default)
        else:
            kw[key] = ps.find_one_float(pname, default)

    def _make_material(self, name, ps: ParamSet) -> int:
        if name in ("", "none"):
            return -1
        kw = {}
        if name == "matte":
            mt = sc.MAT_MATTE
            self._bind(ps, kw, "Kd", "kd", 0.5)
            self._bind(ps, kw, "sigma", "sigma", 0.0, spectrum=False)
        elif name == "plastic":
            mt = sc.MAT_PLASTIC
            self._bind(ps, kw, "Kd", "kd", 0.25)
            self._bind(ps, kw, "Ks", "ks", 0.25)
            self._bind(ps, kw, "roughness", "roughness", 0.1, spectrum=False)
            kw["remap_roughness"] = ps.find_one_bool("remaproughness", True)
        elif name == "mirror":
            mt = sc.MAT_MIRROR
            kw["kr"] = ps.find_one_spectrum("Kr", 0.9)
        elif name == "glass":
            # the JAX package reads uroughness alone (api.py:479-484)
            mt = sc.MAT_GLASS
            kw["kr"] = ps.find_one_spectrum("Kr", 1.0)
            kw["kt"] = ps.find_one_spectrum("Kt", 1.0)
            kw["eta"] = ps.find_one_float("eta", ps.find_one_float("index", 1.5))
            kw["roughness"] = ps.find_one_float("uroughness", 0.0)
        elif name == "metal":
            # copper by default (metal.cpp:115-121); roughness alone, as
            # the JAX package reads it (api.py:481-487)
            from ..core.sampled_spectrum import copper_eta_k_rgb

            mt = sc.MAT_METAL
            cu_eta, cu_k = copper_eta_k_rgb()
            kw["metal_eta"] = ps.find_one_spectrum("eta", tuple(cu_eta))
            kw["metal_k"] = ps.find_one_spectrum("k", tuple(cu_k))
            kw["roughness"] = ps.find_one_float("roughness", 0.01)
            kw["remap_roughness"] = ps.find_one_bool("remaproughness", True)
        elif name == "uber":
            mt = sc.MAT_UBER
            self._bind(ps, kw, "Kd", "kd", 0.25)
            self._bind(ps, kw, "Ks", "ks", 0.25)
            kw["kr"] = ps.find_one_spectrum("Kr", 0.0)
            kw["kt"] = ps.find_one_spectrum("Kt", 0.0)
            self._bind(ps, kw, "opacity", "opacity", 1.0)
            kw["roughness"] = ps.find_one_float("roughness", 0.1)
            kw["eta"] = ps.find_one_float("eta", ps.find_one_float("index", 1.5))
            kw["remap_roughness"] = ps.find_one_bool("remaproughness", True)
        elif name == "substrate":
            mt = sc.MAT_SUBSTRATE
            self._bind(ps, kw, "Kd", "kd", 0.5)
            self._bind(ps, kw, "Ks", "ks", 0.5)
            kw["urough"] = ps.find_one_float("uroughness", 0.1)
            kw["vrough"] = ps.find_one_float("vroughness", 0.1)
            kw["remap_roughness"] = ps.find_one_bool("remaproughness", True)
        elif name == "translucent":
            # "reflect" and "transmit" weigh the lobes (translucent.cpp:47-76)
            mt = sc.MAT_TRANSLUCENT
            self._bind(ps, kw, "Kd", "kd", 0.25)
            self._bind(ps, kw, "Ks", "ks", 0.25)
            kw["kr"] = ps.find_one_spectrum("reflect", 0.5)
            kw["kt"] = ps.find_one_spectrum("transmit", 0.5)
            kw["roughness"] = ps.find_one_float("roughness", 0.1)
            kw["remap_roughness"] = ps.find_one_bool("remaproughness", True)
        elif name == "mix":
            # two named materials blended by amount (mixmat.cpp:46)
            mt = sc.MAT_MIX
            for key, pname in (("mix_m1", "namedmaterial1"),
                               ("mix_m2", "namedmaterial2")):
                ref = ps.find_one_string(pname, "")
                if ref not in self.gs.named_materials:
                    raise ValueError(f"mix material: {pname} {ref!r} was never "
                                     "made")
                kw[key] = self.gs.named_materials[ref]
            kw["mix_amount"] = ps.find_one_spectrum("amount", 0.5)
        elif name == "disney":
            # disney.cpp:92-625; its microfacet takes the roughness as
            # alpha, not remapped (api.py:527-546)
            mt = sc.MAT_DISNEY
            self._bind(ps, kw, "color", "kd", 0.5)
            kw["roughness"] = ps.find_one_float("roughness", 0.5)
            kw["eta"] = ps.find_one_float("eta", 1.5)
            kw["remap_roughness"] = False
            kw["disney"] = tuple(
                ps.find_one_float(pname, default) for pname, default in (
                    ("metallic", 0.0), ("speculartint", 0.0),
                    ("anisotropic", 0.0), ("sheen", 0.0), ("sheentint", 0.5),
                    ("clearcoat", 0.0), ("clearcoatgloss", 1.0),
                    ("spectrans", 0.0), ("flatness", 0.0),
                    ("difftrans", 1.0))) + (
                1.0 if ps.find_one_bool("thin", False) else 0.0, 0.0)
        elif name == "hair":
            mt = sc.MAT_HAIR
            kw["hair"] = self._hair_params(ps)
            kw["eta"] = ps.find_one_float("eta", 1.55)
        elif name in ("subsurface", "kdsubsurface"):
            mt = sc.MAT_SUBSURFACE
            kw.update(self._subsurface_params(name, ps))
        elif name == "fourier":
            # a measured BSDF from a layerlab 'SCATFUN' file
            # (materials/fourier.cpp); the JAX package renders matte without
            # one (api.py:626-629), the port refuses
            mt = sc.MAT_FOURIER
            fname = ps.find_one_string("bsdffile", "")
            if not fname:
                raise ValueError('fourier material without "bsdffile"')
            kw["fourier_file"] = self._path(fname)
        else:
            raise NotImplementedError(
                f"material {name!r}: the port has "
                f"{', '.join(sc.SUPPORTED_MATERIALS.values())}, kdsubsurface")
        return self.setup.scene_builder.add_material(mt, **kw)

    @staticmethod
    def _hair_params(ps: ParamSet) -> tuple:
        """sigma_a rgb, beta_m, beta_n, alpha (hair.cpp:599-670): sigma_a
        given, or from "color" (SigmaAFromReflectance), or from the
        eumelanin and pheomelanin concentrations (eumelanin 1.3 by
        default)."""
        sig = ps.find_one_spectrum("sigma_a", None)
        bn = ps.find_one_float("beta_n", 0.3)
        if sig is None:
            color = ps.find_one_spectrum("color", None)
            if color is not None:
                c = np.asarray(color, np.float64)
                denom = (5.969 - 0.215 * bn + 2.532 * bn ** 2 - 10.73 * bn ** 3
                         + 5.574 * bn ** 4 + 0.245 * bn ** 5)
                sig = tuple((np.log(np.maximum(c, 1e-4)) / denom) ** 2)
            else:
                ce = ps.find_one_float("eumelanin", 1.3)
                cp = ps.find_one_float("pheomelanin", 0.0)
                sig = tuple(ce * np.array([0.419, 0.697, 1.37])
                            + cp * np.array([0.187, 0.4, 1.05]))
        return (float(sig[0]), float(sig[1]), float(sig[2]),
                ps.find_one_float("beta_m", 0.3), bn,
                ps.find_one_float("alpha", 2.0))

    @staticmethod
    def _subsurface_params(name, ps: ParamSet) -> dict:
        """subsurface.cpp / kdsubsurface.cpp's parameters: the surface's
        Kr, Kt, roughness and eta, and the medium's sigma_a and sigma_s
        (mm^-1) before "scale": given, named in the measured table (the
        JAX package falls back to the defaults on an unknown name,
        api.py:600-603; the port refuses), or, for kdsubsurface, inverted
        from Kd and the mean free path (SubsurfaceFromDiffuse)."""
        from ..materials import bssrdf as bsx
        from ..materials.measuredss import get_medium_scattering_properties

        g = ps.find_one_float("g", 0.0)
        eta = ps.find_one_float("eta", 1.33)
        kw = dict(kr=ps.find_one_spectrum("Kr", 1.0),
                  kt=ps.find_one_spectrum("Kt", 1.0), roughness=0.0,
                  urough=ps.find_one_float("uroughness", 0.0),
                  vrough=ps.find_one_float("vroughness", 0.0),
                  remap_roughness=ps.find_one_bool("remaproughness", True),
                  eta=eta, ss_scale=ps.find_one_float("scale", 1.0))
        if name == "subsurface":
            sig_a, sig_s = (0.0011, 0.0024, 0.014), (2.55, 3.21, 3.77)
            named = ps.find_one_string("name", "")
            if named:
                props = get_medium_scattering_properties(named)
                if props is None:
                    raise ValueError(f"subsurface material: no measured "
                                     f"medium named {named!r}")
                sig_s, sig_a = props
                g = 0.0  # the table holds reduced coefficients
            kw["ss_sigma_a"] = ps.find_one_spectrum("sigma_a", sig_a)
            kw["ss_sigma_s"] = ps.find_one_spectrum("sigma_s", sig_s)
        else:
            kd = np.asarray(ps.find_one_spectrum("Kd", 0.5), np.float64)
            mfp = np.asarray(ps.find_one_spectrum("mfp", 1.0), np.float64)
            sig_a, sig_s = bsx.subsurface_from_diffuse(
                bsx.beam_diffusion_table(g, eta), kd, mfp)
            kw["ss_sigma_a"] = tuple(sig_a.tolist())
            kw["ss_sigma_s"] = tuple(sig_s.tolist())
        kw["ss_g"] = g
        return kw

    def _map_image(self, ps: ParamSet):
        """A light's "mapname" image, read as the infinite light's map is,
        or None without one."""
        from ..utils.imageio import read_image

        mapname = ps.find_one_string("mapname", "")
        return read_image(self._path(mapname)) if mapname else None

    # ---- lights ----
    def light_source(self, name, params):
        ps = ParamSet.from_decls(params, self.cwd)
        b = self.setup.scene_builder
        scale = np.asarray(ps.find_one_spectrum("scale", 1.0))
        if name == "point":
            i = np.asarray(ps.find_one_spectrum("I", 1.0)) * scale
            from_p = ps.find_one_point("from", (0, 0, 0))
            b.add_point_light(self.ctm @ tf.translate(*from_p), i)
        elif name == "spot":
            # the JAX package places the spot by the CTM alone (api.py:
            # 657-665); pbrt's spot.cpp composes LookAt(from, to)
            for pname, default in (("from", (0, 0, 0)), ("to", (0, 0, 1))):
                if not np.array_equal(ps.find_one_point(pname, default), default):
                    raise NotImplementedError(
                        f'spot light "{pname}": the JAX package does not read '
                        "it; place the spot with the CTM")
            b.add_spot_light(self.ctm, np.asarray(ps.find_one_spectrum("I", 1.0))
                             * scale,
                             cone_angle_deg=ps.find_one_float("coneangle", 30.0),
                             cone_delta_deg=ps.find_one_float("conedeltaangle", 5.0))
        elif name == "distant":
            from_p = ps.find_one_point("from", (0, 0, 0))
            to_p = ps.find_one_point("to", (0, 0, 1))
            b.add_distant_light(self.ctm.apply_vector(from_p - to_p),
                                np.asarray(ps.find_one_spectrum("L", 1.0)) * scale)
        elif name == "projection":
            b.add_projection_light(
                self.ctm, np.asarray(ps.find_one_spectrum("I", 1.0)) * scale,
                fov_deg=ps.find_one_float("fov", 45.0), image=self._map_image(ps))
        elif name == "goniometric":
            b.add_gonio_light(self.ctm,
                              np.asarray(ps.find_one_spectrum("I", 1.0)) * scale,
                              image=self._map_image(ps))
        elif name == "infinite":
            L = np.asarray(ps.find_one_spectrum("L", 1.0)) * scale
            img = self._map_image(ps)
            b.add_infinite_light(L=L, image=None if img is None else img * L,
                                 world_to_light=self.ctm.m_inv)
        else:
            raise NotImplementedError(
                f"light {name!r}: the port has point, spot, distant, "
                "projection, goniometric, infinite and diffuse area lights")
        ps.report_unused(f"LightSource {name}")

    def area_light_source(self, name, params):
        if name not in ("area", "diffuse"):
            raise NotImplementedError(f"area light {name!r}: the port has "
                                      "'diffuse' ('area')")
        self.gs.area_light = ParamSet.from_decls(params, self.cwd)

    # ---- shapes (api.cpp:426-520) ----
    def shape(self, name, params):
        ps = ParamSet.from_decls(params, self.cwd)
        if self.current_object is not None:
            if self.gs.area_light is not None and name in _MESH_SHAPES:
                raise NotImplementedError(
                    f"an emissive {name} inside an object (the JAX package "
                    "drops its emission; the port refuses it)")
            self.objects[self.current_object].append(
                (name, ps, self.ctm, self.gs.material, copy.deepcopy(self.gs)))
            return
        self._create_shape(name, ps, self.ctm, self.gs.material, self.gs)

    def _create_shape(self, name, ps: ParamSet, o2w, mat, gs):
        b = self.setup.scene_builder
        area = gs.area_light
        if area is not None:
            if name not in ("trianglemesh", "sphere"):
                raise NotImplementedError(
                    f"an emissive {name} (the JAX package drops its "
                    "AreaLightSource; the port refuses it)")
            L = (np.asarray(area.find_one_spectrum("L", 1.0))
                 * np.asarray(area.find_one_spectrum("scale", 1.0)))
            two_sided = area.find_one_bool("twosided", False)
            n_samples = area.find_one_int("samples", area.find_one_int("nsamples", 1))
        media = dict(medium_inside=gs.medium_inside,
                     medium_outside=gs.medium_outside)
        rev = gs.reverse_orientation
        if name == "trianglemesh":
            idx = ps.find_ints("indices")
            p = ps.find_points("P")
            n = ps.find_points("N")
            uv = ps.find_point2s("uv")
            if uv is None:
                uv = ps.find_point2s("st")
            if area is not None:
                b.add_emissive_triangle_mesh(
                    idx, p, L, material=mat, object_to_world=o2w,
                    two_sided=two_sided, n_samples=n_samples, n=n, uv=uv)
            else:
                b.add_triangle_mesh(idx, p, n=n, uv=uv, object_to_world=o2w,
                                    material=mat, **media)
        elif name == "sphere":
            r = ps.find_one_float("radius", 1.0)
            zmin = ps.find_one_float("zmin", -r)
            zmax = ps.find_one_float("zmax", r)
            phimax = ps.find_one_float("phimax", 360.0)
            if area is not None:
                b.add_emissive_sphere(o2w, r, L, material=mat,
                                      two_sided=two_sided, n_samples=n_samples)
            else:
                b.add_sphere(o2w, r, material=mat, zmin=zmin, zmax=zmax,
                             phimax_deg=phimax, reverse_orientation=rev, **media)
        elif name == "disk":  # no media, as in the JAX package
            r = ps.find_one_float("radius", 1.0)
            b.add_quadric(sc.SHAPE_DISK, o2w, (
                r, ps.find_one_float("innerradius", 0.0),
                ps.find_one_float("height", 0.0),
                np.deg2rad(ps.find_one_float("phimax", 360.0))), mat, -1, rev)
        elif name == "cylinder":  # no media, as in the JAX package
            b.add_quadric(sc.SHAPE_CYLINDER, o2w, (
                ps.find_one_float("radius", 1.0), ps.find_one_float("zmin", -1.0),
                ps.find_one_float("zmax", 1.0),
                np.deg2rad(ps.find_one_float("phimax", 360.0))), mat, -1, rev)
        elif name == "cone":
            b.add_cone(o2w, ps.find_one_float("radius", 1.0),
                       ps.find_one_float("height", 1.0), material=mat,
                       phimax_deg=ps.find_one_float("phimax", 360.0),
                       reverse_orientation=rev, **media)
        elif name == "paraboloid":
            b.add_paraboloid(o2w, ps.find_one_float("radius", 1.0),
                             ps.find_one_float("zmin", 0.0),
                             ps.find_one_float("zmax", 1.0), material=mat,
                             phimax_deg=ps.find_one_float("phimax", 360.0),
                             reverse_orientation=rev, **media)
        elif name == "hyperboloid":
            b.add_hyperboloid(o2w, ps.find_one_point("p1", (0.0, 0.0, 0.0)),
                              ps.find_one_point("p2", (1.0, 1.0, 1.0)),
                              material=mat,
                              phimax_deg=ps.find_one_float("phimax", 360.0),
                              reverse_orientation=rev, **media)
        elif name == "loopsubdiv":
            from ..shapes.loopsubdiv import loop_subdivide

            levels = ps.find_one_int("levels", ps.find_one_int("nlevels", 3))
            with self._timed("loop subdivision"):
                idx, p, n = loop_subdivide(ps.find_ints("indices"),
                                           ps.find_points("P"), levels)
            b.add_triangle_mesh(idx, p, n=n, object_to_world=o2w, material=mat)
        elif name == "heightfield":
            idx, p, uv = heightfield_mesh(ps.find_one_int("nu", 0),
                                          ps.find_one_int("nv", 0),
                                          ps.find_floats("Pz"))
            b.add_triangle_mesh(idx, p, uv=uv, object_to_world=o2w, material=mat)
        elif name == "plymesh":
            from .plyload import load_ply

            idx, p, n, uv = load_ply(self._path(ps.find_one_string("filename", "")))
            b.add_triangle_mesh(idx, p, n=n, uv=uv, object_to_world=o2w,
                                material=mat)
        elif name == "curve":
            self._curve(ps, o2w, mat)
        elif name == "nurbs":
            from ..shapes.nurbs import tessellate_nurbs

            nu, nv = ps.find_one_int("nu", 0), ps.find_one_int("nv", 0)
            pw = ps.find_floats("Pw")
            if pw is not None:
                pw = np.asarray(pw, np.float32).reshape(nv, nu, 4)
            else:
                p3 = np.asarray(ps.find_points("P"), np.float32).reshape(nv, nu, 3)
                pw = np.concatenate([p3, np.ones((nv, nu, 1), np.float32)], -1)
            with self._timed("NURBS"):
                idx, p, uv = tessellate_nurbs(
                    nu, nv, ps.find_one_int("uorder", 4), ps.find_one_int("vorder", 4),
                    ps.find_floats("uknots"), ps.find_floats("vknots"), pw)
            b.add_triangle_mesh(idx, p, uv=uv, object_to_world=o2w, material=mat)
        else:
            raise NotImplementedError(
                f"shape {name!r}: the port has {', '.join(_SHAPES)}")

    def _curve(self, ps: ParamSet, o2w, mat):
        """Shape "curve" (curve.cpp CreateCurveShape, api.py:871-901): one
        statement holds a chain of cubic Bezier segments, each made into
        procedural curve primitives, the widths lerped along the chain."""
        degree = ps.find_one_int("degree", 3)
        basis = ps.find_one_string("basis", "bezier")
        if degree != 3 or basis != "bezier":
            raise NotImplementedError(
                f'curve degree {degree}, basis "{basis}": the port has cubic '
                "Bezier curves (the JAX package reads any curve as one)")
        p = np.asarray(ps.find_points("P"), np.float32)
        n_seg = max((p.shape[0] - 1) // 3, 1)
        cps = np.stack([p[3 * i:3 * i + 4] for i in range(n_seg)])
        w = ps.find_one_float("width", 1.0)
        w0 = ps.find_one_float("width0", w)
        w1 = ps.find_one_float("width1", w)
        ctype = ps.find_one_string("type", "flat")
        nrm = ps.find_points("N")
        normals = None
        if ctype == "ribbon":
            if nrm is None or len(nrm) < 2:
                raise ValueError("a ribbon curve needs its normals \"N\"")
            if n_seg > 1 and len(nrm) > 2:
                raise NotImplementedError(
                    "a ribbon chain of several segments with their own "
                    "normals (the JAX package gives every segment the first "
                    "two)")
            normals = np.asarray(nrm[:2], np.float32)
        ws = np.linspace(w0, w1, n_seg + 1)
        sd = ps.find_one_int("splitdepth", 3)
        for i in range(n_seg):
            self.setup.scene_builder.add_curve(
                cps[i], float(ws[i]), float(ws[i + 1]), curve_type=ctype,
                normals=normals, object_to_world=o2w, material=mat, splitdepth=sd)

    # ---- instancing (api.cpp:1520-1588) ----
    def object_begin(self, name, params=None):
        self.attribute_begin()
        self.objects[name] = []
        self.current_object = name

    def object_end(self):
        self.current_object = None
        self.attribute_end()

    def object_instance(self, name, params=None):
        """TransformedPrimitive instancing (core/primitive.h:99-127): the
        object's mesh shapes are built once into a shared object-space
        template, and each instance adds one primitive per triangle; its
        quadrics and curves are made again under the combined transform
        (pbrt_tpu/sceneio/api.py:939-970)."""
        if name not in self.objects:
            raise ValueError(f"ObjectInstance {name!r}: no such object")
        shapes = self.objects[name]
        b = self.setup.scene_builder
        mesh = [x for x in shapes if x[0] in _MESH_SHAPES]
        if mesh and name not in self._mesh_templates:
            b.begin_mesh_template()
            for shape_name, ps, o2w, mat, gs in mesh:
                self._create_shape(shape_name, ps, o2w, mat, gs)
            self._mesh_templates[name] = b.end_mesh_template()
        with self._timed("instancing"):
            if mesh:
                b.add_mesh_instance(self._mesh_templates[name], self.ctm)
            for shape_name, ps, o2w, mat, gs in shapes:
                if shape_name not in _MESH_SHAPES:
                    self._create_shape(shape_name, ps, self.ctm @ o2w, mat, gs)

    @contextlib.contextmanager
    def _timed(self, what: str):
        """Add the block's host seconds to the builder's timings[what]."""
        t = self.setup.scene_builder.timings
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t[what] = t.get(what, 0.0) + time.perf_counter() - t0

    def finalize(self) -> RenderSetup:
        self.setup.cwd = self.cwd
        return self.setup
