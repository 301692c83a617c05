"""Graphics-state machine: .pbrt directives -> SceneBuilder + render config.

Port of pbrt_tpu/sceneio/api.py (pbrt-v3 core/api.cpp) for what the path
and direct-lighting integrators render:

* the options/world phases, the CTM and its stacks, named coordinate
  systems (api.cpp:899-1186);
* ``Camera "perspective"`` (with ``lensradius``/``focaldistance``), the image
  film, the box filter, the halton and sobol samplers, ``Integrator
  "path"`` and ``"directlighting"``;
* matte, plastic, mirror, glass, metal (copper by default), substrate,
  uber, translucent and mix materials, named materials and the default
  matte material; Kd, Ks, matte's sigma, plastic's roughness and uber's
  opacity bind to textures, as the JAX package binds them;
* ``Texture``: constant, scale, mix, checkerboard (2D), uv, bilerp, fbm,
  wrinkled, windy, marble, dots and imagemap, with uv mapping;
* point, spot, distant, projection and goniometric lights, infinite
  lights (constant or with ``mapname``) and diffuse area lights on
  triangle meshes and spheres;
* ``trianglemesh``, ``sphere`` and ``plymesh`` shapes;
* ``MakeNamedMedium`` (homogeneous and heterogeneous) and
  ``MediumInterface``: in the options block it sets the camera's medium,
  in the world block the media of the shapes that follow (non-emissive
  trianglemeshes and spheres, as in the JAX package: a plymesh or an
  emissive shape gets none);
* ``Integrator "volpath"``, ``"whitted"`` and ``"ao"``.

Everything else raises NotImplementedError naming what is missing:
instancing, other shapes, lights, materials, medium types, texture classes
and mappings, and kd-trees.  Unlike the JAX package, nothing degrades to a
stand-in: a missing image file raises, and so do a mix naming an unknown
or a mix material, and a spot light's "from" or "to" (which the JAX
package does not read).

Output: ``RenderSetup``, everything render.py needs.
"""
from __future__ import annotations

import copy
import dataclasses
import os

import numpy as np

from .. import scene as sc
from ..core import transform as tf
from .paramset import ParamSet


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
        from ..cameras import make_perspective_camera

        if self.camera_name != "perspective":
            raise NotImplementedError(
                f"camera {self.camera_name!r}: the port has 'perspective' only")
        p = self.camera_params or ParamSet()
        return make_perspective_camera(
            self.camera_to_world or tf.identity(), self.resolution,
            fov_deg=p.find_one_float("fov", 90.0),
            lens_radius=p.find_one_float("lensradius", 0.0),
            focal_distance=p.find_one_float("focaldistance", 1e6),
            shutter_open=p.find_one_float("shutteropen", 0.0),
            shutter_close=p.find_one_float("shutterclose", 1.0),
        )

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
            scale=p.find_one_float("scale", 1.0),
            max_sample_luminance=p.find_one_float("maxsampleluminance",
                                                  float("inf")),
        )
        return cfg, filt

    def make_sampler_config(self):
        from ..samplers.samplers import SamplerConfig

        if os.environ.get("PBRT_TPU_EXACT_SAMPLER", "0") == "1":
            raise NotImplementedError(
                "PBRT_TPU_EXACT_SAMPLER=1: the exact host sample tables are "
                "not ported")
        p = self.sampler_params or ParamSet()
        name = {"lowdiscrepancy": "zerotwosequence"}.get(self.sampler_name,
                                                         self.sampler_name)
        return SamplerConfig(name, p.find_one_int("pixelsamples", 16),
                             self.resolution)

    def make_integrator_config(self):
        """PathConfig for "path" and "volpath", DirectLightingConfig for
        "directlighting" (maxdepth; strategy, by default "all") and
        "whitted" (maxdepth), AOConfig for "ao" (cossample, nsamples);
        the JAX package's parameters (render.py:55-120)."""
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
        self.setup.camera_params = ParamSet.from_decls(params)
        self.setup.camera_to_world = self.ctm.inverse
        self.named_coordinate_systems["camera"] = self.ctm.inverse

    def film(self, name, params):
        self.setup.film_name = name
        self.setup.film_params = ParamSet.from_decls(params)

    def sampler(self, name, params):
        self.setup.sampler_name = name
        self.setup.sampler_params = ParamSet.from_decls(params)

    def integrator(self, name, params):
        self.setup.integrator_name = name
        self.setup.integrator_params = ParamSet.from_decls(params)

    def filter(self, name, params):
        self.setup.filter_name = name
        self.setup.filter_params = ParamSet.from_decls(params)

    pixel_filter = filter

    def accelerator(self, name, params):
        if name == "kdtree":
            raise NotImplementedError('Accelerator "kdtree": the port has the BVH')

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
        tid = self._make_texture(tclass, ParamSet.from_decls(params))
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

    # ---- not ported ----
    def object_begin(self, name, params=None):
        raise NotImplementedError("ObjectBegin/ObjectInstance: instancing is "
                                  "not ported")

    object_end = object_instance = object_begin

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
        ps = ParamSet.from_decls(params)
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
        self.gs.material = self._make_material(name, ParamSet.from_decls(params))

    def make_named_material(self, name, params):
        ps = ParamSet.from_decls(params)
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
        else:
            raise NotImplementedError(
                f"material {name!r}: the port has "
                f"{', '.join(sc.SUPPORTED_MATERIALS.values())}")
        return self.setup.scene_builder.add_material(mt, **kw)

    def _map_image(self, ps: ParamSet):
        """A light's "mapname" image, read as the infinite light's map is,
        or None without one."""
        from ..utils.imageio import read_image

        mapname = ps.find_one_string("mapname", "")
        return read_image(self._path(mapname)) if mapname else None

    # ---- lights ----
    def light_source(self, name, params):
        ps = ParamSet.from_decls(params)
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
        self.gs.area_light = ParamSet.from_decls(params)

    # ---- shapes (api.cpp:426-520) ----
    def shape(self, name, params):
        ps = ParamSet.from_decls(params)
        b = self.setup.scene_builder
        mat = self.gs.material
        o2w = self.ctm
        area = self.gs.area_light
        if area is not None:
            L = (np.asarray(area.find_one_spectrum("L", 1.0))
                 * np.asarray(area.find_one_spectrum("scale", 1.0)))
            two_sided = area.find_one_bool("twosided", False)
            n_samples = area.find_one_int("samples", area.find_one_int("nsamples", 1))
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
                                    material=mat,
                                    medium_inside=self.gs.medium_inside,
                                    medium_outside=self.gs.medium_outside)
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
                             phimax_deg=phimax,
                             reverse_orientation=self.gs.reverse_orientation,
                             medium_inside=self.gs.medium_inside,
                             medium_outside=self.gs.medium_outside)
        elif name == "plymesh":
            if area is not None:
                raise NotImplementedError(
                    "an emissive plymesh (the JAX package drops its "
                    "AreaLightSource; the port refuses it)")
            from .plyload import load_ply

            idx, p, n, uv = load_ply(self._path(ps.find_one_string("filename", "")))
            b.add_triangle_mesh(idx, p, n=n, uv=uv, object_to_world=o2w,
                                material=mat)
        else:
            raise NotImplementedError(
                f"shape {name!r}: the port has trianglemesh, sphere and plymesh")

    def finalize(self) -> RenderSetup:
        return self.setup
