"""SceneArrays, the flattened scene as tensors on one device, and the host
SceneBuilder that assembles it.

Port of pbrt_tpu/scene.py (SceneBuilder, SceneArrays, statics.py) for the
shapes, materials, lights and textures of the path and direct-lighting
integrators:

* shapes: triangle meshes, the six quadrics (sphere, cylinder, disk, cone,
  paraboloid, hyperboloid), procedural cubic curves (shapes/curve.py) and
  instanced triangle meshes (a shared object-space template, one
  SHAPE_TRIANGLE_INST primitive per triangle and instance, the instance's
  world-to-object and object-to-world rows in ``inst_xf``); area lights on
  spheres and triangle meshes only;
* materials: matte, plastic, mirror, glass (smooth and rough), metal,
  substrate, uber (with its opacity), translucent, mix, disney, hair,
  fourier (one table per .bsdf file) and subsurface (one beam-diffusion
  table per distinct (g, eta), stacked), with Kd, Ks, sigma, roughness and
  uber's opacity bound to textures (textures/textures.py);
* lights: point, spot, distant, projection and goniometric lights, diffuse
  area lights on spheres and triangles, and infinite lights, constant or
  with an equirect map importance-sampled by a Distribution2D (one map a
  scene; the first wins, as in the JAX package; a second projection or
  goniometric light must share the first one's map and transform);
* media: homogeneous and density-grid media (media/media.py), each
  primitive's inside and outside medium (MediumInterface) and the camera's.

Anything else raises NotImplementedError.  The builder computes its numpy
arrays exactly as the JAX builder does (``build_numpy``), and
``SceneArrays.from_numpy`` turns them, or the JAX package's own arrays
(bridge.py), into tensors plus the GPU traversal tables of ops/bvh.py:
``bvh4_nodes`` (128-byte 4-wide node rows), ``bvh2_nodes`` (64-byte binary
rows, both children of an interior node in one) and ``prim_tris``
(triangle records in BVH order, shared by both), which replace the TPU
kernel tables.  Both node tables are always built, as
the JAX builder builds both of its own (pbrt_tpu/scene.py:965-966).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from .accel.build import build_bvh
from .core import sampling as smp
from .core import transform as tf
from .materials.fourier import FourierTable
from .media.media import MEDIUM_NAMES, HostMediumTable, MediumTable
from .ops.bvh import build_bvh2_table, build_bvh4_table, build_prim_records
from .textures.textures import HostTextureTable, TextureTable, texture_meta

SHAPE_TRIANGLE = 0
SHAPE_SPHERE = 1
SHAPE_CYLINDER = 2
SHAPE_DISK = 3
SHAPE_CONE = 4
SHAPE_PARABOLOID = 5
SHAPE_HYPERBOLOID = 6
SHAPE_CURVE = 7  # procedural cubic Bezier curve, a row of curve_packed
SHAPE_TRIANGLE_INST = 8  # instanced triangle: a row of inst_tri
QUADRIC_SHAPES = (SHAPE_SPHERE, SHAPE_CYLINDER, SHAPE_DISK, SHAPE_CONE,
                  SHAPE_PARABOLOID, SHAPE_HYPERBOLOID)

LIGHT_POINT = 0
LIGHT_SPOT = 1
LIGHT_DISTANT = 2
LIGHT_AREA = 3
LIGHT_INFINITE = 4
LIGHT_PROJECTION = 5
LIGHT_GONIO = 6

MAT_MATTE = 0
MAT_PLASTIC = 1
MAT_MIRROR = 2
MAT_GLASS = 3
MAT_METAL = 4
MAT_SUBSTRATE = 5
MAT_UBER = 6
MAT_TRANSLUCENT = 7
MAT_FOURIER = 8
MAT_DISNEY = 9
MAT_MIX = 10
MAT_HAIR = 11
MAT_SUBSURFACE = 12  # subsurface and kdsubsurface (TabulatedBSSRDF)
# the exit point's SeparableBSSRDFAdapter (bssrdf.h:153-171): made by the
# path integrator at a sampled exit point, never a row of the table
MAT_BSSRDF_ADAPTER = 13

SUPPORTED_MATERIALS = {MAT_MATTE: "matte", MAT_PLASTIC: "plastic",
                       MAT_MIRROR: "mirror", MAT_GLASS: "glass",
                       MAT_METAL: "metal", MAT_SUBSTRATE: "substrate",
                       MAT_UBER: "uber", MAT_TRANSLUCENT: "translucent",
                       MAT_FOURIER: "fourier", MAT_DISNEY: "disney",
                       MAT_MIX: "mix", MAT_HAIR: "hair",
                       MAT_SUBSURFACE: "subsurface"}
SUPPORTED_LIGHTS = {LIGHT_POINT: "point", LIGHT_SPOT: "spot",
                    LIGHT_DISTANT: "distant", LIGHT_AREA: "diffuse area",
                    LIGHT_INFINITE: "infinite", LIGHT_PROJECTION: "projection",
                    LIGHT_GONIO: "goniometric"}
SUPPORTED_SHAPES = {SHAPE_TRIANGLE: "triangle", SHAPE_SPHERE: "sphere",
                    SHAPE_CYLINDER: "cylinder", SHAPE_DISK: "disk",
                    SHAPE_CONE: "cone", SHAPE_PARABOLOID: "paraboloid",
                    SHAPE_HYPERBOLOID: "hyperboloid", SHAPE_CURVE: "curve",
                    SHAPE_TRIANGLE_INST: "instanced triangle"}
# the shapes an area light can sit on
EMISSIVE_SHAPES = {SHAPE_TRIANGLE: "triangle", SHAPE_SPHERE: "sphere"}

# texture-bound material columns the port evaluates
TEXTURE_COLUMNS = ("kd_tex", "ks_tex", "sigma_tex", "rough_tex", "opacity_tex")
MATERIAL_FIELDS = ("mat_type", "kd", "ks", "kr", "kt", "sigma", "roughness",
                   "urough", "vrough", "eta", "remap_roughness", "metal_eta",
                   "metal_k", "opacity", "disney", "hair", "mix_amount",
                   "mix_m1", "mix_m2") + TEXTURE_COLUMNS
# the subsurface columns, present with a subsurface row
SUBSURFACE_FIELDS = ("ss_sigma_t", "ss_rho", "ss_table")
# the scene's stacked beam-diffusion tables (materials/bssrdf.py)
BSSRDF_FIELDS = ("bssrdf_rho_nodes", "bssrdf_radius_nodes", "bssrdf_profile",
                 "bssrdf_cdf", "bssrdf_rho_eff")
LIGHT_FIELDS = ("light_type", "L", "pos", "dir", "cos_falloff_start",
                "cos_falloff_end", "shape_type", "shape_idx", "two_sided",
                "n_samples", "world_radius", "world_center")
ENV_FIELDS = ("env_map", "env_w2l")
# the projection and goniometric lights' maps (first such light's)
MAP_LIGHT_FIELDS = ("proj_img", "proj_w2l", "proj_screen", "gonio_img",
                    "gonio_w2l")
SCENE_FIELDS = ("bvh_min", "bvh_max", "bvh_offset", "bvh_nprims", "bvh_axis",
                "prim_meta", "tri_indices", "tri_p", "tri_attr", "tri_verts",
                "q_type", "q_w2o", "q_o2w", "q_params", "q_rev", "q_packed",
                "q_prim_id")
MEDIUM_ID_FIELDS = ("prim_medium_inside", "prim_medium_outside", "camera_medium")
# present with a curve or an instanced mesh, None otherwise
GEOMETRY_FIELDS = ("curve_packed", "inst_xf", "inst_tri")
# bump_tex is a column of the JAX package's table that no code of its
# materials or integrators applies; a scene that binds it is refused
_REFUSED_TEXTURE_COLUMNS = ("bump_tex",)


def resolve_device(device) -> torch.device:
    """The card unless the caller asks for the CPU; no silent fallback."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


@dataclasses.dataclass(frozen=True)
class MaterialTable:
    mat_type: torch.Tensor  # [M] i32
    kd: torch.Tensor  # [M, 3]
    ks: torch.Tensor  # [M, 3]
    kr: torch.Tensor  # [M, 3]
    kt: torch.Tensor  # [M, 3] glass transmission
    sigma: torch.Tensor  # [M] Oren-Nayar sigma, degrees
    roughness: torch.Tensor  # [M]
    urough: torch.Tensor  # [M]
    vrough: torch.Tensor  # [M]
    eta: torch.Tensor  # [M]
    remap_roughness: torch.Tensor  # [M] bool
    metal_eta: torch.Tensor  # [M, 3] metal's conductor eta
    metal_k: torch.Tensor  # [M, 3] and absorption k
    opacity: torch.Tensor  # [M, 3] uber's opacity (1 opaque)
    # disney [M, 12]: metallic, specTint, anisotropic, sheen, sheenTint,
    # clearcoat, clearcoatGloss, specTrans, flatness, diffTrans, thin, pad
    disney: torch.Tensor
    hair: torch.Tensor  # [M, 6]: sigma_a rgb, beta_m, beta_n, alpha
    mix_amount: torch.Tensor  # [M, 3] mix: the first material's weight
    mix_m1: torch.Tensor  # [M] i32 mix: the two material rows
    mix_m2: torch.Tensor
    # texture ids (-1: the constant column holds the value)
    kd_tex: torch.Tensor  # [M] i32
    ks_tex: torch.Tensor
    sigma_tex: torch.Tensor
    rough_tex: torch.Tensor
    opacity_tex: torch.Tensor
    # subsurface (TabulatedBSSRDF, bssrdf.h:117-137), with a subsurface
    # row: world-space sigma_t and single-scattering albedo a channel, and
    # the row's beam-diffusion table among the scene's
    ss_sigma_t: Optional[torch.Tensor] = None  # [M, 3]
    ss_rho: Optional[torch.Tensor] = None  # [M, 3]
    ss_table: Optional[torch.Tensor] = None  # [M] i32
    # fourier (reflection.h:130), with a fourier row: its table, -1 none
    fourier_id: Optional[torch.Tensor] = None  # [M] i32
    fourier: tuple = ()  # FourierTable a .bsdf file

    @staticmethod
    def from_numpy(mats: dict, device) -> "MaterialTable":
        cols = {k: torch.as_tensor(np.asarray(mats[k]), device=device)
                for k in MATERIAL_FIELDS}
        for k in SUBSURFACE_FIELDS + ("fourier_id",):
            if mats.get(k) is not None:
                cols[k] = torch.as_tensor(np.asarray(mats[k]), device=device)
        return MaterialTable(**cols, fourier=tuple(
            FourierTable.from_numpy(t, device) for t in mats.get("fourier") or ()))


@dataclasses.dataclass(frozen=True)
class LightTable:
    light_type: torch.Tensor  # [L] i32
    L: torch.Tensor  # [L, 3] intensity (point, spot, projection,
    #   goniometric), radiance (distant, area), scale (infinite)
    pos: torch.Tensor  # [L, 3]
    dir: torch.Tensor  # [L, 3] toward the distant light; the spot's axis
    cos_falloff_start: torch.Tensor  # [L] spot
    cos_falloff_end: torch.Tensor  # [L] spot, the cone's edge
    shape_type: torch.Tensor  # [L] i32 (area lights)
    shape_idx: torch.Tensor  # [L] i32 into the triangle or quadric table
    two_sided: torch.Tensor  # [L] bool
    n_samples: torch.Tensor  # [L] i32, the light's "nsamples"
    world_radius: torch.Tensor  # [] the scene's bounding-sphere radius
    world_center: torch.Tensor  # [3]
    # the infinite light's map (lights/infinite.cpp:62-124): a 1x1 black
    # placeholder when no infinite light has one
    env_map: torch.Tensor  # [H, W, 3] equirect radiance, L folded in
    env_w2l: torch.Tensor  # [4, 4] world to light
    env_distr: smp.Distribution2D  # over luminance * sin(theta)
    # the first projection light's map (lights/projection.cpp) and the
    # first goniometric light's (lights/goniometric.cpp): 1x1 white
    # placeholders without one
    proj_img: torch.Tensor  # [H, W, 3]
    proj_w2l: torch.Tensor  # [4, 4] world to light
    proj_screen: torch.Tensor  # [4] x0 x1 y0 y1, the fov scale folded in
    gonio_img: torch.Tensor  # [H, W, 3] equirect
    gonio_w2l: torch.Tensor  # [4, 4]


@dataclasses.dataclass(frozen=True)
class SceneArrays:
    # binary BVH, LinearBVHNode SoA (the watertight oracle's tree)
    bvh_min: torch.Tensor
    bvh_max: torch.Tensor
    bvh_offset: torch.Tensor
    bvh_nprims: torch.Tensor
    bvh_axis: torch.Tensor
    # primitives in BVH order: (shape type, shape index, material, area light)
    prim_meta: torch.Tensor
    tri_indices: torch.Tensor  # [T, 3]
    tri_p: torch.Tensor  # [V, 3]
    tri_attr: torch.Tensor  # [T, 26] v(9) | uv(6) | n(9) | has_n | pad
    tri_verts: torch.Tensor  # [T, 9]
    q_type: torch.Tensor
    q_w2o: torch.Tensor  # [Q, 4, 4]
    q_o2w: torch.Tensor
    q_params: torch.Tensor  # [Q, 12]
    q_rev: torch.Tensor  # [Q] bool
    q_packed: torch.Tensor  # [Q, 24] w2o rows (12) | params (12)
    q_prim_id: torch.Tensor  # [Q] BVH-ordered prim row per quadric
    # GPU traversal tables (ops/bvh.py)
    bvh4_nodes: torch.Tensor  # [M4, 32] f32
    bvh2_nodes: torch.Tensor  # [M2, 16] f32, one row per interior node + 1
    prim_tris: torch.Tensor  # [P, 12] f32, one 48-byte record a primitive
    materials: MaterialTable
    lights: LightTable
    light_distr: smp.Distribution1D
    # host-side facts fixed at build time
    bvh4_depth: int
    bvh2_depth: int
    mat_types: tuple
    light_types: tuple
    quadric_types: tuple
    quadric_rows: tuple  # ((quadric index, prim row, shape type), ...) for
    #   the brute-force quadric pass
    env_light_idx: int = -1  # the light row of the env map, -1 none
    mix_sub_types: tuple = ()  # the types of the mix materials' materials
    textures: Optional[TextureTable] = None
    tex_meta: tuple = ()  # per texture row (type, child1, child2, fparams,
    #   n_levels): evaluate_textures' control flow
    tex_ids: tuple = ()  # the texture rows materials refer to
    # the spatial light distribution (lights/lightdistrib.py), filled by
    # ensure_spatial_light_distribution when a render uses "spatial"
    spatial_grid_res: Optional[torch.Tensor] = None  # [3] i64
    spatial_b0: Optional[torch.Tensor] = None  # [3]
    spatial_diag: Optional[torch.Tensor] = None  # [3]
    spatial_cdf: Optional[torch.Tensor] = None  # [V, L+1]
    spatial_pmf: Optional[torch.Tensor] = None  # [V, L]
    # media (core/medium.h:102 MediumInterface per primitive, BVH order)
    prim_medium_inside: Optional[torch.Tensor] = None  # [P] i32, -1 none
    prim_medium_outside: Optional[torch.Tensor] = None  # [P] i32
    media: Optional[MediumTable] = None
    camera_medium: int = -1  # the camera's (the scene's outer) medium
    medium_types: tuple = ()  # types of the media some primitive or the
    #   camera uses (statics.py:58-70)
    has_media: bool = False
    # the beam-diffusion tables of the scene's distinct (g, eta), stacked
    # (materials/bssrdf.py), with a subsurface material
    bssrdf_rho_nodes: Optional[torch.Tensor] = None  # [100]
    bssrdf_radius_nodes: Optional[torch.Tensor] = None  # [64]
    bssrdf_profile: Optional[torch.Tensor] = None  # [K * 100, 64]
    bssrdf_cdf: Optional[torch.Tensor] = None  # [K * 100, 64]
    bssrdf_rho_eff: Optional[torch.Tensor] = None  # [K * 100]
    # procedural curves and instanced meshes (None without)
    curve_packed: Optional[torch.Tensor] = None  # [C, 28] f32
    inst_xf: Optional[torch.Tensor] = None  # [I, 24] f32 w2i rows | i2w rows
    inst_tri: Optional[torch.Tensor] = None  # [IT, 2] i32 (template row, instance)

    @property
    def device(self) -> torch.device:
        return self.prim_meta.device

    @property
    def has_textures(self) -> bool:
        return len(self.tex_ids) > 0

    @staticmethod
    def from_numpy(fields: dict, device) -> "SceneArrays":
        """Tensors on `device` from numpy arrays named as the JAX package's
        SceneArrays fields (materials, lights and light_distr as nested
        dicts).  Refuses what this port does not render yet."""
        device = resolve_device(device)
        mats = fields["materials"]
        lights = fields["lights"]
        for col in _REFUSED_TEXTURE_COLUMNS:
            if col in mats and (np.asarray(mats[col]) >= 0).any():
                raise NotImplementedError(
                    f"material column {col}: bump mapping, which the JAX "
                    "package never applies either")
        _check_mix_rows(mats)
        _check_mix_of_hair(mats)
        tex = fields.get("textures")
        _check_opacity_textures(mats, tex)
        tex_ids = tuple(sorted({int(i) for col in TEXTURE_COLUMNS
                                for i in np.asarray(mats[col]) if i >= 0}))
        prim_meta = np.asarray(fields["prim_meta"])
        mat_types = tuple(sorted(set(np.asarray(mats["mat_type"]).tolist())))
        light_types = tuple(sorted(set(np.asarray(lights["light_type"]).tolist())))
        prim_types = tuple(sorted(set(prim_meta[:, 0].tolist())))
        _refuse(mat_types, SUPPORTED_MATERIALS, "material type")
        _refuse(light_types, SUPPORTED_LIGHTS, "light type")
        _refuse(prim_types, SUPPORTED_SHAPES, "shape type")
        area = np.asarray(lights["light_type"]) == LIGHT_AREA
        _refuse(tuple(np.asarray(lights["shape_type"])[area].tolist()),
                EMISSIVE_SHAPES, "area light shape")
        if fields.get("kd_nodes") is not None:
            raise NotImplementedError("scenes with kd_nodes")
        geo = {k: fields.get(k) for k in GEOMETRY_FIELDS}
        for key, ptype in (("curve_packed", SHAPE_CURVE),
                           ("inst_tri", SHAPE_TRIANGLE_INST)):
            if ptype in prim_types and geo[key] is None:
                raise ValueError(f"{SUPPORTED_SHAPES[ptype]} primitives without {key}")
        media = _media_fields(fields)

        rows, depth = build_bvh4_table(fields["bvh_min"], fields["bvh_max"],
                                       fields["bvh_offset"],
                                       fields["bvh_nprims"])
        rows2, depth2 = build_bvh2_table(fields["bvh_min"], fields["bvh_max"],
                                         fields["bvh_offset"],
                                         fields["bvh_nprims"], fields["bvh_axis"])
        recs = build_prim_records(prim_meta[:, 0], prim_meta[:, 1],
                                  fields["tri_verts"], geo["inst_tri"])
        q_prim = np.asarray(fields["q_prim_id"])
        out = {k: torch.as_tensor(np.asarray(fields[k]), device=device)
               for k in SCENE_FIELDS}
        return SceneArrays(
            **out,
            bvh4_nodes=torch.as_tensor(rows, device=device),
            bvh2_nodes=torch.as_tensor(rows2, device=device),
            prim_tris=torch.as_tensor(recs, device=device),
            materials=MaterialTable.from_numpy(mats, device),
            lights=_light_table(lights, device),
            light_distr=smp.distribution_from_numpy(fields["light_distr"],
                                                    device),
            env_light_idx=int(np.asarray(lights["env_light_idx"])),
            textures=(None if tex is None or not tex_ids
                      else TextureTable.from_numpy(tex, device)),
            tex_meta=() if tex is None or not tex_ids else texture_meta(tex),
            tex_ids=tex_ids,
            bvh4_depth=depth,
            bvh2_depth=depth2,
            mat_types=mat_types,
            mix_sub_types=_mix_sub_types(mats),
            light_types=light_types,
            quadric_types=tuple(t for t in prim_types if t != SHAPE_TRIANGLE),
            quadric_rows=tuple((int(qi), int(r), int(prim_meta[r, 0]))
                               for qi, r in enumerate(q_prim) if r >= 0),
            prim_medium_inside=torch.as_tensor(media["prim_medium_inside"],
                                               device=device),
            prim_medium_outside=torch.as_tensor(media["prim_medium_outside"],
                                                device=device),
            media=MediumTable.from_numpy(media["media"], device),
            camera_medium=media["camera_medium"],
            medium_types=media["medium_types"],
            has_media=media["has_media"],
            **{k: torch.as_tensor(np.asarray(fields[k]), device=device)
               for k in BSSRDF_FIELDS + GEOMETRY_FIELDS
               if fields.get(k) is not None},
        )


def _media_fields(fields: dict) -> dict:
    """The media fields of `fields`, with the types of the media in use
    and whether there are any (statics.py:58-70: the media some primitive
    or the camera refers to)."""
    ids = {k: np.asarray(fields[k], np.int32) for k in MEDIUM_ID_FIELDS[:2]}
    cam = int(np.asarray(fields["camera_medium"]))
    table = fields["media"]
    used = {int(i) for col in ids.values() for i in col[col >= 0]}
    if cam >= 0:
        used.add(cam)
    med_types = np.asarray(table["med_type"])
    types = tuple(sorted({int(med_types[i]) for i in used}))
    _refuse(types, MEDIUM_NAMES, "medium type")
    return dict(ids, media=table, camera_medium=cam, medium_types=types,
                has_media=bool(used))


def _check_mix_rows(mats: dict):
    """A mix names two materials of the table, neither of them a mix: the
    JAX package flattens a nested mix to matte and gathers an unknown
    name's row 0 (bsdf.py:994-1000, api.py:516-530); the port refuses
    both."""
    types = np.asarray(mats["mat_type"])
    for row in np.nonzero(types == MAT_MIX)[0]:
        for col in ("mix_m1", "mix_m2"):
            sub = int(np.asarray(mats[col])[row])
            if not 0 <= sub < types.shape[0]:
                raise ValueError(f"mix material {row}: {col} = {sub} names no "
                                 "material")
            if types[sub] == MAT_MIX:
                raise NotImplementedError(
                    f"mix material {row}: {col} is itself a mix (the JAX "
                    "package would render it as matte)")


def _check_mix_of_hair(mats: dict):
    """A hair material as a mix's material is refused: the JAX package
    gathers no uv for a mix's materials, so its hair reads h = -1 there
    (bsdf.py:985-987, hair.py:107)."""
    types = np.asarray(mats["mat_type"])
    rows = types == MAT_MIX
    for col in ("mix_m1", "mix_m2"):
        for sub in np.asarray(mats[col])[rows]:
            if 0 <= sub < types.shape[0] and types[sub] == MAT_HAIR:
                raise NotImplementedError(
                    f"a mix of hair (material {int(sub)}): the JAX package "
                    "renders its hair at h = -1")


def _check_opacity_textures(mats: dict, tex):
    """An opacity texture that no Kd, Ks, sigma or roughness binding reaches
    (as its row or a child of one) is refused: the JAX package evaluates
    only the textures those columns reach (pbrt_tpu/statics.py:42-46,
    textures.py:350), so such a map reads 0 there and the material turns
    fully transparent, where the port would evaluate it."""
    opac = {int(i) for i in np.asarray(mats["opacity_tex"]) if i >= 0}
    if not opac:
        return
    reached = {int(i) for col in ("kd_tex", "ks_tex", "sigma_tex", "rough_tex")
               for i in np.asarray(mats[col]) if i >= 0}
    todo = list(reached)
    while todo:
        t = todo.pop()
        for col in ("child1", "child2"):
            c = int(np.asarray(tex[col])[t])
            if c >= 0 and c not in reached:
                reached.add(c)
                todo.append(c)
    alone = sorted(opac - reached)
    if alone:
        raise NotImplementedError(
            f"opacity texture(s) {alone} bound by no Kd, Ks, sigma or "
            "roughness parameter: the JAX package never evaluates such a "
            "map and renders the material fully transparent")


def _mix_sub_types(mats: dict) -> tuple:
    types = np.asarray(mats["mat_type"])
    rows = types == MAT_MIX
    return tuple(sorted({int(types[i]) for col in ("mix_m1", "mix_m2")
                         for i in np.asarray(mats[col])[rows]}))


def _light_table(lights: dict, device) -> LightTable:
    cols = {k: torch.as_tensor(np.asarray(lights[k]), device=device)
            for k in LIGHT_FIELDS + ENV_FIELDS + MAP_LIGHT_FIELDS}
    return LightTable(**cols, env_distr=smp.distribution_2d_from_numpy(
        lights["env_distr"], device))


def _refuse(present, supported: dict, what: str):
    missing = [t for t in present if t not in supported]
    if missing:
        raise NotImplementedError(
            f"{what} id(s) {missing}: the port renders {sorted(supported.values())}")


@dataclasses.dataclass
class _PrimBlock:
    """The primitives one add_* call made, as arrays (per-prim Python
    objects cost seconds at a million triangles)."""
    shape_type: int
    shape_idx: np.ndarray  # [k]
    material: int
    arealight: np.ndarray  # [k]
    bmin: np.ndarray  # [k, 3]
    bmax: np.ndarray  # [k, 3]
    medium_inside: int = -1
    medium_outside: int = -1


class SceneBuilder:
    """Accumulates shapes, materials and lights, then freezes them into
    SceneArrays.  Same calls and same arrays as pbrt_tpu.scene.SceneBuilder
    for the supported subset."""

    def __init__(self):
        self.blocks: list[_PrimBlock] = []
        self.tri_indices: list[np.ndarray] = []
        self.tri_p: list[np.ndarray] = []
        self.tri_n: list[np.ndarray] = []
        self.tri_uv: list[np.ndarray] = []
        self.tri_has_n: list[np.ndarray] = []
        self.tri_has_uv: list[np.ndarray] = []
        self._n_verts = 0
        self._n_tris = 0
        self.quadrics: list[tuple] = []
        self.curves: list[np.ndarray] = []  # curve_packed rows
        self.instances: list[np.ndarray] = []  # inst_xf rows
        self.inst_tri: list[np.ndarray] = []  # [k, 2] (template row, instance)
        self._template: Optional[list] = None  # the mesh template in capture
        self.materials: list[dict] = []
        self.lights: list[dict] = []
        self.light_strategy = "uniform"  # "uniform" | "power"
        self.textures = HostTextureTable()
        self.media = HostMediumTable()
        self.camera_medium = -1
        # host seconds of set-up steps, by name ("BVH build"; the scene
        # reader adds "loop subdivision", "NURBS" and "instancing")
        self.timings: dict = {}

    # -- materials --
    def add_material(self, mat_type: int = MAT_MATTE, **params) -> int:
        """params as the JAX builder's: kd, ks, kr, kt, sigma, roughness,
        urough, vrough, eta, remap_roughness, metal_eta, metal_k, opacity,
        disney (12 values), hair (6), mix_amount, mix_m1 and mix_m2 (a mix's
        two material rows, checked at build), the texture ids kd_tex,
        ks_tex, sigma_tex, roughness_tex, opacity_tex (rows of
        self.textures), fourier_file (a .bsdf path), and subsurface's ss_g,
        ss_scale, ss_sigma_a and ss_sigma_s (mm^-1, before the scale)."""
        _refuse((mat_type,), SUPPORTED_MATERIALS, "material type")
        m = _default_material()
        unknown = set(params) - set(m)
        if unknown:
            raise NotImplementedError(f"material parameters {sorted(unknown)}")
        m.update(params)
        m["mat_type"] = mat_type
        self.materials.append(m)
        return len(self.materials) - 1

    # -- shapes --
    def add_triangle_mesh(self, indices, p, n=None, uv=None,
                          object_to_world: Optional[tf.Transform] = None,
                          material: int = -1, arealight: int = -1,
                          medium_inside: int = -1,
                          medium_outside: int = -1) -> None:
        """Vertices are transformed to world here (triangle.cpp:54).
        medium_inside/outside: rows of self.media, -1 none."""
        indices = np.asarray(indices, np.int32).reshape(-1, 3)
        p = np.asarray(p, np.float32).reshape(-1, 3)
        if object_to_world is not None and not object_to_world.is_identity():
            p = object_to_world.apply_point(p).astype(np.float32)
            if n is not None:
                n = object_to_world.apply_normal(np.asarray(n, np.float32))
        nv = p.shape[0]
        nt = indices.shape[0]
        self.tri_indices.append(indices + self._n_verts)
        self.tri_p.append(p)
        self.tri_n.append(np.asarray(n, np.float32).reshape(-1, 3)
                          if n is not None else np.zeros((nv, 3), np.float32))
        self.tri_uv.append(np.asarray(uv, np.float32).reshape(-1, 2)
                           if uv is not None else np.zeros((nv, 2), np.float32))
        self.tri_has_n.append(np.full(nt, n is not None))
        self.tri_has_uv.append(np.full(nt, uv is not None))
        tri_v = p[indices]
        if self._template is not None:
            self._template.append(dict(
                t0=self._n_tris, nt=nt, verts=tri_v, material=material,
                arealight=arealight, medium_inside=medium_inside,
                medium_outside=medium_outside))
            self._n_verts += nv
            self._n_tris += nt
            return
        self.blocks.append(_PrimBlock(
            SHAPE_TRIANGLE, np.arange(self._n_tris, self._n_tris + nt),
            material, np.full(nt, arealight), tri_v.min(1), tri_v.max(1),
            medium_inside, medium_outside))
        self._n_verts += nv
        self._n_tris += nt

    def add_quadric(self, q_type: int, object_to_world: tf.Transform, params,
                    material: int = -1, arealight: int = -1,
                    reverse_orientation: bool = False, medium_inside: int = -1,
                    medium_outside: int = -1) -> int:
        """One quadric (pbrt_tpu/scene.py:463-521): params are its q_params
        (see shapes/quadrics.py), its world bounds the 8 transformed
        corners of its object bounds.  Area lights sit on spheres only:
        the JAX package drops the emission of the others."""
        if arealight >= 0 and q_type != SHAPE_SPHERE:
            raise NotImplementedError(
                f"an emissive {SUPPORTED_SHAPES[q_type]} (the JAX package drops "
                "its AreaLightSource; the port refuses it)")
        _refuse((q_type,), {k: SUPPORTED_SHAPES[k] for k in QUADRIC_SHAPES},
                "quadric type")
        qi = len(self.quadrics)
        rev = bool(reverse_orientation) ^ object_to_world.swaps_handedness()
        self.quadrics.append((q_type, object_to_world,
                              np.asarray(params, np.float32), rev))
        params = np.asarray(params, np.float64)  # the bounds' values
        r = float(params[0])
        if q_type in (SHAPE_SPHERE, SHAPE_CYLINDER, SHAPE_PARABOLOID):
            omin = np.array([-r, -r, float(params[1])])
            omax = np.array([r, r, float(params[2])])
        elif q_type == SHAPE_CONE:
            omin = np.array([-r, -r, 0.0])
            omax = np.array([r, r, float(params[1])])
        elif q_type == SHAPE_HYPERBOLOID:
            r = max(float(np.hypot(params[5], params[6])),
                    float(np.hypot(params[8], params[9])))
            omin = np.array([-r, -r, float(params[2])])
            omax = np.array([r, r, float(params[3])])
        else:  # disk
            h = float(params[2])
            omin = np.array([-r, -r, h - 1e-4])
            omax = np.array([r, r, h + 1e-4])
        corners = np.array([[x, y, z] for x in (omin[0], omax[0])
                            for y in (omin[1], omax[1])
                            for z in (omin[2], omax[2])], np.float32)
        wc = object_to_world.apply_point(corners)
        self.blocks.append(_PrimBlock(q_type, np.array([qi]), material,
                                      np.array([arealight]), wc.min(0)[None],
                                      wc.max(0)[None], medium_inside,
                                      medium_outside))
        return qi

    def add_sphere(self, object_to_world: tf.Transform, radius, material=-1,
                   arealight=-1, zmin=None, zmax=None, phimax_deg=360.0,
                   reverse_orientation=False, medium_inside=-1,
                   medium_outside=-1) -> int:
        zmin = -radius if zmin is None else zmin
        zmax = radius if zmax is None else zmax
        return self.add_quadric(
            SHAPE_SPHERE, object_to_world,
            (radius, zmin, zmax, np.deg2rad(phimax_deg)), material, arealight,
            reverse_orientation, medium_inside, medium_outside)

    def add_cone(self, object_to_world, radius, height, material=-1,
                 phimax_deg=360.0, reverse_orientation=False, medium_inside=-1,
                 medium_outside=-1) -> int:
        """shapes/cone.cpp CreateConeShape."""
        return self.add_quadric(
            SHAPE_CONE, object_to_world, (radius, height, np.deg2rad(phimax_deg)),
            material, -1, reverse_orientation, medium_inside, medium_outside)

    def add_paraboloid(self, object_to_world, radius, zmin, zmax, material=-1,
                       phimax_deg=360.0, reverse_orientation=False,
                       medium_inside=-1, medium_outside=-1) -> int:
        """shapes/paraboloid.cpp CreateParaboloidShape."""
        return self.add_quadric(
            SHAPE_PARABOLOID, object_to_world,
            (radius, zmin, zmax, np.deg2rad(phimax_deg)), material, -1,
            reverse_orientation, medium_inside, medium_outside)

    def add_hyperboloid(self, object_to_world, p1, p2, material=-1,
                        phimax_deg=360.0, reverse_orientation=False,
                        medium_inside=-1, medium_outside=-1) -> int:
        """shapes/hyperboloid.cpp: ah (x^2 + y^2) - ch z^2 = 1 through p1
        and p2, p1 marched along the segment while the solve is degenerate
        (the constructor's do/while), as pbrt_tpu/scene.py:561-596."""
        p1 = np.asarray(p1, np.float64)
        p2 = np.asarray(p2, np.float64)
        if p2[2] == 0.0:
            p1, p2 = p2, p1
        pp = p1.copy()
        ah = ch = np.inf
        for _ in range(64):
            r1s = pp[0] ** 2 + pp[1] ** 2
            r2s = p2[0] ** 2 + p2[1] ** 2
            z1s, z2s = pp[2] ** 2, p2[2] ** 2
            det = z1s * r2s - r1s * z2s
            if abs(det) > 1e-12:
                ah = (z1s - z2s) / det
                ch = (r1s - r2s) / det
                if np.isfinite(ah) and np.isfinite(ch):
                    break
            pp = pp + 2.0 * (p2 - p1)
        if not (np.isfinite(ah) and np.isfinite(ch)):
            raise ValueError("degenerate hyperboloid points")
        params = (ah, ch, float(min(p1[2], p2[2])), float(max(p1[2], p2[2])),
                  np.deg2rad(phimax_deg), p1[0], p1[1], p1[2], p2[0], p2[1], p2[2])
        return self.add_quadric(SHAPE_HYPERBOLOID, object_to_world, params,
                                material, -1, reverse_orientation,
                                medium_inside, medium_outside)

    def add_curve(self, cp, width0: float, width1: float,
                  curve_type: str = "flat", normals=None, object_to_world=None,
                  material: int = -1, splitdepth: int = 3) -> None:
        """Procedural curve primitives (shapes/curve.cpp CreateCurveShape,
        pbrt_tpu/scene.py:598-664): the cubic cp [4, 3] is split into
        2^splitdepth u-ranges, each split further until its refinement
        depth fits the test's 16 windows (curve.K_LOG2); normals [2, 3]
        are a ribbon's end normals."""
        from .shapes import curve as cv

        cp = np.asarray(cp, np.float32).reshape(4, 3)
        if object_to_world is not None and not object_to_world.is_identity():
            cp = object_to_world.apply_point(cp).astype(np.float32)
            if normals is not None:
                normals = object_to_world.apply_normal(np.asarray(normals, np.float32))
        if curve_type not in cv.CURVE_TYPES:
            raise NotImplementedError(f"curve type {curve_type!r}: the port has "
                                      f"{sorted(cv.CURVE_TYPES)}")
        ctype = cv.CURVE_TYPES[curve_type]
        n_seg = 1 << max(int(splitdepth), 0)
        ends = [(i / n_seg, (i + 1) / n_seg) for i in range(n_seg)]
        cps = cv.blossom_cps(cp.astype(np.float64), *np.asarray(ends).T)
        segs = []
        for c, (a, b) in zip(cps, ends):
            segs.extend(cv.split_curve_for_build(c, width0, width1, a, b))
        rows, bmin, bmax = [], [], []
        for cp12, u0, u1 in segs:
            rows.append(cv.pack_curve_rows(
                cp12[None], width0, width1, u0, u1, ctype,
                None if normals is None else normals[0:1],
                None if normals is None else normals[1:2])[0])
            lo, hi = cv.curve_prim_bounds(cp12, u0, u1, width0, width1)
            bmin.append(lo)
            bmax.append(hi)
        first = len(self.curves)
        self.curves.extend(rows)
        k = len(rows)
        self.blocks.append(_PrimBlock(SHAPE_CURVE, np.arange(first, first + k),
                                      material, np.full(k, -1), np.stack(bmin),
                                      np.stack(bmax)))

    # -- instancing (TransformedPrimitive, core/primitive.h:99-127) --
    def begin_mesh_template(self):
        """Capture the add_triangle_mesh calls that follow as a template:
        their rows are stored once, with no primitives."""
        self._template = []

    def end_mesh_template(self) -> list:
        t, self._template = self._template, None
        return t

    def add_mesh_instance(self, template, o2w: tf.Transform) -> int:
        """One SHAPE_TRIANGLE_INST primitive per template triangle, bounded
        by the instanced triangle in world space; the rows stay shared and
        the traversal moves the ray into object space
        (pbrt_tpu/scene.py:417-462).  An emissive template is refused (the
        JAX package drops its emission)."""
        iid = len(self.instances)
        self.instances.append(np.concatenate([
            np.asarray(o2w.m_inv, np.float32)[:3].reshape(12),
            np.asarray(o2w.m, np.float32)[:3].reshape(12)]))
        for blk in template:
            if blk["arealight"] >= 0:
                raise NotImplementedError(
                    "an emissive mesh inside an object instance (the JAX "
                    "package drops its emission; the port refuses it)")
            nt = blk["nt"]
            vw = o2w.apply_point(blk["verts"].reshape(-1, 3)).reshape(nt, 3, 3)
            base = sum(len(x) for x in self.inst_tri)
            self.blocks.append(_PrimBlock(
                SHAPE_TRIANGLE_INST, np.arange(base, base + nt), blk["material"],
                np.full(nt, -1), vw.min(1).astype(np.float32),
                vw.max(1).astype(np.float32), blk["medium_inside"],
                blk["medium_outside"]))
            self.inst_tri.append(np.stack([np.arange(blk["t0"], blk["t0"] + nt),
                                           np.full(nt, iid)], 1))
        return iid

    # -- lights --
    def add_point_light(self, light_to_world: tf.Transform, intensity) -> int:
        self.lights.append(dict(
            light_type=LIGHT_POINT, L=np.asarray(intensity, np.float32),
            pos=light_to_world.apply_point(np.zeros(3)).astype(np.float32)))
        return len(self.lights) - 1

    def add_spot_light(self, light_to_world: tf.Transform, intensity,
                       cone_angle_deg=30.0, cone_delta_deg=5.0) -> int:
        """SpotLight (lights/spot.cpp): at the light's origin, along its
        +z, full inside cone_angle - cone_delta, none beyond cone_angle."""
        pos = light_to_world.apply_point(np.zeros(3)).astype(np.float32)
        axis = light_to_world.apply_vector(np.array([0.0, 0.0, 1.0]))
        axis = axis / np.linalg.norm(axis)
        self.lights.append(dict(
            light_type=LIGHT_SPOT, L=np.asarray(intensity, np.float32), pos=pos,
            dir=axis.astype(np.float32),
            cos_falloff_start=float(np.cos(np.deg2rad(cone_angle_deg
                                                      - cone_delta_deg))),
            cos_falloff_end=float(np.cos(np.deg2rad(cone_angle_deg)))))
        return len(self.lights) - 1

    def add_distant_light(self, direction, L) -> int:
        """DistantLight (lights/distant.cpp): radiance L arriving from
        `direction` (toward the light)."""
        d = np.asarray(direction, np.float32)
        self.lights.append(dict(light_type=LIGHT_DISTANT,
                                L=np.asarray(L, np.float32),
                                dir=d / np.linalg.norm(d)))
        return len(self.lights) - 1

    def add_projection_light(self, light_to_world: tf.Transform, intensity,
                             fov_deg=45.0, image=None) -> int:
        """ProjectionLight (lights/projection.cpp:51-101): a point light
        projecting `image` through a frustum of fov_deg along its +z."""
        img = (np.ones((1, 1, 3), np.float32) if image is None
               else np.asarray(image, np.float32))
        aspect = img.shape[1] / img.shape[0]
        if aspect > 1.0:
            screen = (-aspect, aspect, -1.0, 1.0)
        else:
            screen = (-1.0, 1.0, -1.0 / aspect, 1.0 / aspect)
        self.lights.append(dict(
            light_type=LIGHT_PROJECTION, L=np.asarray(intensity, np.float32),
            pos=light_to_world.apply_point(np.zeros(3)).astype(np.float32),
            image=img, w2l=np.asarray(light_to_world.m_inv, np.float32),
            proj_screen=np.asarray(screen, np.float32),
            proj_tan_scale=float(1.0 / np.tan(np.deg2rad(fov_deg) / 2.0))))
        return len(self.lights) - 1

    def add_gonio_light(self, light_to_world: tf.Transform, intensity,
                        image=None) -> int:
        """GonioPhotometricLight (lights/goniometric.cpp:47-104): a point
        light scaled by an equirect map of its directions."""
        img = (np.ones((1, 1, 3), np.float32) if image is None
               else np.asarray(image, np.float32))
        self.lights.append(dict(
            light_type=LIGHT_GONIO, L=np.asarray(intensity, np.float32),
            pos=light_to_world.apply_point(np.zeros(3)).astype(np.float32),
            image=img, w2l=np.asarray(light_to_world.m_inv, np.float32)))
        return len(self.lights) - 1

    def add_infinite_light(self, L=(1.0, 1.0, 1.0), image=None,
                           world_to_light=None) -> int:
        """InfiniteAreaLight (lights/infinite.cpp): an equirect map (L
        already folded in, as the scene file's reader does) or a constant
        L, importance-sampled by luminance."""
        self.lights.append(dict(
            light_type=LIGHT_INFINITE, L=np.asarray(L, np.float32),
            image=None if image is None else np.asarray(image, np.float32),
            w2l=(np.eye(4, dtype=np.float32) if world_to_light is None
                 else np.asarray(world_to_light, np.float32))))
        return len(self.lights) - 1

    def add_area_light_handle(self, L, shape_type, shape_idx, two_sided=False,
                              n_samples=1) -> int:
        """One DiffuseAreaLight per shape (lights/diffuse.cpp)."""
        self.lights.append(dict(
            light_type=LIGHT_AREA, L=np.asarray(L, np.float32),
            shape_type=shape_type, shape_idx=shape_idx, two_sided=two_sided,
            n_samples=n_samples))
        return len(self.lights) - 1

    def add_emissive_sphere(self, object_to_world, radius, L, material=-1,
                            two_sided=False, n_samples=1):
        li = self.add_area_light_handle(L, SHAPE_SPHERE, len(self.quadrics),
                                        two_sided, n_samples)
        self.add_sphere(object_to_world, radius, material=material,
                        arealight=li)
        return li

    def add_emissive_triangle_mesh(self, indices, p, L, material=-1,
                                   object_to_world=None, two_sided=False,
                                   n_samples=1, n=None, uv=None):
        """One DiffuseAreaLight per triangle (api.cpp:1385-1407)."""
        first_tri = self._n_tris
        indices = np.asarray(indices, np.int32).reshape(-1, 3)
        first_light = len(self.lights)
        for k in range(indices.shape[0]):
            self.add_area_light_handle(L, SHAPE_TRIANGLE, first_tri + k,
                                       two_sided, n_samples)
        self.add_triangle_mesh(indices, p, n=n, uv=uv,
                               object_to_world=object_to_world,
                               material=material)
        self.blocks[-1].arealight = first_light + np.arange(indices.shape[0])
        return first_light

    # -- freeze --
    def build(self, max_prims_in_node: int = 7, device="cuda",
              bvh_method: str = "native") -> SceneArrays:
        """SceneArrays on `device` (the card unless the caller asks for the
        CPU).  bvh_method "numpy" selects the slow numpy BVH builder."""
        device = resolve_device(device)
        return SceneArrays.from_numpy(
            self.build_numpy(max_prims_in_node, bvh_method), device)

    def build_numpy(self, max_prims_in_node: int = 7,
                    bvh_method: str = "native") -> dict:
        """The scene as numpy arrays named like SceneArrays' fields."""
        if not self.blocks:
            raise ValueError("scene has no primitives")
        bmin = np.concatenate([b.bmin for b in self.blocks]).astype(np.float32)
        bmax = np.concatenate([b.bmax for b in self.blocks]).astype(np.float32)
        t0 = time.perf_counter()
        bvh = build_bvh(bmin, bmax, max_prims_in_node, method=bvh_method)
        self.timings["BVH build"] = (self.timings.get("BVH build", 0.0)
                                     + time.perf_counter() - t0)
        meta = np.concatenate([
            np.stack([np.full(b.shape_idx.shape, b.shape_type), b.shape_idx,
                      np.full(b.shape_idx.shape, b.material), b.arealight], 1)
            for b in self.blocks]).astype(np.int32)
        prim_meta = meta[bvh.order]
        med_ids = {key: np.concatenate([
            np.full(b.shape_idx.shape, getattr(b, key[5:])) for b in self.blocks
        ]).astype(np.int32)[bvh.order] for key in MEDIUM_ID_FIELDS[:2]}

        if self.tri_indices:
            tri_indices = np.concatenate(self.tri_indices)
            tri_p = np.concatenate(self.tri_p)
            tri_n = np.concatenate(self.tri_n)
            tri_uv = np.concatenate(self.tri_uv)
            tri_has_n = np.concatenate(self.tri_has_n)
            tri_has_uv = np.concatenate(self.tri_has_uv)
        else:
            tri_indices = np.zeros((1, 3), np.int32)
            tri_p = np.zeros((3, 3), np.float32)
            tri_n = np.zeros((3, 3), np.float32)
            tri_uv = np.zeros((3, 2), np.float32)
            tri_has_n = np.zeros(1, bool)
            tri_has_uv = np.zeros(1, bool)

        if self.quadrics:
            q_type = np.array([q[0] for q in self.quadrics], np.int32)
            q_o2w = np.stack([q[1].m for q in self.quadrics]).astype(np.float32)
            q_w2o = np.stack([q[1].m_inv for q in self.quadrics]).astype(np.float32)
            q_params = np.stack([np.pad(q[2], (0, 12 - len(q[2])))
                                 for q in self.quadrics]).astype(np.float32)
            q_rev = np.array([q[3] for q in self.quadrics], bool)
        else:
            q_type = np.zeros(1, np.int32)
            q_o2w = np.eye(4, dtype=np.float32)[None]
            q_w2o = np.eye(4, dtype=np.float32)[None]
            q_params = np.ones((1, 12), np.float32)
            q_rev = np.zeros(1, bool)

        tri_verts = tri_p[tri_indices].reshape(-1, 9).astype(np.float32)
        # One-row hit-record attributes: v0|v1|v2, uv (defaulted like GetUVs,
        # triangle.cpp:403-410), n0|n1|n2, has_n, pad.
        uvs = tri_uv[tri_indices].reshape(-1, 6).astype(np.float32)
        uvs[~tri_has_uv] = np.array([0, 0, 1, 0, 1, 1], np.float32)
        ns = tri_n[tri_indices].reshape(-1, 9).astype(np.float32)
        tri_attr = np.concatenate(
            [tri_verts, uvs, ns, tri_has_n.astype(np.float32)[:, None],
             np.zeros((tri_verts.shape[0], 1), np.float32)], -1
        ).astype(np.float32)
        q_packed = np.concatenate([q_w2o[:, :3, :].reshape(-1, 12), q_params],
                                  -1).astype(np.float32)
        q_prim_id = np.full(max(len(self.quadrics), 1), -1, np.int32)
        quad = np.isin(prim_meta[:, 0], QUADRIC_SHAPES)
        q_prim_id[prim_meta[quad, 1]] = np.nonzero(quad)[0]
        geometry = dict(
            curve_packed=(np.stack(self.curves).astype(np.float32)
                          if self.curves else None),
            inst_xf=(np.stack(self.instances).astype(np.float32)
                     if self.instances else None),
            inst_tri=(np.concatenate(self.inst_tri).astype(np.int32)
                      if self.inst_tri else None))
        light_table, light_distr = self._build_lights(bmin, bmax)
        materials, bssrdf_tables = self._build_materials()
        return dict(
            **bssrdf_tables, **geometry,
            bvh_min=bvh.nodes_min, bvh_max=bvh.nodes_max,
            bvh_offset=bvh.offset, bvh_nprims=bvh.n_prims, bvh_axis=bvh.axis,
            prim_meta=prim_meta, tri_indices=tri_indices, tri_p=tri_p,
            tri_attr=tri_attr, tri_verts=tri_verts, q_type=q_type,
            q_w2o=q_w2o, q_o2w=q_o2w, q_params=q_params, q_rev=q_rev,
            q_packed=q_packed, q_prim_id=q_prim_id,
            materials=materials, lights=light_table,
            light_distr=light_distr, textures=self.textures.to_numpy(),
            media=self.media.to_numpy(), camera_medium=np.int32(self.camera_medium),
            **med_ids,
        )

    def _build_materials(self) -> tuple:
        """(the material table's numpy columns, the BSSRDF tables)."""
        mats = self.materials or [dict(_default_material(), mat_type=MAT_MATTE)]
        out = {k: np.asarray([m[k] for m in mats], np.float32)
               for k in ("kd", "ks", "kr", "kt", "sigma", "roughness",
                         "urough", "vrough", "eta", "metal_eta", "metal_k",
                         "opacity", "mix_amount")}
        out["mat_type"] = np.array([m["mat_type"] for m in mats], np.int32)
        out["remap_roughness"] = np.array(
            [bool(m["remap_roughness"]) for m in mats])
        for col in TEXTURE_COLUMNS + ("mix_m1", "mix_m2", "bump_tex"):
            key = "roughness_tex" if col == "rough_tex" else col
            out[col] = np.array([int(m[key]) for m in mats], np.int32)
        out["disney"] = np.array([m["disney"] for m in mats], np.float32)
        out["hair"] = np.array([m["hair"] for m in mats], np.float32)
        tables = _subsurface_tables(mats, out)
        _fourier_tables(mats, out)
        return out, tables

    def _light_power(self, li: dict, world_radius: float) -> float:
        """Approximate emitted power for the "power" strategy
        (integrator.cpp:217 ComputeLightPowerDistribution), as the JAX
        package's (scene.py:1181-1216)."""
        L = np.asarray(li["L"], np.float64)
        y = float(0.212671 * L[0] + 0.715160 * L[1] + 0.072169 * L[2])
        t = li["light_type"]
        if t == LIGHT_POINT:
            return 4.0 * np.pi * y
        if t == LIGHT_SPOT:
            return 2.0 * np.pi * y * (
                1.0 - 0.5 * (li["cos_falloff_start"] + li["cos_falloff_end"]))
        if t == LIGHT_DISTANT:
            return y * np.pi * world_radius ** 2
        if t in (LIGHT_PROJECTION, LIGHT_GONIO):
            img = np.asarray(li["image"], np.float64)
            return float(img.mean()) * y * (2.0 if t == LIGHT_PROJECTION
                                             else 4.0) * np.pi
        if t == LIGHT_INFINITE:
            return y  # the JAX package's fall-through (scene.py:1216)
        if li["shape_type"] == SHAPE_SPHERE:
            r = float(self.quadrics[li["shape_idx"]][2][0])
            area = 4.0 * np.pi * r * r
        else:
            tri_indices = np.concatenate(self.tri_indices)
            tri_p = np.concatenate(self.tri_p)
            v = tri_p[tri_indices[li["shape_idx"]]]
            area = 0.5 * np.linalg.norm(np.cross(v[1] - v[0], v[2] - v[0]))
        return (2.0 if li.get("two_sided") else 1.0) * y * area * np.pi

    def _build_lights(self, bmin, bmax):
        center = 0.5 * (bmin.min(0) + bmax.max(0))
        radius = float(np.linalg.norm(bmax.max(0) - center))
        lights = self.lights or [dict(light_type=LIGHT_POINT,
                                      L=(0.0, 0.0, 0.0), pos=(0, 0, 0))]

        def col(key, default, dtype):
            return np.asarray([li.get(key, default) for li in lights]).astype(dtype)

        table = dict(
            light_type=col("light_type", LIGHT_POINT, np.int32),
            L=col("L", (0.0, 0.0, 0.0), np.float32),
            pos=col("pos", (0.0, 0.0, 0.0), np.float32),
            dir=col("dir", (0.0, 0.0, 1.0), np.float32),
            cos_falloff_start=col("cos_falloff_start", 1.0, np.float32),
            cos_falloff_end=col("cos_falloff_end", 0.0, np.float32),
            shape_type=col("shape_type", -1, np.int32),
            shape_idx=col("shape_idx", -1, np.int32),
            two_sided=col("two_sided", False, bool),
            n_samples=col("n_samples", 1, np.int32),
            world_radius=np.float32(max(radius, 1e-3)),
            world_center=center.astype(np.float32),
            **_env_payload(lights),
            **_map_light_payload(lights),
        )
        if self.light_strategy == "power" and self.lights:
            powers = np.array([self._light_power(li, radius) for li in lights])
            if powers.sum() <= 0:
                powers = np.ones(len(lights))
        elif self.light_strategy in ("uniform", "power"):
            powers = np.ones(len(lights))
        else:
            raise NotImplementedError(f"light strategy {self.light_strategy!r}")
        return table, smp.build_distribution_1d_np(powers)


def _default_material() -> dict:
    """The JAX builder's defaults (pbrt_tpu/scene.py:299-330, the
    subsurface ones :1084-1095)."""
    return dict(kd=(0.5, 0.5, 0.5), ks=(0.25, 0.25, 0.25), kr=(0.9, 0.9, 0.9),
                kt=(1.0, 1.0, 1.0), sigma=0.0, roughness=0.1, urough=-1.0,
                vrough=-1.0, eta=1.5, remap_roughness=True,
                metal_eta=(0.2004, 0.9240, 1.1022),
                metal_k=(3.9129, 2.4528, 2.1421), opacity=(1.0, 1.0, 1.0),
                disney=(0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 1.0, 0.0,
                        0.0),
                hair=(1.3, 1.3, 1.3, 0.3, 0.3, 2.0),
                mix_amount=(0.5, 0.5, 0.5), mix_m1=-1, mix_m2=-1, kd_tex=-1,
                ks_tex=-1, sigma_tex=-1, roughness_tex=-1, opacity_tex=-1,
                bump_tex=-1, fourier_file="", ss_g=0.0, ss_scale=1.0,
                ss_sigma_a=(0.0011, 0.0024, 0.014),
                ss_sigma_s=(2.55, 3.21, 3.77))


def _subsurface_tables(mats, out: dict) -> dict:
    """The subsurface columns (into `out`, with a subsurface row) and the
    scene's BSSRDF tables: one beam-diffusion table per distinct (g, eta),
    stacked in order of first use (pbrt_tpu/scene.py:1069-1116;
    subsurface.cpp:43-50 builds one per material)."""
    from .materials import bssrdf as bsx

    rows = [i for i, m in enumerate(mats) if m["mat_type"] == MAT_SUBSURFACE]
    if not rows:
        return {}
    sigma_t = np.zeros((len(mats), 3), np.float32)
    rho = np.zeros((len(mats), 3), np.float32)
    table = np.zeros(len(mats), np.int32)
    keys, tables = [], []
    for i in rows:
        m = mats[i]
        g, eta = float(m["ss_g"]), float(m["eta"])
        key = (round(g, 6), round(eta, 6))
        if key not in keys:
            keys.append(key)
            tables.append(bsx.beam_diffusion_table(g, eta))
        table[i] = keys.index(key)
        scale = float(m["ss_scale"])
        sig_a = scale * np.asarray(m["ss_sigma_a"], np.float32)
        sig_s = scale * np.asarray(m["ss_sigma_s"], np.float32)
        st = sig_a + sig_s
        sigma_t[i] = st
        rho[i] = np.where(st > 0, sig_s / np.maximum(st, 1e-20), 0.0)
    out.update(ss_sigma_t=sigma_t, ss_rho=rho, ss_table=table)
    return dict(
        bssrdf_rho_nodes=tables[0]["rho"], bssrdf_radius_nodes=tables[0]["radius"],
        bssrdf_profile=np.concatenate([t["profile"] for t in tables]),
        bssrdf_cdf=np.concatenate([t["cdf"] for t in tables]),
        bssrdf_rho_eff=np.concatenate([t["rho_eff"] for t in tables]))


def _fourier_tables(mats, out: dict):
    """Each distinct .bsdf file read once (materials/fourier.cpp's cache):
    "fourier" the tables, "fourier_id" each row's, -1 none, into `out`
    with a fourier row."""
    from .materials.fourier import read_bsdf

    paths: dict = {}
    ids = np.full(len(mats), -1, np.int32)
    for i, m in enumerate(mats):
        if m["mat_type"] == MAT_FOURIER:
            if not m["fourier_file"]:
                raise ValueError(f"fourier material {i} names no .bsdf file")
            ids[i] = paths.setdefault(m["fourier_file"], len(paths))
    if paths:
        out.update(fourier_id=ids,
                   fourier=tuple(read_bsdf(p) for p in paths))


def _map_light_payload(lights) -> dict:
    """The projection and goniometric lights' maps (pbrt_tpu/scene.py:
    1246-1274): the first light of each kind gives its map, its
    world-to-light matrix and, for projection, its screen window with the
    fov scale folded in; 1x1 white placeholders without one.  The JAX
    package serves every light of a kind with the first one's payload; the
    port raises on a second light whose payload differs."""
    out = dict(proj_img=np.ones((1, 1, 3), np.float32),
               proj_w2l=np.eye(4, dtype=np.float32),
               proj_screen=np.asarray([-1.0, 1.0, -1.0, 1.0], np.float32),
               proj_light_idx=np.int32(-1),
               gonio_img=np.ones((1, 1, 3), np.float32),
               gonio_w2l=np.eye(4, dtype=np.float32),
               gonio_light_idx=np.int32(-1))
    for i, li in enumerate(lights):
        kind = {LIGHT_PROJECTION: "proj", LIGHT_GONIO: "gonio"}.get(
            li.get("light_type"))
        if kind is None:
            continue
        payload = {f"{kind}_img": np.asarray(li["image"], np.float32),
                   f"{kind}_w2l": np.asarray(li["w2l"], np.float32)}
        if kind == "proj":
            payload["proj_screen"] = (np.asarray(li["proj_screen"], np.float32)
                                      / max(li["proj_tan_scale"], 1e-6))
        if out[f"{kind}_light_idx"] < 0:
            out.update(payload, **{f"{kind}_light_idx": np.int32(i)})
        elif not all(np.array_equal(v, out[k]) for k, v in payload.items()):
            raise NotImplementedError(
                f"light {i}: a second {SUPPORTED_LIGHTS[li['light_type']]} "
                "light with its own map or transform (the JAX package would "
                "serve it with the first one's)")
    return out


def _env_payload(lights) -> dict:
    """The first infinite light with a map (InfiniteAreaLight ctor,
    infinite.cpp:62-124): the map, its world-to-light matrix and the
    Distribution2D over luminance * sin(theta) (pbrt_tpu/scene.py:1218-1244);
    a 1x1 black placeholder without one."""
    env_idx = -1
    env_map = np.zeros((1, 1, 3), np.float32)
    env_w2l = np.eye(4, dtype=np.float32)
    for i, li in enumerate(lights):
        if li.get("light_type") == LIGHT_INFINITE and li.get("image") is not None:
            env_idx = i
            env_map = np.asarray(li["image"], np.float32)
            env_w2l = np.asarray(li.get("w2l", np.eye(4)), np.float32)
            break
    h = env_map.shape[0]
    lum = (0.212671 * env_map[..., 0] + 0.715160 * env_map[..., 1]
           + 0.072169 * env_map[..., 2])
    sin_theta = np.sin(np.pi * (np.arange(h) + 0.5) / h)
    func = np.maximum(lum * sin_theta[:, None], 0.0) + 1e-9
    return dict(env_map=env_map, env_w2l=env_w2l,
                env_distr=smp.build_distribution_2d_np(func),
                env_light_idx=np.int32(env_idx))
