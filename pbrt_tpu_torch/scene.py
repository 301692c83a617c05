"""SceneArrays, the flattened scene as tensors on one device, and the host
SceneBuilder that assembles it.

Port of pbrt_tpu/scene.py (SceneBuilder, SceneArrays, statics.py) for the
shapes, materials, lights and textures of the path and direct-lighting
integrators:

* shapes: triangle meshes and spheres;
* materials: matte, plastic, mirror, glass (smooth and rough), with Kd, Ks,
  sigma and roughness bound to textures (textures/textures.py);
* lights: point lights, diffuse area lights on spheres and triangles, and
  infinite lights, constant or with an equirect map importance-sampled by a
  Distribution2D (one map a scene; the first wins, as in the JAX package);
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
from typing import Optional

import numpy as np
import torch

from .accel.build import build_bvh
from .core import sampling as smp
from .core import transform as tf
from .media.media import MEDIUM_NAMES, HostMediumTable, MediumTable
from .ops.bvh import build_bvh2_table, build_bvh4_table, build_prim_records
from .textures.textures import HostTextureTable, TextureTable, texture_meta

SHAPE_TRIANGLE = 0
SHAPE_SPHERE = 1

LIGHT_POINT = 0
LIGHT_AREA = 3
LIGHT_INFINITE = 4

MAT_MATTE = 0
MAT_PLASTIC = 1
MAT_MIRROR = 2
MAT_GLASS = 3

SUPPORTED_MATERIALS = {MAT_MATTE: "matte", MAT_PLASTIC: "plastic",
                       MAT_MIRROR: "mirror", MAT_GLASS: "glass"}
SUPPORTED_LIGHTS = {LIGHT_POINT: "point", LIGHT_AREA: "diffuse area",
                    LIGHT_INFINITE: "infinite"}
SUPPORTED_SHAPES = {SHAPE_TRIANGLE: "triangle", SHAPE_SPHERE: "sphere"}

# texture-bound material columns the port evaluates; the JAX package's
# bump_tex and opacity_tex (uber) have no material here and are refused
TEXTURE_COLUMNS = ("kd_tex", "ks_tex", "sigma_tex", "rough_tex")
MATERIAL_FIELDS = ("mat_type", "kd", "ks", "kr", "kt", "sigma", "roughness",
                   "urough", "vrough", "eta", "remap_roughness") + TEXTURE_COLUMNS
LIGHT_FIELDS = ("light_type", "L", "pos", "shape_type", "shape_idx",
                "two_sided", "n_samples", "world_radius", "world_center")
ENV_FIELDS = ("env_map", "env_w2l")
SCENE_FIELDS = ("bvh_min", "bvh_max", "bvh_offset", "bvh_nprims", "bvh_axis",
                "prim_meta", "tri_indices", "tri_p", "tri_attr", "tri_verts",
                "q_type", "q_w2o", "q_o2w", "q_params", "q_rev", "q_packed",
                "q_prim_id")
MEDIUM_ID_FIELDS = ("prim_medium_inside", "prim_medium_outside", "camera_medium")
_REFUSED_TEXTURE_COLUMNS = ("bump_tex", "opacity_tex")


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


def _tensors(cls, fields: dict, device):
    return cls(**{k: torch.as_tensor(np.asarray(fields[k]), device=device)
                  for k in (f.name for f in dataclasses.fields(cls))})


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
    # texture ids (-1: the constant column holds the value)
    kd_tex: torch.Tensor  # [M] i32
    ks_tex: torch.Tensor
    sigma_tex: torch.Tensor
    rough_tex: torch.Tensor


@dataclasses.dataclass(frozen=True)
class LightTable:
    light_type: torch.Tensor  # [L] i32
    L: torch.Tensor  # [L, 3] intensity (point), emitted radiance (area),
    #   scale (infinite)
    pos: torch.Tensor  # [L, 3]
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
    prim_tris: torch.Tensor  # [P, 12] f32
    materials: MaterialTable
    lights: LightTable
    light_distr: smp.Distribution1D
    # host-side facts fixed at build time
    bvh4_depth: int
    bvh2_depth: int
    mat_types: tuple
    light_types: tuple
    quadric_types: tuple
    quadric_rows: tuple  # ((quadric index, prim row), ...) for the quadric pass
    env_light_idx: int = -1  # the light row of the env map, -1 none
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
                raise NotImplementedError(f"material column {col}: bump "
                                          "mapping and uber opacity")
        tex_ids = tuple(sorted({int(i) for col in TEXTURE_COLUMNS
                                for i in np.asarray(mats[col]) if i >= 0}))
        tex = fields.get("textures")
        prim_meta = np.asarray(fields["prim_meta"])
        mat_types = tuple(sorted(set(np.asarray(mats["mat_type"]).tolist())))
        light_types = tuple(sorted(set(np.asarray(lights["light_type"]).tolist())))
        prim_types = tuple(sorted(set(prim_meta[:, 0].tolist())))
        _refuse(mat_types, SUPPORTED_MATERIALS, "material type")
        _refuse(light_types, SUPPORTED_LIGHTS, "light type")
        _refuse(prim_types, SUPPORTED_SHAPES, "shape type")
        area = np.asarray(lights["light_type"]) == LIGHT_AREA
        _refuse(tuple(np.asarray(lights["shape_type"])[area].tolist()),
                SUPPORTED_SHAPES, "area light shape")
        for key in ("kd_nodes", "curve_packed", "inst_tri"):
            if fields.get(key) is not None:
                raise NotImplementedError(f"scenes with {key}")
        media = _media_fields(fields)

        rows, depth = build_bvh4_table(fields["bvh_min"], fields["bvh_max"],
                                       fields["bvh_offset"],
                                       fields["bvh_nprims"])
        rows2, depth2 = build_bvh2_table(fields["bvh_min"], fields["bvh_max"],
                                         fields["bvh_offset"],
                                         fields["bvh_nprims"], fields["bvh_axis"])
        recs = build_prim_records(prim_meta[:, 0], prim_meta[:, 1],
                                  fields["tri_verts"])
        q_prim = np.asarray(fields["q_prim_id"])
        out = {k: torch.as_tensor(np.asarray(fields[k]), device=device)
               for k in SCENE_FIELDS}
        return SceneArrays(
            **out,
            bvh4_nodes=torch.as_tensor(rows, device=device),
            bvh2_nodes=torch.as_tensor(rows2, device=device),
            prim_tris=torch.as_tensor(recs, device=device),
            materials=_tensors(MaterialTable, mats, device),
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
            light_types=light_types,
            quadric_types=tuple(t for t in prim_types if t != SHAPE_TRIANGLE),
            quadric_rows=tuple((int(qi), int(r)) for qi, r in enumerate(q_prim)
                               if r >= 0),
            prim_medium_inside=torch.as_tensor(media["prim_medium_inside"],
                                               device=device),
            prim_medium_outside=torch.as_tensor(media["prim_medium_outside"],
                                                device=device),
            media=MediumTable.from_numpy(media["media"], device),
            camera_medium=media["camera_medium"],
            medium_types=media["medium_types"],
            has_media=media["has_media"],
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


def _light_table(lights: dict, device) -> LightTable:
    cols = {k: torch.as_tensor(np.asarray(lights[k]), device=device)
            for k in LIGHT_FIELDS + ENV_FIELDS}
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
        self.materials: list[dict] = []
        self.lights: list[dict] = []
        self.light_strategy = "uniform"  # "uniform" | "power"
        self.textures = HostTextureTable()
        self.media = HostMediumTable()
        self.camera_medium = -1

    # -- materials --
    def add_material(self, mat_type: int = MAT_MATTE, **params) -> int:
        """params as the JAX builder's: kd, ks, kr, kt, sigma, roughness,
        urough, vrough, eta, remap_roughness, and the texture ids kd_tex,
        ks_tex, sigma_tex, roughness_tex (rows of self.textures)."""
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
        self.blocks.append(_PrimBlock(
            SHAPE_TRIANGLE, np.arange(self._n_tris, self._n_tris + nt),
            material, np.full(nt, arealight), tri_v.min(1), tri_v.max(1),
            medium_inside, medium_outside))
        self._n_verts += nv
        self._n_tris += nt

    def add_sphere(self, object_to_world: tf.Transform, radius, material=-1,
                   arealight=-1, zmin=None, zmax=None, phimax_deg=360.0,
                   reverse_orientation=False, medium_inside=-1,
                   medium_outside=-1) -> int:
        zmin = -radius if zmin is None else zmin
        zmax = radius if zmax is None else zmax
        params = np.asarray((radius, zmin, zmax, np.deg2rad(phimax_deg)),
                            np.float32)
        qi = len(self.quadrics)
        rev = bool(reverse_orientation) ^ object_to_world.swaps_handedness()
        self.quadrics.append((SHAPE_SPHERE, object_to_world, params, rev))
        r = float(radius)
        omin = np.array([-r, -r, float(zmin)])
        omax = np.array([r, r, float(zmax)])
        corners = np.array([[x, y, z] for x in (omin[0], omax[0])
                            for y in (omin[1], omax[1])
                            for z in (omin[2], omax[2])], np.float32)
        wc = object_to_world.apply_point(corners)
        self.blocks.append(_PrimBlock(SHAPE_SPHERE, np.array([qi]), material,
                                      np.array([arealight]), wc.min(0)[None],
                                      wc.max(0)[None], medium_inside,
                                      medium_outside))
        return qi

    # -- lights --
    def add_point_light(self, light_to_world: tf.Transform, intensity) -> int:
        self.lights.append(dict(
            light_type=LIGHT_POINT, L=np.asarray(intensity, np.float32),
            pos=light_to_world.apply_point(np.zeros(3)).astype(np.float32)))
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
        bvh = build_bvh(bmin, bmax, max_prims_in_node, method=bvh_method)
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
        quad = prim_meta[:, 0] != SHAPE_TRIANGLE
        q_prim_id[prim_meta[quad, 1]] = np.nonzero(quad)[0]
        light_table, light_distr = self._build_lights(bmin, bmax)
        return dict(
            bvh_min=bvh.nodes_min, bvh_max=bvh.nodes_max,
            bvh_offset=bvh.offset, bvh_nprims=bvh.n_prims, bvh_axis=bvh.axis,
            prim_meta=prim_meta, tri_indices=tri_indices, tri_p=tri_p,
            tri_attr=tri_attr, tri_verts=tri_verts, q_type=q_type,
            q_w2o=q_w2o, q_o2w=q_o2w, q_params=q_params, q_rev=q_rev,
            q_packed=q_packed, q_prim_id=q_prim_id,
            materials=self._build_materials(), lights=light_table,
            light_distr=light_distr, textures=self.textures.to_numpy(),
            media=self.media.to_numpy(), camera_medium=np.int32(self.camera_medium),
            **med_ids,
        )

    def _build_materials(self) -> dict:
        mats = self.materials or [dict(_default_material(), mat_type=MAT_MATTE)]
        out = {k: np.asarray([m[k] for m in mats], np.float32)
               for k in ("kd", "ks", "kr", "kt", "sigma", "roughness",
                         "urough", "vrough", "eta")}
        out["mat_type"] = np.array([m["mat_type"] for m in mats], np.int32)
        out["remap_roughness"] = np.array(
            [bool(m["remap_roughness"]) for m in mats])
        for col in TEXTURE_COLUMNS:
            key = "roughness_tex" if col == "rough_tex" else col
            out[col] = np.array([int(m[key]) for m in mats], np.int32)
        return out

    def _light_power(self, li: dict) -> float:
        """Approximate emitted power for the "power" strategy
        (integrator.cpp:217 ComputeLightPowerDistribution)."""
        L = np.asarray(li["L"], np.float64)
        y = float(0.212671 * L[0] + 0.715160 * L[1] + 0.072169 * L[2])
        if li["light_type"] == LIGHT_POINT:
            return 4.0 * np.pi * y
        if li["light_type"] == LIGHT_INFINITE:
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
            shape_type=col("shape_type", -1, np.int32),
            shape_idx=col("shape_idx", -1, np.int32),
            two_sided=col("two_sided", False, bool),
            n_samples=col("n_samples", 1, np.int32),
            world_radius=np.float32(max(radius, 1e-3)),
            world_center=center.astype(np.float32),
            **_env_payload(lights),
        )
        if self.light_strategy == "power" and self.lights:
            powers = np.array([self._light_power(li) for li in lights])
            if powers.sum() <= 0:
                powers = np.ones(len(lights))
        elif self.light_strategy in ("uniform", "power"):
            powers = np.ones(len(lights))
        else:
            raise NotImplementedError(f"light strategy {self.light_strategy!r}")
        return table, smp.build_distribution_1d_np(powers)


def _default_material() -> dict:
    """The JAX builder's defaults for the columns the port keeps."""
    return dict(kd=(0.5, 0.5, 0.5), ks=(0.25, 0.25, 0.25), kr=(0.9, 0.9, 0.9),
                kt=(1.0, 1.0, 1.0), sigma=0.0, roughness=0.1, urough=-1.0,
                vrough=-1.0, eta=1.5, remap_roughness=True, kd_tex=-1,
                ks_tex=-1, sigma_tex=-1, roughness_tex=-1)


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
