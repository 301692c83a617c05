#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (pbrt_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--profile FILE]

Phases, each printing its result on a line of its own and its seconds:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: csrc/bvh4_traverse.cu and csrc/bvh2_traverse.cu (one nvcc each,
     sm_90a) and the host BVH builder (g++), all compilers started together,
     into build/, with ptxas's registers, shared memory and spills of each
     kernel; then the layout probe's Triton kernel, compiled once;
  3. BVH kernels: bvh4_traverse and bvh2_traverse each held against its
     plain PyTorch version on the card, bit for bit, and bvh2 against bvh4,
     on a 200-triangle soup, on a ~1M-triangle mesh with 64k rays, and on
     every launch of one sample of the main path (its camera rays and each
     bounce's merged NEE batch, replayed with the work list `order` and the
     any-hit shadow lanes as the render launched it, with its live-lane
     count), once as the default path launches them and once under
     PBRT_TPU_BVH4=0; each with two floors, the bytes of one read of the
     tables and rays, and the bytes of every node and triangle visit; on
     the main batches bvh4 is also timed without its work list, on the rays
     gathered into sorted order beforehand (ms_gathered), beside the
     gathers and scatters that launch needs around it (glue_ms);
  4. layout probe: the Triton chain (form C) against form B at N = 163840,
     forms A, B and C timed eagerly (the host's launch path included), B
     and C on the device alone (a CUDA graph of 50 calls, inputs cycled
     past the L2), then the probe's entry point driven once;
  5. main path: pbrt_tpu_torch.integrators.path.render on a 400x400, 8 spp,
     depth-5 scene of ~262k triangles (halton sampler, box filter): finite,
     non-zero, 8 x (1 + 5) kernel launches, and a bit-identical repeat;
     with --profile FILE, one more sample under torch.profiler, its table
     of device operations written to FILE, the traversal's device time
     split into the kernel, the key and argsort, the sphere pass and the
     rest;
  6. card against CPU: a small scene rendered on the card and on the CPU
     (the plain versions) at depth 1 (per pixel) and depth 3 (image mean);
  7. parity ladder: the in-repo ladder scenes, d_media_volpath (media,
     volpath) among them, through render.render_file on the card, against
     the pbrt-v3 goldens at tests/test_parity_images.py's thresholds;
  8. CLI: the main scene written as a .pbrt file and a binary PLY, rendered
     by `python -m pbrt_tpu_torch` in a subprocess and by render_file with
     each BVH kernel once (spatial light distribution), 48 launches of
     that kernel and none of the other, images equal to phase 5's;
  9. grad: parallel.diff.render_grad_step on phase 5's scene, one halton
     batch at 400x400, depth 5, every DEFAULT_PARAMS leaf, weights of ones:
     a warm step at sample 0, then at samples 1 and 2 a step with remat on
     (1 + 5 + 5 = 11 launches), one with remat off (6), and the forward
     alone under no_grad; L bit-equal to that forward, the remat and
     no-remat gradients within 1e-4 of each leaf's largest entry, every
     leaf finite, kd and camera gradients non-zero; the walls, Mrays/s and
     peak memories printed; then one remat step under PBRT_TPU_BVH4=0 (11
     bvh2 launches), and the backward of a material gather at the batch's
     width by indexing (what the step runs) and by index_select, timed and
     held against each other; with --profile FILE, one more remat step under
     torch.profiler, its table written to FILE's name plus "_grad";
 10. config3: BASELINE config 3's features through render.render_file on
     the main scene's blob (an EWA imagemap on the blob, a checkerboard
     floor, a smooth and a rough glass sphere, an env map; 400x400 @ 64
     spp, depth 5, spatial distribution): Mrays/s, wall, process CPU and
     set-up by phase (the pyramid and the env CDF timed alone too), 384
     bvh4 launches, a bit-identical repeat, PBRT_TPU_BVH4=0 with 384 bvh2
     launches at tests/test_torch_path.py:58-59's bars against bvh4, and a
     64x64 @ 2 spp copy on the card against the CPU at the same bars; with
     --profile FILE, one spp under torch.profiler, its table written to
     FILE's name plus "_config3";
 11. direct: Integrator "directlighting" through render_file:
     b_arealight with strategy "one" at maxdepth 1 against its pbrt-v3
     golden at tests/test_parity_images.py's bars, and the main scene at
     400x400 @ 8 spp, depth 5, strategies "one" and "all" (88 bvh4
     launches each);
 12. config4: BASELINE config 4 through render.render_file
     (write_config4_pbrt): the main scene's blob, floor, wall, emissive
     sphere and a point light, a material-less sphere of homogeneous fog
     in the mirror's place and a material-less box beside the blob holding
     a seeded 128^3 density grid (8.4 MB); volpath, 400x400 @ 8 spp, depth
     5, halton, spatial distribution: Mrays/s (live traversal lanes over
     the render's wall), the wall a spp, process CPU and set-up by phase,
     the bytes on the card, 688 bvh4 launches (86 a spp), a bit-identical
     repeat, PBRT_TPU_BVH4=0 with 688 bvh2 launches against bvh4 and a
     64x64 @ 2 spp copy on the card against the CPU, both at
     tests/test_torch_path.py:58-59's bars, and each kernel against its
     plain version and bvh2 against bvh4 on the camera batch and the first
     segment of each of the four walks (the surface's at bounce 0, the
     medium vertex's at bounce 1); with --profile FILE,
     one spp under torch.profiler, its table written to FILE's name plus
     "_config4" (ranges "layer: media / delta tracking", "/ ratio
     tracking", "/ Tr walk", "/ medium NEE");
 13. whitted and ao: the main scene's file with Integrator "whitted"
     (maxdepth 5, 88 launches) and "ao" (nsamples 64, 520 launches) at
     400x400 @ 8 spp: finite, non-zero, a bit-identical repeat, a 64x64 @
     2 spp copy on the card against the CPU at tests/test_torch_path.py:
     58-59's bars, and each kernel against its plain version and bvh2
     against bvh4 on the batches of one spp as each render launched them:
     the camera rays, whitted's bounce-0 shadow rays and ao's first probe
     (every lane any-hit, unbounded);
 14. breadth: pbrt-v3's classic material and light set through
     render.render_file (write_breadth_pbrt): the main scene's blob in uber,
     the floor in substrate, the wall in translucent with a spot light
     behind it, the mirror sphere in metal (copper), a sphere mixing matte
     and metal, a sphere in uber with an imagemap opacity, the emissive
     sphere and a distant, a projection (a seeded 64x64 slide) and a
     goniometric light (a seeded 32x64 map); path at 400x400 @ 8 spp,
     depth 5, spatial distribution: Mrays/s, the wall a spp, process CPU
     and set-up by phase, the bytes on the card, 48 bvh4 launches, a
     bit-identical repeat, PBRT_TPU_BVH4=0 with 48 bvh2 launches against
     bvh4, a 64x64 @ 1 spp copy under path, directlighting "all" and
     volpath on the card against the CPU (the CPU scene takes the card's
     spatial distribution), all at tests/test_torch_path.py:
     58-59's bars, and each kernel against its plain version bit for bit
     and bvh2 against bvh4 on one spp's camera batch and bounce-0 merged
     batch (its shadow lanes reach every kind of light, the distant one's
     at twice the scene's radius); with --profile FILE, one spp under
     torch.profiler, its table written to FILE's name plus "_breadth"
     (ranges "layer: materials" and "layer: lights", main's beside them in
     phase 5's table);
then a JSON line listing each kernel, and last the JSON result line.  A
failed phase raises, so the script exits non-zero and prints no result.  It
needs the repository beside it and a CUDA card; it does not use JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
SMOKE_DIR = HERE / "build" / "smoke"
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores
SLAB_FLOPS = 27  # one box's slab test
TRI_FLOPS = 45  # per Moller-Trumbore test
SPP, DEPTH, RES = 8, 5, (400, 400)
# traversal launches a spp at DEPTH: config4 (volpath with media) 1 + 16
# walk segments a bounce but the last, 1 at the last; whitted on the main
# scene (one light) 1 + 1 a bounce but the last, 1 at the last; ao 1 + 64
CONFIG4_LAUNCHES = DEPTH * (1 + 16) + 1
WHITTED_LAUNCHES = DEPTH * (1 + 1) + 1
AO_SAMPLES = 64

# tests/test_parity_images.py:35-49: (scene, rel-tol, min match_frac,
# max mean-rel).  c2u_uniform has no golden; killeroo_64_4spp (it includes
# files from outside the repository) is not rendered.
LADDER = [
    ("a_floor_point", 1e-3, 0.995, 5e-3),
    ("c3_plastic_d1", 1e-3, 0.995, 5e-3),
    ("b_arealight", 1e-3, 0.999, 1e-4),
    ("c2_twolights_d2", 1e-3, 0.995, 1e-3),
    ("c4_mirror_d3", 1e-3, 0.995, 1e-3),
    ("c1_matte_point_d5", 1e-3, 0.70, 1e-3),
    ("c_indirect", 2e-2, 0.70, 2e-2),
    ("d_media_volpath", 1e-3, 0.60, 4e-2),
]


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str):
    if not ok:
        raise SmokeFailure(what)


def phase(name: str, t0: float):
    print(f"phase {name}: {time.perf_counter() - t0:.2f} s", flush=True)


@contextlib.contextmanager
def bvh_switch(value: str):
    """PBRT_TPU_BVH4 (the JAX package's switch, which the port reads at
    each traversal) set to `value` inside the block, restored after."""
    old = os.environ.get("PBRT_TPU_BVH4")
    os.environ["PBRT_TPU_BVH4"] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("PBRT_TPU_BVH4")
        else:
            os.environ["PBRT_TPU_BVH4"] = old


# ---------------------------------------------------------------------------
# Scenes, made from seeds with numpy
# ---------------------------------------------------------------------------

def blob_mesh(nu: int, nv: int, seed: int, center, radius: float):
    """A closed, displaced, tessellated sphere: 2 * nu * nv triangles."""
    rs = np.random.RandomState(seed)
    th = np.linspace(0.0, np.pi, nv + 1)
    ph = np.linspace(0.0, 2 * np.pi, nu, endpoint=False)
    T, P = np.meshgrid(th, ph, indexing="ij")
    r = np.ones_like(T)
    for _ in range(6):
        a, k, l, s = rs.rand() * 0.06, rs.randint(2, 9), rs.randint(1, 7), rs.rand() * 6.3
        r += a * np.sin(k * T + s) * np.cos(l * P + s)
    r *= radius
    v = np.stack([r * np.sin(T) * np.cos(P), r * np.sin(T) * np.sin(P),
                  r * np.cos(T)], -1).reshape(-1, 3) + np.asarray(center)
    i = np.arange(nv)[:, None]
    j = np.arange(nu)[None, :]
    a = i * nu + j
    b = i * nu + (j + 1) % nu
    c = (i + 1) * nu + j
    d = (i + 1) * nu + (j + 1) % nu
    idx = np.concatenate([np.stack([a, c, b], -1).reshape(-1, 3),
                          np.stack([b, c, d], -1).reshape(-1, 3)])
    return idx.astype(np.int32), v.astype(np.float32)


def main_scene(builder_cls, sc, tf):
    """The demo scene of __graft_entry__._demo_scene at BASELINE config 1's
    size: a ~262k-triangle plastic blob, matte floor and back wall, a mirror
    sphere and one emissive sphere light (L = 40)."""
    b = builder_cls()
    matte = b.add_material(sc.MAT_MATTE, kd=(0.5, 0.5, 0.8))
    plastic = b.add_material(sc.MAT_PLASTIC, kd=(0.4, 0.2, 0.2),
                             ks=(0.5, 0.5, 0.5), roughness=0.025)
    mirror = b.add_material(sc.MAT_MIRROR, kr=(0.9, 0.9, 0.9))
    b.add_triangle_mesh([[0, 1, 2], [2, 3, 0]],
                        [[-10, -10, 0], [10, -10, 0], [10, 10, 0], [-10, 10, 0]],
                        material=matte)
    b.add_triangle_mesh([[0, 1, 2], [2, 3, 0]],
                        [[-10, 6, 0], [10, 6, 0], [10, 6, 12], [-10, 6, 12]],
                        material=matte)
    idx, v = blob_mesh(512, 256, seed=0, center=(0.0, 0.0, 2.2), radius=2.0)
    b.add_triangle_mesh(idx, v, material=plastic)
    b.add_sphere(tf.translate(3.7, -0.5, 1.2), 1.2, material=mirror)
    b.add_emissive_sphere(tf.translate(0, 5, 8), 0.5, L=(40.0, 40.0, 40.0),
                          material=matte)
    return b


def demo_scene(builder_cls, sc, tf):
    """__graft_entry__._demo_scene, call for call."""
    b = builder_cls()
    matte = b.add_material(sc.MAT_MATTE, kd=(0.5, 0.5, 0.8))
    plastic = b.add_material(sc.MAT_PLASTIC, kd=(0.4, 0.2, 0.2),
                             ks=(0.5, 0.5, 0.5), roughness=0.025)
    b.add_triangle_mesh([[0, 1, 2], [2, 3, 0]],
                        [[-10, -10, 0], [10, -10, 0], [10, 10, 0], [-10, 10, 0]],
                        material=matte)
    rs = np.random.RandomState(0)
    c = rs.randn(64, 1, 3) * 1.5 + np.array([0, 0, 3.0])
    v = c + rs.randn(64, 3, 3) * 0.4
    b.add_triangle_mesh(np.arange(192).reshape(-1, 3), v.reshape(-1, 3),
                        material=plastic)
    b.add_sphere(tf.translate(2, 0, 2), 0.8, material=plastic)
    b.add_emissive_sphere(tf.translate(0, 5, 8), 0.5, L=(40.0, 40.0, 40.0),
                          material=matte)
    return b


def soup_scene(builder_cls, sc, tf, n_tris=200, seed=0):
    """tests/test_pallas_bvh.py:_tri_scene."""
    rs = np.random.RandomState(seed)
    b = builder_cls()
    m = b.add_material(sc.MAT_MATTE)
    c = rs.randn(n_tris, 1, 3) * 2.0
    v = c + rs.randn(n_tris, 3, 3) * 0.5
    b.add_triangle_mesh(np.arange(3 * n_tris).reshape(-1, 3), v.reshape(-1, 3),
                        material=m)
    b.add_point_light(tf.translate(0, 0, 5), (1, 1, 1))
    return b


def camera_for(cameras, tf, res):
    return cameras.make_perspective_camera(
        tf.look_at([0, -8, 4], [0, 0, 2], [0, 0, 1]), res, fov_deg=45.0)


MAIN_PBRT = """LookAt 0 -8 4  0 0 2  0 0 1
Camera "perspective" "float fov" [45]
Film "image" "integer xresolution" [{xres}] "integer yresolution" [{yres}]
  "string filename" "main.pfm"
Sampler "halton" "integer pixelsamples" [{spp}]
Integrator "path" "integer maxdepth" [{depth}]
WorldBegin
Material "matte" "rgb Kd" [0.5 0.5 0.8]
Shape "trianglemesh" "point P" [-10 -10 0  10 -10 0  10 10 0  -10 10 0]
  "integer indices" [0 1 2 2 3 0]
Shape "trianglemesh" "point P" [-10 6 0  10 6 0  10 6 12  -10 6 12]
  "integer indices" [0 1 2 2 3 0]
AttributeBegin
  Material "plastic" "rgb Kd" [0.4 0.2 0.2] "rgb Ks" [0.5 0.5 0.5]
    "float roughness" [0.025]
  Shape "plymesh" "string filename" "blob.ply"
AttributeEnd
AttributeBegin
  Material "mirror" "rgb Kr" [0.9 0.9 0.9]
  Translate 3.7 -0.5 1.2
  Shape "sphere" "float radius" [1.2]
AttributeEnd
AttributeBegin
  Translate 0 5 8
  AreaLightSource "diffuse" "rgb L" [40 40 40]
  Shape "sphere" "float radius" [0.5]
AttributeEnd
WorldEnd
"""


def write_ply(path: Path, idx, v, uv=None):
    """A binary little-endian PLY: float x y z (and u v) per vertex."""
    props = "xyz" + ("uv" if uv is not None else "")
    head = (f"ply\nformat binary_little_endian 1.0\nelement vertex {len(v)}\n"
            + "".join(f"property float {c}\n" for c in props)
            + f"element face {len(idx)}\nproperty list uchar int vertex_indices\n"
            "end_header\n").encode()
    verts = v if uv is None else np.concatenate([v, uv], -1)
    faces = np.zeros(len(idx), np.dtype([("n", "u1"), ("i", "<i4", (3,))]))
    faces["n"] = 3
    faces["i"] = idx
    with open(path, "wb") as f:
        f.write(head + verts.astype("<f4").tobytes() + faces.tobytes())


def write_main_pbrt(out_dir: Path) -> Path:
    """main_scene as a .pbrt file (the default light strategy, spatial) and
    its blob as a binary little-endian PLY, shape for shape."""
    out_dir.mkdir(parents=True, exist_ok=True)
    idx, v = blob_mesh(512, 256, seed=0, center=(0.0, 0.0, 2.2), radius=2.0)
    write_ply(out_dir / "blob.ply", idx, v)
    path = out_dir / "main.pbrt"
    path.write_text(MAIN_PBRT.format(xres=RES[0], yres=RES[1], spp=SPP,
                                     depth=DEPTH))
    return path


CONFIG3_PBRT = """LookAt 0 -8 4  0 0 2  0 0 1
Camera "perspective" "float fov" [45]
Film "image" "integer xresolution" [{xres}] "integer yresolution" [{yres}]
  "string filename" "config3.pfm"
Sampler "halton" "integer pixelsamples" [{spp}]
Integrator "path" "integer maxdepth" [{depth}]{extra}
WorldBegin
AttributeBegin
  LightSource "infinite" "string mapname" "env.pfm" "rgb L" [1 1 1]
AttributeEnd
Texture "checks" "spectrum" "checkerboard" "float uscale" [8] "float vscale" [8]
  "rgb tex1" [0.8 0.8 0.8] "rgb tex2" [0.2 0.3 0.4]
Texture "skin" "spectrum" "imagemap" "string filename" "skin.pfm"
  "bool trilinear" "false"
Material "matte" "texture Kd" "checks"
Shape "trianglemesh" "point P" [-10 -10 0  10 -10 0  10 10 0  -10 10 0]
  "integer indices" [0 1 2 2 3 0] "point2 uv" [0 0  1 0  1 1  0 1]
AttributeBegin
  Material "plastic" "texture Kd" "skin" "rgb Ks" [0.5 0.5 0.5]
    "float roughness" [0.025]
  Shape "plymesh" "string filename" "blob.ply"
AttributeEnd
AttributeBegin
  Material "glass" "float eta" [1.5]
  Translate 3.7 -0.5 1.2
  Shape "sphere" "float radius" [1.2]
AttributeEnd
AttributeBegin
  Material "glass" "float eta" [1.5] "float uroughness" [0.1]
  Translate -3.4 -1.5 1.0
  Shape "sphere" "float radius" [1.0]
AttributeEnd
AttributeBegin
  Translate 0 5 8
  AreaLightSource "diffuse" "rgb L" [40 40 40]
  Shape "sphere" "float radius" [0.5]
AttributeEnd
WorldEnd
"""


def write_config3_pbrt(out_dir: Path, res=RES, spp=64, blob=(512, 256),
                       skin=(512, 512), env=(512, 256), extra="") -> Path:
    """BASELINE config 3's features on the main scene's blob: the blob in
    plastic with an imagemap Kd (EWA: "trilinear" false) on a seeded image,
    the floor matte with a checkerboard Kd, a smooth and a rough glass
    sphere (the JAX package's glass reads "uroughness"), and an infinite
    light with a seeded equirect map beside the emissive sphere.  The blob
    (blob = (nu, nv), 2 nu nv triangles) is a PLY with spherical uv; the
    images are PFM, skin (w, h) and env (w, h).  extra: more parameters of
    the Integrator line."""
    from pbrt_tpu_torch.utils.imageio import write_pfm

    out_dir.mkdir(parents=True, exist_ok=True)
    idx, v = blob_mesh(blob[0], blob[1], seed=0, center=(0.0, 0.0, 2.2),
                       radius=2.0)
    th, ph = np.meshgrid(np.linspace(0.0, 1.0, blob[1] + 1),
                         np.arange(blob[0]) / blob[0], indexing="ij")
    write_ply(out_dir / "blob.ply", idx, v,
              np.stack([ph, th], -1).reshape(-1, 2).astype(np.float32))
    rs = np.random.RandomState(3)
    tex = 0.15 + 0.7 * rs.rand(skin[1], skin[0], 3)
    tex[:, ::16] = (0.9, 0.8, 0.1)  # stripes that the pyramid blurs away
    write_pfm(str(out_dir / "skin.pfm"), tex.astype(np.float32))
    # sky: brighter toward the zenith (v = 0), one warm sun, seeded grain
    h, w = env[1], env[0]
    theta = (np.arange(h) + 0.5) / h * np.pi
    sky = (0.2 + 0.6 * np.clip(np.cos(theta), 0.0, 1.0))[:, None, None]
    sky = sky * np.array([0.6, 0.8, 1.0]) * (0.9 + 0.2 * rs.rand(h, w, 1))
    sky[h // 5: h // 5 + max(h // 32, 1), w // 3: w // 3 + max(w // 64, 1)] = (
        60.0, 50.0, 30.0)
    write_pfm(str(out_dir / "env.pfm"), sky.astype(np.float32))
    path = out_dir / "config3_path.pbrt"
    path.write_text(CONFIG3_PBRT.format(xres=res[0], yres=res[1], spp=spp,
                                        depth=DEPTH, extra=extra))
    return path


CONFIG4_PBRT = """LookAt 0 -8 4  0 0 2  0 0 1
Camera "perspective" "float fov" [45]
Film "image" "integer xresolution" [{xres}] "integer yresolution" [{yres}]
  "string filename" "config4.pfm"
Sampler "halton" "integer pixelsamples" [{spp}]
Integrator "volpath" "integer maxdepth" [{depth}]
WorldBegin
LightSource "point" "rgb I" [30 30 30] "point from" [-3 -5 7]
Material "matte" "rgb Kd" [0.5 0.5 0.8]
Shape "trianglemesh" "point P" [-10 -10 0  10 -10 0  10 10 0  -10 10 0]
  "integer indices" [0 1 2 2 3 0]
Shape "trianglemesh" "point P" [-10 6 0  10 6 0  10 6 12  -10 6 12]
  "integer indices" [0 1 2 2 3 0]
AttributeBegin
  Material "plastic" "rgb Kd" [0.4 0.2 0.2] "rgb Ks" [0.5 0.5 0.5]
    "float roughness" [0.025]
  Shape "plymesh" "string filename" "blob.ply"
AttributeEnd
AttributeBegin
  MakeNamedMedium "fog" "string type" "homogeneous"
    "rgb sigma_a" [0.12 0.12 0.12] "rgb sigma_s" [0.6 0.6 0.6] "float g" [0.2]
  Material ""
  MediumInterface "fog" ""
  Translate 3.7 -0.5 1.2
  Shape "sphere" "float radius" [1.2]
AttributeEnd
AttributeBegin
  MakeNamedMedium "smoke" "string type" "heterogeneous"
    "rgb sigma_a" [0.4 0.4 0.4] "rgb sigma_s" [2.0 2.0 2.0]
    "point p0" [{p0}] "point p1" [{p1}]
    "integer nx" [{n}] "integer ny" [{n}] "integer nz" [{n}]
    "float density" [{density}]
  Material ""
  MediumInterface "smoke" ""
  Shape "trianglemesh" "point P" [{box}]
    "integer indices" [0 2 1 0 3 2  4 5 6 4 6 7  0 1 5 0 5 4
                       3 6 2 3 7 6  0 4 7 0 7 3  1 2 6 1 6 5]
AttributeEnd
AttributeBegin
  Translate 0 5 8
  AreaLightSource "diffuse" "rgb L" [40 40 40]
  Shape "sphere" "float radius" [0.5]
AttributeEnd
WorldEnd
"""
SMOKE_BOX = ((-4.4, -1.4, 0.02), (-2.4, 0.6, 2.6))  # beside the blob


def smoke_density(n: int, seed: int = 7) -> np.ndarray:
    """A seeded, smooth density grid [n, n, n] (z, y, x) with values in
    [0, 2.4]: 1.2 plus a sum of three random plane waves, scaled."""
    rs = np.random.RandomState(seed)
    c = (np.arange(n, dtype=np.float32) + 0.5) / n
    z, y, x = np.meshgrid(c, c, c, indexing="ij")
    f = np.zeros((n, n, n), np.float32)
    for _ in range(3):
        k = rs.uniform(2.0, 9.0, 3).astype(np.float32)
        ph = np.float32(rs.uniform(0.0, 6.3))
        f += np.sin(k[0] * x + ph) * np.sin(k[1] * y + 2 * ph) * np.sin(k[2] * z + 3 * ph)
    return np.clip(1.2 + 1.2 * f / 3.0, 0.0, 2.4).astype(np.float32)


def write_config4_pbrt(out_dir: Path, res=RES, spp=SPP, blob=(512, 256),
                       grid=128) -> Path:
    """BASELINE config 4 on the main scene: the blob (2 nu nv triangles, a
    PLY) in plastic, the matte floor and back wall, the emissive sphere and
    a point light; the mirror sphere's place holds a material-less sphere
    of homogeneous fog (d_media_volpath's coefficients), and beside the
    blob a material-less box holds a heterogeneous medium whose seeded
    grid^3 density (smoke_density) fills it through p0/p1.  volpath at
    depth 5, halton, the spatial distribution."""
    out_dir.mkdir(parents=True, exist_ok=True)
    idx, v = blob_mesh(blob[0], blob[1], seed=0, center=(0.0, 0.0, 2.2),
                       radius=2.0)
    write_ply(out_dir / "blob.ply", idx, v)
    lo, hi = SMOKE_BOX
    corners = [(x, y, z) for z in (lo[2], hi[2])
               for (x, y) in ((lo[0], lo[1]), (hi[0], lo[1]), (hi[0], hi[1]),
                              (lo[0], hi[1]))]
    text = CONFIG4_PBRT.format(
        xres=res[0], yres=res[1], spp=spp, depth=DEPTH, n=grid,
        p0=" ".join(map(str, lo)), p1=" ".join(map(str, hi)),
        box="  ".join(" ".join(map(str, c)) for c in corners),
        density=" ".join(f"{x:.5g}" for x in smoke_density(grid).ravel()))
    path = out_dir / "config4.pbrt"
    path.write_text(text)
    return path


BREADTH_PBRT = """LookAt 0 -8 4  0 0 2  0 0 1
Camera "perspective" "float fov" [45]
Film "image" "integer xresolution" [{xres}] "integer yresolution" [{yres}]
  "string filename" "breadth.pfm"
Sampler "halton" "integer pixelsamples" [{spp}]
Integrator "path" "integer maxdepth" [{depth}]{extra}
WorldBegin
LightSource "distant" "point from" [0 0 0] "point to" [1 0.6 -2]
  "rgb L" [1.2 1.1 0.9]
AttributeBegin
  Translate 0 9 4
  Rotate 90 1 0 0
  LightSource "spot" "rgb I" [90 80 60] "float coneangle" [40]
    "float conedeltaangle" [10]
AttributeEnd
AttributeBegin
  Translate 0 -2 9
  Rotate 180 1 0 0
  LightSource "projection" "rgb I" [120 120 120] "float fov" [60]
    "string mapname" "slide.pfm"
AttributeEnd
AttributeBegin
  Translate -3 -3 5
  LightSource "goniometric" "rgb I" [25 25 25] "string mapname" "gonio.pfm"
AttributeEnd
Texture "op" "spectrum" "imagemap" "string filename" "opacity.pfm"
MakeNamedMaterial "mixa" "string type" "matte" "rgb Kd" [0.2 0.6 0.3]
MakeNamedMaterial "mixb" "string type" "metal" "float roughness" [0.05]
AttributeBegin
  Material "substrate" "rgb Kd" [0.5 0.5 0.7] "rgb Ks" [0.3 0.3 0.3]
    "float uroughness" [0.05] "float vroughness" [0.2]
  Shape "trianglemesh" "point P" [-10 -10 0  10 -10 0  10 10 0  -10 10 0]
    "integer indices" [0 1 2 2 3 0]
AttributeEnd
AttributeBegin
  Material "translucent" "rgb Kd" [0.6 0.5 0.4] "rgb Ks" [0.2 0.2 0.2]
    "rgb reflect" [0.5 0.5 0.5] "rgb transmit" [0.5 0.5 0.5]
    "float roughness" [0.1]
  Shape "trianglemesh" "point P" [-10 6 0  10 6 0  10 6 12  -10 6 12]
    "integer indices" [0 1 2 2 3 0]
AttributeEnd
AttributeBegin
  Material "uber" "rgb Kd" [0.3 0.3 0.3] "rgb Ks" [0.2 0.2 0.2]
    "rgb Kr" [0.1 0.1 0.1] "float roughness" [0.05]
  Shape "plymesh" "string filename" "blob.ply"
AttributeEnd
AttributeBegin
  Material "metal" "float roughness" [0.05]
  Translate 3.7 -0.5 1.2
  Shape "sphere" "float radius" [1.2]
AttributeEnd
AttributeBegin
  Material "mix" "string namedmaterial1" "mixa" "string namedmaterial2" "mixb"
    "rgb amount" [0.3 0.3 0.3]
  Translate 2.2 -3.2 0.8
  Shape "sphere" "float radius" [0.8]
AttributeEnd
AttributeBegin
  Material "uber" "rgb Kd" [0.6 0.3 0.2] "texture Ks" "op"
    "texture opacity" "op" "float roughness" [0.1]
  Translate -3.4 -1.5 1.0
  Shape "sphere" "float radius" [1.0]
AttributeEnd
AttributeBegin
  Translate 0 5 8
  AreaLightSource "diffuse" "rgb L" [40 40 40]
  Shape "sphere" "float radius" [0.5]
AttributeEnd
WorldEnd
"""


def write_breadth_pbrt(out_dir: Path, res=RES, spp=SPP, blob=(512, 256),
                       depth=DEPTH, extra="") -> Path:
    """pbrt-v3's classic materials and lights on the main scene: the blob
    (2 nu nv triangles, a PLY) in uber, the floor in substrate, the wall in
    translucent with a spot light behind it, the mirror sphere in metal
    (copper, roughness 0.05), a sphere mixing matte and metal (amount 0.3)
    and a sphere in uber whose opacity (and Ks) is an imagemap (seeded,
    mean 0.5: the JAX package evaluates a texture only where a Kd, Ks,
    sigma, roughness or bump binds it, pbrt_tpu/statics.py:42, and the
    port refuses an opacity map bound alone);
    the emissive sphere, a distant light, a projection light with a seeded
    64x64 slide and a goniometric light with a seeded 32x64 equirect map,
    all PFM.  path at `depth`, halton, the spatial distribution; extra:
    more parameters of the Integrator line."""
    from pbrt_tpu_torch.utils.imageio import write_pfm

    out_dir.mkdir(parents=True, exist_ok=True)
    idx, v = blob_mesh(blob[0], blob[1], seed=0, center=(0.0, 0.0, 2.2),
                       radius=2.0)
    write_ply(out_dir / "blob.ply", idx, v)
    rs = np.random.RandomState(8)
    slide = 0.2 + 0.8 * rs.rand(64, 64, 3)
    slide[::8] = (1.0, 0.9, 0.3)  # bars the light projects
    write_pfm(str(out_dir / "slide.pfm"), slide.astype(np.float32))
    theta = (np.arange(32) + 0.5) / 32 * np.pi
    gonio = (0.3 + np.cos(theta / 2) ** 2)[:, None, None] * (
        0.8 + 0.4 * rs.rand(32, 64, 1))
    write_pfm(str(out_dir / "gonio.pfm"), np.broadcast_to(
        gonio, (32, 64, 3)).astype(np.float32))
    write_pfm(str(out_dir / "opacity.pfm"),
              (0.25 + 0.5 * rs.rand(16, 16, 3)).astype(np.float32))
    path = out_dir / "breadth.pbrt"
    path.write_text(BREADTH_PBRT.format(xres=res[0], yres=res[1], spp=spp,
                                        depth=depth, extra=extra))
    return path


# ---------------------------------------------------------------------------
# BVH kernels against their plain versions and against each other
# ---------------------------------------------------------------------------

def bvh_kernels(bvh) -> dict:
    """The two traversal kernels: wrapper, plain version, the scene's table
    and depth fields, and the bytes and operations of one node visit."""
    return {
        "bvh4": dict(wrapper=bvh.bvh4_traverse, plain=bvh.bvh4_traverse_plain,
                     nodes="bvh4_nodes", depth="bvh4_depth",
                     node_bytes=bvh.NODE_BYTES, node_flops=4 * SLAB_FLOPS),
        # one bvh2 row fetch tests both children's boxes
        "bvh2": dict(wrapper=bvh.bvh2_traverse, plain=bvh.bvh2_traverse_plain,
                     nodes="bvh2_nodes", depth="bvh2_depth",
                     node_bytes=bvh.NODE2_BYTES, node_flops=2 * SLAB_FLOPS),
    }


def time_cuda(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def kernel_case(name, k, bvh, scene, o, d, t_max, any_mask, timed: str,
                order=None):
    """Hold one kernel against its plain version on one ray batch (with and
    without the any-hit mask), bit for bit; returns its measurements.
    timed = "mask" times and counts the launch with the any-hit mask (as
    the main path launches its merged batches), "closest" without it.
    order: the work list the batch was launched with (None = the
    identity).  Where there is one, the kernel is also timed on the rays
    gathered into that order beforehand with no work list (ms_gathered),
    and the four gathers and two scatters such a launch needs around it are
    timed alone (glue_ms): what the work list read inside the kernel costs
    and saves."""
    import torch

    n = o.shape[0]
    dev = o.device
    zeros = torch.zeros(n, dtype=torch.float32, device=dev)
    mode = any_mask.to(torch.float32)
    timed_mode = {"mask": mode, "closest": zeros}[timed]
    nodes, depth = getattr(scene, k["nodes"]), getattr(scene, k["depth"])
    args = (nodes, scene.prim_tris, o, d, t_max)
    wrapper, plain = k["wrapper"], k["plain"]
    saved = wrapper.launches
    t_k, p_k = wrapper(*args, zeros, depth, order)
    tm_k, pm_k = wrapper(*args, mode, depth, order)
    # the plain version once a mode; the timed mode's run counts the visits
    torch.cuda.synchronize()
    runs = {}
    for key, m in (("closest", zeros), ("mask", mode)):
        t0 = time.perf_counter()
        runs[key] = plain(*args, m, return_counts=key == timed, order=order)
        torch.cuda.synchronize()
        if key == timed:
            plain_ms = (time.perf_counter() - t0) * 1e3
    t_p, p_p = runs["closest"][:2]
    tm_p, pm_p = runs["mask"][:2]
    visits, tests = runs[timed][2:]
    check(torch.equal(t_k, t_p) and torch.equal(p_k, p_p),
          f"{name}: kernel and plain version differ (closest hit)")
    check(torch.equal(tm_k, tm_p) and torch.equal(pm_k, pm_p),
          f"{name}: kernel and plain version differ (any-hit mask)")
    ms = time_cuda(lambda: wrapper(*args, timed_mode, depth, order), 10)
    extra = {}
    if order is not None:
        idx = order.to(torch.int64)
        rays = [x[idx].contiguous() for x in (o, d, t_max, timed_mode)]
        t_g, p_g = wrapper(nodes, scene.prim_tris, *rays, depth)
        t_s, p_s = torch.empty_like(t_g), torch.empty_like(p_g)
        t_s[idx], p_s[idx] = t_g, p_g
        t_w, p_w = wrapper(*args, timed_mode, depth, order)
        torch.cuda.synchronize()
        check(torch.equal(t_s, t_w) and torch.equal(p_s, p_w),
              f"{name}: the gathered launch differs from the work list's")

        def glue():
            for x in (o, d, t_max, timed_mode):
                x[idx]
            t_s[idx], p_s[idx] = t_g, p_g

        extra = dict(ms_gathered=time_cuda(
                         lambda: wrapper(nodes, scene.prim_tris, *rays, depth), 10),
                     glue_ms=time_cuda(glue, 10))
    wrapper.launches = saved  # comparison launches do not count

    hk, hp = p_k >= 0, p_p >= 0
    hit_agree = (hk == hp).float().mean().item()
    both = hk & hp
    same = both & (p_k == p_p)
    prim_agree = (same.sum() / both.sum().clamp(min=1)).item()
    tk, tp = t_k[same], t_p[same]
    t_rel = ((tk - tp).abs() / tp.abs().clamp(min=1e-30)).max().item() if tk.numel() else 0.0
    max_abs = (tk - tp).abs().max().item() if tk.numel() else 0.0
    mk = any_mask
    occ_ok = torch.equal((pm_k >= 0)[mk], hk[mk]) and torch.equal((pm_p >= 0)[mk], hp[mk])
    free_ok = torch.equal(pm_k[~mk], p_k[~mk]) and torch.equal(tm_k[~mk], t_k[~mk])
    check(occ_ok, f"{name}: any-hit occlusion differs from the closest hit")
    check(free_ok, f"{name}: unflagged lanes changed under the any-hit mask")
    node_v = int(visits.sum())
    prim_t = int(tests.sum())
    # Two floors.  bound_ms: each input read once and each output written
    # once (the node and triangle tables, 40 B per ray), against the
    # operations this run's visits need.  visit_bound_ms: every node visit
    # and triangle test read from device memory, as if nothing stayed in L2.
    table_bytes = nodes.nbytes + scene.prim_tris.nbytes
    t_bytes = (table_bytes + n * bvh.RAY_BYTES) / H100_BYTES_PER_S * 1e3
    t_ops = (node_v * k["node_flops"] + prim_t * TRI_FLOPS) / H100_F32_FLOPS * 1e3
    visit_bytes = node_v * k["node_bytes"] + prim_t * bvh.PRIM_BYTES + n * bvh.RAY_BYTES
    out = dict(case=name, rays=n, live_rays=int((t_max > 0).sum()), timed=timed,
               hit_agree=hit_agree,
               prim_agree=prim_agree, t_rel_err=t_rel, max_abs_err=max_abs,
               mismatch_frac=1.0 - (hk == hp).float().mean().item()
               + (both & ~same).float().mean().item(),
               ms=ms, plain_ms=plain_ms, node_visits_per_ray=node_v / n,
               tri_tests_per_ray=prim_t / n, table_mb=table_bytes / 1e6,
               visit_mb=visit_bytes / 1e6,
               bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               visit_bound_ms=visit_bytes / H100_BYTES_PER_S * 1e3, **extra)
    print(f"kernel-check {json.dumps(out)}", flush=True)
    return out


def cross_check(name, kernels, scene, o, d, t_max, any_mask, order=None):
    """bvh2 against bvh4 on one batch: hit flags equal, t equal where the
    prims agree, prims agree on >= 99.9% of the hits, and the any-hit
    occlusion equal."""
    import torch

    n = o.shape[0]
    zeros = torch.zeros(n, dtype=torch.float32, device=o.device)
    mode = any_mask.to(torch.float32)
    out = {}
    for kind, k in kernels.items():
        saved = k["wrapper"].launches
        nodes, depth = getattr(scene, k["nodes"]), getattr(scene, k["depth"])
        out[kind] = [k["wrapper"](nodes, scene.prim_tris, o, d, t_max, m, depth,
                                  order)
                     for m in (zeros, mode)]
        k["wrapper"].launches = saved
    (t2, p2), (_, pm2) = out["bvh2"]
    (t4, p4), (_, pm4) = out["bvh4"]
    hits = p4 >= 0
    same = hits & (p2 == p4)
    prim_agree = (same.sum() / hits.sum().clamp(min=1)).item()
    check(torch.equal(p2 >= 0, hits), f"{name}: bvh2 and bvh4 hit flags differ")
    check(torch.equal(t2[same], t4[same]), f"{name}: bvh2 and bvh4 t differ")
    check(prim_agree >= 0.999, f"{name}: bvh2/bvh4 prim agreement {prim_agree}")
    check(torch.equal((pm2 >= 0)[any_mask], (pm4 >= 0)[any_mask]),
          f"{name}: bvh2 and bvh4 any-hit occlusion differ")
    print(f"kernel-cross {name}: bvh2 vs bvh4 hit flags equal, prims agree "
          f"{prim_agree:.6f}, t equal where they agree, occlusion equal",
          flush=True)


def mesh_rays(rs, n, center, radius, device):
    """Half coherent (a pinhole cone at the mesh), half incoherent (random
    origins on a shell, random directions toward the mesh)."""
    import torch

    h = n // 2
    o1 = np.tile(np.asarray(center) + np.array([0.0, -4.0 * radius, 0.5]), (h, 1))
    d1 = (np.array([0.0, 1.0, 0.0]) + rs.randn(h, 3) * 0.15)
    o2 = rs.randn(n - h, 3)
    o2 = np.asarray(center) + 3.0 * radius * o2 / np.linalg.norm(o2, axis=-1, keepdims=True)
    d2 = (np.asarray(center) + rs.randn(n - h, 3) * radius) - o2
    o = np.concatenate([o1, o2]).astype(np.float32)
    d = np.concatenate([d1, d2])
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return (torch.as_tensor(o, device=device), torch.as_tensor(d, device=device))


def profile_render(render_one, table_path: Path, label: str = "profile"):
    """One spp (render_one()) under torch.profiler: the device's busy
    time against the wall, the port's "layer: ..." ranges (around the calls
    into each layer; inclusive of the layers they call), and the top device
    operations, written to table_path; each line starts with `label`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render_one()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    key = ("self_device_time_total" if hasattr(events[0], "self_device_time_total")
           else "self_cuda_time_total")
    total_key = key.replace("self_", "")
    spans = [e for e in events if e.key.startswith("layer: ")]
    # device operations; a span also shows as a device-side range, not counted
    on_card = [e for e in events
               if e.device_type == DeviceType.CUDA and e not in spans]
    busy_ms = sum(getattr(e, key) for e in on_card) / 1e3
    table_path.parent.mkdir(parents=True, exist_ok=True)
    table_path.write_text(events.table(sort_by=key, row_limit=40))
    print(f"{label} (1 spp, profiler on): wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.3f}, "
          f"{sum(e.count for e in on_card)} device operations", flush=True)
    kern = [e for e in on_card if "bvh4_traverse" in e.key]
    kern_ms = sum(getattr(e, key) for e in kern) / 1e3
    print(f"{label} kernel in the render: {sum(e.count for e in kern)} launches, "
          f"device {kern_ms:.4f} ms", flush=True)
    device_ms = {}
    for e in spans:
        if e.device_type == DeviceType.CPU:
            device_ms[e.key] = getattr(e, total_key) / 1e3
            print(f"{label} {e.key}: {e.count} calls, host {e.cpu_time_total / 1e3:.1f} ms, "
                  f"device busy {device_ms[e.key]:.2f} ms", flush=True)
    # The traversal's device time: the kernel by name (launched through
    # ctypes, it falls in no range) and the glue by its own ranges
    # (ops/bvh.py:intersect_kernel_with_quadrics); the rest of the glue's
    # range is the lane set-up (t_max, mode, the launch counter).
    glue = device_ms.get("layer: traversal incl. kernel", 0.0)
    key_ms = device_ms.get("layer: traversal / key and argsort", 0.0)
    sphere_ms = device_ms.get("layer: traversal / sphere pass", 0.0)
    print(f"{label} traversal split (device ms, 1 spp): kernel {kern_ms:.3f}, key "
          f"and argsort {key_ms:.3f}, sphere pass {sphere_ms:.3f}, rest "
          f"{glue - key_ms - sphere_ms:.3f}; in all {kern_ms + glue:.3f}", flush=True)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def reset_counts(counted):
    for fn in counted.values():
        fn.launches = 0


def read_counts(counted) -> dict:
    return {name: fn.launches for name, fn in counted.items()}


def bvh_phase(sc, tf, path, bvh, cameras, film_cls, sampler_cls, dev):
    """Phase 3.  Returns {kernel: {case: measurements}}."""
    import torch

    kernels = bvh_kernels(bvh)
    results = {kind: {} for kind in kernels}

    def both(label, scene, o, d, t_max, mask, timed):
        for kind, k in kernels.items():
            results[kind][label] = kernel_case(f"{kind}-{label}", k, bvh, scene,
                                               o, d, t_max, mask, timed)
        cross_check(label, kernels, scene, o, d, t_max, mask)

    rs = np.random.RandomState(1)
    soup = soup_scene(sc.SceneBuilder, sc, tf).build(device=dev)
    n = 65536
    o = np.tile(np.array([[0.0, 0.0, -8.0]], np.float32), (n, 1))
    d = np.array([[0, 0, 1]], np.float32) + rs.randn(n, 3).astype(np.float32) * 0.3
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    oi = (rs.randn(n, 3) * 3).astype(np.float32)
    di = rs.randn(n, 3).astype(np.float32)
    di /= np.linalg.norm(di, axis=-1, keepdims=True)
    tmax = torch.full((n,), 1e30, device=dev)
    mask = torch.as_tensor(rs.rand(n) < 0.5, device=dev)
    for label, (oo, dd) in (("soup200-coherent", (o, d)),
                            ("soup200-incoherent", (oi, di))):
        both(label, soup, torch.as_tensor(oo, device=dev).contiguous(),
             torch.as_tensor(dd, device=dev).contiguous(), tmax, mask, "closest")

    t0 = time.perf_counter()
    big = sc.SceneBuilder()
    m = big.add_material(sc.MAT_MATTE)
    idx, v = blob_mesh(1024, 512, seed=5, center=(0.0, 0.0, 0.0), radius=3.0)
    big.add_triangle_mesh(idx, v, material=m)
    big.add_point_light(tf.translate(0, 0, 10), (1, 1, 1))
    big = big.build(device=dev)
    print(f"mesh-1M: {idx.shape[0]} triangles, {big.bvh4_nodes.shape[0]} "
          f"4-wide nodes (depth {big.bvh4_depth}), {big.bvh2_nodes.shape[0]} "
          f"binary rows (depth {big.bvh2_depth}), host build "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    o_b, d_b = mesh_rays(rs, 65536, (0.0, 0.0, 0.0), 3.0, dev)
    both("mesh1M-64k", big, o_b, d_b, torch.full((65536,), 1e30, device=dev),
         mask, "closest")
    del big

    # The main scene: capture the kernels' inputs on one sample of the main
    # path (its camera rays, then each bounce's merged [shadow | MIS |
    # extension] batch, whose dead lanes carry t_max = 0), once as the
    # default path traverses and once under PBRT_TPU_BVH4=0.
    t0 = time.perf_counter()
    scene = main_scene(sc.SceneBuilder, sc, tf).build(device=dev)
    torch.cuda.synchronize()
    n_tris = int((scene.prim_tris[:, 3] == 0).sum())
    print(f"main scene: {n_tris} triangles, binary depth {scene.bvh2_depth}, "
          f"host build {time.perf_counter() - t0:.2f} s", flush=True)
    camera = camera_for(cameras, tf, RES)
    film_cfg = film_cls(full_resolution=RES)
    cfg = path.PathConfig(max_depth=DEPTH)
    labels = ["main-camera"] + [f"main-nee-merged-b{b}" for b in range(DEPTH)]
    for kind, switch in (("bvh4", "1"), ("bvh2", "0")):
        with bvh_switch(switch), bvh.record_calls() as captured:
            path.render(scene, camera, film_cfg, sampler_cls("halton", 1, RES), cfg)
        check(len(captured) == 1 + DEPTH,
              f"one sample launched {kind} {len(captured)} times, not {1 + DEPTH}")
        for label, (oc, dc, tc, mc, order) in zip(labels, captured):
            check(order is not None, f"{kind}-{label}: launched without a work list")
            live = int((tc > 0).sum())
            print(f"batch {kind}-{label}: {tc.shape[0]} lanes, {live} live "
                  f"({live / tc.shape[0]:.4f})", flush=True)
            results[kind][label] = kernel_case(f"{kind}-{label}", kernels[kind], bvh,
                                               scene, oc, dc, tc, mc > 0, "mask",
                                               order)
            cross_check(f"{kind}-{label}", kernels, scene, oc, dc, tc, mc > 0, order)
        del captured
    return results, scene, camera, film_cfg, cfg


def probe_phase(bp, dev, counted):
    """Phase 4: the Triton chain against form B, the three forms timed, and
    the probe's entry point driven once with the counts at 0."""
    import torch

    n = bp.N
    p, d, ns, t = bp.inputs(n, dev)
    pT, dT, nsT = (x.t().contiguous() for x in (p, d, ns))
    saved = bp.chain_fused.launches
    pc, tc = bp.chain_fused(pT, dT, nsT, t)
    pb, tb = bp.chain_planar(pT, dT, nsT, t)
    torch.cuda.synchronize()
    bp.chain_fused.launches = saved
    out = {}
    for key, got, ref in (("p", pc, pb), ("t", tc, tb)):
        err = (got - ref).abs()
        within = (err <= 1e-5 * ref.abs() + 1e-6).float().mean().item()
        out[key] = dict(max_abs=err.max().item(), exact=(err == 0).float().mean().item(),
                        within=within)
        check(bool(torch.isfinite(got).all()), f"probe form C {key} is not finite")
        check(within >= 0.999, f"probe form C {key}: {within} within 1e-5 relative")
    print(f"probe-check form C vs B at N={n}: {json.dumps(out)}", flush=True)
    ms_a = bp.time_ms(bp.chain_rows, p, d, ns, t)
    ms_b = bp.time_ms(bp.chain_planar, pT, dT, nsT, t)
    ms_c = bp.time_ms(bp.chain_fused, pT, dT, nsT, t)
    # the device alone: one replay of a CUDA graph of 50 calls, inputs
    # cycled past the L2
    cold = bp.cold_copies(pT, dT, nsT, t)
    dev_b = bp.device_ms(bp.chain_planar, cold)
    dev_c = bp.device_ms(bp.chain_fused, cold)
    del cold
    bp.chain_fused.launches = saved
    t_bytes = n * bp.BYTES_PER_ELEMENT / H100_BYTES_PER_S * 1e3
    t_ops = n * bp.FLOPS_PER_ELEMENT / H100_F32_FLOPS * 1e3
    print(f"probe times: A {ms_a:.4f} ms, B {ms_b:.4f} ms, C {ms_c:.4f} ms per eager "
          f"call; on the device B {dev_b:.5f} ms, C {dev_c:.5f} ms per call; "
          f"C's floor {max(t_bytes, t_ops):.5f} ms ("
          f"{'bytes' if t_bytes >= t_ops else 'operations'}: {t_bytes:.5f} ms of "
          f"bytes, {t_ops:.5f} ms of operations); C's host launch cost "
          f"{ms_c - dev_c:.5f} ms a call (eager less device)", flush=True)
    reset_counts(counted)
    bp.main(["--reps", "20"])
    launches = read_counts(counted)
    check(launches["chain_fused"] > 0, "the probe's entry point launched no kernel")
    print(f"probe entry point: launches {launches}", flush=True)
    return dict(ms=ms_c, device_ms=dev_c, plain_ms=ms_b, plain_device_ms=dev_b,
                rows_ms=ms_a, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                max_abs_err=max(out["p"]["max_abs"], out["t"]["max_abs"]),
                exact_frac=min(out["p"]["exact"], out["t"]["exact"]),
                launches=launches["chain_fused"], n=n)


def ladder_phase(render, read_pfm, dev):
    """Phase 7: the parity ladder on the card against the goldens."""
    out_dir = SMOKE_DIR / "ladder"
    out_dir.mkdir(parents=True, exist_ok=True)
    for name, tol, min_frac, max_mean_rel in LADDER:
        t0 = time.perf_counter()
        img, _ = render.render_file(str(HERE / "refgold/parity" / f"{name}.pbrt"),
                                    out=str(out_dir / f"{name}.pfm"), device=dev)
        ref = read_pfm(str(HERE / "refgold/goldens/parity" / f"{name}.pfm"))
        check(img.shape == ref.shape, f"ladder {name}: shape {img.shape}")
        rel = np.abs(ref - img) / np.maximum(np.abs(ref), 1e-2)
        frac = float(np.all(rel <= tol, -1).mean())
        mean_rel = abs(float(img.mean()) - float(ref.mean())) / max(float(ref.mean()), 1e-6)
        print(f"ladder {name}: match_frac {frac:.4f} (>= {min_frac}), mean rel "
              f"{mean_rel:.3e} (<= {max_mean_rel}), {time.perf_counter() - t0:.2f} s",
              flush=True)
        check(frac >= min_frac and mean_rel <= max_mean_rel,
              f"ladder {name}: match_frac {frac}, mean rel {mean_rel}")
    img, _ = render.render_file(str(HERE / "refgold/parity/c2u_uniform.pbrt"),
                                out=str(out_dir / "c2u_uniform.pfm"), device=dev)
    check(bool(np.isfinite(img).all()) and float(img.mean()) > 0.0,
          "ladder c2u_uniform: image not finite or black")
    print(f"ladder c2u_uniform: no golden; finite, mean {float(img.mean()):.6f}",
          flush=True)
    print("ladder skipped: killeroo_64_4spp (it includes files from outside "
          "the repository)", flush=True)


def cli_phase(render, read_pfm, lightdistrib, counted, ref_img, dev):
    """Phase 8: the main scene as a .pbrt file through the CLI and through
    render_file with each BVH kernel."""
    import torch

    scene_path = write_main_pbrt(SMOKE_DIR)
    out = SMOKE_DIR / "out.pfm"
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "pbrt_tpu_torch", str(scene_path),
                        "-o", str(out), "--quiet"], cwd=HERE,
                       capture_output=True, text=True, timeout=600)
    sub_s = time.perf_counter() - t0
    check(r.returncode == 0, f"python -m pbrt_tpu_torch exited {r.returncode}:\n"
                             f"{r.stderr[-3000:]}")
    img = read_pfm(str(out))
    check(img.shape == (RES[1], RES[0], 3) and bool(np.isfinite(img).all())
          and float(img.mean()) > 0.0, "CLI image not finite or black")
    print(f"cli subprocess: {sub_s:.2f} s for the process; it printed: "
          f"{r.stdout.strip().splitlines()[0]}", flush=True)

    # Each kernel once; phases 5 and 10 hold repeats bit-identical.
    runs = {}
    for kind, switch in (("bvh4", "1"), ("bvh2", "0")):
        with bvh_switch(switch):
            reset_counts(counted)
            img, st = render.render_file(str(scene_path), out=str(out), device=dev)
            launches = read_counts(counted)
        other = "bvh2" if kind == "bvh4" else "bvh4"
        check(launches[f"{kind}_traverse"] == SPP * (1 + DEPTH),
              f"render_file ({kind}) launched it {launches[f'{kind}_traverse']} "
              f"times, not {SPP * (1 + DEPTH)}")
        check(launches[f"{other}_traverse"] == 0,
              f"render_file ({kind}) launched {other}")
        check(bool(np.isfinite(img).all()) and float(img.mean()) > 0.0,
              f"render_file ({kind}): image not finite or black")
        ph = st["phases"]
        mrays = st["rays_traced"] / ph["Rendering"] / 1e6
        print(f"cli render_file {kind}: parse + PLY load {ph['Parsing']:.3f} s, host "
              f"build {ph['Scene construction']:.3f} s, spatial distribution "
              f"{ph['Light distribution']:.3f} s, render wall {ph['Rendering']:.3f} s "
              f"(process CPU {st['render_cpu_s']:.3f} s), {int(st['rays_traced'])} "
              f"rays, {mrays:.3f} Mrays/s, launches {launches}", flush=True)
        runs[kind] = dict(img=img, launches=launches)
    m4, m2 = float(runs["bvh4"]["img"].mean()), float(runs["bvh2"]["img"].mean())
    check(abs(m4 - m2) <= 1e-3 * m4, f"bvh2 image mean {m2} vs bvh4 {m4}")
    same = np.array_equal(runs["bvh4"]["img"], ref_img)
    print(f"cli images: means {m4:.6f} (bvh4) {m2:.6f} (bvh2); bvh4 image equal "
          f"to phase 5's SceneBuilder render: {same}; bvh2 image equal: "
          f"{np.array_equal(runs['bvh2']['img'], runs['bvh4']['img'])}", flush=True)
    check(same, "the .pbrt render differs from the SceneBuilder render")

    # What the spatial pick costs per spp: one pick per bounce at the
    # batch's width, on points inside the scene.
    from pbrt_tpu_torch.sceneio import parse_pbrt_file

    scene = lightdistrib.ensure_spatial_light_distribution(
        parse_pbrt_file(str(scene_path)).build_scene(dev))
    n = RES[0] * RES[1]
    g = torch.Generator(device=dev).manual_seed(0)
    p = scene.spatial_b0 + torch.rand((n, 3), generator=g, device=dev) * scene.spatial_diag
    u = torch.rand(n, generator=g, device=dev)
    args = (scene.spatial_grid_res, scene.spatial_b0, scene.spatial_diag,
            scene.spatial_cdf, scene.spatial_pmf, p, u)
    dev_ms = time_cuda(lambda: lightdistrib.spatial_pick_light(*args), 20)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        lightdistrib.spatial_pick_light(*args)
        torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / 20 * 1e3
    print(f"spatial pick at {n} lanes: {dev_ms:.4f} ms by CUDA events, "
          f"{host_ms:.4f} ms host wall with a sync per call; per spp "
          f"({DEPTH} bounces): {DEPTH * dev_ms:.4f} / {DEPTH * host_ms:.4f} ms",
          flush=True)
    return runs["bvh2"]["launches"]["bvh2_traverse"]


def profile_grad(run_step, table_path: Path):
    """One grad step under torch.profiler: the device's busy time against
    the wall and the device operations that take the most of it, the
    profiler's table written to table_path."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    key = ("self_device_time_total" if hasattr(events[0], "self_device_time_total")
           else "self_cuda_time_total")
    on_card = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.key.startswith("layer: ")]
    busy_ms = sum(getattr(e, key) for e in on_card) / 1e3
    table_path.parent.mkdir(parents=True, exist_ok=True)
    table_path.write_text(events.table(sort_by=key, row_limit=40))
    print(f"profile grad step (remat, profiler on): wall {wall_ms:.1f} ms, device "
          f"busy {busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.3f}, "
          f"{sum(e.count for e in on_card)} device operations", flush=True)
    top = sorted(on_card, key=lambda e: -getattr(e, key))[:8]
    print("profile grad step, top device operations: " + "; ".join(
        f"{e.key[:70]} {getattr(e, key) / 1e3:.2f} ms "
        f"({getattr(e, key) / 1e3 / busy_ms:.1%}, {e.count} calls)" for e in top),
        flush=True)


def gather_backward(scene, n: int, dev) -> dict:
    """The backward of one per-lane gather of the material table's kd [M, 3]
    and roughness [M] at n lanes, as the grad step's material and light
    gathers run it (`table[idx]`: index_put_ with accumulation, a sort and
    a pass over each run of equal indices), beside `index_select` (whose
    backward is index_add_, atomics) on the same inputs: ms per backward by
    CUDA events, each pair checked to agree within 1e-4 of its largest
    entry."""
    import torch

    g = torch.Generator(device=dev).manual_seed(0)
    rows = scene.materials.kd.shape[0]
    idx = torch.randint(0, rows, (n,), generator=g, device=dev)
    out = {}
    for name, table in (("kd", scene.materials.kd), ("roughness",
                                                      scene.materials.roughness)):
        leaf = table.detach().clone().requires_grad_(True)
        cot = torch.rand((n,) + tuple(table.shape[1:]), generator=g, device=dev)
        ref, got = (torch.autograd.grad(fn(leaf), leaf, cot)[0] for fn in
                    (lambda t: t[idx], lambda t: torch.index_select(t, 0, idx)))
        check(float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max()),
              f"gather backward {name}: index_select differs from indexing")
        for label, fn in (("index", lambda t: t[idx]),
                          ("index_select", lambda t: torch.index_select(t, 0, idx))):
            y = fn(leaf)
            out[f"{name} {label}"] = time_cuda(
                lambda: torch.autograd.grad(y, leaf, cot, retain_graph=True), 10)
    return out


def grad_phase(diff, path, stats, sampler_cls, scene, camera, film_cfg, cfg,
               counted, card, dev, profile: Path | None = None) -> dict:
    """Phase 9: render_grad_step on the main scene (one halton batch at
    RES, depth DEPTH, every DEFAULT_PARAMS leaf, weights of ones): a warm
    step at sample 0, then at samples 1 and 2 a step with remat on, one
    with remat off, and the forward alone under no_grad; then one remat
    step under PBRT_TPU_BVH4=0; with profile, one more remat step under
    torch.profiler, its table written to profile.  Returns the launches of
    each BVH kernel in one remat step."""
    import torch

    pixels = torch.as_tensor(path.make_pixel_grid(film_cfg), device=dev)
    w = torch.ones((pixels.shape[0], 3), dtype=torch.float32, device=dev)
    sampler = sampler_cls("halton", 1, RES)

    def step(sample, remat):
        counters = stats.zeros(dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        reset_counts(counted)
        t0 = time.perf_counter()
        L, g = diff.render_grad_step(scene, camera, pixels, sample, w, sampler,
                                     cfg, remat=remat, device=dev,
                                     counters=counters)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts(counted)
        peak = torch.cuda.max_memory_allocated(dev)
        leaves = {k: v for k, v in g.items() if k != "camera"}
        leaves.update({f"camera.{k}": v for k, v in g["camera"].items()})
        for k, v in leaves.items():
            check(bool(torch.isfinite(v).all()), f"grad step: leaf {k} is not finite")
        check(float(leaves["kd"].abs().sum()) > 0.0, "grad step: kd gradient is zero")
        check(float(leaves["camera.camera_to_world"].abs().sum()) > 0.0,
              "grad step: camera gradient is zero")
        return dict(L=L, leaves=leaves, wall=wall, launches=launches,
                    rays=stats.ray_total(counters), peak=peak, base=base)

    def forward(sample):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            L = diff.render_batch_radiance(scene, camera, pixels, sample,
                                           sampler, cfg)
        torch.cuda.synchronize()
        return L, time.perf_counter() - t0

    def leaf_diff(a, b) -> float:
        """The largest |a - b| of any leaf over that leaf's largest |b|."""
        return max(float((a[k] - b[k]).abs().max())
                   / max(float(b[k].abs().max()), 1e-30) for k in b)

    warm = step(0, True)
    print(f"grad warm step (sample 0, remat): {warm['wall']:.3f} s, launches "
          f"{warm['launches']}", flush=True)
    remat_steps = {}
    for sample in (1, 2):
        on, off = step(sample, True), step(sample, False)
        remat_steps[sample] = on
        L_fwd, fwd_s = forward(sample)
        check(on["launches"]["bvh4_traverse"] == 1 + 2 * DEPTH
              and on["launches"]["bvh2_traverse"] == 0,
              f"remat step launched {on['launches']}, not {1 + 2 * DEPTH} bvh4")
        check(off["launches"]["bvh4_traverse"] == 1 + DEPTH
              and off["launches"]["bvh2_traverse"] == 0,
              f"no-remat step launched {off['launches']}, not {1 + DEPTH} bvh4")
        check(torch.equal(on["L"], L_fwd) and torch.equal(off["L"], L_fwd),
              f"sample {sample}: the step's L differs from the no_grad forward")
        check(on["rays"] == off["rays"], "remat changed the counted rays")
        rel = leaf_diff(on["leaves"], off["leaves"])
        check(rel <= 1e-4, f"sample {sample}: remat and no-remat gradients differ "
                           f"by {rel:.3e} of a leaf's largest entry")
        for label, r in (("remat on", on), ("remat off", off)):
            print(f"grad step sample {sample} {label}: fwd+bwd {r['wall']:.3f} s, "
                  f"{int(r['rays'])} forward rays, "
                  f"{r['rays'] / r['wall'] / 1e6:.4f} Mrays/s, "
                  f"max_memory_allocated {r['peak'] / 2**20:.1f} MiB "
                  f"({(r['peak'] - r['base']) / 2**20:.1f} above the step's "
                  f"start), launches "
                  f"{r['launches']} [{card}]", flush=True)
        print(f"grad forward only sample {sample} (no_grad): {fwd_s:.3f} s; step "
              f"over forward {on['wall'] / fwd_s:.2f}x (remat on), "
              f"{off['wall'] / fwd_s:.2f}x (off); peak above the start, "
              f"remat off / on {(off['peak'] - off['base']) / max(on['peak'] - on['base'], 1):.2f}; "
              f"L bit-equal to the "
              f"forward; remat gradients within {rel:.3e} of each leaf's largest "
              f"entry", flush=True)
    leaf_max = {k: float(v.abs().max()) for k, v in on["leaves"].items()}
    print(f"grad leaves (largest |g|): {json.dumps(leaf_max)}", flush=True)
    with bvh_switch("0"):
        b2 = step(1, True)
    check(b2["launches"]["bvh2_traverse"] == 1 + 2 * DEPTH
          and b2["launches"]["bvh4_traverse"] == 0,
          f"bvh2 remat step launched {b2['launches']}")
    ref = remat_steps[1]
    print(f"grad step sample 1 under PBRT_TPU_BVH4=0: fwd+bwd {b2['wall']:.3f} s, "
          f"launches {b2['launches']}; gradients within "
          f"{leaf_diff(b2['leaves'], ref['leaves']):.3e} of bvh4's, L max diff "
          f"{float((b2['L'] - ref['L']).abs().max()):.3e} [{card}]", flush=True)
    ms = gather_backward(scene, pixels.shape[0], dev)
    print(f"grad gather backward at {pixels.shape[0]} lanes, ms by CUDA events: "
          f"{json.dumps(ms)} [{card}]", flush=True)
    if profile is not None:
        profile_grad(lambda: diff.render_grad_step(
            scene, camera, pixels, 3, w, sampler, cfg, device=dev), profile)
    return {"bvh4": ref["launches"]["bvh4_traverse"],
            "bvh2": b2["launches"]["bvh2_traverse"]}


def image_bars(ref, got):
    """(match_frac, mean rel): the share of pixels within rel 1e-3 and the
    means' relative difference, which tests/test_torch_path.py:58-59 bar
    at 0.995 and 5e-3, and tests/test_parity_images.py:48 (media) at 0.60
    and 4e-2."""
    rel = np.abs(ref - got) / np.maximum(np.abs(ref), 1e-2)
    frac = float(np.all(rel <= 1e-3, -1).mean())
    mean_rel = abs(float(got.mean()) - float(ref.mean())) / max(float(ref.mean()), 1e-6)
    return frac, mean_rel


def timed_render_file(render, counted, path, out, dev, switch="1"):
    """render_file under PBRT_TPU_BVH4=switch with the launch counts set to
    0 just before and read just after: (img, stats, launches)."""
    with bvh_switch(switch):
        reset_counts(counted)
        img, st = render.render_file(str(path), out=str(out), device=dev)
        launches = read_counts(counted)
    check(bool(np.isfinite(img).all()) and float(img.mean()) > 0.0,
          f"{path.name}: image not finite or black")
    return img, st, launches


def render_line(what, st, launches, card):
    ph = st["phases"]
    setup = ", ".join(f"{k.lower()} {v:.3f} s" for k, v in ph.items()
                      if k != "Rendering")
    return (f"{what}: set-up {setup}; render wall {ph['Rendering']:.3f} s "
            f"(process CPU {st['render_cpu_s']:.3f} s), {int(st['rays_traced'])} "
            f"rays, {st['rays_traced'] / ph['Rendering'] / 1e6:.3f} Mrays/s, "
            f"launches {launches} [{card}]")


def config3_cross(scene, captured):
    """Both kernels on every batch that config3's bvh2 render launched:
    hit flags and any-hit occlusion equal, and t equal on every closest-hit
    lane, so that the prims may differ only at a tie (two triangles hit at
    the same t).  The first differing lanes are printed with both plain
    versions' answers on them."""
    import torch

    from pbrt_tpu_torch.ops import bvh

    kernels = bvh_kernels(bvh)
    tot = dict(lanes=0, closest_hits=0, hit_flag=0, t=0, ties=0, occlusion=0)
    shown = []
    for o, d, tm, mode, order in captured:
        out = {}
        for kind, k in kernels.items():
            saved = k["wrapper"].launches
            out[kind] = k["wrapper"](getattr(scene, k["nodes"]), scene.prim_tris,
                                     o, d, tm, mode, getattr(scene, k["depth"]),
                                     order)
            k["wrapper"].launches = saved
        (t2, p2), (t4, p4) = out["bvh2"], out["bvh4"]
        closest, live = mode <= 0, tm > 0
        hits = closest & (p4 >= 0)
        bad = {"hit_flag": closest & ((p2 >= 0) != (p4 >= 0)),
               "t": hits & (p2 >= 0) & (t2 != t4),
               "ties": hits & (t2 == t4) & (p2 != p4),
               "occlusion": ~closest & live & ((p2 >= 0) != (p4 >= 0))}
        tot["lanes"] += int(live.sum())
        tot["closest_hits"] += int(hits.sum())
        for key, m in bad.items():
            tot[key] += int(m.sum())
        lanes = torch.nonzero(bad["hit_flag"] | bad["t"] | bad["ties"]
                              | bad["occlusion"]).flatten()
        for j in lanes[:max(0, 6 - len(shown))].tolist():
            row = dict(o=o[j].tolist(), d=d[j].tolist(), t_max=tm[j].item(),
                       any_hit=not bool(closest[j]),
                       bvh4=(t4[j].item(), int(p4[j])), bvh2=(t2[j].item(), int(p2[j])))
            for kind, k in kernels.items():
                tp, pp = k["plain"](getattr(scene, k["nodes"]).cpu(),
                                    scene.prim_tris.cpu(), o[j:j + 1].cpu(),
                                    d[j:j + 1].cpu(), tm[j:j + 1].cpu(),
                                    mode[j:j + 1].cpu())
                row[f"{kind}_plain"] = (tp.item(), int(pp))
            for q in sorted({row["bvh4"][1], row["bvh2"][1]}):
                if q >= 0:
                    row[f"tri {q}"] = scene.prim_tris[q].tolist()
            shown.append(row)
    print(f"config3 bvh2 against bvh4 on the {len(captured)} batches of the bvh2 "
          f"render: {json.dumps(tot)}", flush=True)
    for row in shown:
        print(f"config3 differing lane: {json.dumps(row)}", flush=True)
    check(tot["hit_flag"] == 0 and tot["t"] == 0 and tot["occlusion"] == 0,
          f"config3: bvh2 and bvh4 differ other than at ties: {tot}")


def config3_phase(render, counted, card, dev, profile):
    """Phase 10: BASELINE config 3's features through render_file on the
    card: the main scene's 262,144-triangle blob textured, the checkerboard
    floor, smooth and rough glass, the env map; 400x400 @ 64 spp, depth 5,
    halton, spatial light distribution.  A bit-identical repeat, the same
    image under PBRT_TPU_BVH4=0 with bvh2 launches only, and a 64x64 @ 2
    spp copy on the card against the CPU."""
    import torch

    from pbrt_tpu_torch import scene as sc
    from pbrt_tpu_torch.ops import bvh
    from pbrt_tpu_torch.textures.textures import build_pyramid
    from pbrt_tpu_torch.utils.imageio import read_pfm

    out_dir = SMOKE_DIR / "config3"
    spp = 64
    path = write_config3_pbrt(out_dir, spp=spp)
    # the set-up inside parse and build, timed alone on the same images
    skin, env = read_pfm(str(out_dir / "skin.pfm")), read_pfm(str(out_dir / "env.pfm"))
    t0 = time.perf_counter()
    levels = build_pyramid(skin)
    t1 = time.perf_counter()
    payload = sc._env_payload([dict(light_type=sc.LIGHT_INFINITE, image=env)])
    t2 = time.perf_counter()
    print(f"config3 set-up parts: the {skin.shape[1]}x{skin.shape[0]} pyramid "
          f"({len(levels)} levels) {t1 - t0:.3f} s, the {env.shape[1]}x"
          f"{env.shape[0]} env CDF {t2 - t1:.3f} s", flush=True)
    del payload
    want = spp * (1 + DEPTH)
    runs = []
    for kind, switch in (("bvh4", "1"), ("bvh4", "1"), ("bvh2", "0")):
        # the bvh2 render keeps its batches for config3_cross
        rec = bvh.record_calls() if kind == "bvh2" else contextlib.nullcontext()
        with rec as captured:
            img, st, launches = timed_render_file(render, counted, path,
                                                  out_dir / f"{kind}.pfm", dev,
                                                  switch)
        other = "bvh2" if kind == "bvh4" else "bvh4"
        check(launches[f"{kind}_traverse"] == want
              and launches[f"{other}_traverse"] == 0,
              f"config3 ({kind}) launches {launches}, not {want} of {kind}")
        print(render_line(f"config3 {RES[0]}x{RES[1]} @ {spp} spp, {kind}", st,
                          launches, card) + f", {st['rays_traced'] / 1e6 / spp:.3f}"
              f" Mrays a spp, wall {st['phases']['Rendering'] / spp:.4f} s a spp, "
              f"image mean {float(img.mean()):.6f}", flush=True)
        runs.append((img, launches))
    check(np.array_equal(runs[0][0], runs[1][0]), "config3: a repeat differs")
    frac, mean_rel = image_bars(runs[0][0], runs[2][0])
    print(f"config3 bvh2 against bvh4: bit-equal "
          f"{np.array_equal(runs[0][0], runs[2][0])}, match_frac {frac:.4f}, "
          f"mean rel {mean_rel:.3e}", flush=True)
    check(frac >= 0.995 and mean_rel <= 5e-3,
          f"config3 bvh2 against bvh4: match_frac {frac}, mean rel {mean_rel}")

    small = write_config3_pbrt(out_dir / "small", res=(64, 64), spp=2)
    a, _ = render.render_file(str(small), out=str(out_dir / "small_card.pfm"),
                              device=dev)
    t0 = time.perf_counter()
    b, _ = render.render_file(str(small), out=str(out_dir / "small_cpu.pfm"),
                              device="cpu")
    frac, mean_rel = image_bars(b, a)
    print(f"config3 card against cpu (64x64 @ 2 spp): match_frac {frac:.4f}, "
          f"mean rel {mean_rel:.3e}; the CPU render {time.perf_counter() - t0:.2f} s",
          flush=True)
    check(frac >= 0.995 and mean_rel <= 5e-3,
          f"config3 card against cpu: match_frac {frac}, mean rel {mean_rel}")

    from pbrt_tpu_torch import film as fm
    from pbrt_tpu_torch.integrators import path as ip
    from pbrt_tpu_torch.lights import lightdistrib
    from pbrt_tpu_torch.sceneio import parse_pbrt_file
    from pbrt_tpu_torch.utils import stats

    setup = parse_pbrt_file(str(path))
    scene = lightdistrib.ensure_spatial_light_distribution(setup.build_scene(dev))
    lt, tx, d2 = scene.lights, scene.textures, scene.lights.env_distr
    mb = {"bvh4 nodes + triangles": scene.bvh4_nodes.nbytes + scene.prim_tris.nbytes,
          "bvh2 nodes + triangles": scene.bvh2_nodes.nbytes + scene.prim_tris.nbytes,
          "texture atlas (the skin pyramid)": tx.atlas.nbytes,
          "env map": lt.env_map.nbytes,
          "env Distribution2D": sum(getattr(d2, f).nbytes for f in (
              "cond_func", "cond_cdf", "cond_int", "marg_func", "marg_cdf",
              "marg_int", "cond_keys")),
          "spatial distribution": scene.spatial_cdf.nbytes + scene.spatial_pmf.nbytes}
    print("config3 bytes on the card, MB: " + json.dumps(
        {k: round(v / 1e6, 3) for k, v in mb.items()}), flush=True)
    if profile is not None:
        film_cfg, filt = setup.make_film_config()
        sampler = setup.make_sampler_config()
        camera = setup.make_camera().to(dev)
        state = fm.make_film_state(film_cfg, filt, dev)
        pixels = torch.as_tensor(ip.make_pixel_grid(film_cfg), device=dev)
        with torch.no_grad():
            cfg = setup.make_integrator_config()
            profile_render(lambda: ip.sample_batch(
                ip.path_li(scene, sampler, cfg), ip.n_path_dims(cfg), scene,
                camera, state, pixels, 0, sampler, stats.zeros(dev)),
                profile.with_name(f"{profile.stem}_config3{profile.suffix}"),
                "config3 profile")
    config3_cross(scene, captured)
    del captured
    return {"bvh4": runs[0][1]["bvh4_traverse"], "bvh2": runs[2][1]["bvh2_traverse"]}


def direct_phase(render, read_pfm, counted, card, dev):
    """Phase 11: Integrator "directlighting" through render_file on the
    card: b_arealight with strategy "one" at maxdepth 1 (the path
    integrator's NEE dims 5-9) against its pbrt-v3 golden at
    tests/test_parity_images.py's bars, then the main scene at 400x400 @
    8 spp, depth 5, with "one" and "all"."""
    out_dir = SMOKE_DIR / "direct"
    out_dir.mkdir(parents=True, exist_ok=True)
    line = 'Integrator "path" "integer maxdepth" [1]'
    src = (HERE / "refgold/parity/b_arealight.pbrt").read_text()
    check(line in src, "b_arealight.pbrt has no path Integrator line")
    b_path = out_dir / "b_direct_one.pbrt"
    b_path.write_text(src.replace(line, 'Integrator "directlighting" '
                                        '"integer maxdepth" [1] "string strategy" "one"'))
    img, _, launches = timed_render_file(render, counted, b_path,
                                         out_dir / "b.pfm", dev)
    ref = read_pfm(str(HERE / "refgold/goldens/parity/b_arealight.pfm"))
    frac, mean_rel = image_bars(ref, img)
    print(f"direct b_arealight (\"one\", maxdepth 1): match_frac {frac:.4f} "
          f"(>= 0.999), mean rel {mean_rel:.3e} (<= 1e-4), launches {launches}",
          flush=True)
    check(frac >= 0.999 and mean_rel <= 1e-4,
          f"direct b_arealight: match_frac {frac}, mean rel {mean_rel}")

    main = write_main_pbrt(out_dir)
    text = main.read_text()
    out = {}
    for strategy in ("one", "all"):
        p = out_dir / f"main_{strategy}.pbrt"
        p.write_text(text.replace(
            f'Integrator "path" "integer maxdepth" [{DEPTH}]',
            f'Integrator "directlighting" "integer maxdepth" [{DEPTH}] '
            f'"string strategy" "{strategy}"'))
        img, st, launches = timed_render_file(render, counted, p,
                                              out_dir / f"{strategy}.pfm", dev)
        # one light of nsamples 1: a closest-hit launch a depth and one NEE
        # launch a vertex, either strategy
        want = SPP * (DEPTH + 1 + DEPTH)
        check(launches["bvh4_traverse"] == want and launches["bvh2_traverse"] == 0,
              f"direct {strategy}: launches {launches}, not {want}")
        print(render_line(f"direct main {RES[0]}x{RES[1]} @ {SPP} spp, "
                          f"\"{strategy}\"", st, launches, card)
              + f", image mean {float(img.mean()):.6f}", flush=True)
        out[strategy] = (float(img.mean()), launches["bvh4_traverse"])
    m1, m2 = out["one"][0], out["all"][0]
    check(abs(m1 - m2) <= 0.02 * m1, f"direct means: one {m1}, all {m2}")
    return {k: v[1] for k, v in out.items()}


def config4_phase(render, counted, card, dev, profile):
    """Phase 12: BASELINE config 4 through render_file on the card: the
    main scene's blob with a homogeneous fog sphere and a 128^3 density
    grid, volpath at 400x400 @ 8 spp, depth 5.  86 launches a spp; a
    bit-identical repeat, PBRT_TPU_BVH4=0 against bvh4 and a 64x64 @ 2
    spp copy on the card against the CPU at tests/test_torch_path.py:58-59's
    bars, and each kernel held against its plain version on the walk
    batches of one spp."""
    from pbrt_tpu_torch.integrators import volpath
    from pbrt_tpu_torch.lights import lightdistrib
    from pbrt_tpu_torch.ops import bvh
    from pbrt_tpu_torch.samplers.samplers import SamplerConfig
    from pbrt_tpu_torch.sceneio import parse_pbrt_file

    out_dir = SMOKE_DIR / "config4"
    t0 = time.perf_counter()
    path = write_config4_pbrt(out_dir)
    print(f"config4 file: {path.stat().st_size / 1e6:.1f} MB written in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    want = SPP * CONFIG4_LAUNCHES
    runs = []
    for kind, switch in (("bvh4", "1"), ("bvh4", "1"), ("bvh2", "0")):
        c0 = time.process_time()
        img, st, launches = timed_render_file(render, counted, path,
                                              out_dir / f"{kind}.pfm", dev, switch)
        cpu = time.process_time() - c0
        other = "bvh2" if kind == "bvh4" else "bvh4"
        check(launches[f"{kind}_traverse"] == want
              and launches[f"{other}_traverse"] == 0,
              f"config4 ({kind}) launches {launches}, not {want} of {kind}")
        wall = st["phases"]["Rendering"]
        print(render_line(f"config4 {RES[0]}x{RES[1]} @ {SPP} spp, {kind}", st,
                          launches, card)
              + f", wall {wall / SPP:.4f} s a spp, process CPU of the whole "
              f"call {cpu:.3f} s, image mean {float(img.mean()):.6f}", flush=True)
        runs.append((img, launches))
    check(np.array_equal(runs[0][0], runs[1][0]), "config4: a repeat differs")
    frac, mean_rel = image_bars(runs[0][0], runs[2][0])
    print(f"config4 bvh2 against bvh4: bit-equal "
          f"{np.array_equal(runs[0][0], runs[2][0])}, match_frac {frac:.4f}, "
          f"mean rel {mean_rel:.3e}", flush=True)
    check(frac >= 0.995 and mean_rel <= 5e-3,
          f"config4 bvh2 against bvh4: match_frac {frac}, mean rel {mean_rel}")

    small = write_config4_pbrt(out_dir / "small", res=(64, 64), spp=2)
    a, _ = render.render_file(str(small), out=str(out_dir / "small_card.pfm"),
                              device=dev)
    t0 = time.perf_counter()
    b, _ = render.render_file(str(small), out=str(out_dir / "small_cpu.pfm"),
                              device="cpu")
    frac, mean_rel = image_bars(b, a)
    print(f"config4 card against cpu (64x64 @ 2 spp): match_frac {frac:.4f}, "
          f"mean rel {mean_rel:.3e}; the CPU render {time.perf_counter() - t0:.2f} s",
          flush=True)
    check(frac >= 0.995 and mean_rel <= 5e-3,
          f"config4 card against cpu: match_frac {frac}, mean rel {mean_rel}")

    setup = parse_pbrt_file(str(path))
    scene = lightdistrib.ensure_spatial_light_distribution(setup.build_scene(dev))
    mb = {"bvh4 nodes + triangles": scene.bvh4_nodes.nbytes + scene.prim_tris.nbytes,
          "bvh2 nodes + triangles": scene.bvh2_nodes.nbytes + scene.prim_tris.nbytes,
          "density atlas": scene.media.density_atlas.nbytes,
          "spatial distribution": scene.spatial_cdf.nbytes + scene.spatial_pmf.nbytes}
    print("config4 bytes on the card, MB: " + json.dumps(
        {k: round(v / 1e6, 3) for k, v in mb.items()}), flush=True)
    film_cfg, filt = setup.make_film_config()
    camera = setup.make_camera()
    cfg = setup.make_integrator_config()
    one = SamplerConfig("halton", 1, RES)
    if profile is not None:
        profile_render(lambda: volpath.render(scene, camera, film_cfg, one, cfg, filt,
                                              device=dev),
                       profile.with_name(f"{profile.stem}_config4{profile.suffix}"),
                       "config4 profile")
    # each kernel against its plain version and bvh2 against bvh4 on the
    # batches of one spp: the camera rays, the first segment of the surface
    # NEE's shadow and MIS walks at bounce 0 (launches 9 and 13), and of the
    # medium vertex's at bounce 1 (18 and 22; no lane is in a medium at
    # bounce 0, the camera being outside the media)
    kernels = bvh_kernels(bvh)
    with bvh.record_calls() as captured:
        volpath.render(scene, camera, film_cfg, one, cfg, filt, device=dev)
    check(len(captured) == CONFIG4_LAUNCHES,
          f"config4: one spp launched {len(captured)} times")
    results = {kind: {} for kind in kernels}
    for label, i in (("camera", 0), ("surface-shadow", 9), ("surface-mis", 13),
                     ("medium-shadow", 18), ("medium-mis", 22)):
        oc, dc, tc, mc, order = captured[i]
        print(f"batch config4-{label}: {tc.shape[0]} lanes, {int((tc > 0).sum())} "
              f"live", flush=True)
        for kind, k in kernels.items():
            results[kind][label] = kernel_case(f"{kind}-config4-{label}", k, bvh,
                                               scene, oc, dc, tc, mc > 0, "mask",
                                               order)
        cross_check(f"config4-{label}", kernels, scene, oc, dc, tc, mc > 0, order)
    del captured
    return {"bvh4": runs[0][1]["bvh4_traverse"], "bvh2": runs[2][1]["bvh2_traverse"],
            "results": results}


def whitted_ao_phase(render, counted, card, dev):
    """Phase 13: Integrator "whitted" (maxdepth 5) and "ao" (nsamples 64)
    on the main scene through render_file at 400x400 @ 8 spp: finite and
    non-zero, the launches, a bit-identical repeat, and a 64x64 @ 2 spp
    copy on the card against the CPU at tests/test_torch_path.py:58-59's
    bars.  Then one spp of each under bvh.record_calls(): each kernel held
    against its plain version, and bvh2 against bvh4, on the camera batch,
    whitted's bounce-0 shadow batch and ao's first probe batch."""
    from pbrt_tpu_torch.integrators import ao, whitted
    from pbrt_tpu_torch.ops import bvh
    from pbrt_tpu_torch.samplers.samplers import SamplerConfig
    from pbrt_tpu_torch.sceneio import parse_pbrt_file

    out_dir = SMOKE_DIR / "whitted_ao"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = write_main_pbrt(out_dir).read_text()
    line = f'Integrator "path" "integer maxdepth" [{DEPTH}]'
    kernels = bvh_kernels(bvh)
    out = {"results": {kind: {} for kind in kernels}}
    # (name, Integrator line, launches a spp, renderer, batches to check:
    # label and index in one spp's launches)
    for name, integ, per_spp, renderer, batches in (
            ("whitted", f'Integrator "whitted" "integer maxdepth" [{DEPTH}]',
             WHITTED_LAUNCHES, whitted.render, (("camera", 0), ("shadow", 1))),
            ("ao", f'Integrator "ao" "integer nsamples" [{AO_SAMPLES}]',
             1 + AO_SAMPLES, ao.render, (("probe", 1),))):
        p = out_dir / f"main_{name}.pbrt"
        p.write_text(text.replace(line, integ))
        imgs = []
        for _ in range(2):
            img, st, launches = timed_render_file(render, counted, p,
                                                  out_dir / f"{name}.pfm", dev)
            check(launches["bvh4_traverse"] == SPP * per_spp
                  and launches["bvh2_traverse"] == 0,
                  f"{name}: launches {launches}, not {SPP * per_spp}")
            print(render_line(f"{name} main {RES[0]}x{RES[1]} @ {SPP} spp", st,
                              launches, card)
                  + f", wall {st['phases']['Rendering'] / SPP:.4f} s a spp, "
                  f"image mean {float(img.mean()):.6f}", flush=True)
            imgs.append(img)
        check(np.array_equal(imgs[0], imgs[1]), f"{name}: a repeat differs")
        small = out_dir / f"small_{name}.pbrt"
        small.write_text(p.read_text().replace(
            f'"integer xresolution" [{RES[0]}] "integer yresolution" [{RES[1]}]',
            '"integer xresolution" [64] "integer yresolution" [64]').replace(
            f'"integer pixelsamples" [{SPP}]', '"integer pixelsamples" [2]'))
        a, _ = render.render_file(str(small), out=str(out_dir / "small_card.pfm"),
                                  device=dev)
        t0 = time.perf_counter()
        b, _ = render.render_file(str(small), out=str(out_dir / "small_cpu.pfm"),
                                  device="cpu")
        frac, mean_rel = image_bars(b, a)
        print(f"{name} card against cpu (64x64 @ 2 spp): match_frac {frac:.4f}, "
              f"mean rel {mean_rel:.3e}; the CPU render "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        check(a.shape == (64, 64, 3) and frac >= 0.995 and mean_rel <= 5e-3,
              f"{name} card against cpu: match_frac {frac}, mean rel {mean_rel}")
        out[name] = launches["bvh4_traverse"]

        setup = parse_pbrt_file(str(p))
        scene = setup.build_scene(dev)
        film_cfg, filt = setup.make_film_config()
        with bvh.record_calls() as captured:
            renderer(scene, setup.make_camera(), film_cfg,
                     SamplerConfig("halton", 1, RES),
                     setup.make_integrator_config(), filt, device=dev)
        check(len(captured) == per_spp,
              f"{name}: one spp launched {len(captured)} times, not {per_spp}")
        for label, i in batches:
            oc, dc, tc, mc, order = captured[i]
            live = tc > 0
            print(f"batch {name}-{label}: {tc.shape[0]} lanes, "
                  f"{int(live.sum())} live, {int((mc > 0).sum())} any-hit",
                  flush=True)
            if name == "ao":
                check(bool((mc > 0).all()) and bool((tc[live] >= 1e30).all()),
                      "ao: a probe batch has lanes that are not unbounded any-hit")
            for kind, k in kernels.items():
                out["results"][kind][f"{name}-{label}"] = kernel_case(
                    f"{kind}-{name}-{label}", k, bvh, scene, oc, dc, tc, mc > 0,
                    "mask", order)
            cross_check(f"{name}-{label}", kernels, scene, oc, dc, tc, mc > 0,
                        order)
        del captured, scene
    return out


def breadth_phase(render, counted, card, dev, profile):
    """Phase 14: pbrt-v3's classic material and light set through
    render_file on the card (write_breadth_pbrt: uber, substrate,
    translucent, metal, mix, uber with an imagemap opacity; spot, distant,
    projection and goniometric lights beside the emissive sphere), path at
    400x400 @ 8 spp, depth 5, halton, spatial distribution: 48 launches, a
    bit-identical repeat, PBRT_TPU_BVH4=0 against bvh4; a 64x64 @ 1 spp copy
    under path, directlighting "all" and volpath on the card against the
    CPU, after the card's spatial distribution against the CPU's; each kernel
    against its plain version and bvh2 against bvh4 on one spp's camera
    batch and bounce-0 merged batch, whose shadow lanes go to every kind of
    light."""
    import torch

    from pbrt_tpu_torch.integrators import direct, volpath
    from pbrt_tpu_torch.integrators import path as ip
    from pbrt_tpu_torch.lights import lightdistrib
    from pbrt_tpu_torch.ops import bvh
    from pbrt_tpu_torch.samplers.samplers import SamplerConfig
    from pbrt_tpu_torch.sceneio import parse_pbrt_file

    out_dir = SMOKE_DIR / "breadth"
    t0 = time.perf_counter()
    split = {}
    path = write_breadth_pbrt(out_dir)
    print(f"breadth file and maps written in {time.perf_counter() - t0:.2f} s",
          flush=True)
    want = SPP * (1 + DEPTH)
    runs = []
    for kind, switch in (("bvh4", "1"), ("bvh4", "1"), ("bvh2", "0")):
        c0 = time.process_time()
        img, st, launches = timed_render_file(render, counted, path,
                                              out_dir / f"{kind}.pfm", dev, switch)
        cpu = time.process_time() - c0
        other = "bvh2" if kind == "bvh4" else "bvh4"
        check(launches[f"{kind}_traverse"] == want
              and launches[f"{other}_traverse"] == 0,
              f"breadth ({kind}) launches {launches}, not {want} of {kind}")
        wall = st["phases"]["Rendering"]
        print(render_line(f"breadth {RES[0]}x{RES[1]} @ {SPP} spp, {kind}", st,
                          launches, card)
              + f", wall {wall / SPP:.4f} s a spp, process CPU of the whole "
              f"call {cpu:.3f} s, image mean {float(img.mean()):.6f}", flush=True)
        runs.append((img, launches))
    check(np.array_equal(runs[0][0], runs[1][0]), "breadth: a repeat differs")
    frac, mean_rel = image_bars(runs[0][0], runs[2][0])
    print(f"breadth bvh2 against bvh4: bit-equal "
          f"{np.array_equal(runs[0][0], runs[2][0])}, match_frac {frac:.4f}, "
          f"mean rel {mean_rel:.3e}", flush=True)
    check(frac >= 0.995 and mean_rel <= 5e-3,
          f"breadth bvh2 against bvh4: match_frac {frac}, mean rel {mean_rel}")

    split["renders"] = time.perf_counter() - t0

    # the 64x64 copy under three integrators, card against CPU, each side
    # with the spatial distribution it builds; the card's is first held
    # against the CPU's at tests/test_torch_lightdistrib.py's bars (grid,
    # origin and extent equal, cdf and pmf within 1e-5)
    t0 = time.perf_counter()
    small = write_breadth_pbrt(out_dir / "small", res=(64, 64), spp=1)
    line = f'Integrator "path" "integer maxdepth" [{DEPTH}]'
    spatial = ("spatial_grid_res", "spatial_b0", "spatial_diag", "spatial_cdf",
               "spatial_pmf")
    card_scene = lightdistrib.ensure_spatial_light_distribution(
        parse_pbrt_file(str(small)).build_scene(dev))
    t1 = time.perf_counter()
    cpu_scene = lightdistrib.ensure_spatial_light_distribution(
        parse_pbrt_file(str(small)).build_scene("cpu"))
    cpu_build = time.perf_counter() - t1
    errs = {}
    for k in spatial:
        a, b = getattr(card_scene, k).cpu().numpy(), getattr(cpu_scene, k).numpy()
        check(a.shape == b.shape, f"breadth spatial {k}: shape {a.shape} "
              f"on the card, {b.shape} on the CPU")
        errs[k] = float(np.abs(a - b).max())
        check(errs[k] == 0.0 if k in spatial[:3] else errs[k] <= 1e-5,
              f"breadth spatial {k}: the card's differs from the CPU's by "
              f"{errs[k]}")
    print(f"breadth spatial distribution ({int(np.prod(b.shape[:-1]))} voxels "
          f"x {b.shape[-1]} lights), card against cpu: max abs differences "
          f"{json.dumps(errs)}; the CPU build {cpu_build:.2f} s", flush=True)
    del card_scene
    for name, integ, renderer in (
            ("path", line, ip.render),
            ("directlighting", f'Integrator "directlighting" "integer maxdepth" '
                               f'[{DEPTH}] "string strategy" "all"', direct.render),
            ("volpath", f'Integrator "volpath" "integer maxdepth" [{DEPTH}]',
             volpath.render)):
        p = small.with_name(f"small_{name}.pbrt")
        p.write_text(small.read_text().replace(line, integ))
        a, _ = render.render_file(str(p), out=str(out_dir / f"small_{name}.pfm"),
                                  device=dev)
        t1 = time.perf_counter()
        setup = parse_pbrt_file(str(p))
        film_cfg, filt = setup.make_film_config()
        b = renderer(cpu_scene, setup.make_camera(), film_cfg,
                     setup.make_sampler_config(), setup.make_integrator_config(),
                     filt, device="cpu").numpy()
        frac, mean_rel = image_bars(b, a)
        print(f"breadth {name} card against cpu (64x64 @ 1 spp): match_frac "
              f"{frac:.4f}, mean rel {mean_rel:.3e}; the CPU "
              f"{time.perf_counter() - t1:.2f} s", flush=True)
        check(a.shape == (64, 64, 3) and bool(np.isfinite(a).all())
              and float(a.mean()) > 0 and frac >= 0.995 and mean_rel <= 5e-3,
              f"breadth {name} card against cpu: match_frac {frac}, "
              f"mean rel {mean_rel}")
    del cpu_scene
    split["64x64 copies"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    setup = parse_pbrt_file(str(path))
    scene = lightdistrib.ensure_spatial_light_distribution(setup.build_scene(dev))
    lt, mt = scene.lights, scene.materials
    mb = {"bvh4 nodes + triangles": scene.bvh4_nodes.nbytes + scene.prim_tris.nbytes,
          "bvh2 nodes + triangles": scene.bvh2_nodes.nbytes + scene.prim_tris.nbytes,
          "material table": sum(getattr(mt, f.name).nbytes
                                for f in dataclasses.fields(mt)),
          "texture atlas (the opacity map)": scene.textures.atlas.nbytes,
          "projection slide": lt.proj_img.nbytes,
          "goniometric map": lt.gonio_img.nbytes,
          "spatial distribution": scene.spatial_cdf.nbytes + scene.spatial_pmf.nbytes}
    print("breadth bytes on the card, MB: " + json.dumps(
        {k: round(v / 1e6, 4) for k, v in mb.items()}), flush=True)
    film_cfg, filt = setup.make_film_config()
    camera = setup.make_camera()
    cfg = setup.make_integrator_config()
    one = SamplerConfig("halton", 1, RES)
    if profile is not None:
        profile_render(lambda: ip.render(scene, camera, film_cfg, one, cfg, filt,
                                         device=dev),
                       profile.with_name(f"{profile.stem}_breadth{profile.suffix}"),
                       "breadth profile")
    kernels = bvh_kernels(bvh)
    split["set-up, bytes, profile"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with bvh.record_calls() as captured:
        ip.render(scene, camera, film_cfg, one, cfg, filt, device=dev)
    check(len(captured) == 1 + DEPTH,
          f"breadth: one spp launched {len(captured)} times")
    results = {kind: {} for kind in kernels}
    for label, i in (("camera", 0), ("merged-b0", 1)):
        oc, dc, tc, mc, order = captured[i]
        n = tc.shape[0] // 3 if label != "camera" else tc.shape[0]
        shadow_t = tc[:n] if label != "camera" else tc[:0]
        # a distant light's shadow lane runs to 2 * world_radius; no other
        # light of the scene is 1.9 radii from a surface
        far = int((shadow_t > 1.9 * float(lt.world_radius)).sum())
        print(f"batch breadth-{label}: {tc.shape[0]} lanes, {int((tc > 0).sum())} "
              f"live, {int((mc > 0).sum())} any-hit, {far} shadow lanes to the "
              f"distant light", flush=True)
        check(label == "camera" or far > 0,
              "breadth: no distant-light shadow lane in the merged batch")
        for kind, k in kernels.items():
            results[kind][label] = kernel_case(f"{kind}-breadth-{label}", k, bvh,
                                               scene, oc, dc, tc, mc > 0, "mask",
                                               order)
        cross_check(f"breadth-{label}", kernels, scene, oc, dc, tc, mc > 0, order)
    del captured, scene
    torch.cuda.empty_cache()
    split["kernel checks"] = time.perf_counter() - t0
    print("breadth phase split, s: " + json.dumps(
        {k: round(v, 2) for k, v in split.items()}), flush=True)
    return {"bvh4": runs[0][1]["bvh4_traverse"], "bvh2": runs[2][1]["bvh2_traverse"],
            "results": results}


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------

def run(profile: Path | None = None) -> dict:
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false")
    if not (HERE / "pbrt_tpu_torch" / "csrc" / "bvh2_traverse.cu").exists():
        raise SmokeFailure("pbrt_tpu_torch/ is not beside chip_smoke.py")
    sys.path.insert(0, str(HERE))
    from pbrt_tpu_torch import cameras, native, render
    from pbrt_tpu_torch import scene as sc
    from pbrt_tpu_torch.core import transform as tf
    from pbrt_tpu_torch.film import FilmConfig
    from pbrt_tpu_torch.integrators import path
    from pbrt_tpu_torch.lights import lightdistrib
    from pbrt_tpu_torch.ops import bvh
    from pbrt_tpu_torch.parallel import diff
    from pbrt_tpu_torch.samplers.samplers import SamplerConfig
    from pbrt_tpu_torch.tools import bench_layout_probe as bp
    from pbrt_tpu_torch.utils import stats
    from pbrt_tpu_torch.utils.imageio import read_pfm

    counted = {"bvh4_traverse": bvh.bvh4_traverse,
               "bvh2_traverse": bvh.bvh2_traverse,
               "chain_fused": bp.chain_fused}
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    t_all = time.perf_counter()
    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else name
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # 2. build: every native library at once, then the Triton kernel
    t0 = time.perf_counter()
    native.build()
    t1 = time.perf_counter()
    x = torch.zeros((3, 8), device=dev)
    bp.chain_fused(x, x, x, torch.zeros(8, device=dev))
    torch.cuda.synchronize()
    bp.chain_fused.launches = 0
    print(f"build: bvh4_traverse.cu + bvh2_traverse.cu + bvh_builder.cpp in "
          f"{t1 - t0:.2f} s, the Triton chain kernel in "
          f"{time.perf_counter() - t1:.2f} s", flush=True)
    for kernel in native.CUDA_KERNELS:
        for line in native.build_log(kernel).splitlines():
            if "ptxas" in line or "spill" in line:
                print(f"build {kernel}: {line.strip()}", flush=True)
    phase("build", t0)

    # 3. BVH kernels against plain and against each other
    t0 = time.perf_counter()
    results, scene, camera, film_cfg, cfg = bvh_phase(
        sc, tf, path, bvh, cameras, FilmConfig, SamplerConfig, dev)
    per_spp = {}
    for kind, res in results.items():
        main = [r for label, r in res.items() if label.startswith("main-")]
        per_spp[kind] = {k: sum(r[k] for r in main) for k in
                         ("ms", "plain_ms", "bound_ms", "visit_bound_ms", "visit_mb",
                          "ms_gathered", "glue_ms")}
        per_spp[kind]["node_visits"] = sum(r["node_visits_per_ray"] * r["rays"] for r in main)
        print(f"{kind} per spp of the main path: {json.dumps(per_spp[kind])}",
              flush=True)
    phase("bvh kernels", t0)

    # 4. layout probe
    t0 = time.perf_counter()
    probe = probe_phase(bp, dev, counted)
    phase("layout probe", t0)

    # 5. main path, through the entry point a user calls
    t0 = time.perf_counter()
    sampler = SamplerConfig("halton", SPP, RES)
    reset_counts(counted)
    torch.cuda.synchronize()
    t1, c1 = time.perf_counter(), time.process_time()
    img, rays = path.render(scene, camera, film_cfg, sampler, cfg, count_rays=True)
    torch.cuda.synchronize()
    wall, cpu = time.perf_counter() - t1, time.process_time() - c1
    launches = read_counts(counted)
    check(launches["bvh4_traverse"] == SPP * (1 + DEPTH),
          f"main path launched bvh4 {launches['bvh4_traverse']} times, not "
          f"{SPP * (1 + DEPTH)}")
    check(launches["bvh2_traverse"] == 0, "main path launched bvh2")
    check(tuple(img.shape) == (RES[1], RES[0], 3), f"image shape {tuple(img.shape)}")
    check(bool(torch.isfinite(img).all()), "image has non-finite values")
    check(float(img.mean()) > 0.0, "image is black")
    t1, c1 = time.perf_counter(), time.process_time()
    img2 = path.render(scene, camera, film_cfg, sampler, cfg)
    torch.cuda.synchronize()
    wall2, cpu2 = time.perf_counter() - t1, time.process_time() - c1
    check(torch.equal(img, img2), "a second render differs")
    print(f"main path: {RES[0]}x{RES[1]} @ {SPP} spp, depth {DEPTH}: "
          f"{wall:.3f} s wall ({wall2:.3f} s the repeat), {int(rays)} rays, "
          f"{rays / wall / 1e6:.3f} Mrays/s, launches {launches}, "
          f"image mean {float(img.mean()):.6f}, repeat bit-identical", flush=True)
    # host CPU time of this process beside the wall: near the wall when the
    # render waits on the host issuing operations, not on the card
    print(f"main path host: process CPU {cpu:.3f} s ({cpu2:.3f} s the repeat), "
          f"{len(os.sched_getaffinity(0))} cores, load average "
          f"{os.getloadavg()[0]:.2f}", flush=True)
    k4 = per_spp["bvh4"]
    print(f"main path kernel time: {k4['ms']:.4f} ms per spp (bound "
          f"{k4['bound_ms']:.4f} ms, visit bound {k4['visit_bound_ms']:.4f} ms, "
          f"plain {k4['plain_ms']:.1f} ms), {k4['ms'] * SPP / (wall * 1e3):.4%} "
          f"of the render's wall", flush=True)
    if profile is not None:
        profile_render(lambda: path.render(scene, camera, film_cfg,
                                           SamplerConfig("halton", 1, RES), cfg),
                       profile)
    ref_img = img.cpu().numpy()
    del img, img2
    phase("main path", t0)

    # 6. card against CPU on the small demo scene
    t0 = time.perf_counter()
    small = (32, 32)
    fields = demo_scene(sc.SceneBuilder, sc, tf).build_numpy()
    s_gpu = sc.SceneArrays.from_numpy(fields, dev)
    s_cpu = sc.SceneArrays.from_numpy(fields, "cpu")
    cam_s = camera_for(cameras, tf, small)
    fc = FilmConfig(full_resolution=small)
    for depth_s, per_pixel in ((1, True), (3, False)):
        kw = dict(film_cfg=fc, sampler_cfg=SamplerConfig("halton", 2, small),
                  cfg=path.PathConfig(max_depth=depth_s))
        a = path.render(s_gpu, cam_s, device=dev, **kw).cpu().numpy()
        b = path.render(s_cpu, cam_s, device="cpu", **kw).numpy()
        rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-2)
        frac = float(np.all(rel <= 1e-3, -1).mean())
        mean_rel = abs(float(a.mean()) - float(b.mean())) / max(float(b.mean()), 1e-6)
        print(f"card vs cpu depth {depth_s}: match_frac {frac:.4f}, "
              f"mean rel {mean_rel:.3e}", flush=True)
        if per_pixel:
            check(frac >= 0.995, f"card vs cpu depth {depth_s}: {frac}")
        else:
            check(mean_rel <= 1e-3, f"card vs cpu depth {depth_s}: {mean_rel}")
    del s_gpu
    phase("card against cpu", t0)

    # 7. parity ladder
    t0 = time.perf_counter()
    ladder_phase(render, read_pfm, dev)
    phase("parity ladder", t0)

    # 8. CLI at full width, both BVH kernels
    t0 = time.perf_counter()
    bvh2_launches = cli_phase(render, read_pfm, lightdistrib, counted, ref_img, dev)
    phase("cli", t0)

    # 9. differentiable rendering on the main scene
    t0 = time.perf_counter()
    grad_launches = grad_phase(
        diff, path, stats, SamplerConfig, scene, camera, film_cfg, cfg, counted,
        card, dev, None if profile is None
        else profile.with_name(f"{profile.stem}_grad{profile.suffix}"))
    del scene
    phase("grad", t0)

    # 10. BASELINE config 3's features through the front end
    t0 = time.perf_counter()
    c3 = config3_phase(render, counted, card, dev, profile)
    phase("config3", t0)

    # 11. the direct-lighting integrator
    t0 = time.perf_counter()
    dl = direct_phase(render, read_pfm, counted, card, dev)
    phase("direct", t0)

    # 12. BASELINE config 4: participating media, volpath
    t0 = time.perf_counter()
    c4 = config4_phase(render, counted, card, dev, profile)
    phase("config4", t0)

    # 13. the Whitted and ambient-occlusion integrators
    t0 = time.perf_counter()
    wa = whitted_ao_phase(render, counted, card, dev)
    phase("whitted and ao", t0)

    # 14. pbrt-v3's classic materials and lights
    t0 = time.perf_counter()
    br = breadth_phase(render, counted, card, dev, profile)
    phase("breadth", t0)

    # the kernels line
    entries = []
    for kind, src, replaces, n_launch in (
            ("bvh4", "pbrt_tpu_torch/csrc/bvh4_traverse.cu",
             "pbrt_tpu/ops/pallas_bvh.py:382 (_make_kernel4, pallas_call at :632)",
             launches["bvh4_traverse"]),
            ("bvh2", "pbrt_tpu_torch/csrc/bvh2_traverse.cu",
             "pbrt_tpu/ops/pallas_bvh.py:230 (_make_kernel, pallas_call at :666)",
             bvh2_launches)):
        res = results[kind]
        checked = (list(res.values()) + list(c4["results"][kind].values())
                   + list(wa["results"][kind].values())
                   + list(br["results"][kind].values()))
        nee = res["main-nee-merged-b0"]
        entries.append({
            "name": f"{kind}_traverse", "route": "cuda", "source": src,
            "replaces": replaces, "launches": n_launch,
            "grad_launches": grad_launches[kind],
            "config3_launches": c3[kind],
            "config4_launches": c4[kind],
            "config4_camera_ms": c4["results"][kind]["camera"]["ms"],
            "config4_walk_ms": c4["results"][kind]["surface-shadow"]["ms"],
            "config4_walk_plain_ms": c4["results"][kind]["surface-shadow"]["plain_ms"],
            "whitted_shadow_ms": wa["results"][kind]["whitted-shadow"]["ms"],
            "ao_probe_ms": wa["results"][kind]["ao-probe"]["ms"],
            "ao_probe_plain_ms": wa["results"][kind]["ao-probe"]["plain_ms"],
            "breadth_launches": br[kind],
            "breadth_camera_ms": br["results"][kind]["camera"]["ms"],
            "breadth_merged_ms": br["results"][kind]["merged-b0"]["ms"],
            "breadth_merged_plain_ms": br["results"][kind]["merged-b0"]["plain_ms"],
            "breadth_merged_bound_ms": br["results"][kind]["merged-b0"]["bound_ms"],
            "max_abs_err": max(r["max_abs_err"] for r in checked),
            "mismatch_frac": max(r["mismatch_frac"] for r in checked),
            "ms": nee["ms"], "plain_ms": nee["plain_ms"],
            "bound_ms": nee["bound_ms"], "bound_by": nee["bound_by"],
            "library_ms": None, "visit_bound_ms": nee["visit_bound_ms"],
            "shape": f"{nee['rays']} rays (the main path's bounce-0 merged NEE "
                     "batch, any-hit shadow lanes as launched)",
            "ms_per_spp": per_spp[kind]["ms"],
            "bound_ms_per_spp": per_spp[kind]["bound_ms"],
            "visit_bound_ms_per_spp": per_spp[kind]["visit_bound_ms"],
            "mesh1M_ms": res["mesh1M-64k"]["ms"],
            "ms_gathered_per_spp": per_spp[kind]["ms_gathered"],
            "glue_ms_per_spp": per_spp[kind]["glue_ms"],
        })
    entries[0]["direct_one_launches"] = dl["one"]
    entries[0]["direct_all_launches"] = dl["all"]
    entries[0]["whitted_launches"] = wa["whitted"]
    entries[0]["ao_launches"] = wa["ao"]
    entries.append({
        "name": "chain_fused", "route": "triton",
        "source": "pbrt_tpu_torch/tools/bench_layout_probe.py",
        "replaces": "tools/bench_layout_probe.py:67 (pallas_fused, pallas_call at :79)",
        "launches": probe["launches"], "max_abs_err": probe["max_abs_err"],
        "exact_frac": probe["exact_frac"],
        "ms": probe["ms"], "device_ms": probe["device_ms"],
        "plain_ms": probe["plain_ms"], "plain_device_ms": probe["plain_device_ms"],
        "rows_ms": probe["rows_ms"],
        "bound_ms": probe["bound_ms"], "bound_by": probe["bound_by"],
        "library_ms": None,
        "shape": f"p, d, ns f32 [3, {probe['n']}], t f32 [{probe['n']}]",
    })
    print(f"chip_smoke: {time.perf_counter() - t_all:.1f} s in all", flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    return {"ok": True, "device": {"platform": "gpu", "kind": name,
                                   "count": torch.cuda.device_count()}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", type=Path, metavar="FILE",
                    help="profile one more sample of the main path; write the "
                         "profiler's table to FILE")
    args = ap.parse_args()
    try:
        import torch  # noqa: F401
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    try:
        result = run(profile=args.profile)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
