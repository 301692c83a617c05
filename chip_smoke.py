#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (pbrt_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--profile FILE]

Phases, each printing its result on a line of its own and its seconds:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: csrc/bvh4_traverse.cu (its triangle-only and typed builds) and
     csrc/bvh2_traverse.cu (one nvcc each, sm_90a) and the host BVH builder
     (g++), all compilers started together,
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
     tables and rays, and the bytes of every node and triangle visit, and
     its warp efficiency (warp_efficiency: how much of each warp's time its
     lanes idle behind its busiest); on
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
     split into the kernel, the key and argsort, the quadric pass and the
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
     floor, a smooth and a rough glass sphere, an env map; 400x400 @ 16
     spp (cut from 64 to 16, then to 8, as phases were added), depth 5, spatial
     distribution): Mrays/s,
     wall, process CPU and set-up by phase (the pyramid and the env CDF
     timed alone too), 48 bvh4 launches, a bit-identical repeat,
     PBRT_TPU_BVH4=0 with 48 bvh2 launches at tests/test_torch_path.py:
     58-59's bars against bvh4, and a 64x64 @ 1 spp copy
     on the card against the CPU at the same bars; with
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
     a seeded 128^3 density grid (8.4 MB); volpath, 400x400 @ 4 spp (cut
     from 8), depth 3 (cut from 5), halton, spatial
     distribution: Mrays/s (live
     traversal lanes over the render's wall), the wall a spp, process CPU
     and set-up by phase, the bytes on the card, 208 bvh4 launches (52 a
     spp), a bit-identical repeat, PBRT_TPU_BVH4=0 with 208 bvh2 launches
     against bvh4 and a
     64x64 @ 1 spp copy on the card against the CPU, both at
     tests/test_torch_path.py:58-59's bars, and each kernel against its
     plain version and bvh2 against bvh4 on the camera batch and the first
     segment of each of the four walks (the surface's at bounce 0, the
     medium vertex's at bounce 1); with --profile FILE,
     one spp under torch.profiler, its table written to FILE's name plus
     "_config4" (ranges "layer: media / delta tracking", "/ ratio
     tracking", "/ Tr walk", "/ medium NEE");
 13. whitted and ao: the main scene's file with Integrator "whitted"
     (maxdepth 5, 44 launches) and "ao" (nsamples 64, 260 launches) at
     400x400 @ 4 spp (cut from 8): finite, non-zero, a
     bit-identical repeat, a 64x64 @
     1 spp copy on the card against the CPU at tests/test_torch_path.py:
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
     goniometric light (a seeded 32x64 map); path at 400x400 @ 4 spp (cut
     from 8), depth 5, spatial distribution: Mrays/s, the wall a
     spp, process CPU and set-up by phase, the bytes on the card, 24 bvh4
     launches, a bit-identical repeat, PBRT_TPU_BVH4=0 with 24 bvh2 launches against
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
 15. advanced: pbrt-v3's remaining materials through render.render_file
     (write_advanced_pbrt): the main scene's blob in kdsubsurface, the
     mirror sphere in subsurface "Skin1", the floor in fourier (the
     port's copy of roughgold_alpha_0.2.bsdf), a disney and a hair sphere,
     the wall in matte and the emissive sphere; path at 400x400 @ 4 spp
     (cut from 8), depth 3 (cut from 5), halton, spatial
     distribution: Mrays/s
     (BSSRDF probe rays among the rays), the wall a spp, process CPU and
     set-up by phase (a BSSRDF table and the .bsdf read timed alone), the
     bytes on the card, 4 x 22 bvh4 launches (the camera rays, then a
     bounce's NEE, 4 probe
     segments, the exit point's NEE and the next closest hit), a
     bit-identical repeat, PBRT_TPU_BVH4=0 with as many bvh2 launches
     against bvh4, a 64x64 @ 1 spp copy under path and directlighting
     "all" on the card against the CPU, each side with its own spatial
     distribution, at tests/test_torch_path.py:58-59's bars, and each
     kernel against its plain version bit for bit and bvh2 against bvh4
     on one spp's camera batch, bounce 0's NEE batch, its first probe
     segment and its next-bounce launch; with --profile FILE, one spp
     under torch.profiler, its table written to FILE's name plus
     "_advanced" (ranges "layer: materials / fourier", "/ disney",
     "/ hair", "layer: subsurface / probe walk", "/ sr sampling",
     "/ exit NEE");
 16. imaging: image formation through render.render_file.  Main's file
     with PixelFilter "gaussian" and Sampler "lowdiscrepancy" at 400x400 @
     8 spp, depth 5, spatial distribution: the wall, the wall a spp,
     Mrays/s, process CPU and set-up by phase, 48 bvh4 launches, a
     bit-identical repeat, PBRT_TPU_BVH4=0 with 48 bvh2 launches against
     bvh4; the film's time a call on a 400x400 batch under the box,
     gaussian and sinc filters; PBRT_TPU_EXACT_SAMPLER=1 with halton on the
     same file at 2 spp, twice, bit-identical, with the host seconds of one
     batch's exact table; 64x64 copies on the card against the CPU
     (the gaussian file; orthographic camera, mitchell, stratified; environment, sinc,
     random; realistic with the built-in lens, triangle, maxmin; the exact
     mode under stratified and zerotwosequence; directlighting "all" under
     zerotwosequence with the light's nsamples 3, which rounds to 4); and
     each kernel against its plain version and bvh2 against bvh4 on the
     camera batch of the orthographic, environment and realistic cameras
     at 400x400; with --profile FILE, one spp under torch.profiler, its
     table written to FILE's name plus "_imaging" (range "layer: film");
 17. grad breadth: parallel.diff.render_grad_step on every family the port
     renders, set up from the config3, breadth, advanced and imaging
     (lowdiscrepancy, gaussian) files at 400x400, depth 5, one
     160,000-pixel batch at sample 1: a remat step with its launches
     recorded, a step without remat and the no_grad forward, timed (wall,
     Mrays/s, max_memory_allocated, the step over the forward); L
     bit-equal to the forward, every leaf finite, remat against no remat
     within 1e-4 of each leaf's largest entry, the forward's launches
     without remat and the forward's plus depth x (1, or 6 on advanced)
     replayed ones with it, each replayed launch's inputs bit-equal to its
     forward launch's; a remat step under PBRT_TPU_BVH4=0 against bvh4; a
     64x64 copy of each file at depth 2 on the card against the CPU (1e-3
     of each leaf's largest entry; lanes whose L differs weigh 0), and
     64x64 steps with the orthographic (thin lens), environment and
     realistic (material and light leaves) cameras, card against CPU;
     with --profile FILE, one more remat step of each file under
     torch.profiler (the gathers' backward's share of the device time),
     its table written to FILE's name plus "_grad_<file>";
 18. geometry: pbrt-v3's remaining shapes through render.render_file
     (geometry_phase): write_geometry_pbrt (a 512x512 heightfield, a
     loopsubdiv body of 327,680 triangles, a 16x16 NURBS panel, the six
     quadrics, a "blackbody I" point light, spectrum Kd pairs and an .spd
     file; inside the JAX package's gate: bvh4 and the quadric pass) and
     write_instances_pbrt (16 instances of a 65,536-triangle blob, 256
     instanced quadrics, 4,096 hair curves; past the gate: the typed
     build), each at 400x400 @ 4 spp (cut from 8), depth 5,
     spatial: 24 launches of the
     one build, a bit-identical repeat, the geometry file bit-equal to its
     SceneBuilder scene, a 64x64 depth-2 copy card against CPU, each
     kernel against its plain version on one spp's batches, a remat grad
     step (11 launches, 5 replayed bit for bit), the instances refused
     under PBRT_TPU_BVH4=0; with --profile FILE, one spp of each profiled
     (FILE's name plus "_geometry", "_instances");
 19. transport: Integrator "bdpt", "mlt" and "sppm" through
     render.render_file on main's scene (write_transport_pbrt) at 400x400,
     depth 5, halton: bdpt at 8 spp (31 bvh4 launches a spp, a
     bit-identical repeat, PBRT_TPU_BVH4=0 at the path bars, bvh4 against
     its plain version on one spp's camera-walk, light-walk and connection
     batches and bvh2 on the connection's, a 64x64 copy card against CPU,
     the image against path at tests/test_bdpt.py's bars on the file with
     the sphere in matte); mlt with 65,536 chains, 4
     mutations a pixel and 393,216 bootstrap vectors (a bit-identical
     repeat, a 64x64 depth-2 copy card against CPU with the same draws, the
     image against path at tests/test_mlt_sppm_tools.py's bars); sppm with
     160,000 photons an iteration, 4 iterations (the photons a visible
     point gathers, a bit-identical repeat, a 64x64 copy card against CPU,
     the image against path, each kernel against its plain version on one
     photon batch); with --profile FILE, one bdpt spp, one mlt render at
     1 mutation a pixel and one sppm iteration profiled (FILE's name plus
     "_bdpt", "_mlt", "_sppm");
then a JSON line listing each kernel, and last the JSON result line.  A
failed phase raises, so the script exits non-zero and prints no result.  It
needs the repository beside it and a CUDA card; it does not use JAX.

Phases 10-19 run in the groups of GROUPS, side by side on the one card:
the first in this process after phase 9, each other in a worker process
(`chip_smoke.py --worker`, started after phase 4, its output kept under
build/smoke/ and printed once it ends).  A worker that fails fails the
script; every worker is stopped when the script ends, and dies with it.
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
# phase 10's samples a pixel: BASELINE config 3 asks 64; cut (to 16, then
# 8) to keep the script inside its time as phases were added (each of its
# three renders is host-bound, its wall in proportion)
CONFIG3_SPP = 8
# the samples a pixel of phases 12-15 and 18's renders: cut from 8 to keep
# the script inside its time beside phase 19 (their launches a spp
# are unchanged; phases 10, 12 and 13's 64x64 copies went from 2 spp to 1)
CUT_SPP = 4
# traversal launches a spp at DEPTH: config4 (volpath with media) 1 + 16
# walk segments a bounce but the last, 1 at the last; whitted on the main
# scene (one light) 1 + 1 a bounce but the last, 1 at the last; ao 1 + 64
# phases 12 and 15 render at path depth 3 (cut from 5 at PR 12 to keep the
# script inside its time as phases were added; the walks, the medium
# vertex and the BSSRDF exit still occur at every bounce but the last)
CONFIG4_DEPTH = ADVANCED_DEPTH = 3
CONFIG4_LAUNCHES = CONFIG4_DEPTH * (1 + 16) + 1
WHITTED_LAUNCHES = DEPTH * (1 + 1) + 1
# the advanced scene (subsurface, path): the camera rays, then a bounce but
# the last launches its NEE, PROBE_DEPTH probe segments, its exit point's
# NEE and its next closest hit (pbrt_tpu_torch/integrators/path.py)
PROBE_DEPTH = 4
ADVANCED_LAUNCHES = 1 + ADVANCED_DEPTH * (3 + PROBE_DEPTH)
AO_SAMPLES = 64
# a scene's spatial light distribution (lights/lightdistrib.py)
SPATIAL_FIELDS = ("spatial_grid_res", "spatial_b0", "spatial_diag", "spatial_cdf",
                  "spatial_pmf")

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
                       grid=128, depth=DEPTH) -> Path:
    """BASELINE config 4 on the main scene: the blob (2 nu nv triangles, a
    PLY) in plastic, the matte floor and back wall, the emissive sphere and
    a point light; the mirror sphere's place holds a material-less sphere
    of homogeneous fog (d_media_volpath's coefficients), and beside the
    blob a material-less box holds a heterogeneous medium whose seeded
    grid^3 density (smoke_density) fills it through p0/p1.  volpath at
    `depth`, halton, the spatial distribution."""
    out_dir.mkdir(parents=True, exist_ok=True)
    idx, v = blob_mesh(blob[0], blob[1], seed=0, center=(0.0, 0.0, 2.2),
                       radius=2.0)
    write_ply(out_dir / "blob.ply", idx, v)
    lo, hi = SMOKE_BOX
    corners = [(x, y, z) for z in (lo[2], hi[2])
               for (x, y) in ((lo[0], lo[1]), (hi[0], lo[1]), (hi[0], hi[1]),
                              (lo[0], hi[1]))]
    text = CONFIG4_PBRT.format(
        xres=res[0], yres=res[1], spp=spp, depth=depth, n=grid,
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


ADVANCED_PBRT = """LookAt 0 -8 4  0 0 2  0 0 1
Camera "perspective" "float fov" [45]
Film "image" "integer xresolution" [{xres}] "integer yresolution" [{yres}]
  "string filename" "advanced.pfm"
Sampler "halton" "integer pixelsamples" [{spp}]
Integrator "path" "integer maxdepth" [{depth}]{extra}
WorldBegin
AttributeBegin
  Material "fourier" "string bsdffile" "roughgold_alpha_0.2.bsdf"
  Shape "trianglemesh" "point P" [-10 -10 0  10 -10 0  10 10 0  -10 10 0]
    "integer indices" [0 1 2 2 3 0]
AttributeEnd
AttributeBegin
  Material "matte" "rgb Kd" [0.5 0.5 0.8]
  Shape "trianglemesh" "point P" [-10 6 0  10 6 0  10 6 12  -10 6 12]
    "integer indices" [0 1 2 2 3 0]
AttributeEnd
AttributeBegin
  Material "kdsubsurface" "rgb Kd" [0.8 0.55 0.45] "rgb mfp" [0.05 0.05 0.05]
  Shape "plymesh" "string filename" "blob.ply"
AttributeEnd
AttributeBegin
  Material "subsurface" "string name" "Skin1" "float scale" [40]
  Translate 3.7 -0.5 1.2
  Shape "sphere" "float radius" [1.2]
AttributeEnd
AttributeBegin
  Material "disney" "rgb color" [0.3 0.5 0.8] "float metallic" [0.3]
    "float clearcoat" [0.5] "float sheen" [0.3] "float spectrans" [0.2]
    "float roughness" [0.3]
  Translate 2.2 -3.2 0.8
  Shape "sphere" "float radius" [0.8]
AttributeEnd
AttributeBegin
  Material "hair"
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


def write_advanced_pbrt(out_dir: Path, res=RES, spp=SPP, blob=(512, 256),
                        depth=DEPTH, extra="") -> Path:
    """pbrt-v3's remaining materials on the main scene: the blob (2 nu nv
    triangles, a PLY, radius 2) in kdsubsurface, Kd (0.8, 0.55, 0.45) and a
    mean free path of 0.05, 2.5 % of its radius; the mirror sphere
    (radius 1.2) in subsurface "Skin1": its measured coefficients are per
    mm, and "scale" 40 makes a scene unit 40 mm, so its mean free path of
    0.65-1.3 mm (blue to red) is 0.016-0.032 units, 1.4-2.7 % of the
    radius; the floor in fourier, reading the port's copy of
    roughgold_alpha_0.2.bsdf, copied beside the file; a sphere in disney
    (metallic 0.3, clearcoat 0.5, sheen 0.3, spectrans 0.2: every lobe
    present) and one in hair (the eumelanin default); the wall in matte
    and the emissive sphere.  path at `depth`, halton, the spatial
    distribution; extra: more parameters of the Integrator line."""
    import shutil

    out_dir.mkdir(parents=True, exist_ok=True)
    idx, v = blob_mesh(blob[0], blob[1], seed=0, center=(0.0, 0.0, 2.2),
                       radius=2.0)
    write_ply(out_dir / "blob.ply", idx, v)
    shutil.copyfile(HERE / "pbrt_tpu_torch" / "data" / "roughgold_alpha_0.2.bsdf",
                    out_dir / "roughgold_alpha_0.2.bsdf")
    path = out_dir / "advanced.pbrt"
    path.write_text(ADVANCED_PBRT.format(xres=res[0], yres=res[1], spp=spp,
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


def warp_efficiency(visits, tests, order=None) -> float:
    """How evenly a launch's warps are loaded: the mean over its warps (32
    consecutive entries of the work list, in launch order) of the warp's
    mean lane work over its busiest lane's, a lane's work being its node
    visits plus its record tests (the typed build's tests of every type;
    not its curve windows).  Warps of dead lanes alone are left out.  1 if
    every lane of a warp does as much as the busiest; 1 less it is the
    share of the warps' lane-steps that idle while the busiest lane walks
    on, the single-wave tail's cost inside each warp."""
    import torch

    work = visits.to(torch.float64) + (tests[:, :9].sum(1) if tests.dim() == 2
                                       else tests).to(torch.float64)
    if order is not None:
        work = work[order.to(torch.int64)]
    pad = (-work.shape[0]) % 32
    work = torch.cat([work, work.new_zeros(pad)]).view(-1, 32)
    lanes = torch.full((work.shape[0],), 32.0, dtype=work.dtype, device=work.device)
    lanes[-1] = 32 - pad
    busiest = work.max(1).values
    live = busiest > 0
    if not bool(live.any()):
        return 1.0
    return float((work.sum(1)[live] / lanes[live] / busiest[live]).mean())


def kernel_case(name, k, bvh, scene, o, d, t_max, any_mask, timed: str,
                order=None, both_modes=True):
    """Hold one kernel against its plain version on one ray batch (with and
    without the any-hit mask), bit for bit; returns its measurements.
    timed = "mask" times and counts the launch with the any-hit mask (as
    the main path launches its merged batches), "closest" without it.
    order: the work list the batch was launched with (None = the
    identity).  Where there is one, the kernel is also timed on the rays
    gathered into that order beforehand with no work list (ms_gathered),
    and the four gathers and two scatters such a launch needs around it are
    timed alone (glue_ms): what the work list read inside the kernel costs
    and saves.  both_modes=False holds the kernel against its plain version
    in the timed mode alone (the mode the batch was launched in); the any-
    hit checks then read the kernel's own run of the other mode."""
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
        if key != timed and (not bool(any_mask.any()) or not both_modes):
            continue  # no any-hit lane: both modes are one run
        t0 = time.perf_counter()
        runs[key] = plain(*args, m, return_counts=key == timed, order=order)
        torch.cuda.synchronize()
        if key == timed:
            plain_ms = (time.perf_counter() - t0) * 1e3
    if not both_modes and bool(any_mask.any()):  # the untimed mode's kernel run
        other = "mask" if timed == "closest" else "closest"
        runs[other] = {"closest": (t_k, p_k), "mask": (tm_k, pm_k)}[other]
    for key, other in (("closest", "mask"), ("mask", "closest")):
        runs.setdefault(key, runs[other])
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
    by_type = {}
    if tests.dim() == 2:  # the typed build: tests by record type, windows
        per = [int(x) for x in tests.sum(0).tolist()]
        prim_t = sum(per[:9])
        test_ops = sum(c * f for c, f in zip(per, k["test_flops"]))
        test_bytes = sum(c * b for c, b in zip(per, k["test_bytes"]))
        by_type = {"tests_by_type": per[:9], "curve_windows": per[9]}
    else:
        prim_t = int(tests.sum())
        test_ops, test_bytes = prim_t * TRI_FLOPS, prim_t * bvh.PRIM_BYTES
    # Two floors.  bound_ms: each input read once and each output written
    # once (the node, record and typed tables, 40 B per ray), against the
    # operations this run's visits and tests need.  visit_bound_ms: every
    # node visit and record test read from device memory, as if nothing
    # stayed in L2.
    table_bytes = nodes.nbytes + scene.prim_tris.nbytes + k.get("extra_bytes", 0)
    t_bytes = (table_bytes + n * bvh.RAY_BYTES) / H100_BYTES_PER_S * 1e3
    t_ops = (node_v * k["node_flops"] + test_ops) / H100_F32_FLOPS * 1e3
    visit_bytes = node_v * k["node_bytes"] + test_bytes + n * bvh.RAY_BYTES
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
               visit_bound_ms=visit_bytes / H100_BYTES_PER_S * 1e3,
               warp_eff=warp_efficiency(visits, tests, order), **extra, **by_type)
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
    quad_ms = device_ms.get("layer: traversal / quadric pass", 0.0)
    print(f"{label} traversal split (device ms, 1 spp): kernel {kern_ms:.3f}, key "
          f"and argsort {key_ms:.3f}, quadric pass {quad_ms:.3f}, rest "
          f"{glue - key_ms - quad_ms:.3f}; in all {kern_ms + glue:.3f}", flush=True)


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


def profile_grad(run_step, table_path: Path, label: str = "grad step"):
    """One grad step under torch.profiler: the device's busy time against
    the wall, the share of it in the gathers' backward (the
    indexing_backward kernels of index_put_ with accumulation, and the
    sorts it launches) and the device operations that take the most of it,
    the profiler's table written to table_path."""
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
    gathers = sum(getattr(e, key) for e in on_card
                  if "indexing_backward" in e.key or "RadixSort" in e.key) / 1e3
    print(f"profile {label} (remat, profiler on): wall {wall_ms:.1f} ms, device "
          f"busy {busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.3f}, "
          f"{sum(e.count for e in on_card)} device operations; the gathers' "
          f"backward (indexing_backward and radix-sort kernels) {gathers:.1f} ms, "
          f"{gathers / max(busy_ms, 1e-9):.1%} of the busy time", flush=True)
    top = sorted(on_card, key=lambda e: -getattr(e, key))[:8]
    print(f"profile {label}, top device operations: " + "; ".join(
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


def flat_grads(g) -> dict:
    out = {k: v for k, v in g.items() if k != "camera"}
    out.update({f"camera.{k}": v for k, v in g.get("camera", {}).items()})
    return out


def leaf_rel(a: dict, b: dict) -> float:
    """The largest |a - b| of any leaf over that leaf's largest |b|."""
    return max(float((a[k] - b[k]).abs().max()) / max(float(b[k].abs().max()), 1e-30)
               for k in b)


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
        leaves = flat_grads(g)
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
        rel = leaf_rel(on["leaves"], off["leaves"])
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
          f"{leaf_rel(b2['leaves'], ref['leaves']):.3e} of bvh4's, L max diff "
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


def config3_cross(scene, captured, label="config3"):
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
    print(f"{label} bvh2 against bvh4 on the {len(captured)} batches of the bvh2 "
          f"run: {json.dumps(tot)}", flush=True)
    for row in shown:
        print(f"{label} differing lane: {json.dumps(row)}", flush=True)
    check(tot["hit_flag"] == 0 and tot["t"] == 0 and tot["occlusion"] == 0,
          f"{label}: bvh2 and bvh4 differ other than at ties: {tot}")


def config3_phase(render, counted, card, dev, profile):
    """Phase 10: BASELINE config 3's features through render_file on the
    card: the main scene's 262,144-triangle blob textured, the checkerboard
    floor, smooth and rough glass, the env map; 400x400 @ CONFIG3_SPP spp,
    depth 5,
    halton, spatial light distribution.  A bit-identical repeat, the same
    image under PBRT_TPU_BVH4=0 with bvh2 launches only, and a 64x64 @ 2
    spp copy on the card against the CPU."""
    import torch

    from pbrt_tpu_torch import scene as sc
    from pbrt_tpu_torch.ops import bvh
    from pbrt_tpu_torch.textures.textures import build_pyramid
    from pbrt_tpu_torch.utils.imageio import read_pfm

    out_dir = SMOKE_DIR / "config3"
    spp = CONFIG3_SPP
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

    small = write_config3_pbrt(out_dir / "small", res=(64, 64), spp=1)
    a, _ = render.render_file(str(small), out=str(out_dir / "small_card.pfm"),
                              device=dev)
    t0 = time.perf_counter()
    b, _ = render.render_file(str(small), out=str(out_dir / "small_cpu.pfm"),
                              device="cpu")
    frac, mean_rel = image_bars(b, a)
    print(f"config3 card against cpu (64x64 @ 1 spp): match_frac {frac:.4f}, "
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
    grid, volpath at 400x400 @ CUT_SPP (4) spp, depth CONFIG4_DEPTH (3).
    CONFIG4_LAUNCHES (52) launches a spp; a
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
    path = write_config4_pbrt(out_dir, spp=CUT_SPP, depth=CONFIG4_DEPTH)
    print(f"config4 file: {path.stat().st_size / 1e6:.1f} MB written in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    want = CUT_SPP * CONFIG4_LAUNCHES
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
        print(render_line(f"config4 {RES[0]}x{RES[1]} @ {CUT_SPP} spp, {kind}", st,
                          launches, card)
              + f", wall {wall / CUT_SPP:.4f} s a spp, process CPU of the whole "
              f"call {cpu:.3f} s, image mean {float(img.mean()):.6f}", flush=True)
        runs.append((img, launches))
    check(np.array_equal(runs[0][0], runs[1][0]), "config4: a repeat differs")
    frac, mean_rel = image_bars(runs[0][0], runs[2][0])
    print(f"config4 bvh2 against bvh4: bit-equal "
          f"{np.array_equal(runs[0][0], runs[2][0])}, match_frac {frac:.4f}, "
          f"mean rel {mean_rel:.3e}", flush=True)
    check(frac >= 0.995 and mean_rel <= 5e-3,
          f"config4 bvh2 against bvh4: match_frac {frac}, mean rel {mean_rel}")

    small = write_config4_pbrt(out_dir / "small", res=(64, 64), spp=1,
                               depth=CONFIG4_DEPTH)
    a, _ = render.render_file(str(small), out=str(out_dir / "small_card.pfm"),
                              device=dev)
    t0 = time.perf_counter()
    b, _ = render.render_file(str(small), out=str(out_dir / "small_cpu.pfm"),
                              device="cpu")
    frac, mean_rel = image_bars(b, a)
    print(f"config4 card against cpu (64x64 @ 1 spp): match_frac {frac:.4f}, "
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
    on the main scene through render_file at 400x400 @ CUT_SPP (4) spp:
    finite and
    non-zero, the launches, a bit-identical repeat, and a 64x64 @ 1 spp
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
    text = write_main_pbrt(out_dir).read_text().replace(
        f'"integer pixelsamples" [{SPP}]', f'"integer pixelsamples" [{CUT_SPP}]')
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
            check(launches["bvh4_traverse"] == CUT_SPP * per_spp
                  and launches["bvh2_traverse"] == 0,
                  f"{name}: launches {launches}, not {CUT_SPP * per_spp}")
            print(render_line(f"{name} main {RES[0]}x{RES[1]} @ {CUT_SPP} spp", st,
                              launches, card)
                  + f", wall {st['phases']['Rendering'] / CUT_SPP:.4f} s a spp, "
                  f"image mean {float(img.mean()):.6f}", flush=True)
            imgs.append(img)
        check(np.array_equal(imgs[0], imgs[1]), f"{name}: a repeat differs")
        small = out_dir / f"small_{name}.pbrt"
        small.write_text(p.read_text().replace(
            f'"integer xresolution" [{RES[0]}] "integer yresolution" [{RES[1]}]',
            '"integer xresolution" [64] "integer yresolution" [64]').replace(
            f'"integer pixelsamples" [{CUT_SPP}]', '"integer pixelsamples" [1]'))
        a, _ = render.render_file(str(small), out=str(out_dir / "small_card.pfm"),
                                  device=dev)
        t0 = time.perf_counter()
        b, _ = render.render_file(str(small), out=str(out_dir / "small_cpu.pfm"),
                                  device="cpu")
        frac, mean_rel = image_bars(b, a)
        print(f"{name} card against cpu (64x64 @ 1 spp): match_frac {frac:.4f}, "
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
    400x400 @ CUT_SPP (4) spp, depth 5, halton, spatial distribution: 24
    launches, a
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
    path = write_breadth_pbrt(out_dir, spp=CUT_SPP)
    print(f"breadth file and maps written in {time.perf_counter() - t0:.2f} s",
          flush=True)
    want = CUT_SPP * (1 + DEPTH)
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
        print(render_line(f"breadth {RES[0]}x{RES[1]} @ {CUT_SPP} spp, {kind}", st,
                          launches, card)
              + f", wall {wall / CUT_SPP:.4f} s a spp, process CPU of the whole "
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
    card_scene = lightdistrib.ensure_spatial_light_distribution(
        parse_pbrt_file(str(small)).build_scene(dev))
    t1 = time.perf_counter()
    cpu_scene = lightdistrib.ensure_spatial_light_distribution(
        parse_pbrt_file(str(small)).build_scene("cpu"))
    cpu_build = time.perf_counter() - t1
    errs = {}
    for k in SPATIAL_FIELDS:
        a, b = getattr(card_scene, k).cpu().numpy(), getattr(cpu_scene, k).numpy()
        check(a.shape == b.shape, f"breadth spatial {k}: shape {a.shape} "
              f"on the card, {b.shape} on the CPU")
        errs[k] = float(np.abs(a - b).max())
        check(errs[k] == 0.0 if k in SPATIAL_FIELDS[:3] else errs[k] <= 1e-5,
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
          "material table": sum(v.nbytes for v in (getattr(mt, f.name) for f in
                                                   dataclasses.fields(mt))
                                if isinstance(v, torch.Tensor)),
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


def advanced_phase(render, counted, card, dev, profile):
    """Phase 15: pbrt-v3's remaining materials through render_file on the
    card (write_advanced_pbrt: kdsubsurface, subsurface "Skin1", fourier,
    disney, hair), path at 400x400 @ CUT_SPP (4) spp, depth ADVANCED_DEPTH
    (3),
    halton, spatial distribution: ADVANCED_LAUNCHES a spp, a bit-identical
    repeat,
    PBRT_TPU_BVH4=0 against bvh4; a 64x64 @ 1 spp copy under path and
    directlighting "all" on the card against the CPU (each side builds its
    spatial distribution, held equal first); each kernel against its plain
    version and bvh2 against bvh4 on one spp's camera batch, bounce 0's NEE
    batch, its first probe segment and its separate next-bounce launch."""
    import torch

    from pbrt_tpu_torch.integrators import direct
    from pbrt_tpu_torch.integrators import path as ip
    from pbrt_tpu_torch.lights import lightdistrib
    from pbrt_tpu_torch.materials import bssrdf, fourier
    from pbrt_tpu_torch.ops import bvh
    from pbrt_tpu_torch.samplers.samplers import SamplerConfig
    from pbrt_tpu_torch.scene import BSSRDF_FIELDS
    from pbrt_tpu_torch.sceneio import parse_pbrt_file
    from pbrt_tpu_torch.utils import stats as pstats

    out_dir = SMOKE_DIR / "advanced"
    t0 = time.perf_counter()
    split = {}
    path = write_advanced_pbrt(out_dir, spp=CUT_SPP, depth=ADVANCED_DEPTH)
    t1 = time.perf_counter()
    bssrdf.compute_beam_diffusion_bssrdf(0.0, 1.33)
    t2 = time.perf_counter()
    fourier.read_bsdf(str(out_dir / "roughgold_alpha_0.2.bsdf"))
    print(f"advanced file written in {t1 - t0:.2f} s; set-up timed alone: one "
          f"BSSRDF table (g 0, eta 1.33) {t2 - t1:.3f} s (the file's two "
          f"subsurface materials share it), the .bsdf read "
          f"{time.perf_counter() - t2:.3f} s", flush=True)
    want = CUT_SPP * ADVANCED_LAUNCHES
    runs = []
    for kind, switch in (("bvh4", "1"), ("bvh4", "1"), ("bvh2", "0")):
        c0 = time.process_time()
        img, st, launches = timed_render_file(render, counted, path,
                                              out_dir / f"{kind}.pfm", dev, switch)
        cpu = time.process_time() - c0
        other = "bvh2" if kind == "bvh4" else "bvh4"
        check(launches[f"{kind}_traverse"] == want
              and launches[f"{other}_traverse"] == 0,
              f"advanced ({kind}) launches {launches}, not {want} of {kind}")
        wall = st["phases"]["Rendering"]
        probes = int(np.asarray(st["counters"])[
            pstats.COUNTERS.index("Intersections/BSSRDF probe rays")])
        print(render_line(f"advanced {RES[0]}x{RES[1]} @ {CUT_SPP} spp, {kind}", st,
                          launches, card)
              + f", wall {wall / CUT_SPP:.4f} s a spp, process CPU of the whole "
              f"call {cpu:.3f} s, {probes} BSSRDF probe rays among the rays, "
              f"image mean {float(img.mean()):.6f}", flush=True)
        runs.append((img, launches))
    check(np.array_equal(runs[0][0], runs[1][0]), "advanced: a repeat differs")
    frac, mean_rel = image_bars(runs[0][0], runs[2][0])
    print(f"advanced bvh2 against bvh4: bit-equal "
          f"{np.array_equal(runs[0][0], runs[2][0])}, match_frac {frac:.4f}, "
          f"mean rel {mean_rel:.3e}", flush=True)
    check(frac >= 0.995 and mean_rel <= 5e-3,
          f"advanced bvh2 against bvh4: match_frac {frac}, mean rel {mean_rel}")
    split["renders"] = time.perf_counter() - t0

    # the 64x64 copy under path and directlighting "all", card against CPU,
    # each side with the spatial distribution it builds, held equal first
    t0 = time.perf_counter()
    small = write_advanced_pbrt(out_dir / "small", res=(64, 64), spp=1,
                                depth=ADVANCED_DEPTH)
    line = f'Integrator "path" "integer maxdepth" [{ADVANCED_DEPTH}]'
    card_scene = lightdistrib.ensure_spatial_light_distribution(
        parse_pbrt_file(str(small)).build_scene(dev))
    t1 = time.perf_counter()
    cpu_scene = lightdistrib.ensure_spatial_light_distribution(
        parse_pbrt_file(str(small)).build_scene("cpu"))
    cpu_build = time.perf_counter() - t1
    errs = {}
    for k in SPATIAL_FIELDS:
        a, b = getattr(card_scene, k).cpu().numpy(), getattr(cpu_scene, k).numpy()
        check(a.shape == b.shape, f"advanced spatial {k}: shape {a.shape} on the "
              f"card, {b.shape} on the CPU")
        errs[k] = float(np.abs(a - b).max())
        check(errs[k] == 0.0 if k in SPATIAL_FIELDS[:3] else errs[k] <= 1e-5,
              f"advanced spatial {k}: the card's differs from the CPU's by {errs[k]}")
    print(f"advanced spatial distribution, card against cpu: max abs differences "
          f"{json.dumps(errs)}; the CPU build {cpu_build:.2f} s", flush=True)
    del card_scene
    for name, integ, renderer in (
            ("path", line, ip.render),
            ("directlighting", f'Integrator "directlighting" "integer maxdepth" '
                               f'[{ADVANCED_DEPTH}] "string strategy" "all"',
             direct.render)):
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
        print(f"advanced {name} card against cpu (64x64 @ 1 spp): match_frac "
              f"{frac:.4f}, mean rel {mean_rel:.3e}; the CPU "
              f"{time.perf_counter() - t1:.2f} s", flush=True)
        check(a.shape == (64, 64, 3) and bool(np.isfinite(a).all())
              and float(a.mean()) > 0 and frac >= 0.995 and mean_rel <= 5e-3,
              f"advanced {name} card against cpu: match_frac {frac}, "
              f"mean rel {mean_rel}")
    del cpu_scene
    split["64x64 copies"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    setup = parse_pbrt_file(str(path))
    scene = lightdistrib.ensure_spatial_light_distribution(setup.build_scene(dev))
    mb = {"bvh4 nodes + triangles": scene.bvh4_nodes.nbytes + scene.prim_tris.nbytes,
          "bvh2 nodes + triangles": scene.bvh2_nodes.nbytes + scene.prim_tris.nbytes,
          "Fourier table": sum(t.nbytes for t in scene.materials.fourier),
          "BSSRDF tables": sum(getattr(scene, k).nbytes for k in BSSRDF_FIELDS),
          "spatial distribution": scene.spatial_cdf.nbytes + scene.spatial_pmf.nbytes}
    print("advanced bytes on the card, MB: " + json.dumps(
        {k: round(v / 1e6, 4) for k, v in mb.items()}), flush=True)
    film_cfg, filt = setup.make_film_config()
    camera = setup.make_camera()
    cfg = setup.make_integrator_config()
    one = SamplerConfig("halton", 1, RES)
    if profile is not None:
        profile_render(lambda: ip.render(scene, camera, film_cfg, one, cfg, filt,
                                         device=dev),
                       profile.with_name(f"{profile.stem}_advanced{profile.suffix}"),
                       "advanced profile")
    kernels = bvh_kernels(bvh)
    split["set-up, bytes, profile"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with bvh.record_calls() as captured:
        ip.render(scene, camera, film_cfg, one, cfg, filt, device=dev)
    check(len(captured) == ADVANCED_LAUNCHES,
          f"advanced: one spp launched {len(captured)} times, not "
          f"{ADVANCED_LAUNCHES}")
    results = {kind: {} for kind in kernels}
    # one spp's launches: the camera rays, then a bounce's NEE, its probe
    # segments, its exit point's NEE and its next closest hit
    for label, i in (("camera", 0), ("nee-b0", 1), ("probe1-b0", 2),
                     ("next-b0", 3 + PROBE_DEPTH)):
        oc, dc, tc, mc, order = captured[i]
        print(f"batch advanced-{label}: {tc.shape[0]} lanes, {int((tc > 0).sum())} "
              f"live, {int((mc > 0).sum())} any-hit", flush=True)
        for kind, k in kernels.items():
            results[kind][label] = kernel_case(f"{kind}-advanced-{label}", k, bvh,
                                               scene, oc, dc, tc, mc > 0, "mask",
                                               order)
        cross_check(f"advanced-{label}", kernels, scene, oc, dc, tc, mc > 0, order)
    del captured, scene
    torch.cuda.empty_cache()
    split["kernel checks"] = time.perf_counter() - t0
    print("advanced phase split, s: " + json.dumps(
        {k: round(v, 2) for k, v in split.items()}), flush=True)
    return {"bvh4": runs[0][1]["bvh4_traverse"], "bvh2": runs[2][1]["bvh2_traverse"],
            "results": results}


def icosphere(levels: int):
    """(indices, unit vertices) of an icosahedron split `levels` times:
    20 * 4^levels faces, closed and consistently wound."""
    t = (1 + 5 ** 0.5) / 2
    v = [(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0), (0, -1, t), (0, 1, t),
         (0, -1, -t), (0, 1, -t), (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1)]
    v = [np.asarray(x, np.float64) / np.linalg.norm(x) for x in v]
    f = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11), (1, 5, 9),
         (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8), (3, 9, 4), (3, 4, 2),
         (3, 2, 6), (3, 6, 8), (3, 8, 9), (4, 9, 5), (2, 4, 11), (6, 2, 10),
         (8, 6, 7), (9, 8, 1)]
    for _ in range(levels):
        mids, out = {}, []

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in mids:
                m = v[a] + v[b]
                v.append(m / np.linalg.norm(m))
                mids[key] = len(v) - 1
            return mids[key]

        for a, b, c in f:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            out += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        f = out
    return np.asarray(f, np.int32), np.asarray(v, np.float64)


# phase 18's quadrics: (shape, parameters, transform, reversed); the disk
# is small: its hits carry no error bound (disk.cpp), so its shadow rays'
# self-intersection flips with the last bit of the hit point
GEOMETRY_QUADRICS = [
    ("disk", '"float radius" [0.35] "float innerradius" [0.15] "float phimax" [300]',
     "Translate -3.2 -3.0 0.9 Rotate 50 1 0 0", False),
    ("cylinder", '"float radius" [0.45] "float zmin" [-0.6] "float zmax" [0.7]',
     "Translate 3.2 -1.2 1.4 Rotate 25 1 0 0", False),
    ("cone", '"float radius" [0.6] "float height" [1.3] "float phimax" [320]',
     "Translate -4.2 0.8 0.4", True),
    ("paraboloid", '"float radius" [0.55] "float zmin" [0.05] "float zmax" [1.1]',
     "Translate 4.3 1.2 0.5", False),
    ("hyperboloid", '"point p1" [0.3 0 -0.6] "point p2" [0.65 0.25 0.7] '
                    '"float phimax" [340]', "Translate 2.4 -3.2 1.2", True),
    ("sphere", '"float radius" [0.7] "float phimax" [270]',
     "Translate -2.2 -2.4 2.2 Rotate 30 0 0 1", False),
]

GEOMETRY_PBRT = """LookAt 0 -8 4  0 0 2  0 0 1
Camera "perspective" "float fov" [45]
Film "image" "integer xresolution" [{xres}] "integer yresolution" [{yres}]
  "string filename" "geometry.pfm"
Sampler "halton" "integer pixelsamples" [{spp}]
Integrator "path" "integer maxdepth" [{depth}]
WorldBegin
LightSource "point" "blackbody I" [6500 1] "rgb scale" [60 60 60]
  "point from" [-3 -4 7]
AttributeBegin
  Translate 0 5 8
  AreaLightSource "diffuse" "rgb L" [20 20 20]
  Shape "sphere" "float radius" [0.5]
AttributeEnd
AttributeBegin
  Material "matte" "spectrum Kd" [400 0.25 480 0.45 560 0.6 640 0.35 700 0.3]
  Translate -10 -8 -0.6
  Scale 20 18 1.2
  Shape "heightfield" "integer nu" [{hf}] "integer nv" [{hf}] "float Pz" [{pz}]
AttributeEnd
AttributeBegin
  Material "plastic" "spectrum Kd" "kd.spd" "rgb Ks" [0.4 0.4 0.4]
    "float roughness" [0.05]
  Shape "loopsubdiv" "integer levels" [{levels}] "integer indices" [{li}]
    "point P" [{lp}]
AttributeEnd
AttributeBegin
  Material "substrate" "rgb Kd" [0.3 0.35 0.5] "rgb Ks" [0.2 0.2 0.2]
  Translate -5 4.5 0.2
  Scale 10 1 6
  Shape "nurbs" "integer nu" [16] "integer nv" [16] "integer uorder" [4]
    "integer vorder" [4] "float uknots" [{knots}] "float vknots" [{knots}]
    "point P" [{np}]
AttributeEnd
AttributeBegin
  Material "metal" "float roughness" [0.08]
{quadrics}
AttributeEnd
WorldEnd
"""


def _floats(a) -> str:
    return " ".join(f"{x:.7g}" for x in np.asarray(a).ravel())


def geometry_parts(hf: int = 512, levels: int = 4):
    """Phase 18's seeded geometry: the heightfield's heights [hf * hf], the
    coarse closed mesh of the loop body (1,280 faces: an icosphere split 3
    times, radius 1.8 at (0, 0, 2.2), seeded bumps), the 16 x 16 NURBS
    control net (a seeded wave), its clamped uniform knots."""
    rs = np.random.RandomState(18)
    x, y = np.meshgrid(np.linspace(0, 1, hf), np.linspace(0, 1, hf))
    pz = 0.3 * np.sin(6.0 * x + 1.0) * np.cos(5.0 * y) + 0.15 * rs.rand(hf, hf)
    idx, v = icosphere(3)
    r = 1.8 * (1.0 + 0.08 * rs.randn(v.shape[0]).clip(-2, 2))
    lp = v * r[:, None] + np.array([0.0, 0.0, 2.2])
    u, w = np.meshgrid(np.linspace(0, 1, 16), np.linspace(0, 1, 16))
    npts = np.stack([u, np.zeros_like(u) + 0.3 * np.sin(7 * u) * np.cos(5 * w)
                     + 0.1 * rs.rand(16, 16), w], -1)
    knots = np.concatenate([[0.0] * 4, np.linspace(0, 1, 14)[1:-1], [1.0] * 4])
    return dict(pz=pz.astype(np.float32), li=idx, lp=lp.astype(np.float32),
                np=npts.astype(np.float32), knots=knots, levels=levels, hf=hf)


def write_geometry_pbrt(out_dir: Path, res=RES, spp=SPP, depth=DEPTH, hf=512,
                        levels=4) -> Path:
    """Phase 18's first file, inside the JAX package's gate: a hf x hf
    heightfield terrain (2 (hf-1)^2 triangles), a loopsubdiv body (1,280
    faces at `levels`: 327,680 triangles at 4), a 16 x 16 NURBS panel, one
    each of the disk (inner radius), cylinder, cone, paraboloid, hyperboloid
    and a sphere with phimax 270 (two of them reversed), matte, plastic,
    substrate and metal; a point light given as "blackbody I" and the
    emissive sphere; one Kd as inline spectrum pairs, one from an .spd file
    written beside the scene.  path at `depth`, halton, spatial."""
    out_dir.mkdir(parents=True, exist_ok=True)
    g = geometry_parts(hf, levels)
    (out_dir / "kd.spd").write_text(
        "# seeded reflectance\n" + "\n".join(
            f"{lam:.1f} {val:.5f}" for lam, val in zip(
                np.linspace(380, 720, 18),
                0.2 + 0.5 * np.random.RandomState(19).rand(18))) + "\n")
    quads = "\n".join(
        f"  AttributeBegin\n    {xf}\n" + ("    ReverseOrientation\n" if rev else "")
        + f'    Shape "{name}" {params}\n  AttributeEnd'
        for name, params, xf, rev in GEOMETRY_QUADRICS)
    path = out_dir / "geometry.pbrt"
    path.write_text(GEOMETRY_PBRT.format(
        xres=res[0], yres=res[1], spp=spp, depth=depth, hf=hf,
        pz=_floats(g["pz"]), levels=levels, li=_floats(g["li"]),
        lp=_floats(g["lp"]), knots=_floats(g["knots"]), np=_floats(g["np"]),
        quadrics=quads))
    return path


def _text_floats(a) -> np.ndarray:
    """a as the scene file holds it (_floats) and its reader reads it back:
    float() of each token, then float32."""
    return np.asarray([float(x) for x in _floats(a).split()], np.float32)


def _transform(tf, statements: str):
    """The CTM of a line of Translate / Rotate / Scale statements."""
    toks = statements.split()
    m = tf.identity()
    i = 0
    while i < len(toks):
        n = {"Translate": 3, "Rotate": 4, "Scale": 3}[toks[i]]
        args = [float(x) for x in toks[i + 1:i + 1 + n]]
        m = m @ getattr(tf, toks[i].lower())(*args)
        i += 1 + n
    return m


def geometry_builder(path: Path):
    """The scene of write_geometry_pbrt's file made with SceneBuilder calls,
    as its reader makes it: the reader's default material first, then a
    row for each Material statement, the lights and shapes in the file's
    order, the mesh shapes through shapes/ and heightfield_mesh, the
    spectra through core/sampled_spectrum.py."""
    from pbrt_tpu_torch import scene as sc
    from pbrt_tpu_torch.core import sampled_spectrum as ss
    from pbrt_tpu_torch.core import transform as tf
    from pbrt_tpu_torch.sceneio.api import heightfield_mesh
    from pbrt_tpu_torch.shapes.loopsubdiv import loop_subdivide
    from pbrt_tpu_torch.shapes.nurbs import tessellate_nurbs

    text = path.read_text()
    hf = int(text.split('"integer nu" [')[1].split("]")[0])
    levels = int(text.split('"integer levels" [')[1].split("]")[0])
    g = geometry_parts(hf, levels)
    b = sc.SceneBuilder()
    f32 = np.float32
    b.add_material(sc.MAT_MATTE, kd=np.full(3, 0.5, f32))  # the default
    b.add_point_light(tf.identity() @ tf.translate(-3.0, -4.0, 7.0),
                      ss.blackbody_rgb_normalized(6500.0) * 1.0
                      * np.full(3, 60.0, f32))
    b.add_emissive_sphere(tf.identity() @ tf.translate(0.0, 5.0, 8.0), 0.5,
                          np.full(3, 20.0, f32) * np.ones(3, f32), material=0)
    kd = ss.spd_to_rgb(np.array([400, 480, 560, 640, 700], np.float64),
                       np.array([0.25, 0.45, 0.6, 0.35, 0.3]))
    m = b.add_material(sc.MAT_MATTE, kd=kd, sigma=0.0)
    idx, p, uv = heightfield_mesh(hf, hf, _text_floats(g["pz"]))
    b.add_triangle_mesh(idx, p, uv=uv, material=m, object_to_world=_transform(
        tf, "Translate -10 -8 -0.6 Scale 20 18 1.2"))
    lam, val = ss.read_spd_file(str(path.parent / "kd.spd"))
    m = b.add_material(sc.MAT_PLASTIC, kd=ss.spd_to_rgb(lam, val),
                       ks=np.full(3, 0.4, f32), roughness=0.05, remap_roughness=True)
    idx, p, n = loop_subdivide(_text_floats(g["li"]).astype(np.int64).astype(np.int32),
                               _text_floats(g["lp"]).reshape(-1, 3), levels)
    b.add_triangle_mesh(idx, p, n=n, object_to_world=tf.identity(), material=m)
    m = b.add_material(sc.MAT_SUBSTRATE, kd=np.array([0.3, 0.35, 0.5], f32),
                       ks=np.full(3, 0.2, f32), urough=0.1, vrough=0.1,
                       remap_roughness=True)
    knots = _text_floats(g["knots"])
    pw = np.concatenate([_text_floats(g["np"]).reshape(16, 16, 3),
                         np.ones((16, 16, 1), f32)], -1)
    idx, p, uv = tessellate_nurbs(16, 16, 4, 4, knots, knots, pw)
    b.add_triangle_mesh(idx, p, uv=uv, material=m, object_to_world=_transform(
        tf, "Translate -5 4.5 0.2 Scale 10 1 6"))
    cu_eta, cu_k = ss.copper_eta_k_rgb()
    m = b.add_material(sc.MAT_METAL, metal_eta=np.asarray(tuple(cu_eta), f32),
                       metal_k=np.asarray(tuple(cu_k), f32), roughness=0.08,
                       remap_roughness=True)
    for name, params, xf, rev in GEOMETRY_QUADRICS:
        o2w = _transform(tf, xf)
        vals = {}
        for decl, v in zip(params.split('"')[1::2], params.split("[")[1:]):
            vals[decl.split()[1]] = [float(x) for x in v.split("]")[0].split()]
        one = {k: v[0] for k, v in vals.items()}
        if name == "disk":
            b.add_quadric(sc.SHAPE_DISK, o2w, (one["radius"], one["innerradius"],
                                               0.0, np.deg2rad(one["phimax"])),
                          m, -1, rev)
        elif name == "cylinder":
            b.add_quadric(sc.SHAPE_CYLINDER, o2w, (one["radius"], one["zmin"],
                                                   one["zmax"], np.deg2rad(360.0)),
                          m, -1, rev)
        elif name == "cone":
            b.add_cone(o2w, one["radius"], one["height"], material=m,
                       phimax_deg=one["phimax"], reverse_orientation=rev)
        elif name == "paraboloid":
            b.add_paraboloid(o2w, one["radius"], one["zmin"], one["zmax"],
                             material=m, phimax_deg=360.0, reverse_orientation=rev)
        elif name == "hyperboloid":
            b.add_hyperboloid(o2w, np.asarray(vals["p1"], f32),
                              np.asarray(vals["p2"], f32), material=m,
                              phimax_deg=one["phimax"], reverse_orientation=rev)
        else:
            r = one["radius"]
            b.add_sphere(o2w, r, material=m, zmin=-r, zmax=r,
                         phimax_deg=one["phimax"], reverse_orientation=rev)
    return b


INSTANCES_PBRT = """LookAt 0 -8 4  0 0 2  0 0 1
Camera "perspective" "float fov" [45]
Film "image" "integer xresolution" [{xres}] "integer yresolution" [{yres}]
  "string filename" "instances.pfm"
Sampler "halton" "integer pixelsamples" [{spp}]
Integrator "path" "integer maxdepth" [{depth}]
WorldBegin
LightSource "point" "blackbody I" [5000 1] "rgb scale" [50 50 50]
  "point from" [3 -5 7]
AttributeBegin
  Translate 0 5 8
  AreaLightSource "diffuse" "rgb L" [20 20 20]
  Shape "sphere" "float radius" [0.5]
AttributeEnd
Material "matte" "rgb Kd" [0.5 0.5 0.8]
Shape "trianglemesh" "point P" [-10 -10 0  10 -10 0  10 10 0  -10 10 0]
  "integer indices" [0 1 2 2 3 0]
ObjectBegin "blob"
  Material "plastic" "rgb Kd" [0.4 0.2 0.2] "rgb Ks" [0.5 0.5 0.5]
    "float roughness" [0.025]
  Shape "plymesh" "string filename" "blob.ply"
ObjectEnd
ObjectBegin "quadrics"
  Material "metal" "float roughness" [0.05]
{quadrics}
ObjectEnd
{instances}
AttributeBegin
  Material "hair"
{curves}
AttributeEnd
WorldEnd
"""

# phase 18's quadric object: 8 quadrics, instanced 32 times
INSTANCE_QUADRICS = [
    ("sphere", '"float radius" [0.12]', "Translate 0 0 0.12"),
    ("cylinder", '"float radius" [0.06] "float zmin" [0] "float zmax" [0.3]',
     "Translate 0.3 0 0"),
    ("disk", '"float radius" [0.12] "float innerradius" [0.04]',
     "Translate -0.3 0 0.02"),
    ("cone", '"float radius" [0.1] "float height" [0.25]', "Translate 0 0.3 0"),
    ("paraboloid", '"float radius" [0.1] "float zmin" [0] "float zmax" [0.2]',
     "Translate 0 -0.3 0"),
    ("hyperboloid", '"point p1" [0.06 0 0] "point p2" [0.1 0.04 0.25]',
     "Translate 0.3 0.3 0"),
    ("sphere", '"float radius" [0.08] "float phimax" [200]',
     "Translate -0.3 -0.3 0.1"),
    ("cone", '"float radius" [0.08] "float height" [0.2] "float phimax" [270]',
     "Translate -0.3 0.3 0"),
]


def write_instances_pbrt(out_dir: Path, res=RES, spp=SPP, depth=DEPTH,
                         blob=(256, 128), n_blobs=16, n_quads=32,
                         n_curves=4096) -> Path:
    """Phase 18's second file, past the JAX package's gate: n_blobs
    ObjectInstances of a seeded blob (2 nu nv triangles, a PLY inside the
    object; 16 x 65,536 = 1,048,576 instanced triangles), n_quads instances
    of an object of 8 quadrics of all six types (256 quadrics), and a hair
    patch of n_curves cubic curves, flat, ribbon (two normals) and
    cylinder in turn, chains of 1-3 segments, splitdepth 2, under the hair
    material; the point light given as "blackbody I" and the emissive
    sphere.  path at `depth`, halton, spatial."""
    out_dir.mkdir(parents=True, exist_ok=True)
    idx, v = blob_mesh(blob[0], blob[1], seed=3, center=(0.0, 0.0, 0.0),
                       radius=0.55)
    write_ply(out_dir / "blob.ply", idx, v)
    rs = np.random.RandomState(20)
    side = int(np.ceil(np.sqrt(n_blobs)))
    inst = []
    for k in range(n_blobs):
        x, y = -4.2 + 8.4 * (k % side) / max(side - 1, 1), -1.0 + 4.0 * (k // side) / max(side - 1, 1)
        inst.append(f"AttributeBegin\n  Translate {x:.4f} {y:.4f} 0.6\n"
                    f"  Rotate {rs.uniform(0, 360):.3f} 0 0 1\n"
                    f"  Scale {rs.uniform(0.8, 1.2):.4f} {rs.uniform(0.8, 1.2):.4f} "
                    f"{rs.uniform(0.8, 1.2):.4f}\n  ObjectInstance \"blob\"\nAttributeEnd")
    for k in range(n_quads):
        inst.append(f"AttributeBegin\n  Translate {rs.uniform(-5, 5):.4f} "
                    f"{rs.uniform(-3.5, -1.6):.4f} 0\n  Rotate "
                    f"{rs.uniform(0, 360):.3f} 0 0 1\n  ObjectInstance \"quadrics\"\n"
                    "AttributeEnd")
    quads = "\n".join(f"  AttributeBegin\n    {xf}\n    Shape \"{name}\" {params}\n"
                      "  AttributeEnd" for name, params, xf in INSTANCE_QUADRICS)
    curves = []
    kinds = ("flat", "ribbon", "cylinder")
    for k in range(n_curves):
        n_seg = 1 + k % 3
        base = np.array([rs.uniform(-2.5, 2.5), rs.uniform(-4.8, -3.2), 0.0])
        steps = np.cumsum(rs.normal(0, 0.05, (3 * n_seg, 3))
                          + np.array([0.0, 0.0, 0.6 / (3 * n_seg)]), 0)
        pts = np.concatenate([base[None], base + steps])
        kind = kinds[k % 3]
        extra = ""
        if kind == "ribbon":
            nrm = rs.normal(0, 1, (2, 3)) + np.array([0.0, -1.0, 0.0])
            extra = f' "normal N" [{_floats(nrm)}]'
        curves.append(f'  Shape "curve" "point P" [{_floats(pts)}] "string type" '
                      f'"{kind}" "float width0" [0.02] "float width1" [0.004] '
                      f'"integer splitdepth" [2]{extra}')
    path = out_dir / "instances.pbrt"
    path.write_text(INSTANCES_PBRT.format(
        xres=res[0], yres=res[1], spp=spp, depth=depth, quadrics=quads,
        instances="\n".join(inst), curves="\n".join(curves)))
    return path


MAIN_CAMERA = 'Camera "perspective" "float fov" [45]'
MAIN_SAMPLER = f'Sampler "halton" "integer pixelsamples" [{SPP}]'
MAIN_CAMERA = 'Camera "perspective" "float fov" [45]'
MAIN_SAMPLER = f'Sampler "halton" "integer pixelsamples" [{SPP}]'
# phase 16's 64x64 copies, card against CPU: (label, camera, filter,
# sampler, integrator or None for the main file's, the exact mode)
IMAGING_COPIES = [
    ("gaussian, lowdiscrepancy (the full-width file)", MAIN_CAMERA,
     'PixelFilter "gaussian"', 'Sampler "lowdiscrepancy" "integer pixelsamples" [4]',
     None, False),
    ("orthographic, mitchell, stratified",
     'Camera "orthographic"', 'PixelFilter "mitchell"', 'Sampler "stratified" "integer pixelsamples" [4]',
     None, False),
    ("environment, sinc, random", 'Camera "environment"', 'PixelFilter "sinc"',
     'Sampler "random" "integer pixelsamples" [2]', None, False),
    ("realistic (built-in lens), triangle, maxmin",
     'Camera "realistic" "float focusdistance" [8.5]', 'PixelFilter "triangle"',
     'Sampler "maxmin" "integer pixelsamples" [2]', None, False),
    ("exact stratified", MAIN_CAMERA, "",
     'Sampler "stratified" "integer pixelsamples" [4]', None, True),
    ("exact zerotwosequence", MAIN_CAMERA, "",
     'Sampler "zerotwosequence" "integer pixelsamples" [2]', None, True),
    ("directlighting all, zerotwosequence, nsamples 3", MAIN_CAMERA, "",
     'Sampler "zerotwosequence" "integer pixelsamples" [2]',
     f'Integrator "directlighting" "integer maxdepth" [{DEPTH}] '
     '"string strategy" "all"', False),
]
# the camera batches phase 16 holds each kernel against its plain version on
IMAGING_CAMERAS = {
    "orthographic": 'Camera "orthographic"',
    "environment": 'Camera "environment"',
    "realistic": 'Camera "realistic" "float focusdistance" [8.5]',
}


@contextlib.contextmanager
def exact_sampler(on: bool):
    """PBRT_TPU_EXACT_SAMPLER=1 within the block when on."""
    old = os.environ.get("PBRT_TPU_EXACT_SAMPLER")
    if on:
        os.environ["PBRT_TPU_EXACT_SAMPLER"] = "1"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("PBRT_TPU_EXACT_SAMPLER", None)
        else:
            os.environ["PBRT_TPU_EXACT_SAMPLER"] = old


def imaging_file(main: Path, name: str, camera=MAIN_CAMERA, filt="",
                 sampler=MAIN_SAMPLER, integrator=None, res=None,
                 light_samples=None) -> Path:
    """A copy of the main file beside it (it shares blob.ply) with its
    camera, filter, sampler, integrator, resolution or its light's sample
    count swapped."""
    text = main.read_text()
    for old in (MAIN_CAMERA, MAIN_SAMPLER):
        check(old in text, f"the main file has no {old!r}")
    text = text.replace(MAIN_CAMERA, camera + ("\n" + filt if filt else ""))
    text = text.replace(MAIN_SAMPLER, sampler)
    if integrator:
        text = text.replace(f'Integrator "path" "integer maxdepth" [{DEPTH}]',
                            integrator)
    if res:
        text = text.replace(f'"integer xresolution" [{RES[0]}] "integer '
                            f'yresolution" [{RES[1]}]', f'"integer xresolution" '
                            f'[{res[0]}] "integer yresolution" [{res[1]}]')
    if light_samples:
        text = text.replace('AreaLightSource "diffuse" "rgb L" [40 40 40]',
                            'AreaLightSource "diffuse" "rgb L" [40 40 40] '
                            f'"integer nsamples" [{light_samples}]')
    path = main.with_name(f"{name}.pbrt")
    path.write_text(text)
    return path


def film_times(dev) -> dict:
    """add_samples on one sample per pixel of a 400x400 batch (the main
    path's film call) under the box, gaussian and sinc filters: ms a call
    (CUDA events around 10 calls; add_samples waits on the card twice a
    call, so the host's part between its launches counts) and the
    footprint's cells a sample."""
    import torch

    from pbrt_tpu_torch import film
    from pbrt_tpu_torch.filters import make_filter

    g = torch.Generator(device=dev).manual_seed(16)
    ys, xs = torch.meshgrid(torch.arange(RES[1], device=dev),
                            torch.arange(RES[0], device=dev), indexing="ij")
    pix = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1).to(torch.float32)
    p_film = pix + torch.rand(pix.shape, generator=g, device=dev)
    L = torch.rand((pix.shape[0], 3), generator=g, device=dev)
    out = {}
    for name in ("box", "gaussian", "sinc"):
        filt = make_filter(name)
        cfg = film.FilmConfig(full_resolution=RES, filter_radius=filt.radius)
        state = film.make_film_state(cfg, filt, dev)
        ms = time_cuda(lambda: film.add_samples(state, p_film, L), 10)
        out[name] = {"ms": round(ms, 4), "footprint_cells": state.footprint ** 2}
    return out


def imaging_phase(render, counted, card, dev, profile):
    """Phase 16: image formation on the card.  The main file with a
    gaussian filter and the lowdiscrepancy sampler through render_file, at
    400x400 @ 8 spp, depth 5, spatial distribution: (1 + DEPTH) launches a
    spp, a bit-identical repeat, PBRT_TPU_BVH4=0 against bvh4; the exact
    mode (halton) on the same file at 400x400 @ 2 spp, repeated bit for bit,
    with the host seconds of one batch's table; 64x64 copies (that file;
    orthographic,
    environment and realistic cameras, mitchell, sinc and triangle filters,
    stratified, random and maxmin samplers, the exact mode under stratified
    and zerotwosequence, directlighting "all" under zerotwosequence with a
    light of nsamples 3) on the card against the CPU, the CPU rendering its
    own scene; the film's device time under three filters; each kernel
    against its plain version and bvh2 against bvh4 on the camera batch of
    each new camera at 400x400."""
    import torch

    from pbrt_tpu_torch import film
    from pbrt_tpu_torch.integrators import direct
    from pbrt_tpu_torch.integrators import path as ip
    from pbrt_tpu_torch.lights import lightdistrib
    from pbrt_tpu_torch.ops import bvh
    from pbrt_tpu_torch.samplers import exact_tables
    from pbrt_tpu_torch.samplers.samplers import SamplerConfig
    from pbrt_tpu_torch.sceneio import parse_pbrt_file

    out_dir = SMOKE_DIR / "imaging"
    t0 = time.perf_counter()
    split = {}
    main = write_main_pbrt(out_dir)
    gauss = imaging_file(main, "gaussian", filt='PixelFilter "gaussian"',
                         sampler=f'Sampler "lowdiscrepancy" "integer pixelsamples" [{SPP}]')
    want = SPP * (1 + DEPTH)
    runs = []
    for kind, switch in (("bvh4", "1"), ("bvh4", "1"), ("bvh2", "0")):
        c0 = time.process_time()
        img, st, launches = timed_render_file(render, counted, gauss,
                                              out_dir / f"{kind}.pfm", dev, switch)
        cpu = time.process_time() - c0
        other = "bvh2" if kind == "bvh4" else "bvh4"
        check(launches[f"{kind}_traverse"] == want
              and launches[f"{other}_traverse"] == 0,
              f"imaging ({kind}) launches {launches}, not {want} of {kind}")
        wall = st["phases"]["Rendering"]
        print(render_line(f"imaging {RES[0]}x{RES[1]} @ {SPP} spp, gaussian, "
                          f"lowdiscrepancy, {kind}", st, launches, card)
              + f", wall {wall / SPP:.4f} s a spp, "
              f"{launches[f'{kind}_traverse'] / SPP:.0f} launches a spp, process "
              f"CPU of the whole call {cpu:.3f} s, image mean "
              f"{float(img.mean()):.6f}", flush=True)
        runs.append((img, launches))
    check(np.array_equal(runs[0][0], runs[1][0]), "imaging: a repeat differs")
    frac, mean_rel = image_bars(runs[0][0], runs[2][0])
    print(f"imaging bvh2 against bvh4: bit-equal "
          f"{np.array_equal(runs[0][0], runs[2][0])}, match_frac {frac:.4f}, "
          f"mean rel {mean_rel:.3e}", flush=True)
    check(frac >= 0.995 and mean_rel <= 5e-3,
          f"imaging bvh2 against bvh4: match_frac {frac}, mean rel {mean_rel}")
    print("imaging film, device ms of one add_samples of a 400x400 batch: "
          + json.dumps(film_times(dev)) + f" [{card}]", flush=True)
    split["gaussian renders"] = time.perf_counter() - t0

    # the exact mode, halton, on the same file at 2 spp
    t0 = time.perf_counter()
    exact = imaging_file(main, "exact", filt='PixelFilter "gaussian"',
                         sampler='Sampler "halton" "integer pixelsamples" [2]')
    imgs = []
    with exact_sampler(True):
        cfg = parse_pbrt_file(str(exact)).make_sampler_config()
        check(cfg.exact, "PBRT_TPU_EXACT_SAMPLER=1 did not turn the exact mode on")
        for i in range(2):
            img, st, launches = timed_render_file(render, counted, exact,
                                                  out_dir / f"exact{i}.pfm", dev)
            check(launches["bvh4_traverse"] == 2 * (1 + DEPTH),
                  f"imaging exact: launches {launches}")
            print(render_line(f"imaging exact halton {RES[0]}x{RES[1]} @ 2 spp, "
                              "gaussian", st, launches, card), flush=True)
            imgs.append(img)
    check(np.array_equal(imgs[0], imgs[1]), "imaging exact: a repeat differs")
    pix = ip.make_pixel_grid(film.FilmConfig(full_resolution=RES))
    n_dims = ip.n_path_dims(ip.PathConfig(max_depth=DEPTH))
    t1 = time.perf_counter()
    exact_tables.halton_exact_table(cfg, pix, 1, n_dims)
    print(f"imaging exact: repeat bit-identical; one batch's halton table "
          f"({RES[0] * RES[1]} lanes x {n_dims} dims) "
          f"{time.perf_counter() - t1:.3f} s on the host", flush=True)
    split["exact renders"] = time.perf_counter() - t0

    # the 64x64 copies, card against CPU; the CPU side renders its own
    # build of the scene, its spatial distribution built once
    t0 = time.perf_counter()
    cpu_scene = None
    for i, (label, camera, filt, sampler, integ, ex) in enumerate(IMAGING_COPIES):
        p = imaging_file(main, f"small{i}", camera, filt, sampler, integ,
                         res=(64, 64), light_samples=3 if integ else None)
        with exact_sampler(ex):
            a, _ = render.render_file(str(p), out=str(out_dir / f"small{i}.pfm"),
                                      device=dev)
            t1 = time.perf_counter()
            setup = parse_pbrt_file(str(p))
            film_cfg, filt_obj = setup.make_film_config()
            if integ:  # its light's nsamples differs: a scene of its own
                scene, renderer = setup.build_scene("cpu"), direct.render
            else:
                if cpu_scene is None:
                    cpu_scene = lightdistrib.ensure_spatial_light_distribution(
                        setup.build_scene("cpu"))
                scene, renderer = cpu_scene, ip.render
            b = renderer(scene, setup.make_camera(), film_cfg,
                         setup.make_sampler_config(), setup.make_integrator_config(),
                         filt_obj, device="cpu").numpy()
        frac, mean_rel = image_bars(b, a)
        print(f"imaging {label} card against cpu (64x64 @ "
              f"{setup.make_sampler_config().spp} spp): match_frac {frac:.4f}, "
              f"mean rel {mean_rel:.3e}; the CPU {time.perf_counter() - t1:.2f} s",
              flush=True)
        check(a.shape == (64, 64, 3) and bool(np.isfinite(a).all())
              and float(a.mean()) > 0 and frac >= 0.995 and mean_rel <= 5e-3,
              f"imaging {label} card against cpu: match_frac {frac}, "
              f"mean rel {mean_rel}")
    del cpu_scene, scene
    split["64x64 copies"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    setup = parse_pbrt_file(str(gauss))
    scene = lightdistrib.ensure_spatial_light_distribution(setup.build_scene(dev))
    film_cfg, filt = setup.make_film_config()
    cfg = setup.make_integrator_config()
    one = SamplerConfig("zerotwosequence", 1, RES)
    fs = film.make_film_state(film_cfg, filt, dev)
    mb = {"bvh4 nodes + triangles": scene.bvh4_nodes.nbytes + scene.prim_tris.nbytes,
          "spatial distribution": scene.spatial_cdf.nbytes + scene.spatial_pmf.nbytes,
          "film sums": fs.weighted_sum.nbytes + fs.weight_sum.nbytes,
          "an exact batch's halton table": 4 * RES[0] * RES[1] * n_dims}
    print("imaging bytes on the card, MB: " + json.dumps(
        {k: round(v / 1e6, 4) for k, v in mb.items()}), flush=True)
    del fs
    if profile is not None:
        profile_render(lambda: ip.render(scene, setup.make_camera(), film_cfg, one,
                                         cfg, filt, device=dev),
                       profile.with_name(f"{profile.stem}_imaging{profile.suffix}"),
                       "imaging profile")
    kernels = bvh_kernels(bvh)
    results = {kind: {} for kind in kernels}
    for label, camera in IMAGING_CAMERAS.items():
        cam = parse_pbrt_file(str(imaging_file(main, f"kernel_{label}", camera))
                              ).make_camera()
        with bvh.record_calls() as captured:
            ip.render(scene, cam, film_cfg, one, dataclasses.replace(cfg, max_depth=0),
                      filt, device=dev)
        oc, dc, tc, mc, order = captured[0]
        print(f"batch imaging-{label}: {tc.shape[0]} lanes, {int((tc > 0).sum())} "
              f"live", flush=True)
        for kind, k in kernels.items():
            results[kind][label] = kernel_case(f"{kind}-imaging-{label}", k, bvh,
                                               scene, oc, dc, tc, mc > 0, "mask",
                                               order)
        cross_check(f"imaging-{label}", kernels, scene, oc, dc, tc, mc > 0, order)
        del captured
    del scene
    torch.cuda.empty_cache()
    split["set-up, profile, kernel checks"] = time.perf_counter() - t0
    print("imaging phase split, s: " + json.dumps(
        {k: round(v, 2) for k, v in split.items()}), flush=True)
    return {"bvh4": runs[0][1]["bvh4_traverse"], "bvh2": runs[2][1]["bvh2_traverse"],
            "results": results}


# phase 17's new cameras, each on a 64x64 copy of the main file, card
# against CPU: the orthographic camera with a thin lens, the environment
# camera, the realistic camera (its material and light leaves only)
GRAD_CAMERAS = {
    "orthographic": 'Camera "orthographic" "float lensradius" [0.05] '
                    '"float focaldistance" [8.5]',
    "environment": 'Camera "environment"',
    "realistic": IMAGING_CAMERAS["realistic"],
}
# phase 17's copies, card against CPU, at a depth cut to keep the CPU's
# steps short (glass's inside bounce and the subsurface exit are reached)
GRAD_SMALL, GRAD_SMALL_DEPTH = (64, 64), 2


def grad_setup(path: Path, dev, spatial_from=None, depth=None):
    """(scene, camera, sampler, path config, pixels, param names) of a
    .pbrt file for a grad step, set up as render_setup sets it up; the
    spatial light distribution built here, or taken from spatial_from (a
    scene of the same file on another device); depth: the path's maxdepth
    in place of the file's, or None."""
    import torch

    from pbrt_tpu_torch.cameras.realistic import RealisticParams
    from pbrt_tpu_torch.integrators import path as ip
    from pbrt_tpu_torch.lights import lightdistrib
    from pbrt_tpu_torch.parallel import diff
    from pbrt_tpu_torch.sceneio import parse_pbrt_file

    setup = parse_pbrt_file(str(path))
    if depth is not None:
        setup.integrator_params.set("maxdepth", "integer", [depth])
    scene = setup.build_scene(dev)
    cfg = setup.make_integrator_config()
    if cfg.light_strategy == "spatial":
        if spatial_from is None:
            scene = lightdistrib.ensure_spatial_light_distribution(scene)
        else:
            scene = dataclasses.replace(scene, **{
                k: (v.to(dev) if isinstance(v, torch.Tensor) else v)
                for k in SPATIAL_FIELDS for v in [getattr(spatial_from, k)]})
    camera = setup.make_camera().to(dev)
    film_cfg, _ = setup.make_film_config()
    pixels = torch.as_tensor(ip.make_pixel_grid(film_cfg), device=dev)
    names = (diff.MATERIAL_PARAMS + diff.LIGHT_PARAMS
             if isinstance(camera, RealisticParams) else diff.DEFAULT_PARAMS)
    return scene, camera, setup.make_sampler_config(), cfg, pixels, names


def grad_card_cpu(label, path, dev):
    """One remat grad step at sample 1 of a small file on the card and one
    without remat on the CPU (the CPU takes the card's spatial
    distribution): L at tests/test_torch_path.py:58's bar, every leaf
    finite, and each leaf within 1e-3 of the CPU leaf's largest entry
    (tests/test_torch_cuda.py:335-341) with the weights of the lanes whose
    L differs set to 0 on both devices: a lane whose path took another hit
    or lobe on the other device is another path, not the same path's
    gradient."""
    import torch

    from pbrt_tpu_torch.parallel import diff

    t0 = time.perf_counter()
    setups = [grad_setup(path, dev, depth=GRAD_SMALL_DEPTH)]
    setups.append(grad_setup(path, "cpu", setups[0][0], GRAD_SMALL_DEPTH))
    with torch.no_grad():
        Ls = [diff.render_batch_radiance(scene, camera, pixels, 1, scfg, cfg).cpu()
              for scene, camera, scfg, cfg, pixels, _ in setups]
    rel = (Ls[0] - Ls[1]).abs() / Ls[1].abs().clamp(min=1e-2)
    same = (rel <= 1e-3).all(-1)
    frac = float(same.float().mean())
    out = []
    for (scene, camera, scfg, cfg, pixels, names), remat in zip(setups, (True, False)):
        w = same[:, None].to(torch.float32).expand(-1, 3).to(pixels.device)
        _, g = diff.render_grad_step(scene, camera, pixels, 1, w, scfg, cfg,
                                     param_names=names, remat=remat,
                                     device=pixels.device)
        out.append({k: v.cpu() for k, v in flat_grads(g).items()})
    ga, gb = out
    for k, v in ga.items():
        check(bool(torch.isfinite(v).all()) and bool(torch.isfinite(gb[k]).all()),
              f"grad {label} card against cpu: leaf {k} not finite")
    lr = leaf_rel(ga, gb)
    print(f"grad {label} card against cpu ({GRAD_SMALL[0]}x{GRAD_SMALL[1]}, "
          f"depth {GRAD_SMALL_DEPTH}, sample 1): L match_frac {frac:.4f} ({int((~same).sum())} lanes "
          f"differ, weight 0), leaves within {lr:.3e} of the CPU leaf's "
          f"largest entry; {time.perf_counter() - t0:.2f} s", flush=True)
    check(frac >= 0.995 and lr <= 1e-3,
          f"grad {label} card against cpu: match_frac {frac}, leaves {lr}")


def grad_breadth_phase(counted, card, dev, profile):
    """Phase 17: render_grad_step on every family the port renders, at
    full width.  For each of the config3, breadth, advanced and imaging
    (lowdiscrepancy, gaussian) files at 400x400, depth 5, one 160,000-pixel
    batch at sample 1: a remat step (its launches recorded), a step
    without remat and the no_grad forward, timed; L bit-equal to the
    forward,
    every leaf finite, remat against no remat within 1e-4 of each leaf's
    largest entry, the launches (the forward's without remat, the
    forward's and the replayed bounces' with it), each replayed launch
    bit-equal to its forward launch; a remat step under PBRT_TPU_BVH4=0
    against bvh4 (1e-4 of each leaf's largest entry, or, where L differs,
    only at ties: config3_cross on its batches); a 64x64 copy at depth
    GRAD_SMALL_DEPTH card against CPU (grad_card_cpu).  Then 64x64 steps with the orthographic (thin lens), environment
    and realistic cameras, card against CPU.  With profile, one more remat
    step of each file under torch.profiler, its table written to profile's
    name plus "_grad_<file>" (the advanced one "_grad_advanced").  Returns
    the launches of each kernel in each file's remat step."""
    import torch

    from pbrt_tpu_torch.ops import bvh
    from pbrt_tpu_torch.parallel import diff
    from pbrt_tpu_torch.utils import stats

    out_dir = SMOKE_DIR / "grad_breadth"
    t_phase = time.perf_counter()
    main = write_main_pbrt(out_dir / "imaging")
    gauss = 'PixelFilter "gaussian"'
    lowd = f'Sampler "lowdiscrepancy" "integer pixelsamples" [{SPP}]'
    files = {
        "config3": lambda res: write_config3_pbrt(out_dir / f"config3_{res[0]}",
                                                  res=res, spp=1),
        "breadth": lambda res: write_breadth_pbrt(out_dir / f"breadth_{res[0]}",
                                                  res=res, spp=1),
        "advanced": lambda res: write_advanced_pbrt(out_dir / f"advanced_{res[0]}",
                                                    res=res, spp=1),
        "imaging": lambda res: imaging_file(main, f"imaging_{res[0]}", filt=gauss,
                                            sampler=lowd, res=res),
    }
    launches = {"bvh4": {}, "bvh2": {}}
    for label, write in files.items():
        t0 = time.perf_counter()
        path = write(RES)
        scene, camera, scfg, cfg, pixels, names = grad_setup(path, dev)
        w = torch.ones((pixels.shape[0], 3), device=dev)
        per = 2 + PROBE_DEPTH if label == "advanced" else 1  # replayed a bounce

        def step(remat, record=False):
            counters = stats.zeros(dev)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            reset_counts(counted)
            with (bvh.record_calls() if record else contextlib.nullcontext()) as calls:
                t1 = time.perf_counter()
                L, g = diff.render_grad_step(scene, camera, pixels, 1, w, scfg, cfg,
                                             param_names=names, remat=remat,
                                             device=dev, counters=counters)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t1
            leaves = flat_grads(g)
            for k, v in leaves.items():
                check(bool(torch.isfinite(v).all()),
                      f"grad {label}: leaf {k} is not finite (remat {remat})")
            return dict(L=L, leaves=leaves, wall=wall, launches=read_counts(counted),
                        rays=stats.ray_total(counters), calls=calls,
                        peak=torch.cuda.max_memory_allocated(dev) - base)

        on, off = step(True, record=True), step(False)
        reset_counts(counted)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.no_grad():
            L_fwd = diff.render_batch_radiance(scene, camera, pixels, 1, scfg, cfg)
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t1
        fwd_launches = read_counts(counted)["bvh4_traverse"]
        check(torch.equal(on["L"], L_fwd) and torch.equal(off["L"], L_fwd),
              f"grad {label}: the step's L differs from the no_grad forward")
        rel = leaf_rel(on["leaves"], off["leaves"])
        check(rel <= 1e-4, f"grad {label}: remat and no-remat leaves differ by "
                           f"{rel:.3e} of a leaf's largest entry")
        n_on, n_off = (r["launches"]["bvh4_traverse"] for r in (on, off))
        check(n_off == fwd_launches and n_on == fwd_launches + DEPTH * per
              and on["launches"]["bvh2_traverse"] == 0,
              f"grad {label}: launches {n_on} (remat) and {n_off}, the forward "
              f"{fwd_launches}, not + {DEPTH * per} replayed")
        calls = on["calls"]
        k = (fwd_launches - 1) // DEPTH
        replay = [calls[1 + b * k + i] for b in reversed(range(DEPTH))
                  for i in range(per)]
        same = all(len(a) == len(b) and all(
            (x is None and y is None) or (x is not None and y is not None
                                          and torch.equal(x, y))
            for x, y in zip(a, b)) for a, b in zip(calls[fwd_launches:], replay))
        check(len(calls) == n_on and same,
              f"grad {label}: a replayed launch differs from its forward launch")
        del calls, on["calls"]
        with bvh_switch("0"), bvh.record_calls() as cap2:
            b2 = step(True)
        check(b2["launches"]["bvh2_traverse"] == n_on
              and b2["launches"]["bvh4_traverse"] == 0,
              f"grad {label}: the bvh2 step launched {b2['launches']}")
        rel2 = leaf_rel(b2["leaves"], on["leaves"])
        if not (torch.equal(b2["L"], on["L"]) and rel2 <= 1e-4):
            config3_cross(scene, cap2, f"grad {label}")
        del cap2
        for name, r in (("remat on", on), ("remat off", off)):
            print(f"grad {label} {RES[0]}x{RES[1]} sample 1 {name}: fwd+bwd "
                  f"{r['wall']:.3f} s, {int(r['rays'])} forward rays, "
                  f"{r['rays'] / r['wall'] / 1e6:.4f} Mrays/s, max_memory_allocated "
                  f"{r['peak'] / 2**20:.1f} MiB above the step's start, "
                  f"{r['launches']['bvh4_traverse']} bvh4 launches, step over "
                  f"forward {r['wall'] / fwd_s:.2f}x [{card}]", flush=True)
        print(f"grad {label}: forward (no_grad) {fwd_s:.3f} s, {fwd_launches} "
              f"launches; L bit-equal; remat leaves within {rel:.3e}; "
              f"{DEPTH * per} replayed launches bit-equal to their forward "
              f"launches; bvh2 step {b2['wall']:.3f} s, L bit-equal "
              f"{torch.equal(b2['L'], on['L'])}, leaves within {rel2:.3e} of "
              f"bvh4's; leaves' largest |g| "
              + json.dumps({k: float(f"{float(v.abs().max()):.4g}")
                            for k, v in on["leaves"].items()}), flush=True)
        launches["bvh4"][label] = n_on
        launches["bvh2"][label] = b2["launches"]["bvh2_traverse"]
        if profile is not None:
            profile_grad(lambda: diff.render_grad_step(
                scene, camera, pixels, 2, w, scfg, cfg, param_names=names,
                device=dev),
                profile.with_name(f"{profile.stem}_grad_{label}{profile.suffix}"),
                f"grad {label}")
        del scene, on, off, b2, L_fwd
        torch.cuda.empty_cache()
        grad_card_cpu(label, write(GRAD_SMALL), dev)
        print(f"grad {label}: {time.perf_counter() - t0:.1f} s", flush=True)
    for label, camera in GRAD_CAMERAS.items():
        grad_card_cpu(f"{label} camera", imaging_file(
            main, f"camera_{label}", camera, res=GRAD_SMALL), dev)
    print(f"grad breadth phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


# the scene arrays phase 18 holds between the geometry file and its
# SceneBuilder scene
SCENE_ARRAYS = ("prim_meta", "tri_indices", "tri_attr", "tri_verts", "q_packed",
                "q_prim_id", "bvh_min", "bvh_max", "bvh_offset", "bvh_nprims")

# the typed build's float operations a test (column of the plain version's
# per-type counts, ops/bvh.py _leaf_tests): a triangle's Moller-Trumbore;
# an instanced triangle's plus the ray's move to object space (33); a
# quadric's move (33), coefficients, double-single discriminant and root
# (~80) and two clips with their atan2 (~2 x 55); a curve's ray frame and
# control points (~170), and ~335 a window (12 blossoms, the leaf test,
# 3 Bezier evaluations)
TYPED_FLOPS = (TRI_FLOPS,) + (230,) * 6 + (170, TRI_FLOPS + 33, 335)
# the bytes a test reads: the 48-byte record, plus its q_packed row (96),
# curve_packed row (112) or inst_xf w2i (48)
TYPED_BYTES = (48,) + (48 + 96,) * 6 + (48 + 112, 48 + 48, 0)


class _TypedWrapper:
    """bvh4_traverse_typed with the scene's typed tables bound, called as
    kernel_case calls a wrapper; `launches` is the typed build's count."""

    def __init__(self, bvh, scene):
        self.bvh = bvh
        self.tables = bvh.typed_tables(scene)

    def __call__(self, nodes, tris, o, d, t_max, mode, depth, order=None):
        return self.bvh.bvh4_traverse_typed(nodes, tris, *self.tables, o, d,
                                            t_max, mode, depth, order)

    @property
    def launches(self):
        return self.bvh.bvh4_traverse_typed.launches

    @launches.setter
    def launches(self, value):
        self.bvh.bvh4_traverse_typed.launches = value


def typed_kernel(bvh, scene) -> dict:
    """kernel_case's entry for the typed build of bvh4 on `scene`."""
    import functools

    wrapper = _TypedWrapper(bvh, scene)
    return dict(wrapper=wrapper,
                plain=functools.partial(bvh.bvh4_traverse_plain,
                                        typed=wrapper.tables),
                nodes="bvh4_nodes", depth="bvh4_depth", node_bytes=bvh.NODE_BYTES,
                node_flops=4 * SLAB_FLOPS, test_flops=TYPED_FLOPS,
                test_bytes=TYPED_BYTES,
                extra_bytes=sum(t.nbytes for t in wrapper.tables))


def geometry_checks(label, scene, camera, film_cfg, cfg, filt, bvh, ip, kernels, dev):
    """Each kernel of `kernels` against its plain version, bit for bit, on
    every batch that one spp of the file launched (the camera rays and
    each bounce's merged NEE batch)."""
    from pbrt_tpu_torch.samplers.samplers import SamplerConfig

    with bvh.record_calls() as captured:
        ip.render(scene, camera, film_cfg, SamplerConfig("halton", 1, RES), cfg,
                  filt, device=dev)
    check(len(captured) == 1 + DEPTH,
          f"{label}: one spp launched {len(captured)} times, not {1 + DEPTH}")
    results = {kind: {} for kind in kernels}
    for i, (oc, dc, tc, mc, order) in enumerate(captured):
        batch = "camera" if i == 0 else f"merged-b{i - 1}"
        print(f"batch {label}-{batch}: {tc.shape[0]} lanes, {int((tc > 0).sum())} "
              f"live, {int((mc > 0).sum())} any-hit", flush=True)
        for kind, k in kernels.items():
            results[kind][batch] = kernel_case(f"{kind}-{label}-{batch}", k, bvh,
                                               scene, oc, dc, tc, mc > 0, "mask",
                                               order, both_modes=kind != "typed")
    return results


def geometry_grad(label, scene, camera, film_cfg, cfg, counted, kernel, dev):
    """One render_grad_step at RES, sample 1, remat on, every DEFAULT_PARAMS
    leaf, weights of ones: L bit-equal to the no_grad forward, every leaf
    finite, 1 + DEPTH forward launches and DEPTH replayed ones, each
    replayed launch's inputs bit-equal to its forward launch's."""
    import torch

    from pbrt_tpu_torch.integrators import path as ip
    from pbrt_tpu_torch.ops import bvh
    from pbrt_tpu_torch.parallel import diff
    from pbrt_tpu_torch.samplers.samplers import SamplerConfig

    pixels = torch.as_tensor(ip.make_pixel_grid(film_cfg), device=dev)
    scfg = SamplerConfig("halton", SPP, RES)
    w = torch.ones((pixels.shape[0], 3), device=dev)
    reset_counts(counted)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    with bvh.record_calls() as calls:
        t0 = time.perf_counter()
        L, g = diff.render_grad_step(scene, camera, pixels, 1, w, scfg, cfg,
                                     remat=True, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - base
    n_step = read_counts(counted)[kernel]
    leaves = flat_grads(g)
    for k, v in leaves.items():
        check(bool(torch.isfinite(v).all()), f"grad {label}: leaf {k} not finite")
    reset_counts(counted)
    t0 = time.perf_counter()
    with torch.no_grad():
        L_fwd = diff.render_batch_radiance(scene, camera, pixels, 1, scfg, cfg)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    n_fwd = read_counts(counted)[kernel]
    check(torch.equal(L, L_fwd), f"grad {label}: L differs from the forward")
    check(n_fwd == 1 + DEPTH and n_step == n_fwd + DEPTH and len(calls) == n_step,
          f"grad {label}: launches {n_step} (step), {n_fwd} (forward)")
    replay = [calls[1 + b] for b in reversed(range(DEPTH))]
    same = all(all((x is None and y is None) or (x is not None and y is not None
                                                 and torch.equal(x, y))
                   for x, y in zip(a, b)) for a, b in zip(calls[n_fwd:], replay))
    check(same, f"grad {label}: a replayed launch differs from its forward launch")
    print(f"grad {label} {RES[0]}x{RES[1]} sample 1, remat: fwd+bwd {wall:.3f} s, "
          f"forward {fwd_s:.3f} s, step over forward {wall / fwd_s:.2f}x, "
          f"max_memory_allocated {peak / 2**20:.1f} MiB above the step's start, "
          f"{n_step} {kernel} launches ({DEPTH} replayed, bit-equal); L bit-equal "
          f"to the forward; every leaf finite, largest |g| "
          + json.dumps({k: float(f"{float(v.abs().max()):.4g}")
                        for k, v in leaves.items()}) + f" [{card_name()}]", flush=True)
    return n_step


def card_name() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "?"


def table_bytes(scene) -> dict:
    """The scene's tables on the card, MB."""
    names = ("bvh4_nodes", "bvh2_nodes", "prim_tris", "prim_meta", "tri_attr",
             "tri_verts", "q_packed", "curve_packed", "inst_xf", "inst_tri",
             "spatial_cdf", "spatial_pmf")
    return {k: round(getattr(scene, k).nbytes / 1e6, 4) for k in names
            if getattr(scene, k) is not None}


def blob_alone(bvh, dev, n_blobs=16, blob=(256, 128)) -> dict:
    """The typed build against the triangle-only build on one BVH: the
    instances file's 16 blob instances as instanced triangles, and the same
    1,048,576 triangles flattened into world space (the same world bounds,
    so the same tree and record order), each traced by its build on one
    400x400 batch of camera rays, timed with CUDA events; the two must find
    the same prims."""
    import torch

    from pbrt_tpu_torch import cameras
    from pbrt_tpu_torch import scene as sc
    from pbrt_tpu_torch.core import transform as tf

    idx, v = blob_mesh(blob[0], blob[1], seed=3, center=(0.0, 0.0, 0.0),
                       radius=0.55)
    rs = np.random.RandomState(21)
    side = int(np.ceil(np.sqrt(n_blobs)))
    xfs = [tf.translate(-4.2 + 8.4 * (k % side) / (side - 1),
                        -1.0 + 4.0 * (k // side) / (side - 1), 0.6)
           @ tf.rotate(rs.uniform(0, 360), 0, 0, 1) for k in range(n_blobs)]
    inst, flat = sc.SceneBuilder(), sc.SceneBuilder()
    inst.begin_mesh_template()
    inst.add_triangle_mesh(idx, v)
    t = inst.end_mesh_template()
    for xf in xfs:
        inst.add_mesh_instance(t, xf)
        flat.add_triangle_mesh(idx, xf.apply_point(v).astype(np.float32))
    s_inst, s_flat = inst.build(device=dev), flat.build(device=dev)
    check(torch.equal(s_inst.bvh4_nodes.view(torch.int32),
                      s_flat.bvh4_nodes.view(torch.int32)),
          "blob alone: the instanced and flattened trees differ")
    cam = camera_for(cameras, tf, RES)
    from pbrt_tpu_torch.cameras import generate_rays
    from pbrt_tpu_torch.integrators import path as ip
    from pbrt_tpu_torch.film import FilmConfig

    px = torch.as_tensor(ip.make_pixel_grid(FilmConfig(full_resolution=RES)),
                         device=dev).to(torch.float32) + 0.5
    o, d = generate_rays(cam.to(dev), px, torch.full_like(px, 0.5),
                         torch.zeros(px.shape[0], device=dev))[:2]
    o, d = o.contiguous(), d.contiguous()
    n = o.shape[0]
    tm = torch.full((n,), 1e30, device=dev)
    zeros = torch.zeros(n, device=dev)
    key = bvh.sort_rays_key(s_flat.bvh_min[0], s_flat.bvh_max[0], o, d, tm)
    order = torch.argsort(key, stable=True).to(torch.int32)
    saved = (bvh.bvh4_traverse.launches, bvh.bvh4_traverse_typed.launches)
    typed = bvh.typed_tables(s_inst)
    run_t = lambda: bvh.bvh4_traverse_typed(s_inst.bvh4_nodes, s_inst.prim_tris, *typed,
                                            o, d, tm, zeros, s_inst.bvh4_depth, order)
    run_f = lambda: bvh.bvh4_traverse(s_flat.bvh4_nodes, s_flat.prim_tris, o, d, tm,
                                      zeros, s_flat.bvh4_depth, order)
    (tt, pt), (tf_, pf) = run_t(), run_f()
    agree = float((pt == pf).float().mean())
    ms = {"flat_ms": time_cuda(run_f, 10), "typed_ms": time_cuda(run_t, 10)}
    ms["flat_ms_2"], ms["typed_ms_2"] = time_cuda(run_f, 10), time_cuda(run_t, 10)
    bvh.bvh4_traverse.launches, bvh.bvh4_traverse_typed.launches = saved
    check(agree >= 0.999, f"blob alone: the builds agree on {agree} of the prims")
    out = dict(rays=n, prims=int(s_inst.prim_meta.shape[0]), prim_agree=agree,
               hit_frac=float((pf >= 0).float().mean()), **ms,
               typed_over_flat=(ms["typed_ms"] + ms["typed_ms_2"])
               / (ms["flat_ms"] + ms["flat_ms_2"]))
    print("blob alone (typed instanced against triangle-only flattened, one tree, "
          f"a 400x400 camera batch): {json.dumps(out)}", flush=True)
    return out


def geometry_phase(render, counted, card, dev, profile):
    """Phase 18: pbrt-v3's remaining shapes through render.render_file on
    the card.  write_geometry_pbrt (inside the JAX package's gate: the
    triangle-only bvh4 and the six-type quadric pass) and
    write_instances_pbrt (past it: the typed build of bvh4), each at
    400x400 @ CUT_SPP (4) spp, path depth 5, halton, spatial: the launches
    of each
    build, the wall a spp beside the process CPU, Mrays/s, set-up seconds
    by phase, the bytes on the card by table, a bit-identical repeat; the
    geometry file against the same scene made with SceneBuilder calls (bit
    for bit); a 64x64 copy at depth 2 on the card against the CPU at
    tests/test_torch_path.py:58-59's bars; each kernel against its plain
    version on every batch of one spp; one remat render_grad_step at
    400x400; the instances scene refused under PBRT_TPU_BVH4=0.  With
    profile, one spp of each under torch.profiler ("_geometry",
    "_instances")."""
    import torch

    from pbrt_tpu_torch.integrators import path as ip
    from pbrt_tpu_torch.lights import lightdistrib
    from pbrt_tpu_torch.ops import bvh
    from pbrt_tpu_torch.sceneio import parse_pbrt_file

    out_dir = SMOKE_DIR / "geometry"
    out = {"launches": {}, "grad": {}, "results": {}}
    for label, write, kernel in (
            ("geometry", write_geometry_pbrt, "bvh4_traverse"),
            ("instances", write_instances_pbrt, "bvh4_traverse_typed")):
        split = {}
        t0 = time.perf_counter()
        path = write(out_dir / label, spp=CUT_SPP)
        split["file written"] = time.perf_counter() - t0
        # the user's entry point, counted
        t0 = time.perf_counter()
        c0 = time.process_time()
        img, st, launches = timed_render_file(render, counted, path,
                                              out_dir / f"{label}.pfm", dev)
        cpu = time.process_time() - c0
        want = CUT_SPP * (1 + DEPTH)
        check(launches[kernel] == want
              and all(v == 0 for k, v in launches.items() if k != kernel),
              f"{label}: launches {launches}, not {want} of {kernel} alone")
        wall = st["phases"]["Rendering"]
        print(render_line(f"{label} {RES[0]}x{RES[1]} @ {CUT_SPP} spp", st, launches,
                          card)
              + f", wall {wall / CUT_SPP:.4f} s a spp, process CPU of the whole call "
              f"{cpu:.3f} s; set-up split, s: "
              + json.dumps({k: round(v, 3) for k, v in st["setup_split"].items()})
              + f"; image mean {float(img.mean()):.6f}", flush=True)
        out["launches"][label] = launches
        split["render_file"] = time.perf_counter() - t0
        # the repeat: the instances file from a second parse; the geometry
        # file as the same scene made with SceneBuilder calls, whose arrays
        # are the file's bit for bit (the same render, through the builder)
        t0 = time.perf_counter()
        setup = parse_pbrt_file(str(path))
        if label == "geometry":
            own = dataclasses.replace(setup, scene_builder=geometry_builder(path),
                                      _scene_cache=None)
            a, b = setup.scene_builder.build_numpy(), own.scene_builder.build_numpy()
            same = [k for k in SCENE_ARRAYS if np.array_equal(a[k], b[k])]
            check(len(same) == len(SCENE_ARRAYS), "geometry: the SceneBuilder "
                  f"scene's arrays differ: {set(SCENE_ARRAYS) - set(same)}")
            img2, _ = render.render_setup(own, device=dev)
            check(np.array_equal(img, img2),
                  "geometry: the .pbrt render differs from the SceneBuilder render")
            del own, a, b
        else:
            img2, _ = render.render_setup(setup, device=dev)
            check(np.array_equal(img, img2), f"{label}: a repeat differs")
        scene = lightdistrib.ensure_spatial_light_distribution(setup.build_scene(dev))
        print(f"{label} bytes on the card, MB: " + json.dumps(table_bytes(scene))
              + f"; {int(scene.prim_meta.shape[0])} primitives; repeat bit-identical"
              + (" (the SceneBuilder scene: arrays and render bit-equal to the "
                 "file's)" if label == "geometry" else ""), flush=True)
        split["repeat"] = time.perf_counter() - t0
        if label != "geometry":
            with bvh_switch("0"):
                try:
                    render.render_setup(setup, spp_override=1, device=dev)
                    refused = False
                except NotImplementedError as e:
                    refused = "PBRT_TPU_BVH4" in str(e)
            check(refused, "instances: PBRT_TPU_BVH4=0 was not refused")
            print("instances: refused under PBRT_TPU_BVH4=0", flush=True)
            out["blob_alone"] = blob_alone(bvh, dev)
        film_cfg, filt = setup.make_film_config()
        camera = setup.make_camera()
        cfg = setup.make_integrator_config()
        if profile is not None:
            from pbrt_tpu_torch.samplers.samplers import SamplerConfig

            profile_render(lambda: ip.render(scene, camera, film_cfg,
                                             SamplerConfig("halton", 1, RES), cfg,
                                             filt, device=dev),
                           profile.with_name(f"{profile.stem}_{label}{profile.suffix}"),
                           f"{label} profile")
        t0 = time.perf_counter()
        kernels = ({"bvh4": bvh_kernels(bvh)["bvh4"]} if label == "geometry"
                   else {"typed": typed_kernel(bvh, scene)})
        out["results"].update(geometry_checks(label, scene, camera, film_cfg, cfg,
                                              filt, bvh, ip, kernels, dev))
        split["kernel checks"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["grad"][label] = geometry_grad(label, scene, camera, film_cfg, cfg,
                                           counted, kernel, dev)
        split["grad step"] = time.perf_counter() - t0
        del scene, setup
        torch.cuda.empty_cache()
        # the 64x64 copy at depth 2, card against CPU (the CPU takes the
        # card's spatial distribution)
        t0 = time.perf_counter()
        small = parse_pbrt_file(str(path))
        small.integrator_params.set("maxdepth", "integer", [2])
        a, _ = render.render_setup(small, spp_override=1, res_override=(64, 64),
                                   device=dev)
        card_scene = small._scene_cache
        cpu_scene = small.scene_builder.build(device="cpu")
        spatial = lightdistrib.ensure_spatial_light_distribution(card_scene)
        cpu_scene = dataclasses.replace(cpu_scene, **{
            k: getattr(spatial, k).cpu() for k in SPATIAL_FIELDS})
        small._scene_cache = cpu_scene
        b, _ = render.render_setup(small, spp_override=1, res_override=(64, 64),
                                   device="cpu")
        frac, mean_rel = image_bars(b, a)
        print(f"{label} card against cpu (64x64 @ 1 spp, depth 2): match_frac "
              f"{frac:.4f}, mean rel {mean_rel:.3e}", flush=True)
        check(a.shape == (64, 64, 3) and bool(np.isfinite(a).all())
              and float(a.mean()) > 0 and frac >= 0.995 and mean_rel <= 5e-3,
              f"{label} card against cpu: match_frac {frac}, mean rel {mean_rel}")
        del small, card_scene, cpu_scene, spatial
        split["64x64 card against cpu"] = time.perf_counter() - t0
        print(f"{label} phase split, s: " + json.dumps(
            {k: round(v, 2) for k, v in split.items()}), flush=True)
    return out


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Phase 19: pbrt-v3's other light-transport integrators
# ---------------------------------------------------------------------------

# a bdpt sample at depth D launches the camera walk's D + 1, the light
# walk's D, then a connection each for the D strategies with t = 1, the D
# with s = 1 and the D (D - 1) / 2 with s, t >= 2 (integrators/bdpt.py)
BDPT_LAUNCHES = (DEPTH + 1) + DEPTH + DEPTH + DEPTH + DEPTH * (DEPTH - 1) // 2
# phase 19's MLT: the chains are the lanes; 65,536 bootstrap vectors a depth
MLT_CHAINS, MLT_MPP = 65536, 4
MLT_BOOTSTRAP = MLT_CHAINS * (DEPTH + 1)
# phase 19's SPPM: photons an iteration at the pixel count; the radius
# against main's scale (a 20-unit floor, ~0.02 units a pixel at the blob)
SPPM_ITERATIONS, SPPM_RADIUS = 4, 0.3
SPPM_LAUNCHES = 3 * DEPTH  # an iteration: 2 a camera bounce, 1 a photon bounce


def write_transport_pbrt(out_dir: Path, integrator: str, extra: str = "",
                         res=RES, spp=SPP) -> Path:
    """write_main_pbrt's scene (its 262,144-triangle blob, the mirror
    sphere's caustic and the emissive sphere, L = 40) with Integrator
    `integrator` and its parameters `extra`, at res and spp."""
    out_dir.mkdir(parents=True, exist_ok=True)
    text = write_main_pbrt(out_dir).read_text()
    text = text.replace(f'Integrator "path" "integer maxdepth" [{DEPTH}]',
                        f'Integrator "{integrator}" "integer maxdepth" [{DEPTH}] {extra}')
    text = text.replace(
        f'"integer xresolution" [{RES[0]}] "integer yresolution" [{RES[1]}]',
        f'"integer xresolution" [{res[0]}] "integer yresolution" [{res[1]}]')
    text = text.replace(f'"integer pixelsamples" [{SPP}]',
                        f'"integer pixelsamples" [{spp}]')
    path = out_dir / f"{integrator}_{res[0]}.pbrt"
    path.write_text(text)
    return path


def block_mean(img, res):
    """img [H, W, 3] averaged over blocks down to res (x, y): the image at
    the resolution a test's bars were set at (tests/test_bdpt.py's 20x20,
    tests/test_mlt_sppm_tools.py's 16x16)."""
    h, w = img.shape[:2]
    return img.reshape(res[1], h // res[1], res[0], w // res[0], 3).mean((1, 3))


def mean_corr(img, ref):
    """tests/test_mlt_sppm_tools.py's measures: the means' relative
    difference and the pixels' correlation."""
    return (abs(float(img.mean()) - float(ref.mean())) / float(ref.mean()),
            float(np.corrcoef(img.ravel(), ref.ravel())[0, 1]))


def bdpt_bars(img, ref):
    """tests/test_bdpt.py's measures at its 20x20: the means' relative
    difference and the mean per-pixel difference over the mean."""
    a, b = block_mean(img, (20, 20)), block_mean(ref, (20, 20))
    return (abs(float(a.mean()) - float(b.mean())) / float(b.mean()),
            float(np.abs(a - b).mean()) / float(b.mean()))


def transport_batches(name, scene, captured, picks, kernels, bvh, out, bvh2_on):
    """bvh4 against its plain version on the batches picks {label: index}
    of one recorded sample, bvh2 against its plain version on the batch
    bvh2_on, and bvh2 against bvh4 on every one."""
    for label, i in picks.items():
        oc, dc, tc, mc, order = captured[i]
        print(f"batch {name}-{label}: {tc.shape[0]} lanes, {int((tc > 0).sum())} "
              f"live, {int((mc > 0).sum())} any-hit", flush=True)
        for kind, k in kernels.items():
            if kind == "bvh2" and label != bvh2_on:
                continue  # bvh2 is held to bvh4 below, bit for bit
            out["results"][kind][f"{name}-{label}"] = kernel_case(
                f"{kind}-{name}-{label}", k, bvh, scene, oc, dc, tc, mc > 0, "mask",
                order, both_modes=False)
        cross_check(f"{name}-{label}", kernels, scene, oc, dc, tc, mc > 0, order)


def small_copy(render, path, dev):
    """A 64x64 file rendered on the card and on the CPU: (card, cpu, the
    CPU's seconds)."""
    a, _ = render.render_file(str(path), out=str(path.with_suffix(".card.pfm")),
                              device=dev)
    t0 = time.perf_counter()
    b, _ = render.render_file(str(path), out=str(path.with_suffix(".cpu.pfm")),
                              device="cpu")
    return a, b, time.perf_counter() - t0


def transport_phase(render, counted, card, dev, profile):
    """Phase 19: Integrator "bdpt", "mlt" and "sppm" through
    render.render_file on main's scene at 400x400, depth 5, halton (the
    mirror sphere's caustic is what they exist for), against the port's
    path render of the file (8 spp).  bdpt at 8 spp: its launches, a
    bit-identical repeat, PBRT_TPU_BVH4=0 at tests/test_torch_path.py:
    58-59's bars, bvh4 against its plain version on one spp's camera-walk,
    light-walk and (s = t = 2) connection batches and bvh2 on the
    connection's, bvh2 against bvh4 on all three, a 64x64 @ 1 spp copy
    card against CPU at the path bars, and tests/test_bdpt.py's bars
    (means within 5%, mean per-pixel difference within 15%, at its 20x20)
    against path on the file with the sphere in matte (2 spp each: the
    path integrator counts light through the mirror twice, ROADMAP §3 O1;
    main's own file is printed).  mlt with 65,536 chains, 4 mutations a
    pixel, 393,216 bootstrap vectors: a bit-identical repeat, a 64x64 copy
    (depth 2, 1,024 chains) card against CPU with the same draws (the
    bootstrap's b within 1e-3, the images at the MLT bars), the image
    against path at tests/test_mlt_sppm_tools.py's MLT bars at its 16x16
    (means within 15%, correlation above 0.9).  sppm with 160,000 photons
    an iteration: the photons a visible point gathers, a bit-identical
    repeat, a 64x64 copy card against CPU at the path bars, the image
    against path at the SPPM bars at 16x16 (12%, 0.95), and each kernel
    against its plain version on one photon batch.  With --profile FILE,
    one bdpt spp, one mlt render at 1 mutation a pixel and one sppm
    iteration under torch.profiler (FILE's name plus "_bdpt", "_mlt",
    "_sppm")."""
    import torch
    from pbrt_tpu_torch import film
    from pbrt_tpu_torch.integrators import bdpt, mlt, sppm
    from pbrt_tpu_torch.ops import bvh
    from pbrt_tpu_torch.samplers.samplers import SamplerConfig
    from pbrt_tpu_torch.sceneio import parse_pbrt_file

    out_dir = SMOKE_DIR / "transport"
    kernels = bvh_kernels(bvh)
    out = {"results": {kind: {} for kind in kernels}, "walls": {}}
    split = {}

    # the port's path render of the file, the reference of all three
    t0 = time.perf_counter()
    p_path = write_transport_pbrt(out_dir, "path")
    ref, st, launches = timed_render_file(render, counted, p_path,
                                          out_dir / "path.pfm", dev)
    print(render_line(f"transport path reference 400x400 @ {SPP} spp", st, launches,
                      card), flush=True)
    split["path reference"] = time.perf_counter() - t0

    # bdpt
    t0 = time.perf_counter()
    p = write_transport_pbrt(out_dir, "bdpt")
    imgs = []
    for _ in range(2):
        ranks0 = film.add_splats.ranks
        img, st, launches = timed_render_file(render, counted, p,
                                              out_dir / "bdpt.pfm", dev)
        check(launches["bvh4_traverse"] == SPP * BDPT_LAUNCHES
              and launches["bvh2_traverse"] == 0,
              f"bdpt: launches {launches}, not {SPP * BDPT_LAUNCHES}")
        wall = st["phases"]["Rendering"]
        print(render_line(f"bdpt main {RES[0]}x{RES[1]} @ {SPP} spp", st, launches,
                          card)
              + f", wall {wall / SPP:.4f} s a spp, splat rounds "
              f"{film.add_splats.ranks - ranks0}, image mean {float(img.mean()):.6f}",
              flush=True)
        out["walls"].setdefault("bdpt", []).append(wall)
        imgs.append(img)
    check(np.array_equal(imgs[0], imgs[1]), "bdpt: a repeat differs")
    out["bdpt"] = launches["bvh4_traverse"]
    img2, _, launches2 = timed_render_file(render, counted, p, out_dir / "bdpt2.pfm",
                                           dev, switch="0")
    check(launches2["bvh2_traverse"] == SPP * BDPT_LAUNCHES
          and launches2["bvh4_traverse"] == 0, f"bdpt bvh2: launches {launches2}")
    frac, mrel = image_bars(imgs[0], img2)
    print(f"bdpt bvh2 against bvh4: match_frac {frac:.4f}, mean rel {mrel:.3e}",
          flush=True)
    check(frac >= 0.995 and mrel <= 5e-3, f"bdpt bvh2: {frac}, {mrel}")
    # the path integrator counts light seen through the mirror twice (its
    # NEE samples the specular lobe, as the JAX package's does, and the
    # next bounce adds the emission again): printed here; the bars are held
    # on the same file with the sphere in matte
    rel, per_pix = bdpt_bars(imgs[0], ref)
    print(f"bdpt against path, main's file: means differ by {rel:.4f}, mean "
          f"per-pixel difference at 20x20 {per_pix:.4f} of the mean; at "
          f"400x400 {float(np.abs(imgs[0] - ref).mean()) / float(ref.mean()):.4f}",
          flush=True)
    matte = {}
    for integ in ("path", "bdpt"):
        q = write_transport_pbrt(out_dir / "matte", integ, spp=2)
        q.write_text(q.read_text().replace('Material "mirror" "rgb Kr" [0.9 0.9 0.9]',
                                           'Material "matte" "rgb Kd" [0.7 0.7 0.7]'))
        matte[integ], _, _ = timed_render_file(render, counted, q,
                                               out_dir / f"matte_{integ}.pfm", dev)
    rel, per_pix = bdpt_bars(matte["bdpt"], matte["path"])
    print(f"bdpt against path, the sphere in matte (2 spp each): means differ by "
          f"{rel:.4f} (bar 0.05), mean per-pixel difference at 20x20 {per_pix:.4f} "
          f"of the mean (bar 0.15)", flush=True)
    check(rel < 0.05 and per_pix < 0.15, f"bdpt against path: {rel}, {per_pix}")
    split["bdpt renders"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    setup = parse_pbrt_file(str(p))
    scene = setup.build_scene(dev)
    camera = setup.make_camera()
    film_cfg, filt = setup.make_film_config()
    with bvh.record_calls() as captured:
        bdpt.render(scene, camera, film_cfg, SamplerConfig("halton", 1, RES),
                    setup.make_integrator_config(), filt, device=dev)
    check(len(captured) == BDPT_LAUNCHES,
          f"bdpt: one spp launched {len(captured)} times, not {BDPT_LAUNCHES}")
    # the camera walk's first segment, the light walk's first, the first
    # t = 1 connection (to the lens), the first s = 1 (a light sample) and
    # the first s, t >= 2 (the strategies' order: bdpt.strategies)
    order = bdpt.strategies(DEPTH)
    traced = [st_ for st_ in order if st_[0] != 0]
    conn0 = 2 * DEPTH + 1
    picks = {"camera-walk": 0, "light-walk": DEPTH + 1,
             "connect-s2t2": conn0 + traced.index((2, 2))}
    transport_batches("bdpt", scene, captured, picks, kernels, bvh, out,
                      "connect-s2t2")
    del captured
    if profile is not None:
        profile_render(lambda: bdpt.render(scene, camera, film_cfg,
                                           SamplerConfig("halton", 1, RES),
                                           setup.make_integrator_config(), filt,
                                           device=dev),
                       profile.with_name(f"{profile.stem}_bdpt{profile.suffix}"),
                       "bdpt profile")
    split["bdpt kernel checks"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    small = write_transport_pbrt(out_dir, "bdpt", res=(64, 64), spp=1)
    a, b, cpu_s = small_copy(render, small, dev)
    frac, mrel = image_bars(b, a)
    print(f"bdpt card against cpu (64x64 @ 1 spp): match_frac {frac:.4f}, mean rel "
          f"{mrel:.3e}; the CPU render {cpu_s:.2f} s", flush=True)
    check(frac >= 0.995 and mrel <= 5e-3, f"bdpt card against cpu: {frac}, {mrel}")
    split["bdpt 64x64 copy"] = time.perf_counter() - t0

    # mlt
    t0 = time.perf_counter()
    extra = (f'"integer chains" [{MLT_CHAINS}] "integer mutationsperpixel" '
             f'[{MLT_MPP}] "integer bootstrapsamples" [{MLT_BOOTSTRAP}]')
    p = write_transport_pbrt(out_dir, "mlt", extra)
    imgs = []
    for _ in range(2):
        img, st, launches = timed_render_file(render, counted, p, out_dir / "mlt.pfm",
                                              dev)
        info = dict(mlt.render.info)
        wall = st["phases"]["Rendering"]
        print(render_line(f"mlt main {RES[0]}x{RES[1]}, {MLT_CHAINS} chains, "
                          f"{MLT_MPP} mutations a pixel", st, launches, card)
              + f", b {info['b']:.6f}, chains a depth {info['chains']}, steps "
              f"{info['steps']}, splat rounds {info['splat_rounds']}, image mean "
              f"{float(img.mean()):.6f}", flush=True)
        out["walls"].setdefault("mlt", []).append(wall)
        imgs.append(img)
    check(np.array_equal(imgs[0], imgs[1]), "mlt: a repeat differs")
    out["mlt"] = launches["bvh4_traverse"]
    out["mlt_info"] = info
    rel, corr = mean_corr(block_mean(imgs[0], (16, 16)), block_mean(ref, (16, 16)))
    print(f"mlt against path at 16x16: means differ by {rel:.4f} (bar 0.15), "
          f"correlation {corr:.4f} (bar 0.9); at 400x400 "
          f"{mean_corr(imgs[0], ref)[1]:.4f}", flush=True)
    check(rel < 0.15 and corr > 0.9, f"mlt against path: {rel}, {corr}")
    if profile is not None:
        q = write_transport_pbrt(out_dir / "profile", "mlt", extra.replace(
            f'"integer mutationsperpixel" [{MLT_MPP}]',
            '"integer mutationsperpixel" [1]'))
        setup = parse_pbrt_file(str(q))
        scene = setup.build_scene(dev)
        film_cfg, _ = setup.make_film_config()
        profile_render(lambda: mlt.render(scene, setup.make_camera(), film_cfg, None,
                                          setup.make_integrator_config(),
                                          device=dev),
                       profile.with_name(f"{profile.stem}_mlt{profile.suffix}"),
                       "mlt profile (1 mutation a pixel)")
        del scene
    split["mlt renders"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    small = write_transport_pbrt(
        out_dir, "mlt", '"integer chains" [1024] "integer mutationsperpixel" [1] '
        '"integer bootstrapsamples" [6144]', res=(64, 64), spp=1)
    small.write_text(small.read_text().replace(
        f'"integer maxdepth" [{DEPTH}]', '"integer maxdepth" [2]'))
    a, _ = render.render_file(str(small), out=str(out_dir / "mlt_small_card.pfm"),
                              device=dev)
    b_card = mlt.render.info["b"]
    c0 = time.perf_counter()
    b, _ = render.render_file(str(small), out=str(out_dir / "mlt_small_cpu.pfm"),
                              device="cpu")
    b_cpu = mlt.render.info["b"]
    rel, corr = mean_corr(a, b)
    b_rel = abs(b_card - b_cpu) / max(abs(b_cpu), 1e-12)
    print(f"mlt card against cpu (64x64, depth 2, 1024 chains, the same draws): b "
          f"{b_card:.6f} against {b_cpu:.6f} (rel {b_rel:.2e}, bar 1e-3), means "
          f"differ by {rel:.4f}, correlation {corr:.4f}; the CPU render "
          f"{time.perf_counter() - c0:.2f} s", flush=True)
    check(b_rel <= 1e-3 and rel < 0.15 and corr > 0.9,
          f"mlt card against cpu: b {b_rel}, {rel}, {corr}")
    split["mlt 64x64 copy"] = time.perf_counter() - t0

    # sppm
    t0 = time.perf_counter()
    extra = (f'"integer numiterations" [{SPPM_ITERATIONS}] "integer '
             f'photonsperiteration" [{RES[0] * RES[1]}] "float radius" [{SPPM_RADIUS}]')
    p = write_transport_pbrt(out_dir, "sppm", extra)
    imgs = []
    for _ in range(2):
        img, st, launches = timed_render_file(render, counted, p,
                                              out_dir / "sppm.pfm", dev)
        check(launches["bvh4_traverse"] == SPPM_ITERATIONS * SPPM_LAUNCHES,
              f"sppm: launches {launches}, not {SPPM_ITERATIONS * SPPM_LAUNCHES}")
        info = dict(sppm.render.info)
        wall = st["phases"]["Rendering"]
        n_vp = RES[0] * RES[1] * SPPM_ITERATIONS
        print(render_line(f"sppm main {RES[0]}x{RES[1]}, {SPPM_ITERATIONS} "
                          f"iterations of {RES[0] * RES[1]} photons, radius "
                          f"{SPPM_RADIUS}", st, launches, card)
              + f", wall {wall / SPPM_ITERATIONS:.4f} s an iteration, photons a "
              f"visible point gathers {info['found'] / n_vp:.2f} (of "
              f"{info['pairs'] / n_vp:.1f} tested), gather rounds {info['rounds']}, "
              f"image mean {float(img.mean()):.6f}", flush=True)
        out["walls"].setdefault("sppm", []).append(wall)
        imgs.append(img)
    check(np.array_equal(imgs[0], imgs[1]), "sppm: a repeat differs")
    out["sppm"] = launches["bvh4_traverse"]
    out["sppm_info"] = info
    rel, corr = mean_corr(block_mean(imgs[0], (16, 16)), block_mean(ref, (16, 16)))
    print(f"sppm against path at 16x16: means differ by {rel:.4f} (bar 0.12), "
          f"correlation {corr:.4f} (bar 0.95); at 400x400 "
          f"{mean_corr(imgs[0], ref)[1]:.4f}", flush=True)
    check(rel < 0.12 and corr > 0.95, f"sppm against path: {rel}, {corr}")
    split["sppm renders"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    setup = parse_pbrt_file(str(p))
    scene = setup.build_scene(dev)
    one = dataclasses.replace(setup.make_integrator_config(), n_iterations=1)
    with bvh.record_calls() as captured:
        sppm.render(scene, setup.make_camera(), film_cfg, None, one, device=dev)
    check(len(captured) == SPPM_LAUNCHES,
          f"sppm: one iteration launched {len(captured)} times, not {SPPM_LAUNCHES}")
    # the camera pass launches 2 a bounce, then the photon walk
    transport_batches("sppm", scene, captured, {"photon-walk": 2 * DEPTH},
                      kernels, bvh, out, "photon-walk")
    del captured
    if profile is not None:
        profile_render(lambda: sppm.render(scene, setup.make_camera(), film_cfg, None,
                                           one, device=dev),
                       profile.with_name(f"{profile.stem}_sppm{profile.suffix}"),
                       "sppm profile")
    del scene
    small = write_transport_pbrt(out_dir, "sppm", f'"integer numiterations" [4] '
                                 f'"float radius" [{SPPM_RADIUS}]', res=(64, 64))
    a, b, cpu_s = small_copy(render, small, dev)
    frac, mrel = image_bars(b, a)
    print(f"sppm card against cpu (64x64, 4 iterations): match_frac {frac:.4f}, "
          f"mean rel {mrel:.3e}; the CPU render {cpu_s:.2f} s", flush=True)
    check(frac >= 0.995 and mrel <= 5e-3, f"sppm card against cpu: {frac}, {mrel}")
    split["sppm checks and copy"] = time.perf_counter() - t0
    print("transport phase split, s: "
          + json.dumps({k: round(v, 2) for k, v in split.items()}), flush=True)
    torch.cuda.empty_cache()
    return out


# Phases 10-19 by name: (number, the call on the shared arguments).
LATER = {
    "config3": (10, lambda a: config3_phase(a.render, a.counted, a.card, a.dev,
                                            a.profile)),
    "direct": (11, lambda a: direct_phase(a.render, a.read_pfm, a.counted, a.card,
                                          a.dev)),
    "config4": (12, lambda a: config4_phase(a.render, a.counted, a.card, a.dev,
                                            a.profile)),
    "whitted and ao": (13, lambda a: whitted_ao_phase(a.render, a.counted, a.card,
                                                      a.dev)),
    "breadth": (14, lambda a: breadth_phase(a.render, a.counted, a.card, a.dev,
                                            a.profile)),
    "advanced": (15, lambda a: advanced_phase(a.render, a.counted, a.card, a.dev,
                                              a.profile)),
    "imaging": (16, lambda a: imaging_phase(a.render, a.counted, a.card, a.dev,
                                            a.profile)),
    "grad breadth": (17, lambda a: grad_breadth_phase(a.counted, a.card, a.dev,
                                                      a.profile)),
    "geometry": (18, lambda a: geometry_phase(a.render, a.counted, a.card, a.dev,
                                              a.profile)),
    "transport": (19, lambda a: transport_phase(a.render, a.counted, a.card, a.dev,
                                                a.profile)),
}
# The script is host-bound (a render waits on Python issuing operations, and
# the plain versions and CPU copies run on the host), so phases 10-19 run in
# groups side by side: the first group in this process after phase 9, each
# other in a worker process of its own on the same card, started after phase
# 4 so that phases 3 and 4's kernel times have the card to themselves.  The
# groups are balanced by their seconds when the phases ran one after another
# (PERF.md).  Each process counts its own launches, so a phase's counts stay
# its own.
GROUPS = (("direct", "whitted and ao"), ("transport", "config3"), ("grad breadth",),
          ("geometry", "config4"), ("imaging", "advanced", "breadth"))
WORKER_THREADS = 2  # torch's CPU threads in each process once the workers run
DEADLINE_S = 1100.0  # the workers are stopped, and the script fails, past this


def later_args(card: str, profile: Path | None):
    """What phases 10-19 take: the front end, the counted wrappers, the card."""
    import types

    import torch
    from pbrt_tpu_torch import render
    from pbrt_tpu_torch.ops import bvh
    from pbrt_tpu_torch.tools import bench_layout_probe as bp
    from pbrt_tpu_torch.utils.imageio import read_pfm

    counted = {"bvh4_traverse": bvh.bvh4_traverse,
               "bvh2_traverse": bvh.bvh2_traverse,
               "bvh4_traverse_typed": bvh.bvh4_traverse_typed,
               "chain_fused": bp.chain_fused}
    return types.SimpleNamespace(render=render, read_pfm=read_pfm, counted=counted,
                                 card=card, dev=torch.device("cuda", 0),
                                 profile=profile)


def run_later(names, args) -> dict:
    import torch

    out = {}
    for name in names:
        t0 = time.perf_counter()
        out[name] = LATER[name][1](args)
        phase(name, t0)
        torch.cuda.empty_cache()
    return out


def start_workers(card: str, profile: Path | None) -> list:
    """One process a group of GROUPS but the first, each running
    `chip_smoke.py --worker`, its output written to a log under SMOKE_DIR."""
    SMOKE_DIR.mkdir(parents=True, exist_ok=True)
    workers = []
    for i, names in enumerate(GROUPS[1:], 1):
        log, result = SMOKE_DIR / f"worker{i}.log", SMOKE_DIR / f"worker{i}.pkl"
        result.unlink(missing_ok=True)
        cmd = [sys.executable, str(HERE / "chip_smoke.py"), "--worker", ",".join(names),
               "--result", str(result), "--parent", str(os.getpid()), "--card", card]
        if profile is not None:
            cmd += ["--profile", str(profile)]
        fh = open(log, "w")
        workers.append(dict(names=names, log=log, result=result, fh=fh,
                            t0=time.perf_counter(),
                            proc=subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT,
                                                  stdin=subprocess.DEVNULL, cwd=HERE)))
    return workers


def join_workers(workers, deadline: float) -> dict:
    """Wait for every worker; fail at the first that fails or at the deadline.
    Prints each worker's log, in the order of its first phase, and returns
    the phases' results."""
    import pickle

    running = list(workers)
    while running:
        for w in list(running):
            rc = w["proc"].poll()
            if rc is None:
                continue
            running.remove(w)
            w["wall"] = time.perf_counter() - w["t0"]
            w["fh"].close()
            if rc != 0:
                text = w["log"].read_text()
                print(text, end="", flush=True)
                failed = [ln for ln in text.splitlines() if ln.strip()][-1:] or [""]
                raise SmokeFailure(f"phases {', '.join(w['names'])} (exit code {rc}): "
                                   f"{failed[0]}")
        if running and time.perf_counter() > deadline:
            raise SmokeFailure("phases " + "; ".join(", ".join(w["names"]) for w in running)
                               + f" still running after {DEADLINE_S:.0f} s")
        time.sleep(0.5)
    out = {}
    for w in sorted(workers, key=lambda w: min(LATER[n][0] for n in w["names"])):
        print(f"worker ({', '.join(w['names'])}): {w['wall']:.2f} s, its output:",
              flush=True)
        print(w["log"].read_text(), end="", flush=True)
        with open(w["result"], "rb") as fh:
            out.update(pickle.load(fh))
    return out


def stop_workers(workers):
    for w in workers:
        if w["proc"].poll() is None:
            w["proc"].kill()
        w["proc"].wait()
        w["fh"].close()


def worker_main(names, result: Path, parent: int, card: str,
                profile: Path | None) -> int:
    """A worker: runs phases `names`, pickles their results to `result`."""
    import ctypes
    import pickle
    import signal

    # killed when the parent ends, whichever way it ends (PR_SET_PDEATHSIG)
    ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)
    if os.getppid() != parent:
        return 1
    import torch

    sys.path.insert(0, str(HERE))
    torch.set_num_threads(WORKER_THREADS)
    try:
        out = run_later(names, later_args(card, profile))
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", flush=True)
        return 1
    tmp = result.with_suffix(".tmp")
    with open(tmp, "wb") as fh:
        pickle.dump(out, fh)
    os.replace(tmp, result)
    return 0


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
               "bvh4_traverse_typed": bvh.bvh4_traverse_typed,
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

    # phases 10-19: GROUPS[1:] in workers from here on, GROUPS[0] here after 9
    workers = start_workers(card, profile)
    try:
        torch.set_num_threads(WORKER_THREADS)
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
        check(launches["bvh2_traverse"] == 0 and launches["bvh4_traverse_typed"] == 0,
              "main path launched bvh2 or the typed build")
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

        # GROUPS[0] here, then the workers' results
        args = later_args(card, profile)
        later = run_later(GROUPS[0], args)
        later.update(join_workers(workers, t_all + DEADLINE_S))
    finally:
        stop_workers(workers)
    c3, dl, c4, wa, br, adv, img16, gb, geo, tr = (later[n] for n in LATER)

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
                   + list(br["results"][kind].values())
                   + list(adv["results"][kind].values())
                   + list(img16["results"][kind].values())
                   + list(geo["results"].get(kind, {}).values())
                   + list(tr["results"][kind].values()))
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
            "advanced_launches": adv[kind],
            **{f"advanced_{label.replace('-', '_')}_{key}": r[key]
               for label, r in adv["results"][kind].items()
               for key in ("ms", "plain_ms", "bound_ms", "live_rays")},
            "imaging_launches": img16[kind],
            "grad_breadth_launches": gb[kind],
            **{f"imaging_{label}_camera_{key}": r[key]
               for label, r in img16["results"][kind].items()
               for key in ("ms", "plain_ms", "bound_ms", "live_rays")},
            "bdpt_launches": tr["bdpt"] if kind == "bvh4" else 0,
            "mlt_launches": tr["mlt"] if kind == "bvh4" else 0,
            "sppm_launches": tr["sppm"] if kind == "bvh4" else 0,
            **{f"{label.replace('-', '_')}_{key}": r[key]
               for label, r in tr["results"][kind].items()
               for key in ("ms", "plain_ms", "bound_ms", "live_rays")},
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
    entries[0]["geometry_launches"] = geo["launches"]["geometry"]["bvh4_traverse"]
    entries[0]["geometry_grad_launches"] = geo["grad"]["geometry"]
    for label, r in geo["results"]["bvh4"].items():
        for key in ("ms", "plain_ms", "bound_ms", "live_rays"):
            entries[0][f"geometry_{label.replace('-', '_')}_{key}"] = r[key]
    typed = geo["results"]["typed"]
    tn = typed["merged-b0"]
    entries.append({
        "name": "bvh4_traverse_typed", "route": "cuda",
        "source": "pbrt_tpu_torch/csrc/bvh4_traverse.cu",
        "replaces": "pbrt_tpu/ops/pallas_bvh.py:382 (_make_kernel4, pallas_call "
                    "at :632), with the leaf tests of pbrt_tpu/accel/traverse.py:41-131 "
                    "that the JAX package runs past its gate",
        "launches": geo["launches"]["instances"]["bvh4_traverse_typed"],
        "grad_launches": geo["grad"]["instances"],
        "max_abs_err": max(r["max_abs_err"] for r in typed.values()),
        "mismatch_frac": max(r["mismatch_frac"] for r in typed.values()),
        "ms": tn["ms"], "plain_ms": tn["plain_ms"], "bound_ms": tn["bound_ms"],
        "bound_by": tn["bound_by"], "library_ms": None,
        "visit_bound_ms": tn["visit_bound_ms"],
        **{f"instances_{label.replace('-', '_')}_{key}": r[key]
           for label, r in typed.items()
           for key in ("ms", "plain_ms", "bound_ms", "live_rays")},
        "ms_per_spp": sum(r["ms"] for r in typed.values()),
        "tests_by_type_b0": tn["tests_by_type"],
        "shape": f"{tn['rays']} rays (the instances file's bounce-0 merged "
                 "NEE batch, any-hit shadow lanes as launched)",
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
    # a worker of run(), started by it: phases of GROUPS, its result pickled
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--result", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--parent", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--card", help=argparse.SUPPRESS)
    args = ap.parse_args()
    try:
        import torch  # noqa: F401
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if args.worker:
        return worker_main(args.worker.split(","), args.result, args.parent, args.card,
                           args.profile)
    try:
        result = run(profile=args.profile)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
