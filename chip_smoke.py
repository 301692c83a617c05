#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (pbrt_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--profile FILE]

Phases, each printing its result on a line of its own:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: csrc/bvh4_traverse.cu (nvcc, sm_90a) and the host BVH builder
     (g++), both compilers started together, into build/;
  3. kernel: bvh4_traverse held against its plain PyTorch version on the
     card, on a 200-triangle soup, on a ~1M-triangle mesh with 64k rays, and
     on every launch of one sample of the main path (its camera rays and
     each bounce's merged NEE batch, timed with its any-hit shadow lanes as
     the render launches it); each with two floors, the bytes of one read
     of the tables and rays, and the bytes of every node and triangle visit;
  4. main path: pbrt_tpu_torch.integrators.path.render on a 400x400, 8 spp,
     depth-5 scene of ~262k triangles (halton sampler, box filter): finite,
     non-zero, 8 x (1 + 5) kernel launches, and a bit-identical repeat;
     with --profile FILE, one more sample under torch.profiler, its
     table of device operations written to FILE;
  5. card against CPU: a small scene rendered on the card and on the CPU
     (the plain versions) at depth 1 (per pixel) and depth 3 (image mean);
then a JSON line listing each kernel, and last the JSON result line.  A
failed phase raises, so the script exits non-zero and prints no result.  It
needs the repository beside it and a CUDA card; it does not use JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores
NODE_FLOPS = 4 * 27  # per 4-wide node visit: 4 slab tests
TRI_FLOPS = 45  # per Moller-Trumbore test


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str):
    if not ok:
        raise SmokeFailure(what)


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


# ---------------------------------------------------------------------------
# Kernel against plain
# ---------------------------------------------------------------------------

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


def kernel_case(name, bvh, scene, o, d, t_max, any_mask, timed: str):
    """Hold the kernel against the plain version on one ray batch (with and
    without the any-hit mask); returns its measurements.  timed = "mask"
    times and counts the launch with the any-hit mask (as the main path
    launches its merged batches), "closest" without it."""
    import torch

    n = o.shape[0]
    dev = o.device
    zeros = torch.zeros(n, dtype=torch.float32, device=dev)
    mode = any_mask.to(torch.float32)
    timed_mode = {"mask": mode, "closest": zeros}[timed]
    args = (scene.bvh4_nodes, scene.prim_tris, o, d, t_max)
    saved = bvh.bvh4_traverse.launches
    t_k, p_k = bvh.bvh4_traverse(*args, zeros, scene.bvh4_depth)
    tm_k, pm_k = bvh.bvh4_traverse(*args, mode, scene.bvh4_depth)
    t_p, p_p = bvh.bvh4_traverse_plain(*args, zeros)
    tm_p, pm_p = bvh.bvh4_traverse_plain(*args, mode)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, visits, tests = bvh.bvh4_traverse_plain(*args, timed_mode,
                                                  return_counts=True)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    ms = time_cuda(lambda: bvh.bvh4_traverse(*args, timed_mode, scene.bvh4_depth), 10)
    bvh.bvh4_traverse.launches = saved  # comparison launches do not count

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
    check(hit_agree >= 0.999, f"{name}: hit agreement {hit_agree}")
    check(prim_agree >= 0.999, f"{name}: prim agreement {prim_agree}")
    check(t_rel <= 1e-5, f"{name}: t rel err {t_rel}")
    check(occ_ok, f"{name}: any-hit occlusion differs from the closest hit")
    check(free_ok, f"{name}: unflagged lanes changed under the any-hit mask")
    node_v = int(visits.sum())
    prim_t = int(tests.sum())
    # Two floors.  bound_ms: each input read once and each output written
    # once (the node and triangle tables, 40 B per ray), against the
    # operations this run's visits need.  visit_bound_ms: every node visit
    # and triangle test read from device memory, as if nothing stayed in L2.
    table_bytes = scene.bvh4_nodes.nbytes + scene.prim_tris.nbytes
    t_bytes = (table_bytes + n * bvh.RAY_BYTES) / H100_BYTES_PER_S * 1e3
    t_ops = (node_v * NODE_FLOPS + prim_t * TRI_FLOPS) / H100_F32_FLOPS * 1e3
    visit_bytes = node_v * bvh.NODE_BYTES + prim_t * bvh.PRIM_BYTES + n * bvh.RAY_BYTES
    out = dict(case=name, rays=n, timed=timed, hit_agree=hit_agree,
               prim_agree=prim_agree, t_rel_err=t_rel, max_abs_err=max_abs,
               mismatch_frac=1.0 - (hk == hp).float().mean().item()
               + (both & ~same).float().mean().item(),
               ms=ms, plain_ms=plain_ms, node_visits_per_ray=node_v / n,
               tri_tests_per_ray=prim_t / n, table_mb=table_bytes / 1e6,
               bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               visit_bound_ms=visit_bytes / H100_BYTES_PER_S * 1e3)
    print("kernel-check " + json.dumps(out), flush=True)
    return out


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


def profile_render(scene, camera, film_cfg, cfg, res, table_path: Path):
    """One spp of the main path under torch.profiler: the device's busy
    time against the wall, the port's "layer: ..." ranges (around the calls
    into each layer; inclusive of the layers they call), and the top device
    operations, written to table_path."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pbrt_tpu_torch.integrators import path
    from pbrt_tpu_torch.samplers.samplers import SamplerConfig

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        path.render(scene, camera, film_cfg, SamplerConfig("halton", 1, res), cfg)
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
    print(f"profile (1 spp, profiler on): wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.3f}, "
          f"{sum(e.count for e in on_card)} device operations", flush=True)
    kern = [e for e in on_card if "bvh4_traverse" in e.key]
    print(f"profile kernel in the render: {sum(e.count for e in kern)} launches, "
          f"device {sum(getattr(e, key) for e in kern) / 1e3:.4f} ms", flush=True)
    for e in spans:
        if e.device_type == DeviceType.CPU:
            print(f"profile {e.key}: {e.count} calls, host {e.cpu_time_total / 1e3:.1f} ms, "
                  f"device busy {getattr(e, total_key) / 1e3:.2f} ms", flush=True)


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------

def run(profile: Path | None = None) -> dict:
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false")
    if not (HERE / "pbrt_tpu_torch" / "csrc" / "bvh4_traverse.cu").exists():
        raise SmokeFailure("pbrt_tpu_torch/ is not beside chip_smoke.py")
    sys.path.insert(0, str(HERE))
    from pbrt_tpu_torch import cameras, native
    from pbrt_tpu_torch import scene as sc
    from pbrt_tpu_torch.core import transform as tf
    from pbrt_tpu_torch.film import FilmConfig
    from pbrt_tpu_torch.integrators import path
    from pbrt_tpu_torch.ops import bvh
    from pbrt_tpu_torch.samplers.samplers import SamplerConfig

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else name
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    native.build()
    print(f"build: bvh4_traverse.cu + bvh_builder.cpp in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # 3. kernel against plain
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
        kernel_case(label, bvh, soup,
                    torch.as_tensor(oo, device=dev).contiguous(),
                    torch.as_tensor(dd, device=dev).contiguous(), tmax, mask,
                    timed="closest")

    t0 = time.perf_counter()
    big = sc.SceneBuilder()
    m = big.add_material(sc.MAT_MATTE)
    idx, v = blob_mesh(1024, 512, seed=5, center=(0.0, 0.0, 0.0), radius=3.0)
    big.add_triangle_mesh(idx, v, material=m)
    big.add_point_light(tf.translate(0, 0, 10), (1, 1, 1))
    big = big.build(device=dev)
    big_build_s = time.perf_counter() - t0
    print(f"mesh-1M: {idx.shape[0]} triangles, {big.bvh4_nodes.shape[0]} "
          f"4-wide nodes, depth {big.bvh4_depth}, host build {big_build_s:.2f} s",
          flush=True)
    o_b, d_b = mesh_rays(rs, 65536, (0.0, 0.0, 0.0), 3.0, dev)
    kernel_case("mesh1M-64k", bvh, big, o_b, d_b,
                torch.full((65536,), 1e30, device=dev), mask, timed="closest")
    del big

    # main scene: capture the kernel's inputs on one sample of the main path
    # (the camera rays, then each bounce's merged [shadow | MIS | extension]
    # batch, whose dead lanes carry t_max = 0)
    res = (400, 400)
    spp, depth = 8, 5
    t0 = time.perf_counter()
    scene = main_scene(sc.SceneBuilder, sc, tf).build(device=dev)
    torch.cuda.synchronize()
    host_build_s = time.perf_counter() - t0
    n_tris = int((scene.prim_tris[:, 3] == 0).sum())
    print(f"main scene: {n_tris} triangles, host build {host_build_s:.2f} s",
          flush=True)
    camera = camera_for(cameras, tf, res)
    film_cfg = FilmConfig(full_resolution=res)
    cfg = path.PathConfig(max_depth=depth)
    with bvh.record_calls() as captured:
        path.render(scene, camera, film_cfg, SamplerConfig("halton", 1, res), cfg)
    check(len(captured) == 1 + depth,
          f"one sample launched the kernel {len(captured)} times, not {1 + depth}")
    labels = ["main-camera"] + [f"main-nee-merged-b{b}" for b in range(depth)]
    results = {}
    for label, (oc, dc, tc, mc) in zip(labels, captured):
        results[label] = kernel_case(label, bvh, scene, oc, dc, tc, mc > 0,
                                     timed="mask")
    del captured
    kernel_ms_per_spp = sum(r["ms"] for r in results.values())
    plain_ms_per_spp = sum(r["plain_ms"] for r in results.values())
    bound_ms_per_spp = sum(r["bound_ms"] for r in results.values())
    visit_bound_ms_per_spp = sum(r["visit_bound_ms"] for r in results.values())

    # 4. main path, through the entry point a user calls
    sampler = SamplerConfig("halton", spp, res)
    bvh.bvh4_traverse.launches = 0
    torch.cuda.synchronize()
    t0, c0 = time.perf_counter(), time.process_time()
    img, rays = path.render(scene, camera, film_cfg, sampler, cfg,
                            count_rays=True)
    torch.cuda.synchronize()
    wall, cpu = time.perf_counter() - t0, time.process_time() - c0
    launches = bvh.bvh4_traverse.launches
    check(launches == spp * (1 + depth),
          f"main path launched the kernel {launches} times, not {spp * (1 + depth)}")
    check(tuple(img.shape) == (res[1], res[0], 3), f"image shape {tuple(img.shape)}")
    check(bool(torch.isfinite(img).all()), "image has non-finite values")
    check(float(img.mean()) > 0.0, "image is black")
    t0, c0 = time.perf_counter(), time.process_time()
    img2 = path.render(scene, camera, film_cfg, sampler, cfg)
    torch.cuda.synchronize()
    wall2, cpu2 = time.perf_counter() - t0, time.process_time() - c0
    check(torch.equal(img, img2), "a second render differs")
    print(f"main path: {res[0]}x{res[1]} @ {spp} spp, depth {depth}: "
          f"{wall:.3f} s wall ({wall2:.3f} s the repeat), {int(rays)} rays, "
          f"{rays / wall / 1e6:.3f} Mrays/s, "
          f"{launches} kernel launches, host build {host_build_s:.2f} s, "
          f"image mean {float(img.mean()):.6f}, repeat bit-identical", flush=True)
    # host CPU time of this process beside the wall: near the wall when the
    # render waits on the host issuing operations, not on the card
    print(f"main path host: process CPU {cpu:.3f} s ({cpu2:.3f} s the repeat), "
          f"{len(os.sched_getaffinity(0))} cores, load average "
          f"{os.getloadavg()[0]:.2f}", flush=True)
    print(f"main path kernel time: {kernel_ms_per_spp:.4f} ms per spp "
          f"(bound {bound_ms_per_spp:.4f} ms, visit bound "
          f"{visit_bound_ms_per_spp:.4f} ms, plain {plain_ms_per_spp:.1f} ms), "
          f"{kernel_ms_per_spp * spp / (wall * 1e3):.4%} of the render's wall",
          flush=True)
    if profile is not None:
        profile_render(scene, camera, film_cfg, cfg, res, profile)
    del scene, img, img2

    # 5. card against CPU on the small demo scene
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

    # 6. the kernels line
    nee = results["main-nee-merged-b0"]
    worst = max(r["mismatch_frac"] for r in results.values())
    print(json.dumps({"kernels": [{
        "name": "bvh4_traverse",
        "route": "cuda",
        "source": "pbrt_tpu_torch/csrc/bvh4_traverse.cu",
        "replaces": "pbrt_tpu/ops/pallas_bvh.py:382 (_make_kernel4, "
                    "pallas_call at :632)",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in results.values()),
        "mismatch_frac": worst,
        "ms": nee["ms"],
        "plain_ms": nee["plain_ms"],
        "bound_ms": nee["bound_ms"],
        "bound_by": nee["bound_by"],
        "library_ms": None,
        "visit_bound_ms": nee["visit_bound_ms"],
        "shape": f"{nee['rays']} rays (the main path's bounce-0 merged NEE "
                 "batch, any-hit shadow lanes as launched)",
        "ms_per_spp": kernel_ms_per_spp,
        "bound_ms_per_spp": bound_ms_per_spp,
        "visit_bound_ms_per_spp": visit_bound_ms_per_spp,
    }]}), flush=True)
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
