"""Stochastic progressive photon mapping.

Port of pbrt_tpu/integrators/sppm.py (integrators/sppm.cpp).  An
iteration:
  1. camera pass (_camera_pass, sppm.cpp:135-239): each pixel's walk to
     its first non-specular hit, the visible point, with direct light by
     NEE at every vertex on the way; halton with n_iterations as its spp;
  2. photon pass (_photon_pass, sppm.cpp:303-415): Sample_Le light rays
     walked max_depth bounces with Russian roulette on the photon weight;
     every surface hit after the first is a photon;
  3. gather (_gather): each visible point sums f * beta over the photons
     within its current radius in the 27 grid cells around it;
  4. the radius and flux update (sppm.cpp:417-443).
The image is Ld / iterations + tau / (photons * pi r^2) (sppm.cpp:445-466),
times the film's scale (the JAX package's SPPM ignores the scale).

The grid is the JAX package's: a static uniform grid of cell size twice
the initial radius, hashed into 2^18 buckets (sppm.cpp:77-82's hash), the
photons sorted by bucket.  Its gather scans the 27 buckets' sorted
segments in a loop to the longest segment; the port expands the (visible
point, photon) pairs of those segments instead, in bounded chunks, tests
the same radius, evaluates the BSDF on the photons within it only, and
adds each visible point's photons in the JAX loop's order (neighbour cell,
then position in the bucket), one index_add_ round per rank.  A
neighbour cell that hashes to the bucket of another is counted twice, as
there.  Photons that hit nothing (the JAX package parks them at 1e18,
past every radius) are left out of the grid.

The photon pass's random draws are the port's own: a CPU torch.Generator
an iteration (seeded by the seed and the iteration), moved to the device;
_photon_pass takes them as tensors (tests/test_torch_mlt_sppm.py feeds it
the JAX package's).

Traversal launches an iteration: 2 a camera-pass bounce (the closest hit
and the NEE's shadow and MIS rays) and 1 a photon bounce: 3 max_depth.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch.profiler import record_function

from .. import film as fm
from ..accel import traverse as tv
from ..cameras import generate_rays
from ..core import sampling as smp
from ..core.vecmath import absdot, dot, offset_ray_origin
from ..lights import lights as lt
from ..materials import bsdf as bx
from ..samplers import samplers as sa
from ..scene import MAT_GLASS, MAT_MIRROR, SceneArrays, resolve_device
from ..utils import stats as st
from . import bdpt as bd
from . import common

HASH_BITS = 18
N_CELLS = 1 << HASH_BITS
PAIR_CHUNK = 1 << 22  # (visible point, photon) pairs a gather chunk


@dataclasses.dataclass(frozen=True)
class SPPMConfig:
    """pbrt's SPPMIntegrator parameters (sppm.cpp:468-485), the JAX
    package's defaults; photons_per_iteration -1 is the pixel count."""
    max_depth: int = 5
    n_iterations: int = 16
    photons_per_iteration: int = -1
    initial_radius: float = 1.0
    alpha: float = 0.6666667  # 2/3 (sppm.cpp:420)


def hash_cell(ix, iy, iz):
    """sppm.cpp:77-82: a grid cell's bucket in [0, N_CELLS)."""
    m = 0xFFFFFFFF
    h = (((ix & m) * 73856093) & m) ^ (((iy & m) * 19349663) & m) \
        ^ (((iz & m) * 83492791) & m)
    return h & (N_CELLS - 1)


def cell_of(p, inv_cell: float):
    """The integer grid cell of points p [n, 3] (int64)."""
    return torch.floor(p * inv_cell).to(torch.int32).to(torch.int64)


def camera_pass(scene, camera, pixels, s_cfg, sample_num: int, cfg: SPPMConfig,
                counters):
    """The visible points and the direct light Ld [n, 3] of one sample a
    pixel (sppm.cpp:135-239)."""
    n = pixels.shape[0]
    dev = pixels.device
    state = sa.init_state(s_cfg, pixels, torch.full((n,), sample_num,
                                                    dtype=torch.int64, device=dev))
    p_film, tu, pl = sa.get_camera_sample(s_cfg, state, pixels)
    o, d, _, _ = generate_rays(camera, p_film, pl, tu)
    beta = torch.ones((n, 3), dtype=torch.float32, device=dev)
    Ld = torch.zeros_like(beta)
    z3 = torch.zeros_like(beta)
    vp = {"exists": torch.zeros(n, dtype=torch.bool, device=dev), "p": z3,
          "wo": z3, "beta": z3, "ns": z3, "dpdu": z3, "ss": z3,
          "mat_id": torch.full((n,), -1, dtype=torch.int32, device=dev),
          "uv": torch.zeros((n, 2), dtype=torch.float32, device=dev)}
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    specular = torch.ones_like(alive)
    dim = 5
    st.bump(counters, "Integrator/Camera rays traced", float(n))
    for _ in range(cfg.max_depth):
        t, prim = bd.trace(scene, o, d, alive, counters)
        rec = tv.hit_record(scene, o, d, t, prim)
        found = rec["hit"] & alive & (rec["material"] >= 0)
        le = lt.area_light_emission(scene, rec["arealight"], rec["ng"], rec["wo"])
        Ld = Ld + torch.where((found & specular)[:, None], beta * le, 0.0)
        mat = bd.gather_vertex_material(scene, rec["material"], rec["uv"])
        frame = bx.frame_from_rec(rec)
        ss, ts, ns = frame
        wo_l = bx.to_local(ss, ts, ns, rec["wo"])
        # NEE at every vertex (sppm.cpp:175-183)
        u_sel = sa.get_1d(s_cfg, state, dim)
        u_li = sa.get_2d(s_cfg, state, dim + 1)
        u_sc = sa.get_2d(s_cfg, state, dim + 3)
        dim += 5
        st.bump(counters, "Intersections/Shadow ray intersection tests",
                2.0 * found.to(torch.float64).sum())
        ld, _ = common.sample_one_light(scene, rec, frame, mat, wo_l, u_sel, u_li,
                                        u_sc, found)
        Ld = Ld + torch.where(found[:, None], beta * ld, 0.0)
        # a non-specular hit is the visible point; a specular one goes on
        mt = mat["type"]
        is_spec = (mt == MAT_MIRROR) | ((mt == MAT_GLASS) & ~mat["is_rough"])
        make_vp = found & ~is_spec & ~vp["exists"]
        mv = make_vp[:, None]
        for k in ("p", "wo", "ns", "dpdu", "ss", "uv"):
            vp[k] = torch.where(mv, rec[k], vp[k])
        vp["beta"] = torch.where(mv, beta, vp["beta"])
        vp["mat_id"] = torch.where(make_vp, rec["material"], vp["mat_id"])
        vp["exists"] = vp["exists"] | make_vp
        u_b = sa.get_2d(s_cfg, state, dim)
        dim += 2
        bs = bx.sample_material(mat, wo_l, u_b, scene.mat_types)
        wi_w = bx.to_world(ss, ts, ns, bs["wi"])
        cont = found & is_spec & bs["valid"]
        beta = torch.where(
            cont[:, None],
            beta * bs["f"] * (absdot(wi_w, ns)
                              / torch.clamp(bs["pdf"], min=1e-20))[:, None],
            beta)
        specular = cont
        alive = cont
        o = offset_ray_origin(rec["p"], rec["p_error"], rec["ng"], wi_w)
        d = wi_w
    return vp, Ld


def photon_draws(seed: int, it: int, n_photons: int, max_depth: int, device):
    """An iteration's photon draws: u [n, 5 + 2 max_depth] (light pick,
    position, direction, each bounce's BSDF sample) and the Russian
    roulette uniforms [max_depth, n], from a CPU torch.Generator."""
    g = torch.Generator().manual_seed((seed * 1_000_003 + 7919 * it + 1) & 0x7FFFFFFF)
    u = torch.rand((n_photons, 5 + 2 * max_depth), generator=g)
    u_rr = torch.rand((max_depth, n_photons), generator=g)
    return u.to(device), u_rr.to(device)


def photon_pass(scene, u, u_rr, cfg: SPPMConfig, counters):
    """The photon walks (sppm.cpp:303-415): (p, wo, beta) of every photon
    hit after the first bounce, [(max_depth - 1) n, 3] each, bounce-major;
    a lane with no hit has p = 1e18 and beta 0."""
    light_idx, pmf = smp.sample_discrete_1d(scene.light_distr, u[:, 0])
    le = lt.sample_le(scene, light_idx, u[:, 1:3], u[:, 3:5], scene.light_types)
    denom = torch.clamp(pmf * le["pdf_pos"] * le["pdf_dir"], min=1e-20)
    beta = le["le"] * (torch.abs(dot(le["n_light"], le["d"])) / denom)[:, None]
    o = le["o"] + le["n_light"] * 1e-4
    d = le["d"]
    alive = torch.any(beta > 0.0, -1)
    hits_p, hits_wo, hits_beta = [], [], []
    for b in range(cfg.max_depth):
        t, prim = bd.trace(scene, o, d, alive, counters)
        rec = tv.hit_record(scene, o, d, t, prim)
        found = rec["hit"] & alive & (rec["material"] >= 0)
        # photons deposit after the first bounce: the camera pass' NEE
        # takes direct light (sppm.cpp:352-358)
        if b > 0:
            hits_p.append(torch.where(found[:, None], rec["p"], 1e18))
            hits_wo.append(rec["wo"])
            hits_beta.append(torch.where(found[:, None], beta, 0.0))
        if b == cfg.max_depth - 1:
            break
        mat = bd.gather_vertex_material(scene, rec["material"], rec["uv"])
        ss, ts, ns = bx.frame_from_rec(rec)
        wo_l = bx.to_local(ss, ts, ns, rec["wo"])
        bs = bx.sample_material(mat, wo_l, u[:, 5 + 2 * b: 7 + 2 * b],
                                scene.mat_types)
        wi_w = bx.to_world(ss, ts, ns, bs["wi"])
        bnew = beta * bs["f"] * (absdot(wi_w, ns)
                                 / torch.clamp(bs["pdf"], min=1e-20))[:, None]
        # Russian roulette on the photon's weight (sppm.cpp:389-397)
        q = torch.clamp(1.0 - torch.amax(bnew, -1)
                        / torch.clamp(torch.amax(beta, -1), min=1e-12), min=0.0)
        die = u_rr[b] < q
        beta = torch.where(die[:, None], 0.0,
                           bnew / torch.clamp(1.0 - q, min=1e-6)[:, None])
        alive = found & bs["valid"] & ~die
        o = offset_ray_origin(rec["p"], rec["p_error"], rec["ng"], wi_w)
        d = wi_w
    if not hits_p:
        z = torch.zeros((1, 3), dtype=torch.float32, device=u.device)
        return {"p": z + 1e18, "wo": z, "beta": z}
    return {"p": torch.cat(hits_p), "wo": torch.cat(hits_wo),
            "beta": torch.cat(hits_beta)}


def gather(scene, vp, radius, photons, inv_cell: float, info: dict | None = None):
    """Each visible point's photon flux Phi [n, 3] and count M [n] over the
    photons within radius [n] in its 27 neighbour cells (sppm.py:224-275),
    summed in the JAX loop's order.  info, when given, gets the pairs
    tested, the photons found and the index_add_ rounds."""
    n = vp["p"].shape[0]
    dev = vp["p"].device
    live = photons["p"][:, 0] < 1e17  # a photon that hit a surface
    ph_p = photons["p"][live]
    ph_wo = photons["wo"][live]
    ph_b = photons["beta"][live]
    cid = hash_cell(*cell_of(ph_p, inv_cell).unbind(-1))
    cid_s, order = torch.sort(cid, stable=True)
    p_s, wo_s, b_s = ph_p[order], ph_wo[order], ph_b[order]
    vcell = cell_of(vp["p"], inv_cell)
    offs = torch.tensor([(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                         for dz in (-1, 0, 1)], dtype=torch.int64, device=dev)
    nb = vcell[:, None, :] + offs[None]  # [n, 27, 3]
    ncid = hash_cell(nb[..., 0], nb[..., 1], nb[..., 2]).contiguous()
    start = torch.searchsorted(cid_s, ncid, side="left")
    count = torch.searchsorted(cid_s, ncid, side="right") - start
    count = torch.where(vp["exists"][:, None], count, 0)
    per_vp = count.sum(1).cpu()
    Phi = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    M = torch.zeros(n, dtype=torch.float32, device=dev)
    frame = bx.frame_from_rec(vp)
    wo_l = bx.to_local(*frame, vp["wo"])
    r2 = radius * radius
    stats = {"pairs": 0, "found": 0, "rounds": 0}
    v0 = 0
    bounds = torch.cumsum(per_vp, 0)
    while v0 < n:
        # the visible points [v0, v1) hold at most PAIR_CHUNK pairs (or one)
        base = int(bounds[v0 - 1]) if v0 else 0
        v1 = int(torch.searchsorted(bounds, base + PAIR_CHUNK, right=True))
        v1 = min(max(v1, v0 + 1), n)
        n_pairs = int(bounds[v1 - 1]) - base
        if n_pairs:
            c = count[v0:v1].reshape(-1)
            entry = torch.repeat_interleave(torch.arange(c.shape[0], device=dev), c,
                                            output_size=n_pairs)
            first = torch.cumsum(c, 0) - c
            ph = start[v0:v1].reshape(-1)[entry] + (
                torch.arange(n_pairs, device=dev) - first[entry])
            vi = v0 + torch.div(entry, 27, rounding_mode="floor")
            dd = vp["p"][vi] - p_s[ph]
            near = torch.sum(dd * dd, -1) <= r2[vi]
            vi, ph = vi[near], ph[near]
            mat = bd.gather_vertex_material(scene, vp["mat_id"][vi], vp["uv"][vi])
            ss, ts, ns = (x[vi] for x in frame)
            f, _ = bx.eval_material(mat, wo_l[vi], bx.to_local(ss, ts, ns, wo_s[ph]),
                                    scene.mat_types)
            stats["rounds"] += fm.ordered_index_add(vi, [(Phi, f * b_s[ph])])
            M += torch.bincount(vi, minlength=n).to(torch.float32)
            stats["pairs"] += n_pairs
            stats["found"] += int(vi.shape[0])
        v0 = v1
    if info is not None:
        for k, v in stats.items():
            info[k] = info.get(k, 0) + v
    return Phi, M


def update(radius, n_vp, tau, vp_beta, Phi, M, alpha: float):
    """The SPPM update (sppm.cpp:417-443): (radius, N, tau)."""
    has = M > 0
    n_new = n_vp + alpha * M
    r_new = torch.where(has, radius * torch.sqrt(
        n_new / torch.clamp(n_vp + M, min=1e-6)), radius)
    tau_new = torch.where(
        has[:, None],
        (tau + vp_beta * Phi) * (r_new * r_new
                                 / torch.clamp(radius * radius, min=1e-12))[:, None],
        tau)
    return r_new, torch.where(has, n_new, n_vp), tau_new


def render(scene: SceneArrays, camera, film_cfg: fm.FilmConfig, sampler_cfg=None,
           cfg: SPPMConfig = SPPMConfig(), filt=None, count_rays: bool = False,
           stats_out: bool = False, progress=None, device="cuda", seed: int = 0,
           info: dict | None = None):
    """SPPMIntegrator::Render (sppm.cpp:111-466).  The camera pass draws
    from halton with n_iterations samples a pixel whatever sampler_cfg
    says; filt is not read (each pixel's own sample); the exact sampler
    mode raises.  Runs on the card unless device="cpu", with the scene
    already there.  info (render.info after the call) gets the gather's
    pairs, photons found and index_add_ rounds, summed over iterations.  Returns the image
    [H, W, 3] (and the rays or counters as path.render)."""
    from .path import make_pixel_grid

    device = resolve_device(device)
    if scene.device != device:
        raise ValueError(f"scene is on {scene.device}, render asked for {device}")
    bd.check_transport_scene("sppm", scene, None, sampler_cfg)
    camera = camera.to(device)
    res = tuple(film_cfg.full_resolution)
    xr, yr = res
    pixels = torch.as_tensor(make_pixel_grid(film_cfg), device=device)
    n = pixels.shape[0]
    n_photons = cfg.photons_per_iteration if cfg.photons_per_iteration > 0 else n
    s_cfg = sa.SamplerConfig("halton", max(cfg.n_iterations, 1), res)
    inv_cell = 1.0 / (2.0 * cfg.initial_radius)
    counters = st.zeros(device)
    info = {} if info is None else info
    render.info = info
    radius = torch.full((n,), cfg.initial_radius, dtype=torch.float32, device=device)
    n_vp = torch.zeros(n, dtype=torch.float32, device=device)
    tau = torch.zeros((n, 3), dtype=torch.float32, device=device)
    Ld_sum = torch.zeros_like(tau)
    with torch.no_grad():
        for it in range(cfg.n_iterations):
            with record_function("layer: sppm / camera pass"):
                vp, Ld = camera_pass(scene, camera, pixels, s_cfg, it, cfg, counters)
            with record_function("layer: sppm / photon pass"):
                u, u_rr = photon_draws(seed, it, n_photons, cfg.max_depth, device)
                photons = photon_pass(scene, u, u_rr, cfg, counters)
            with record_function("layer: sppm / gather"):
                Phi, M = gather(scene, vp, radius, photons, inv_cell, info)
            radius, n_vp, tau = update(radius, n_vp, tau, vp["beta"], Phi, M,
                                       cfg.alpha)
            Ld_sum = Ld_sum + Ld
        np_total = cfg.n_iterations * n_photons
        L = Ld_sum / cfg.n_iterations + tau / (
            np_total * math.pi * torch.clamp(radius * radius, min=1e-12))[:, None]
        img = torch.zeros((yr, xr, 3), dtype=torch.float32, device=device)
        img[pixels[:, 1].long(), pixels[:, 0].long()] = L
        img = img * film_cfg.scale
    if stats_out:
        return img, counters
    if count_rays:
        return img, st.ray_total(counters)
    return img
