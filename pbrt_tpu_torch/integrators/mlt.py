"""Metropolis light transport (PSSMLT over BDPT).

Port of pbrt_tpu/integrators/mlt.py (integrators/mlt.{h,cpp}): each lane
is one Markov chain over a primary-sample vector, a row of X [C, D]; the
BDPT target function reads the row through the "pss" sampler, so L(X)
reuses integrators/bdpt.py whole.

As in the JAX package: L(X) sums every strategy of the chain's depth
(pbrt picks one a mutation: the same expectation, lower variance); the
whole row mutates a step; the bootstrap draws n_bootstrap / (max_depth +
1) vectors a depth (at least one a chain), b is the sum over depths of
their mean luminance, and the chains start from picks of
np.random.RandomState(seed + 1).choice over the bootstrap luminances;
every step splats the proposal and the current state with Metropolis'
weights (mlt.cpp:254-263); the image is the splats times b /
mutations_per_pixel.

The random draws are the port's own, not the JAX package's threefry:
torch.Generator streams on the CPU (seeded by the seed and the depth),
moved to the render's device, so the card and the CPU draw the same
numbers.  eval_L and mutation_step take their draws as
tensors (tests/test_torch_mlt_sppm.py feeds them the JAX package's).
The film's scale applies (the JAX package's MLT ignores it).  A chain
starts from its bootstrap row's L as the bootstrap evaluated it (the JAX
package evaluates the picked rows again; L is lane by lane, the same
bits).  Profiler ranges: "layer: mlt / draws", "/ evaluate L", "/ splat".

Traversal launches an evaluation of L at depth d: d + 1 camera-walk and d
light-walk steps (the vertices depth d reads), then one for each strategy
of depth d that traces (d + 1 of them from depth 1): 1 at depth 0, 3 d + 2
beyond.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.profiler import record_function

from .. import film as fm
from ..samplers.samplers import SamplerConfig
from ..scene import SceneArrays, resolve_device
from ..utils import stats as st
from . import bdpt as bd


@dataclasses.dataclass(frozen=True)
class MLTConfig:
    """pbrt's MLTIntegrator parameters (mlt.cpp:282-300), the JAX
    package's defaults."""
    max_depth: int = 5
    n_bootstrap: int = 4096
    n_chains: int = 1024
    mutations_per_pixel: int = 4
    sigma: float = 0.01
    large_step_prob: float = 0.3
    light_normal: str = "surface"  # bdpt.BDPTConfig's


def n_dims(max_depth: int) -> int:
    """The primary-sample vector's length: the walks' dims and the s = 1
    strategies' light-sample dims at 200 + 3 t (mlt.py:51-56)."""
    return 200 + 3 * (max_depth + 3) + 4


def chain_key(depth: int) -> int:
    return depth * 7919 + 13


def _luminance(v):
    return 0.212671 * v[:, 0] + 0.715160 * v[:, 1] + 0.072169 * v[:, 2]


def eval_L(scene, camera, X, depth: int, cfg: MLTConfig, res, counters):
    """L(X) over the strategies of paths of exactly `depth` edges
    (mlt.py:63-112).  Returns (rasters [K][C, 2], values [K][C, 3], lum
    [C]); the last raster is the camera's, its value the t >= 2 sum."""
    n = X.shape[0]
    xr, yr = res
    fx = X[:, 0] * xr
    fy = X[:, 1] * yr
    px = torch.clamp(fx.to(torch.int32), 0, xr - 1)
    py = torch.clamp(fy.to(torch.int32), 0, yr - 1)
    pixels = torch.stack([px, py], -1)
    X2 = torch.cat([torch.clamp(fx - px.to(torch.float32), 0.0, 1.0 - 1e-6)[:, None],
                    torch.clamp(fy - py.to(torch.float32), 0.0, 1.0 - 1e-6)[:, None],
                    X[:, 2:]], 1)
    s_cfg = SamplerConfig.pss(res)
    state = {"x": X2, "chain_key": chain_key(depth)}
    bcfg = bd.BDPTConfig(max_depth=cfg.max_depth,
                         light_normal=cfg.light_normal)
    # the strategies of depth d read camera vertices 0..d+1 and light
    # vertices 0..d: the walks stop there (the JAX package walks the full
    # max_depth; the vertices read, their pdfs and dims are the same)
    cam_vs, dim_c, p_film = bd.generate_camera_subpath(
        scene, camera, pixels, s_cfg, state, bcfg, counters, n_steps=depth + 1)
    light_vs, _ = bd.generate_light_subpath(scene, n, s_cfg, state, bcfg, dim_c,
                                            counters, X.device, n_steps=depth)
    rasters, values = [], []
    L_film = torch.zeros((n, 3), dtype=torch.float32, device=X.device)
    for t in range(1, depth + 3):
        s = depth + 2 - t
        if (s, t) == (1, 1):
            continue
        contrib, weight, raster = bd.connect(scene, camera, cam_vs, light_vs, s, t,
                                             s_cfg, state, counters, cfg.light_normal)
        wc = contrib * weight[:, None]
        wc = torch.where(torch.all(torch.isfinite(wc), -1)[:, None], wc, 0.0)
        if t == 1:
            rasters.append(raster)
            values.append(wc)
        else:
            L_film = L_film + wc
    rasters.append(p_film)
    values.append(L_film)
    lum = sum(_luminance(v) for v in values)
    return rasters, values, lum


def draws(seed: int, stream: int, shapes, device):
    """Uniform (a shape) or standard normal (("normal", shape)) draws from
    a CPU torch.Generator seeded by (seed, stream), on `device`: the same
    numbers on the card and on the CPU."""
    g = torch.Generator().manual_seed((seed * 1_000_003 + stream) & 0x7FFFFFFF)
    out = []
    for shape in shapes:
        if shape and shape[0] == "normal":
            out.append(torch.randn(shape[1], generator=g).to(device))
        else:
            out.append(torch.rand(shape, generator=g).to(device))
    return out


def bootstrap_luminance(lum) -> np.ndarray:
    """The bootstrap's luminances (eval_L's lum of the bootstrap vectors)
    on the host, non-finite ones zeroed (mlt.cpp:177-202)."""
    lum = lum.cpu().numpy()
    return np.where(np.isfinite(lum), lum, 0.0)


def pick_chains(lums, n_chains: int, seed: int):
    """b and each chain's (depth, bootstrap row): b sums the depths' mean
    luminance; the picks are the JAX package's (mlt.py:158-163)."""
    b = 0.0
    for lum in lums:
        b += lum.mean()
    all_lum = np.concatenate(lums)
    probs = all_lum / max(all_lum.sum(), 1e-12)
    picks = np.random.RandomState(seed + 1).choice(len(all_lum), size=n_chains,
                                                   p=probs)
    per = lums[0].shape[0]
    return b, picks // per, picks % per


def splat_all(splat, res, rasters, values):
    """The JAX package's _splat of each (raster, value) in turn, as one
    ordered add: each pixel gets its values in the same order.  Raster
    (x, y) truncates toward zero and clamps to the image; values or rasters
    that are not finite add nothing.  Returns the index_add_ rounds."""
    xr, yr = res
    r = torch.cat(rasters)
    v = torch.cat(values)
    good = (torch.all(torch.isfinite(v), -1) & torch.all(torch.isfinite(r), -1)
            & torch.any(v != 0.0, -1))
    r = torch.where(good[:, None], r, 0.0)
    xi = torch.clamp(r[:, 0].to(torch.int32), 0, xr - 1)
    yi = torch.clamp(r[:, 1].to(torch.int32), 0, yr - 1)
    pix = (yi.to(torch.int64) * xr + xi)[good]
    return fm.ordered_index_add(pix, [(splat.view(-1, 3), v[good])])


def mutation_step(scene, camera, chain, step_draws, depth: int, cfg: MLTConfig,
                  res, splat, counters):
    """One Metropolis step of every chain (mlt.cpp:204-280): chain is (X,
    lum, rasters, values), step_draws (large-step uniforms [C], fresh
    vectors [C, D], normals [C, D], acceptance uniforms [C]); both
    candidates are splatted into splat [H, W, 3] in place.  Returns (the
    next chain, the splat's index_add_ rounds)."""
    X, lum, rasters, values = chain
    u_large, fresh, normal, u_accept = step_draws
    large = u_large < cfg.large_step_prob
    perturb = X + cfg.sigma * normal
    perturb = perturb - torch.floor(perturb)
    Xp = torch.where(large[:, None], fresh, perturb)
    with record_function("layer: mlt / evaluate L"):
        r_p, v_p, lum_p = eval_L(scene, camera, Xp, depth, cfg, res, counters)
    a = torch.clamp(lum_p / torch.clamp(lum, min=1e-12), 0.0, 1.0)
    accept = u_accept < a
    w_p = (a / torch.clamp(lum_p, min=1e-12))[:, None]
    w_c = ((1.0 - a) / torch.clamp(lum, min=1e-12))[:, None]
    with record_function("layer: mlt / splat"):
        ranks = splat_all(splat, res, r_p + rasters,
                          [vv * w_p for vv in v_p] + [vv * w_c for vv in values])
    av = accept[:, None]
    chain = (torch.where(av, Xp, X), torch.where(accept, lum_p, lum),
             [torch.where(av, rp, rc) for rp, rc in zip(r_p, rasters)],
             [torch.where(av, vp, vc) for vp, vc in zip(v_p, values)])
    return chain, ranks


def render(scene: SceneArrays, camera, film_cfg: fm.FilmConfig, sampler_cfg=None,
           cfg: MLTConfig = MLTConfig(), filt=None, count_rays: bool = False,
           stats_out: bool = False, progress=None, device="cuda", seed: int = 0,
           info: dict | None = None):
    """MLTIntegrator::Render (mlt.cpp:165-280).  sampler_cfg and filt are
    not read (pbrt's MLT has no sampler; the splats are unfiltered), but
    the exact sampler mode raises; progress is not updated.  Runs on the card unless
    device="cpu", with the scene already there.  info (render.info after
    the call) gets b, the chains a depth, the steps and the splat's
    index_add_ rounds.
    Returns the image [H, W, 3] (and the rays or counters as path.render)."""
    device = resolve_device(device)
    if scene.device != device:
        raise ValueError(f"scene is on {scene.device}, render asked for {device}")
    bd.check_transport_scene("mlt", scene, camera, sampler_cfg)
    camera = camera.to(device)
    res = tuple(film_cfg.full_resolution)
    xr, yr = res
    D = n_dims(cfg.max_depth)
    n_depths = cfg.max_depth + 1
    C = cfg.n_chains
    per_depth = max(cfg.n_bootstrap // n_depths, C)
    counters = st.zeros(device)
    info = {} if info is None else info
    render.info = info
    with torch.no_grad():
        Xs, lums, evals = [], [], []
        for depth in range(n_depths):
            with record_function("layer: mlt / draws"):
                X, = draws(seed, depth, [(per_depth, D)], device)
            with record_function("layer: mlt / evaluate L"):
                evals.append(eval_L(scene, camera, X, depth, cfg, res, counters))
            Xs.append(X)
            lums.append(bootstrap_luminance(evals[-1][2]))
        b, depth_of, row_of = pick_chains(lums, C, seed)
        n_mut_total = cfg.mutations_per_pixel * xr * yr
        n_steps = max(n_mut_total // C, 1)
        splat = torch.zeros((yr, xr, 3), dtype=torch.float32, device=device)
        info.update(b=float(b), steps=n_steps, chains=[], splat_rounds=0)
        for depth in range(n_depths):
            rows = row_of[depth_of == depth]
            info["chains"].append(int(rows.shape[0]))
            if rows.shape[0] == 0:
                continue
            # the chains start at their bootstrap rows, whose L the
            # bootstrap evaluated (the JAX package evaluates them again:
            # each lane's L is its own, the same bits)
            rows_t = torch.as_tensor(rows, device=device)
            rasters, values, lum = evals[depth]
            chain = (Xs[depth][rows_t], lum[rows_t], [r[rows_t] for r in rasters],
                     [v[rows_t] for v in values])
            n = rows_t.shape[0]
            for i in range(n_steps):
                with record_function("layer: mlt / draws"):
                    step_draws = draws(seed, 1000 * (depth + 1) + i,
                                       [(n,), (n, D), ("normal", (n, D)), (n,)],
                                       device)
                chain, ranks = mutation_step(scene, camera, chain, step_draws, depth,
                                             cfg, res, splat, counters)
                info["splat_rounds"] += ranks
        scale = b / max(cfg.mutations_per_pixel, 1) * (
            n_mut_total / max(n_steps * C, 1))
        img = splat * float(scale) * film_cfg.scale
    if stats_out:
        return img, counters
    if count_rays:
        return img, st.ray_total(counters)
    return img
