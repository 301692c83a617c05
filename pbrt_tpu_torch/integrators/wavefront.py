"""The streaming wavefront path integrator: a persistent lane pool refilled
as paths finish.

Port of pbrt_tpu/integrators/wavefront.py (PBRT_TPU_ENGINE=wavefront).  A
pool of n_lanes lanes, each holding one (pixel, sample) path at a time;
every iteration advances every live lane by one bounce, scatters the
finished lanes' radiance into the film and refills them with fresh camera
samples from a global work counter, so the traversal launches stay full
instead of thinning with path survival.  Work ids are sample-major, id =
s * n_pix + pixel row, the lockstep engine's (pixel, sample) pairs.

Per-lane dimension cursors draw pbrt's conditional consumption (path.cpp):
the 5 NEE dims are skipped at specular-only vertices (path.cpp:117-131) and
the Russian-roulette dim is drawn only where rrBeta < threshold past bounce
3 (path.cpp:176-184); the draws go through samplers.get_1d_dyn/get_2d_dyn.
On a scene without specular vertices the cursors follow the lockstep
schedule.

Two traversal launches an iteration, as in the JAX package:
  A. the NEE shadow rays (any-hit) and BSDF-MIS rays, 2N lanes;
  B. the extension rays of surviving lanes and the camera rays of refilled
     lanes, N lanes (dead lanes get t_max = -1).

The JAX package compiles a superstep of iters_per_step iterations under
lax.fori_loop and reads the work counter and the live count back once a
superstep; here the iterations run eagerly and read back the same two
numbers once a superstep, in one transfer.  Nothing inside an iteration
waits for the card: masks, not data-dependent shapes.  The finished lanes'
film samples are kept a superstep and added in one call at its end, in
the order the JAX package adds them iteration by iteration (film.py sums
each pixel's contributions in their order in the call).

A scene with a subsurface material renders with the lockstep engine
(path.render), as in the JAX package (wavefront.py:364-370).
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from .. import film as fm
from ..accel import traverse as tv
from ..cameras import generate_ray_differentials, generate_rays
from ..core import spectrum
from ..core.vecmath import absdot, offset_ray_origin
from ..filters import make_filter
from ..lights import lightdistrib as ldist
from ..lights import lights as lt
from ..materials import bsdf as bx
from ..samplers import samplers as sa
from ..scene import MAT_SUBSURFACE, SceneArrays, resolve_device
from ..utils import checkpoint as ckpt
from ..utils import stats as st
from . import common
from .path import PathConfig, _twice, eval_scene_textures, make_pixel_grid

DIMS_PER_BOUNCE = 8  # 5 NEE + 2 BSDF + 1 Russian roulette, at most


def max_live_dim(cfg: PathConfig) -> int:
    """The largest sampler dim a live lane can draw at this depth: 5 camera
    dims, then at most DIMS_PER_BOUNCE a bounce."""
    return 5 + DIMS_PER_BOUNCE * (cfg.max_depth + 1)


def _merge(take, old, new):
    """new on the lanes of take, old elsewhere, through dicts and tuples."""
    if isinstance(old, dict):
        return {k: _merge(take, old[k], new[k]) for k in old}
    if isinstance(old, tuple):
        return tuple(_merge(take, a, b) for a, b in zip(old, new))
    return torch.where(take.reshape(take.shape + (1,) * (old.dim() - 1)), new, old)


def _refill(state, scene, camera, sampler_cfg, pixels):
    """Give the dead lanes fresh (pixel, sample) work (wavefront.py:52):
    the k-th dead lane takes work id next_work + k while ids last."""
    n = state["alive"].shape[0]
    n_pix = pixels.shape[0]
    dev = pixels.device
    dead = ~state["alive"]
    new_id = state["next_work"] + torch.cumsum(dead.to(torch.int64), 0) - 1
    take = dead & (new_id < state["total"])
    pix = pixels[torch.clamp(new_id % n_pix, 0, n_pix - 1)]
    fresh = sa.init_state(sampler_cfg, pix, new_id // n_pix)
    p_film, time_u, p_lens = sa.get_camera_sample(sampler_cfg, fresh, pix)
    out = dict(state)
    with record_function("layer: camera rays"):
        if "rx_o" in state:
            o, d, _, w, *diffs = generate_ray_differentials(
                camera, p_film, p_lens, time_u, spp=sampler_cfg.spp)
            for k, v in zip(("rx_o", "rx_d", "ry_o", "ry_d"), diffs):
                out[k] = _merge(take, state[k], v)
        else:
            o, d, _, w = generate_rays(camera, p_film, p_lens, time_u)
    zeros3 = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    out["sampler"] = _merge(take, state["sampler"], fresh)
    for k, v in (("o", o), ("d", d), ("p_film", p_film), ("cam_w", w),
                 ("L", zeros3), ("beta", torch.ones_like(zeros3)),
                 ("eta_scale", torch.ones(n, dtype=torch.float32, device=dev)),
                 ("specular", torch.zeros(n, dtype=torch.bool, device=dev)),
                 ("bounce", torch.zeros(n, dtype=torch.int64, device=dev)),
                 ("dim", torch.full((n,), 5, dtype=torch.int64, device=dev))):
        out[k] = _merge(take, state[k], v)
    out["alive"] = state["alive"] | take
    out["next_work"] = state["next_work"] + take.to(torch.int64).sum()
    return out, take


def _trace(state, scene, fresh):
    """Launch B: the closest hit of every live lane's ray; dead lanes trace
    nothing (t_max = -1) and keep prim = -1."""
    trace = state["alive"]
    t, prim = tv.intersect_closest(scene, state["o"], state["d"],
                                   torch.where(trace, 1e30, -1.0))
    state["t"] = t
    state["prim"] = torch.where(trace, prim, -1)
    st.bump(state["counters"], "Intersections/Regular ray intersection tests", trace)
    st.bump(state["counters"], "Integrator/Camera rays traced", fresh)
    return state


def _iteration(state, scene, camera, sampler_cfg, cfg: PathConfig, pixels,
               film_batches: list):
    """One wavefront step (wavefront.py:106): shade the current hits, NEE
    (launch A), the next rays, Russian roulette; the finished lanes' film
    samples go to film_batches; refill, then launch B."""
    max_dim = max_live_dim(cfg)
    alive = state["alive"]
    o, d = state["o"], state["d"]
    L, beta = state["L"], state["beta"]
    bounce, dim = state["bounce"], state["dim"]
    counters = state["counters"]
    sampler = state["sampler"]

    with record_function("layer: hit record"):
        rec = tv.hit_record(scene, o, d, state["t"], state["prim"])
    found = rec["hit"] & alive
    st.bump(counters, "Integrator/Path vertices", found)

    # Le at the vertex and escaped radiance (path.cpp:91-108)
    count_le = (bounce == 0) | state["specular"]
    le_surf = lt.area_light_emission(scene, rec["arealight"], rec["ng"], rec["wo"])
    L = L + torch.where((found & count_le)[:, None], beta * le_surf, 0.0)
    le_inf = lt.escaped_radiance(scene, d, scene.light_types)
    L = L + torch.where((alive & ~rec["hit"] & count_le)[:, None], beta * le_inf, 0.0)

    was_live = alive
    alive = found & (bounce < cfg.max_depth)

    duv = None
    if "rx_o" in state:
        at_cam = (bounce == 0)[:, None]
        duv = tv.uv_differentials(rec, *(torch.where(at_cam, state[k], 0.0)
                                         for k in ("rx_o", "rx_d", "ry_o", "ry_d")))
    tex = eval_scene_textures(scene, rec, duv)
    with record_function("layer: materials"):
        mat = bx.gather_material(scene.materials, rec["material"], tex,
                                 scene.mat_types, scene.mix_sub_types, uv=rec["uv"])
    frame = bx.frame_from_rec(rec)
    ss, ts, ns = frame
    wo_local = bx.to_local(ss, ts, ns, rec["wo"])
    has_bsdf = alive & (rec["material"] >= 0)
    nonspec = bx.count_nonspecular(mat) & has_bsdf

    # the draws at per-lane dims, in pbrt's consumption order
    with record_function("layer: sampler draws"):
        u_select = sa.get_1d_dyn(sampler_cfg, sampler, dim, max_dim)
        u_light = sa.get_2d_dyn(sampler_cfg, sampler, dim + 1, max_dim)
        u_scatter = sa.get_2d_dyn(sampler_cfg, sampler, dim + 3, max_dim)
        dim_bsdf = torch.where(nonspec, dim + 5, dim)
        u_bsdf = sa.get_2d_dyn(sampler_cfg, sampler, dim_bsdf, max_dim)
    dim = dim_bsdf + 2

    pick = None
    if cfg.light_strategy == "spatial" and scene.spatial_cdf is not None:
        pick = ldist.spatial_pick_light(
            scene.spatial_grid_res, scene.spatial_b0, scene.spatial_diag,
            scene.spatial_cdf, scene.spatial_pmf, rec["p"], u_select)

    with record_function("layer: materials"):
        # the NEE's MIS sample (u_scatter) and the next bounce's (u_bsdf) in
        # one call, bit for bit the two calls
        n = u_bsdf.shape[0]
        both = bx.sample_material(_twice(mat), torch.cat([wo_local, wo_local]),
                                  torch.cat([u_scatter, u_bsdf]), scene.mat_types)
        bs_mis = {k: v[:n] for k, v in both.items()}
        bs = {k: v[n:] for k, v in both.items()}
    wi_world = bx.to_world(ss, ts, ns, bs["wi"])
    o_next = offset_ray_origin(rec["p"], rec["p_error"], rec["ng"], wi_world)

    with record_function("layer: NEE incl. its traversal"):  # launch A
        ld, _ = common.sample_one_light(
            scene, rec, frame, mat, wo_local, u_select, u_light, u_scatter,
            nonspec, pick=pick, bsdf_sample=bs_mis)
    L = L + torch.where(nonspec[:, None], beta * ld, 0.0)
    st.bump(counters, "Intersections/Shadow ray intersection tests",
            2.0 * nonspec.to(torch.float64).sum())
    st.bump(counters, "Lights/Light samples taken", nonspec)

    contrib = bs["f"] * (absdot(wi_world, ns)
                         / torch.clamp(bs["pdf"], min=1e-20))[:, None]
    alive = alive & has_bsdf & bs["valid"]
    beta = torch.where(alive[:, None], beta * contrib, beta)
    specular = bs["is_specular"]
    transmitted = bs["is_specular"] & (bs["wi"][:, 2] * wo_local[:, 2] < 0.0)
    et = mat["eta"]
    eta_fac = torch.where(wo_local[:, 2] > 0.0, et * et,
                          1.0 / torch.clamp(et * et, min=1e-12))
    eta_scale = torch.where(transmitted, state["eta_scale"] * eta_fac,
                            state["eta_scale"])

    # Russian roulette (path.cpp:176-184), its dim drawn where it applies
    u_rr = sa.get_1d_dyn(sampler_cfg, sampler, dim, max_dim)
    rr_beta_max = spectrum.max_component(beta * eta_scale[:, None])
    do_rr = (bounce > 3) & (rr_beta_max < cfg.rr_threshold) & alive
    q = torch.clamp(1.0 - rr_beta_max, min=0.05)
    die = do_rr & (u_rr < q)
    st.bump(counters, "Integrator/Russian-roulette terminations", die)
    alive = alive & ~die
    beta = torch.where((do_rr & ~die)[:, None],
                       beta / torch.clamp(1.0 - q, min=1e-6)[:, None], beta)
    dim = torch.where(do_rr, dim + 1, dim)

    # the finished lanes' samples, non-finite and negative L zeroed
    finished = was_live & ~alive
    bad = ~torch.all(torch.isfinite(L), -1) | torch.any(L < 0.0, -1)
    film_batches.append((state["p_film"], torch.where(bad[:, None], 0.0, L),
                         state["cam_w"], finished))
    st.bump(counters, "Film/Samples added", finished)

    new = dict(state, alive=alive, L=L, beta=beta, eta_scale=eta_scale,
               specular=specular, bounce=bounce + 1, dim=dim,
               o=torch.where(alive[:, None], o_next, o),
               d=torch.where(alive[:, None], wi_world, d))
    new, fresh = _refill(new, scene, camera, sampler_cfg, pixels)
    return _trace(new, scene, fresh)


def flush_film(state, film_batches: list):
    """Add a superstep's finished samples to the film in one call, in
    iteration order, then lane order."""
    if film_batches:
        p_film, L, w, mask = (torch.cat(x) for x in zip(*film_batches))
        with record_function("layer: film"):
            fm.add_samples(state["film"], p_film, L, w, mask=mask)
        film_batches.clear()


def initial_state(scene, camera, film_state, sampler_cfg, pixels, total: int,
                  n_lanes: int, start: int = 0):
    """The pool before the first iteration (wavefront.py:262): every lane
    dead, then the initial fill and its closest hits.  Work ids run from
    start to total (exclusive)."""
    n = n_lanes
    dev = pixels.device
    z3 = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    state = {
        "film": film_state,
        "alive": torch.zeros(n, dtype=torch.bool, device=dev),
        "o": z3,
        "d": torch.cat([torch.zeros((n, 2), dtype=torch.float32, device=dev),
                        torch.ones((n, 1), dtype=torch.float32, device=dev)], -1),
        "t": torch.zeros(n, dtype=torch.float32, device=dev),
        "prim": torch.full((n,), -1, dtype=torch.int32, device=dev),
        "L": z3,
        "beta": torch.ones_like(z3),
        "eta_scale": torch.ones(n, dtype=torch.float32, device=dev),
        "specular": torch.zeros(n, dtype=torch.bool, device=dev),
        "bounce": torch.zeros(n, dtype=torch.int64, device=dev),
        "dim": torch.full((n,), 5, dtype=torch.int64, device=dev),
        "p_film": torch.zeros((n, 2), dtype=torch.float32, device=dev),
        "cam_w": torch.zeros(n, dtype=torch.float32, device=dev),
        "sampler": sa.init_state(sampler_cfg,
                                 torch.zeros((n, 2), dtype=torch.int32, device=dev),
                                 torch.zeros(n, dtype=torch.int64, device=dev)),
        "next_work": torch.tensor(start, dtype=torch.int64, device=dev),
        "total": torch.tensor(total, dtype=torch.int64, device=dev),
        "counters": st.zeros(dev),
    }
    if scene.has_textures:
        state.update(rx_o=z3, rx_d=z3, ry_o=z3, ry_d=z3)
    state, fresh = _refill(state, scene, camera, sampler_cfg, pixels)
    return _trace(state, scene, fresh)


def _check(scene: SceneArrays, sampler_cfg, device):
    device = resolve_device(device)
    if scene.device != device:
        raise ValueError(f"scene is on {scene.device}, render asked for {device}")
    if sampler_cfg.exact:
        raise NotImplementedError(
            "the exact sampler mode covers the lockstep engine's path "
            "integrator; the wavefront draws each dim where a lane needs it")
    return device


def run_supersteps(state, scene, camera, sampler_cfg, cfg: PathConfig, pixels,
                   iters_per_step: int, on_step=None):
    """The host loop (wavefront.py:334-395): supersteps of iters_per_step
    iterations until the work is handed out and no lane is live.  After
    each superstep the film is flushed, the work counter and live count
    are read back (one transfer) and on_step(state, steps, next_work,
    live) is called.  Returns the state."""
    steps = 0
    total = int(state["total"])
    batches: list = []
    while True:
        for _ in range(iters_per_step):
            state = _iteration(state, scene, camera, sampler_cfg, cfg, pixels,
                               batches)
        flush_film(state, batches)
        steps += 1
        nw, live = torch.stack([state["next_work"],
                                state["alive"].sum()]).tolist()
        if on_step is not None:
            on_step(state, steps, nw, live)
        if nw >= total and live == 0:
            return state


def render(scene: SceneArrays, camera, film_cfg: fm.FilmConfig, sampler_cfg,
           cfg: PathConfig = PathConfig(), filt=None, n_lanes: int = 1 << 17,
           iters_per_step: int = 8, count_rays: bool = False,
           stats_out: bool = False, progress=None,
           checkpoint_path: str | None = None, checkpoint_every: int = 0,
           device="cuda"):
    """The wavefront render (wavefront.py:298): the image [H, W, 3], with
    count_rays also the rays traced, with stats_out the counter vector.
    progress: a ProgressReporter in (pixel, sample) paths retired.
    checkpoint_path/_every: the loop state (film, lane pool, work counter)
    is the whole render state; it is written every checkpoint_every
    supersteps and a render started with an existing checkpoint resumes
    from it (utils/checkpoint.py save_state/load_state)."""
    device = _check(scene, sampler_cfg, device)
    if MAT_SUBSURFACE in scene.mat_types:
        from . import path as pt

        return pt.render(scene, camera, film_cfg, sampler_cfg, cfg, filt,
                         count_rays=count_rays, stats_out=stats_out,
                         progress=progress, device=device)
    if cfg.light_strategy == "spatial":
        scene = ldist.ensure_spatial_light_distribution(scene)
    camera = camera.to(device)
    film_state = fm.make_film_state(
        film_cfg, filt or make_filter(film_cfg.filter_name), device)
    pixels = torch.as_tensor(make_pixel_grid(film_cfg), device=device)
    total = pixels.shape[0] * sampler_cfg.spp
    n_lanes = min(n_lanes, max(total, 1024))

    def on_step(state, steps, nw, live):
        if progress is not None:
            progress.update(max(nw - live, 0))
        if checkpoint_path and checkpoint_every and steps % checkpoint_every == 0:
            ckpt.save_state(checkpoint_path, state)

    with torch.no_grad():
        state = initial_state(scene, camera, film_state, sampler_cfg, pixels,
                              total, n_lanes)
        if checkpoint_path:
            state = ckpt.maybe_resume_state(checkpoint_path, state)
        state = run_supersteps(state, scene, camera, sampler_cfg, cfg, pixels,
                               iters_per_step, on_step)
        img = fm.to_image(state["film"], scale=film_cfg.scale)
    if stats_out:
        return img, state["counters"]
    if count_rays:
        return img, st.ray_total(state["counters"])
    return img


def render_sharded(scene: SceneArrays, camera, film_cfg: fm.FilmConfig,
                   sampler_cfg, cfg: PathConfig = PathConfig(), filt=None,
                   n_lanes_per_shard: int = 1 << 15, iters_per_step: int = 8,
                   count_rays: bool = False, device="cuda"):
    """The wavefront over the processes of the default torch.distributed
    group (wavefront.py:420-567), or this process alone without one: rank
    i of D owns the work ids [i total // D, (i + 1) total // D) with a
    lane pool and film of its own, and nothing crosses processes until the
    end, when one all_reduce(SUM) adds the film partials and the counters.
    Work ids equal the one-process render's, so the image does not depend
    on D up to the film's add order.  Returns the image on every rank
    (and with count_rays the rays traced).  A scene with a subsurface
    material raises, where the JAX package's render_sharded renders it
    without the probe walk."""
    from ..parallel import mesh

    device = _check(scene, sampler_cfg, device)
    if MAT_SUBSURFACE in scene.mat_types:
        raise NotImplementedError(
            "subsurface materials: the sharded wavefront has no BSSRDF probe "
            "walk (render() hands such scenes to the lockstep engine)")
    if cfg.light_strategy == "spatial":
        scene = ldist.ensure_spatial_light_distribution(scene)
    camera = camera.to(device)
    film_state = fm.make_film_state(
        film_cfg, filt or make_filter(film_cfg.filter_name), device)
    pixels = torch.as_tensor(make_pixel_grid(film_cfg), device=device)
    total = pixels.shape[0] * sampler_cfg.spp
    rank, world = mesh.rank_and_world()
    base, lim = mesh.work_range(rank, world, total)
    with torch.no_grad():
        state = initial_state(scene, camera, film_state, sampler_cfg, pixels,
                              lim, n_lanes_per_shard, start=base)
        state = run_supersteps(state, scene, camera, sampler_cfg, cfg, pixels,
                               iters_per_step)
        film = state["film"]
        mesh.all_reduce_sum([film.weighted_sum, film.weight_sum, film.splat,
                             state["counters"]])
        img = fm.to_image(film, scale=film_cfg.scale)
    if count_rays:
        return img, st.ray_total(state["counters"])
    return img
