"""The path integrator's main loop, bounce-major over a flat ray batch.

Port of pbrt_tpu/integrators/path.py (PathIntegrator::Li, path.cpp:64-188,
and SamplerIntegrator::Render, integrator.cpp:228-339).  One Python loop
iteration per bounce takes the place of the JAX package's lax.scan (or its
unrolled loop on a scene with subsurface materials); both draw the same
sampler dimensions.

Textures are evaluated once per bounce (eval_scene_textures).  On a scene
with textures the camera rays carry ray differentials, which select the mip
level at the first hit only; later bounces look up level 0 bilinearly, as
pbrt's scattered rays carry no differentials.

Dimension schedule (path.py:13-14, 185-193): camera dims 0-4; from dim 5,
each bounce b draws 5 NEE dims and 2 BSDF dims, on a scene with a
subsurface material 10 more for every lane (the exit point's axis,
channel and radius, its light sample and its Sw direction), and 1 Russian-
roulette dim after bounce 3.

Subsurface (path.cpp:152-174): a lane whose BSDF sample crossed a
subsurface material's surface samples an exit point with the BSSRDF probe
walk (common.sample_bssrdf_sp), takes direct lighting there through the
SeparableBSSRDFAdapter and continues from it along a sampled Sw direction.

Traversal launches: the camera rays' closest hit is one launch.  Without
subsurface each later bounce's closest hit rides the previous bounce's NEE
launch (integrators/common.py), so a sample costs 1 + max_depth launches;
a grad step with remat (parallel/diff.py) replays max_depth of them in
backward.  With subsurface, a bounce launches its NEE, ss_probe_depth
probe segments, the exit point's NEE and then the next bounce's closest
hit alone, after the exit point has moved its lanes' rays: 1 + max_depth
(3 + ss_probe_depth) launches a sample; a remat step replays max_depth
(2 + ss_probe_depth) of them (the non-reentrant checkpoint stops a
bounce's replay once its backward has what it needs, before the next
closest hit).  Every replayed launch takes its forward launch's inputs bit
for bit: the bounce's draws are stateless hashes of (pixel, sample, dim),
and a grad step refuses the random sampler, whose stream a replay would
advance again, with remat.

The exact sampler mode (PBRT_TPU_EXACT_SAMPLER=1, SamplerConfig.exact)
reads a batch's dims from host tables (samplers/exact_tables.py): all of
them for halton, the 10 array-backed dims of a PixelSampler with the rest
drawn as the stateless sampler's get_1d draws them (path.py:612-625,
728-760).  As in the JAX package it is the path integrator's alone; the
other integrators' renders raise on it.

Profiler ranges named "layer: ..." mark the calls into each layer; without
the profiler each costs a few microseconds on the host.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from .. import film as fm
from ..accel import traverse as tv
from ..cameras import generate_ray_differentials, generate_rays
from ..core import spectrum
from ..core.vecmath import absdot, offset_ray_origin
from ..filters import make_filter
from ..lights import lightdistrib as ldist
from ..lights import lights as lt
from ..materials import bsdf as bx
from ..samplers import exact_tables as xt
from ..samplers import samplers as sa
from ..scene import MAT_BSSRDF_ADAPTER, MAT_SUBSURFACE, SceneArrays, resolve_device
from ..textures.textures import evaluate_textures
from ..utils import stats as st
from . import common


@dataclasses.dataclass(frozen=True)
class PathConfig:
    """pbrt's PathIntegrator parameters (path.cpp:190-208).  light_strategy
    "spatial" picks each light from the spatial light distribution
    (lights/lightdistrib.py); "uniform" and "power" use the scene's own
    distribution (SceneBuilder.light_strategy), as in the JAX package.
    Russian roulette applies when max(beta * etaScale) < rr_threshold.
    ss_probe_depth: the BSSRDF probe walk's segments (bssrdf.cpp:295-320
    walks until the segment ends)."""
    max_depth: int = 5
    rr_threshold: float = 1.0
    light_strategy: str = "uniform"  # "uniform" | "power" | "spatial"
    ss_probe_depth: int = 4

    def __post_init__(self):
        if self.light_strategy not in ("uniform", "power", "spatial"):
            raise NotImplementedError(
                f"lightsamplestrategy {self.light_strategy!r}: the port has "
                "uniform, power and spatial")


SS_DIMS = 10  # the subsurface branch's dims a bounce


def dims_per_bounce(bounce: int, mat_types=()) -> int:
    """5 NEE + 2 BSDF dims, +10 on a scene with a subsurface material, +1
    Russian-roulette dim after bounce 3 (path.py:185-193)."""
    return (7 + (SS_DIMS if MAT_SUBSURFACE in mat_types else 0)
            + (1 if bounce > 3 else 0))


def eval_scene_textures(scene: SceneArrays, rec, duv=None):
    """The texture stack [T, n, 3] at the hits (path.py:47-57), or None on
    a scene without textures.  duv: (duvdx, duvdy) from the camera rays'
    differentials, or None (level-0 lookups)."""
    if not scene.has_textures:
        return None
    duvdx, duvdy = duv if duv is not None else (None, None)
    with record_function("layer: textures"):
        return evaluate_textures(scene.textures, rec["uv"], rec["p"],
                                 scene.tex_meta, scene.tex_ids,
                                 duvdx=duvdx, duvdy=duvdy)


def li_path(scene: SceneArrays, o, d, sampler_cfg, sampler_state,
            cfg: PathConfig, counters, start_dim: int = 5,
            remat: bool = False, ray_diffs=None):
    """Radiance along a batch of camera rays: L [n, 3].  ray_diffs: the
    camera rays' differentials (rx_o, rx_d, ry_o, ry_d), used at bounce 0
    on a scene with textures, or None.

    remat=True wraps each bounce but the last in a non-reentrant
    torch.utils.checkpoint: the backward pass replays each bounce from its
    carry instead of holding every bounce's activations, so backward memory
    does not grow with depth (path replay, the JAX package's per-bounce
    jax.checkpoint).  A replayed bounce launches its traversal kernel again;
    its counter increments are added once, outside the checkpoint."""
    n = o.shape[0]
    dev = o.device
    L = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    beta = torch.ones((n, 3), dtype=torch.float32, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    specular_bounce = torch.zeros(n, dtype=torch.bool, device=dev)
    eta_scale = torch.ones(n, dtype=torch.float32, device=dev)

    st.bump(counters, "Integrator/Camera rays traced", float(n))
    t, prim = tv.intersect_closest(scene, o, d, 1e30)
    carry = (L, beta, alive, specular_bounce, eta_scale, o, d, t, prim)
    dim = start_dim
    for bounce in range(cfg.max_depth + 1):
        body = _make_bounce_body(scene, bounce, dim, sampler_cfg,
                                 sampler_state, cfg,
                                 ray_diffs if bounce == 0 else None)
        if remat and bounce < cfg.max_depth:
            carry, inc = checkpoint(body, *carry, use_reentrant=False,
                                    preserve_rng_state=False)
        else:
            carry, inc = body(*carry)
        counters += inc
        dim += dims_per_bounce(bounce, scene.mat_types)
    return carry[0]


def _make_bounce_body(scene: SceneArrays, bounce: int, dim: int, sampler_cfg,
                      sampler_state, cfg: PathConfig, ray_diffs=None):
    """One bounce of the path walk as a function of the carry (L, beta,
    alive, specular_bounce, eta_scale, o, d, t, prim) to (the next carry,
    its counter increments), the counterpart of the JAX package's
    _make_bounce_body (path.py:198).  The last bounce only adds emission."""
    last = bounce == cfg.max_depth
    spatial = cfg.light_strategy == "spatial" and scene.spatial_cdf is not None
    subsurface = MAT_SUBSURFACE in scene.mat_types

    def body(L, beta, alive, specular_bounce, eta_scale, o, d, t, prim):
        counters = st.zeros(o.device)
        st.bump(counters, "Intersections/Regular ray intersection tests", alive)
        with record_function("layer: hit record"):
            rec = tv.hit_record(scene, o, d, t, prim)
        found = rec["hit"] & alive
        st.bump(counters, "Integrator/Path vertices", found)

        # Emitted radiance for camera rays and rays leaving a specular
        # bounce; the others were counted by MIS (path.cpp:91-101).
        count_le = specular_bounce | (bounce == 0)
        le_surf = lt.area_light_emission(scene, rec["arealight"], rec["ng"],
                                         rec["wo"])
        L = L + torch.where((found & count_le)[:, None], beta * le_surf, 0.0)
        le_inf = lt.escaped_radiance(scene, d, scene.light_types)
        L = L + torch.where((alive & ~rec["hit"] & count_le)[:, None],
                            beta * le_inf, 0.0)
        alive = found
        if last:
            return (L, beta, alive, specular_bounce, eta_scale, o, d, t,
                    prim), counters

        duv = None
        if ray_diffs is not None and scene.has_textures:
            duv = tv.uv_differentials(rec, *ray_diffs)
        tex = eval_scene_textures(scene, rec, duv)
        with record_function("layer: materials"):
            mat = bx.gather_material(scene.materials, rec["material"], tex,
                                     scene.mat_types, scene.mix_sub_types,
                                     uv=rec["uv"])
        frame = bx.frame_from_rec(rec)
        ss, ts, ns = frame
        wo_local = bx.to_local(ss, ts, ns, rec["wo"])
        has_bsdf = alive & (rec["material"] >= 0)

        # NEE draws (dims +0..+4), then the BSDF draw (+5, +6), taken before
        # the NEE launch so the extension ray can ride it (without
        # subsurface).
        u_select = sa.get_1d(sampler_cfg, sampler_state, dim)
        u_light = sa.get_2d(sampler_cfg, sampler_state, dim + 1)
        u_scatter = sa.get_2d(sampler_cfg, sampler_state, dim + 3)
        u_bsdf = sa.get_2d(sampler_cfg, sampler_state, dim + 5)
        st.bump(counters, "Intersections/Shadow ray intersection tests",
                2.0 * has_bsdf.to(torch.float64).sum())
        st.bump(counters, "Lights/Light samples taken", has_bsdf)
        pick = None
        if spatial:
            with record_function("layer: spatial light pick"):
                pick = ldist.spatial_pick_light(
                    scene.spatial_grid_res, scene.spatial_b0, scene.spatial_diag,
                    scene.spatial_cdf, scene.spatial_pmf, rec["p"], u_select)
        with record_function("layer: materials"):
            # the NEE's MIS sample (u_scatter) and the next bounce's
            # (u_bsdf) in one call over both lane sets: bit for bit the two
            # calls, half their operations
            n = u_bsdf.shape[0]
            both = bx.sample_material(_twice(mat), torch.cat([wo_local, wo_local]),
                                      torch.cat([u_scatter, u_bsdf]),
                                      scene.mat_types)
            bs_mis = {k: v[:n] for k, v in both.items()}
            bs = {k: v[n:] for k, v in both.items()}
        wi_world = bx.to_world(ss, ts, ns, bs["wi"])
        o_next = offset_ray_origin(rec["p"], rec["p_error"], rec["ng"], wi_world)
        with record_function("layer: NEE incl. its traversal"):
            ld, next_hits = common.sample_one_light(
                scene, rec, frame, mat, wo_local, u_select, u_light, u_scatter,
                has_bsdf, extra_ray=None if subsurface else (o_next, wi_world),
                pick=pick, bsdf_sample=bs_mis)
        L = L + torch.where(has_bsdf[:, None], beta * ld, 0.0)

        valid = has_bsdf & bs["valid"]
        pdf_s = torch.where(valid, bs["pdf"], 1.0)
        contrib = bs["f"] * (absdot(wi_world, ns)
                             / torch.clamp(pdf_s, min=1e-20))[:, None]
        contrib = torch.where(valid[:, None], contrib, 0.0)
        alive = alive & valid
        beta = torch.where(alive[:, None], beta * contrib, beta)
        specular_bounce = bs["is_specular"]
        # etaScale through specular transmission (path.cpp:144-150).
        transmitted = bs["is_specular"] & (bs["wi"][:, 2] * wo_local[:, 2] < 0.0)
        et = mat["eta"]
        eta_fac = torch.where(wo_local[:, 2] > 0.0, et * et,
                              1.0 / torch.clamp(et * et, min=1e-12))
        eta_scale = torch.where(transmitted, eta_scale * eta_fac, eta_scale)
        o = torch.where(alive[:, None], o_next, o)
        d = torch.where(alive[:, None], wi_world, d)

        if subsurface:
            L, beta, alive, specular_bounce, o, d = _subsurface(
                scene, cfg, rec, frame, mat, wo_local, bs, dim + 7,
                sampler_cfg, sampler_state, counters, spatial,
                L, beta, alive, specular_bounce, o, d)

        if bounce > 3:  # Russian roulette (path.cpp:176-184)
            u_rr = sa.get_1d(sampler_cfg, sampler_state,
                             dim + 7 + (SS_DIMS if subsurface else 0))
            rr_beta_max = spectrum.max_component(beta * eta_scale[:, None])
            q = torch.clamp(1.0 - rr_beta_max, min=0.05)
            do_rr = rr_beta_max < cfg.rr_threshold
            die = do_rr & (u_rr < q)
            st.bump(counters, "Integrator/Russian-roulette terminations",
                    die & alive)
            alive = alive & ~die
            beta = torch.where((do_rr & ~die)[:, None],
                               beta / torch.clamp(1.0 - q, min=1e-6)[:, None],
                               beta)
        if subsurface:  # the next closest hit, after the exit points moved
            next_hits = tv.intersect_closest(scene, o, d,
                                             torch.where(alive, 1e30, 0.0))
        return (L, beta, alive, specular_bounce, eta_scale, o, d,
                *next_hits), counters

    return body


def _subsurface(scene, cfg, rec, frame, mat, wo_local, bs, dim, sampler_cfg,
                sampler_state, counters, spatial, L, beta, alive,
                specular_bounce, o, d):
    """path.cpp:152-174 (path.py:326-409): the lanes whose BSDF sample
    crossed a subsurface material's surface re-emerge at an exit point pi
    (common.sample_bssrdf_sp, dims +0..+2), take direct lighting there
    through the SeparableBSSRDFAdapter with the light picked at pi (+3..+7)
    and continue along its sampled Sw direction (+8, +9).  Every lane draws
    the 10 dims.  Returns the updated (L, beta, alive, specular_bounce, o,
    d)."""
    u_ss = sa.get_1d(sampler_cfg, sampler_state, dim)
    u_ss2 = sa.get_2d(sampler_cfg, sampler_state, dim + 1)
    u_sel2 = sa.get_1d(sampler_cfg, sampler_state, dim + 3)
    u_li2 = sa.get_2d(sampler_cfg, sampler_state, dim + 4)
    u_sc2 = sa.get_2d(sampler_cfg, sampler_state, dim + 6)
    u_bsdf2 = sa.get_2d(sampler_cfg, sampler_state, dim + 8)
    crossed = bs["wi"][:, 2] * wo_local[:, 2] < 0.0
    do_ss = alive & (mat["type"] == MAT_SUBSURFACE) & crossed
    with record_function("layer: subsurface / probe walk"):
        spr = common.sample_bssrdf_sp(scene, rec, frame, mat, u_ss, u_ss2,
                                      n_probe=cfg.ss_probe_depth, live=do_ss)
    ok = do_ss & spr["ok"]
    st.bump(counters, "Intersections/BSSRDF probe rays",
            cfg.ss_probe_depth * do_ss.to(torch.float64).sum())
    st.bump(counters, "Intersections/Shadow ray intersection tests",
            2.0 * ok.to(torch.float64).sum())
    beta = torch.where(ok[:, None],
                       beta * spr["sp"] / torch.clamp(spr["pdf"], min=1e-20)[:, None],
                       beta)
    alive = alive & (~do_ss | ok)  # S black or pdf 0: the path ends
    pi_rec = {k: spr[k] for k in ("p", "p_error", "ns", "ng")}
    pi_frame = bx.make_frame(spr["ns"], spr["dpdu"])
    adapter = {"type": torch.where(ok, MAT_BSSRDF_ADAPTER, -1), "eta": mat["eta"]}
    # wo at pi is the shading normal (bssrdf.cpp:243)
    wo_pi = torch.zeros_like(wo_local)
    wo_pi[:, 2] = 1.0
    pick = None
    if spatial:
        pick = ldist.spatial_pick_light(
            scene.spatial_grid_res, scene.spatial_b0, scene.spatial_diag,
            scene.spatial_cdf, scene.spatial_pmf, spr["p"], u_sel2)
    with record_function("layer: subsurface / exit NEE"):
        ld, _ = common.sample_one_light(
            scene, pi_rec, pi_frame, adapter, wo_pi, u_sel2, u_li2, u_sc2, ok,
            pick=pick, mat_types=(MAT_BSSRDF_ADAPTER,))
    L = L + torch.where(ok[:, None], beta * ld, 0.0)
    bs2 = bx.sample_material(adapter, wo_pi, u_bsdf2, (MAT_BSSRDF_ADAPTER,))
    wi2 = bx.to_world(*pi_frame, bs2["wi"])
    contrib = bs2["f"] * (absdot(wi2, pi_frame[2])
                          / torch.clamp(bs2["pdf"], min=1e-20))[:, None]
    alive = alive & (~ok | (bs2["valid"] & torch.any(bs2["f"] > 0, -1)))
    beta = torch.where((ok & alive)[:, None], beta * contrib, beta)
    specular_bounce = torch.where(ok, False, specular_bounce)
    o = torch.where(ok[:, None],
                    offset_ray_origin(spr["p"], spr["p_error"], spr["ng"], wi2), o)
    d = torch.where(ok[:, None], wi2, d)
    return L, beta, alive, specular_bounce, o, d


def _twice(mat):
    """A material dict with every lane's parameters twice, [mat; mat]."""
    return {k: (_twice(v) if isinstance(v, dict) else
                torch.cat([v, v]) if isinstance(v, torch.Tensor) else v)
            for k, v in mat.items()}


def make_pixel_grid(film_cfg: fm.FilmConfig) -> np.ndarray:
    """All pixels in the cropped bounds as an [Npix, 2] int array."""
    px0, px1, py0, py1 = film_cfg.cropped_pixel_bounds
    xs, ys = np.meshgrid(np.arange(px0, px1), np.arange(py0, py1))
    return np.stack([xs.ravel(), ys.ravel()], -1).astype(np.int32)


def n_path_dims(cfg: PathConfig, mat_types=()) -> int:
    """The sampler dims a path draws on a scene of these material types."""
    return 5 + sum(dims_per_bounce(b, mat_types) for b in range(cfg.max_depth)) + 1


def batch_sampler_state(sampler_cfg, pixels, sample_num: int, n_dims: int,
                        table=None):
    """The sampler state of one sample per pixel; for halton, with its
    first n_dims dims at once, one table row per dimension.  table: the
    exact mode's rows of this batch, [D, N] with D <= n_dims; a shorter
    table (a PixelSampler's) gets the rest as get_1d draws."""
    n = pixels.shape[0]
    state = sa.init_state(sampler_cfg, pixels,
                          torch.full((n,), sample_num, dtype=torch.int64,
                                     device=pixels.device))
    if table is not None:
        if table.shape[0] < n_dims:
            table = torch.cat([table, torch.stack(
                [sa.get_1d(sampler_cfg, state, dd)
                 for dd in range(table.shape[0], n_dims)])])
        state["table"] = table
    elif sampler_cfg.name == "halton":
        with record_function("layer: sampler table"):
            state["table"] = sa.halton_table(sampler_cfg, state, n_dims)
    return state


def exact_tables(sampler_cfg, pixels, n_dims: int):
    """The exact mode's table of each batch, as a function of the sample
    number: halton's [n_dims, N] computed on the host for that batch, or a
    PixelSampler's [10, N] rows, every sample's built here at once
    (path.py:728-760).  pixels: the render's whole pixel grid."""
    pix = pixels.cpu().numpy()
    name = sampler_cfg.name
    if name == "halton":
        return lambda s: torch.as_tensor(
            xt.halton_exact_table(sampler_cfg, pix, s, n_dims).T.copy(),
            device=pixels.device)
    if name not in xt.PIXEL_EXACT_SAMPLERS:
        raise NotImplementedError(
            "exact-tables render mode covers halton (full-stream) and the "
            "PixelSamplers stratified/(0,2)/maxmin (array-backed dims; "
            "samplers/exact_tables.pixel_exact_table)")
    tables = torch.as_tensor(xt.pixel_exact_table(name, pix, sampler_cfg.spp),
                             device=pixels.device)
    return lambda s: tables[s]


def camera_rays(scene: SceneArrays, camera, p_film, p_lens, time_u, spp: int):
    """(o, d, weight, ray differentials or None): the differentials only
    on a scene with textures (path.py:642-647)."""
    with record_function("layer: camera rays"):
        if not scene.has_textures:
            o, d, _, weight = generate_rays(camera, p_film, p_lens, time_u)
            return o, d, weight, None
        o, d, _, weight, *diffs = generate_ray_differentials(
            camera, p_film, p_lens, time_u, spp=spp)
        return o, d, weight, tuple(diffs)


def path_li(scene: SceneArrays, sampler_cfg, cfg: PathConfig):
    """li_path as render_loop's li."""
    def li(o, d, state, pixels, s, counters, ray_diffs):
        return li_path(scene, o, d, sampler_cfg, state, cfg, counters,
                       ray_diffs=ray_diffs)
    return li


def sample_batch(li, n_dims: int, scene: SceneArrays, camera, film_state,
                 pixels, sample_num: int, sampler_cfg, counters, table=None):
    """One sample per pixel, accumulated into film_state (in place): the
    sampler state of n_dims dims (from the exact mode's table when one is
    given), the camera rays (with differentials on a scene with textures),
    L = li(o, d, state, pixels, sample_num, counters, ray_diffs) with
    non-finite and negative L zeroed (integrator.cpp:294-315), weighted by
    the camera's ray weight into the film.  Integrators other than path
    ignore ray_diffs, so their textures look up level 0, as the JAX
    package's do."""
    state = batch_sampler_state(sampler_cfg, pixels, sample_num, n_dims, table)
    p_film, time_u, p_lens = sa.get_camera_sample(sampler_cfg, state, pixels)
    o, d, weight, ray_diffs = camera_rays(scene, camera, p_film, p_lens,
                                          time_u, sampler_cfg.spp)
    L = li(o, d, state, pixels, sample_num, counters, ray_diffs)
    bad = ~torch.all(torch.isfinite(L), -1) | torch.any(L < 0.0, -1)
    L = torch.where(bad[:, None], 0.0, L)
    with record_function("layer: film"):
        fm.add_samples(film_state, p_film, L, weight)
    st.bump(counters, "Film/Samples added", float(pixels.shape[0]))
    return film_state


def render(scene: SceneArrays, camera, film_cfg: fm.FilmConfig, sampler_cfg,
           cfg: PathConfig = PathConfig(), filt=None, count_rays: bool = False,
           stats_out: bool = False, progress=None, device="cuda"):
    """Full render of the path integrator (render_loop).  The spatial light
    distribution is built here, once per scene, when cfg asks for it."""
    if cfg.light_strategy == "spatial":
        scene = ldist.ensure_spatial_light_distribution(scene)
    return render_loop(path_li(scene, sampler_cfg, cfg),
                       n_path_dims(cfg, scene.mat_types),
                       scene, camera, film_cfg, sampler_cfg, filt, count_rays,
                       stats_out, progress, device, exact=True)


def render_loop(li, n_dims: int, scene: SceneArrays, camera, film_cfg,
                sampler_cfg, filt=None, count_rays: bool = False,
                stats_out: bool = False, progress=None, device="cuda",
                exact: bool = False):
    """The sample loop of every integrator's render: one sample_batch per
    sample per pixel.  Runs on the card unless device="cpu"; the scene must
    already be on that device.  Returns the image [H, W, 3]; with count_rays
    also the rays traced, with stats_out also the counter vector
    (utils/stats.py).  filt: the reconstruction filter (the film's named
    one by default).  progress: a ProgressReporter updated once per spp
    batch.  exact: the integrator reads the exact mode's tables (the path
    integrator's render); a sampler_cfg.exact render of any other raises."""
    device = resolve_device(device)
    if scene.device != device:
        raise ValueError(f"scene is on {scene.device}, render asked for {device}")
    if sampler_cfg.exact and not exact:
        raise NotImplementedError(
            "the exact sampler mode covers the path integrator, as in the "
            "JAX package")
    camera = camera.to(device)
    film_state = fm.make_film_state(
        film_cfg, filt or make_filter(film_cfg.filter_name), device)
    pixels = torch.as_tensor(make_pixel_grid(film_cfg), device=device)
    tables = (exact_tables(sampler_cfg, pixels, n_dims) if sampler_cfg.exact
              else lambda s: None)
    counters = st.zeros(device)
    with torch.no_grad():
        for s in range(sampler_cfg.spp):
            sample_batch(li, n_dims, scene, camera, film_state, pixels, s,
                         sampler_cfg, counters, tables(s))
            if progress is not None:
                progress.update(s + 1)
        img = fm.to_image(film_state, scale=film_cfg.scale)
    if stats_out:
        return img, counters
    if count_rays:
        return img, st.ray_total(counters)
    return img
