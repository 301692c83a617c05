"""The path integrator's main loop, bounce-major over a flat ray batch.

Port of pbrt_tpu/integrators/path.py (PathIntegrator::Li, path.cpp:64-188,
and SamplerIntegrator::Render, integrator.cpp:228-339) for scenes without
subsurface materials.  One Python loop iteration per bounce takes the place
of the JAX package's lax.scan; both draw the same sampler dimensions.

Textures are evaluated once per bounce (eval_scene_textures).  On a scene
with textures the camera rays carry ray differentials, which select the mip
level at the first hit only; later bounces look up level 0 bilinearly, as
pbrt's scattered rays carry no differentials.

Dimension schedule (path.py:13-14): camera dims 0-4; from dim 5, each bounce
b draws 5 NEE dims and 2 BSDF dims, plus 1 Russian-roulette dim after
bounce 3.

Traversal launches: the camera rays' closest hit is one launch; each later
bounce's closest hit rides the previous bounce's NEE launch
(integrators/common.py), so a sample costs 1 + max_depth launches; a grad
step with remat (parallel/diff.py) replays max_depth of them in backward.

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
from ..samplers import samplers as sa
from ..scene import SceneArrays, resolve_device
from ..textures.textures import evaluate_textures
from ..utils import stats as st
from . import common


@dataclasses.dataclass(frozen=True)
class PathConfig:
    """pbrt's PathIntegrator parameters (path.cpp:190-208).  light_strategy
    "spatial" picks each light from the spatial light distribution
    (lights/lightdistrib.py); "uniform" and "power" use the scene's own
    distribution (SceneBuilder.light_strategy), as in the JAX package.
    Russian roulette applies when max(beta * etaScale) < rr_threshold."""
    max_depth: int = 5
    rr_threshold: float = 1.0
    light_strategy: str = "uniform"  # "uniform" | "power" | "spatial"

    def __post_init__(self):
        if self.light_strategy not in ("uniform", "power", "spatial"):
            raise NotImplementedError(
                f"lightsamplestrategy {self.light_strategy!r}: the port has "
                "uniform, power and spatial")


def dims_per_bounce(bounce: int) -> int:
    """5 NEE + 2 BSDF dims, +1 Russian-roulette dim after bounce 3."""
    return 7 + (1 if bounce > 3 else 0)


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
        dim += dims_per_bounce(bounce)
    return carry[0]


def _make_bounce_body(scene: SceneArrays, bounce: int, dim: int, sampler_cfg,
                      sampler_state, cfg: PathConfig, ray_diffs=None):
    """One bounce of the path walk as a function of the carry (L, beta,
    alive, specular_bounce, eta_scale, o, d, t, prim) to (the next carry,
    its counter increments), the counterpart of the JAX package's
    _make_bounce_body (path.py:198).  The last bounce only adds emission."""
    last = bounce == cfg.max_depth
    spatial = cfg.light_strategy == "spatial" and scene.spatial_cdf is not None

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
                                     scene.mat_types, scene.mix_sub_types)
        frame = bx.frame_from_rec(rec)
        ss, ts, ns = frame
        wo_local = bx.to_local(ss, ts, ns, rec["wo"])
        has_bsdf = alive & (rec["material"] >= 0)

        # NEE draws (dims +0..+4), then the BSDF draw (+5, +6), taken before
        # the NEE launch so the extension ray can ride it.
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
            ld, (t_next, prim_next) = common.sample_one_light(
                scene, rec, frame, mat, wo_local, u_select, u_light, u_scatter,
                has_bsdf, extra_ray=(o_next, wi_world), pick=pick,
                bsdf_sample=bs_mis)
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

        if bounce > 3:  # Russian roulette (path.cpp:176-184)
            u_rr = sa.get_1d(sampler_cfg, sampler_state, dim + 7)
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
        return (L, beta, alive, specular_bounce, eta_scale, o, d, t_next,
                prim_next), counters

    return body


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


def n_path_dims(cfg: PathConfig) -> int:
    """The sampler dims a path draws."""
    return 5 + sum(dims_per_bounce(b) for b in range(cfg.max_depth)) + 1


def batch_sampler_state(sampler_cfg, pixels, sample_num: int, n_dims: int):
    """The sampler state of one sample per pixel; for halton, with its
    first n_dims dims at once, one table row per dimension."""
    n = pixels.shape[0]
    state = sa.init_state(sampler_cfg, pixels,
                          torch.full((n,), sample_num, dtype=torch.int64,
                                     device=pixels.device))
    if sampler_cfg.name == "halton":
        with record_function("layer: sampler table"):
            state["table"] = sa.halton_table(sampler_cfg, state, n_dims)
    return state


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
                 pixels, sample_num: int, sampler_cfg, counters):
    """One sample per pixel, accumulated into film_state (in place): the
    sampler state of n_dims dims, the camera rays (with differentials on a
    scene with textures), L = li(o, d, state, pixels, sample_num, counters,
    ray_diffs) with non-finite and negative L zeroed (integrator.cpp:294-315),
    into the film.  Integrators other than path ignore ray_diffs, so their
    textures look up level 0, as the JAX package's do."""
    state = batch_sampler_state(sampler_cfg, pixels, sample_num, n_dims)
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
    return render_loop(path_li(scene, sampler_cfg, cfg), n_path_dims(cfg),
                       scene, camera, film_cfg, sampler_cfg, filt, count_rays,
                       stats_out, progress, device)


def render_loop(li, n_dims: int, scene: SceneArrays, camera, film_cfg,
                sampler_cfg, filt=None, count_rays: bool = False,
                stats_out: bool = False, progress=None, device="cuda"):
    """The sample loop of every integrator's render: one sample_batch per
    sample per pixel.  Runs on the card unless device="cpu"; the scene must
    already be on that device.  Returns the image [H, W, 3]; with count_rays
    also the rays traced, with stats_out also the counter vector
    (utils/stats.py).  filt: the reconstruction filter (the film's named
    one by default).  progress: a ProgressReporter updated once per spp
    batch."""
    device = resolve_device(device)
    if scene.device != device:
        raise ValueError(f"scene is on {scene.device}, render asked for {device}")
    camera = camera.to(device)
    film_state = fm.make_film_state(
        film_cfg, filt or make_filter(film_cfg.filter_name), device)
    pixels = torch.as_tensor(make_pixel_grid(film_cfg), device=device)
    counters = st.zeros(device)
    with torch.no_grad():
        for s in range(sampler_cfg.spp):
            sample_batch(li, n_dims, scene, camera, film_state, pixels, s,
                         sampler_cfg, counters)
            if progress is not None:
                progress.update(s + 1)
        img = fm.to_image(film_state, scale=film_cfg.scale)
    if stats_out:
        return img, counters
    if count_rays:
        return img, st.ray_total(counters)
    return img
