"""The Whitted integrator (integrators/whitted.cpp:44-100).

Port of pbrt_tpu/integrators/whitted.py: emitted light, direct light from
every light with no MIS (one 2-D sample and one shadow ray each), and the
specular continuation, up to max_depth bounces, as a bounce-major loop.

Dimension schedule per bounce but the last, from dim 5: 2 dims a light,
then 2 for the BSDF sample.  Traversal launches: per bounce but the last,
one closest hit and one any-hit shadow launch a light; the last bounce
one closest hit: (1 + lights) max_depth + 1 a sample.  Dead lanes get
t_max = 0.  Like the JAX package's, the camera rays carry no
differentials: textures are looked up at level 0.
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from .. import film as fm
from ..accel import traverse as tv
from ..core.vecmath import absdot, offset_ray_origin
from ..lights import lights as lt
from ..materials import bsdf as bx
from ..samplers import samplers as sa
from ..scene import SceneArrays
from ..utils import stats as st
from . import common
from .direct import DirectLightingConfig
from .path import eval_scene_textures, render_loop


def n_whitted_dims(scene: SceneArrays, cfg: DirectLightingConfig) -> int:
    return 5 + cfg.max_depth * (2 * scene.lights.light_type.shape[0] + 2)


def li_whitted(scene: SceneArrays, o, d, sampler_cfg, sampler_state,
               cfg: DirectLightingConfig, counters):
    """Radiance along a batch of camera rays: L [n, 3]."""
    n = o.shape[0]
    dev = o.device
    n_lights = scene.lights.light_type.shape[0]
    L = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    beta = torch.ones((n, 3), dtype=torch.float32, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    dim = 5  # after the camera dims
    st.bump(counters, "Integrator/Camera rays traced", float(n))

    for depth in range(cfg.max_depth + 1):
        st.bump(counters, "Intersections/Regular ray intersection tests", alive)
        t, prim = tv.intersect_closest(scene, o, d, torch.where(alive, 1e30, 0.0))
        with record_function("layer: hit record"):
            rec = tv.hit_record(scene, o, d, t, prim)
        found = rec["hit"] & alive
        st.bump(counters, "Integrator/Path vertices", found)
        le_surf = lt.area_light_emission(scene, rec["arealight"], rec["ng"],
                                         rec["wo"])
        L = L + torch.where(found[:, None], beta * le_surf, 0.0)
        le_inf = lt.escaped_radiance(scene, d, scene.light_types)
        L = L + torch.where((alive & ~rec["hit"])[:, None], beta * le_inf, 0.0)
        alive = found
        if depth >= cfg.max_depth:
            break

        mat = bx.gather_material(scene.materials, rec["material"],
                                 eval_scene_textures(scene, rec),
                                 scene.mat_types, scene.mix_sub_types)
        ss, ts, ns = bx.frame_from_rec(rec)
        wo_local = bx.to_local(ss, ts, ns, rec["wo"])
        has_bsdf = alive & (rec["material"] >= 0)

        # every light (whitted.cpp:77-92), one shadow launch each
        with record_function("layer: NEE incl. its traversal"):
            for li_i in range(n_lights):
                u_l = sa.get_2d(sampler_cfg, sampler_state, dim)
                dim += 2
                light = torch.full((n,), li_i, dtype=torch.int64, device=dev)
                s = lt.sample_li(scene, light, rec["p"], u_l, scene.light_types)
                f, _ = bx.eval_material(mat, wo_local,
                                        bx.to_local(ss, ts, ns, s["wi"]),
                                        scene.mat_types)
                f = f * absdot(s["wi"], ns)[:, None]
                usable = has_bsdf & (s["pdf"] > 0.0) & torch.any(f != 0.0, -1)
                st.bump(counters, "Intersections/Shadow ray intersection tests",
                        has_bsdf)
                st.bump(counters, "Lights/Light samples taken", has_bsdf)
                occ = common.occluded(scene, rec["p"], rec["p_error"], rec["ng"],
                                      s["p_light"], live=has_bsdf)
                L = L + torch.where(
                    (usable & ~occ)[:, None],
                    beta * f * s["li"] / torch.clamp(s["pdf"], min=1e-20)[:, None],
                    0.0)

        # the specular continuation
        u_b = sa.get_2d(sampler_cfg, sampler_state, dim)
        dim += 2
        bs = bx.sample_material(mat, wo_local, u_b, scene.mat_types)
        cont = has_bsdf & bs["is_specular"] & bs["valid"]
        wi_world = bx.to_world(ss, ts, ns, bs["wi"])
        beta = torch.where(
            cont[:, None],
            beta * bs["f"] * (absdot(wi_world, ns)
                              / torch.clamp(bs["pdf"], min=1e-20))[:, None],
            beta)
        alive = cont
        o = offset_ray_origin(rec["p"], rec["p_error"], rec["ng"], wi_world)
        d = wi_world
    return L


def render(scene: SceneArrays, camera, film_cfg: fm.FilmConfig, sampler_cfg,
           cfg: DirectLightingConfig = DirectLightingConfig(), filt=None,
           count_rays: bool = False, stats_out: bool = False, progress=None,
           device="cuda"):
    """Full render, one batch per sample per pixel, as path.render: on the
    card unless device="cpu", with the scene already there.  Returns the
    image [H, W, 3]; with count_rays also the rays traced, with stats_out
    also the counter vector."""
    def li(o, d, state, pixels, s, counters, ray_diffs):
        return li_whitted(scene, o, d, sampler_cfg, state, cfg, counters)

    return render_loop(li, n_whitted_dims(scene, cfg), scene, camera, film_cfg,
                       sampler_cfg, filt, count_rays, stats_out, progress,
                       device)
