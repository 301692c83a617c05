"""The volumetric path integrator (integrators/volpath.cpp:55-189).

Port of pbrt_tpu/integrators/volpath.py.  Each bounce, the lanes inside a
medium sample a distance along their segment (media/media.py: the
homogeneous closed form, or delta tracking in a density grid); the lanes
that scatter in the medium take phase-function NEE and a Henyey-Greenstein
direction, the others the path integrator's surface vertex, all masked in
lockstep.  Each lane carries its current medium id, updated where its ray
crosses a primitive's medium interface (interaction.h GetMedium).  Shadow
and MIS rays walk across material-less boundaries, multiplying the
transmittance of each medium they cross (VisibilityTester::Tr,
Scene::IntersectTr), in up to four segments, one traversal launch each.

A scene with a subsurface material is refused (the JAX package's volpath
renders its surface alone, pbrt's follows the BSSRDF).

The JAX package's liberties, kept (ROADMAP.md, "not port faults"):
delta tracking draws its first K_TRACK + 1 steps from sampler dims and
the rest, like ratio tracking, from a counter hash; a null-material
boundary vertex consumes a full bounce's dims; the medium vertex's light
pick uses the scene's light distribution, not the spatial one; a grid's
sigma_t is its channel 0.

Dimension schedule per bounce b, from dim 5: 2 medium-sample dims (+2
K_TRACK on a scene with a grid medium), then, but at the last bounce, 5
NEE dims, 2 scattering dims and 1 Russian-roulette dim after bounce 3.

Traversal launches a bounce but the last: on a scene with media, 1
closest hit, 4 + 4 in the medium vertex's NEE walks and 4 + 4 in the
surface NEE's; without media 1 closest hit and the merged [shadow | MIS]
launch.  The last bounce launches its closest hit.  Dead lanes, and walk
lanes whose answer is not read, get t_max = 0.

Counters: every live lane (t_max > 0) of a closest-hit launch counts as a
regular ray intersection test, so ray_total is the live traversal lanes;
the merged launch counts as the path integrator's.
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from .. import film as fm
from ..accel import traverse as tv
from ..core import sampling as smp
from ..core import spectrum
from ..core.vecmath import absdot, dot, offset_ray_origin
from ..lights import lightdistrib as ldist
from ..lights import lights as lt
from ..materials import bsdf as bx
from ..media import media as md
from ..samplers import samplers as sa
from ..scene import MAT_SUBSURFACE, SceneArrays
from ..utils import stats as st
from . import common
from .path import PathConfig, eval_scene_textures, render_loop

# Sampler dims a bounce gives grid delta tracking (2 a step: distance and
# real/null); steps past them draw from the counter hash.
K_TRACK = 4
MAX_SEGMENTS = 4  # medium boundaries a shadow or MIS walk crosses


def n_volpath_dims(scene: SceneArrays, cfg: PathConfig) -> int:
    """The sampler dims a path draws (the module docstring's schedule)."""
    track = 2 * K_TRACK if md.MEDIUM_GRID in scene.medium_types else 0
    dims = 5
    for b in range(cfg.max_depth + 1):
        dims += 2 + track
        if b < cfg.max_depth:
            dims += 7 + (1 if b > 3 else 0)
    return dims


def _closest(scene, o, d, t_max, counters):
    """intersect_closest, its live lanes counted as regular tests."""
    st.bump(counters, "Intersections/Regular ray intersection tests", t_max > 0.0)
    return tv.intersect_closest(scene, o, d, t_max)


def _medium_params(scene: SceneArrays, med_id):
    mt = scene.media
    mid = torch.clamp(med_id.to(torch.int64), 0, mt.med_type.shape[0] - 1)
    valid = med_id >= 0
    return {"valid": valid, "mid": mid,
            "type": torch.where(valid, mt.med_type[mid], -1),
            "sigma_a": torch.where(valid[:, None], mt.sigma_a[mid], 0.0),
            "sigma_s": torch.where(valid[:, None], mt.sigma_s[mid], 0.0),
            "g": torch.where(valid, mt.g[mid], 0.0)}


def _grid_lanes(med, live):
    return torch.nonzero(med["valid"] & (med["type"] == md.MEDIUM_GRID)
                         & live).flatten()


def _sample_medium(scene, med, o, d, t_hit, u1, u2, key, live, u_track=None):
    """Medium::Sample over the medium types present: (sampled_medium,
    t, weight [n, 3]); live: the lanes whose answer is read."""
    n = o.shape[0]
    sampled = torch.zeros(n, dtype=torch.bool, device=o.device)
    t_out = t_hit
    w = torch.ones((n, 3), dtype=torch.float32, device=o.device)
    if md.MEDIUM_HOMOGENEOUS in scene.medium_types:
        m = med["valid"] & (med["type"] == md.MEDIUM_HOMOGENEOUS)
        hs = md.homogeneous_sample(med["sigma_a"], med["sigma_s"], t_hit, u1, u2)
        sampled = torch.where(m, hs["sampled_medium"], sampled)
        t_out = torch.where(m, hs["t"], t_out)
        w = torch.where(m[:, None], hs["weight"], w)
    if md.MEDIUM_GRID in scene.medium_types:
        lanes = _grid_lanes(med, live)
        if lanes.numel():
            with record_function("layer: media / delta tracking"):
                gs = md.grid_sample(scene.media, med["mid"][lanes], o[lanes],
                                    d[lanes], t_hit[lanes], key[lanes],
                                    u_tab=None if u_track is None else u_track[lanes])
            sampled = sampled.index_put((lanes,), gs["sampled_medium"])
            t_out = t_out.index_put((lanes,), gs["t"])
            w = w.index_put((lanes,), gs["weight"])
    return sampled, t_out, w


def _tr_along(scene, med, o, d, dist, key, live):
    """Transmittance [n, 3] through each lane's medium over [0, dist]."""
    n = o.shape[0]
    tr = torch.ones((n, 3), dtype=torch.float32, device=o.device)
    if md.MEDIUM_HOMOGENEOUS in scene.medium_types:
        m = med["valid"] & (med["type"] == md.MEDIUM_HOMOGENEOUS)
        tr = torch.where(m[:, None],
                         md.homogeneous_tr(med["sigma_a"] + med["sigma_s"], dist), tr)
    if md.MEDIUM_GRID in scene.medium_types:
        lanes = _grid_lanes(med, live)
        if lanes.numel():
            with record_function("layer: media / ratio tracking"):
                g = md.grid_tr(scene.media, med["mid"][lanes], o[lanes], d[lanes],
                               dist[lanes], md.key_add(key[lanes], 7))
            tr = tr.index_put((lanes,), g)
    return tr


def _cross(scene, prim, hit, has_mat, cur):
    """The medium past each crossed material-less boundary: a prim whose
    inside medium is the current one is left to its outside, else its
    inside is entered."""
    pid = torch.clamp(prim.to(torch.int64), 0, scene.prim_meta.shape[0] - 1)
    m_in = scene.prim_medium_inside[pid]
    m_out = scene.prim_medium_outside[pid]
    crossing = hit & ~has_mat
    return crossing, torch.where(crossing, torch.where(cur == m_in, m_out, m_in), cur)


def _live_rays(o, dn, dist, live):
    """The walk's rays, lanes outside `live` (whose points may be far or
    not finite) replaced by a finite ray of length 0."""
    if live is None:
        return o, dn, dist, torch.ones(o.shape[0], dtype=torch.bool, device=o.device)
    lv = live[:, None]
    return (torch.where(lv, o, 0.0), torch.where(lv, dn, 1.0),
            torch.where(live, dist, 0.0), live)


def _segment(scene, oo, dn, t_max, active, counters):
    """One segment of a walk: (t, prim, hit, has_mat) for the active lanes."""
    t, prim = _closest(scene, oo, dn, torch.where(active, t_max, 0.0), counters)
    hit = (prim >= 0) & active
    pid = torch.clamp(prim.to(torch.int64), 0, scene.prim_meta.shape[0] - 1)
    return t, prim, hit, hit & (scene.prim_meta[pid, 2] >= 0)


def _tr_walk_to(scene, o, dn, dist, cur_med, key, counters, live=None):
    """VisibilityTester::Tr (core/light.cpp:47-67): walk [o, o + dn dist]
    through up to MAX_SEGMENTS segments, multiplying each medium's
    transmittance, crossing material-less boundaries; a surface with a
    material occludes, and so does a walk that needs more segments.
    Returns (occluded [n], Tr [n, 3]); lanes outside `live` trace nothing
    and their answer means nothing."""
    n = dist.shape[0]
    tr = torch.ones((n, 3), dtype=torch.float32, device=o.device)
    occ = torch.zeros(n, dtype=torch.bool, device=o.device)
    oo, dn, rem, active = _live_rays(o, dn, dist, live)
    cur = cur_med
    with record_function("layer: media / Tr walk"):
        for k in range(MAX_SEGMENTS):
            t, prim, hit, has_mat = _segment(scene, oo, dn, rem * (1.0 - 1e-4),
                                             active, counters)
            seg = torch.where(hit, t, rem)
            tr = tr * torch.where(
                active[:, None],
                _tr_along(scene, _medium_params(scene, cur), oo, dn, seg,
                          md.key_add(key, 29 * k + 3), active), 1.0)
            occ = occ | has_mat
            crossing, cur = _cross(scene, prim, hit, has_mat, cur)
            adv = t * (1.0 + 1e-4) + 1e-6
            oo = torch.where(crossing[:, None], oo + dn * adv[:, None], oo)
            rem = torch.where(crossing, torch.clamp(rem - adv, min=0.0), rem)
            active = crossing
    return occ | active, tr


def _intersect_tr(scene, o, dn, cur_med, key, counters, live=None):
    """Scene::IntersectTr (core/scene.cpp:57-71): the closest surface with a
    material along the ray, past material-less boundaries, with the
    transmittance on the way.  Returns (t [n] from o, prim [n], -1 none,
    Tr [n, 3]); lanes outside `live` as in _tr_walk_to."""
    n = o.shape[0]
    dev = o.device
    tr = torch.ones((n, 3), dtype=torch.float32, device=dev)
    far = torch.full((n,), 1e30, dtype=torch.float32, device=dev)
    oo, dn, far, active = _live_rays(o, dn, far, live)
    cur = cur_med
    t_base = torch.zeros(n, dtype=torch.float32, device=dev)
    t_out = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    prim_out = torch.full((n,), -1, dtype=torch.int32, device=dev)
    with record_function("layer: media / Tr walk"):
        for k in range(MAX_SEGMENTS):
            t, prim, hit, has_mat = _segment(scene, oo, dn, far, active, counters)
            seg = torch.where(hit, t, 1e30)
            tr = tr * torch.where(
                active[:, None],
                _tr_along(scene, _medium_params(scene, cur), oo, dn, seg,
                          md.key_add(key, 31 * k + 11), active), 1.0)
            first_mat = has_mat & (prim_out < 0)
            prim_out = torch.where(first_mat, prim, prim_out)
            t_out = torch.where(first_mat, t_base + t, t_out)
            crossing, cur = _cross(scene, prim, hit, has_mat, cur)
            adv = t * (1.0 + 1e-4) + 1e-6
            oo = torch.where(crossing[:, None], oo + dn * adv[:, None], oo)
            t_base = torch.where(crossing, t_base + adv, t_base)
            active = crossing
    return t_out, prim_out, tr


def _medium_nee(scene, p, wo, g, cur_med, u_select, u_light, u_phase, mask,
                key, counters):
    """UniformSampleOneLight from a medium vertex (integrator.cpp:108-215,
    handleMedia): the phase function in place of the BSDF, the shadow ray
    by _tr_walk_to and the phase-sampled MIS ray by _intersect_tr."""
    light_types = scene.light_types
    light_idx, pmf = smp.sample_discrete_1d(scene.light_distr, u_select)
    s = lt.sample_li(scene, light_idx, p, u_light, light_types)
    ph = md.hg_p(dot(wo, s["wi"]), g)
    w = s["p_light"] - p
    dist = torch.sqrt(torch.clamp(dot(w, w), min=1e-20))
    dn = w / dist[:, None]
    occ, tr = _tr_walk_to(scene, p + dn * 1e-3, dn, dist * (1.0 - 1e-3), cur_med,
                          md.key_add(key, 13), counters, live=mask)
    li = torch.where((mask & ~occ & (s["pdf"] > 0))[:, None], s["li"] * tr, 0.0)
    weight = torch.where(s["is_delta"], 1.0,
                         smp.power_heuristic(1.0, s["pdf"], 1.0, ph))
    ld = li * (ph * weight / torch.clamp(s["pdf"], min=1e-20))[:, None]
    wi2, ph2 = md.hg_sample(wo, u_phase, g)
    light_pdf2 = lt.pdf_li(scene, light_idx, p, wi2, light_types)
    weight2 = smp.power_heuristic(1.0, ph2, 1.0, light_pdf2)
    t2, prim2, tr2 = _intersect_tr(scene, p + wi2 * 1e-3, wi2, cur_med,
                                   md.key_add(key, 17), counters, live=mask)
    hit2 = prim2 >= 0
    pid2 = torch.clamp(prim2.to(torch.int64), 0, scene.prim_meta.shape[0] - 1)
    hit_light = torch.where(hit2, scene.prim_meta[pid2, 3], -1)
    same = hit2 & (hit_light == light_idx) & ~s["is_delta"]
    rec2 = tv.hit_record(scene, p, wi2, t2, prim2)
    li2 = lt.area_light_emission(scene, hit_light, rec2["ng"], -wi2)
    ld = ld + torch.where((mask & same & (light_pdf2 > 0))[:, None],
                          li2 * tr2 * weight2[:, None], 0.0)  # f / pdf = 1
    return torch.where(mask[:, None], ld / torch.clamp(pmf, min=1e-20)[:, None], 0.0)


def _surface_tr_fns(scene, cur_med, key, counters):
    """estimate_direct's tr_fn and isect_tr_fn for the surface vertex."""
    def tr_fn(p, p_err, ng, p_light, live):
        o = offset_ray_origin(p, p_err, ng, p_light - p)
        dvec = p_light - o
        dist = torch.sqrt(torch.clamp(dot(dvec, dvec), min=1e-20))
        return _tr_walk_to(scene, o, dvec / dist[:, None], dist * (1.0 - 1e-4),
                           cur_med, md.key_add(key, 41), counters, live=live)

    def isect_tr_fn(o, d, live):
        return _intersect_tr(scene, o, d, cur_med, md.key_add(key, 43), counters,
                             live=live)

    return tr_fn, isect_tr_fn


def li_volpath(scene: SceneArrays, o, d, sampler_cfg, sampler_state,
               cfg: PathConfig, counters):
    """Radiance along a batch of camera rays: L [n, 3].  A subsurface
    material is refused: pbrt's volpath follows its BSSRDF (volpath.cpp),
    the JAX package's renders only its surface BSDF."""
    if MAT_SUBSURFACE in scene.mat_types:
        raise NotImplementedError(
            "volpath with a subsurface material: pbrt's volpath follows the "
            "BSSRDF, the JAX package's volpath ignores it; render it with "
            "path")
    n = o.shape[0]
    dev = o.device
    L = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    beta = torch.ones((n, 3), dtype=torch.float32, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    specular_bounce = torch.zeros(n, dtype=torch.bool, device=dev)
    cur_med = torch.full((n,), scene.camera_medium, dtype=torch.int32, device=dev)
    lane_key = md.lane_keys(n, dev)
    has_grid = md.MEDIUM_GRID in scene.medium_types
    spatial = cfg.light_strategy == "spatial" and scene.spatial_cdf is not None
    dim = 5  # after the camera dims
    st.bump(counters, "Integrator/Camera rays traced", float(n))

    for bounce in range(cfg.max_depth + 1):
        t, prim = _closest(scene, o, d, torch.where(alive, 1e30, 0.0), counters)
        with record_function("layer: hit record"):
            rec = tv.hit_record(scene, o, d, t, prim)
        found = rec["hit"] & alive

        # medium distance sampling (volpath.cpp:73-82), dims +0, +1; on a
        # grid scene those two lead the delta-tracking table
        u_ch = sa.get_1d(sampler_cfg, sampler_state, dim)
        u_ds = sa.get_1d(sampler_cfg, sampler_state, dim + 1)
        dim += 2
        u_track = None
        if has_grid:
            u_track = torch.stack(
                [u_ch, u_ds] + [sa.get_1d(sampler_cfg, sampler_state, dim + i)
                                for i in range(2 * K_TRACK)], -1)
            dim += 2 * K_TRACK
        med = _medium_params(scene, cur_med)
        key_b = md.key_add(lane_key, bounce * 0x101)
        t_seg = torch.where(rec["hit"], t, 1e30)
        in_medium, t_med, w_med = _sample_medium(scene, med, o, d, t_seg, u_ch,
                                                 u_ds, key_b, alive, u_track)
        in_medium = in_medium & alive & scene.has_media
        beta = torch.where(alive[:, None], beta * w_med, beta)
        p_med = o + t_med[:, None] * d
        st.bump(counters, "Integrator/Path vertices", found | in_medium)

        # emission where the ray was not scattered by a medium
        count_le = specular_bounce | (bounce == 0)
        le_surf = lt.area_light_emission(scene, rec["arealight"], rec["ng"],
                                         rec["wo"])
        L = L + torch.where((found & ~in_medium & count_le)[:, None],
                            beta * le_surf, 0.0)
        le_inf = lt.escaped_radiance(scene, d, scene.light_types)
        L = L + torch.where((alive & ~rec["hit"] & ~in_medium & count_le)[:, None],
                            beta * le_inf, 0.0)
        alive = (found | in_medium) & alive
        if bounce >= cfg.max_depth:
            break

        u_select = sa.get_1d(sampler_cfg, sampler_state, dim)
        u_light = sa.get_2d(sampler_cfg, sampler_state, dim + 1)
        u_scatter = sa.get_2d(sampler_cfg, sampler_state, dim + 3)
        u_dir = sa.get_2d(sampler_cfg, sampler_state, dim + 5)
        dim += 7

        if scene.has_media:  # the medium vertex: phase NEE, HG direction
            st.bump(counters, "Lights/Light samples taken", in_medium)
            with record_function("layer: media / medium NEE"):
                ld_med = _medium_nee(scene, p_med, rec["wo"], med["g"], cur_med,
                                     u_select, u_light, u_scatter, in_medium,
                                     key_b, counters)
            L = L + torch.where(in_medium[:, None], beta * ld_med, 0.0)
            wi_med, _ = md.hg_sample(rec["wo"], u_dir, med["g"])

        # the surface vertex, as the path integrator's
        mat = bx.gather_material(scene.materials, rec["material"],
                                 eval_scene_textures(scene, rec),
                                 scene.mat_types, scene.mix_sub_types,
                                 uv=rec["uv"])
        frame = bx.frame_from_rec(rec)
        ss, ts, ns = frame
        wo_local = bx.to_local(ss, ts, ns, rec["wo"])
        surf = alive & ~in_medium & rec["hit"]
        has_bsdf = surf & (rec["material"] >= 0)
        null_boundary = surf & (rec["material"] < 0)
        pick = None
        if spatial:
            with record_function("layer: spatial light pick"):
                pick = ldist.spatial_pick_light(
                    scene.spatial_grid_res, scene.spatial_b0, scene.spatial_diag,
                    scene.spatial_cdf, scene.spatial_pmf, rec["p"], u_select)
        tr_fn = isect_tr_fn = None
        if scene.has_media:
            tr_fn, isect_tr_fn = _surface_tr_fns(scene, cur_med, key_b, counters)
        else:
            st.bump(counters, "Intersections/Shadow ray intersection tests",
                    2.0 * has_bsdf.to(torch.float64).sum())
        st.bump(counters, "Lights/Light samples taken", has_bsdf)
        with record_function("layer: NEE incl. its traversal"):
            ld_surf, _ = common.sample_one_light(
                scene, rec, frame, mat, wo_local, u_select, u_light, u_scatter,
                has_bsdf, pick=pick, tr_fn=tr_fn, isect_tr_fn=isect_tr_fn)
        L = L + torch.where(has_bsdf[:, None], beta * ld_surf, 0.0)

        bs = bx.sample_material(mat, wo_local, u_dir, scene.mat_types)
        wi_surf = bx.to_world(ss, ts, ns, bs["wi"])
        contrib = bs["f"] * (absdot(wi_surf, ns)
                             / torch.clamp(bs["pdf"], min=1e-20))[:, None]
        new_d = wi_surf
        if scene.has_media:
            new_d = torch.where(in_medium[:, None], wi_med, wi_surf)
        new_d = torch.where(null_boundary[:, None], d, new_d)  # pass through
        new_o = torch.where(in_medium[:, None], p_med,
                            offset_ray_origin(rec["p"], rec["p_error"], rec["ng"],
                                              new_d))
        ok_surf = has_bsdf & bs["valid"]
        beta = torch.where(ok_surf[:, None], beta * contrib, beta)
        alive = alive & (in_medium | ok_surf | null_boundary)
        specular_bounce = surf & bs["is_specular"]

        # medium changes where the new ray crosses the surface
        pid = torch.clamp(prim.to(torch.int64), 0, scene.prim_meta.shape[0] - 1)
        cos_new = dot(new_d, rec["ng"])
        boundary_med = torch.where(cos_new < 0.0, scene.prim_medium_inside[pid],
                                   scene.prim_medium_outside[pid])
        crossed = (((surf | null_boundary) & (cos_new * dot(rec["wo"], rec["ng"]) < 0.0))
                   | null_boundary)
        cur_med = torch.where(crossed & rec["hit"], boundary_med, cur_med)
        o, d = new_o, new_d

        if bounce > 3:  # Russian roulette
            u_rr = sa.get_1d(sampler_cfg, sampler_state, dim)
            dim += 1
            rr_beta_max = spectrum.max_component(beta)
            q = torch.clamp(1.0 - rr_beta_max, min=0.05)
            do_rr = rr_beta_max < cfg.rr_threshold
            die = do_rr & (u_rr < q)
            st.bump(counters, "Integrator/Russian-roulette terminations", die & alive)
            alive = alive & ~die
            beta = torch.where((do_rr & ~die)[:, None],
                               beta / torch.clamp(1.0 - q, min=1e-6)[:, None], beta)
    return L


def render(scene: SceneArrays, camera, film_cfg: fm.FilmConfig, sampler_cfg,
           cfg: PathConfig = PathConfig(), filt=None, count_rays: bool = False,
           stats_out: bool = False, progress=None, device="cuda"):
    """Full render, one batch per sample per pixel, as path.render: on the
    card unless device="cpu", with the scene already there.  Returns the
    image [H, W, 3]; with count_rays also the rays traced, with stats_out
    also the counter vector."""
    if cfg.light_strategy == "spatial":
        scene = ldist.ensure_spatial_light_distribution(scene)

    def li(o, d, state, pixels, s, counters, ray_diffs):
        return li_volpath(scene, o, d, sampler_cfg, state, cfg, counters)

    return render_loop(li, n_volpath_dims(scene, cfg), scene, camera, film_cfg,
                       sampler_cfg, filt, count_rays, stats_out, progress,
                       device)
