"""Direct lighting: next-event estimation with MIS.

Port of pbrt_tpu/integrators/common.py (EstimateDirect / UniformSampleOneLight,
integrator.cpp:85-215).  The shadow rays (any-hit) and the BSDF-sampled MIS
rays go to the traversal kernel in one launch, lanes concatenated
[shadow | MIS]; the path integrator adds its next bounce's extension rays
to the same launch, [shadow | MIS | extension] (common.py:111-161).  Dead
lanes get t_max = 0 and leave the traversal at the root.

With participating media (handleMedia = true, the volumetric path
integrator) the caller passes tr_fn and isect_tr_fn, and the shadow and
MIS rays are traced by them, with transmittance, instead (common.py:
163-168): their walks cross material-less medium boundaries.

Profiler ranges "layer: lights" and "layer: materials" mark the calls into
lights/ and materials/ (the path integrator's bounce body adds its own
gather and BSDF sample to the latter).
"""
from __future__ import annotations

import math

import torch
from torch.profiler import record_function

from .. import scene as sc
from ..accel import traverse as tv
from ..core import sampling as smp
from ..core.vecmath import (absdot, cross, dot, normalize, offset_ray_origin,
                            safe_sqrt)
from ..core.vecmath import xform_vector
from ..lights import lights as lt
from ..materials import bsdf as bx

_SHADOW_EPS = 1.0 - 1e-4  # shadowEpsilon-scaled tMax (interaction.h:231)


def occluded(scene, p, p_err, ng, p_light, live=None):
    """VisibilityTester::Unoccluded (light.cpp:56): shadow ray p -> p_light.
    Lanes outside `live` (when given) trace nothing and read unoccluded."""
    o = offset_ray_origin(p, p_err, ng, p_light - p)
    d = p_light - o
    dist = torch.sqrt(torch.clamp(dot(d, d), min=1e-20))
    t_max = dist * _SHADOW_EPS
    if live is not None:
        t_max = torch.where(live, t_max, 0.0)
    return tv.intersect_any(scene, o, d / dist[:, None], t_max)


def _cheap_hit_normal(scene, o, d, t, prim_id):
    """Geometric normal of a hit without the full hit record (the two-sided
    emission test only needs ng): one triangle-row gather, or the sphere's
    implicit gradient."""
    hit = prim_id >= 0
    pid = torch.clamp(prim_id.to(torch.int64), 0, scene.prim_meta.shape[0] - 1)
    meta = scene.prim_meta[pid]
    ptype = meta[:, 0]
    pidx = meta[:, 1].to(torch.int64)
    attr = scene.tri_attr[torch.clamp(pidx, 0, scene.tri_attr.shape[0] - 1)]
    ng = normalize(cross(attr[:, 3:6] - attr[:, 0:3], attr[:, 6:9] - attr[:, 0:3]))
    has_n = attr[:, 24] > 0.0
    flip = has_n & (dot(ng, attr[:, 15:18]) < 0.0)
    ng = torch.where(flip[:, None], -ng, ng)
    if scene.quadric_types:
        qi = torch.clamp(pidx, 0, scene.q_packed.shape[0] - 1)
        w2o = scene.q_packed[qi, :12].view(-1, 3, 4)
        p_w = o + torch.where(torch.isfinite(t), t, 0.0)[:, None] * d
        g = xform_vector(w2o, p_w) + w2o[:, :, 3]  # object-space hit point
        # world normal = w2o^T applied to the normalised gradient
        gw = normalize(torch.stack(
            [dot(w2o[:, :, j], normalize(g)) for j in range(3)], -1))
        is_q = ptype == sc.SHAPE_SPHERE
        rev = scene.q_rev[qi]
        gw = torch.where((is_q & rev)[:, None], -gw, gw)
        ng = torch.where(is_q[:, None], gw, ng)
    return torch.where(hit[:, None], ng, 0.0)


def estimate_direct(scene, rec, frame, mat, wo_local, light_idx, u_light,
                    u_scattering, mask, extra_ray=None, extra_live=None,
                    tr_fn=None, isect_tr_fn=None, bsdf_sample=None,
                    mat_types=None):
    """EstimateDirect (integrator.cpp:108-215), specular = false.  Returns
    (Ld [n, 3], extra_hits): with extra_ray = (o3, d3), rays traced in the
    same launch (live where extra_live), extra_hits is their (t3, prim3),
    else None.

    handleMedia = true: tr_fn(p, p_err, ng, p_light, live) -> (occluded,
    Tr [n, 3]) traces the shadow ray (VisibilityTester::Tr) and
    isect_tr_fn(o, d, live) -> (t, prim, Tr) the MIS ray
    (Scene::IntersectTr), each live where `live` (only those lanes' answers
    are read); then no extension ray rides along.

    bsdf_sample: sample_material's result at u_scattering when the caller
    drew it already (the path integrator draws it in one call with its
    next bounce's sample: half the host's operations of the two).

    mat_types: the material types mat's lanes can have, the scene's by
    default (the path integrator's BSSRDF exit point passes the adapter's)."""
    mat_types = scene.mat_types if mat_types is None else mat_types
    light_types = scene.light_types
    ss, ts, ns = frame
    n = light_idx.shape[0]
    dev = light_idx.device

    # light-sampling strategy
    with record_function("layer: lights"):
        s = lt.sample_li(scene, light_idx, rec["p"], u_light, light_types)
    wi_world = s["wi"]
    with record_function("layer: materials"):
        f, scattering_pdf = bx.eval_material(mat, wo_local,
                                             bx.to_local(ss, ts, ns, wi_world),
                                             mat_types)
    f = f * absdot(wi_world, ns)[:, None]
    usable = (mask & (s["pdf"] > 0.0) & torch.any(s["li"] > 0.0, -1)
              & torch.any(f != 0.0, -1))
    weight = torch.where(s["is_delta"], 1.0,
                         smp.power_heuristic(1.0, s["pdf"], 1.0, scattering_pdf))

    # BSDF-sampling strategy (non-delta lights only)
    bs = bsdf_sample
    if bs is None:
        with record_function("layer: materials"):
            bs = bx.sample_material(mat, wo_local, u_scattering, mat_types)
    wi2_world = bx.to_world(ss, ts, ns, bs["wi"])
    f2 = bs["f"] * absdot(wi2_world, ns)[:, None]
    do_bsdf = mask & ~s["is_delta"] & bs["valid"]
    o2 = offset_ray_origin(rec["p"], rec["p_error"], rec["ng"], wi2_world)
    with record_function("layer: lights"):
        light_pdf2 = lt.pdf_li(scene, light_idx, o2, wi2_world, light_types)
    weight2 = torch.where(bs["is_specular"], 1.0,
                          smp.power_heuristic(1.0, bs["pdf"], 1.0, light_pdf2))
    zero_light_pdf = ~bs["is_specular"] & (light_pdf2 == 0.0)
    do_bsdf = do_bsdf & ~zero_light_pdf & (bs["pdf"] > 0.0)

    trv = trv2 = extra_hits = None
    if tr_fn is not None:
        if extra_ray is not None:
            raise ValueError("an extension ray rides the merged launch only")
        occ, trv = tr_fn(rec["p"], rec["p_error"], rec["ng"], s["p_light"], mask)
        t2, prim2, trv2 = isect_tr_fn(o2, wi2_world, mask)
    else:  # one traversal launch: [shadow (any-hit) | MIS | extension]
        w_sh = s["p_light"] - rec["p"]
        o_sh = offset_ray_origin(rec["p"], rec["p_error"], rec["ng"], w_sh)
        d_sh = s["p_light"] - o_sh
        dist = torch.sqrt(torch.clamp(dot(d_sh, d_sh), min=1e-20))
        live = mask.to(torch.float32)
        far = torch.full((n,), 1e30, dtype=torch.float32, device=dev)
        o_cat = [o_sh, o2]
        d_cat = [d_sh / dist[:, None], wi2_world]
        t_max = [dist * _SHADOW_EPS * live, far * live]
        if extra_ray is not None:
            o_cat.append(extra_ray[0])
            d_cat.append(extra_ray[1])
            t_max.append(far * extra_live.to(torch.float32))
        t_cat, prim_cat = tv.intersect_closest(
            scene, torch.cat(o_cat), torch.cat(d_cat), torch.cat(t_max),
            any_mask=torch.cat([torch.ones(n, dtype=torch.bool, device=dev),
                                torch.zeros((len(o_cat) - 1) * n,
                                            dtype=torch.bool, device=dev)]),
        )
        occ = prim_cat[:n] >= 0
        t2, prim2 = t_cat[n:2 * n], prim_cat[n:2 * n]
        if extra_ray is not None:
            extra_hits = (t_cat[2 * n:], prim_cat[2 * n:])

    li = torch.where((usable & ~occ)[:, None], s["li"], 0.0)
    if trv is not None:
        li = li * trv
    pdf_l = torch.where(usable, s["pdf"], 1.0)
    ld = torch.where(usable[:, None],
                     f * li * (weight / torch.clamp(pdf_l, min=1e-20))[:, None],
                     0.0)

    hit2 = prim2 >= 0
    pid2 = torch.clamp(prim2.to(torch.int64), 0, scene.prim_meta.shape[0] - 1)
    hit_light = torch.where(hit2, scene.prim_meta[pid2, 3], -1)
    same_light = hit2 & (hit_light == light_idx)
    rec2_ng = _cheap_hit_normal(scene, o2, wi2_world, t2, prim2)
    li2 = lt.area_light_emission(scene, hit_light, rec2_ng, -wi2_world)
    li2 = torch.where(same_light[:, None], li2, 0.0)
    li2 = torch.where(hit2[:, None], li2,
                      lt.escaped_radiance(scene, wi2_world, light_types))
    if trv2 is not None:
        li2 = li2 * trv2
    pdf_b = torch.where(do_bsdf, bs["pdf"], 1.0)
    ld = ld + torch.where(
        do_bsdf[:, None],
        f2 * li2 * (weight2 / torch.clamp(pdf_b, min=1e-20))[:, None], 0.0)
    return ld, extra_hits


def sample_one_light(scene, rec, frame, mat, wo_local, u_select, u_light,
                     u_scattering, mask, extra_ray=None, pick=None,
                     tr_fn=None, isect_tr_fn=None, bsdf_sample=None,
                     mat_types=None):
    """UniformSampleOneLight (integrator.cpp:85-106): pick one light from the
    scene's light distribution, or take the per-lane (light_idx, pmf) of the
    spatial distribution (lightdistrib.cpp:135) when `pick` is given,
    estimate direct lighting, divide by its pmf.  Returns (Ld,
    extra_hits) as estimate_direct does; tr_fn, isect_tr_fn, bsdf_sample
    and mat_types as there."""
    if pick is not None:
        light_idx, pmf = pick
    else:
        light_idx, pmf = smp.sample_discrete_1d(scene.light_distr, u_select)
    ld, extra_hits = estimate_direct(
        scene, rec, frame, mat, wo_local, light_idx, u_light, u_scattering,
        mask & (pmf > 0.0), extra_ray, extra_live=mask, tr_fn=tr_fn,
        isect_tr_fn=isect_tr_fn, bsdf_sample=bsdf_sample, mat_types=mat_types)
    return ld / torch.clamp(pmf, min=1e-20)[:, None], extra_hits


def sample_bssrdf_sp(scene, rec, frame, mat, u1, u2, n_probe: int = 4,
                     live=None):
    """SeparableBSSRDF::Sample_Sp (bssrdf.cpp:248-330): an exit point near
    the entry point rec (common.py:331-422).  Picks the projection axis
    (1/2 the shading normal, 1/4 each tangent) and the channel from u1, a
    radius from u2[0] and an angle from u2[1], then walks the probe
    segment through the surface in n_probe bounded closest-hit launches
    (t_max = the rest of the segment times shadowEpsilon's scale),
    collects the hits on rec's material and picks one.  pbrt's walk is
    unbounded (bssrdf.cpp:295-320); hits past n_probe are dropped, as in
    the JAX package.

    live: the lanes to walk (all by default).  The others, and lanes whose
    walk has ended, trace with t_max = 0 from a finite ray, so the work
    list puts them last; the walking lanes' hits are those of the JAX
    package's walk of every lane.  Returns dict: ok, sp [n, 3], pdf [n],
    nfound [n] and the exit point's p, p_error, ns, ng and dpdu (read
    where ok)."""
    from ..materials import bssrdf as bsx

    ss_ax, ts_ax, ns_ax = frame
    n = u1.shape[0]
    dev = u1.device
    pick0 = (u1 < 0.5)[:, None]
    pick1 = ((u1 >= 0.5) & (u1 < 0.75))[:, None]
    vx = torch.where(pick0, ss_ax, torch.where(pick1, ts_ax, ns_ax))
    vy = torch.where(pick0, ts_ax, torch.where(pick1, ns_ax, ss_ax))
    vz = torch.where(pick0, ns_ax, torch.where(pick1, ss_ax, ts_ax))
    u1r = torch.where(u1 < 0.5, u1 * 2.0,
                      torch.where(u1 < 0.75, (u1 - 0.5) * 4.0, (u1 - 0.75) * 4.0))
    ch = torch.clamp((u1r * 3.0).to(torch.int32), 0, 2)  # bssrdf.cpp:274-277
    u1r = u1r * 3.0 - ch.to(torch.float32)
    chl = ch.to(torch.int64)[:, None]
    sigma_t_ch = torch.gather(mat["ss_sigma_t"], 1, chl)[:, 0]
    rho_ch = torch.gather(mat["ss_rho"], 1, chl)[:, 0]
    tbl = mat["ss_table"]
    tables = (scene.bssrdf_rho_nodes, scene.bssrdf_radius_nodes,
              scene.bssrdf_profile)
    # the radius and the probe sphere's, r_max = Sample_Sr(0.999), in one call
    with record_function("layer: subsurface / sr sampling"):
        both = bsx.sample_sr(*tables, scene.bssrdf_cdf, torch.cat([tbl, tbl]),
                             torch.cat([sigma_t_ch, sigma_t_ch]),
                             torch.cat([rho_ch, rho_ch]),
                             torch.cat([u2[:, 0], torch.full_like(u1, 0.999)]))
    r, r_max = both[:n], both[n:]
    ok = (r >= 0.0) & (r < r_max)
    phi = 2.0 * math.pi * u2[:, 1]
    l = 2.0 * safe_sqrt(r_max * r_max - r * r)
    p_start = (rec["p"] + r[:, None] * (vx * torch.cos(phi)[:, None]
                                        + vy * torch.sin(phi)[:, None])
               - 0.5 * l[:, None] * vz)
    p_target = p_start + l[:, None] * vz

    walking = ok if live is None else ok & live
    safe_o = torch.where(walking[:, None], p_start, 0.0)
    up = torch.tensor([0.0, 0.0, 1.0], device=dev)
    cur_o = p_start
    nfound = torch.zeros(n, dtype=torch.int32, device=dev)
    hits = []
    for _ in range(n_probe):
        seg = p_target - cur_o
        dist = torch.sqrt(torch.clamp(dot(seg, seg), min=1e-20))
        d = seg / dist[:, None]
        t, prim = tv.intersect_closest(
            scene, torch.where(walking[:, None], cur_o, safe_o),
            torch.where(walking[:, None], d, up),
            torch.where(walking, dist * _SHADOW_EPS, 0.0))
        hrec = tv.hit_record(scene, cur_o, d, t, prim)
        found = hrec["hit"] & walking
        match = found & (hrec["material"] == rec["material"])
        hits.append((match, hrec))
        nfound = nfound + match.to(torch.int32)
        walking = found
        adv = offset_ray_origin(hrec["p"], hrec["p_error"], hrec["ng"],
                                p_target - hrec["p"])
        cur_o = torch.where(found[:, None], adv, cur_o)

    ok = ok & (nfound > 0)
    sel = torch.minimum((u1r * nfound.to(torch.float32)).to(torch.int32),
                        torch.clamp(nfound - 1, min=0))
    sel = torch.clamp(sel, min=0)
    keys = ("p", "p_error", "ns", "ng", "dpdu")
    pi = {k: torch.zeros_like(rec[k]) for k in keys}
    cum = torch.zeros(n, dtype=torch.int32, device=dev)
    for match, hrec in hits:
        use = (match & (cum == sel))[:, None]
        for k in keys:
            pi[k] = torch.where(use, hrec[k], pi[k])
        cum = cum + match.to(torch.int32)
    dist_po = torch.sqrt(torch.clamp(torch.sum((rec["p"] - pi["p"]) ** 2, -1),
                                     min=1e-20))
    sp = bsx.sr_eval(*tables, tbl, mat["ss_sigma_t"], mat["ss_rho"], dist_po)
    pdf = bsx.pdf_sp(*tables, scene.bssrdf_rho_eff, tbl, mat["ss_sigma_t"],
                     mat["ss_rho"], rec["p"], ss_ax, ts_ax, ns_ax, pi["p"],
                     pi["ng"])
    pdf = pdf / torch.clamp(nfound.to(torch.float32), min=1.0)
    ok = ok & (pdf > 0.0) & torch.any(sp > 0.0, -1)
    return dict(ok=ok, sp=sp, pdf=pdf, nfound=nfound, **pi)
