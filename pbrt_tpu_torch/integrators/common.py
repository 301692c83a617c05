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
"""
from __future__ import annotations

import torch

from .. import scene as sc
from ..accel import traverse as tv
from ..core import sampling as smp
from ..core.vecmath import absdot, cross, dot, normalize, offset_ray_origin
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
                    tr_fn=None, isect_tr_fn=None):
    """EstimateDirect (integrator.cpp:108-215), specular = false.  Returns
    (Ld [n, 3], extra_hits): with extra_ray = (o3, d3), rays traced in the
    same launch (live where extra_live), extra_hits is their (t3, prim3),
    else None.

    handleMedia = true: tr_fn(p, p_err, ng, p_light, live) -> (occluded,
    Tr [n, 3]) traces the shadow ray (VisibilityTester::Tr) and
    isect_tr_fn(o, d, live) -> (t, prim, Tr) the MIS ray
    (Scene::IntersectTr), each live where `live` (only those lanes' answers
    are read); then no extension ray rides along."""
    mat_types = scene.mat_types
    light_types = scene.light_types
    ss, ts, ns = frame
    n = light_idx.shape[0]
    dev = light_idx.device

    # light-sampling strategy
    s = lt.sample_li(scene, light_idx, rec["p"], u_light, light_types)
    wi_world = s["wi"]
    f, scattering_pdf = bx.eval_material(mat, wo_local,
                                         bx.to_local(ss, ts, ns, wi_world),
                                         mat_types)
    f = f * absdot(wi_world, ns)[:, None]
    usable = (mask & (s["pdf"] > 0.0) & torch.any(s["li"] > 0.0, -1)
              & torch.any(f != 0.0, -1))
    weight = torch.where(s["is_delta"], 1.0,
                         smp.power_heuristic(1.0, s["pdf"], 1.0, scattering_pdf))

    # BSDF-sampling strategy (non-delta lights only)
    bs = bx.sample_material(mat, wo_local, u_scattering, mat_types)
    wi2_world = bx.to_world(ss, ts, ns, bs["wi"])
    f2 = bs["f"] * absdot(wi2_world, ns)[:, None]
    do_bsdf = mask & ~s["is_delta"] & bs["valid"]
    o2 = offset_ray_origin(rec["p"], rec["p_error"], rec["ng"], wi2_world)
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
                     tr_fn=None, isect_tr_fn=None):
    """UniformSampleOneLight (integrator.cpp:85-106): pick one light from the
    scene's light distribution, or take the per-lane (light_idx, pmf) of the
    spatial distribution (lightdistrib.cpp:135) when `pick` is given,
    estimate direct lighting, divide by its pmf.  Returns (Ld,
    extra_hits) as estimate_direct does; tr_fn and isect_tr_fn as there."""
    if pick is not None:
        light_idx, pmf = pick
    else:
        light_idx, pmf = smp.sample_discrete_1d(scene.light_distr, u_select)
    ld, extra_hits = estimate_direct(
        scene, rec, frame, mat, wo_local, light_idx, u_light, u_scattering,
        mask & (pmf > 0.0), extra_ray, extra_live=mask, tr_fn=tr_fn,
        isect_tr_fn=isect_tr_fn)
    return ld / torch.clamp(pmf, min=1e-20)[:, None], extra_hits
