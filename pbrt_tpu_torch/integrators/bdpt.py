"""The bidirectional path tracer.

Port of pbrt_tpu/integrators/bdpt.py (integrators/bdpt.{h,cpp}): each
subpath is a Python list of per-depth vertex dicts of flat [n, ...]
tensors, and every (s, t) strategy is unrolled, so vertex lookups are
list indexing.

  * generate_camera_subpath / generate_light_subpath share _random_walk
    (bdpt.cpp:50-123), which records beta, pdf_fwd, pdf_rev and delta a
    vertex;
  * connect (ConnectBDPT, bdpt.cpp:300+) for one strategy: s = 0 (the
    camera path hits a light), s = 1 (a light sample), t = 1 (a camera
    sample, splatted on the film), and s, t >= 2 (G and visibility);
  * _mis_weight (MISWeight, bdpt.cpp:230-294) with the four strategies'
    pdfRev overrides as explicit values.

As in the JAX package but one: surface vertices only; the light is
picked from the scene's light distribution (never the spatial one); the
light subpath starts at le["o"] + n_light * 1e-4 (not offset_ray_origin);
the (1, 1) strategy is skipped; lights are point, spot, distant and
diffuse area (sphere, triangle); the camera is the perspective pinhole.
The one: an s = 1 strategy's MIS weight reads the sampled light point's
own normal, as pbrt-v3 does, where the JAX package puts -wi
(BDPTConfig.light_normal keeps its choice for the tests).  The port
refuses what the JAX package would render as something else
(check_transport_scene): media, subsurface, a bound texture, an infinite,
projection or goniometric light, another camera or a lens, the exact
sampler mode.

Sampler dims: the camera's 5, then 2 a camera-walk step (max_depth + 1
steps); the light subpath's 1 + 2 + 2, then 2 a step (max_depth steps);
the s = 1 strategies 3 at 200 + 3 t.  halton and sobol read them without
the path integrator's table; the random sampler draws in the JAX
package's call order.

Traversal launches a sample at depth D: D + 1 for the camera walk, D for
the light walk, then one a strategy that traces (t = 1 with s >= 2, s = 1
with t >= 2, and s, t >= 2): 31 at depth 5.  Dead lanes trace rays of
length 0; every live lane counts in the ray counters (walks as regular
tests, connections as shadow tests).  Profiler ranges: "layer: bdpt /
walks", "layer: bdpt / connections", "layer: film".
"""
from __future__ import annotations

import dataclasses

import torch
from torch.profiler import record_function

from .. import film as fm
from .. import scene as sc
from ..accel import traverse as tv
from ..cameras import CameraParams, generate_rays
from ..cameras.cameras import CAM_PERSPECTIVE, camera_pdf_we, camera_sample_wi
from ..core import sampling as smp
from ..core.vecmath import absdot, dot, normalize, offset_ray_origin
from ..filters import make_filter
from ..lights import lights as lt
from ..materials import bsdf as bx
from ..samplers import samplers as sa
from ..scene import SceneArrays, resolve_device
from ..utils import stats as st
from .common import _SHADOW_EPS


@dataclasses.dataclass(frozen=True)
class BDPTConfig:
    """max_depth as pbrt's.  light_normal: the normal of the light vertex
    that an s = 1 strategy samples, in its MIS weight: "surface", the area
    light's own (pbrt-v3: the Interaction Sample_Li returns), or
    "stand-in", -wi, the JAX package's (bdpt.py:440-450), whose weights
    then sum to less than one (9% dark on a floor and wall under a small
    far sphere light at depth 1); the tests hold the port to the JAX
    package with it."""
    max_depth: int = 5
    light_normal: str = "surface"

    def __post_init__(self):
        if self.light_normal not in ("surface", "stand-in"):
            raise ValueError(f"light_normal {self.light_normal!r}")


def check_transport_scene(name: str, scene: SceneArrays, camera=None,
                          sampler_cfg=None):
    """Raise NotImplementedError, naming the integrator and the feature,
    where the JAX package's bdpt, mlt or sppm would render something other
    than pbrt-v3: media (surface vertices only), subsurface, a bound
    texture (their material gathers take no texture values), an infinite,
    projection or goniometric light (sample_le leaves them dark), a camera
    other than the perspective pinhole (bdpt and mlt: the camera's
    importance; pass camera=None for sppm) and the exact sampler mode."""
    def refuse(feature):
        raise NotImplementedError(
            f"integrator {name!r} with {feature}: the JAX package's {name} "
            "does not render it as pbrt-v3 does, so the port refuses it")

    if scene.has_media:
        refuse("media")
    if sc.MAT_SUBSURFACE in scene.mat_types:
        refuse("a subsurface material")
    if scene.has_textures:
        refuse("a texture bound to a material parameter")
    for t, what in ((sc.LIGHT_INFINITE, "an infinite light"),
                    (sc.LIGHT_PROJECTION, "a projection light"),
                    (sc.LIGHT_GONIO, "a goniometric light")):
        if t in scene.light_types:
            refuse(what)
    if camera is not None and (not isinstance(camera, CameraParams)
                               or camera.cam_type != CAM_PERSPECTIVE):
        refuse("a camera other than perspective")
    if camera is not None and camera.host_lens_radius > 0.0:
        refuse("a lens radius above 0")
    if sampler_cfg is not None and sampler_cfg.exact:
        refuse("the exact sampler mode")


def _remap0(x):
    return torch.where(x == 0.0, 1.0, x)


def _convert_density(pdf_sa, p_from, p_to, ng_to, to_is_surface):
    """Vertex::ConvertDensity (bdpt.h:150): solid angle to area measure."""
    w = p_to - p_from
    inv_d2 = 1.0 / torch.clamp(torch.sum(w * w, -1), min=1e-12)
    cos_f = torch.where(to_is_surface,
                        torch.abs(dot(ng_to, w * torch.sqrt(inv_d2)[:, None])), 1.0)
    return pdf_sa * cos_f * inv_d2


def _light_pick_pmf(scene, light_idx):
    d = scene.light_distr
    nl = d.func.shape[-1]
    li = torch.clamp(light_idx.to(torch.int64), 0, nl - 1)
    pmf = torch.where(d.func_int > 0.0,
                      d.func[li] / torch.clamp(d.func_int * nl, min=1e-30), 0.0)
    return torch.where(light_idx >= 0, pmf, 0.0)


def trace(scene, o, d, live, counters):
    """Closest hit of the live lanes (t, prim); the others trace a finite
    ray of length 0.  Counts the live lanes as regular tests."""
    st.bump(counters, "Intersections/Regular ray intersection tests", live)
    o = torch.where(live[:, None], o, 0.0)
    d = torch.where(live[:, None], d, torch.tensor([0.0, 0.0, 1.0], device=d.device))
    return tv.intersect_closest(scene, o, d, torch.where(live, 1e30, 0.0))


def occluded(scene, p, p_err, ng, p_light, live, counters):
    """common.occluded (VisibilityTester::Unoccluded) for the live lanes;
    the others read unoccluded and trace a ray of length 0."""
    lv = live[:, None]
    p = torch.where(lv, p, 0.0)
    p_err = torch.where(lv, p_err, 0.0)
    ng = torch.where(lv, ng, torch.tensor([0.0, 0.0, 1.0], device=p.device))
    p_light = torch.where(lv, p_light, p + ng)
    o = offset_ray_origin(p, p_err, ng, p_light - p)
    d = p_light - o
    dist = torch.sqrt(torch.clamp(dot(d, d), min=1e-20))
    st.bump(counters, "Intersections/Shadow ray intersection tests", live)
    mask = torch.ones_like(live)
    _, prim = tv.intersect_closest(scene, o, d / dist[:, None],
                                   torch.where(live, dist * _SHADOW_EPS, 0.0),
                                   any_mask=mask)
    return prim >= 0


def gather_vertex_material(scene, mat_id, uv):
    """The material of a vertex, without texture values (the JAX package's
    bdpt.py:82, sppm.py:109)."""
    return bx.gather_material(scene.materials, mat_id, None, scene.mat_types,
                              scene.mix_sub_types, uv=uv)


def _surface_vertex(scene, rec, beta):
    n = rec["t"].shape[0]
    zeros = torch.zeros(n, dtype=torch.float32, device=beta.device)
    return {
        "exists": rec["hit"], "p": rec["p"], "p_error": rec["p_error"],
        "ng": rec["ng"], "ns": rec["ns"], "dpdu": rec["dpdu"], "ss": rec["ss"],
        "uv": rec["uv"], "wo": rec["wo"],
        "mat": gather_vertex_material(scene, rec["material"], rec["uv"]),
        "mat_id": rec["material"], "light_idx": rec["arealight"],
        "beta": beta, "pdf_fwd": zeros, "pdf_rev": zeros,
        "delta": torch.zeros(n, dtype=torch.bool, device=beta.device),
        "is_surface": torch.ones(n, dtype=torch.bool, device=beta.device),
    }


def _vertex_f(scene, v, p_next):
    """Vertex::f: the BSDF from v toward p_next (radiance transport)."""
    wi_l = bx.to_local(*v["frame"], normalize(p_next - v["p"]))
    return bx.eval_material(v["mat"], v["wo_l"], wi_l, scene.mat_types)[0]


def _vertex_pdf(scene, v, p_prev, p_next, ng_next, next_is_surface):
    """Vertex::Pdf at a surface vertex: the BSDF's pdf of prev -> v -> next,
    in area measure at next."""
    ss, ts, ns = v["frame"]
    wo_l = bx.to_local(ss, ts, ns, normalize(p_prev - v["p"]))
    wi_l = bx.to_local(ss, ts, ns, normalize(p_next - v["p"]))
    _, pdf_sa = bx.eval_material(v["mat"], wo_l, wi_l, scene.mat_types)
    return _convert_density(pdf_sa, v["p"], p_next, ng_next, next_is_surface)


def _random_walk(scene, o, d, beta, pdf_dir, n_steps, sampler_cfg, state,
                 dim0, first_vertex_p, first_vertex_ng, counters):
    """RandomWalk (bdpt.cpp:69-123): up to n_steps surface vertices.
    Returns (vertices, dims consumed); each vertex's pdf_rev is its
    successor's "prev_pdf_rev"."""
    verts = []
    dim = dim0
    pdf_fwd_sa = pdf_dir
    prev_p, prev_ng = first_vertex_p, first_vertex_ng
    alive = torch.any(beta != 0.0, -1) & (pdf_dir > 0.0)
    surface = torch.ones_like(alive)
    for _ in range(n_steps):
        t, prim = trace(scene, o, d, alive, counters)
        rec = tv.hit_record(scene, o, d, t, prim)
        exists = rec["hit"] & alive & (rec["material"] >= 0)
        v = _surface_vertex(scene, rec, beta)
        v["exists"] = exists
        v["pdf_fwd"] = torch.where(
            exists, _convert_density(pdf_fwd_sa, prev_p, rec["p"], rec["ng"], surface),
            0.0)
        u = sa.get_2d(sampler_cfg, state, dim)
        dim += 2
        ss, ts, ns = v["frame"] = bx.frame_from_rec(rec)
        wo_l = v["wo_l"] = bx.to_local(ss, ts, ns, rec["wo"])
        bs = bx.sample_material(v["mat"], wo_l, u, scene.mat_types)
        wi_w = bx.to_world(ss, ts, ns, bs["wi"])
        v["delta"] = bs["is_specular"] & exists
        # the reverse pdf toward the previous vertex (bdpt.cpp:109-117)
        _, pdf_rev_sa = bx.eval_material(v["mat"], bs["wi"], wo_l, scene.mat_types)
        v["prev_pdf_rev"] = torch.where(
            exists, _convert_density(pdf_rev_sa, rec["p"], prev_p, prev_ng, surface),
            0.0)
        verts.append(v)
        contrib = bs["f"] * (absdot(wi_w, ns)
                             / torch.clamp(bs["pdf"], min=1e-20))[:, None]
        alive = exists & bs["valid"]
        beta = torch.where(alive[:, None], beta * contrib, 0.0)
        pdf_fwd_sa = torch.where(bs["is_specular"], bs["pdf"] * 0.0 + 1.0, bs["pdf"])
        pdf_fwd_sa = torch.where(alive, pdf_fwd_sa, 0.0)
        prev_p, prev_ng = rec["p"], rec["ng"]
        o = offset_ray_origin(rec["p"], rec["p_error"], rec["ng"], wi_w)
        d = wi_w
    for i in range(1, len(verts)):
        verts[i - 1]["pdf_rev"] = verts[i]["prev_pdf_rev"]
    return verts, dim


def generate_camera_subpath(scene, camera, pixels, sampler_cfg, state, cfg,
                            counters, n_steps=None):
    """GenerateCameraSubpath (bdpt.cpp:50-64): the camera vertex and a
    (max_depth + 1)-step walk, or its first n_steps steps (the vertices a
    shorter path reads are the same).  Returns (vertices, the dims of the
    whole walk's schedule, p_film)."""
    n = pixels.shape[0]
    dev = pixels.device
    p_film, time_u, p_lens = sa.get_camera_sample(sampler_cfg, state, pixels)
    o, d, _, _ = generate_rays(camera, p_film, p_lens, time_u)
    _, pdf_dir = camera_pdf_we(camera, o, d)
    ones3 = torch.ones((n, 3), dtype=torch.float32, device=dev)
    cam_v = {
        "exists": torch.ones(n, dtype=torch.bool, device=dev), "p": o,
        "ng": d,  # the forward axis' stand-in; the camera's cos is in We
        "beta": ones3, "pdf_fwd": torch.ones(n, dtype=torch.float32, device=dev),
        "pdf_rev": torch.zeros(n, dtype=torch.float32, device=dev),
        "delta": torch.zeros(n, dtype=torch.bool, device=dev),
        "is_surface": torch.zeros(n, dtype=torch.bool, device=dev),
    }
    steps = cfg.max_depth + 1
    walk, _ = _random_walk(scene, o, d, ones3, pdf_dir,
                           steps if n_steps is None else n_steps, sampler_cfg, state,
                           5, o, torch.zeros_like(o), counters)
    return [cam_v] + walk, 5 + 2 * steps, p_film


def generate_light_subpath(scene, n, sampler_cfg, state, cfg, dim0, counters,
                           device, n_steps=None):
    """GenerateLightSubpath (bdpt.cpp:66-123): pick a light, Sample_Le,
    walk max_depth steps (or the first n_steps).  Returns (vertices, the
    dims of the whole walk's schedule)."""
    u_pick = sa.get_1d(sampler_cfg, state, dim0)
    u_pos = sa.get_2d(sampler_cfg, state, dim0 + 1)
    u_dir = sa.get_2d(sampler_cfg, state, dim0 + 3)
    light_idx, pmf = smp.sample_discrete_1d(scene.light_distr, u_pick)
    le = lt.sample_le(scene, light_idx, u_pos, u_dir, scene.light_types)
    pdf_pos, pdf_dir, nl = le["pdf_pos"], le["pdf_dir"], le["n_light"]
    cos_e = torch.abs(dot(nl, le["d"]))
    denom = torch.clamp(pmf * pdf_pos * pdf_dir, min=1e-20)
    beta1 = le["le"] * (cos_e / denom)[:, None]
    light_v = {
        "exists": (pdf_pos > 0.0) & (pmf > 0.0), "p": le["o"], "ng": nl,
        "beta": le["le"] / torch.clamp(pmf * pdf_pos, min=1e-20)[:, None],
        "pdf_fwd": pmf * pdf_pos,
        "pdf_rev": torch.zeros(n, dtype=torch.float32, device=device),
        # Vertex::delta marks specular BSDF vertices; a light's delta
        # position is IsDeltaLight, read at the path's end in _mis_weight
        "delta": torch.zeros(n, dtype=torch.bool, device=device),
        "is_delta_light": le["is_delta_pos"],
        "is_surface": torch.zeros(n, dtype=torch.bool, device=device),
        "light_idx": light_idx,
    }
    o = le["o"] + nl * 1e-4  # off the light's surface (bdpt.py:254)
    walk, _ = _random_walk(scene, o, le["d"], beta1, pdf_dir,
                           cfg.max_depth if n_steps is None else n_steps,
                           sampler_cfg, state, dim0 + 5, le["o"], nl, counters)
    if walk:
        light_v["pdf_rev"] = walk[0]["prev_pdf_rev"]
    return [light_v] + walk, dim0 + 5 + 2 * cfg.max_depth


def _g_term(scene, va, vb, live, counters):
    """G(va <-> vb) with visibility (bdpt.cpp:228-240); the shadow ray
    spawns from va with its error bounds and geometric normal."""
    d = vb["p"] - va["p"]
    d2 = torch.clamp(torch.sum(d * d, -1), min=1e-12)
    w = d / torch.sqrt(d2)[:, None]
    g = torch.abs(dot(va["ns"], w)) * torch.abs(dot(vb["ns"], w)) / d2
    occ = occluded(scene, va["p"], va["p_error"], va["ng"], vb["p"], live, counters)
    return torch.where(occ, 0.0, g)


def _mis_weight(cam_vs, light_vs, s, t, overrides):
    """MISWeight (bdpt.cpp:230-294) for strategy (s, t) with the pdfRev
    overrides {(side, index): value}."""
    if s + t == 2:
        return torch.ones_like(cam_vs[0]["pdf_fwd"])

    def pr(side, vs, i):
        return overrides.get((side, i), vs[i]["pdf_rev"])

    sum_ri = torch.zeros_like(cam_vs[0]["pdf_fwd"])
    ri = torch.ones_like(sum_ri)
    for i in range(t - 1, 0, -1):
        ri = ri * _remap0(pr("c", cam_vs, i)) / _remap0(cam_vs[i]["pdf_fwd"])
        nd = ~cam_vs[i]["delta"] & ~cam_vs[i - 1]["delta"]
        sum_ri = sum_ri + torch.where(nd, ri, 0.0)
    ri = torch.ones_like(sum_ri)
    for i in range(s - 1, -1, -1):
        ri = ri * _remap0(pr("l", light_vs, i)) / _remap0(light_vs[i]["pdf_fwd"])
        dl = (light_vs[i - 1]["delta"] if i > 0
              else light_vs[0].get("is_delta_light", light_vs[0]["delta"]))
        sum_ri = sum_ri + torch.where(~light_vs[i]["delta"] & ~dl, ri, 0.0)
    return 1.0 / (1.0 + sum_ri)


def strategies(max_depth: int):
    """The (s, t) strategies of li_bdpt, in its order."""
    return [(s, t) for t in range(1, max_depth + 3) for s in range(0, max_depth + 2)
            if 0 <= t + s - 2 <= max_depth and (s, t) != (1, 1)]


def connect(scene, camera, cam_vs, light_vs, s, t, sampler_cfg, state, counters,
            light_normal: str = "surface"):
    """ConnectBDPT (bdpt.cpp:300+) for strategy (s, t): (contribution
    [n, 3], MIS weight [n], raster [n, 2] for t = 1 or None).
    light_normal as BDPTConfig's."""
    zero = torch.zeros_like(cam_vs[0]["beta"])

    def weighted(contrib, over, light=light_vs):
        w = _mis_weight(cam_vs, light, s, t, over)
        return torch.where(torch.any(contrib != 0.0, -1), w, 0.0)

    if s == 0:
        # the camera path alone; cam_vs[t - 1] must lie on a light
        pt, ptm = cam_vs[t - 1], cam_vs[t - 2]
        is_l = pt["exists"] & (pt["light_idx"] >= 0)
        le = lt.area_light_emission(scene, pt["light_idx"], pt["ng"], pt["wo"])
        contrib = torch.where(is_l[:, None], pt["beta"] * le, zero)
        pmf = _light_pick_pmf(scene, pt["light_idx"])
        pdf_pos, pdf_dir = lt.pdf_le(scene, pt["light_idx"], pt["p"], pt["ng"],
                                     normalize(ptm["p"] - pt["p"]),
                                     scene.light_types)
        over = {("c", t - 1): pmf * pdf_pos,
                ("c", t - 2): _convert_density(pdf_dir, pt["p"], ptm["p"],
                                               ptm["ng"], ptm["is_surface"])}
        return contrib, weighted(contrib, over), None

    if t == 1:
        # light vertex s - 1 to the lens, splatted
        qs, qsm = light_vs[s - 1], light_vs[s - 2]
        cs = camera_sample_wi(camera, qs["p"])
        f_q = _vertex_f(scene, qs, cs["p_cam"])
        live = qs["exists"] & cs["valid"] & (cs["pdf"] > 0.0)
        occ = occluded(scene, qs["p"], qs["p_error"], qs["ng"], cs["p_cam"], live,
                       counters)
        ok = live & ~occ
        contrib = torch.where(
            ok[:, None],
            qs["beta"] * f_q * cs["we"]
            * (absdot(cs["wi"], qs["ns"]) / torch.clamp(cs["pdf"], min=1e-20))[:, None],
            zero)
        _, pdf_dir_c = camera_pdf_we(camera, cs["p_cam"], -cs["wi"])
        over = {("l", s - 1): _convert_density(pdf_dir_c, cs["p_cam"], qs["p"],
                                               qs["ng"], qs["is_surface"]),
                ("l", s - 2): _vertex_pdf(scene, qs, cs["p_cam"], qsm["p"],
                                          qsm["ng"], qsm["is_surface"])}
        return contrib, weighted(contrib, over), cs["p_raster"]

    pt, ptm = cam_vs[t - 1], cam_vs[t - 2]
    if s == 1:
        # a light sample from pt (bdpt.cpp:338-360): a new light vertex
        u_sel = sa.get_1d(sampler_cfg, state, 200 + 3 * t)
        u_l = sa.get_2d(sampler_cfg, state, 201 + 3 * t)
        light_idx, pmf = smp.sample_discrete_1d(scene.light_distr, u_sel)
        sl = lt.sample_li(scene, light_idx, pt["p"], u_l, scene.light_types)
        live = pt["exists"] & (sl["pdf"] > 0.0) & (pmf > 0.0)
        occ = occluded(scene, pt["p"], pt["p_error"], pt["ng"], sl["p_light"], live,
                       counters)
        f_p = _vertex_f(scene, pt, sl["p_light"])
        ok = live & ~occ
        contrib = torch.where(
            ok[:, None],
            pt["beta"] * f_p * sl["li"]
            * (absdot(sl["wi"], pt["ns"])
               / torch.clamp(pmf * sl["pdf"], min=1e-20))[:, None],
            zero)
        # the light's normal at the sampled point, or the JAX package's -wi
        n_q = sl["n_light"] if light_normal == "surface" else -sl["wi"]
        pdf_pos, pdf_dir = lt.pdf_le(scene, light_idx, sl["p_light"], n_q,
                                     normalize(pt["p"] - sl["p_light"]),
                                     scene.light_types)
        q_sampled = {"pdf_fwd": pmf * pdf_pos, "pdf_rev": torch.zeros_like(pmf),
                     "delta": torch.zeros_like(ok),
                     "is_delta_light": sl["is_delta"]}
        over = {("l", 0): _vertex_pdf(scene, pt, ptm["p"], sl["p_light"], n_q,
                                      ~sl["is_delta"]),
                ("c", t - 1): _convert_density(pdf_dir, sl["p_light"], pt["p"],
                                               pt["ng"], pt["is_surface"]),
                ("c", t - 2): _vertex_pdf(scene, pt, sl["p_light"], ptm["p"],
                                          ptm["ng"], ptm["is_surface"])}
        return contrib, weighted(contrib, over, [q_sampled]), None

    # s >= 2, t >= 2
    qs, qsm = light_vs[s - 1], light_vs[s - 2]
    ok = pt["exists"] & qs["exists"]
    f_p = _vertex_f(scene, pt, qs["p"])
    f_q = _vertex_f(scene, qs, pt["p"])
    g = _g_term(scene, qs, pt, ok, counters)
    contrib = torch.where(ok[:, None],
                          qs["beta"] * f_q * g[:, None] * f_p * pt["beta"], zero)
    over = {("c", t - 1): _vertex_pdf(scene, qs, qsm["p"], pt["p"], pt["ng"],
                                      pt["is_surface"]),
            ("c", t - 2): _vertex_pdf(scene, pt, qs["p"], ptm["p"], ptm["ng"],
                                      ptm["is_surface"]),
            ("l", s - 1): _vertex_pdf(scene, pt, ptm["p"], qs["p"], qs["ng"],
                                      qs["is_surface"]),
            ("l", s - 2): _vertex_pdf(scene, qs, pt["p"], qsm["p"], qsm["ng"],
                                      qsm["is_surface"])}
    return contrib, weighted(contrib, over), None


def li_bdpt(scene, camera, pixels, sampler_cfg, state, cfg: BDPTConfig, counters):
    """Every strategy's weighted estimate for one sample batch.  Returns (L
    [n, 3] of the t >= 2 strategies, the t = 1 splats [(raster, value)],
    p_film [n, 2])."""
    with record_function("layer: bdpt / walks"):
        cam_vs, dim_c, p_film = generate_camera_subpath(
            scene, camera, pixels, sampler_cfg, state, cfg, counters)
        light_vs, _ = generate_light_subpath(scene, pixels.shape[0], sampler_cfg,
                                             state, cfg, dim_c, counters,
                                             pixels.device)
    L = torch.zeros_like(cam_vs[0]["beta"])
    splats = []
    with record_function("layer: bdpt / connections"):
        for s, t in strategies(cfg.max_depth):
            contrib, weight, raster = connect(scene, camera, cam_vs, light_vs, s, t,
                                              sampler_cfg, state, counters,
                                              cfg.light_normal)
            wc = contrib * weight[:, None]
            if t == 1:
                splats.append((raster, wc))
            else:
                L = L + wc
    return L, splats, p_film


def render_sample_batch(scene, camera, film_state, pixels, sample_num: int,
                        sampler_cfg, cfg: BDPTConfig, counters):
    """One sample a pixel into film_state (in place): non-finite L and
    splats are zeroed (bdpt.py:524-542)."""
    n = pixels.shape[0]
    state = sa.init_state(sampler_cfg, pixels,
                          torch.full((n,), sample_num, dtype=torch.int64,
                                     device=pixels.device))
    st.bump(counters, "Integrator/Camera rays traced", float(n))
    L, splats, p_film = li_bdpt(scene, camera, pixels, sampler_cfg, state, cfg,
                                counters)
    with record_function("layer: film"):
        L = torch.where(torch.all(torch.isfinite(L), -1)[:, None], L, 0.0)
        fm.add_samples(film_state, p_film, L)
        st.bump(counters, "Film/Samples added", float(n))
        for raster, v in splats:
            fm.add_splats(film_state, raster,
                          torch.where(torch.all(torch.isfinite(v), -1)[:, None], v, 0.0))
    return film_state


def render(scene: SceneArrays, camera, film_cfg: fm.FilmConfig, sampler_cfg,
           cfg: BDPTConfig = BDPTConfig(), filt=None, count_rays: bool = False,
           stats_out: bool = False, progress=None, device="cuda"):
    """The BDPT render: one batch a sample; the splats scaled by 1 / spp at
    the end (bdpt.cpp:380-392).  On the card unless device="cpu", with the
    scene already there.  Returns the image [H, W, 3]; with count_rays also
    the rays traced, with stats_out also the counter vector."""
    from .path import make_pixel_grid

    device = resolve_device(device)
    if scene.device != device:
        raise ValueError(f"scene is on {scene.device}, render asked for {device}")
    check_transport_scene("bdpt", scene, camera, sampler_cfg)
    camera = camera.to(device)
    film_state = fm.make_film_state(
        film_cfg, filt or make_filter(film_cfg.filter_name), device)
    pixels = torch.as_tensor(make_pixel_grid(film_cfg), device=device)
    counters = st.zeros(device)
    with torch.no_grad():
        for s in range(sampler_cfg.spp):
            render_sample_batch(scene, camera, film_state, pixels, s, sampler_cfg,
                                cfg, counters)
            if progress is not None:
                progress.update(s + 1)
        img = fm.to_image(film_state, scale=film_cfg.scale,
                          splat_scale=1.0 / sampler_cfg.spp)
    if stats_out:
        return img, counters
    if count_rays:
        return img, st.ray_total(counters)
    return img
