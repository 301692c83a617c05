"""Light sampling for point, spot, projection, goniometric and distant
lights, diffuse area lights on spheres and triangles, and infinite lights.

Port of pbrt_tpu/lights/lights.py's Sample_Li and Pdf_Li (lights/point.cpp,
spot.cpp, projection.cpp, goniometric.cpp, distant.cpp, diffuse.cpp,
sphere.cpp:232-318 cone sampling, triangle.cpp Sample and shape.cpp:56
solid-angle conversion, lights/infinite.cpp).  The first five are delta
lights (Pdf_Li 0); a distant light's shadow ray runs to ref_p + w * 2 *
world_radius.  An infinite light with a map is importance-sampled through
the scene's Distribution2D; a constant one samples the uniform sphere.
Escaped rays carry the infinite lights' radiance.

``sample_le`` and ``pdf_le`` (Light::Sample_Le and Pdf_Le, the light
subpaths of bdpt, mlt and sppm) cover the point, spot, distant and
diffuse area lights, as the JAX package's do (lights.py:429-607): its
sample_le leaves projection, goniometric and infinite lights at zero, so
the integrators that call it refuse scenes with those lights.
"""
from __future__ import annotations

import math

import torch

from .. import scene as sc
from ..core import sampling as smp
from ..core.vecmath import (coordinate_system, cross, distance_squared, dot,
                            length, normalize, safe_acos, safe_atan2,
                            safe_sqrt, spherical_direction_basis)
from ..shapes.triangle import intersect_triangle


def _gather_tri(scene, tri_idx):
    vid = scene.tri_indices[torch.clamp(tri_idx, 0, scene.tri_indices.shape[0] - 1)]
    vid = vid.to(torch.int64)
    return scene.tri_p[vid[:, 0]], scene.tri_p[vid[:, 1]], scene.tri_p[vid[:, 2]]


def _sphere_center_radius(scene, q_idx):
    qi = torch.clamp(q_idx, 0, scene.q_type.shape[0] - 1)
    return scene.q_o2w[qi, :3, 3], scene.q_params[qi, 0]


def sample_li(scene, light_idx, ref_p, u, light_types):
    """Light::Sample_Li.  Returns dict: wi, li (radiance), pdf (solid angle),
    p_light (shadow-ray target), n_light (an area light's surface normal
    there, -wi for the others), is_delta."""
    lt = scene.lights
    li_t = lt.light_type[light_idx]
    L = lt.L[light_idx]
    n = ref_p.shape[0]
    wi = torch.zeros_like(ref_p)
    li = torch.zeros_like(ref_p)
    pdf = torch.zeros(n, dtype=torch.float32, device=ref_p.device)
    p_light = torch.zeros_like(ref_p)
    n_light = torch.zeros_like(ref_p)
    is_delta = torch.zeros(n, dtype=torch.bool, device=ref_p.device)

    if sc.LIGHT_POINT in light_types:
        m = li_t == sc.LIGHT_POINT
        pos = lt.pos[light_idx]
        dd = pos - ref_p
        dist2 = torch.clamp(dot(dd, dd), min=1e-12)
        mv = m[:, None]
        wi = torch.where(mv, dd / torch.sqrt(dist2)[:, None], wi)
        li = torch.where(mv, L / dist2[:, None], li)
        pdf = torch.where(m, 1.0, pdf)
        p_light = torch.where(mv, pos, p_light)
        is_delta = is_delta | m

    # the point-like delta lights: the intensity over the squared distance,
    # times the spot's falloff (spot.cpp:60-72, delta^4 between the cone's
    # cosines), the projected map (projection.cpp:87-115) or the angular
    # map (goniometric.cpp:65-92)
    for t in (sc.LIGHT_SPOT, sc.LIGHT_PROJECTION, sc.LIGHT_GONIO):
        if t not in light_types:
            continue
        m = li_t == t
        pos = lt.pos[light_idx]
        dd = pos - ref_p
        dist2 = torch.clamp(dot(dd, dd), min=1e-12)
        wi_m = dd / torch.sqrt(dist2)[:, None]
        if t == sc.LIGHT_SPOT:
            ct = dot(-wi_m, lt.dir[light_idx])
            c0 = lt.cos_falloff_start[light_idx]
            c1 = lt.cos_falloff_end[light_idx]
            delta = torch.clamp((ct - c1) / torch.clamp(c0 - c1, min=1e-9), 0.0, 1.0)
            fall = torch.where(ct < c1, 0.0, torch.where(ct > c0, 1.0, delta ** 4))
            li_m = L * (fall / dist2)[:, None]
        elif t == sc.LIGHT_PROJECTION:
            li_m = L * _projection_factor(lt, -wi_m) * (1.0 / dist2)[:, None]
        else:
            li_m = L * _gonio_factor(lt, -wi_m) * (1.0 / dist2)[:, None]
        mv = m[:, None]
        wi = torch.where(mv, wi_m, wi)
        li = torch.where(mv, li_m, li)
        pdf = torch.where(m, 1.0, pdf)
        p_light = torch.where(mv, pos, p_light)
        is_delta = is_delta | m

    if sc.LIGHT_DISTANT in light_types:
        # DistantLight::Sample_Li (distant.cpp:44-57)
        m = li_t == sc.LIGHT_DISTANT
        w_light = normalize(lt.dir[light_idx])
        mv = m[:, None]
        wi = torch.where(mv, w_light, wi)
        li = torch.where(mv, L, li)
        pdf = torch.where(m, 1.0, pdf)
        p_light = torch.where(mv, ref_p + w_light * (2.0 * lt.world_radius), p_light)
        is_delta = is_delta | m

    if sc.LIGHT_AREA in light_types:
        m_area = li_t == sc.LIGHT_AREA
        stype = lt.shape_type[light_idx]
        sidx = lt.shape_idx[light_idx].to(torch.int64)
        two = lt.two_sided[light_idx]

        # sphere: cone sampling outside, uniform area sampling inside
        m = (m_area & (stype == sc.SHAPE_SPHERE))[:, None]
        center, radius = _sphere_center_radius(scene, sidx)
        dc_v = center - ref_p
        dist2 = torch.clamp(dot(dc_v, dc_v), min=1e-12)
        dc = torch.sqrt(dist2)
        inside = dist2 <= radius * radius * (1.0 + 1e-4)
        wc = dc_v / dc[:, None]
        wc_x, wc_y = coordinate_system(wc)
        cos_t_max = safe_sqrt(1.0 - radius * radius / dist2)
        cos_t = (1.0 - u[:, 0]) + u[:, 0] * cos_t_max
        sin_t = safe_sqrt(1.0 - cos_t * cos_t)
        phi = u[:, 1] * 2.0 * math.pi
        ds = dc * cos_t - safe_sqrt(radius * radius - dist2 * sin_t * sin_t)
        cos_a = (dist2 + radius * radius - ds * ds) / torch.clamp(
            2.0 * dc * radius, min=1e-12)
        sin_a = safe_sqrt(1.0 - cos_a * cos_a)
        n_obj = spherical_direction_basis(sin_a, cos_a, phi, -wc_x, -wc_y, -wc)
        p_s = center + radius[:, None] * n_obj
        wi_s = normalize(p_s - ref_p)
        pdf_cone = smp.uniform_cone_pdf(cos_t_max)
        w_uniform = smp.uniform_sample_sphere(u)
        p_in = center + radius[:, None] * w_uniform
        wi_in = normalize(p_in - ref_p)
        d2_in = distance_squared(ref_p, p_in)
        cos_surf = torch.abs(dot(w_uniform, -wi_in))
        area = 4.0 * math.pi * radius * radius
        pdf_in = d2_in / torch.clamp(cos_surf * area, min=1e-12)
        iv = inside[:, None]
        wi_m = torch.where(iv, wi_in, wi_s)
        p_m = torch.where(iv, p_in, p_s)
        n_m = torch.where(iv, w_uniform, n_obj)
        emit = two | (dot(n_m, -wi_m) > 0.0)
        wi = torch.where(m, wi_m, wi)
        li = torch.where(m, torch.where(emit[:, None], L, 0.0), li)
        pdf = torch.where(m[:, 0], torch.where(inside, pdf_in, pdf_cone), pdf)
        p_light = torch.where(m, p_m, p_light)
        n_light = torch.where(m, n_m, n_light)

        # triangle: uniform area sampling, converted to solid angle
        m = (m_area & (stype == sc.SHAPE_TRIANGLE))[:, None]
        p0, p1, p2 = _gather_tri(scene, sidx)
        b = smp.uniform_sample_triangle(u)
        p_t = b[:, 0:1] * p0 + b[:, 1:2] * p1 + (1.0 - b[:, 0:1] - b[:, 1:2]) * p2
        ng = cross(p1 - p0, p2 - p0)
        area_t = 0.5 * length(ng)
        ng = normalize(ng)
        d_t = p_t - ref_p
        d2_t = torch.clamp(dot(d_t, d_t), min=1e-12)
        wi_t = d_t / torch.sqrt(d2_t)[:, None]
        cos_surf = torch.abs(dot(ng, -wi_t))
        pdf_t = d2_t / torch.clamp(cos_surf * area_t, min=1e-12)
        pdf_t = torch.where(cos_surf < 1e-7, 0.0, pdf_t)
        emit = two | (dot(ng, -wi_t) > 0.0)
        wi = torch.where(m, wi_t, wi)
        li = torch.where(m, torch.where(emit[:, None], L, 0.0), li)
        pdf = torch.where(m[:, 0], pdf_t, pdf)
        p_light = torch.where(m, p_t, p_light)
        n_light = torch.where(m, ng, n_light)

    if sc.LIGHT_INFINITE in light_types:
        # InfiniteAreaLight::Sample_Li (infinite.cpp:126-155).
        m = (li_t == sc.LIGHT_INFINITE)[:, None]
        if scene.env_light_idx >= 0:
            uv, map_pdf = smp.sample_continuous_2d(lt.env_distr, u)
            theta = uv[:, 1] * math.pi
            phi = uv[:, 0] * 2.0 * math.pi
            sin_t = torch.sin(theta)
            w_light = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                                   torch.cos(theta)], -1)
            # light to world: the transpose of the world-to-light rotation
            wi_m = w_light @ lt.env_w2l[:3, :3]
            pdf_m = torch.where(
                sin_t == 0.0, 0.0,
                map_pdf / torch.clamp(2.0 * math.pi * math.pi * sin_t, min=1e-12))
            li_m = _env_lookup(lt, uv)
        else:
            wi_m = smp.uniform_sample_sphere(u)
            pdf_m = torch.full((n,), smp.uniform_sphere_pdf(),
                               device=ref_p.device)
            li_m = L
        wi = torch.where(m, wi_m, wi)
        li = torch.where(m, li_m, li)
        pdf = torch.where(m[:, 0], pdf_m, pdf)
        p_light = torch.where(m, ref_p + wi_m * (2.0 * lt.world_radius), p_light)

    area = (li_t == sc.LIGHT_AREA)[:, None]
    return {"wi": wi, "li": li, "pdf": pdf, "p_light": p_light,
            "n_light": torch.where(area, n_light, -wi), "is_delta": is_delta}


def _apply_w2l(w2l, v):
    """A world direction in light space (the rotation alone)."""
    return v @ w2l[:3, :3].T


def _bilinear_img(img, u, v):
    """A bilinear texel fetch at (u, v) in [0, 1]^2, clamped at the edges.
    The indices are clamped again after the cast: a NaN lane (a missed
    ray's hit point) reads texel 0, as the JAX package's clamped gather
    does, and is masked by the caller."""
    h, w = img.shape[0], img.shape[1]
    x = torch.clamp(u * w - 0.5, 0.0, w - 1.0)
    y = torch.clamp(v * h - 0.5, 0.0, h - 1.0)
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, w - 1)
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    a = img[y0, x0] * (1 - fx) + img[y0, x1] * fx
    b = img[y1, x0] * (1 - fx) + img[y1, x1] * fx
    return a * (1 - fy) + b * fy


def _projection_factor(lt, w_world):
    """ProjectionLight::Projection (projection.cpp:87-101): the light-space
    direction projected on z = 1 against the screen window (fov folded
    in), zero behind the hither plane or outside the window."""
    wl = _apply_w2l(lt.proj_w2l, w_world)
    z = wl[:, 2]
    behind = z < 1e-3
    x = wl[:, 0] / torch.where(behind, 1.0, z)
    y = wl[:, 1] / torch.where(behind, 1.0, z)
    s = lt.proj_screen
    inside = ~behind & (x >= s[0]) & (x <= s[1]) & (y >= s[2]) & (y <= s[3])
    u = (x - s[0]) / torch.clamp(s[1] - s[0], min=1e-9)
    v = (y - s[2]) / torch.clamp(s[3] - s[2], min=1e-9)
    return torch.where(inside[:, None], _bilinear_img(lt.proj_img, u, v), 0.0)


def _gonio_factor(lt, w_world):
    """GonioPhotometricLight::Scale (goniometric.cpp:65-75): the equirect
    map at the light-space direction's (phi, theta)."""
    wl = normalize(_apply_w2l(lt.gonio_w2l, w_world))
    theta = safe_acos(wl[:, 2])
    phi = safe_atan2(wl[:, 1], wl[:, 0])
    phi = torch.where(phi < 0.0, phi + 2.0 * math.pi, phi)
    return _bilinear_img(lt.gonio_img, phi * (0.5 / math.pi), theta / math.pi)


def _env_lookup(lt, uv):
    """Bilinear equirect map lookup at (u, v) in [0, 1)^2, u wrapping and v
    clamped."""
    env = lt.env_map
    h, w = env.shape[0], env.shape[1]
    x = uv[:, 0] * w - 0.5
    y = uv[:, 1] * h - 0.5
    xf = torch.floor(x)
    yf = torch.floor(y)
    fx = (x - xf)[:, None]
    fy = (y - yf)[:, None]
    x0 = xf.to(torch.int64)
    y0 = yf.to(torch.int64)

    def at(xi, yi):
        return env[torch.clamp(yi, 0, h - 1), torch.remainder(xi, w)]

    return ((1 - fx) * ((1 - fy) * at(x0, y0) + fy * at(x0, y0 + 1))
            + fx * ((1 - fy) * at(x0 + 1, y0) + fy * at(x0 + 1, y0 + 1)))


def _env_dir_to_uv(lt, wi):
    """World direction to equirect (u, v) in light space, and theta."""
    w_l = normalize(wi @ lt.env_w2l[:3, :3].T)
    theta = safe_acos(w_l[:, 2])
    phi = safe_atan2(w_l[:, 1], w_l[:, 0])
    phi = torch.where(phi < 0.0, phi + 2.0 * math.pi, phi)
    return torch.stack([phi / (2.0 * math.pi), theta / math.pi], -1), theta


def pdf_li(scene, light_idx, ref_p, wi, light_types):
    """Light::Pdf_Li for the BSDF-sampling MIS weight; 0 for the delta
    lights (point, spot, projection, goniometric, distant)."""
    lt = scene.lights
    li_t = lt.light_type[light_idx]
    n = ref_p.shape[0]
    pdf = torch.zeros(n, dtype=torch.float32, device=ref_p.device)
    if sc.LIGHT_INFINITE in light_types:
        # InfiniteAreaLight::Pdf_Li (infinite.cpp:157-168)
        if scene.env_light_idx >= 0:
            uv, theta = _env_dir_to_uv(lt, wi)
            sin_t = torch.sin(theta)
            pdf_m = torch.where(
                sin_t == 0.0, 0.0,
                smp.pdf_2d(lt.env_distr, uv)
                / torch.clamp(2.0 * math.pi ** 2 * sin_t, min=1e-12))
        else:
            pdf_m = smp.uniform_sphere_pdf()
        pdf = torch.where(li_t == sc.LIGHT_INFINITE, pdf_m, pdf)
    if sc.LIGHT_AREA not in light_types:
        return pdf
    m_area = li_t == sc.LIGHT_AREA
    stype = lt.shape_type[light_idx]
    sidx = lt.shape_idx[light_idx].to(torch.int64)

    m = m_area & (stype == sc.SHAPE_SPHERE)
    center, radius = _sphere_center_radius(scene, sidx)
    dist2 = torch.clamp(distance_squared(ref_p, center), min=1e-12)
    outside = dist2 > radius * radius
    cos_t_max = safe_sqrt(1.0 - radius * radius / dist2)
    oc = ref_p - center
    b_q = 2.0 * dot(wi, oc)
    c_q = dot(oc, oc) - radius * radius
    disc = b_q * b_q - 4.0 * c_q
    hits = disc >= 0.0
    root = safe_sqrt(disc)
    t0 = 0.5 * (-b_q - root)
    t1 = 0.5 * (-b_q + root)
    t_hit = torch.where(t0 > 1e-4, t0, t1)
    p_hit = ref_p + t_hit[:, None] * wi
    n_hit = (p_hit - center) / torch.clamp(radius, min=1e-12)[:, None]
    cos_surf = torch.abs(dot(n_hit, -wi))
    area = 4.0 * math.pi * radius * radius
    pdf_in = (t_hit * t_hit) / torch.clamp(cos_surf * area, min=1e-12)
    pdf_in = torch.where(hits & (t_hit > 1e-4), pdf_in, 0.0)
    pdf_m = torch.where(outside,
                        torch.where(hits, smp.uniform_cone_pdf(cos_t_max), 0.0),
                        pdf_in)
    pdf = torch.where(m, pdf_m, pdf)

    m = m_area & (stype == sc.SHAPE_TRIANGLE)
    p0, p1, p2 = _gather_tri(scene, sidx)
    r = intersect_triangle(ref_p, wi, torch.full((n,), 1e30, device=ref_p.device),
                           p0, p1, p2)
    ng = cross(p1 - p0, p2 - p0)
    area_t = 0.5 * length(ng)
    ng = normalize(ng)
    cos_surf = torch.abs(dot(ng, -wi))
    t_s = torch.where(r["hit"], r["t"], 1.0)
    pdf_m = torch.where(r["hit"] & (cos_surf > 1e-7),
                        t_s * t_s / torch.clamp(cos_surf * area_t, min=1e-12), 0.0)
    return torch.where(m, pdf_m, pdf)


def sample_le(scene, light_idx, u1, u2, light_types):
    """Light::Sample_Le (point.cpp:58, spot.cpp:87, distant.cpp:76,
    diffuse.cpp:103): an emitted ray.  Returns dict: o, d, n_light [n, 3],
    pdf_pos, pdf_dir [n], le [n, 3], is_delta_pos [n] (point, spot and, as
    in the JAX package, distant)."""
    lt = scene.lights
    li_t = lt.light_type[light_idx]
    L = lt.L[light_idx]
    n = u1.shape[0]
    dev = u1.device
    o = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    d = torch.zeros_like(o)
    nl = torch.zeros_like(o)
    pdf_pos = torch.zeros(n, dtype=torch.float32, device=dev)
    pdf_dir = torch.zeros_like(pdf_pos)
    le = torch.zeros_like(o)
    delta_pos = torch.zeros(n, dtype=torch.bool, device=dev)

    if sc.LIGHT_POINT in light_types:
        m = li_t == sc.LIGHT_POINT
        mv = m[:, None]
        w = smp.uniform_sample_sphere(u1)
        o = torch.where(mv, lt.pos[light_idx], o)
        d = torch.where(mv, w, d)
        nl = torch.where(mv, w, nl)
        pdf_pos = torch.where(m, 1.0, pdf_pos)
        pdf_dir = torch.where(m, smp.uniform_sphere_pdf(), pdf_dir)
        le = torch.where(mv, L, le)
        delta_pos = delta_pos | m

    if sc.LIGHT_SPOT in light_types:
        # a uniform cone of the total width about the axis
        m = li_t == sc.LIGHT_SPOT
        mv = m[:, None]
        c1 = lt.cos_falloff_end[light_idx]
        w_local = smp.uniform_sample_cone(u1, c1)
        axis = lt.dir[light_idx]
        ax_x, ax_y = coordinate_system(axis)
        w = (w_local[:, 0:1] * ax_x + w_local[:, 1:2] * ax_y
             + w_local[:, 2:3] * axis)
        ct = dot(w, axis)
        c0 = lt.cos_falloff_start[light_idx]
        delta = torch.clamp((ct - c1) / torch.clamp(c0 - c1, min=1e-9), 0.0, 1.0)
        fall = torch.where(ct < c1, 0.0, torch.where(ct > c0, 1.0, delta ** 4))
        o = torch.where(mv, lt.pos[light_idx], o)
        d = torch.where(mv, w, d)
        nl = torch.where(mv, w, nl)
        pdf_pos = torch.where(m, 1.0, pdf_pos)
        pdf_dir = torch.where(m, smp.uniform_cone_pdf(c1), pdf_dir)
        le = torch.where(mv, L * fall[:, None], le)
        delta_pos = delta_pos | m

    if sc.LIGHT_DISTANT in light_types:
        # a disk of the scene's radius, facing the light
        m = li_t == sc.LIGHT_DISTANT
        mv = m[:, None]
        w_light = normalize(lt.dir[light_idx])
        vx, vy = coordinate_system(w_light)
        cd = smp.concentric_sample_disk(u1)
        r = lt.world_radius
        p_disk = (lt.world_center + r * (cd[:, 0:1] * vx + cd[:, 1:2] * vy)
                  + r * w_light)
        o = torch.where(mv, p_disk, o)
        d = torch.where(mv, -w_light, d)
        nl = torch.where(mv, -w_light, nl)
        pdf_pos = torch.where(m, 1.0 / (math.pi * r * r), pdf_pos)
        pdf_dir = torch.where(m, 1.0, pdf_dir)
        le = torch.where(mv, L, le)
        delta_pos = delta_pos | m

    if sc.LIGHT_AREA in light_types:
        # an area sample, then a cosine direction about the normal, flipped
        # for a two-sided light by a coin from u2[0] (remapped)
        m_area = li_t == sc.LIGHT_AREA
        stype = lt.shape_type[light_idx]
        sidx = lt.shape_idx[light_idx].to(torch.int64)
        two = lt.two_sided[light_idx]

        m = m_area & (stype == sc.SHAPE_SPHERE)
        mv = m[:, None]
        center, radius = _sphere_center_radius(scene, sidx)
        w_sph = smp.uniform_sample_sphere(u1)
        p_sph = center + radius[:, None] * w_sph
        area_sph = 4.0 * math.pi * radius * radius
        o = torch.where(mv, p_sph, o)
        nl = torch.where(mv, w_sph, nl)
        pdf_pos = torch.where(m, 1.0 / torch.clamp(area_sph, min=1e-12), pdf_pos)

        m2 = m_area & (stype == sc.SHAPE_TRIANGLE)
        mv2 = m2[:, None]
        p0, p1, p2 = _gather_tri(scene, sidx)
        b = smp.uniform_sample_triangle(u1)
        p_t = (b[:, 0:1] * p0 + b[:, 1:2] * p1
               + (1.0 - b[:, 0:1] - b[:, 1:2]) * p2)
        ng_t = cross(p1 - p0, p2 - p0)
        area_t = 0.5 * length(ng_t)
        ng_t = normalize(ng_t)
        o = torch.where(mv2, p_t, o)
        nl = torch.where(mv2, ng_t, nl)
        pdf_pos = torch.where(m2, 1.0 / torch.clamp(area_t, min=1e-12), pdf_pos)

        m_any = m | m2
        low = u2[:, 0] < 0.5
        flip = two & low
        u2r = torch.stack(
            [torch.where(two, torch.where(low, 2.0 * u2[:, 0],
                                          2.0 * (u2[:, 0] - 0.5)), u2[:, 0]),
             u2[:, 1]], -1)
        w_loc = smp.cosine_sample_hemisphere(u2r)
        nrm = torch.where(flip[:, None], -nl, nl)
        nx, ny = coordinate_system(nrm)
        w_dir = w_loc[:, 0:1] * nx + w_loc[:, 1:2] * ny + w_loc[:, 2:3] * nrm
        pd = torch.abs(w_loc[:, 2]) * smp.INV_PI
        pd = torch.where(two, 0.5 * pd, pd)
        d = torch.where(m_any[:, None], w_dir, d)
        pdf_dir = torch.where(m_any, pd, pdf_dir)
        le = torch.where(m_any[:, None], L, le)

    return {"o": o, "d": d, "n_light": nl, "pdf_pos": pdf_pos,
            "pdf_dir": pdf_dir, "le": le, "is_delta_pos": delta_pos}


def pdf_le(scene, light_idx, p_on_light, n_light, w, light_types):
    """Light::Pdf_Le: (pdf_pos, pdf_dir) of emitting from p_on_light along
    w, for the lights sample_le covers."""
    lt = scene.lights
    li_t = lt.light_type[light_idx]
    n = p_on_light.shape[0]
    pdf_pos = torch.zeros(n, dtype=torch.float32, device=p_on_light.device)
    pdf_dir = torch.zeros_like(pdf_pos)
    if sc.LIGHT_POINT in light_types:
        m = li_t == sc.LIGHT_POINT
        pdf_pos = torch.where(m, 1.0, pdf_pos)
        pdf_dir = torch.where(m, smp.uniform_sphere_pdf(), pdf_dir)
    if sc.LIGHT_SPOT in light_types:
        m = li_t == sc.LIGHT_SPOT
        c1 = lt.cos_falloff_end[light_idx]
        inside = dot(w, lt.dir[light_idx]) >= c1
        pdf_pos = torch.where(m, 1.0, pdf_pos)
        pdf_dir = torch.where(m, torch.where(inside, smp.uniform_cone_pdf(c1), 0.0),
                              pdf_dir)
    if sc.LIGHT_DISTANT in light_types:
        m = li_t == sc.LIGHT_DISTANT
        r = lt.world_radius
        pdf_pos = torch.where(m, 1.0 / (math.pi * r * r), pdf_pos)
        pdf_dir = torch.where(m, 0.0, pdf_dir)
    if sc.LIGHT_AREA in light_types:
        m_area = li_t == sc.LIGHT_AREA
        stype = lt.shape_type[light_idx]
        sidx = lt.shape_idx[light_idx].to(torch.int64)
        two = lt.two_sided[light_idx]
        _, radius = _sphere_center_radius(scene, sidx)
        area_sph = 4.0 * math.pi * radius * radius
        p0, p1, p2 = _gather_tri(scene, sidx)
        area_t = 0.5 * length(cross(p1 - p0, p2 - p0))
        area = torch.where(stype == sc.SHAPE_SPHERE, area_sph, area_t)
        cos_d = dot(n_light, w)
        pd = torch.where(two, 0.5 * torch.abs(cos_d),
                         torch.clamp(cos_d, min=0.0)) * smp.INV_PI
        pdf_pos = torch.where(m_area, 1.0 / torch.clamp(area, min=1e-12), pdf_pos)
        pdf_dir = torch.where(m_area, pd, pdf_dir)
    return pdf_pos, pdf_dir


def area_light_emission(scene, arealight_idx, ng, wo):
    """DiffuseAreaLight::L (diffuse.cpp:53): emitted radiance toward wo."""
    lt = scene.lights
    m = arealight_idx >= 0
    ai = torch.clamp(arealight_idx.to(torch.int64), 0, lt.L.shape[0] - 1)
    emit = lt.two_sided[ai] | (dot(ng, wo) > 0.0)
    return torch.where((m & emit)[:, None], lt.L[ai], 0.0)


def escaped_radiance(scene, d, light_types):
    """The infinite lights' Le along escaped rays (InfiniteAreaLight::Le,
    infinite.cpp:37-45): the constant ones' L summed, plus the map's
    lookup."""
    out = torch.zeros_like(d)
    if sc.LIGHT_INFINITE not in light_types:
        return out
    lt = scene.lights
    rows = torch.arange(lt.light_type.shape[0], device=d.device)
    is_const = (lt.light_type == sc.LIGHT_INFINITE) & (rows != scene.env_light_idx)
    out = out + torch.where(is_const[:, None], lt.L, 0.0).sum(0)
    if scene.env_light_idx >= 0:
        uv, _ = _env_dir_to_uv(lt, normalize(d))
        out = out + _env_lookup(lt, uv)
    return out
