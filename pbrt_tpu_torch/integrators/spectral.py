"""The spectral render mode: pbrt's PBRT_SAMPLED_SPECTRUM build
(spectrum.h:48-515) as a choice at render time.

Port of pbrt_tpu/integrators/spectral.py, a library mode that no scene
file selects.  The scene's RGB reflectances and emitters are lifted to
N-bin spectra (SampledSpectrum::FromRGB, as pbrt's sampled build lifts an
RGB scene), the path integral carries [n, N] radiance, and each sample's
spectrum goes to XYZ and then RGB before the film (spectrum.h:249-259).

Scope, the JAX module's: matte materials with sigma = 0, point lights and
diffuse area lights on spheres and triangles, no textures, no media (the
analytic-scene tier pbrt's own tests validate its sampled build with).
Anything else raises NotImplementedError naming it.  Traversal goes through
the BVH kernel path: the camera rays and each bounce's extension rays in
one closest-hit launch, the shadow rays in one any-hit launch a bounce.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import film as fm
from .. import scene as sc
from ..accel import traverse as tv
from ..cameras import generate_rays
from ..core import sampled_spectrum as ss
from ..core import sampling as smp
from ..core.sampling import INV_PI
from ..core.vecmath import absdot, offset_ray_origin
from ..filters import make_filter
from ..lights import lights as lt
from ..materials import bsdf as bx
from ..samplers import samplers as sa
from . import common
from .path import make_pixel_grid


@dataclasses.dataclass(frozen=True)
class SpectralConfig:
    max_depth: int = 5
    n_samples: int = ss.N_SPECTRAL_SAMPLES


def lift_scene_spectra(scene: sc.SceneArrays, n: int):
    """Material Kd -> reflectance spectra [M, n], light L -> illuminant
    spectra [L, n] scaled so that each keeps its RGB luminance
    (spectral.py:46-65), as float32 tensors on the scene's device."""
    kd = scene.materials.kd.cpu().numpy()
    light_l = scene.lights.L.cpu().numpy()
    kd_s = ss.from_rgb(kd, "reflectance", n).astype(np.float32)
    l_s = np.zeros((light_l.shape[0], n), np.float32)
    for i in range(light_l.shape[0]):
        spec = ss.from_rgb(light_l[i], "illuminant", n)
        y_rgb = float(0.212671 * light_l[i][0] + 0.715160 * light_l[i][1]
                      + 0.072169 * light_l[i][2])
        y_s = float(ss.y_luminance(spec, n))
        l_s[i] = (spec * (y_rgb / y_s if y_s > 0 else 0.0)).astype(np.float32)
    return (torch.as_tensor(kd_s, device=scene.device),
            torch.as_tensor(l_s, device=scene.device))


def check_scope(scene: sc.SceneArrays):
    """Raise NotImplementedError naming what the spectral mode does not
    cover."""
    names = {sc.MAT_MATTE: "matte"}
    for t in scene.mat_types:
        if t not in names:
            raise NotImplementedError(
                f"spectral mode covers matte materials; material type {t} present")
    if bool((scene.materials.sigma != 0.0).any()):
        raise NotImplementedError("spectral mode covers Lambertian matte "
                                  "(sigma 0); an Oren-Nayar sigma is present")
    for t in scene.light_types:
        if t not in (sc.LIGHT_POINT, sc.LIGHT_AREA):
            raise NotImplementedError(
                "spectral mode covers point and diffuse area lights; light "
                f"type {t} present")
    area = scene.lights.light_type == sc.LIGHT_AREA
    shapes = set(scene.lights.shape_type[area].tolist())
    if shapes - {sc.SHAPE_SPHERE, sc.SHAPE_TRIANGLE}:
        raise NotImplementedError("spectral mode covers area lights on spheres "
                                  f"and triangles; shape types {sorted(shapes)}")
    if scene.has_textures:
        raise NotImplementedError("spectral mode covers constant Kd; textures present")
    if scene.has_media:
        raise NotImplementedError("spectral mode covers surfaces; media present")


def render(scene: sc.SceneArrays, camera, film_cfg: fm.FilmConfig, sampler_cfg,
           cfg: SpectralConfig = SpectralConfig(), filt=None, device="cuda"):
    """The spectral render (spectral.py:68-194): the RGB image [H, W, 3]
    of the spectral estimate."""
    device = sc.resolve_device(device)
    if scene.device != device:
        raise ValueError(f"scene is on {scene.device}, render asked for {device}")
    if sampler_cfg.exact:
        raise NotImplementedError("the exact sampler mode covers the path integrator")
    check_scope(scene)
    n = cfg.n_samples
    kd_s, l_s = lift_scene_spectra(scene, n)
    xyz_bins = torch.as_tensor(ss.cie_xyz_bins(n), dtype=torch.float32, device=device)
    xyz_scale = float(np.float32((ss.SAMPLED_LAMBDA_END - ss.SAMPLED_LAMBDA_START)
                                 / (ss.CIE_Y_INTEGRAL * n)))
    xyz2rgb = torch.as_tensor(ss._XYZ2RGB, dtype=torch.float32, device=device)
    camera = camera.to(device)
    film_state = fm.make_film_state(
        film_cfg, filt or make_filter(film_cfg.filter_name), device)
    pixels = torch.as_tensor(make_pixel_grid(film_cfg), device=device)
    npix = pixels.shape[0]
    with torch.no_grad():
        for s_num in range(sampler_cfg.spp):
            state = sa.init_state(sampler_cfg, pixels,
                                  torch.full((npix,), s_num, dtype=torch.int64,
                                             device=device))
            p_film, tu, p_lens = sa.get_camera_sample(sampler_cfg, state, pixels)
            o, d, _, w = generate_rays(camera, p_film, p_lens, tu)
            L = _li(scene, o, d, sampler_cfg, state, cfg, kd_s, l_s)
            # spectrum -> XYZ -> RGB (spectrum.h:249-259, film.cpp:169-254)
            xyz = (L @ xyz_bins.T) * xyz_scale
            rgb = xyz @ xyz2rgb.T
            rgb = torch.where(torch.all(torch.isfinite(rgb), -1)[:, None], rgb, 0.0)
            fm.add_samples(film_state, p_film, rgb, w)
        return fm.to_image(film_state, scale=film_cfg.scale)


def _li(scene, o, d, sampler_cfg, state, cfg: SpectralConfig, kd_s, l_s):
    """The spectral radiance [n, N] along camera rays: emission seen at
    bounce 0, NEE with a one-light sample a bounce (its geometry and pdf
    from the RGB machinery, its radiance from l_s), cosine-sampled
    continuation with Kd / pi."""
    npix = o.shape[0]
    n = kd_s.shape[1]
    dev = o.device
    L = torch.zeros((npix, n), dtype=torch.float32, device=dev)
    beta = torch.ones((npix, n), dtype=torch.float32, device=dev)
    alive = torch.ones(npix, dtype=torch.bool, device=dev)
    t, prim = tv.intersect_closest(scene, o, d, 1e30)
    dim = 5
    for bounce in range(cfg.max_depth + 1):
        rec = tv.hit_record(scene, o, d, t, prim)
        found = rec["hit"] & alive
        ali = rec["arealight"]
        if bounce == 0:
            le_s = l_s[torch.clamp(ali, 0, l_s.shape[0] - 1).to(torch.int64)]
            L = L + beta * torch.where((found & (ali >= 0))[:, None], le_s, 0.0)
        alive = found
        if bounce >= cfg.max_depth:
            break
        frame = bx.frame_from_rec(rec)
        sxv, tsv, nsv = frame
        has = alive & (rec["material"] >= 0)
        kd_lane = kd_s[torch.clamp(rec["material"], 0, kd_s.shape[0] - 1).to(torch.int64)]

        u_sel = sa.get_1d(sampler_cfg, state, dim)
        u_li = sa.get_2d(sampler_cfg, state, dim + 1)
        u_bs = sa.get_2d(sampler_cfg, state, dim + 3)
        dim += 5
        light_idx, pmf = smp.sample_discrete_1d(scene.light_distr, u_sel)
        sl = lt.sample_li(scene, light_idx, rec["p"], u_li, scene.light_types)
        occ = common.occluded(scene, rec["p"], rec["p_error"], rec["ng"],
                              sl["p_light"], live=has)
        li_spec = l_s[torch.clamp(light_idx, 0, l_s.shape[0] - 1).to(torch.int64)]
        # sample_li's masks (the emitting side, zero radiance) come with
        # its RGB value
        li_on = torch.any(sl["li"] > 0.0, -1)
        cos_i = absdot(sl["wi"], nsv)
        usable = has & ~occ & (sl["pdf"] > 0.0) & li_on
        pdf_s = torch.where(usable, sl["pdf"] * pmf, 1.0)
        f_spec = kd_lane * INV_PI
        L = L + torch.where(usable[:, None],
                            beta * f_spec * li_spec
                            * (cos_i / torch.clamp(pdf_s, min=1e-20))[:, None], 0.0)
        wo_l = bx.to_local(sxv, tsv, nsv, rec["wo"])
        wi_l = bx._cosine_sample_wi(wo_l, u_bs)
        wi_w = bx.to_world(sxv, tsv, nsv, wi_l)
        pdf_b = bx.cosine_pdf(wo_l, wi_l)
        contrib = f_spec * (absdot(wi_w, nsv) / torch.clamp(pdf_b, min=1e-20))[:, None]
        alive = alive & has & (pdf_b > 0.0)
        beta = torch.where(alive[:, None], beta * contrib, beta)
        o = torch.where(alive[:, None],
                        offset_ray_origin(rec["p"], rec["p_error"], rec["ng"], wi_w), o)
        d = torch.where(alive[:, None], wi_w, d)
        t, prim = tv.intersect_closest(scene, o, d, torch.where(alive, 1e30, 0.0))
    return L
