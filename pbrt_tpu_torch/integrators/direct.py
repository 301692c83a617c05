"""The direct-lighting integrator (integrators/directlighting.{h,cpp}).

Port of pbrt_tpu/integrators/direct.py: emitted light plus next-event
estimation at the first non-specular vertex of each camera path, continued
only through specular bounces, up to max_depth of them.  Two strategies:

* "one": UniformSampleOneLight (integrator.cpp:85-106), dims 5-9 a vertex
  as in the path integrator, then the 2 BSDF dims;
* "all": UniformSampleAllLights (integrator.cpp:54-84) with pbrt's
  GlobalSampler sample arrays (sampler.cpp:136-196): light j's two 2-D
  arrays of n_j samples sit at dims 5 + 4j and 5 + 4j + 2, element k of
  sample s drawn at global sample index s * n_j + k; regular dims resume at
  5 + 4 * nLights.  Sobol, zerotwosequence and maxmin round n_j up to a
  power of two (RoundCount).
  Vertices past the first, where pbrt's arrays are exhausted, draw one
  regular 2-D pair per light each (integrator.cpp:66-73).

Textures are looked up at level 0 at every vertex: the JAX package's direct
integrator gives its camera rays no differentials (direct.py:186).

Traversal launches a depth: one closest-hit launch for the path's rays,
then one [shadow | MIS] launch per estimate_direct call: one for "one";
sum(n_j) at the first vertex and nLights later for "all".  Unlike the path
integrator's, no extension ray rides the NEE launch: the continuation is
drawn after NEE, as in the JAX package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
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
from .path import eval_scene_textures, render_loop

STRATEGIES = ("one", "all")


@dataclasses.dataclass(frozen=True)
class DirectLightingConfig:
    """pbrt's DirectLightingIntegrator parameters (directlighting.cpp:
    127-145): max_depth bounds the specular chain."""
    max_depth: int = 5
    strategy: str = "one"  # "one" | "all"

    def __post_init__(self):
        if self.strategy not in STRATEGIES:
            raise NotImplementedError(
                f"directlighting strategy {self.strategy!r}: pbrt has "
                f"{STRATEGIES}")


def light_sample_counts(scene: SceneArrays, sampler_cfg) -> tuple:
    """Each light's array length n_j: its "nsamples", rounded up to a power
    of two for sobol, zerotwosequence and maxmin (Sampler::RoundCount,
    sobol.cpp:69; direct.py:173-178)."""
    ns = scene.lights.n_samples.cpu().numpy().astype(int)
    if sampler_cfg.name in ("sobol", "zerotwosequence", "maxmin"):
        ns = np.array([1 << max(0, int(x - 1).bit_length()) for x in ns])
    return tuple(int(max(x, 1)) for x in ns)


def n_regular_dims(cfg: DirectLightingConfig, light_ns: tuple) -> int:
    """Sampler dims a path draws outside the sample arrays."""
    if cfg.strategy == "one":
        return 5 + 7 * cfg.max_depth
    if cfg.max_depth == 0:
        return 5 + 4 * len(light_ns)
    return 5 + 4 * len(light_ns) + 2 + (cfg.max_depth - 1) * (4 * len(light_ns) + 2)


def _array_draws(sampler_cfg, pixels, sample_num: int, nj: int, dim: int):
    """Light j's (uLight, uScattering) array elements k < nj of sample
    sample_num: dims dim and dim + 2 at global sample index
    sample_num * nj + k (sampler.cpp:136-196)."""
    out = []
    for k in range(nj):
        state = sa.init_state(sampler_cfg, pixels, torch.full(
            (pixels.shape[0],), sample_num * nj + k, dtype=torch.int64,
            device=pixels.device))
        out.append((sa.get_2d(sampler_cfg, state, dim),
                    sa.get_2d(sampler_cfg, state, dim + 2)))
    return out


def li_direct(scene: SceneArrays, o, d, sampler_cfg, sampler_state,
              cfg: DirectLightingConfig, counters, pixels=None, sample_num=0,
              light_ns=(), start_dim: int = 5):
    """Radiance along a batch of camera rays: L [n, 3].  For "all",
    pixels, sample_num and light_ns (light_sample_counts) drive the array
    draws."""
    n = o.shape[0]
    dev = o.device
    L = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    beta = torch.ones((n, 3), dtype=torch.float32, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    specular = torch.ones(n, dtype=torch.bool, device=dev)  # camera rays count Le
    use_all = cfg.strategy == "all"
    dim = start_dim + 4 * len(light_ns) if use_all else start_dim
    st.bump(counters, "Integrator/Camera rays traced", float(n))

    for depth in range(cfg.max_depth + 1):
        st.bump(counters, "Intersections/Regular ray intersection tests", alive)
        t, prim = tv.intersect_closest(
            scene, o, d, torch.where(alive, 1e30, 0.0).to(torch.float32))
        with record_function("layer: hit record"):
            rec = tv.hit_record(scene, o, d, t, prim)
        found = rec["hit"] & alive
        st.bump(counters, "Integrator/Path vertices", found)
        le_surf = lt.area_light_emission(scene, rec["arealight"], rec["ng"],
                                         rec["wo"])
        L = L + torch.where((found & specular)[:, None], beta * le_surf, 0.0)
        le_inf = lt.escaped_radiance(scene, d, scene.light_types)
        L = L + torch.where((alive & ~rec["hit"] & specular)[:, None],
                            beta * le_inf, 0.0)
        alive = found
        if depth >= cfg.max_depth:
            break

        mat = bx.gather_material(scene.materials, rec["material"],
                                 eval_scene_textures(scene, rec),
                                 scene.mat_types, scene.mix_sub_types,
                                 uv=rec["uv"])
        frame = bx.frame_from_rec(rec)
        ss, ts, ns = frame
        wo_local = bx.to_local(ss, ts, ns, rec["wo"])
        has_bsdf = alive & (rec["material"] >= 0)
        first_diffuse = has_bsdf & specular

        with record_function("layer: NEE incl. its traversal"):
            if use_all:
                ld = torch.zeros((n, 3), dtype=torch.float32, device=dev)
                for j, nj in enumerate(light_ns):
                    light = torch.full((n,), j, dtype=torch.int64, device=dev)
                    if depth == 0:
                        draws = _array_draws(sampler_cfg, pixels, sample_num,
                                             nj, start_dim + 4 * j)
                    else:
                        draws = [(sa.get_2d(sampler_cfg, sampler_state, dim),
                                  sa.get_2d(sampler_cfg, sampler_state, dim + 2))]
                        dim += 4
                    acc = torch.zeros((n, 3), dtype=torch.float32, device=dev)
                    for u_l, u_s in draws:
                        st.bump(counters, "Intersections/Shadow ray intersection tests",
                                2.0 * first_diffuse.to(torch.float64).sum())
                        st.bump(counters, "Lights/Light samples taken", first_diffuse)
                        acc = acc + common.estimate_direct(
                            scene, rec, frame, mat, wo_local, light, u_l, u_s,
                            first_diffuse)[0]
                    ld = ld + (acc / float(nj) if depth == 0 else acc)
            else:
                u_select = sa.get_1d(sampler_cfg, sampler_state, dim)
                u_light = sa.get_2d(sampler_cfg, sampler_state, dim + 1)
                u_scatter = sa.get_2d(sampler_cfg, sampler_state, dim + 3)
                dim += 5
                st.bump(counters, "Intersections/Shadow ray intersection tests",
                        2.0 * first_diffuse.to(torch.float64).sum())
                st.bump(counters, "Lights/Light samples taken", first_diffuse)
                ld = common.sample_one_light(
                    scene, rec, frame, mat, wo_local, u_select, u_light,
                    u_scatter, first_diffuse)[0]
        L = L + torch.where(first_diffuse[:, None], beta * ld, 0.0)

        # the specular chain (SamplerIntegrator::SpecularReflect/Transmit)
        u_bsdf = sa.get_2d(sampler_cfg, sampler_state, dim)
        dim += 2
        bs = bx.sample_material(mat, wo_local, u_bsdf, scene.mat_types)
        cont = alive & bs["is_specular"] & bs["valid"]
        wi_world = bx.to_world(ss, ts, ns, bs["wi"])
        pdf_s = torch.where(cont, bs["pdf"], 1.0)
        beta = torch.where(
            cont[:, None],
            beta * bs["f"] * (absdot(wi_world, ns)
                              / torch.clamp(pdf_s, min=1e-20))[:, None],
            beta)
        alive = cont
        specular = cont
        o = torch.where(cont[:, None],
                        offset_ray_origin(rec["p"], rec["p_error"], rec["ng"],
                                          wi_world), o)
        d = torch.where(cont[:, None], wi_world, d)
    return L


def render(scene: SceneArrays, camera, film_cfg: fm.FilmConfig, sampler_cfg,
           cfg: DirectLightingConfig = DirectLightingConfig(), filt=None,
           count_rays: bool = False, stats_out: bool = False, progress=None,
           device="cuda"):
    """Full render, one batch per sample per pixel, as path.render: on the
    card unless device="cpu", with the scene already there.  Returns the
    image [H, W, 3]; with count_rays also the rays traced, with stats_out
    also the counter vector."""
    light_ns = (light_sample_counts(scene, sampler_cfg)
                if cfg.strategy == "all" else ())

    def li(o, d, state, pixels, s, counters, ray_diffs):
        return li_direct(scene, o, d, sampler_cfg, state, cfg, counters,
                         pixels=pixels, sample_num=s, light_ns=light_ns)

    return render_loop(li, n_regular_dims(cfg, light_ns), scene, camera,
                       film_cfg, sampler_cfg, filt, count_rays, stats_out,
                       progress, device)
