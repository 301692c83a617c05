"""The ambient-occlusion integrator (integrators/ao.cpp:45-80).

Port of pbrt_tpu/integrators/ao.py: from each camera ray's first hit,
n_samples cosine- or uniform-hemisphere probes around the face-forwarded
shading normal; a probe that escapes adds cos / (pdf pi).  The JAX package
names it "ao" (pbrt: "ambientocclusion").

Dims from 5: 2 a probe.  Traversal launches a sample: the camera rays'
closest hit, then one any-hit launch a probe (1 + n_samples); lanes that
missed get t_max = 0.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.profiler import record_function

from ..accel import traverse as tv
from ..core import sampling as smp
from ..core.vecmath import dot, offset_ray_origin
from ..materials import bsdf as bx
from ..samplers import samplers as sa
from ..scene import SceneArrays
from ..utils import stats as st
from .path import render_loop


@dataclasses.dataclass(frozen=True)
class AOConfig:
    """pbrt's AOIntegrator parameters (ao.cpp:82-95)."""
    cos_sample: bool = True
    n_samples: int = 64


def li_ao(scene: SceneArrays, o, d, sampler_cfg, sampler_state, cfg: AOConfig,
          counters):
    """Occlusion along a batch of camera rays, as grey radiance [n, 3]."""
    n = o.shape[0]
    st.bump(counters, "Integrator/Camera rays traced", float(n))
    st.bump(counters, "Intersections/Regular ray intersection tests", float(n))
    t, prim = tv.intersect_closest(scene, o, d, 1e30)
    with record_function("layer: hit record"):
        rec = tv.hit_record(scene, o, d, t, prim)
    hit = rec["hit"]
    ns = torch.where((dot(rec["ns"], rec["wo"]) < 0.0)[:, None], -rec["ns"],
                     rec["ns"])  # Faceforward (ao.cpp:60)
    ss, ts, ns = bx.make_frame(ns, rec["dpdu"])
    t_max = torch.where(hit, 1e30, 0.0)  # probes are unbounded (ao.cpp:70)
    total = torch.zeros(n, dtype=torch.float32, device=o.device)
    for k in range(cfg.n_samples):
        u = sa.get_2d(sampler_cfg, sampler_state, 5 + 2 * k)
        if cfg.cos_sample:
            wi_l = smp.cosine_sample_hemisphere(u)
            pdf = smp.cosine_hemisphere_pdf(torch.abs(wi_l[:, 2]))
        else:
            wi_l = smp.uniform_sample_hemisphere(u)
            pdf = torch.full_like(total, smp.uniform_hemisphere_pdf())
        wi = bx.to_world(ss, ts, ns, wi_l)
        o2 = offset_ray_origin(rec["p"], rec["p_error"], rec["ng"], wi)
        st.bump(counters, "Intersections/Shadow ray intersection tests", hit)
        occ = tv.intersect_any(scene, o2, wi, t_max)
        total = total + torch.where(hit & ~occ & (pdf > 0.0),
                                    dot(wi, ns) / torch.clamp(pdf, min=1e-12)
                                    / smp.PI, 0.0)
    v = total / cfg.n_samples
    return torch.stack([v, v, v], -1)


def render(scene: SceneArrays, camera, film_cfg, sampler_cfg,
           cfg: AOConfig = AOConfig(), filt=None, count_rays: bool = False,
           stats_out: bool = False, progress=None, device="cuda"):
    """Full render as path.render: on the card unless device="cpu", with
    the scene already there.  Returns the image [H, W, 3]; with count_rays
    also the rays traced, with stats_out also the counter vector."""
    def li(o, d, state, pixels, s, counters, ray_diffs):
        return li_ao(scene, o, d, sampler_cfg, state, cfg, counters)

    return render_loop(li, 5 + 2 * cfg.n_samples, scene, camera, film_cfg,
                       sampler_cfg, filt, count_rays, stats_out, progress,
                       device)
