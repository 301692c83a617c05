"""Top-level render entry: RenderSetup -> image.

Port of pbrt_tpu/render.py (pbrt-v3 pbrtWorldEnd, api.cpp:1590-1649, and
RenderOptions::MakeIntegrator, api.cpp:1662-1697) for ``Integrator "path"``
on the lockstep engine or, under PBRT_TPU_ENGINE=wavefront, the wavefront
engine (render.py:60-91), ``"volpath"``, ``"directlighting"``,
``"whitted"``, ``"ao"``, ``"bdpt"``, ``"mlt"`` and ``"sppm"``.  Any other
integrator, and a path render under another PBRT_TPU_ENGINE, raises
NotImplementedError.  Runs on the card unless the caller passes
device="cpu".
"""
from __future__ import annotations

import dataclasses
import logging
import os
import time

import numpy as np

from .scene import resolve_device
from .sceneio import RenderSetup, parse_pbrt_file

log = logging.getLogger("pbrt_tpu_torch")


def render_setup(setup: RenderSetup, spp_override=None, res_override=None,
                 crop=None, device="cuda", timer=None):
    """Build the scene and run its integrator.  Returns (img, stats).

    stats: wall_s (light distribution and render, to the image on the
    host), camera_rays, spp, resolution, counters (numpy), report (pbrt's
    Statistics block), rays_traced, phases (host seconds by phase: scene
    construction, light distribution, rendering, and parsing when
    render_file parsed), render_cpu_s (this process's CPU seconds over the
    rendering phase) and profile (pbrt's Profile block)."""
    from .integrators import ao
    from .integrators import bdpt as bd
    from .integrators import direct as dl
    from .integrators import mlt
    from .integrators import sppm
    from .integrators import path as pt
    from .integrators import volpath as vp
    from .integrators import wavefront as wf
    from .integrators import whitted as wh
    from .utils import stats as st
    from .utils.profiling import Timer
    from .utils.progress import ProgressReporter

    device = resolve_device(device)
    renderers = {"path": pt.render, "volpath": vp.render,
                 "directlighting": dl.render, "whitted": wh.render,
                 "ao": ao.render, "bdpt": bd.render, "mlt": mlt.render,
                 "sppm": sppm.render}
    if setup.integrator_name not in renderers:
        raise NotImplementedError(
            f"integrator {setup.integrator_name!r}: the port has "
            f"{sorted(renderers)}")
    engine = os.environ.get("PBRT_TPU_ENGINE", "lockstep")
    if engine not in ("lockstep", "wavefront") and setup.integrator_name == "path":
        raise NotImplementedError(
            f"PBRT_TPU_ENGINE={engine}: the port has the lockstep and "
            "wavefront engines")
    wavefront = engine == "wavefront" and setup.integrator_name == "path"
    if wavefront:
        renderers["path"] = wf.render
    timer = timer or Timer()
    with timer("Scene construction"):
        scene = setup.build_scene(device)
    film_cfg, filt = setup.make_film_config()
    sampler_cfg = setup.make_sampler_config()
    if crop is not None:
        film_cfg = dataclasses.replace(film_cfg, crop_window=tuple(crop))
    if res_override is not None:
        film_cfg = dataclasses.replace(film_cfg, full_resolution=tuple(res_override))
        sampler_cfg = dataclasses.replace(sampler_cfg,
                                          resolution=tuple(res_override))
        if setup.film_params is None:
            from .sceneio.paramset import ParamSet
            setup.film_params = ParamSet()
        setup.film_params.set("xresolution", "integer", [res_override[0]])
        setup.film_params.set("yresolution", "integer", [res_override[1]])
    if spp_override is not None:
        sampler_cfg = dataclasses.replace(sampler_cfg, spp=spp_override)
    camera = setup.make_camera()
    cfg = setup.make_integrator_config()

    t0 = time.perf_counter()
    if getattr(cfg, "light_strategy", None) == "spatial":
        from .lights.lightdistrib import ensure_spatial_light_distribution

        with timer("Light distribution"):
            scene = ensure_spatial_light_distribution(scene)
            if device.type == "cuda":
                import torch
                torch.cuda.synchronize(device)
    w, h = film_cfg.full_resolution
    # the wavefront reports (pixel, sample) paths retired, lockstep batches
    prog = ProgressReporter(w * h * sampler_cfg.spp if wavefront
                            else sampler_cfg.spp, "Rendering")
    c0 = time.process_time()
    with timer("Rendering"):
        img, counters = renderers[setup.integrator_name](
            scene, camera, film_cfg, sampler_cfg, cfg, filt, stats_out=True,
            progress=prog, device=device)
        img = img.cpu().numpy()
    render_cpu_s = time.process_time() - c0
    prog.finish()
    wall = time.perf_counter() - t0
    counters = counters.cpu().numpy()
    stats = {
        "wall_s": wall,
        "camera_rays": w * h * sampler_cfg.spp,
        "spp": sampler_cfg.spp,
        "resolution": film_cfg.full_resolution,
        "counters": counters,
        "report": st.report(counters),
        "rays_traced": st.ray_total(counters),
        "phases": dict(timer.acc),
        "render_cpu_s": render_cpu_s,
        "setup_split": dict(setup.scene_builder.timings),
        "profile": timer.report(),
    }
    return img, stats


def render_file(path: str, out: str | None = None, spp=None, res=None,
                crop=None, device="cuda"):
    """Parse `path`, render it and write the image to `out` (by default the
    film's filename, .exr written as .pfm).  Returns (img, stats)."""
    from .utils.imageio import write_image
    from .utils.profiling import Timer

    device = resolve_device(device)
    timer = Timer()
    with timer("Parsing"):
        setup = parse_pbrt_file(path)
    img, stats = render_setup(setup, spp_override=spp, res_override=res,
                              crop=crop, device=device, timer=timer)
    if out is None:
        from .sceneio.paramset import ParamSet

        p = setup.film_params or ParamSet()
        out = p.find_one_string("filename", "pbrt.pfm")
        if out.endswith(".exr"):
            out = out[:-4] + ".pfm"
    write_image(out, np.asarray(img))
    log.info("wrote %s (%.1fs)", out, stats["wall_s"])
    return img, stats
