"""Carry the JAX package's scene and camera over to the port, as numpy.

The JAX package (pbrt_tpu) builds SceneArrays and cameras as frozen
dataclasses of arrays.  A caller flattens them to numpy (``as_numpy_fields``
does that for any dataclass, without importing JAX) and hands the result
here, so both packages render the very same arrays: the geometry (every
quadric type's q_packed row and q_prim_id, the curves' curve_packed, the
instances' inst_xf and inst_tri), the
material table with its glass, metal, uber opacity, disney, hair, mix,
subsurface and texture columns and its Fourier tables, the scene's BSSRDF
tables, the light table with n_samples, the spot and distant columns, the
projection and goniometric lights' maps and the infinite light's map,
world-to-light matrix and Distribution2D, the texture table (rows, image atlas, pyramid offsets,
level counts), and the medium table with each primitive's inside and
outside medium and the camera's; ``params_from_numpy``
carries the differentiable parameters over the same way.  ``compare_setups``
holds a RenderSetup parsed by the JAX package against one parsed by the port
(the bdpt, mlt and sppm configurations field by field, against the
parameters the JAX package's render.py reads).
The port itself never imports JAX or pbrt_tpu.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .cameras import CameraParams
from .cameras.realistic import RealisticParams
from .core.sampling import DISTRIBUTION_2D_FIELDS
from .media.media import MEDIUM_FIELDS
from .materials.fourier import TABLE_FIELDS, TABLE_INTS
from .scene import (BSSRDF_FIELDS, ENV_FIELDS, GEOMETRY_FIELDS, LIGHT_FIELDS,
                    MAP_LIGHT_FIELDS,
                    MATERIAL_FIELDS, MEDIUM_ID_FIELDS, SCENE_FIELDS,
                    SUBSURFACE_FIELDS, SceneArrays, resolve_device)
from .textures.textures import TEXTURE_FIELDS


def as_numpy_fields(obj) -> dict:
    """A dataclass of arrays (nested dataclasses included) as a dict of
    numpy arrays; None fields are kept as None."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = as_numpy_fields(v)
        elif isinstance(v, tuple) and any(dataclasses.is_dataclass(x) for x in v):
            out[f.name] = tuple(as_numpy_fields(x) for x in v)
        elif v is None or isinstance(v, (int, float, str, tuple)):
            out[f.name] = v
        else:
            out[f.name] = np.array(v)
    return out


def scene_from_numpy(fields: dict, device) -> SceneArrays:
    """The JAX package's SceneArrays, as numpy fields, on `device`.
    MaterialTable, LightTable, MediumTable and light_distr arrive as
    nested dicts."""
    return SceneArrays.from_numpy(fields, device)


def camera_from_numpy(fields: dict, device):
    """The JAX package's CameraParams (perspective, orthographic or
    environment, by cam_type) or RealisticParams, as numpy fields, on
    `device`."""
    device = resolve_device(device)
    if "exit_pupil" in fields:
        return RealisticParams(
            camera_to_world=torch.as_tensor(
                np.array(fields["camera_to_world"], np.float32), device=device),
            **{k: np.array(fields[k], np.float32)
               for k in ("curvature", "element_z", "eta", "aperture_r")},
            exit_pupil=torch.as_tensor(np.array(fields["exit_pupil"], np.float32),
                                       device=device),
            **{k: float(fields[k]) for k in ("rear_z", "film_diag", "shutter_open",
                                             "shutter_close")},
            full_resolution=tuple(fields["full_resolution"]),
        )
    return CameraParams(
        raster_to_camera=torch.as_tensor(
            np.array(fields["raster_to_camera"], np.float32), device=device),
        camera_to_world=torch.as_tensor(
            np.array(fields["camera_to_world"], np.float32), device=device),
        lens_radius=float(fields["lens_radius"]),
        focal_distance=float(fields["focal_distance"]),
        shutter_open=float(fields["shutter_open"]),
        shutter_close=float(fields["shutter_close"]),
        full_resolution=tuple(fields["full_resolution"]),
        cam_type=int(fields.get("cam_type", 0)),
    )


def params_from_numpy(fields: dict, device) -> dict:
    """The JAX package's extract_params output, as numpy, as the port's
    parameter dict for parallel/diff.py apply_params: float32 tensors on
    `device`, the camera's lens_radius and focal_distance as floats (the
    camera keeps its lens radius on the host).  Any subset of the keys
    carries over: without "camera" for the realistic camera, whose step
    takes material and light leaves only."""
    device = resolve_device(device)
    out = {}
    for k, v in fields.items():
        if k == "camera":
            out[k] = {ck: (float(np.asarray(cv)) if np.ndim(cv) == 0 else
                           torch.as_tensor(np.array(cv, np.float32),
                                           device=device))
                      for ck, cv in v.items()}
        else:
            out[k] = torch.as_tensor(np.array(v, np.float32), device=device)
    return out


def _diff(out: list, what: str, ref, got, rtol: float):
    ref = np.asarray(ref)
    got = np.asarray(got)
    if ref.shape != got.shape:
        out.append(f"{what}: shape {ref.shape} != {got.shape}")
    elif ref.dtype.kind in "fc" or got.dtype.kind in "fc":
        if not np.allclose(ref, got, rtol=rtol, atol=0.0, equal_nan=True):
            out.append(f"{what}: max |diff| {np.max(np.abs(ref - got))}")
    elif not np.array_equal(ref, got):
        out.append(f"{what}: {np.count_nonzero(ref != got)} entries differ")


def _diff_optional(out: list, what: str, ref: dict, got: dict, keys, rtol):
    """Fields present on one side only with some rows (None otherwise)."""
    for k in keys:
        a, b = ref.get(k), got.get(k)
        if (a is None) != (b is None):
            out.append(f"{what}.{k}: present on one side only")
        elif a is not None:
            _diff(out, f"{what}.{k}", a, b, rtol)


def compare_setups(jax_setup, port_setup, rtol: float = 1e-6) -> list[str]:
    """Hold a RenderSetup of the JAX package against one of the port,
    parsed from the same file: camera, film, sampler, integrator and the
    built scene's fields, as numpy arrays (integer fields exactly, float
    fields to `rtol`).  Returns the mismatches, empty when they agree.  The
    JAX scene is built by the JAX package's own builder on the host."""
    out: list[str] = []
    jc = as_numpy_fields(jax_setup.make_camera())
    tc = port_setup.make_camera()
    tensors = ("camera_to_world",) + (
        ("exit_pupil",) if "exit_pupil" in jc else ("raster_to_camera",))
    for k in tensors:
        _diff(out, f"camera.{k}", jc[k], getattr(tc, k).cpu().numpy(), rtol)
    for k in (("curvature", "element_z", "eta", "aperture_r", "rear_z", "film_diag")
              if "exit_pupil" in jc else ("lens_radius", "focal_distance", "cam_type")):
        _diff(out, f"camera.{k}", jc[k], getattr(tc, k), rtol)
    for k in ("shutter_open", "shutter_close", "full_resolution"):
        _diff(out, f"camera.{k}", jc[k], getattr(tc, k), rtol)

    (jf, jfilt), (tf, tfilt) = jax_setup.make_film_config(), port_setup.make_film_config()
    for k in ("full_resolution", "crop_window", "filter_radius", "scale",
              "max_sample_luminance"):
        _diff(out, f"film.{k}", getattr(jf, k), getattr(tf, k), rtol)
    if jf.filter_name != tf.filter_name:
        out.append(f"film.filter_name: {jf.filter_name!r} != {tf.filter_name!r}")
    _diff(out, "film.filter_radius", jfilt.radius, tfilt.radius, rtol)

    js, ts = jax_setup.make_sampler_config(), port_setup.make_sampler_config()
    for k in ("name", "seed", "exact"):
        if getattr(js, k) != getattr(ts, k):
            out.append(f"sampler.{k}: {getattr(js, k)!r} != {getattr(ts, k)!r}")
    _diff(out, "sampler.spp", js.spp, ts.spp, rtol)
    _diff(out, "sampler.resolution", js.resolution, ts.resolution, rtol)

    ji, ti = jax_setup.make_integrator_config(), port_setup.make_integrator_config()
    if hasattr(ti, "max_depth"):
        _diff(out, "integrator.max_depth", ji.max_depth, ti.max_depth, rtol)
    else:  # AOConfig: the JAX package reads these in render.py:103-112
        jp = jax_setup.integrator_params
        _diff(out, "integrator.cos_sample", jp.find_one_bool("cossample", True),
              ti.cos_sample, rtol)
        _diff(out, "integrator.n_samples", jp.find_one_int("nsamples", 64),
              ti.n_samples, rtol)
    if port_setup.integrator_name in ("bdpt", "mlt", "sppm"):
        # the JAX package reads these in render.py:121-153
        from .sceneio.paramset import ParamSet

        jp = jax_setup.integrator_params or ParamSet()
        want = {"max_depth": jp.find_one_int("maxdepth", 5)}
        if port_setup.integrator_name == "mlt":
            want.update(n_bootstrap=jp.find_one_int("bootstrapsamples", 4096),
                        n_chains=jp.find_one_int("chains", 1024),
                        mutations_per_pixel=jp.find_one_int("mutationsperpixel", 4),
                        sigma=jp.find_one_float("sigma", 0.01),
                        large_step_prob=jp.find_one_float("largestepprobability", 0.3))
        if port_setup.integrator_name == "sppm":
            want.update(n_iterations=jp.find_one_int(
                            "numiterations", jp.find_one_int("iterations", 16)),
                        photons_per_iteration=jp.find_one_int("photonsperiteration", -1),
                        initial_radius=jp.find_one_float("radius", 1.0))
        for k, v in want.items():
            _diff(out, f"integrator.{k}", v, getattr(ti, k), rtol)
    if hasattr(ti, "light_strategy"):  # the JAX package's PathConfig
        _diff(out, "integrator.rr_threshold", ji.rr_threshold, ti.rr_threshold,
              rtol)
        if ji.light_strategy != ti.light_strategy:
            out.append(f"integrator.light_strategy: {ji.light_strategy!r} != "
                       f"{ti.light_strategy!r}")
    if jax_setup.integrator_name != port_setup.integrator_name:
        out.append("integrator name differs")

    ref = as_numpy_fields(jax_setup.build_scene())
    got = port_setup.scene_builder.build_numpy()
    for k in SCENE_FIELDS + MEDIUM_ID_FIELDS:
        _diff(out, f"scene.{k}", ref[k], got[k], rtol)
    for k in MEDIUM_FIELDS:
        _diff(out, f"scene.media.{k}", ref["media"][k], got["media"][k], rtol)
    for k in MATERIAL_FIELDS + ("bump_tex",):
        _diff(out, f"scene.materials.{k}", ref["materials"][k],
              got["materials"][k], rtol)
    _diff_optional(out, "scene.materials", ref["materials"], got["materials"],
                   SUBSURFACE_FIELDS + ("fourier_id",), rtol)
    _diff_optional(out, "scene", ref, got, BSSRDF_FIELDS + GEOMETRY_FIELDS, rtol)
    rt, gt = ref["materials"]["fourier"] or (), got["materials"].get("fourier", ())
    if len(rt) != len(gt):
        out.append(f"scene.materials.fourier: {len(rt)} tables != {len(gt)}")
    for i, (a, b) in enumerate(zip(rt, gt)):
        for k in TABLE_FIELDS + TABLE_INTS + ("eta",):
            _diff(out, f"scene.materials.fourier[{i}].{k}", a[k], b[k], rtol)
    for k in (LIGHT_FIELDS + ENV_FIELDS + MAP_LIGHT_FIELDS
              + ("env_light_idx", "proj_light_idx", "gonio_light_idx")):
        _diff(out, f"scene.lights.{k}", ref["lights"][k], got["lights"][k], rtol)
    for k in DISTRIBUTION_2D_FIELDS:
        _diff(out, f"scene.lights.env_distr.{k}", ref["lights"]["env_distr"][k],
              got["lights"]["env_distr"][k], rtol)
    for k in TEXTURE_FIELDS:
        _diff(out, f"scene.textures.{k}", ref["textures"][k],
              got["textures"][k], rtol)
    for k in ("func", "cdf", "func_int"):
        _diff(out, f"scene.light_distr.{k}", ref["light_distr"][k],
              got["light_distr"][k], rtol)
    return out
