"""Differentiable rendering: pixel gradients with respect to materials,
lights and the camera, through torch autograd.

Port of pbrt_tpu/parallel/diff.py, with its estimator: the discrete events
(hit ids, traversal t, lobe choices, Russian-roulette decisions, light
picks) are detached, and gradients flow through every continuous factor
(BSDF f, cosines, Le, pdfs, camera rays) of the same paths.  The traversal
kernels run under no_grad (accel/traverse.py), and hit_record re-derives the
hit differentiably for the fixed prim id, so the gradient is the exact
derivative of the render at a fixed sample sequence.

Backward memory: render_grad_step(remat=True) checkpoints each bounce but
the last (integrators/path.py li_path), so the backward pass replays each
bounce, its traversal launch included, from the bounce's carry instead of
holding every bounce's activations.

The spatial light distribution, when the path config asks for it, is built
once before the step (through numpy), so its pmf stays constant with respect
to light_L, as in the JAX package.
"""
from __future__ import annotations

import dataclasses

import torch

from ..cameras import generate_rays
from ..integrators import path as ip
from ..lights import lightdistrib as ldist
from ..samplers import samplers as sa
from .. import scene as sc
from ..scene import resolve_device
from ..utils import stats as st

# Parameter-set keys accepted by render_grad_step.
MATERIAL_PARAMS = ("kd", "ks", "roughness")
LIGHT_PARAMS = ("light_L",)
CAMERA_PARAMS = ("camera",)
DEFAULT_PARAMS = MATERIAL_PARAMS + LIGHT_PARAMS + CAMERA_PARAMS
CAMERA_LEAVES = ("camera_to_world", "raster_to_camera", "lens_radius",
                 "focal_distance")


def _leaf(x, device):
    return (torch.as_tensor(x, dtype=torch.float32, device=device)
            .detach().clone().requires_grad_(True))


def extract_params(scene, camera, names=DEFAULT_PARAMS):
    """The differentiable parameters of (scene, camera): detached leaf
    copies that require grad, keyed as the JAX package keys them
    ("camera" maps to a dict of its four leaves)."""
    dev = scene.device
    out = {}
    for nm in names:
        if nm in MATERIAL_PARAMS:
            out[nm] = _leaf(getattr(scene.materials, nm), dev)
        elif nm == "light_L":
            out[nm] = _leaf(scene.lights.L, dev)
        elif nm == "camera":
            out[nm] = {k: _leaf(getattr(camera, k), dev) for k in CAMERA_LEAVES}
        else:
            raise ValueError(f"unknown grad param {nm!r}")
    return out


def apply_params(scene, camera, params):
    """(scene, camera) with the parameters put in; every other field, the
    spatial light distribution's tables among them, is kept.  A tensor
    lens_radius also sets the camera's host_lens_radius, so ray generation
    takes the thin-lens branch exactly when the new radius is positive."""
    mat_updates = {k: v for k, v in params.items() if k in MATERIAL_PARAMS}
    if mat_updates:
        scene = dataclasses.replace(
            scene, materials=dataclasses.replace(scene.materials, **mat_updates))
    if "light_L" in params:
        scene = dataclasses.replace(
            scene, lights=dataclasses.replace(scene.lights, L=params["light_L"]))
    if "camera" in params:
        cam = dict(params["camera"])
        lens = cam.get("lens_radius")
        if isinstance(lens, torch.Tensor):
            # The thin-lens branch follows the value put in, read once here
            # (the JAX package decides from the value on each call).
            cam["host_lens_radius"] = float(lens.detach())
        camera = dataclasses.replace(camera, **cam)
    return scene, camera


# materials and lights whose gradients are not held against the JAX
# package (its diff.py differentiates them generically)
_UNCHECKED_MATERIALS = (sc.MAT_GLASS, sc.MAT_METAL, sc.MAT_SUBSTRATE,
                        sc.MAT_UBER, sc.MAT_TRANSLUCENT, sc.MAT_MIX)
_UNCHECKED_LIGHTS = (sc.LIGHT_INFINITE, sc.LIGHT_SPOT, sc.LIGHT_DISTANT,
                     sc.LIGHT_PROJECTION, sc.LIGHT_GONIO)


def _refuse_unchecked(scene):
    """Gradients through textures, glass, metal, substrate, uber,
    translucent and mix, and the infinite, spot, distant, projection and
    goniometric lights are not held against the JAX package; a step on
    such a scene raises instead of returning an unchecked gradient."""
    lacks = (["textures"] if scene.has_textures else [])
    lacks += [sc.SUPPORTED_MATERIALS[t] for t in _UNCHECKED_MATERIALS
              if t in scene.mat_types]
    lacks += [f"{sc.SUPPORTED_LIGHTS[t]} lights" for t in _UNCHECKED_LIGHTS
              if t in scene.light_types]
    if lacks:
        raise NotImplementedError(
            f"gradients through {', '.join(lacks)} are not ported")


def render_batch_radiance(scene, camera, pixels, sample_num: int, sampler_cfg,
                          path_cfg, remat: bool = False, counters=None):
    """Forward: per-pixel radiance L [n, 3] of one sample batch, with
    non-finite L zeroed (diff.py:91-92).  counters: a stats vector
    (utils/stats.py) to bump, or None."""
    n = pixels.shape[0]
    state = ip.batch_sampler_state(sampler_cfg, pixels, sample_num,
                                   ip.n_path_dims(path_cfg))
    p_film, time_u, p_lens = sa.get_camera_sample(sampler_cfg, state, pixels)
    o, d, _, _ = generate_rays(camera, p_film, p_lens, time_u)
    if counters is None:
        counters = st.zeros(pixels.device)
    L = ip.li_path(scene, o, d, sampler_cfg, state, path_cfg, counters,
                   remat=remat)
    st.bump(counters, "Film/Samples added", float(n))
    bad = ~torch.all(torch.isfinite(L), -1)
    return torch.where(bad[:, None], 0.0, L)


def render_grad_step(scene, camera, pixels, sample_num: int, grad_weights,
                     sampler_cfg, path_cfg, param_names=DEFAULT_PARAMS,
                     remat: bool = True, device="cuda", counters=None):
    """One differentiable render step: forward one sample batch, then the
    gradient of sum(L * grad_weights) with respect to param_names.

    grad_weights: [n, 3], the adjoint of each pixel sample (dLoss/dL).
    Returns (L, grads): L detached, grads keyed by param_names, with
    "camera" a dict of the camera_to_world, raster_to_camera, lens_radius
    and focal_distance gradients.  Runs on the card unless device="cpu";
    scene, pixels and grad_weights must be on that device.  counters: a
    stats vector to bump with the forward's rays, or None."""
    device = resolve_device(device)
    if scene.device != device:
        raise ValueError(f"scene is on {scene.device}, the step asked for "
                         f"{device}")
    _refuse_unchecked(scene)
    if path_cfg.light_strategy == "spatial":
        scene = ldist.ensure_spatial_light_distribution(scene)
    camera = camera.to(device)
    params = extract_params(scene, camera, param_names)
    s2, cam2 = apply_params(scene, camera, params)
    L = render_batch_radiance(s2, cam2, pixels, sample_num, sampler_cfg,
                              path_cfg, remat=remat, counters=counters)
    # (key, camera leaf or None, tensor) for each leaf, in one flat list
    flat = [(k, c, x) for k, v in params.items()
            for c, x in (v.items() if k == "camera" else [(None, v)])]
    gs = torch.autograd.grad(torch.sum(L * grad_weights), [x for *_, x in flat],
                             allow_unused=True)
    grads = {"camera": {}} if "camera" in params else {}
    for (k, c, x), g in zip(flat, gs):
        g = torch.zeros_like(x) if g is None else g  # a leaf the step never read
        if c is None:
            grads[k] = g
        else:
            grads[k][c] = g
    return L.detach(), grads
