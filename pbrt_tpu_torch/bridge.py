"""Carry the JAX package's scene and camera over to the port, as numpy.

The JAX package (pbrt_tpu) builds SceneArrays and CameraParams as frozen
dataclasses of arrays.  A caller flattens them to numpy (``as_numpy_fields``
does that for any dataclass, without importing JAX) and hands the result
here, so both packages render the very same arrays.  The port itself never
imports JAX or pbrt_tpu.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .cameras import CameraParams
from .scene import SceneArrays, resolve_device


def as_numpy_fields(obj) -> dict:
    """A dataclass of arrays (nested dataclasses included) as a dict of
    numpy arrays; None fields are kept as None."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = as_numpy_fields(v)
        elif v is None or isinstance(v, (int, float, str, tuple)):
            out[f.name] = v
        else:
            out[f.name] = np.array(v)
    return out


def scene_from_numpy(fields: dict, device) -> SceneArrays:
    """The JAX package's SceneArrays, as numpy fields, on `device`.
    MaterialTable, LightTable and light_distr arrive as nested dicts."""
    for key in ("prim_medium_inside", "prim_medium_outside"):
        ids = fields.get(key)
        if ids is not None and (np.asarray(ids) >= 0).any():
            raise NotImplementedError("participating media")
    return SceneArrays.from_numpy(fields, device)


def camera_from_numpy(fields: dict, device) -> CameraParams:
    """The JAX package's CameraParams, as numpy fields, on `device`."""
    device = resolve_device(device)
    if int(fields.get("cam_type", 0)) != 0:
        raise NotImplementedError("only the perspective camera is ported")
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
    )
