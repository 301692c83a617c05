"""Cameras (port of pbrt_tpu/cameras/): perspective, orthographic,
environment and realistic."""
from .cameras import (CameraParams, generate_ray_differentials, generate_rays,
                      make_environment_camera, make_orthographic_camera,
                      make_perspective_camera)
from .realistic import RealisticParams, make_realistic_camera

__all__ = ["CameraParams", "RealisticParams", "generate_ray_differentials",
           "generate_rays", "make_environment_camera",
           "make_orthographic_camera", "make_perspective_camera",
           "make_realistic_camera"]
