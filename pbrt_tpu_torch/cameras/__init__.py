"""Cameras (port of pbrt_tpu/cameras/, perspective only)."""
from .cameras import (CameraParams, generate_ray_differentials, generate_rays,
                      make_perspective_camera)

__all__ = ["CameraParams", "generate_ray_differentials", "generate_rays",
           "make_perspective_camera"]
