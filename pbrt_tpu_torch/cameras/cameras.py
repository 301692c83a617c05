"""Camera ray generation.

Port of pbrt_tpu/cameras/cameras.py: the perspective, orthographic (both
with a thin lens) and environment cameras (cameras/perspective.cpp:43-95,
orthographic.cpp, environment.cpp:43-57).  The host builds RasterToCamera
once from numpy transforms; ``generate_rays`` maps a flat batch of film /
lens / time samples to world-space rays, dispatching a RealisticParams to
cameras/realistic.py, and ``generate_ray_differentials`` adds the rays one
pixel over in x and in y.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import numpy as np
import torch

from ..core import sampling as smp
from ..core import transform as tf
from ..core.vecmath import normalize, xform_point, xform_vector
from .realistic import RealisticParams, generate_rays_realistic

CAM_PERSPECTIVE = 0
CAM_ORTHOGRAPHIC = 1
CAM_ENVIRONMENT = 2


@dataclasses.dataclass(frozen=True)
class CameraParams:
    """lens_radius and focal_distance are floats, or 0-d tensors when they
    are gradient leaves (parallel/diff.py); host_lens_radius keeps the lens
    radius as a Python float beside them, so ray generation picks the
    thin-lens branch on the host without reading the card."""
    raster_to_camera: torch.Tensor  # [4, 4]
    camera_to_world: torch.Tensor  # [4, 4]
    lens_radius: Union[float, torch.Tensor]
    focal_distance: Union[float, torch.Tensor]
    shutter_open: float
    shutter_close: float
    full_resolution: tuple
    cam_type: int = CAM_PERSPECTIVE
    host_lens_radius: Optional[float] = None

    def __post_init__(self):
        if not isinstance(self.lens_radius, torch.Tensor):
            object.__setattr__(self, "host_lens_radius", float(self.lens_radius))
        elif self.host_lens_radius is None:
            raise ValueError("a tensor lens_radius needs host_lens_radius")

    def to(self, device) -> "CameraParams":
        def move(x):
            return x.to(device) if isinstance(x, torch.Tensor) else x
        return dataclasses.replace(
            self, raster_to_camera=self.raster_to_camera.to(device),
            camera_to_world=self.camera_to_world.to(device),
            lens_radius=move(self.lens_radius),
            focal_distance=move(self.focal_distance))


def _screen_window(aspect: float, screen=None):
    if screen is not None:
        return screen
    if aspect > 1.0:
        return (-aspect, aspect, -1.0, 1.0)
    return (-1.0, 1.0, -1.0 / aspect, 1.0 / aspect)


def _raster_to_screen(resolution, screen):
    x0, x1, y0, y1 = screen
    xr, yr = resolution
    s2r = (tf.scale(xr, yr, 1.0) @ tf.scale(1.0 / (x1 - x0), 1.0 / (y0 - y1), 1.0)
           @ tf.translate(-x0, -y1, 0.0))
    return s2r.inverse


def perspective_matrices(camera_to_world: tf.Transform, resolution,
                         fov_deg: float = 90.0, screen=None):
    """(raster_to_camera, camera_to_world) as float32 numpy 4x4 matrices,
    computed as the JAX package's make_perspective_camera does."""
    return _projective_matrices(tf.perspective(fov_deg, 1e-2, 1000.0),
                                camera_to_world, resolution, screen)


def _projective_matrices(cam_to_screen: tf.Transform,
                         camera_to_world: tf.Transform, resolution, screen):
    """The ProjectiveCamera ctor's RasterToCamera (camera.h), and
    CameraToWorld, as float32 numpy 4x4 matrices."""
    screen = _screen_window(resolution[0] / resolution[1], screen)
    raster_to_screen = _raster_to_screen(resolution, screen)
    r2c = cam_to_screen.m_inv @ raster_to_screen.m
    return np.asarray(r2c, np.float32), np.asarray(camera_to_world.m, np.float32)


def perspective_raster_to_camera(fov_deg, resolution, screen=None,
                                 znear=1e-2, zfar=1000.0):
    """RasterToCamera as a differentiable function of fov_deg (a 0-d
    tensor or a float), the counterpart of the JAX package's
    perspective_raster_to_camera (cameras.py:93-118): Perspective
    (transform.cpp:238) composed with the ProjectiveCamera ctor's
    raster-to-screen.  Returns a float32 [4, 4] tensor on fov_deg's device
    (the CPU for a float)."""
    fov = torch.as_tensor(fov_deg, dtype=torch.float32)
    aspect = resolution[0] / resolution[1]
    r2s = torch.as_tensor(np.asarray(
        _raster_to_screen(resolution, _screen_window(aspect, screen)).m,
        np.float32), device=fov.device)
    persp = torch.tensor(
        [[1.0, 0.0, 0.0, 0.0],
         [0.0, 1.0, 0.0, 0.0],
         [0.0, 0.0, zfar / (zfar - znear), -zfar * znear / (zfar - znear)],
         [0.0, 0.0, 1.0, 0.0]], dtype=torch.float32, device=fov.device)
    inv_tan = 1.0 / torch.tan(fov * (math.pi / 180.0) / 2.0)
    one = torch.ones_like(inv_tan)
    cam_to_screen = torch.diag(torch.stack([inv_tan, inv_tan, one, one])) @ persp
    return torch.linalg.inv(cam_to_screen) @ r2s


def make_perspective_camera(camera_to_world: tf.Transform, resolution,
                            fov_deg: float = 90.0, screen=None,
                            lens_radius: float = 0.0,
                            focal_distance: float = 1e6,
                            shutter_open: float = 0.0,
                            shutter_close: float = 1.0,
                            device="cpu") -> CameraParams:
    """PerspectiveCamera (perspective.cpp:43-95)."""
    r2c, c2w = perspective_matrices(camera_to_world, resolution, fov_deg, screen)
    return CameraParams(
        raster_to_camera=torch.as_tensor(r2c, device=device),
        camera_to_world=torch.as_tensor(c2w, device=device),
        lens_radius=float(np.float32(lens_radius)),
        focal_distance=float(np.float32(focal_distance)),
        shutter_open=float(np.float32(shutter_open)),
        shutter_close=float(np.float32(shutter_close)),
        full_resolution=tuple(resolution),
    )


def make_orthographic_camera(camera_to_world: tf.Transform, resolution,
                             screen=None, lens_radius: float = 0.0,
                             focal_distance: float = 1e6,
                             shutter_open: float = 0.0,
                             shutter_close: float = 1.0,
                             device="cpu") -> CameraParams:
    """OrthographicCamera (orthographic.cpp), with its thin lens."""
    r2c, c2w = _projective_matrices(tf.orthographic(0.0, 1.0), camera_to_world,
                                    resolution, screen)
    return CameraParams(
        raster_to_camera=torch.as_tensor(r2c, device=device),
        camera_to_world=torch.as_tensor(c2w, device=device),
        lens_radius=float(np.float32(lens_radius)),
        focal_distance=float(np.float32(focal_distance)),
        shutter_open=float(np.float32(shutter_open)),
        shutter_close=float(np.float32(shutter_close)),
        full_resolution=tuple(resolution), cam_type=CAM_ORTHOGRAPHIC,
    )


def make_environment_camera(camera_to_world: tf.Transform, resolution,
                            shutter_open: float = 0.0,
                            shutter_close: float = 1.0,
                            device="cpu") -> CameraParams:
    """EnvironmentCamera (environment.cpp:43): equirectangular rays from
    the camera's origin, weight 1."""
    return CameraParams(
        raster_to_camera=torch.eye(4, device=device),
        camera_to_world=torch.as_tensor(
            np.asarray(camera_to_world.m, np.float32), device=device),
        lens_radius=0.0, focal_distance=float(np.float32(1e6)),
        shutter_open=float(np.float32(shutter_open)),
        shutter_close=float(np.float32(shutter_close)),
        full_resolution=tuple(resolution), cam_type=CAM_ENVIRONMENT,
    )


def generate_rays(cam, p_film, p_lens, time_u):
    """Camera::GenerateRay over a batch.  Returns (o, d, time, weight)."""
    if isinstance(cam, RealisticParams):
        return generate_rays_realistic(cam, p_film, p_lens, time_u)
    n = p_film.shape[0]
    dev = p_film.device
    time = cam.shutter_open + time_u * (cam.shutter_close - cam.shutter_open)
    ones = torch.ones(n, dtype=torch.float32, device=dev)
    if cam.cam_type == CAM_ENVIRONMENT:
        # environment.cpp:43-57: theta and phi from the raster position.
        xr, yr = cam.full_resolution
        theta = math.pi * p_film[:, 1] / yr
        phi = 2.0 * math.pi * p_film[:, 0] / xr
        sin_t = torch.sin(theta)
        d = torch.stack([sin_t * torch.cos(phi), torch.cos(theta),
                         sin_t * torch.sin(phi)], -1)
        o = xform_point(cam.camera_to_world,
                        torch.zeros((n, 3), dtype=torch.float32, device=dev))
        return o, xform_vector(cam.camera_to_world, d), time, ones
    p_raster = torch.cat([p_film, torch.zeros((n, 1), device=dev)], dim=-1)
    m = cam.raster_to_camera
    p_cam_h = xform_point(m, p_raster)
    w = (m[3, 0] * p_raster[:, 0] + m[3, 1] * p_raster[:, 1]
         + m[3, 2] * p_raster[:, 2] + m[3, 3])
    p_cam = p_cam_h / w[:, None]
    if cam.cam_type == CAM_PERSPECTIVE:
        o = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        d = normalize(p_cam)
    else:
        o = p_cam
        d = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        d[:, 2] = 1.0
    if cam.host_lens_radius > 0.0:
        # Thin-lens depth of field (perspective.cpp:76-95; the JAX package
        # puts the orthographic camera's lens origin at the lens point too,
        # cameras.py:218-228).  Without a lens the branch is not taken, and
        # lens_radius and focal_distance get zero gradients, as the JAX
        # package's jnp.where gives them.
        pl = cam.lens_radius * smp.concentric_sample_disk(p_lens)
        ft = cam.focal_distance / d[:, 2]
        p_focus = o + ft[:, None] * d
        o = torch.cat([pl, torch.zeros((n, 1), device=dev)], dim=-1)
        d = normalize(p_focus - o)
    o = xform_point(cam.camera_to_world, o)
    d = xform_vector(cam.camera_to_world, d)
    return o, d, time, ones


def generate_ray_differentials(cam, p_film, p_lens, time_u,
                               spp: int = 1):
    """Camera::GenerateRayDifferential (camera.cpp:68-85): the rays at
    pFilm + (1, 0) and pFilm + (0, 1) with the same lens and time samples,
    then ScaleDifferentials(1 / sqrt(spp)) (integrator.cpp:290).
    Returns (o, d, time, weight, rx_o, rx_d, ry_o, ry_d)."""
    o, d, time, w = generate_rays(cam, p_film, p_lens, time_u)
    dx = torch.tensor([1.0, 0.0], device=p_film.device)
    rx_o, rx_d, _, _ = generate_rays(cam, p_film + dx, p_lens, time_u)
    ry_o, ry_d, _, _ = generate_rays(cam, p_film + dx.flip(0), p_lens, time_u)
    s = 1.0 / math.sqrt(max(int(spp), 1))
    return (o, d, time, w, o + (rx_o - o) * s, d + (rx_d - d) * s,
            o + (ry_o - o) * s, d + (ry_d - d) * s)
