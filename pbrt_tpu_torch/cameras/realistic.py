"""The realistic (lens-system) camera.

Port of pbrt_tpu/cameras/realistic.py (cameras/realistic.cpp:50-635).  The
element stack is host data, so the walk through it is a loop over the
elements unrolled on the host, each interface's branch (aperture stop or
spherical glass) chosen there; every lane traces film to scene through the
same interfaces.  Host-side at build: the paraxial focusing (realistic.cpp:
387-464) and the exit-pupil table (realistic.cpp:468-521: 64 radial zones,
each the bounds of 1024 seeded rays that pass the lens, traced on the CPU).

Lens rows follow pbrt's .dat convention, scene side first:
  curvature_radius  thickness  eta  aperture_diameter   (mm)
A curvature radius of 0 marks the aperture stop.  ``DGAUSS_50MM`` is the
double-Gauss f/2 50 mm design printed in the PBRT book, used when a scene
names no lens file.

Host scalars are float32 values carried as Python floats, and every
operation on them is done in float32 (numpy), as the JAX package's 0-d
float32 arrays do.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import transform as tf
from ..core.vecmath import normalize, xform_point, xform_vector

DGAUSS_50MM = np.array(
    [
        [29.475, 3.76, 1.67, 25.2],
        [84.83, 0.12, 1.0, 25.2],
        [19.275, 4.025, 1.67, 23.0],
        [40.77, 3.275, 1.699, 23.0],
        [12.75, 5.705, 1.0, 18.0],
        [0.0, 4.5, 0.0, 17.1],
        [-14.495, 1.18, 1.603, 17.0],
        [40.77, 6.065, 1.658, 20.0],
        [-20.385, 0.19, 1.0, 20.0],
        [437.065, 3.22, 1.717, 20.0],
        [-39.73, 0.0, 1.0, 20.0],
    ],
    np.float64,
)

N_PUPIL_ZONES = 64
_f32 = np.float32


@dataclasses.dataclass(frozen=True)
class RealisticParams:
    """The JAX package's RealisticParams: the element table (scene side
    first, metres, camera space with the film at z = 0 and the elements at
    z < 0) as float32 numpy arrays, the exit-pupil bounds [64, 4] (x0, y0,
    x1, y1 on the rear element's plane) and camera_to_world as tensors."""
    camera_to_world: torch.Tensor  # [4, 4]
    curvature: np.ndarray  # [E]
    element_z: np.ndarray  # [E] apex z of each interface
    eta: np.ndarray  # [E] ior on the film side of each interface (0: air)
    aperture_r: np.ndarray  # [E]
    exit_pupil: torch.Tensor  # [Z, 4]
    rear_z: float
    film_diag: float  # metres
    shutter_open: float
    shutter_close: float
    full_resolution: tuple

    @property
    def n_elements(self) -> int:
        return len(self.curvature)

    def to(self, device) -> "RealisticParams":
        return dataclasses.replace(self,
                                   camera_to_world=self.camera_to_world.to(device),
                                   exit_pupil=self.exit_pupil.to(device))


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _trace_film_to_scene(cam: RealisticParams, o, d):
    """TraceLensesFromFilm (realistic.cpp:310-385): rays start on the film
    side and cross the stack toward the scene.  Returns (ok, o, d) in camera
    space before pbrt's z flip."""
    ok = torch.ones(o.shape[:-1], dtype=torch.bool, device=o.device)
    for i in range(cam.n_elements - 1, -1, -1):  # film -> scene
        r, zc = _f32(cam.curvature[i]), _f32(cam.element_z[i])
        if r == 0.0:  # the aperture stop: a plane
            t = (float(zc) - o[..., 2]) / torch.where(d[..., 2] == 0, 1e-12, d[..., 2])
            ok = ok & (t > 0)
        else:
            center = torch.zeros_like(o)
            center[..., 2] = float(zc + r)
            oc = o - center
            b = _dot(oc, d)
            c = _dot(oc, oc) - float(r * r)
            disc = b * b - c
            sq = torch.sqrt(torch.clamp(disc, min=0.0))
            # IntersectSphericalElement's useCloser (realistic.cpp:157-168)
            use_closer = (d[..., 2] > 0.0) ^ bool(r < 0.0)
            t = torch.where(use_closer, -b - sq, -b + sq)
            ok = ok & (disc >= 0) & (t > 0)
        p = o + t[..., None] * d
        ok = ok & (p[..., 0] ** 2 + p[..., 1] ** 2 <= float(_f32(cam.aperture_r[i]) ** 2))
        # Row i's ior is the medium on the film side of surface i, row i-1's
        # the scene side (realistic.cpp:341-346 etaI / etaT).
        eta_i = _f32(cam.eta[i]) if cam.eta[i] != 0.0 else _f32(1.0)
        eta_t = (_f32(cam.eta[i - 1]) if i > 0 and cam.eta[i - 1] != 0.0
                 else _f32(1.0))
        etar = _f32(eta_i / eta_t)
        if r != 0.0 and abs(etar - _f32(1.0)) > 1e-5:
            nrm = normalize(p - center)
            nrm = torch.where((_dot(nrm, -d) < 0.0)[..., None], -nrm, nrm)
            cos_i = _dot(nrm, -d)
            sin2_t = float(etar * etar) * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
            tir = sin2_t >= 1.0
            cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
            d_new = normalize(float(etar) * d + (float(etar) * cos_i - cos_t)[..., None] * nrm)
            ok = ok & ~tir
            d = torch.where(ok[..., None], d_new, d)
        o = torch.where(ok[..., None], p, o)
    return ok, o, d


def _element_zs(lens: np.ndarray) -> np.ndarray:
    """Apex z of each interface: the film at z = 0, thicknesses summed film
    to scene (realistic.cpp:310-320)."""
    z = np.zeros(len(lens))
    cur = 0.0
    for i in range(len(lens) - 1, -1, -1):
        cur -= lens[i, 1]
        z[i] = cur
    return z


def _params(lens, zs, zones, film_diag_m, c2w=None, res=(1, 1),
            shutter=(0.0, 1.0), device="cpu") -> RealisticParams:
    return RealisticParams(
        camera_to_world=torch.as_tensor(
            np.eye(4, dtype=np.float32) if c2w is None else c2w, device=device),
        curvature=lens[:, 0].astype(np.float32),
        element_z=zs.astype(np.float32),
        eta=lens[:, 2].astype(np.float32),
        aperture_r=lens[:, 3].astype(np.float32),
        exit_pupil=torch.as_tensor(
            zones if zones is not None
            else np.zeros((N_PUPIL_ZONES, 4), np.float32), device=device),
        rear_z=float(_f32(zs[-1])), film_diag=float(_f32(film_diag_m)),
        shutter_open=float(_f32(shutter[0])), shutter_close=float(_f32(shutter[1])),
        full_resolution=tuple(res),
    )


def _build_pupil_and_focus(lens_mm, film_diag_m, focus_distance):
    """Host: the paraxial focusing (realistic.cpp:387-464, with ray-transfer
    matrices) and the exit-pupil zones (realistic.cpp:468-521), in metres.
    Returns (lens rows in metres with radii, element zs, zones)."""
    lens = np.asarray(lens_mm, np.float64).copy()
    lens[:, 0] *= 1e-3
    lens[:, 1] *= 1e-3
    lens[:, 3] *= 1e-3 / 2.0  # diameter -> radius
    # The rear air gap d_i that images an object at focus_distance onto the
    # film: (y, n u) through each surface (power (n' - n) / R) and gap.
    M = np.eye(2)
    n_cur = 1.0  # the scene side is air
    total_len = lens[:, 1].sum()
    for i in range(len(lens)):  # scene -> film
        r = lens[i, 0]
        n_next = lens[i, 2] if lens[i, 2] != 0.0 else n_cur
        if r != 0.0:
            M = np.array([[1.0, 0.0], [-(n_next - n_cur) / r, 1.0]]) @ M
        t = lens[i, 1]
        if i < len(lens) - 1 and t > 0:
            M = np.array([[1.0, t / n_next], [0.0, 1.0]]) @ M
        n_cur = n_next
    d_o = max(focus_distance - total_len, 0.1)
    num = M[0, 0] * d_o + M[0, 1]
    den = M[1, 0] * d_o + M[1, 1]
    d_i = -num / den if abs(den) > 1e-12 else 0.05
    if not (1e-4 < d_i < 1.0):
        d_i = 0.05  # a 50 mm flange distance
    lens[-1, 1] = d_i
    zs = _element_zs(lens)
    params = _params(lens, zs, None, film_diag_m)

    rear_z = zs[-1]
    rear_r = lens[-1, 3]
    zones = np.zeros((N_PUPIL_ZONES, 4), np.float32)
    rs = np.random.RandomState(7)
    half_diag = 0.5 * film_diag_m
    S = 1024
    for zi in range(N_PUPIL_ZONES):
        r0 = zi / N_PUPIL_ZONES * half_diag
        r1 = (zi + 1) / N_PUPIL_ZONES * half_diag
        x_film = r0 + (r1 - r0) * rs.rand(S)
        px = (rs.rand(S, 2) * 2 - 1) * rear_r * 1.5
        o = np.stack([x_film, np.zeros(S), np.zeros(S)], -1)
        d = np.stack([px[:, 0] - x_film, px[:, 1], np.full(S, rear_z)], -1)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        ok, _, _ = _trace_film_to_scene(
            params, torch.as_tensor(o, dtype=torch.float32),
            torch.as_tensor(d, dtype=torch.float32))
        ok = ok.numpy()
        if ok.sum() == 0:
            zones[zi] = [-rear_r, -rear_r, rear_r, rear_r]
            continue
        good = px[ok]
        pad = 2.0 * rear_r * 1.5 / np.sqrt(S)
        zones[zi] = [good[:, 0].min() - pad, good[:, 1].min() - pad,
                     good[:, 0].max() + pad, good[:, 1].max() + pad]
    return lens, zs, zones


def make_realistic_camera(camera_to_world: tf.Transform, resolution,
                          lens_data=None, film_diag_mm: float = 35.0,
                          focus_distance: float = 10.0,
                          shutter_open: float = 0.0, shutter_close: float = 1.0,
                          device="cpu") -> RealisticParams:
    """RealisticCamera (realistic.cpp:50-85): `lens_data` rows in mm, the
    built-in DGAUSS_50MM when None."""
    lens_mm = DGAUSS_50MM if lens_data is None else np.asarray(lens_data)
    film_diag_m = film_diag_mm * 1e-3
    lens, zs, zones = _build_pupil_and_focus(lens_mm, film_diag_m, focus_distance)
    return _params(lens, zs, zones, film_diag_m,
                   c2w=np.asarray(camera_to_world.m, np.float32), res=resolution,
                   shutter=(shutter_open, shutter_close), device=device)


def generate_rays_realistic(cam: RealisticParams, p_film, p_lens, time_u):
    """RealisticCamera::GenerateRay (realistic.cpp:575-635).  Returns
    (o, d, time, weight); a vignetted lane has weight 0 and the ray where
    the lens stopped it."""
    n = p_film.shape[0]
    xr, yr = cam.full_resolution
    # The film sample on the physical film, rotated 180 degrees
    # (realistic.cpp:583-586).
    aspect = yr / xr
    diag = _f32(cam.film_diag)
    x_extent = _f32(diag / np.sqrt(_f32(1.0 + aspect * aspect)))
    y_extent = _f32(x_extent * _f32(aspect))
    sx = (0.5 - p_film[:, 0] / xr) * float(x_extent)
    sy = (p_film[:, 1] / yr - 0.5) * float(y_extent)
    r_film = torch.sqrt(sx * sx + sy * sy)
    zone = torch.clamp((r_film / float(_f32(0.5) * diag) * N_PUPIL_ZONES)
                       .to(torch.int64), 0, N_PUPIL_ZONES - 1)
    zb = cam.exit_pupil[zone]  # [N, 4]
    px = zb[:, 0] + p_lens[:, 0] * (zb[:, 2] - zb[:, 0])
    py = zb[:, 1] + p_lens[:, 1] * (zb[:, 3] - zb[:, 1])
    area = torch.clamp((zb[:, 2] - zb[:, 0]) * (zb[:, 3] - zb[:, 1]), min=0.0)
    # The pupil point rotated by the film point's azimuth (SampleExitPupil,
    # realistic.cpp:524-541 and 597).
    far = r_film > 1e-9
    sin_a = torch.where(far, sy / torch.clamp(r_film, min=1e-9), 0.0)
    cos_a = torch.where(far, sx / torch.clamp(r_film, min=1e-9), 1.0)
    lx = cos_a * px - sin_a * py
    ly = sin_a * px + cos_a * py
    zeros = torch.zeros_like(sx)
    o = torch.stack([sx, sy, zeros], -1)
    d = normalize(torch.stack([lx, ly, torch.full_like(sx, cam.rear_z)], -1) - o)
    ok, oo, dd = _trace_film_to_scene(cam, o, d)
    # pbrt's flip to the scene side (+z forward, as the perspective camera)
    flip = torch.tensor([1.0, 1.0, -1.0], device=p_film.device)
    o_w = xform_point(cam.camera_to_world, oo * flip)
    d_w = normalize(xform_vector(cam.camera_to_world, dd * flip))
    time = cam.shutter_open + time_u * (cam.shutter_close - cam.shutter_open)
    # realistic.cpp:603-633's weight cos^4 * A_pupil / rear_z^2, divided by
    # the pupil's on-axis value so exposure compares with the projective
    # cameras'
    rear2 = max(float(_f32(_f32(cam.rear_z) * _f32(cam.rear_z))), 1e-12)
    cos2 = d[:, 2].abs() * d[:, 2].abs()
    w = torch.where(ok, cos2 * cos2 * area / rear2, 0.0)
    w_axis = torch.clamp(area, min=1e-12) / rear2
    w = torch.where(w_axis > 0, w / torch.clamp(w_axis, min=1e-12), w)
    return o_w, d_w, time, w
