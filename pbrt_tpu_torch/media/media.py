"""Participating media: homogeneous and density grid, Henyey-Greenstein.

Port of pbrt_tpu/media/media.py (core/medium.{h,cpp}, media/homogeneous.cpp,
media/grid.cpp).  The media of a scene form one table (``MediumTable``):
type, sigma_a, sigma_s, g, and for grid media the world-to-medium matrix,
the grid's size and offset into one density atlas and 1 / max density.

* homogeneous media use the closed forms (homogeneous.cpp:44-77), the
  distance sampled on one channel, the pdf averaged over the three;
* grid media sample distances by delta tracking (``grid_sample``,
  grid.cpp:62-87) and compute transmittance by ratio tracking
  (``grid_tr``, grid.cpp:89-112), each a loop of at most ``MAX_STEPS``
  steps drawing from a counter-hash RNG (``_rand``); delta tracking takes
  its first steps' uniforms from sampler dims when given ``u_tab``.

The hash is 32-bit unsigned arithmetic, emulated here in int64 with every
product kept below 2^63, so it equals the JAX package's bit for bit.  The
tracking loops stop once every lane is done, tested every ``CHECK_EVERY``
steps (each test waits for the device); a done lane is held fixed, so the
steps past its end change nothing, and the step cap is the JAX package's.
Only the lanes whose ray overlaps the medium's box run the loop.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.rng import mix32
from ..core.sampling import PI
from ..core.vecmath import coordinate_system, xform_point, xform_vector

MEDIUM_NONE = -1
MEDIUM_HOMOGENEOUS = 0
MEDIUM_GRID = 1
MEDIUM_NAMES = {MEDIUM_HOMOGENEOUS: "homogeneous", MEDIUM_GRID: "heterogeneous"}

INV_4PI = 1.0 / (4.0 * PI)
M32 = 0xFFFFFFFF
_INV_2_32 = 2.3283064365386963e-10
MAX_STEPS = 256  # a tracking loop's steps at most (grid_sample: 2 * 256 draws)
CHECK_EVERY = 4  # tracking steps between two tests for "every lane done"

MEDIUM_FIELDS = ("med_type", "sigma_a", "sigma_s", "g", "w2m", "grid_offset",
                 "grid_nx", "grid_ny", "grid_nz", "inv_max_density",
                 "density_atlas")


@dataclasses.dataclass(frozen=True)
class MediumTable:
    med_type: torch.Tensor  # [M] i32
    sigma_a: torch.Tensor  # [M, 3]
    sigma_s: torch.Tensor  # [M, 3]
    g: torch.Tensor  # [M]
    w2m: torch.Tensor  # [M, 4, 4] world to medium (unit cube) space
    grid_offset: torch.Tensor  # [M] i32 into density_atlas
    grid_nx: torch.Tensor  # [M] i32
    grid_ny: torch.Tensor
    grid_nz: torch.Tensor
    inv_max_density: torch.Tensor  # [M]
    density_atlas: torch.Tensor  # [A], entry 0 a zero pad

    @staticmethod
    def from_numpy(fields: dict, device) -> "MediumTable":
        return MediumTable(**{k: torch.as_tensor(np.asarray(fields[k]),
                                                 device=device)
                              for k in MEDIUM_FIELDS})


class HostMediumTable:
    """The builder's medium rows (MakeNamedMedium), frozen to numpy."""

    def __init__(self):
        self.rows: list[dict] = []
        self.atlas = [np.zeros(1, np.float32)]
        self.size = 1

    def add_homogeneous(self, sigma_a, sigma_s, g=0.0) -> int:
        self.rows.append(_row(MEDIUM_HOMOGENEOUS, sigma_a, sigma_s, g))
        return len(self.rows) - 1

    def add_grid(self, sigma_a, sigma_s, g, nx, ny, nz, density,
                 w2m=None) -> int:
        """A density grid of nx * ny * nz values, x fastest, filling the
        unit cube of medium space; w2m maps world to medium space."""
        density = np.asarray(density, np.float32).reshape(-1)
        if density.size != nx * ny * nz:
            raise ValueError(f"density has {density.size} values, the grid "
                             f"{nx}x{ny}x{nz}")
        off = self.size
        self.atlas.append(density)
        self.size += density.size
        self.rows.append(_row(
            MEDIUM_GRID, sigma_a, sigma_s, g,
            w2m=np.eye(4, dtype=np.float32) if w2m is None else w2m,
            grid_offset=off, grid_nx=nx, grid_ny=ny, grid_nz=nz,
            inv_max_density=1.0 / max(float(density.max()), 1e-9)))
        return len(self.rows) - 1

    def to_numpy(self) -> dict:
        """The table as numpy arrays named as MediumTable's fields; one
        all-zero homogeneous row when the scene has no media."""
        rows = self.rows or [_row(MEDIUM_HOMOGENEOUS, np.zeros(3), np.zeros(3))]
        dtypes = dict(med_type=np.int32, g=np.float32, grid_offset=np.int32,
                      grid_nx=np.int32, grid_ny=np.int32, grid_nz=np.int32,
                      inv_max_density=np.float32)
        out = {k: np.stack([np.asarray(r[k]) for r in rows]).astype(
                   dtypes.get(k, np.float32))
               for k in MEDIUM_FIELDS if k != "density_atlas"}
        out["density_atlas"] = np.concatenate(self.atlas)
        return out


def _row(med_type, sigma_a, sigma_s, g=0.0, w2m=None, grid_offset=0,
         grid_nx=0, grid_ny=0, grid_nz=0, inv_max_density=0.0) -> dict:
    return dict(med_type=med_type, sigma_a=np.asarray(sigma_a, np.float32),
                sigma_s=np.asarray(sigma_s, np.float32), g=float(g),
                w2m=(np.eye(4, dtype=np.float32) if w2m is None
                     else np.asarray(w2m, np.float32)),
                grid_offset=grid_offset, grid_nx=grid_nx, grid_ny=grid_ny,
                grid_nz=grid_nz, inv_max_density=inv_max_density)


# ---------------------------------------------------------------------------
# Henyey-Greenstein phase function (medium.h:50-101)
# ---------------------------------------------------------------------------

def hg_p(cos_theta, g):
    """PhaseHG (medium.h:62)."""
    denom = 1.0 + g * g + 2.0 * g * cos_theta
    return INV_4PI * (1.0 - g * g) / (denom * torch.sqrt(torch.clamp(denom, min=1e-8)))


def hg_sample(wo, u, g):
    """HenyeyGreenstein::Sample_p (medium.cpp:92-116): (wi, pdf = p), the
    angle measured from wo with pbrt's flipped cos_theta."""
    small = torch.abs(g) < 1e-3
    g_safe = torch.where(small, 1e-3 * torch.sign(g + 1e-9), g)
    sqr = (1.0 - g_safe * g_safe) / (1.0 + g_safe - 2.0 * g_safe * u[..., 0])
    cos_theta_g = -(1.0 + g_safe * g_safe - sqr * sqr) / (2.0 * g_safe)
    cos_theta = torch.where(small, 1.0 - 2.0 * u[..., 0], cos_theta_g)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    phi = 2.0 * PI * u[..., 1]
    v1, v2 = coordinate_system(wo)
    wi = ((sin_theta * torch.cos(phi))[..., None] * v1
          + (sin_theta * torch.sin(phi))[..., None] * v2
          + cos_theta[..., None] * wo)
    return wi, hg_p(cos_theta, g)


# ---------------------------------------------------------------------------
# Counter-hash RNG of the tracking loops, uint32 in int64
# ---------------------------------------------------------------------------

def _rand(key, ctr):
    """A uniform in [0, 1) from the 32-bit (key, counter) pair, ctr a
    tensor or one int shared by every lane; the u32 to f32 conversion
    rounds to nearest, as XLA's does."""
    u = mix32(key ^ mix32(ctr)).to(torch.float32) * _INV_2_32
    return torch.clamp(u, max=0.99999994)


def lane_keys(n: int, device):
    """Per-lane hash keys, lane * 0x9E3779B9 mod 2^32 (volpath.py:249)."""
    return (torch.arange(n, dtype=torch.int64, device=device) * 0x9E3779B9) & M32


def key_add(key, c: int):
    return (key + c) & M32


# ---------------------------------------------------------------------------
# Homogeneous medium (media/homogeneous.cpp)
# ---------------------------------------------------------------------------

def homogeneous_tr(sigma_t, dist):
    """Tr = exp(-sigma_t * d) (homogeneous.cpp:44)."""
    return torch.exp(-torch.clamp(sigma_t * dist[..., None], 0.0, 80.0))


def homogeneous_sample(sigma_a, sigma_s, t_max, u_channel, u_dist):
    """HomogeneousMedium::Sample (homogeneous.cpp:49-77): sampled_medium,
    t, and weight [n, 3] (Tr * sigma_s / pdf for a medium event, Tr / pdf
    for the surface)."""
    sigma_t = sigma_a + sigma_s
    channel = torch.clamp((u_channel * 3).to(torch.int32), 0, 2)
    sig_c = torch.where(channel == 0, sigma_t[..., 0],
                        torch.where(channel == 1, sigma_t[..., 1], sigma_t[..., 2]))
    dist = (-torch.log(torch.clamp(1.0 - u_dist, min=1e-10))
            / torch.clamp(sig_c, min=1e-20))
    t = torch.minimum(dist, t_max)
    sampled_medium = (dist < t_max) & (sig_c > 0.0)
    tr = torch.exp(-torch.clamp(sigma_t * t[..., None], 0.0, 80.0))
    density = torch.where(sampled_medium[..., None], sigma_t * tr, tr)
    pdf = (density[..., 0] + density[..., 1] + density[..., 2]) / 3.0
    pdf = torch.where(pdf == 0.0, 1.0, pdf)
    w = tr / pdf[..., None]
    w = torch.where(sampled_medium[..., None], w * sigma_s, w)
    return {"sampled_medium": sampled_medium, "t": t, "weight": w}


# ---------------------------------------------------------------------------
# Grid medium (media/grid.cpp): delta and ratio tracking
# ---------------------------------------------------------------------------

# the eight cell corners (dx, dy, dz), x fastest: the pairs (0, 1), (2, 3),
# ... differ in x, then (0, 2), (1, 3) of the x-lerps in y, then z
_CORNERS = [(0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0),
            (0, 0, 1), (1, 0, 1), (0, 1, 1), (1, 1, 1)]


def _density_fn(med: MediumTable, mid):
    """The trilinear density lookup of grid.cpp:46-60 for fixed lanes of
    medium ids mid: a function of medium-space points [n, 3] in [0, 1]^3,
    zero outside the grid.  The eight corners go through one gather."""
    mid = mid.to(torch.int64)
    n_i = torch.stack([med.grid_nx[mid], med.grid_ny[mid], med.grid_nz[mid]],
                      -1).to(torch.int64)[:, None, :]  # [n, 1, 3]
    n_f = n_i[:, 0].to(torch.float32)
    off = med.grid_offset[mid].to(torch.int64)[:, None]
    corners = torch.tensor(_CORNERS, dtype=torch.int64, device=mid.device)
    atlas = med.density_atlas

    def lerp(t, a, b):
        return a + t[:, None] * (b - a)

    def density(p_med):
        ps = p_med * n_f - 0.5
        pi = torch.floor(ps).to(torch.int32)
        d = ps - pi
        c = pi.to(torch.int64)[:, None, :] + corners  # [n, 8, 3]
        ok = ((c >= 0) & (c < n_i)).all(-1)
        idx = off + (c[..., 2] * n_i[..., 1] + c[..., 1]) * n_i[..., 0] + c[..., 0]
        v = torch.where(ok, atlas[torch.clamp(idx, 0, atlas.shape[0] - 1)], 0.0)
        vx = lerp(d[:, 0], v[:, 0::2], v[:, 1::2])  # d00, d10, d01, d11
        vy = lerp(d[:, 1], vx[:, 0::2], vx[:, 1::2])  # d0, d1
        return vy[:, 0] + d[:, 2] * (vy[:, 1] - vy[:, 0])

    return density


def _grid_density(med: MediumTable, mid, p_med):
    """Trilinear density at medium-space points in [0, 1]^3, zero outside
    the grid (grid.cpp:46-60)."""
    return _density_fn(med, mid)(p_med)


def _grid_setup(med: MediumTable, mid, o, dvec, t_max):
    """Medium-space ray, channel-0 sigma_t, 1 / max density and the ray's
    overlap [t0, t1] with the unit cube, clipped to [0, t_max]."""
    mid = mid.to(torch.int64)
    w2m = med.w2m[mid]
    om = xform_point(w2m, o)
    dm = xform_vector(w2m, dvec)
    sigma_t = (med.sigma_a[mid] + med.sigma_s[mid])[..., 0]
    inv_dm = 1.0 / torch.where(torch.abs(dm) < 1e-12, 1e-12, dm)
    ta = (0.0 - om) * inv_dm
    tb = (1.0 - om) * inv_dm
    t0 = torch.clamp(torch.amax(torch.minimum(ta, tb), -1), min=0.0)
    t1 = torch.minimum(torch.amin(torch.maximum(ta, tb), -1), t_max)
    return mid, om, dm, sigma_t, med.inv_max_density[mid], t0, t1


def _track(step):
    """Run done = step(i) for i = 0, 1, ... until every lane is done
    (tested each CHECK_EVERY steps; no lane is done before step 0) or
    MAX_STEPS steps have run."""
    for i in range(MAX_STEPS):
        if i and i % CHECK_EVERY == 0 and not bool((~done).any()):
            return
        done = step(i)


def grid_sample(med: MediumTable, mid, o, dvec, t_max, key, u_tab=None):
    """GridDensityMedium::Sample (grid.cpp:62-87), delta tracking; o, dvec
    in world space, moved to medium space by each lane's w2m; sigma_t is
    channel 0 (pbrt asks for a spectrally uniform sigma_t).  Returns
    sampled_medium, t (world ray units) and weight [n, 3].

    u_tab [n, 2K]: the first K steps' uniforms from sampler dims
    (grid.cpp:73-74 draws Get1D each step); later steps, and every step
    without u_tab, draw from the counter hash."""
    n = o.shape[0]
    mid, om, dm, sigma_t, inv_max_d, t0, t1 = _grid_setup(med, mid, o, dvec,
                                                          t_max)
    sigma_s = med.sigma_s[mid]
    in_medium = t0 < t1
    t = torch.where(in_medium, t0, t1)
    hit_med = torch.zeros(n, dtype=torch.bool, device=o.device)
    lanes = torch.nonzero(in_medium).flatten()
    if lanes.numel():
        lm, lo, ld_ = mid[lanes], om[lanes], dm[lanes]
        lkey, lt1 = key[lanes], t1[lanes]
        l_inv = inv_max_d[lanes]
        l_sig = torch.clamp(sigma_t[lanes], min=1e-20)
        ltab = None if u_tab is None else u_tab[lanes]
        state = {"t": t[lanes], "done": torch.zeros_like(lanes, dtype=torch.bool),
                 "hit": torch.zeros_like(lanes, dtype=torch.bool)}

        density = _density_fn(med, lm)

        def step(i):
            if ltab is not None and 2 * i < ltab.shape[1]:
                u1, u2 = ltab[:, 2 * i], ltab[:, 2 * i + 1]
            else:
                u1, u2 = _rand(lkey, 2 * i), _rand(lkey, 2 * i + 0x9999)
            t_new = (state["t"]
                     - torch.log(torch.clamp(1.0 - u1, min=1e-10)) * l_inv / l_sig)
            escaped = t_new >= lt1
            real = u2 < density(lo + t_new[:, None] * ld_) * l_inv
            done = state["done"]
            state["hit"] = state["hit"] | (~done & real & ~escaped)
            state["t"] = torch.where(done, state["t"], t_new)
            state["done"] = done | escaped | real
            return state["done"]

        _track(step)
        t = t.index_put((lanes,), state["t"])
        hit_med = hit_med.index_put((lanes,), state["hit"])
    weight = torch.where(hit_med[:, None],
                         sigma_s / torch.clamp(sigma_t, min=1e-20)[:, None],
                         torch.ones((n, 3), dtype=torch.float32, device=o.device))
    return {"sampled_medium": hit_med, "t": torch.minimum(t, t_max),
            "weight": weight}


def grid_tr(med: MediumTable, mid, o, dvec, t_max, key):
    """GridDensityMedium::Tr (grid.cpp:89-112), ratio tracking: Tr [n, 3]
    along [0, t_max]."""
    n = o.shape[0]
    mid, om, dm, sigma_t, inv_max_d, t0, t1 = _grid_setup(med, mid, o, dvec,
                                                          t_max)
    tr = torch.ones(n, dtype=torch.float32, device=o.device)
    lanes = torch.nonzero(t0 < t1).flatten()
    if lanes.numel():
        lm, lo, ld_ = mid[lanes], om[lanes], dm[lanes]
        lkey, lt1 = key[lanes], t1[lanes]
        l_inv = inv_max_d[lanes]
        l_sig = torch.clamp(sigma_t[lanes], min=1e-20)
        state = {"t": t0[lanes], "tr": tr[lanes],
                 "done": torch.zeros_like(lanes, dtype=torch.bool)}

        density = _density_fn(med, lm)

        def step(i):
            u1 = _rand(lkey, i + 0x5555)
            t_new = (state["t"]
                     - torch.log(torch.clamp(1.0 - u1, min=1e-10)) * l_inv / l_sig)
            escaped = t_new >= lt1
            dens = density(lo + t_new[:, None] * ld_)
            tr_new = state["tr"] * (1.0 - torch.clamp(dens * l_inv, min=0.0))
            done = state["done"]
            state["tr"] = torch.where(done | escaped, state["tr"], tr_new)
            state["t"] = torch.where(done, state["t"], t_new)
            state["done"] = done | escaped
            return state["done"]

        _track(step)
        tr = tr.index_put((lanes,), state["tr"])
    return tr[:, None].expand(n, 3).contiguous()
