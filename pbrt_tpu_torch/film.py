"""Film: filtered radiance accumulation into image tensors.

Port of pbrt_tpu/film.py (core/film.{h,cpp}): a dense [H, W] film updated
with scatter-adds from flat sample batches, a 16x16 filter LUT exactly as
pbrt discretises it (film.cpp:66-76), and RGB accumulation.

The scatter sums each pixel's contributions in one fixed order on every
device: the order XLA:CPU's scatter adds them in the JAX package, by
sample, then footprint row, then column, each added to the film's running
sum.  A filter wider than the box reaches a pixel from several samples of
a batch, and ``index_put_(accumulate=True)`` promises no order on the card,
so ``add_samples`` sorts the contributions by pixel (a stable sort keeps
the sample order within a pixel), numbers each pixel's contributions from
0, and adds the k-th contribution of every pixel in the k-th of as many
``index_add_`` calls as the most-reached pixel has contributions: within
one call no two contributions share a pixel.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .core import spectrum
from .filters import Filter

FILTER_TABLE_WIDTH = 16  # film.h:91 filterTableWidth


@dataclasses.dataclass(frozen=True)
class FilmConfig:
    """Host-side film description (core/film.h Film)."""

    full_resolution: tuple  # (xres, yres)
    crop_window: tuple = (0.0, 1.0, 0.0, 1.0)  # (x0, x1, y0, y1)
    filter_name: str = "box"
    filter_radius: tuple = (0.5, 0.5)
    scale: float = 1.0
    max_sample_luminance: float = float("inf")

    @property
    def cropped_pixel_bounds(self):
        """(film.cpp:53-60): pixel bounds after the crop window."""
        xr, yr = self.full_resolution
        x0, x1, y0, y1 = self.crop_window
        return (int(math.ceil(xr * x0)), min(int(math.ceil(xr * x1)), xr),
                int(math.ceil(yr * y0)), min(int(math.ceil(yr * y1)), yr))


@dataclasses.dataclass(frozen=True)
class FilmState:
    weighted_sum: torch.Tensor  # [H, W, 3] sum of filter weight * L
    weight_sum: torch.Tensor  # [H, W] sum of filter weights
    filter_table: torch.Tensor  # [16, 16]
    inv_radius: tuple  # (1/rx, 1/ry)
    x0: int
    y0: int
    footprint: int
    max_sample_luminance: float


def build_filter_table(filt: Filter) -> np.ndarray:
    """16x16 LUT of filter values at cell centres (film.cpp:66-76)."""
    w = FILTER_TABLE_WIDTH
    rx, ry = filt.radius
    ys, xs = np.meshgrid((np.arange(w) + 0.5) * ry / w,
                         (np.arange(w) + 0.5) * rx / w, indexing="ij")
    return filt.evaluate(xs.ravel(), ys.ravel()).reshape(w, w).astype(np.float32)


def make_film_state(config: FilmConfig, filt: Filter, device) -> FilmState:
    px0, px1, py0, py1 = config.cropped_pixel_bounds
    rx, ry = filt.radius
    h, w = py1 - py0, px1 - px0
    return FilmState(
        weighted_sum=torch.zeros((h, w, 3), dtype=torch.float32, device=device),
        weight_sum=torch.zeros((h, w), dtype=torch.float32, device=device),
        filter_table=torch.as_tensor(build_filter_table(filt), device=device),
        inv_radius=(float(np.float32(1.0 / rx)), float(np.float32(1.0 / ry))),
        x0=px0, y0=py0,
        footprint=int(math.floor(2 * max(rx, ry))) + 1,
        max_sample_luminance=(config.max_sample_luminance
                              if math.isfinite(config.max_sample_luminance)
                              else 3.4e38),
    )


def add_samples(state: FilmState, p_film, L, sample_weight=None) -> FilmState:
    """FilmTile::AddSample (film.h:121-152) over a flat batch; the film's
    sums are updated in place and the state is returned."""
    n = p_film.shape[0]
    dev = p_film.device
    if sample_weight is None:
        sample_weight = torch.ones(n, dtype=torch.float32, device=dev)
    h, w = state.weight_sum.shape
    ftw = FILTER_TABLE_WIDTH
    lum = spectrum.luminance(L)
    L = torch.where(torch.isfinite(lum)[:, None], L, 0.0)
    ml = state.max_sample_luminance
    L = torch.where((lum > ml)[:, None],
                    L * (ml / torch.clamp(lum, min=1e-12))[:, None], L)

    pd = p_film - 0.5
    irx, iry = state.inv_radius
    rx = float(np.float32(1.0) / np.float32(irx))
    ry = float(np.float32(1.0) / np.float32(iry))
    radius = torch.tensor([rx, ry], dtype=torch.float32, device=dev)
    p0 = torch.ceil(pd - radius).to(torch.int64)
    fo = torch.arange(state.footprint, device=dev)
    px = p0[:, 0:1] + fo[None, :]  # [N, F]
    py = p0[:, 1:2] + fo[None, :]
    dx = px.to(torch.float32) - pd[:, 0:1]
    dy = py.to(torch.float32) - pd[:, 1:2]
    fx = torch.clamp(torch.abs(dx * irx * ftw).to(torch.int64), max=ftw - 1)
    fy = torch.clamp(torch.abs(dy * iry * ftw).to(torch.int64), max=ftw - 1)
    in_x = torch.abs(dx) <= rx
    in_y = torch.abs(dy) <= ry
    wxy = state.filter_table[fy[:, :, None], fx[:, None, :]]  # [N, Fy, Fx]
    ix = px[:, None, :] - state.x0
    iy = py[:, :, None] - state.y0
    valid = (in_x[:, None, :] & in_y[:, :, None] & (ix >= 0) & (ix < w)
             & (iy >= 0) & (iy < h))
    wgt = torch.where(valid, wxy * sample_weight[:, None, None], 0.0)
    # A zero weight adds zero to both sums, which changes no bit of a sum
    # that starts at +0, so those cells are left out.
    keep = wgt != 0.0
    pix = (iy * w + ix).expand_as(wgt)[keep].to(torch.int32)
    _ordered_add(state, pix, (wgt[..., None] * L[:, None, None, :])[keep],
                 wgt[keep])
    return state


def _ordered_add(state: FilmState, pix, contrib, wgt):
    """Add contrib [M, 3] and wgt [M] to pixels pix [M] of the film, each
    pixel's contributions one after another in their order in pix."""
    if pix.numel() == 0:
        return
    spix, by_pix = torch.sort(pix, stable=True)
    pos = torch.arange(spix.numel(), device=pix.device)
    first = torch.ones_like(spix, dtype=torch.bool)
    first[1:] = spix[1:] != spix[:-1]
    rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values
    by_rank = torch.sort(rank, stable=True).indices
    entry, target = by_pix[by_rank], spix[by_rank]
    weighted = state.weighted_sum.view(-1, 3)
    weights = state.weight_sum.view(-1)
    start = 0
    for count in torch.bincount(rank).tolist():
        e, t = entry[start: start + count], target[start: start + count]
        weighted.index_add_(0, t, contrib[e])
        weights.index_add_(0, t, wgt[e])
        start += count


def to_image(state: FilmState, scale: float = 1.0):
    """Film::WriteImage (film.cpp:169-254): normalise by the weight sums."""
    inv_w = torch.where(state.weight_sum > 0.0,
                        1.0 / torch.clamp(state.weight_sum, min=1e-30), 0.0)
    # + 0.0 turns the -0.0 a negative filter weight sum leaves into +0.0,
    # as the JAX package's maximum(x, 0) gives
    return (torch.clamp(state.weighted_sum * inv_w[..., None], min=0.0) + 0.0) * scale
