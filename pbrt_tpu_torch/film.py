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

``add_splats`` (Film::AddSplat, film.cpp:142; the light subpaths' t = 1
strategies of bdpt and mlt) adds unfiltered values to a splat image the
same way, each pixel's values in their order in the call; ``to_image``
adds the splats times splat_scale.  ``add_splats.ranks`` counts the
``index_add_`` rounds its calls took (the most values one pixel got in a
call, summed over calls): splats pile onto bright pixels.
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
    splat: torch.Tensor  # [H, W, 3] unweighted splats (film.cpp:142)


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
        splat=torch.zeros((h, w, 3), dtype=torch.float32, device=device),
    )


def add_samples(state: FilmState, p_film, L, sample_weight=None,
                mask=None) -> FilmState:
    """FilmTile::AddSample (film.h:121-152) over a flat batch; the film's
    sums are updated in place and the state is returned.  mask [N]: the
    lanes that add a sample (all by default)."""
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
    if mask is not None:
        valid = valid & mask[:, None, None]
    wgt = torch.where(valid, wxy * sample_weight[:, None, None], 0.0)
    # A zero weight adds zero to both sums, which changes no bit of a sum
    # that starts at +0, so those cells are left out.
    keep = wgt != 0.0
    pix = (iy * w + ix).expand_as(wgt)[keep].to(torch.int32)
    _ordered_add(state, pix, (wgt[..., None] * L[:, None, None, :])[keep],
                 wgt[keep])
    return state


def ordered_index_add(index, pairs) -> int:
    """For each (dst, src) of pairs, add src [M, ...] to the rows index [M]
    of dst, each row's values one after another in their order in index:
    a stable sort by row, each value's rank within its row, and one
    index_add_ per rank (no two values of a call share a row).  Returns
    the number of ranks."""
    if index.numel() == 0:
        return 0
    srow, by_row = torch.sort(index, stable=True)
    pos = torch.arange(srow.numel(), device=index.device)
    first = torch.ones_like(srow, dtype=torch.bool)
    first[1:] = srow[1:] != srow[:-1]
    rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values
    by_rank = torch.sort(rank, stable=True).indices
    entry, target = by_row[by_rank], srow[by_rank]
    counts = torch.bincount(rank).tolist()
    start = 0
    for count in counts:
        e, t = entry[start: start + count], target[start: start + count]
        for dst, src in pairs:
            dst.index_add_(0, t, src[e])
        start += count
    return len(counts)


def _ordered_add(state: FilmState, pix, contrib, wgt):
    """Add contrib [M, 3] and wgt [M] to pixels pix [M] of the film, each
    pixel's contributions one after another in their order in pix."""
    ordered_index_add(pix, [(state.weighted_sum.view(-1, 3), contrib),
                            (state.weight_sum.view(-1), wgt)])


def add_splats(state: FilmState, p_film, v, mask=None) -> FilmState:
    """Film::AddSplat (film.cpp:142): v [n, 3] added unfiltered to the pixel
    holding p_film [n, 2], in place; lanes off the film, outside mask or
    with a non-finite luminance add nothing (pbrt_tpu/film.py:215-227).
    Lanes whose v is zero are left out too: adding zero changes no bit of a
    splat sum, which starts at +0 and never holds -0."""
    h, w = state.weight_sum.shape
    ix = torch.floor(p_film[:, 0]) - state.x0
    iy = torch.floor(p_film[:, 1]) - state.y0
    keep = ((ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
            & torch.isfinite(spectrum.luminance(v)) & torch.any(v != 0.0, -1))
    if mask is not None:
        keep = keep & mask
    pix = (iy * w + ix)[keep].to(torch.int64)
    add_splats.ranks += ordered_index_add(pix, [(state.splat.view(-1, 3), v[keep])])
    return state


add_splats.ranks = 0


def to_image(state: FilmState, scale: float = 1.0, splat_scale: float = 0.0):
    """Film::WriteImage (film.cpp:169-254): normalise by the weight sums,
    then add the splats times splat_scale (bdpt: 1 / spp)."""
    inv_w = torch.where(state.weight_sum > 0.0,
                        1.0 / torch.clamp(state.weight_sum, min=1e-30), 0.0)
    # + 0.0 turns the -0.0 a negative filter weight sum leaves into +0.0,
    # as the JAX package's maximum(x, 0) gives
    rgb = torch.clamp(state.weighted_sum * inv_w[..., None], min=0.0) + 0.0
    if splat_scale:
        rgb = rgb + splat_scale * state.splat
    return rgb * scale
