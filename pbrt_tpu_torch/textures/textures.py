"""The texture table and its batched evaluation.

Port of pbrt_tpu/textures/textures.py (src/textures/, core/texture.cpp,
core/mipmap.h).  pbrt's Texture DAG is a table of rows evaluated once per
bounce in id order (children have smaller ids), then gathered per lane by
texture id.  Image maps live in one flat atlas with per-row, per-level
(offset, w, h); the host builds each image's pyramid with pbrt's Lanczos
resampling to a power of two and box-filtered halvings.  A lookup is
level-0 bilinear without ray differentials, trilinear (MIPMap::Lookup with a
width), or anisotropic: the JAX package's EWA, eight trilinear taps along
the ellipse's major axis with Gaussian weights.

Types: constant, scale, mix, checkerboard (2D), uv, fbm, wrinkled, windy,
marble, dots, imagemap, bilerp.  The host builder and the pyramid are numpy,
copied from the JAX package; ``TextureTable.from_numpy`` takes either
package's table.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import noise as pn

TEX_CONSTANT = 0
TEX_SCALE = 1
TEX_MIX = 2
TEX_CHECKER = 3
TEX_UV = 4
TEX_FBM = 5
TEX_WRINKLED = 6
TEX_WINDY = 7
TEX_MARBLE = 8
TEX_DOTS = 9
TEX_IMAGEMAP = 10
TEX_BILERP = 11

MAX_MIP_LEVELS = 16

# Image-map wrap modes (mipmap.h:50 ImageWrap), in fparams[2].
WRAP_REPEAT = 0
WRAP_BLACK = 1
WRAP_CLAMP = 2

TEXTURE_FIELDS = ("tex_type", "c1", "c2", "child1", "child2", "map2d", "w2t",
                  "fparams", "atlas", "img_offset", "img_w", "img_h",
                  "mip_meta", "n_levels")


# ---- host: the pyramid and the table builder ----

def _lanczos(x, tau=2.0):
    """Lanczos windowed sinc (texture.cpp:28), MIPMap's resampling filter."""
    x = np.abs(x)
    s = np.where(x < 1e-5, 1.0, np.sin(np.pi * x) / np.maximum(np.pi * x, 1e-20))
    w = np.where(x < 1e-5, 1.0,
                 np.sin(np.pi * x / tau) / np.maximum(np.pi * x / tau, 1e-20))
    return np.where(x > tau, 0.0, s * w)


def _resample_axis(img, new_n, axis):
    """Power-of-two upsampling along one axis (MIPMap::resampleWeights,
    mipmap.cpp:88-108): 4 normalised Lanczos taps, clamped at the edge."""
    old_n = img.shape[axis]
    if old_n == new_n:
        return img
    centers = (np.arange(new_n) + 0.5) * old_n / new_n
    first = np.floor(centers - 2.0 + 0.5).astype(np.int64)
    idx = first[:, None] + np.arange(4)[None, :]
    w = _lanczos((idx + 0.5 - centers[:, None]) / 2.0)
    w /= np.sum(w, axis=1, keepdims=True)
    idx = np.clip(idx, 0, old_n - 1)
    moved = np.moveaxis(img, axis, 0)
    out = np.einsum("nk,nk...->n...", w.astype(np.float32), moved[idx])
    return np.moveaxis(out, 0, axis)


def _next_pow2(n):
    return 1 << max(0, int(np.ceil(np.log2(max(n, 1)))))


def build_pyramid(img: np.ndarray) -> list:
    """MIPMap ctor (mipmap.cpp:88-169): resample to a power-of-two size,
    then average 2x2 blocks down to 1x1."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    w2, h2 = _next_pow2(w), _next_pow2(h)
    if (w2, h2) != (w, h):
        img = _resample_axis(img, w2, 1)
        img = _resample_axis(img, h2, 0)
        h, w = h2, w2
    levels = [img]
    while w > 1 or h > 1:
        nw, nh = max(w // 2, 1), max(h // 2, 1)
        prev = levels[-1]
        px = prev if w == 1 else prev.reshape(h, nw, 2, 3).mean(axis=2)
        if h > 1:
            px = px.reshape(nh, 2, nw, 3).mean(axis=1)
        levels.append(px.astype(np.float32))
        w, h = nw, nh
    return levels


def _rgb(c):
    return (np.asarray(c, np.float32).reshape(3) if np.ndim(c)
            else np.full(3, c, np.float32))


class HostTextureTable:
    """Host-side accumulator of texture rows; ``to_numpy`` freezes it."""

    def __init__(self):
        self.rows: list = []
        self.atlas = [np.zeros((1, 3), np.float32)]
        self.atlas_size = 1

    def add(self, tex_type, c1=(0, 0, 0), c2=(0, 0, 0), child1=-1, child2=-1,
            map2d=(1.0, 1.0, 0.0, 0.0), w2t=None, fparams=(0, 0, 0, 0),
            image=None) -> int:
        row = dict(
            tex_type=tex_type, c1=_rgb(c1), c2=_rgb(c2), child1=child1,
            child2=child2, map2d=np.asarray(map2d, np.float32),
            w2t=(np.eye(4, dtype=np.float32) if w2t is None
                 else np.asarray(w2t, np.float32)),
            fparams=np.asarray(fparams, np.float32),
            img_offset=0, img_w=0, img_h=0,
            mip_meta=np.zeros((MAX_MIP_LEVELS, 3), np.int64), n_levels=0)
        if image is not None:
            img = np.asarray(image, np.float32)
            if img.ndim == 2:
                img = np.repeat(img[..., None], 3, -1)
            levels = build_pyramid(img)[:MAX_MIP_LEVELS]
            row["n_levels"] = len(levels)
            for li, lvl in enumerate(levels):
                h, w = lvl.shape[:2]
                row["mip_meta"][li] = (self.atlas_size, w, h)
                if li == 0:
                    row["img_offset"], row["img_w"], row["img_h"] = (
                        self.atlas_size, w, h)
                self.atlas.append(lvl.reshape(-1, 3))
                self.atlas_size += h * w
        self.rows.append(row)
        return len(self.rows) - 1

    def to_numpy(self) -> dict:
        """The table as numpy arrays named as TextureTable's fields (one
        constant-zero row when empty, as the JAX package freezes it)."""
        rows = self.rows or [dict(
            tex_type=TEX_CONSTANT, c1=np.zeros(3, np.float32),
            c2=np.zeros(3, np.float32), child1=-1, child2=-1,
            map2d=np.array([1, 1, 0, 0], np.float32),
            w2t=np.eye(4, dtype=np.float32), fparams=np.zeros(4, np.float32),
            img_offset=0, img_w=0, img_h=0,
            mip_meta=np.zeros((MAX_MIP_LEVELS, 3), np.int64), n_levels=0)]

        def col(k, dtype=None):
            c = np.stack([np.asarray(r[k]) for r in rows])
            return c.astype(dtype) if dtype is not None else c

        out = {k: col(k) for k in ("c1", "c2", "map2d", "w2t", "fparams")}
        for k in ("tex_type", "child1", "child2", "img_offset", "img_w",
                  "img_h", "mip_meta", "n_levels"):
            out[k] = col(k, np.int32)
        out["atlas"] = np.concatenate(self.atlas)
        return out


# ---- device: the frozen table and its evaluation ----

@dataclasses.dataclass(frozen=True)
class TextureTable:
    tex_type: torch.Tensor  # [T] i32
    c1: torch.Tensor  # [T, 3] first constant (or tex1 fallback)
    c2: torch.Tensor  # [T, 3]
    child1: torch.Tensor  # [T] sub-texture id or -1
    child2: torch.Tensor  # [T]
    map2d: torch.Tensor  # [T, 4] UVMapping2D su, sv, du, dv
    w2t: torch.Tensor  # [T, 4, 4] world to texture space
    fparams: torch.Tensor  # [T, 4]
    atlas: torch.Tensor  # [A, 3]
    img_offset: torch.Tensor  # [T]
    img_w: torch.Tensor  # [T]
    img_h: torch.Tensor  # [T]
    mip_meta: torch.Tensor  # [T, MAX_MIP_LEVELS, 3] (offset, w, h) per level
    n_levels: torch.Tensor  # [T]

    @staticmethod
    def from_numpy(fields: dict, device) -> "TextureTable":
        return TextureTable(**{
            k: torch.as_tensor(np.asarray(fields[k]), device=device)
            for k in TEXTURE_FIELDS})


def texture_meta(fields: dict) -> tuple:
    """Per-row (type, child1, child2, fparams, n_levels) as host values: the
    static control flow of evaluate_textures (pbrt_tpu/statics.py)."""
    return tuple(zip(
        np.asarray(fields["tex_type"]).tolist(),
        np.asarray(fields["child1"]).tolist(),
        np.asarray(fields["child2"]).tolist(),
        [tuple(f) for f in np.asarray(fields["fparams"], np.float32).tolist()],
        np.asarray(fields["n_levels"]).tolist()))


def _bilinear_at(table: TextureTable, off, w, h, uv, wrap: int):
    """Bilinear lookup at per-lane (offset, w, h), one mip level
    (MIPMap::triangle, mipmap.cpp:171-183); image rows run top-down, so v
    flips."""
    off = off.to(torch.int64)
    w = w.to(torch.int64)
    h = h.to(torch.int64)
    wf = torch.clamp(w, min=1).to(torch.float32)
    hf = torch.clamp(h, min=1).to(torch.float32)
    x = uv[..., 0] * wf - 0.5
    y = (1.0 - uv[..., 1]) * hf - 0.5
    xf = torch.floor(x)
    yf = torch.floor(y)
    fx = (x - xf)[..., None]
    fy = (y - yf)[..., None]
    x0 = xf.to(torch.int64)
    y0 = yf.to(torch.int64)
    w_hi = torch.clamp(w - 1, min=0)
    h_hi = torch.clamp(h - 1, min=0)

    def fetch(xi, yi):
        if wrap == WRAP_CLAMP:
            xi = torch.minimum(torch.clamp(xi, min=0), w_hi)
            yi = torch.minimum(torch.clamp(yi, min=0), h_hi)
            inside = None
        elif wrap == WRAP_BLACK:
            inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            xi = torch.minimum(torch.clamp(xi, min=0), w_hi)
            yi = torch.minimum(torch.clamp(yi, min=0), h_hi)
        else:  # repeat
            xi = torch.remainder(xi, torch.clamp(w, min=1))
            yi = torch.remainder(yi, torch.clamp(h, min=1))
            inside = None
        v = table.atlas[off + yi * w + xi]
        return v if inside is None else torch.where(inside[..., None], v, 0.0)

    v00 = fetch(x0, y0)
    v10 = fetch(x0 + 1, y0)
    v01 = fetch(x0, y0 + 1)
    v11 = fetch(x0 + 1, y0 + 1)
    return ((1 - fx) * ((1 - fy) * v00 + fy * v01)
            + fx * ((1 - fy) * v10 + fy * v11))


def _bilinear_level(table, t: int, uv, level, wrap: int):
    meta = table.mip_meta[t][level]  # [N, 3]
    return _bilinear_at(table, meta[..., 0], meta[..., 1], meta[..., 2], uv,
                        wrap)


def _trilinear_lookup(table, t: int, uv, width, n_levels: int, wrap: int):
    """MIPMap::Lookup(st, width) (mipmap.cpp:187-199): level = nLevels - 1 +
    log2(width), lerp between the two levels around it."""
    level = (n_levels - 1) + torch.log2(torch.clamp(width, min=1e-8))
    level = torch.clamp(level, 0.0, n_levels - 1)
    lf = torch.floor(level)
    l0 = lf.to(torch.int64)
    dl = (level - lf)[..., None]
    v0 = _bilinear_level(table, t, uv, l0, wrap)
    v1 = _bilinear_level(table, t, uv, torch.clamp(l0 + 1, max=n_levels - 1),
                         wrap)
    return (1.0 - dl) * v0 + dl * v1


_ANISO_TAPS = 8


def _aniso_lookup(table, t: int, uv, dst0, dst1, n_levels: int, wrap: int,
                  max_aniso: float):
    """The JAX package's EWA (MIPMap::Lookup(st, dst0, dst1), mipmap.cpp:
    203-260): the eccentricity clamped to maxAnisotropy, the level where the
    minor axis spans about a texel, and eight trilinear taps along the major
    axis with Gaussian (alpha = 2) weights."""
    len0 = torch.sqrt((dst0 * dst0).sum(-1))
    len1 = torch.sqrt((dst1 * dst1).sum(-1))
    swap = len1 > len0
    major = torch.where(swap[..., None], dst1, dst0)
    major_len = torch.where(swap, len1, len0)
    minor_len = torch.where(swap, len0, len1)
    scale_minor = major_len / torch.clamp(minor_len * max_aniso, min=1e-20)
    minor_len = torch.where((minor_len * max_aniso < major_len) & (minor_len > 0.0),
                            minor_len * scale_minor, minor_len)
    taps = ((torch.arange(_ANISO_TAPS, dtype=torch.float32) + 0.5)
            / _ANISO_TAPS * 2.0 - 1.0)
    wts = torch.exp(-2.0 * taps * taps) - torch.exp(torch.tensor(-2.0))
    wts = (wts / wts.sum()).tolist()
    taps = taps.tolist()
    width = torch.clamp(minor_len, min=1e-8)
    out = 0.0
    for tap, wt in zip(taps, wts):
        out = out + wt * _trilinear_lookup(table, t, uv + major * tap, width,
                                           n_levels, wrap)
    return out


_MARBLE_COLORS = ((0.58, 0.58, 0.6), (0.58, 0.58, 0.6), (0.58, 0.58, 0.6),
                  (0.5, 0.5, 0.5), (0.6, 0.59, 0.58), (0.58, 0.58, 0.6),
                  (0.58, 0.58, 0.6), (0.2, 0.2, 0.33), (0.58, 0.58, 0.6))


def _needed(active_ids, tex_meta) -> set:
    """The rows active_ids reach, children included."""
    needed = set(range(len(tex_meta))) if active_ids is None else set(active_ids)
    frontier = list(needed)
    while frontier:
        t = frontier.pop()
        for c in tex_meta[t][1:3]:
            if c >= 0 and c not in needed:
                needed.add(int(c))
                frontier.append(int(c))
    return needed


def evaluate_textures(table: TextureTable, uv, p_world, tex_meta,
                      active_ids=None, duvdx=None, duvdy=None):
    """Every texture row for the batch: [T, N, 3].

    tex_meta: the per-row host control flow (texture_meta); active_ids:
    the rows materials refer to (their children are added), or None for
    all; duvdx / duvdy [N, 2]: screen-space uv differentials from camera
    ray differentials, which pick the mip level; without them a lookup is
    level-0 bilinear, as pbrt's rays without differentials look up at
    width 0."""
    n = uv.shape[0]
    dev = uv.device
    needed = _needed(active_ids, tex_meta)
    zeros = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    vals = []
    for t, (tt, ch1, ch2, fp, nl) in enumerate(tex_meta):
        if t not in needed:
            vals.append(zeros)
            continue
        m = table.map2d[t]
        st = torch.stack([uv[..., 0] * m[0] + m[2], uv[..., 1] * m[1] + m[3]], -1)
        w2t = table.w2t[t]
        p_tex = p_world @ w2t[:3, :3].T + w2t[:3, 3]

        def operand(cid, const):
            return vals[cid] if cid >= 0 else const.expand(n, 3)

        a = operand(ch1, table.c1[t])
        b = operand(ch2, table.c2[t])
        if tt == TEX_CONSTANT:
            v = table.c1[t].expand(n, 3)
        elif tt == TEX_SCALE:
            v = a * b
        elif tt == TEX_MIX:
            amt = float(fp[0])
            v = (1.0 - amt) * a + amt * b
        elif tt == TEX_CHECKER:
            par = torch.remainder(torch.floor(st[..., 0]).to(torch.int64)
                                  + torch.floor(st[..., 1]).to(torch.int64), 2)
            v = torch.where((par == 0)[..., None], a, b)
        elif tt == TEX_UV:
            v = torch.stack([st[..., 0] % 1.0, st[..., 1] % 1.0,
                             torch.zeros(n, device=dev)], -1)
        elif tt in (TEX_FBM, TEX_WRINKLED):
            octaves = int(fp[0]) or 6
            omega = float(fp[1]) or 0.5
            fn = pn.fbm if tt == TEX_FBM else pn.turbulence
            v = fn(p_tex, omega=omega, max_octaves=octaves)[..., None].expand(n, 3)
        elif tt == TEX_WINDY:
            strength = pn.fbm(0.1 * p_tex, max_octaves=3)
            height = pn.fbm(p_tex, max_octaves=6)
            v = (torch.abs(strength) * height)[..., None].expand(n, 3)
        elif tt == TEX_MARBLE:
            scale = float(fp[2]) or 1.0
            variation = float(fp[3]) or 0.2
            octaves = int(fp[0]) or 8
            omega = float(fp[1]) or 0.5
            marble = p_tex[..., 1] * scale + variation * pn.fbm(
                scale * p_tex, omega=omega, max_octaves=octaves)
            tv = 0.5 + 0.5 * torch.sin(marble)
            c = torch.tensor(_MARBLE_COLORS, dtype=torch.float32, device=dev)
            nc = c.shape[0] - 3
            first = torch.clamp((tv * nc).to(torch.int64), 0, nc - 1)
            tl = (tv * nc - first.to(torch.float32))[..., None]
            c0, c1, c2, c3 = c[first], c[first + 1], c[first + 2], c[first + 3]
            # pbrt's repeated-lerp spline (marble.h:79-87)
            s0 = (1 - tl) * c0 + tl * c1
            s1 = (1 - tl) * c1 + tl * c2
            s2 = (1 - tl) * c2 + tl * c3
            s0 = (1 - tl) * s0 + tl * s1
            s1 = (1 - tl) * s1 + tl * s2
            v = 1.5 * ((1 - tl) * s0 + tl * s1)
        elif tt == TEX_DOTS:
            s_cell = torch.floor(st[..., 0] + 0.5)
            t_cell = torch.floor(st[..., 1] + 0.5)
            cell = torch.stack([s_cell, t_cell, torch.zeros(n, device=dev)], -1)
            has_dot = pn.noise(cell + 0.5) > 0.0
            rad = 0.35
            maxshift = 0.5 - rad
            off1 = torch.tensor([1.5, 2.8, 0.0], device=dev)
            off2 = torch.tensor([4.5, 9.8, 0.0], device=dev)
            cx = s_cell + maxshift * pn.noise(cell + off1)
            cy = t_cell + maxshift * pn.noise(cell + off2)
            ds = st[..., 0] - cx
            dt = st[..., 1] - cy
            inside = has_dot & (ds * ds + dt * dt < rad * rad)
            v = torch.where(inside[..., None], a, b)
        elif tt == TEX_IMAGEMAP:
            # fparams: (trilinear, maxanisotropy, wrap, _) (imagemap.h:51-104)
            wrap = int(fp[2])
            if duvdx is None or duvdy is None or nl <= 1:
                v = _bilinear_at(table, table.img_offset[t], table.img_w[t],
                                 table.img_h[t], st, wrap)
            else:
                # UVMapping2D::Map scales differentials by (su, sv)
                dstdx = duvdx * m[:2]
                dstdy = duvdy * m[:2]
                if int(fp[0]):
                    width = 2.0 * torch.maximum(
                        torch.abs(dstdx).amax(-1), torch.abs(dstdy).amax(-1))
                    v = _trilinear_lookup(table, t, st, width, nl, wrap)
                else:
                    v = _aniso_lookup(table, t, st, dstdx, dstdy, nl, wrap,
                                      float(fp[1]) or 8.0)
            v = v * table.c1[t]
        elif tt == TEX_BILERP:
            fx = (st[..., 0] % 1.0)[..., None]
            fy = (st[..., 1] % 1.0)[..., None]
            v = (((1 - fx) * (1 - fy) + fx * fy) * table.c1[t]
                 + ((1 - fx) * fy + fx * (1 - fy)) * table.c2[t])
        else:
            raise NotImplementedError(f"texture type {tt}")
        vals.append(v)
    return torch.stack(vals)


def gather_texture(values, tex_id, constant):
    """Per lane: the bound texture's value where tex_id >= 0, else the
    constant."""
    tid = torch.clamp(tex_id.to(torch.int64), 0, values.shape[0] - 1)
    lane = torch.arange(tex_id.shape[0], device=tex_id.device)
    return torch.where((tex_id >= 0)[..., None], values[tid, lane], constant)
