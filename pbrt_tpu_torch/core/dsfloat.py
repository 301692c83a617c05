"""Double-single (two-float) arithmetic, port of pbrt_tpu/core/dsfloat.py.

pbrt retreats to double precision for the quadric discriminant (efloat.h
Quadratic) and the watertight triangle test's exact-zero edge fallback
(triangle.cpp:243-250).  These helpers reproduce the JAX package's Dekker /
Knuth float32 pairs step for step, so both packages make the same decisions.
"""
from __future__ import annotations

import torch

_SPLIT = 4097.0  # Veltkamp constant for float32 (2^12 + 1)


def two_sum(a, b):
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def fast_two_sum(a, b):
    s = a + b
    err = b - (s - a)
    return s, err


def _split(a):
    c = _SPLIT * a
    hi = c - (c - a)
    lo = a - hi
    return hi, lo


def two_prod(a, b):
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def dd_add(xh, xl, yh, yl):
    sh, sl = two_sum(xh, yh)
    sl = sl + (xl + yl)
    return fast_two_sum(sh, sl)


def dd_sub(xh, xl, yh, yl):
    return dd_add(xh, xl, -yh, -yl)


def dd_discriminant(a, b, c):
    """b*b - 4*a*c in double-single; returns (hi, lo)."""
    b2h, b2l = two_prod(b, b)
    ach, acl = two_prod(a, c)
    return dd_sub(b2h, b2l, 4.0 * ach, 4.0 * acl)


def dd_sqrt_to_f32(dh, dl):
    """float32 rounding of sqrt(hi + lo) for a non-negative pair."""
    pos = dh > 0.0
    s = torch.sqrt(torch.where(pos, dh, 1.0))
    refine = dh > 1e-30
    s2h, s2l = two_prod(s, s)
    rh, _ = dd_sub(dh, dl, s2h, s2l)
    s = s + torch.where(refine, rh, 0.0) / (2.0 * torch.where(refine, s, 1.0))
    return torch.where(pos, s, 0.0)


def dd_cross2_f32(ax, ay, bx, by):
    """float32 rounding of the exact 2D cross ax*by - ay*bx."""
    p1h, p1l = two_prod(ax, by)
    p2h, p2l = two_prod(ay, bx)
    h, l = dd_sub(p1h, p1l, p2h, p2l)
    return h + l
