"""Reconstruction filters, evaluated host-side to build the film's LUT.

Port of pbrt_tpu/filters/filters.py: pbrt's box, triangle, gaussian,
mitchell and Lanczos-windowed sinc filters (src/filters/) as closed-form
numpy functions over the filter radius (filter.h:62).  The film
discretises them into its 16x16 LUT as pbrt does (film.cpp:66-76); the
device never evaluates a filter.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Filter:
    name: str
    radius: tuple  # (rx, ry)
    evaluate: object  # (x[N], y[N]) -> w[N]


def box_filter(xwidth=0.5, ywidth=0.5) -> Filter:
    """(filters/box.h BoxFilter): weight 1 everywhere inside the radius."""
    return Filter("box", (xwidth, ywidth), lambda x, y: np.ones_like(x))


def triangle_filter(xwidth=2.0, ywidth=2.0) -> Filter:
    def ev(x, y):
        return np.maximum(0.0, xwidth - np.abs(x)) * np.maximum(
            0.0, ywidth - np.abs(y)
        )

    return Filter("triangle", (xwidth, ywidth), ev)


def gaussian_filter(xwidth=2.0, ywidth=2.0, alpha=2.0) -> Filter:
    """(filters/gaussian.h) exp(-a x^2) - exp(-a r^2), clamped at 0."""
    expx = np.exp(-alpha * xwidth * xwidth)
    expy = np.exp(-alpha * ywidth * ywidth)

    def g(d, expv):
        return np.maximum(0.0, np.exp(-alpha * d * d) - expv)

    return Filter(
        "gaussian", (xwidth, ywidth), lambda x, y: g(x, expx) * g(y, expy)
    )


def mitchell_filter(xwidth=2.0, ywidth=2.0, B=1.0 / 3.0, C=1.0 / 3.0) -> Filter:
    """(filters/mitchell.h Mitchell1D)."""

    def m1(x):
        x = np.abs(2.0 * x)
        gt = (
            (-B - 6 * C) * x**3
            + (6 * B + 30 * C) * x**2
            + (-12 * B - 48 * C) * x
            + (8 * B + 24 * C)
        ) / 6.0
        le = (
            (12 - 9 * B - 6 * C) * x**3
            + (-18 + 12 * B + 6 * C) * x**2
            + (6 - 2 * B)
        ) / 6.0
        return np.where(x > 1, np.where(x > 2, 0.0, gt), le)

    return Filter(
        "mitchell",
        (xwidth, ywidth),
        lambda x, y: m1(x / xwidth) * m1(y / ywidth),
    )


def sinc_filter(xwidth=4.0, ywidth=4.0, tau=3.0) -> Filter:
    """(filters/sinc.h LanczosSincFilter) windowed sinc."""

    def sinc(x):
        x = np.abs(x)
        return np.where(x < 1e-5, 1.0, np.sin(np.pi * x) / (np.pi * x))

    def windowed(x, radius):
        x = np.abs(x)
        lanczos = sinc(x / tau)
        return np.where(x > radius, 0.0, sinc(x) * lanczos)

    return Filter(
        "sinc",
        (xwidth, ywidth),
        lambda x, y: windowed(x, xwidth) * windowed(y, ywidth),
    )


def make_filter(name: str, params: dict | None = None) -> Filter:
    """MakeFilter dispatch (api.cpp:777-795), with pbrt's defaults."""
    params = dict(params or {})

    def f(key, default):
        return float(params.get(key, default))

    if name == "box":
        return box_filter(f("xwidth", 0.5), f("ywidth", 0.5))
    if name == "triangle":
        return triangle_filter(f("xwidth", 2.0), f("ywidth", 2.0))
    if name == "gaussian":
        return gaussian_filter(f("xwidth", 2.0), f("ywidth", 2.0), f("alpha", 2.0))
    if name == "mitchell":
        return mitchell_filter(
            f("xwidth", 2.0), f("ywidth", 2.0), f("B", 1.0 / 3.0), f("C", 1.0 / 3.0)
        )
    if name in ("sinc", "lanczossinc"):
        return sinc_filter(f("xwidth", 4.0), f("ywidth", 4.0), f("tau", 3.0))
    raise ValueError(f"unknown filter {name!r}")
