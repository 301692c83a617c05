"""Reconstruction filters, evaluated host-side to build the film's LUT.

Port of the box filter of pbrt_tpu/filters/filters.py (filters/box.h).  The
other pbrt filters overlap neighbouring pixels, which the film's scatter
does not yet keep bit-stable on the card; they raise NotImplementedError.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Filter:
    name: str
    radius: tuple  # (rx, ry)
    evaluate: object  # (x [N], y [N]) -> w [N]


def box_filter(xwidth=0.5, ywidth=0.5) -> Filter:
    """BoxFilter: weight 1 everywhere inside the radius."""
    return Filter("box", (xwidth, ywidth), lambda x, y: np.ones_like(x))


def make_filter(name: str, params: dict | None = None) -> Filter:
    """MakeFilter dispatch (api.cpp:777-795) for the filters ported so far."""
    params = dict(params or {})
    if name == "box":
        return box_filter(float(params.get("xwidth", 0.5)),
                          float(params.get("ywidth", 0.5)))
    raise NotImplementedError(f"filter {name!r}: the port has 'box' only")
