"""RGB spectra as the trailing ``[..., 3]`` axis (port of the parts of
pbrt_tpu/core/spectrum.py that the path integrator uses)."""
from __future__ import annotations

import torch


def luminance(rgb):
    """y(): the Y row of RGBToXYZ (spectrum.h:508)."""
    return 0.212671 * rgb[..., 0] + 0.715160 * rgb[..., 1] + 0.072169 * rgb[..., 2]


def max_component(rgb):
    return torch.amax(rgb, dim=-1)
