"""Reconstruction filters (port of pbrt_tpu/filters/)."""
from .filters import (Filter, box_filter, gaussian_filter, make_filter,
                      mitchell_filter, sinc_filter, triangle_filter)

__all__ = ["Filter", "box_filter", "gaussian_filter", "make_filter",
           "mitchell_filter", "sinc_filter", "triangle_filter"]
