"""Reconstruction filters (port of pbrt_tpu/filters/)."""
from .filters import Filter, box_filter, make_filter

__all__ = ["Filter", "box_filter", "make_filter"]
