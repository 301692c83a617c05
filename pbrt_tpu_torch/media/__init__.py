"""Participating media (port of pbrt_tpu/media/)."""
from .media import (MEDIUM_GRID, MEDIUM_HOMOGENEOUS, MEDIUM_NONE,
                    HostMediumTable, MediumTable)

__all__ = ["MEDIUM_GRID", "MEDIUM_HOMOGENEOUS", "MEDIUM_NONE",
           "HostMediumTable", "MediumTable"]
