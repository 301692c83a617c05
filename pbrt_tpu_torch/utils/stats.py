"""Ray counters (port of the rays-traced part of pbrt_tpu/utils/stats.py).

A float64 counter vector on the render's device, bumped in place with no
host synchronisation; ``ray_total`` is the rays-traced count behind Mrays/s
(closest-hit plus shadow/MIS rays, pbrt's scene.cpp:40-43 counters).
"""
from __future__ import annotations

import torch

COUNTERS = [
    "Intersections/Regular ray intersection tests",
    "Intersections/Shadow ray intersection tests",
]
_IDX = {name: i for i, name in enumerate(COUNTERS)}


def zeros(device):
    return torch.zeros(len(COUNTERS), dtype=torch.float64, device=device)


def bump(counters, name: str, amount):
    """Add `amount` (a number, or a tensor that is summed) in place."""
    if isinstance(amount, torch.Tensor):
        amount = amount.to(torch.float64).sum()
    counters[_IDX[name]] += amount
    return counters


def ray_total(counters) -> float:
    return float(counters.sum())
