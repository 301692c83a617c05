"""Statistics counters and pbrt's end-of-render report.

Port of pbrt_tpu/utils/stats.py (pbrt-v3 core/stats.{h,cpp}): the same
counter registry, as a float64 vector on the render's device bumped in place
with no host synchronisation; ``ray_total`` is the rays-traced count behind
Mrays/s (closest-hit plus shadow/MIS rays, pbrt's scene.cpp:40-43 counters),
and ``report`` prints the counters grouped by category as PrintStats does
(stats.cpp:79-187).
"""
from __future__ import annotations

import collections

import torch

COUNTERS = [
    "Integrator/Camera rays traced",
    "Intersections/Regular ray intersection tests",
    "Intersections/Shadow ray intersection tests",
    "Intersections/BSSRDF probe rays",
    "Integrator/Path vertices",
    "Integrator/Russian-roulette terminations",
    "Lights/Light samples taken",
    "Film/Samples added",
]
_IDX = {name: i for i, name in enumerate(COUNTERS)}
_RAY_IDS = [_IDX["Intersections/Regular ray intersection tests"],
            _IDX["Intersections/Shadow ray intersection tests"],
            _IDX["Intersections/BSSRDF probe rays"]]


def zeros(device):
    return torch.zeros(len(COUNTERS), dtype=torch.float64, device=device)


def bump(counters, name: str, amount):
    """Add `amount` (a number, or a tensor that is summed) in place."""
    if isinstance(amount, torch.Tensor):
        amount = amount.to(torch.float64).sum()
    counters[_IDX[name]] += amount
    return counters


def ray_total(counters) -> float:
    return float(counters[_RAY_IDS].sum())


def report(counters) -> str:
    """pbrt's PrintStats-style category report (stats.cpp:79-187)."""
    vals = counters.tolist() if isinstance(counters, torch.Tensor) else list(counters)
    by_cat = collections.defaultdict(list)
    for name, v in zip(COUNTERS, vals):
        cat, title = name.split("/", 1)
        by_cat[cat].append((title, v))
    lines = ["Statistics:"]
    for cat in sorted(by_cat):
        lines.append(f"  {cat}")
        for title, v in by_cat[cat]:
            lines.append(f"    {title:<42}{int(v):>16,d}")
    return "\n".join(lines)
