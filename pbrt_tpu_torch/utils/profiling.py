"""Host wall-clock phase timer (port of the ``Timer`` of
pbrt_tpu/utils/profiling.py).

pbrt-v3 samples its phases with SIGPROF (core/stats.h:142-190); here the
coarse phases (parse, scene build, light distribution, render) are separate
host steps, each timed on the host clock and printed as pbrt's "Profile"
block.  The device-side view of the render is torch.profiler's, over the
"layer: ..." ranges of integrators/path.py.
"""
from __future__ import annotations

import contextlib
import time


class Timer:
    """Accumulating host timer of named phases."""

    def __init__(self):
        self.acc: dict[str, float] = {}
        self.t0 = time.perf_counter()

    @contextlib.contextmanager
    def __call__(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.acc[name] = self.acc.get(name, 0.0) + (time.perf_counter() - t)

    def report(self) -> str:
        """pbrt's 'Profile' block format (stats.cpp:207-237): time and %."""
        total = max(time.perf_counter() - self.t0, 1e-9)
        lines = ["Profile (host wall clock):"]
        for name, s in sorted(self.acc.items(), key=lambda kv: -kv[1]):
            lines.append(f"    {name:<42}{s:8.2f}s ({100.0 * s / total:5.1f}%)")
        other = total - sum(self.acc.values())
        lines.append(f"    {'(other)':<42}{other:8.2f}s ({100.0 * other / total:5.1f}%)")
        return "\n".join(lines)
