"""Terminal progress bar with ETA: pbrt's ProgressReporter
(core/progressreporter.h:50-118), port of pbrt_tpu/utils/progress.py.  The
render loop updates it once per spp batch.  It draws only on a terminal,
or when PBRT_TPU_PROGRESS=1.
"""
from __future__ import annotations

import os
import sys
import time


class ProgressReporter:
    def __init__(self, total: float, title: str = "Rendering",
                 out=None, quiet: bool | None = None):
        self.total = max(float(total), 1.0)
        self.title = title
        self.out = out if out is not None else sys.stderr
        if quiet is None:
            quiet = (not (hasattr(self.out, "isatty") and self.out.isatty())
                     and os.environ.get("PBRT_TPU_PROGRESS") != "1")
        self.quiet = quiet
        self.t0 = time.time()
        self.done = 0.0
        self._last_len = 0

    def update(self, done: float):
        """Set absolute completed work (monotone; clamped to total)."""
        self.done = min(float(done), self.total)
        if self.quiet:
            return
        frac = self.done / self.total
        elapsed = time.time() - self.t0
        eta = elapsed * (1.0 - frac) / max(frac, 1e-9) if frac > 0 else 0.0
        width = 40
        fill = int(frac * width)
        bar = "+" * fill + " " * (width - fill)
        msg = (f"\r{self.title}: [{bar}] {100 * frac:5.1f}% "
               f"({elapsed:.1f}s|ETA {eta:.1f}s)")
        pad = max(self._last_len - len(msg), 0)
        self.out.write(msg + " " * pad)
        self.out.flush()
        self._last_len = len(msg)

    def finish(self):
        self.update(self.total)
        if not self.quiet:
            self.out.write("\n")
            self.out.flush()
