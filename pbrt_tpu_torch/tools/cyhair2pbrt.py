"""cyhair2pbrt: Cem Yuksel's binary .hair format to pbrt curves.

Port of pbrt_tpu/tools/cyhair2pbrt.py (pbrt-v3 tools/cyhair2pbrt.cpp; the
format: cemyuksel.com/research/hairmodels); the .pbrt file it writes is the
JAX package's byte for byte.  Each strand's polyline becomes cubic Bezier
"cylinder" curves with Catmull-Rom tangents.

    python -m pbrt_tpu_torch.tools.cyhair2pbrt model.hair out.pbrt
"""
from __future__ import annotations

import argparse
import struct
import sys

import numpy as np


def read_cyhair(path):
    with open(path, "rb") as f:
        magic = f.read(4)
        if magic != b"HAIR":
            raise ValueError("not a cyhair file")
        (n_strands, n_points, flags, d_segments, d_thickness, d_transp,
         ) = struct.unpack("<IIIIff", f.read(24))
        d_color = struct.unpack("<fff", f.read(12))
        f.read(88)  # file info string
        has_segments = flags & 1
        has_points = flags & 2
        has_thickness = flags & 4
        has_transp = flags & 8
        has_color = flags & 16
        if not has_points:
            raise ValueError("cyhair file without points")
        segments = (
            np.frombuffer(f.read(2 * n_strands), "<u2").astype(np.int64)
            if has_segments else np.full(n_strands, d_segments, np.int64)
        )
        points = np.frombuffer(f.read(12 * n_points), "<f4").reshape(-1, 3)
        thickness = (
            np.frombuffer(f.read(4 * n_points), "<f4")
            if has_thickness else np.full(n_points, d_thickness, np.float32)
        )
        if has_transp:
            f.read(4 * n_points)
        color = (
            np.frombuffer(f.read(12 * n_points), "<f4").reshape(-1, 3)
            if has_color else None
        )
    return segments, points, thickness, color, d_color


def convert(hair_path, out_path, scale=1.0, max_strands=0):
    segments, points, thickness, color, d_color = read_cyhair(hair_path)
    with open(out_path, "w") as f:
        f.write(f"# converted from {hair_path} by cyhair2pbrt\n")
        f.write(f"# {len(segments)} strands, {len(points)} points\n")
        off = 0
        n_out = 0
        for si, nseg in enumerate(segments):
            pts = points[off : off + nseg + 1] * scale
            th = thickness[off : off + nseg + 1] * scale
            off += nseg + 1
            if max_strands and si >= max_strands:
                continue
            if nseg < 1:
                continue
            # Interpolating polyline -> cubic Bezier segments (Catmull-Rom
            # style tangents, like the reference converter).
            for k in range(nseg):
                p0, p1 = pts[k], pts[k + 1]
                t0 = (pts[min(k + 1, nseg)] - pts[max(k - 1, 0)]) / 2.0
                t1 = (pts[min(k + 2, nseg)] - pts[k]) / 2.0
                b0 = p0
                b1 = p0 + t0 / 3.0
                b2 = p1 - t1 / 3.0
                b3 = p1
                cp = " ".join(
                    f"{x:.6g} {y:.6g} {z:.6g}" for x, y, z in (b0, b1, b2, b3)
                )
                f.write(
                    f'Shape "curve" "string type" "cylinder" '
                    f'"point P" [{cp}] '
                    f'"float width0" [{th[k]:.6g}] '
                    f'"float width1" [{th[k + 1]:.6g}]\n'
                )
                n_out += 1
    print(f"wrote {out_path}: {n_out} curve segments")


def main(argv=None):
    p = argparse.ArgumentParser(prog="cyhair2pbrt")
    p.add_argument("hair")
    p.add_argument("out")
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--max-strands", type=int, default=0)
    a = p.parse_args(argv)
    convert(a.hair, a.out, a.scale, a.max_strands)
    return 0


if __name__ == "__main__":
    sys.exit(main())
