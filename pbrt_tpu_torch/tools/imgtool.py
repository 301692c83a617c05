"""imgtool: pbrt-v3's image utilities (tools/imgtool.cpp), on the host.

Port of pbrt_tpu/tools/imgtool.py over pbrt_tpu_torch/utils/imageio.py,
with its subcommands, printed lines and exit codes: info, cat, diff,
convert (scale, despike, bloom, tonemap, flipy), assemble and makesky (the
Hosek-Wilkie sky, tools/hosek.py).  Host numpy, as pbrt-v3 runs it.

    python -m pbrt_tpu_torch.tools.imgtool <cmd> [args...]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from ..utils import imageio as iio


def _read(path):
    return np.asarray(iio.read_image(path), np.float32)


def cmd_info(args):
    im = _read(args.file)
    print(f"{args.file}: {im.shape[1]}x{im.shape[0]}, {im.shape[2]} channels")
    print(f"  min {im.min():.6g} max {im.max():.6g} mean {im.mean():.6g}")
    lum = 0.212671 * im[..., 0] + 0.715160 * im[..., 1] + 0.072169 * im[..., 2]
    print(f"  luminance min {lum.min():.6g} max {lum.max():.6g} "
          f"mean {lum.mean():.6g}")
    return 0


def cmd_cat(args):
    im = _read(args.file)
    for y in range(im.shape[0]):
        for x in range(im.shape[1]):
            print(f"({x},{y}): {tuple(float(v) for v in im[y, x])}")
    return 0


def cmd_diff(args):
    """imgtool.cpp:333-420: a tolerance compare and the MSE."""
    a = _read(args.file)
    b = _read(args.ref)
    if a.shape != b.shape:
        print(f"size mismatch: {a.shape} vs {b.shape}")
        return 1
    d = a - b
    mse = float((d * d).mean())
    n_diff = int((np.abs(d) > args.tolerance).sum())
    avg = a.mean()
    ref_avg = b.mean()
    delta = (avg - ref_avg) / max(ref_avg, 1e-12) * 100.0
    print(f"{args.file}: {n_diff} pixel components differ > {args.tolerance}; "
          f"MSE {mse:.6g}; avg delta {delta:.3f}%")
    if args.outfile:
        iio.write_image(args.outfile, np.abs(d))
    return 1 if (args.metric == "mse" and mse > args.tolerance) or (
        args.metric == "count" and n_diff > 0
    ) else 0


def cmd_convert(args):
    """imgtool.cpp:585-760: scale, despike, bloom, tonemap, flip."""
    im = _read(args.file)
    im = im * args.scale
    if args.despike < float("inf"):
        lum = 0.212671 * im[..., 0] + 0.715160 * im[..., 1] + 0.072169 * im[..., 2]
        med = np.stack([
            np.roll(im, s, axis=(0, 1))
            for s in [(0, 1), (0, -1), (1, 0), (-1, 0)]
        ]).mean(0)
        im = np.where((lum > args.despike)[..., None], med, im)
    if args.bloom_level < float("inf"):
        lum = 0.212671 * im[..., 0] + 0.715160 * im[..., 1] + 0.072169 * im[..., 2]
        bright = np.where((lum > args.bloom_level)[..., None], im, 0.0)
        # Separable box blur x bloom_width.
        k = max(int(args.bloom_width), 1)
        for axis in (0, 1):
            acc = np.zeros_like(bright)
            for s in range(-k, k + 1):
                acc += np.roll(bright, s, axis=axis)
            bright = acc / (2 * k + 1)
        im = im + args.bloom_scale * bright
    if args.tonemap:
        # Reinhard-ish (imgtool.cpp tonemap path).
        lum = 0.212671 * im[..., 0] + 0.715160 * im[..., 1] + 0.072169 * im[..., 2]
        scale = (1.0 + lum / (args.max_luminance ** 2)) / (1.0 + lum)
        im = im * scale[..., None]
    if args.flipy:
        im = im[::-1]
    iio.write_image(args.outfile, im)
    print(f"wrote {args.outfile}")
    return 0


def cmd_assemble(args):
    """(imgtool.cpp:190-280): merge crop-window renders.  Crops rendered by
    this framework are full-size images that are black outside the crop; the
    merge takes, per pixel, the image with the largest weight (any nonzero
    wins, later files win ties)."""
    out = None
    filled = None
    for f in args.files:
        im = _read(f)
        nz = np.any(im != 0.0, -1)
        if out is None:
            out = im.copy()
            filled = nz
        else:
            if im.shape != out.shape:
                print(f"size mismatch in {f}")
                return 1
            take = nz & ~filled
            out[take] = im[take]
            filled |= nz
    iio.write_image(args.outfile, out)
    print(f"wrote {args.outfile} ({int(filled.sum())}/{filled.size} px filled)")
    return 0


def cmd_makesky(args):
    from .hosek import make_sky_image

    img = make_sky_image(
        res=args.resolution, turbidity=args.turbidity, albedo=args.albedo,
        elevation=np.deg2rad(args.elevation),
    )
    iio.write_image(args.outfile, img)
    print(f"wrote {args.outfile} ({img.shape[1]}x{img.shape[0]})")
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(prog="imgtool")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("info"); s.add_argument("file")
    s = sub.add_parser("cat"); s.add_argument("file")
    s = sub.add_parser("diff")
    s.add_argument("file"); s.add_argument("ref")
    s.add_argument("--tolerance", type=float, default=0.0)
    s.add_argument("--outfile", default=None)
    s.add_argument("--metric", choices=["count", "mse"], default="count")
    s = sub.add_parser("convert")
    s.add_argument("file"); s.add_argument("outfile")
    s.add_argument("--scale", type=float, default=1.0)
    s.add_argument("--tonemap", action="store_true")
    s.add_argument("--max-luminance", type=float, default=3.0)
    s.add_argument("--flipy", action="store_true")
    s.add_argument("--bloom-level", type=float, default=float("inf"))
    s.add_argument("--bloom-width", type=int, default=15)
    s.add_argument("--bloom-scale", type=float, default=0.3)
    s.add_argument("--despike", type=float, default=float("inf"))
    s = sub.add_parser("assemble")
    s.add_argument("--outfile", required=True)
    s.add_argument("files", nargs="+")
    s = sub.add_parser("makesky")
    s.add_argument("--outfile", default="sky.pfm")
    s.add_argument("--albedo", type=float, default=0.5)
    s.add_argument("--turbidity", type=float, default=3.0)
    s.add_argument("--elevation", type=float, default=10.0)
    s.add_argument("--resolution", type=int, default=512)

    args = p.parse_args(argv)
    return {
        "info": cmd_info, "cat": cmd_cat, "diff": cmd_diff,
        "convert": cmd_convert, "assemble": cmd_assemble,
        "makesky": cmd_makesky,
    }[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
