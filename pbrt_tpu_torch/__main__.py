"""CLI: ``python -m pbrt_tpu_torch scene.pbrt [options]``.

Port of pbrt_tpu/__main__.py (pbrt-v3 main/pbrt.cpp:76-173): scene file(s),
--outfile, --quick (1/4 the spp), --spp, --res, --cropwindow, --quiet,
--nthreads (accepted, ignored), plus --device {cuda,cpu}: the card by
default, the CPU (the kernels' plain versions) only when asked.  Without a
card the CLI exits with status 2 unless --device cpu is given.  --cat and
--toply (the scene reformatter) are not ported and raise.
"""
from __future__ import annotations

import argparse
import logging
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="pbrt_tpu_torch")
    ap.add_argument("scenes", nargs="+", help=".pbrt scene files")
    ap.add_argument("--outfile", "-o", default=None)
    ap.add_argument("--quick", action="store_true", help="1/4 the spp")
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--res", type=int, nargs=2, default=None)
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--cropwindow", type=float, nargs=4, default=None,
                    metavar=("X0", "X1", "Y0", "Y1"))
    ap.add_argument("--cat", action="store_true",
                    help="reformat the scene to stdout and exit (not ported)")
    ap.add_argument("--toply", action="store_true",
                    help="like --cat, dumping meshes to .ply (not ported)")
    ap.add_argument("--nthreads", type=int, default=0,
                    help="accepted for pbrt compatibility (ignored)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where to render: the card (default) or the CPU")
    args = ap.parse_args(argv)

    if args.cat or args.toply:
        raise NotImplementedError("--cat/--toply: the scene reformatter is "
                                  "not ported")
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("pbrt_tpu_torch: no CUDA card is available; pass --device cpu "
              "to render on the CPU", file=sys.stderr)
        return 2

    logging.basicConfig(level=logging.WARNING if args.quiet else logging.INFO,
                        format="%(levelname)s %(message)s")
    from .render import render_file
    from .sceneio import parse_pbrt_file

    for scene_path in args.scenes:
        spp = args.spp
        if args.quick and spp is None:
            spp = max(1, parse_pbrt_file(scene_path).make_sampler_config().spp // 4)
        img, stats = render_file(
            scene_path, out=args.outfile, spp=spp, res=args.res,
            crop=tuple(args.cropwindow) if args.cropwindow else None,
            device=args.device)
        mrays = stats["rays_traced"] / stats["wall_s"] / 1e6
        print(f"{scene_path}: {stats['resolution'][0]}x{stats['resolution'][1]}"
              f" @ {stats['spp']}spp in {stats['wall_s']:.1f}s"
              f" ({mrays:.2f} Mrays/s)")
        # pbrt prints its Statistics and Profile blocks after every render
        # unless --quiet (stats.cpp:79-187, pbrt.cpp:161).
        if not args.quiet:
            print(stats["report"])
            print(stats["profile"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
