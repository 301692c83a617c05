"""bsdftest: a numeric check of the BSDFs' sampling (pbrt-v3 tools/bsdftest.cpp).

Port of pbrt_tpu/tools/bsdftest.py.  For each of nine materials it
estimates the hemispherical-directional reflectance twice, (a) from
``eval_material`` at uniformly drawn directions and (b) from
``sample_material``'s importance samples, prints both and flags the rows
where they disagree; the status is 1 if any row does.  The materials run
through the port's SceneBuilder and materials/bsdf.py (gather_material,
eval_material, sample_material) on the card, or on the CPU when asked.
The draws are numpy's RandomState(0) in the JAX package's order, so both
tools see the same directions.

    python -m pbrt_tpu_torch.tools.bsdftest [--n 200000] [--device cuda|cpu]

Without a card and without --device cpu it exits with status 2.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def rows(n: int, device) -> list:
    """[(name, rho from uniform directions, rho from sampling, agree)] for
    the nine materials, with n directions each, on `device`."""
    import torch

    from .. import scene as sc
    from ..materials import bsdf as bx

    b = sc.SceneBuilder()
    mats = {
        "matte": b.add_material(sc.MAT_MATTE, kd=(0.6, 0.6, 0.6)),
        "oren-nayar": b.add_material(sc.MAT_MATTE, kd=(0.6, 0.6, 0.6), sigma=20.0),
        "plastic": b.add_material(sc.MAT_PLASTIC, kd=(0.4, 0.4, 0.4),
                                  ks=(0.3, 0.3, 0.3), roughness=0.1),
        "metal": b.add_material(sc.MAT_METAL, roughness=0.05),
        "substrate": b.add_material(sc.MAT_SUBSTRATE, kd=(0.4, 0.4, 0.4),
                                    ks=(0.2, 0.2, 0.2), roughness=0.1),
        "translucent": b.add_material(sc.MAT_TRANSLUCENT, kd=(0.4, 0.4, 0.4),
                                      ks=(0.1, 0.1, 0.1), kr=(0.5, 0.5, 0.5),
                                      kt=(0.5, 0.5, 0.5)),
        "rough-glass": b.add_material(sc.MAT_GLASS, urough=0.2, vrough=0.2,
                                      roughness=0.2, remap_roughness=False),
        "disney": b.add_material(sc.MAT_DISNEY, kd=(0.6, 0.3, 0.2), roughness=0.4,
                                 disney=(0.3, 0, 0, 0.5, 0.5, 0.5, 1.0, 0, 0, 1.0,
                                         0, 0),
                                 remap_roughness=False),
        "hair": b.add_material(sc.MAT_HAIR),
    }
    b.add_triangle_mesh([[0, 1, 2]], [[0, 0, 0], [1, 0, 0], [0, 1, 0]], material=0)
    table = b.build(device=device).materials
    dev = table.mat_type.device

    rs = np.random.RandomState(0)
    wo = np.array([0.3, -0.2, 0.85], np.float32)
    wo /= np.linalg.norm(wo)
    wo_b = torch.as_tensor(wo, device=dev).expand(n, 3)
    u_sph = rs.rand(n, 2)
    z = 1 - 2 * u_sph[:, 0]
    r = np.sqrt(np.maximum(0, 1 - z * z))
    ph = 2 * np.pi * u_sph[:, 1]
    wi_u = torch.as_tensor(np.stack([r * np.cos(ph), r * np.sin(ph), z], -1)
                           .astype(np.float32), device=dev)
    u_s = torch.as_tensor(rs.rand(n, 2).astype(np.float32), device=dev)
    uv = torch.full((n, 2), 0.3, device=dev)
    mat_types = table.mat_type.cpu().tolist()

    out = []
    with torch.no_grad():
        for name, mid in mats.items():
            types = (mat_types[mid],)
            ids = torch.full((n,), mid, dtype=torch.int32, device=dev)
            mat = bx.gather_material(table, ids, None, types, uv=uv)
            f_u, _ = bx.eval_material(mat, wo_b, wi_u, types)
            rho_u = float(torch.mean(f_u[:, 0] * torch.abs(wi_u[:, 2])) * 4 * np.pi)
            s = bx.sample_material(mat, wo_b, u_s, types)
            w = torch.where((s["pdf"] > 1e-9) & ~s["is_specular"],
                            s["f"][:, 0] * torch.abs(s["wi"][:, 2])
                            / torch.clamp(s["pdf"], min=1e-9), 0.0)
            rho_s = float(torch.mean(w))
            ok = abs(rho_s - rho_u) < max(0.05, 0.15 * max(rho_u, rho_s))
            out.append((name, rho_u, rho_s, ok))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(prog="bsdftest")
    p.add_argument("--n", type=int, default=200_000)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where to evaluate: the card (default) or the CPU")
    args = p.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("bsdftest: no CUDA card is available; pass --device cpu to run "
              "on the CPU", file=sys.stderr)
        return 2
    print(f"{'material':14s} {'rho(uniform)':>14s} {'rho(sampled)':>14s}  status")
    status = 0
    for name, rho_u, rho_s, ok in rows(args.n, args.device):
        status = status if ok else 1
        print(f"{name:14s} {rho_u:14.4f} {rho_s:14.4f}  {'ok' if ok else 'MISMATCH'}")
    return status


if __name__ == "__main__":
    sys.exit(main())
