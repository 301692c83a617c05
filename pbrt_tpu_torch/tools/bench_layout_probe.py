"""Probe: a vec3 elementwise chain in three layouts, on the card.

Port of tools/bench_layout_probe.py.  It times the same chain of ~56
operations per round, six rounds (normalize, cross, dot and a masked update:
the shape of the hit-record and BSDF math), on N = 163840 lanes in three
forms:

  A. ``chain_rows``: [N, 3] arrays, the package's layout, plain PyTorch;
  B. ``chain_planar``: [3, N] planar arrays, plain PyTorch;
  C. ``chain_fused``: [3, N] planar, one Triton kernel for the whole chain,
     each element read once and written once.

A and B are C's plain versions.  The TPU tool fused B into one Pallas kernel
(``pallas_fused``, tools/bench_layout_probe.py:67); C takes its place.  What
bounds C on an H100 is bytes: each element reads 10 floats and writes 4
(56 B) for 336 float operations, about 6 per byte, far below the card's
~20 float32 operations per byte of device memory.  Its design therefore
keeps every intermediate in registers and touches device memory once per
input and output, with neighbouring threads on neighbouring addresses.  It
rounds as form B does: IEEE square root and division (``sqrt_rn``,
``div_rn``) and no multiply-add contraction (``enable_fp_fusion=False``).

    python -m pbrt_tpu_torch.tools.bench_layout_probe [--n N] [--reps R]

runs on the card: it computes each form once and prints A's and C's
largest difference from B, then each form's ms per call (CUDA events, one
warm-up call and R timed calls each).
"""
from __future__ import annotations

import argparse
import functools
import sys

import torch

N = 160 * 1024
ROUNDS = 6
BLOCK = 1024  # elements per Triton program
FLOPS_PER_ELEMENT = 56 * ROUNDS  # the operations of one round, counted below
BYTES_PER_ELEMENT = (3 + 3 + 3 + 1 + 3 + 1) * 4  # p, d, ns, t in; p, t out


def chain_rows(p, d, ns, t):
    """Form A on [N, 3] rows (axis -1)."""
    for _ in range(ROUNDS):
        w = p - d * t[:, None]
        l2 = (w * w).sum(-1, keepdim=True)
        w = w / torch.sqrt(torch.where(l2 > 0, l2, 1.0))
        c = torch.linalg.cross(w, ns, dim=-1)
        dt = (c * d).sum(-1)
        m = dt > 0.0
        p = torch.where(m[:, None], p + 0.1 * c, p - 0.05 * w)
        ns = torch.where(m[:, None], ns, -ns)
        t = torch.abs(dt) + 0.5 * t
    return p, t


def chain_planar(p, d, ns, t):
    """Form B on [3, N] planar arrays, sums and the cross product written
    out in the kernel's order.  Per round: w (6), |w|^2 (5), where + sqrt
    (3), divide (3), cross (9), dot (5), mask (1), p update (15), ns update
    (6), t (3): 56 operations."""
    for _ in range(ROUNDS):
        w = p - d * t[None, :]
        l2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2]
        w = w / torch.sqrt(torch.where(l2 > 0, l2, 1.0))[None, :]
        c = torch.stack([w[1] * ns[2] - w[2] * ns[1],
                         w[2] * ns[0] - w[0] * ns[2],
                         w[0] * ns[1] - w[1] * ns[0]])
        dt = c[0] * d[0] + c[1] * d[1] + c[2] * d[2]
        m = dt > 0.0
        p = torch.where(m[None, :], p + 0.1 * c, p - 0.05 * w)
        ns = torch.where(m[None, :], ns, -ns)
        t = torch.abs(dt) + 0.5 * t
    return p, t


@functools.cache
def _kernel():
    """The Triton kernel, compiled at first use (triton is imported here,
    never at module import)."""
    import triton
    import triton.language as tl

    @triton.jit
    def chain_kernel(p_ptr, d_ptr, ns_ptr, t_ptr, po_ptr, to_ptr, n,
                     ROUNDS: tl.constexpr, BLOCK: tl.constexpr):
        offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        live = offs < n
        px = tl.load(p_ptr + offs, mask=live, other=0.0)
        py = tl.load(p_ptr + n + offs, mask=live, other=0.0)
        pz = tl.load(p_ptr + 2 * n + offs, mask=live, other=0.0)
        dx = tl.load(d_ptr + offs, mask=live, other=0.0)
        dy = tl.load(d_ptr + n + offs, mask=live, other=0.0)
        dz = tl.load(d_ptr + 2 * n + offs, mask=live, other=0.0)
        nx = tl.load(ns_ptr + offs, mask=live, other=0.0)
        ny = tl.load(ns_ptr + n + offs, mask=live, other=0.0)
        nz = tl.load(ns_ptr + 2 * n + offs, mask=live, other=0.0)
        t = tl.load(t_ptr + offs, mask=live, other=0.0)
        for _ in tl.static_range(ROUNDS):
            wx = px - dx * t
            wy = py - dy * t
            wz = pz - dz * t
            l2 = wx * wx + wy * wy + wz * wz
            s = tl.sqrt_rn(tl.where(l2 > 0, l2, 1.0))
            wx = tl.div_rn(wx, s)
            wy = tl.div_rn(wy, s)
            wz = tl.div_rn(wz, s)
            cx = wy * nz - wz * ny
            cy = wz * nx - wx * nz
            cz = wx * ny - wy * nx
            dt = cx * dx + cy * dy + cz * dz
            m = dt > 0.0
            px = tl.where(m, px + 0.1 * cx, px - 0.05 * wx)
            py = tl.where(m, py + 0.1 * cy, py - 0.05 * wy)
            pz = tl.where(m, pz + 0.1 * cz, pz - 0.05 * wz)
            nx = tl.where(m, nx, -nx)
            ny = tl.where(m, ny, -ny)
            nz = tl.where(m, nz, -nz)
            t = tl.abs(dt) + 0.5 * t
        tl.store(po_ptr + offs, px, mask=live)
        tl.store(po_ptr + n + offs, py, mask=live)
        tl.store(po_ptr + 2 * n + offs, pz, mask=live)
        tl.store(to_ptr + offs, t, mask=live)

    return chain_kernel


def chain_fused(p, d, ns, t):
    """Form C: the chain as one Triton kernel launch on [3, N] planar
    float32 CUDA tensors (t [N]); returns (p [3, N], t [N]).  CPU tensors
    run chain_planar, its plain version."""
    n = t.shape[0]
    for name, x, shape in (("p", p, (3, n)), ("d", d, (3, n)),
                           ("ns", ns, (3, n)), ("t", t, (n,))):
        if x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(f"{name}: expected float32 {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if len({x.device for x in (p, d, ns, t)}) != 1:
        raise ValueError("inputs on several devices")
    if t.device.type == "cpu":
        return chain_planar(p, d, ns, t)
    if t.device.type != "cuda":
        raise NotImplementedError(f"chain_fused on {t.device.type} tensors")
    p_out = torch.empty_like(p)
    t_out = torch.empty_like(t)
    if n:
        with torch.cuda.device(t.device):
            _kernel()[(n + BLOCK - 1) // BLOCK,](
                p, d, ns, t, p_out, t_out, n, ROUNDS=ROUNDS, BLOCK=BLOCK,
                num_warps=4, enable_fp_fusion=False)
        chain_fused.launches += 1
    return p_out, t_out


chain_fused.launches = 0


def inputs(n: int, device, seed: int = 0):
    """p, d, ns [N, 3] and t [N], as the TPU tool draws them (numpy
    default_rng(seed): three standard normals, then a uniform)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    p = rng.standard_normal((n, 3))
    d = rng.standard_normal((n, 3))
    ns = rng.standard_normal((n, 3))
    t = rng.random(n)
    return tuple(torch.as_tensor(x, dtype=torch.float32, device=device)
                 for x in (p, d, ns, t))


def time_ms(fn, *args, reps: int = 50) -> float:
    """ms per call by CUDA events over `reps` calls after one warm-up."""
    fn(*args)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn(*args)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_layout_probe: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print("device:", torch.cuda.get_device_name(0))
    p, d, ns, t = inputs(args.n, dev)
    pT, dT, nsT = (x.t().contiguous() for x in (p, d, ns))
    pb, tb = chain_planar(pT, dT, nsT, t)
    pc, tc = chain_fused(pT, dT, nsT, t)
    pa, ta = chain_rows(p, d, ns, t)
    for name, (pp, tt) in (("A", (pa.t(), ta)), ("C", (pc, tc))):
        print(f"{name} against B: max |dp| {(pp - pb).abs().max().item():.3e}, "
              f"max |dt| {(tt - tb).abs().max().item():.3e}")
    a = time_ms(chain_rows, p, d, ns, t, reps=args.reps)
    b = time_ms(chain_planar, pT, dT, nsT, t, reps=args.reps)
    c = time_ms(chain_fused, pT, dT, nsT, t, reps=args.reps)
    for name, ms in (("A [N,3] rows", a), ("B [3,N] planar", b),
                     ("C [3,N] triton-fused", c)):
        print(f"{name:24s} {ms:8.4f} ms/call")
    print(f"speedups vs A: planar {a / b:.1f}x, fused {a / c:.1f}x")
    return 0


if __name__ == "__main__":
    sys.exit(main())
