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
The 24 IEEE divisions and square roots of a lane are each a sequence of
instructions with a long dependent latency, so at N = 163840 the launch
needs many warps in flight more than wide accesses: one element a thread
(BLOCK, WARPS below) measured fastest on an H100.

    python -m pbrt_tpu_torch.tools.bench_layout_probe [--n N] [--reps R]

runs on the card: it computes each form once and prints A's and C's
largest difference from B, then each form's ms per call twice: eager
(``time_ms``: CUDA events around R calls after a warm-up, the host's launch
path included) and on the device alone (``device_ms``: CUDA events around
one replay of a CUDA graph of R calls that cycle through copies of the
inputs larger than the L2).  Last it prints C's device time at each launch
geometry of ``GEOMETRIES`` (each held bit-equal to the shipped one), the
table BLOCK and WARPS were chosen from, beside a device-to-device copy of
the same 56 bytes a lane: what memory and the launch alone cost.
"""
from __future__ import annotations

import argparse
import functools
import sys

import torch

N = 160 * 1024
ROUNDS = 6
# The launch geometry, the fastest of GEOMETRIES on an H100 (PERF.md): one
# element a thread, so 40 warps an SM at N hide the chain's IEEE division
# and square root latency better than 16-byte accesses with a quarter of
# the warps.
BLOCK = 128  # elements per Triton program
WARPS = 4  # warps per Triton program
L2_BYTES = 50 * 2**20  # an H100's L2; device_ms rotates inputs past it
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
        if t.device.index == torch.cuda.current_device():
            _launch(p, d, ns, t, p_out, t_out)
        else:
            with torch.cuda.device(t.device):
                _launch(p, d, ns, t, p_out, t_out)
    return p_out, t_out


chain_fused.launches = 0  # chain kernels run on the card, graph replays included
chain_fused.captured = 0  # chain kernels recorded into a CUDA graph


def _launch(p, d, ns, t, p_out, t_out, block=BLOCK, warps=WARPS):
    n = t.shape[0]
    _kernel()[(n + block - 1) // block,](
        p, d, ns, t, p_out, t_out, n, ROUNDS=ROUNDS, BLOCK=block,
        num_warps=warps, enable_fp_fusion=False)
    if torch.cuda.is_current_stream_capturing():
        chain_fused.captured += 1  # runs at each replay, counted by device_ms
    else:
        chain_fused.launches += 1


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
    """ms per eager call by CUDA events over `reps` calls after one warm-up:
    the host's launch path and the kernel together."""
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


def cold_copies(*args) -> list:
    """Enough copies of the argument tuple to exceed the L2, so that a call
    that cycles through them reads its inputs from device memory."""
    size = sum(x.nbytes for x in args)
    return [args] + [tuple(x.clone() for x in args)
                     for _ in range(L2_BYTES // max(size, 1))]


def device_ms(fn, arg_sets, reps: int = 50) -> float:
    """ms per call on the device alone: CUDA events around one replay of a
    CUDA graph that captured `reps` calls of fn, cycling through arg_sets
    (from cold_copies), after a warm-up call and a warm-up replay.  The
    graph launches its kernels back to back, so the host's launch path is
    not in the time.  The chain kernels a replay runs are added to
    chain_fused.launches at each replay."""
    fn(*arg_sets[0])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    captured = chain_fused.captured
    with torch.cuda.graph(graph):
        for k in range(reps):
            fn(*arg_sets[k % len(arg_sets)])
    per_replay = chain_fused.captured - captured
    graph.replay()
    chain_fused.launches += per_replay
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    graph.replay()
    chain_fused.launches += per_replay
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


# (BLOCK, num_warps) that main times C at: 1, 2, 4 and 8 elements a thread
GEOMETRIES = ((32, 1), (128, 4), (256, 8), (256, 4), (512, 4), (1024, 4))


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
    rows = cold_copies(p, d, ns, t)
    planar = cold_copies(pT, dT, nsT, t)
    for name, fn, sets in (("A [N,3] rows", chain_rows, rows),
                           ("B [3,N] planar", chain_planar, planar),
                           ("C [3,N] triton-fused", chain_fused, planar)):
        ms = time_ms(fn, *sets[0], reps=args.reps)
        dev_ms = device_ms(fn, sets, args.reps)
        print(f"{name:24s} {ms:8.4f} ms/call eager, {dev_ms:8.4f} ms/call on "
              "the device")
    for block, warps in GEOMETRIES:
        def run(p, d, ns, tt, block=block, warps=warps):
            po, to = torch.empty_like(p), torch.empty_like(tt)
            _launch(p, d, ns, tt, po, to, block, warps)
            return po, to

        if not all(map(torch.equal, run(pT, dT, nsT, t), (pc, tc))):
            raise RuntimeError(f"BLOCK {block}, num_warps {warps}: C differs")
        print(f"C at BLOCK {block:4d}, num_warps {warps} ({block // (32 * warps)} "
              f"a thread): {device_ms(run, planar, args.reps):8.5f} ms/call on the "
              "device")
    src = torch.zeros(args.n * BYTES_PER_ELEMENT // 8, device=dev)
    copy = device_ms(torch.Tensor.copy_, cold_copies(torch.empty_like(src), src),
                     args.reps)
    print(f"a device copy of the same {BYTES_PER_ELEMENT} B a lane: {copy:8.5f} "
          "ms/call on the device")
    return 0


if __name__ == "__main__":
    sys.exit(main())
