"""How the render's work is split over processes.

Port of pbrt_tpu/parallel/mesh.py on torch.distributed.  The JAX package
shards its flat (pixel, sample) work over a device mesh and merges the film
partials with one psum; here each process of the default process group
(one card, or the CPU, a process) takes a contiguous range of work ids and
the film partials are summed with one all_reduce at the end.  Work ids are
global, id = s * n_pix + pixel row, so the image does not depend on the
number of processes up to the film's add order.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def rank_and_world() -> tuple:
    """(this process's rank, the number of processes) of the default group;
    (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def work_range(rank: int, world: int, total: int) -> tuple:
    """Rank's work ids [base, lim): [rank total // world, (rank + 1) total
    // world), as wavefront.py:457-458 splits them over its shards."""
    return rank * total // world, (rank + 1) * total // world


def all_reduce_sum(tensors: list):
    """Sum each tensor over the processes of the default group, in place;
    one all_reduce for each dtype (a group of one process reduces too).
    A no-op without a group.  The tensors stay where they are: a gloo
    group takes CPU or CUDA tensors, an nccl group CUDA tensors only."""
    if not (dist.is_available() and dist.is_initialized()):
        return
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        start = 0
        for t in group:
            t.copy_(flat[start: start + t.numel()].view_as(t))
            start += t.numel()

