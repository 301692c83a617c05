"""The multi-process render on torch.distributed.

Port of pbrt_tpu/parallel/multihost.py.  Every process runs the same
program: ``initialize`` joins it to the default process group from its
arguments or the environment (PBRT_TPU_COORDINATOR host:port,
PBRT_TPU_NUM_PROCESSES, PBRT_TPU_PROCESS_ID; a no-op without them), and
``render`` runs the wavefront over the group (wavefront.render_sharded):
each rank renders its own range of work ids with its own lane pool, and
the film partials are summed once at the end.

The backend follows the device: nccl for the card, gloo for the CPU.  NCCL
refuses two ranks on one card, so processes sharing a card name gloo in
the call (gloo reduces CUDA tensors too).  With nccl, rank r renders on card
r modulo the cards this host has.

As a program, it renders a scene file with the wavefront over the group and
writes the image from rank 0:

    PBRT_TPU_COORDINATOR=localhost:29511 PBRT_TPU_NUM_PROCESSES=2 \\
    PBRT_TPU_PROCESS_ID=0 python -m pbrt_tpu_torch.parallel.multihost \\
        scene.pbrt -o out.pfm --device cpu     # and PROCESS_ID=1 beside it
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import torch
import torch.distributed as dist

from . import mesh


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               backend=None, device="cuda") -> bool:
    """Join the default process group (multihost.py:27-52): the coordinator
    host:port, the number of processes and this one's id from the
    arguments or PBRT_TPU_COORDINATOR, PBRT_TPU_NUM_PROCESSES and
    PBRT_TPU_PROCESS_ID.  Returns False, doing nothing, without a
    coordinator.  backend: "nccl" or "gloo"; by default nccl when device
    is the card, gloo for the CPU."""
    coordinator_address = (coordinator_address
                           or os.environ.get("PBRT_TPU_COORDINATOR"))
    if num_processes is None and "PBRT_TPU_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["PBRT_TPU_NUM_PROCESSES"])
    if process_id is None and "PBRT_TPU_PROCESS_ID" in os.environ:
        process_id = int(os.environ["PBRT_TPU_PROCESS_ID"])
    if coordinator_address is None:
        return False
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator needs the number of processes and "
                         "this process's id")
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if not coordinator_address.startswith("tcp://"):
        coordinator_address = "tcp://" + coordinator_address
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=num_processes, rank=process_id)
    return True


def shutdown():
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def local_device(device="cuda") -> torch.device:
    """This rank's device: under nccl, card rank modulo the host's cards;
    otherwise `device` itself."""
    device = torch.device(device)
    if (device.type == "cuda" and device.index is None and dist.is_initialized()
            and dist.get_backend() == "nccl"):
        return torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    return device


def render(scene, camera, film_cfg, sampler_cfg, cfg, filt=None,
           n_lanes_per_shard: int = 1 << 12, iters_per_step: int = 4,
           count_rays: bool = False, device="cuda"):
    """The wavefront over the default group with the JAX package's
    per-shard defaults (multihost.py:67-84); the scene must be on
    local_device(device)."""
    from ..integrators import wavefront as wf

    return wf.render_sharded(scene, camera, film_cfg, sampler_cfg, cfg, filt,
                             n_lanes_per_shard=n_lanes_per_shard,
                             iters_per_step=iters_per_step,
                             count_rays=count_rays, device=local_device(device))


def render_file(path: str, device="cuda", spp=None, res=None, **kw):
    """Parse a scene file with Integrator "path" and render it with
    ``render``.  Returns (image, rays traced) on every rank."""
    import dataclasses

    from ..sceneio import parse_pbrt_file

    setup = parse_pbrt_file(path)
    if setup.integrator_name != "path":
        raise NotImplementedError(
            f"integrator {setup.integrator_name!r}: the sharded render is the "
            "path integrator's wavefront")
    device = local_device(device)
    scene = setup.build_scene(device)
    film_cfg, filt = setup.make_film_config()
    sampler_cfg = setup.make_sampler_config()
    if res is not None:
        film_cfg = dataclasses.replace(film_cfg, full_resolution=tuple(res))
        sampler_cfg = dataclasses.replace(sampler_cfg, resolution=tuple(res))
    if spp is not None:
        sampler_cfg = dataclasses.replace(sampler_cfg, spp=spp)
    return render(scene, setup.make_camera(), film_cfg, sampler_cfg,
                  setup.make_integrator_config(), filt, count_rays=True,
                  device=device, **kw)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="pbrt_tpu_torch.parallel.multihost")
    ap.add_argument("scene")
    ap.add_argument("--outfile", "-o", default=None,
                    help="image written by rank 0 (.pfm, .exr, .png, .npy)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="nccl for the card, gloo for the CPU by default")
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--res", type=int, nargs=2, default=None)
    ap.add_argument("--lanes", type=int, default=1 << 12,
                    help="the lane pool of each process")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA card is available; pass --device cpu", file=sys.stderr)
        return 2
    initialize(backend=args.backend, device=args.device)
    try:
        t0 = time.perf_counter()
        img, rays = render_file(args.scene, args.device, args.spp, args.res,
                                n_lanes_per_shard=args.lanes)
        img = img.cpu().numpy()
        wall = time.perf_counter() - t0
        rank, world = mesh.rank_and_world()
        if rank == 0:
            if args.outfile:
                from ..utils.imageio import write_image

                write_image(args.outfile, img)
            backend = dist.get_backend() if dist.is_initialized() else "none"
            print(f"{args.scene}: {world} process(es) over {backend}, "
                  f"{rays:.0f} rays, {wall:.3f} s (set-up and render)")
    finally:
        shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
