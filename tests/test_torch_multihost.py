"""The sharded wavefront on torch.distributed (parallel/multihost.py), on
the CPU: two processes over gloo, each rendering half the work ids with
its own pool, against this process alone rendering all of them
(wavefront.render_sharded without a group).  Work ids are the same, so
the images agree up to the film's add order: dmax <= 1e-5, the JAX
package's bar (tests/test_multihost.py).  The workers import no JAX."""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from pbrt_tpu_torch.parallel import mesh, multihost
import test_torch_threads  # noqa: F401  (torch's threads under xdist)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARITY = os.path.join(ROOT, "refgold", "parity", "c1_matte_point_d5.pbrt")
ARGS = ["--res", "24", "20", "--spp", "2"]
LANES = 256


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_gloo_render_matches_one_process(tmp_path):
    """c1_matte_point_d5 with the uniform light strategy (the spatial
    distribution's build would take most of the test's time)."""
    scene = str(tmp_path / "c1.pbrt")
    with open(PARITY) as f, open(scene, "w") as g:
        g.write(f.read().replace('"integer maxdepth" [5]', '"integer maxdepth" [5] '
                                 '"string lightsamplestrategy" "uniform"'))
    port = _free_port()
    out = str(tmp_path / "two.npy")
    env = dict(os.environ, PBRT_TPU_COORDINATOR=f"localhost:{port}",
               PBRT_TPU_NUM_PROCESSES="2", OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "pbrt_tpu_torch.parallel.multihost", scene,
         "--device", "cpu", "--backend", "gloo", "--lanes", str(LANES), *ARGS,
         *(["-o", out] if rank == 0 else [])],
        env=dict(env, PBRT_TPU_PROCESS_ID=str(rank)), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE) for rank in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-2000:]
    assert b"2 process(es) over gloo" in outs[0][0]
    two = np.load(out)

    assert not multihost.initialize()  # no coordinator here: one process
    assert mesh.rank_and_world() == (0, 1)
    one, rays = multihost.render_file(scene, "cpu", spp=2, res=(24, 20),
                                      n_lanes_per_shard=LANES)
    one = one.numpy()
    assert two.shape == one.shape == (20, 24, 3)
    assert np.isfinite(one).all() and one.mean() > 0 and rays > 0
    dmax = float(np.abs(two - one).max())
    assert dmax <= 1e-5, dmax


def test_work_ranges_and_refusals():
    """Each rank's work range, the reduction without a group, and the sharded render's refusal of subsurface materials (the
    JAX package's render_sharded renders them without the probe walk)."""
    import dataclasses

    from pbrt_tpu_torch import film as tfm
    from pbrt_tpu_torch import scene as tsc
    from pbrt_tpu_torch.cameras import make_perspective_camera
    from pbrt_tpu_torch.core import transform as ttf
    from pbrt_tpu_torch.integrators import wavefront as twf
    from pbrt_tpu_torch.samplers.samplers import SamplerConfig


    for world in (1, 2, 3, 7):
        ranges = [mesh.work_range(r, world, 1000) for r in range(world)]
        assert ranges[0][0] == 0 and ranges[-1][1] == 1000
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    mesh.all_reduce_sum([torch.ones(3)])  # without a group: nothing to do
    b = tsc.SceneBuilder()
    b.add_sphere(ttf.identity(), 1.0, material=b.add_material(tsc.MAT_MATTE))
    b.add_point_light(ttf.translate(0, 0, -3), (1, 1, 1))
    scene = b.build(device="cpu")
    scene = dataclasses.replace(scene, mat_types=scene.mat_types + (tsc.MAT_SUBSURFACE,))
    cam = make_perspective_camera(ttf.look_at([0, 0, -3], [0, 0, 0], [0, 1, 0]), (4, 4))
    with pytest.raises(NotImplementedError, match="subsurface"):
        twf.render_sharded(scene, cam, tfm.FilmConfig(full_resolution=(4, 4)),
                           SamplerConfig("halton", 1, (4, 4)), device="cpu")
