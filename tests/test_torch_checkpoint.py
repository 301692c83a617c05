"""Render checkpoints (utils/checkpoint.py) on the CPU, the port alone: a
render stopped after some sample batches (lockstep) or supersteps
(wavefront) and started again from its checkpoint gives the image and
counters of the render that ran straight through, bit for bit; a
checkpoint of another configuration is refused."""
import pytest
import torch

from pbrt_tpu_torch import film as tfm
from pbrt_tpu_torch import scene as tsc
from pbrt_tpu_torch.cameras import make_perspective_camera
from pbrt_tpu_torch.core import transform as ttf
from pbrt_tpu_torch.filters import make_filter
from pbrt_tpu_torch.integrators import path as tpath
from pbrt_tpu_torch.integrators import wavefront as twf
from pbrt_tpu_torch.samplers.samplers import SamplerConfig
from pbrt_tpu_torch.utils import checkpoint as ckpt
from pbrt_tpu_torch.utils import stats as st
import test_torch_threads  # noqa: F401  (torch's threads under xdist)

RES = (16, 12)
SPP = 4


class Stopped(Exception):
    pass


class StopAt:
    """A progress reporter that stops the render at its n-th update."""

    def __init__(self, n):
        self.n, self.calls = n, 0

    def update(self, done):
        self.calls += 1
        if self.calls == self.n:
            raise Stopped


def _setup():
    b = tsc.SceneBuilder()
    m = b.add_material(tsc.MAT_MATTE, kd=(0.5, 0.4, 0.3))
    mirror = b.add_material(tsc.MAT_MIRROR, kr=(0.9, 0.9, 0.9))
    b.add_triangle_mesh([[0, 1, 2], [2, 3, 0]],
                        [[-4, -1, -4], [4, -1, -4], [4, -1, 8], [-4, -1, 8]],
                        material=m)
    b.add_sphere(ttf.translate(0.0, 0.0, 3.0), 1.0, material=m)
    b.add_sphere(ttf.translate(1.5, -0.4, 2.5), 0.5, material=mirror)
    b.add_point_light(ttf.translate(0.0, 3.0, 1.0), (8.0, 8.0, 8.0))
    b.add_emissive_sphere(ttf.translate(-1.5, 1.0, 3.0), 0.3, L=(3.0, 2.0, 1.0),
                          material=m)
    cam = make_perspective_camera(ttf.look_at([0, 0, -1], [0, 0, 3], [0, 1, 0]),
                                  RES, fov_deg=50.0)
    return (b.build(device="cpu"), cam, tfm.FilmConfig(full_resolution=RES),
            SamplerConfig("halton", SPP, RES), tpath.PathConfig(max_depth=5))


def test_lockstep_resume_bit_equal(tmp_path):
    scene, cam, film, sampler, cfg = _setup()
    ref, ref_c = tpath.render(scene, cam, film, sampler, cfg, stats_out=True,
                              device="cpu")
    path = str(tmp_path / "lock.npz")
    with pytest.raises(Stopped):  # stopped after the third batch
        tpath.render(scene, cam, film, sampler, cfg, device="cpu",
                     progress=StopAt(3), checkpoint_path=path, checkpoint_every=1)
    _, start = ckpt.load(path, tfm.make_film_state(film, make_filter("box"), "cpu"))
    assert start == 2
    got = tpath.render(scene, cam, film, sampler, cfg, device="cpu",
                       checkpoint_path=path, checkpoint_every=1)
    assert torch.equal(got, ref)
    assert ref_c[st.COUNTERS.index("Film/Samples added")] == RES[0] * RES[1] * SPP


def test_wavefront_resume_bit_equal(tmp_path):
    """64 lanes, 2 iterations a superstep, a checkpoint every superstep;
    stopped after the fifth: the resumed render continues mid-pool."""
    scene, cam, film, sampler, cfg = _setup()
    kw = dict(n_lanes=64, iters_per_step=2, device="cpu")
    ref, ref_c = twf.render(scene, cam, film, sampler, cfg, stats_out=True, **kw)
    path = str(tmp_path / "wf.npz")
    with pytest.raises(Stopped):
        twf.render(scene, cam, film, sampler, cfg, progress=StopAt(5),
                   checkpoint_path=path, checkpoint_every=1, **kw)
    got, got_c = twf.render(scene, cam, film, sampler, cfg, stats_out=True,
                            checkpoint_path=path, checkpoint_every=1, **kw)
    assert torch.equal(got, ref) and torch.equal(got_c, ref_c)
    assert float(ref.mean()) > 0


def test_checkpoint_of_another_render_is_refused(tmp_path):
    scene, cam, film, sampler, cfg = _setup()
    path = str(tmp_path / "wf.npz")
    pixels = torch.as_tensor(tpath.make_pixel_grid(film))
    fs = tfm.make_film_state(film, make_filter("box"), "cpu")
    state = twf.initial_state(scene, cam, fs, sampler, pixels, 100, 64)
    ckpt.save_state(path, state)
    assert torch.equal(ckpt.load_state(path, state)["L"], state["L"])
    other = twf.initial_state(scene, cam, fs, sampler, pixels, 100, 32)
    with pytest.raises(ValueError, match="shape"):
        ckpt.load_state(path, other)
    with pytest.raises(ValueError, match="different render configuration"):
        ckpt.load_state(path, dict(state, extra=torch.zeros(2)))
    big = tfm.make_film_state(tfm.FilmConfig(full_resolution=(8, 8)),
                              make_filter("box"), "cpu")
    ckpt.save(path, fs, 3)
    with pytest.raises(ValueError, match="shape"):
        ckpt.load(path, big)
    assert not list(tmp_path.glob("*.tmp*"))  # nothing left of the writes
