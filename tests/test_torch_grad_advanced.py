"""pbrt-v3's remaining materials through the port's grad step, held against
the JAX package's on the CPU: tests/test_torch_grad_groups.py's advanced
scene (a fourier floor, disney, hair, subsurface "Skin1" and kdsubsurface
spheres under a point light), 12x12, halton, depth 2, sample 1, on one set
of seeded parameter values, at tests/test_torch_grad_config3.py's bars.

The JAX package's camera_to_world, raster_to_camera and roughness leaves
are NaN on this scene: among its sites, sample_fourier's
sqrt(max(0, 1 - cos^2 phi)) where the solve's cos phi rounds to 1
(pbrt_tpu/core/interpolation.py:101), its hair and BSSRDF square roots at
their domain edges behind a where, and FrDielectric past total internal
reflection; the port's leaves are finite there and held against its own
central differences (test_torch_grad_groups.py FD_CASES).  kdsubsurface's
coefficients come from Kd on the host in both packages, so no gradient
reaches kd through them.

The JAX package's step runs op by op (~130 one-process seconds; jitted,
XLA had not compiled it after 20 minutes), so the comparison is marked
slow."""
import pytest

from test_torch_grad_config3 import assert_matches_jax, fd_leaves, jax_and_port
import test_torch_threads  # noqa: F401  (torch's threads under xdist)


@pytest.mark.slow
def test_grads_match_jax():
    assert_matches_jax(jax_and_port("advanced", eager=True), fd_leaves("advanced"))
