"""pbrt-v3's classic materials and lights through the port's grad step,
held against the JAX package's on the CPU: tests/test_torch_grad_groups.py's
classic scene (a substrate floor, a translucent wall, metal, uber at
opacity 0.5 and a matte/metal mix under spot, distant, projection and
goniometric lights), 12x12, halton, depth 2, sample 1, on one set of
seeded parameter values, at tests/test_torch_grad_config3.py's bars.

The JAX package's camera_to_world, raster_to_camera and roughness leaves
are NaN on this scene; the port's are finite and held against its own
central differences (test_torch_grad_groups.py FD_CASES).

The JAX package's step runs op by op with its bounce loop unrolled
(~160 one-process seconds; jitted, XLA had not compiled it after 20
minutes on the CPU), so the comparison is marked slow.  Tier-1 runs the port's step on this scene in
tests/test_torch_grad_groups.py (finite leaves, L equal to the forward,
remat against no remat, the replayed launches)."""
import pytest

from test_torch_grad_config3 import assert_matches_jax, fd_leaves, jax_and_port
import test_torch_threads  # noqa: F401  (torch's threads under xdist)


@pytest.mark.slow
def test_grads_match_jax():
    assert_matches_jax(jax_and_port("classic", eager=True), fd_leaves("classic"))
