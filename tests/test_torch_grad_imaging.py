"""The new cameras and samplers through the port's grad step, held against
the JAX package's on the CPU: tests/test_torch_grad_groups.py's imaging
scene (a plastic floor, a matte and a plastic sphere, a point light and a
constant infinite light), 12x12, depth 2, sample 1, under the orthographic
camera with a thin lens, the environment camera and the realistic camera
(its material and light leaves only: the JAX package's extract_params
raises on its camera leaves), each with the stratified, zerotwosequence,
maxmin and random samplers (random without remat: the JAX package's step
raises with it), on one set of seeded parameter values, at
tests/test_torch_grad_config3.py's bars.

Each case compiles its own JAX step (~50 one-process seconds), so the
comparisons are marked slow; Tier-1 runs the port's step on every case in
tests/test_torch_grad_groups.py."""
import pytest

from test_torch_grad_config3 import assert_matches_jax, jax_and_port
from test_torch_grad_groups import IMAGING
import test_torch_threads  # noqa: F401  (torch's threads under xdist)


@pytest.mark.slow
@pytest.mark.parametrize("case", IMAGING, ids="-".join)
def test_grads_match_jax(case):
    assert_matches_jax(jax_and_port("imaging", *case))
