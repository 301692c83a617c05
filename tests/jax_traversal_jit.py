"""A module-scoped autouse fixture for the port's tests that call the JAX
package's functions eagerly: its XLA traversal loop
(pbrt_tpu.accel.traverse._traverse), jitted once a shape.  Called eagerly,
its while_loop is traced and compiled again on every call (the loop body
closes over the scene), ~1.3 s a call on an 8-core CPU; jitted, the same
loop runs with the same results.  A test module imports the fixture by
name:

    from jax_traversal_jit import jit_jax_traversal  # noqa: F401
"""
import jax
import pytest

from pbrt_tpu.accel import traverse as jtv


@pytest.fixture(scope="module", autouse=True)
def jit_jax_traversal():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtv, "_traverse", jax.jit(
            jtv._traverse, static_argnames=("quadric_types", "any_hit")))
        yield
