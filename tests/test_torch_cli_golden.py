"""The port's CLI (python -m pbrt_tpu_torch) on the CPU on two parity-ladder
scenes, against the pbrt-v3 goldens at tests/test_parity_images.py's
thresholds and against the JAX package's render_file of the same file
(tests/test_torch_cli.py holds the rest of the CLI's tests).  The JAX
renders are the costly part; the file keeps to six tests or fewer so that
xdist's loadfile scheduling hands it out after tests/test_media.py."""
import numpy as np
import pytest

from pbrt_tpu import render as jrender
from pbrt_tpu.utils import imageio as jimg
from pbrt_tpu_torch.utils import imageio as timg
from test_torch_cli import GOLD, PARITY, assert_meets, run_cli
from jax_traversal_jit import jit_jax_traversal  # noqa: F401  (autouse)
import test_torch_threads  # noqa: F401  (torch's threads under xdist)


@pytest.mark.parametrize("name", ["a_floor_point", "c3_plastic_d1"])
def test_cli_matches_golden_and_jax(name, tmp_path):
    out = tmp_path / "out.pfm"
    r = run_cli(str(PARITY / f"{name}.pbrt"), "--device", "cpu", "-o", str(out))
    assert r.returncode == 0, r.stderr
    assert "Mrays/s" in r.stdout and "Statistics:" in r.stdout
    got = timg.read_pfm(str(out))
    assert_meets(jimg.read_pfm(str(GOLD / f"{name}.pfm")), got, name)
    ref, _ = jrender.render_file(str(PARITY / f"{name}.pbrt"),
                                 out=str(tmp_path / "jax.pfm"))
    assert_meets(np.asarray(ref), got, name)
