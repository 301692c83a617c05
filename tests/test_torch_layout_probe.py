"""The port of the layout probe (pbrt_tpu_torch/tools/bench_layout_probe.py)
against the JAX tool (tools/bench_layout_probe.py): forms A and B against
chain_rows / chain_planar, and against the Pallas-fused form C in interpret
mode on one 8192-lane block.  The Triton form C runs only on a card
(tests/test_torch_cuda.py); on the CPU chain_fused is form B.

Tolerance: six rounds of normalize/cross/dot in float32.  XLA:CPU fuses the
chain and contracts multiply-adds, and sums the three components in its own
order, so values move by a few ulps per round; 1e-5 relative plus 1e-5
absolute (values are O(1)) on >= 99.9% of elements.  A lane whose mask
`dot > 0` flips on such a difference takes the other branch, hence not all
of them."""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu_torch.tools import bench_layout_probe as bp
import test_torch_threads  # noqa: F401  (torch's threads under xdist)

ROOT = pathlib.Path(__file__).resolve().parent.parent
N = 8192


@pytest.fixture(scope="module")
def jtool():
    spec = importlib.util.spec_from_file_location(
        "jax_bench_layout_probe", ROOT / "tools" / "bench_layout_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def close(ref, got):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape
    ok = np.abs(ref - got) <= 1e-5 * np.abs(ref) + 1e-5
    assert ok.mean() >= 0.999, ok.mean()


def test_forms_match_jax(jtool):
    p, d, ns, t = bp.inputs(N, "cpu", seed=3)
    jp, jd, jns, jt = (jnp.asarray(x.numpy()) for x in (p, d, ns, t))
    ra = jax.jit(jtool.chain_rows)(jp, jd, jns, jt)
    rb = jax.jit(jtool.chain_planar)(jp.T, jd.T, jns.T, jt)
    ga = bp.chain_rows(p, d, ns, t)
    gb = bp.chain_planar(p.t().contiguous(), d.t().contiguous(),
                         ns.t().contiguous(), t)
    for ref, got in ((ra[0], ga[0]), (ra[1], ga[1]), (rb[0], gb[0]), (rb[1], gb[1]),
                     (ra[0], gb[0].t())):
        close(ref, got.numpy())


def test_form_b_matches_pallas_fused_interpret(jtool, monkeypatch):
    """pallas_fused (its grid sized by the tool's N), interpret mode, one
    8192-lane block."""
    monkeypatch.setattr(jtool, "N", N)
    orig = jtool.pl.pallas_call
    monkeypatch.setattr(jtool.pl, "pallas_call",
                        lambda *a, **kw: orig(*a, **dict(kw, interpret=True)))
    p, d, ns, t = bp.inputs(N, "cpu", seed=4)
    pT, dT, nsT = (x.t().contiguous() for x in (p, d, ns))
    rp, rt = jtool.pallas_fused(*(jnp.asarray(x.numpy()) for x in (pT, dT, nsT, t)))
    gp, gt = bp.chain_fused(pT, dT, nsT, t)
    close(rp, gp.numpy())
    close(np.asarray(rt)[0], gt.numpy())


def test_chain_fused_on_cpu_is_form_b_and_checks_inputs():
    p, d, ns, t = bp.inputs(300, "cpu")
    pT, dT, nsT = (x.t().contiguous() for x in (p, d, ns))
    before = bp.chain_fused.launches
    got = bp.chain_fused(pT, dT, nsT, t)
    ref = bp.chain_planar(pT, dT, nsT, t)
    assert bp.chain_fused.launches == before
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    with pytest.raises(ValueError, match="float32"):
        bp.chain_fused(p, dT, nsT, t)  # [N, 3], not [3, N]
    with pytest.raises(ValueError, match="contiguous"):
        bp.chain_fused(p.t(), dT, nsT, t)


def test_probe_main_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bp.main([]) == 2
