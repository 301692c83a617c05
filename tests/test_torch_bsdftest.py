"""The port's bsdftest (pbrt_tpu_torch/tools/bsdftest.py) on the CPU
against the JAX package's (pbrt_tpu/tools/bsdftest.py), at --n 2048 on the
same numpy draws: each of the nine rows' two reflectance estimates and its
ok/MISMATCH, the printed table and the exit status.  At this n both tools
flag rough glass (its sampled estimate is noise at 2,048 directions; every
row agrees at the default n), so both exit 1.

Tolerance: the JAX tool prints each estimate to 4 decimals; the port's
value must lie within 7e-5 of the printed one: 5e-5 of the print's rounding
plus 2e-5 for float32 sums taken in another order (the unrounded values
differ by at most 4e-7 relative here)."""
import contextlib
import io

import pytest
import torch

from pbrt_tpu.tools import bsdftest as jtool
from pbrt_tpu_torch.tools import bsdftest as ttool
import test_torch_threads  # noqa: F401  (torch's threads under xdist)

N = 2048
TOL = 7e-5


def run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        status = main(argv)
    return status, out.getvalue()


def parse(text):
    """{name: (rho uniform, rho sampled, status word)} of a printed table."""
    rows = {}
    for line in text.splitlines()[1:]:
        name, rho_u, rho_s, word = line.split()
        rows[name] = (float(rho_u), float(rho_s), word)
    return rows


@pytest.fixture(scope="module")
def both():
    """The JAX tool's run and the port's, once each."""
    return run(jtool.main, ["--n", str(N)]), run(ttool.main, ["--n", str(N),
                                                              "--device", "cpu"])


def test_rows_match_jax(both):
    (_, jtext), _ = both
    theirs = parse(jtext)
    ours = ttool.rows(N, "cpu")
    assert [r[0] for r in ours] == list(theirs) and len(ours) == 9
    for name, rho_u, rho_s, ok in ours:
        ju, js, word = theirs[name]
        assert abs(rho_u - ju) <= TOL and abs(rho_s - js) <= TOL, (name, rho_u, rho_s)
        assert ("ok" if ok else "MISMATCH") == word, name


def test_table_and_status_match_jax(both):
    (jstatus, jtext), (status, text) = both
    assert status == jstatus == 1
    assert text.splitlines()[0] == jtext.splitlines()[0]
    ours, theirs = parse(text), parse(jtext)
    assert [n for n, r in ours.items() if r[2] == "MISMATCH"] == ["rough-glass"]
    assert {n: r[2] for n, r in ours.items()} == {n: r[2] for n, r in theirs.items()}


def test_needs_a_card_or_the_cpu(monkeypatch, capsys):
    """Without a card and without --device cpu it exits 2 and computes
    nothing; it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ttool.main(["--n", "16"]) == 2
    captured = capsys.readouterr()
    assert "--device cpu" in captured.err and captured.out == ""
