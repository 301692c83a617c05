"""The port's CLI and render entry points (python -m pbrt_tpu_torch, render.py)
on the CPU: the heavier parity-ladder scenes against the pbrt-v3 goldens
at tests/test_parity_images.py's thresholds (-m slow; the two light ones,
also against the JAX package's render, are in
tests/test_torch_cli_golden.py); the refusals; image IO and the Statistics
block against the JAX package's; and the port's independence from JAX."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from pbrt_tpu.utils import imageio as jimg
from pbrt_tpu.utils import stats as jst
from pbrt_tpu_torch import __main__ as cli
from pbrt_tpu_torch import render as trender
from pbrt_tpu_torch.utils import imageio as timg
from pbrt_tpu_torch.utils import stats as tst
from jax_traversal_jit import jit_jax_traversal  # noqa: F401  (autouse)
import test_torch_threads  # noqa: F401  (torch's threads under xdist)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PARITY = ROOT / "refgold" / "parity"
GOLD = ROOT / "refgold" / "goldens" / "parity"

# test_parity_images.py:35-42: (scene, rel-tol, min match_frac, max mean-rel)
BARS = {
    "a_floor_point": (1e-3, 0.995, 5e-3),
    "c3_plastic_d1": (1e-3, 0.995, 5e-3),
    "b_arealight": (1e-3, 0.999, 1e-4),
    "c2_twolights_d2": (1e-3, 0.995, 1e-3),
    "c4_mirror_d3": (1e-3, 0.995, 1e-3),
    "c1_matte_point_d5": (1e-3, 0.70, 1e-3),
    "c_indirect": (2e-2, 0.70, 2e-2),
}


def assert_meets(ref, got, name):
    tol, min_frac, max_mean_rel = BARS[name]
    assert got.shape == ref.shape
    rel = np.abs(ref - got) / np.maximum(np.abs(ref), 1e-2)
    frac = np.all(rel <= tol, -1).mean()
    mean_rel = abs(got.mean() - ref.mean()) / max(ref.mean(), 1e-6)
    assert frac >= min_frac and mean_rel <= max_mean_rel, (frac, mean_rel)


def run_cli(*args, env=None):
    return subprocess.run([sys.executable, "-m", "pbrt_tpu_torch", *args],
                          cwd=ROOT, capture_output=True, text=True, timeout=300,
                          env=env)


@pytest.mark.slow
@pytest.mark.parametrize("name", ["b_arealight", "c2_twolights_d2", "c4_mirror_d3",
                                  "c1_matte_point_d5", "c_indirect"])
def test_heavy_ladder_matches_golden(name, tmp_path):
    img, _ = trender.render_file(str(PARITY / f"{name}.pbrt"),
                                 out=str(tmp_path / "out.pfm"), device="cpu")
    assert_meets(jimg.read_pfm(str(GOLD / f"{name}.pfm")), img, name)


def test_cli_needs_a_card_or_the_cpu(monkeypatch, capsys):
    """Without a card and without --device cpu the CLI exits non-zero; the
    same in a fresh process that sees no card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main([str(PARITY / "a_floor_point.pbrt")]) == 2
    assert "--device cpu" in capsys.readouterr().err
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = run_cli(str(PARITY / "a_floor_point.pbrt"), "-o", os.devnull, env=env)
    assert r.returncode != 0 and "--device cpu" in r.stderr


def test_render_refusals(monkeypatch, tmp_path):
    with pytest.raises(NotImplementedError, match="--cat"):
        cli.main(["--cat", str(PARITY / "a_floor_point.pbrt")])
    scene = tmp_path / "s.pbrt"
    scene.write_text((PARITY / "a_floor_point.pbrt").read_text()
                     .replace('Integrator "path"', 'Integrator "bdpt"'))
    # bdpt renders the file; in the exact sampler mode it raises
    monkeypatch.setenv("PBRT_TPU_EXACT_SAMPLER", "1")
    with pytest.raises(NotImplementedError, match="bdpt.*exact sampler"):
        trender.render_file(str(scene), out=str(tmp_path / "o.pfm"), device="cpu")
    monkeypatch.delenv("PBRT_TPU_EXACT_SAMPLER")
    monkeypatch.setenv("PBRT_TPU_ENGINE", "wavefront")
    with pytest.raises(NotImplementedError, match="wavefront"):
        trender.render_file(str(PARITY / "a_floor_point.pbrt"),
                            out=str(tmp_path / "o.pfm"), device="cpu")


def test_overrides_and_stats(tmp_path):
    """--spp/--res/--cropwindow reach the render; the counters' report is
    the JAX package's format."""
    img, stats = trender.render_file(str(PARITY / "c2u_uniform.pbrt"),
                                     out=str(tmp_path / "o.pfm"), spp=1,
                                     res=(24, 16), device="cpu")
    assert img.shape == (16, 24, 3) and np.isfinite(img).all() and img.mean() > 0
    assert stats["spp"] == 1 and stats["resolution"] == (24, 16)
    assert "Light distribution" not in stats["phases"]  # "uniform" strategy
    c = stats["counters"]
    assert c[tst.COUNTERS.index("Integrator/Camera rays traced")] == 24 * 16
    assert tst.report(c) == jst.report(c.astype(np.float32))
    assert stats["rays_traced"] == pytest.approx(
        c[1] + c[2]) and stats["rays_traced"] > 24 * 16
    crop, _ = trender.render_file(str(PARITY / "c2u_uniform.pbrt"),
                                  out=str(tmp_path / "c.pfm"), spp=1, res=(24, 16),
                                  crop=(0.0, 0.5, 0.0, 1.0), device="cpu")
    assert crop.shape == (16, 12, 3)


@pytest.mark.parametrize("ext", [".pfm", ".exr", ".npy", ".png"])
def test_imageio_matches_jax(tmp_path, ext):
    rgb = np.random.RandomState(1).rand(5, 7, 3).astype(np.float32) * 1.2
    ours, theirs = str(tmp_path / f"a{ext}"), str(tmp_path / f"b{ext}")
    timg.write_image(ours, rgb)
    jimg.write_image(theirs, rgb)
    np.testing.assert_array_equal(timg.read_image(ours), jimg.read_image(theirs))
    np.testing.assert_array_equal(timg.read_image(theirs), jimg.read_image(ours))
    if ext != ".png":
        np.testing.assert_array_equal(timg.read_image(ours), rgb)


def test_port_imports_no_jax():
    """Nothing in pbrt_tpu_torch/ or chip_smoke.py imports jax or the JAX
    package."""
    files = sorted((ROOT / "pbrt_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            bad += [(f.name, n) for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "pbrt_tpu")]
    assert len(files) > 30 and bad == []
