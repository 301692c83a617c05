"""Differentiable rendering (port of pbrt_tpu/parallel/diff.py)."""
