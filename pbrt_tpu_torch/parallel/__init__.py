"""Differentiable rendering (port of pbrt_tpu/parallel/diff.py) and the
multi-process render (mesh.py, multihost.py)."""
