"""pbrt_tpu_torch: the path tracer ported to PyTorch and CUDA (NVIDIA Hopper).

A second package beside the JAX reference ``pbrt_tpu``.  It renders a
``SceneBuilder`` scene with the path integrator; every ray it traces on the
card goes through the hand-written 4-wide BVH traversal kernel
(``csrc/bvh4_traverse.cu``, wrapped by ``ops/bvh.py``).  Entry points run on
the card unless the caller passes ``device="cpu"``, where each kernel's plain
PyTorch version runs instead.
"""
