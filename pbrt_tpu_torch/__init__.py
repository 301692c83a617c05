"""pbrt_tpu_torch: the path tracer ported to PyTorch and CUDA (NVIDIA Hopper).

A second package beside the JAX reference ``pbrt_tpu``.  It parses ``.pbrt``
files (``sceneio``) or takes a ``SceneBuilder`` scene, and renders it with
the path integrator (``render.py``, ``python -m pbrt_tpu_torch``); every ray
it traces on the card goes through a hand-written BVH traversal kernel
(``csrc/bvh4_traverse.cu``, or ``csrc/bvh2_traverse.cu`` under
``PBRT_TPU_BVH4=0``, wrapped by ``ops/bvh.py``).  Entry points run on the
card unless the caller asks for the CPU, where each kernel's plain PyTorch
version runs instead.
"""
