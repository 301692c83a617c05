"""Trees shared by the CPU and card tests of the BVH kernels: a caterpillar
tree of any depth, to hold a kernel at its stack cap, and rays that walk it.
The module imports neither JAX nor the JAX package, so the card tests
(tests/test_torch_cuda.py) can use it on a machine without JAX."""
import numpy as np
import pytest
import torch

from pbrt_tpu_torch.ops import bvh as kb
import test_torch_threads  # noqa: F401  (torch's threads under xdist)


def caterpillar_tree(m):
    """A binary BVH whose interior node k has a one-triangle leaf (triangle
    k, a unit triangle in the plane x = k) as its first child and interior
    node k + 1 as its second, the last one two leaves: m interior levels,
    its deepest node at level m.  A ray down -x enters the second child
    first and pushes a leaf at every level.  Returns the tree's numpy arrays
    (min, max, offset, n_prims, axis) and its triangle records."""
    n = m + 1  # triangles
    x = np.arange(n, dtype=np.float32)
    verts = np.zeros((n, 9), np.float32)
    verts[:, 0::3] = x[:, None]
    verts[:, 4] = 1.0  # v1 = (x, 1, 0)
    verts[:, 8] = 1.0  # v2 = (x, 0, 1)
    n_nodes = 2 * m + 1
    nmin = np.zeros((n_nodes, 3), np.float32)
    nmax = np.zeros((n_nodes, 3), np.float32)
    offset = np.zeros(n_nodes, np.int64)
    n_prims = np.zeros(n_nodes, np.int64)
    for k in range(m):
        inner, leaf = 2 * k, 2 * k + 1
        nmin[inner], nmax[inner] = (x[k], 0, 0), (x[-1], 1, 1)
        offset[inner] = 2 * k + 2
        nmin[leaf], nmax[leaf] = (x[k], 0, 0), (x[k], 1, 1)
        offset[leaf], n_prims[leaf] = k, 1
    nmin[-1], nmax[-1] = (x[-1], 0, 0), (x[-1], 1, 1)
    offset[-1], n_prims[-1] = m, 1
    tree = (nmin, nmax, offset, n_prims, np.zeros(n_nodes, np.int64))
    return tree, kb.build_prim_records(np.zeros(n), np.arange(n), verts)


def caterpillar_rays(n, seed, device="cuda"):
    """Half from x = 200 down -x (the deep walk: two 4-wide entries a level,
    one binary entry a level), half from x = -100 up +x (a shallow walk), a
    third of them tilted a little."""
    rs = np.random.RandomState(seed)
    far = np.stack([np.full(n, 200.0), rs.rand(n) * 0.5, rs.rand(n) * 0.5], 1)
    o = far.astype(np.float32)
    o[1::2, 0] = -100.0
    d = np.zeros((n, 3), np.float32)
    d[:, 0] = np.where(o[:, 0] > 0, -1.0, 1.0)
    d[::3] += rs.randn((n + 2) // 3, 3).astype(np.float32) * 0.01
    return torch.as_tensor(o, device=device), torch.as_tensor(d, device=device)



@pytest.mark.parametrize("m", [1, 2, 64, 65])
def test_caterpillar_depths(m):
    """The depths the stack-cap tests rely on: binary depth m, 4-wide
    (m - 1) // 2 + 1 levels, every triangle in exactly one leaf."""
    tree, recs = caterpillar_tree(m)
    rows4, depth4 = kb.build_bvh4_table(*tree[:4])
    rows2, depth2 = kb.build_bvh2_table(*tree)
    assert depth2 == m and depth4 == (m - 1) // 2 + 1
    nmin, nmax, offset, n_prims, _ = tree
    leaves = n_prims > 0
    covered = np.concatenate([np.arange(o, o + c) for o, c in
                              zip(offset[leaves], n_prims[leaves])])
    assert np.array_equal(np.sort(covered), np.arange(m + 1))
    assert recs.shape[0] == m + 1
