"""Render checkpoints and resume.

Port of pbrt_tpu/utils/checkpoint.py.  pbrt writes its film once at the end
(integrator.cpp:338); here a render can stop and go on:

* the lockstep engine (integrators/path.py): the film's sums and the next
  sample index are the whole render state, since the samplers are functions
  of (pixel, sample, dim); ``save`` writes them every K sample batches and
  ``maybe_resume`` continues at the saved index.  The file's keys are the
  JAX package's (weighted_sum, weight_sum, splat, next_sample).
* the wavefront engine (integrators/wavefront.py): the loop state (film,
  lane pool with its sampler cursors, work counter, counters) is the whole
  render state; ``save_state`` writes every tensor of it by its path in the
  state ("film.weighted_sum", "sampler.rng.0", ...), and ``load_state``
  refuses a file whose names or shapes differ from the render's own state
  (a different configuration).

Files are written atomically (a temporary file in the same directory, then
os.replace), as numpy .npz, with the tensors moved to the CPU; a load puts
them back on the device of the state it restores into.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile

import numpy as np
import torch


def _write_npz(path: str, arrays: dict):
    fd, tmp = tempfile.mkstemp(suffix=".npz",
                               dir=os.path.dirname(os.path.abspath(path)))
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def save(path: str, film_state, next_sample: int):
    """The lockstep engine's checkpoint: the film's sums and the index of
    the next sample batch."""
    _write_npz(path, dict(weighted_sum=_np(film_state.weighted_sum),
                          weight_sum=_np(film_state.weight_sum),
                          splat=_np(film_state.splat),
                          next_sample=np.int64(next_sample)))


def load(path: str, film_state):
    """Restore the film's sums into film_state (in place; its other fields
    stay).  Returns (film_state, next_sample)."""
    with np.load(path) as z:
        for k in ("weighted_sum", "weight_sum", "splat"):
            dst = getattr(film_state, k)
            if tuple(z[k].shape) != tuple(dst.shape):
                raise ValueError(f"checkpoint {path}: {k} has shape "
                                 f"{z[k].shape}, the film {tuple(dst.shape)}")
            dst.copy_(torch.as_tensor(z[k]))
        return film_state, int(z["next_sample"])


def maybe_resume(path: str, film_state):
    if path and os.path.exists(path):
        return load(path, film_state)
    return film_state, 0


def _leaves(tree, prefix: str = ""):
    """(path, tensor) for every tensor of a state: dicts by key, tuples and
    lists by index, dataclasses by field; other values are not state."""
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}.{k}" if prefix else str(k))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}.{i}" if prefix else str(i))
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name),
                               f"{prefix}.{f.name}" if prefix else f.name)


def _rebuild(tree, new: dict, prefix: str = ""):
    """tree with each tensor replaced by new[its path]."""
    if isinstance(tree, torch.Tensor):
        return new[prefix]
    if isinstance(tree, dict):
        return {k: _rebuild(v, new, f"{prefix}.{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, new, f"{prefix}.{i}" if prefix else str(i))
                          for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _rebuild(getattr(tree, f.name), new,
                             f"{prefix}.{f.name}" if prefix else f.name)
            for f in dataclasses.fields(tree)})
    return tree


def save_state(path: str, state):
    """Snapshot every tensor of a state (dicts, tuples and dataclasses of
    tensors), atomically."""
    _write_npz(path, {name: _np(x) for name, x in _leaves(state)})


def load_state(path: str, template):
    """The state saved by save_state, in template's structure, each tensor
    with its template tensor's dtype and device.  Raises ValueError when
    the file's tensors are not the template's by name and shape: the
    render must be set up as the one that wrote it (wavefront.py's
    structure check, checkpoint.py:68-97)."""
    leaves = dict(_leaves(template))
    with np.load(path) as z:
        if sorted(z.files) != sorted(leaves):
            raise ValueError(
                f"checkpoint {path} holds {len(z.files)} tensors "
                f"{sorted(set(z.files) ^ set(leaves))[:4]} differ from the "
                f"render's {len(leaves)}: a different render configuration?")
        new = {}
        for name, ref in leaves.items():
            arr = z[name]
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"checkpoint {path}: {name} has shape "
                                 f"{arr.shape}, the render's {tuple(ref.shape)}")
            new[name] = torch.as_tensor(arr).to(dtype=ref.dtype, device=ref.device)
    return _rebuild(template, new)


def maybe_resume_state(path: str, template):
    if path and os.path.exists(path):
        return load_state(path, template)
    return template
