"""Builds and loads the port's native libraries at first use.

Takes the place of native/Makefile and the ctypes loading of
pbrt_tpu/accel/build.py:46-114.  Shared libraries with a plain C interface,
loaded with ctypes, one per source:

* ``csrc/bvh4_traverse.cu`` (its triangle-only and typed builds, one
  library) and ``csrc/bvh2_traverse.cu`` -> the Hopper BVH traversal
  kernels, each compiled with
  ``nvcc -gencode arch=compute_90a,code=sm_90a`` (needs the CUDA toolkit);
* ``csrc/host/bvh_builder.cpp`` -> the host SAH BVH builder, compiled with
  ``g++ -O3 -fPIC -shared`` (no ``-march=native``).

They land in ``build/`` at the repository root (listed in .gitignore), named
by a hash of their source and flags, so an edited source is rebuilt and two
processes that build at once each write a private file and rename it into
place.  ``build`` starts every compiler at once.  Each compiler's output is
kept beside its library (``<library>.log``): for the kernels, ptxas's
registers, shared memory and spills (``-Xptxas -v``), which ``build_log``
returns.  Nothing here runs when the module is imported.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG = Path(__file__).resolve().parent
BUILD_DIR = PKG.parent / "build"
CUDA_KERNELS = ("bvh4_traverse", "bvh2_traverse")
HOST_SRC = PKG / "csrc" / "host" / "bvh_builder.cpp"

# -fmad=false: the kernels' float arithmetic then rounds exactly as the
# plain PyTorch versions' separate multiplies and adds do.  -Xptxas -v:
# each kernel's registers, shared memory and spills, kept in the build log.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
]
GXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       f"{', '.join(k + '.cu' for k in CUDA_KERNELS)}")


def _target(src: Path, flags: list[str], stem: str) -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"lib{stem}_{h[:12]}.so"


def _start(kind: str):
    """Start the compiler for `kind` (a CUDA kernel's name, or "host")
    unless its library is already built.  Returns (target, process or None,
    tmp path or None)."""
    if kind == "host":
        src, flags, compiler = HOST_SRC, GXX_FLAGS, "g++"
    elif kind in CUDA_KERNELS:
        src, flags, compiler = PKG / "csrc" / f"{kind}.cu", NVCC_FLAGS, None
    else:
        raise ValueError(f"unknown native library {kind!r}")
    out = _target(src, flags, "bvh_builder" if kind == "host" else kind)
    if out.exists():
        return out, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.Popen(
        [compiler or _nvcc(), *flags, "-o", tmp, str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    return out, proc, tmp


def _finish(out: Path, proc, tmp) -> Path:
    if proc is None:
        return out
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"building {out.name} failed:\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)
    return out


def build(kinds=(*CUDA_KERNELS, "host")) -> dict:
    """Build the named libraries, all compilers started together.
    Returns {kind: path}."""
    started = {k: _start(k) for k in kinds}
    return {k: _finish(*v) for k, v in started.items()}


def build_log(kind: str) -> str:
    """The compiler's output of one library's build (building it first if
    needed); for a kernel, ptxas's lines on its registers, shared memory and
    spills."""
    log = build((kind,))[kind].with_suffix(".log")
    return log.read_text() if log.exists() else ""


@functools.cache
def cuda_lib(kernel: str) -> ctypes.CDLL:
    """The library of one traversal kernel ("bvh4_traverse" or
    "bvh2_traverse"), built on first call.  It exports
    ``<kernel>(nodes, tris, o, d, t_max, mode, order, t_out, prim_out, n,
    stream)`` and ``<kernel>_stack_size()``; bvh4's also its typed build,
    ``bvh4_traverse_typed(nodes, tris, q_packed, curve_packed, inst_xf, o,
    d, t_max, mode, order, t_out, prim_out, n, stream)``."""
    lib = ctypes.CDLL(str(build((kernel,))[kernel]))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn = getattr(lib, kernel)
    fn.restype = i32
    fn.argtypes = [vp] * 9 + [i32, vp]
    if kernel == "bvh4_traverse":
        typed = lib.bvh4_traverse_typed
        typed.restype = i32
        typed.argtypes = [vp] * 12 + [i32, vp]
    size = getattr(lib, f"{kernel}_stack_size")
    size.restype = i32
    size.argtypes = []
    return lib


@functools.cache
def host_lib() -> ctypes.CDLL:
    """The host BVH builder's library, built on first call."""
    lib = ctypes.CDLL(str(build(("host",))["host"]))
    lib.bvh_build.restype = ctypes.c_int32
    lib.bvh_build.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ]
    return lib
