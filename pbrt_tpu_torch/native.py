"""Builds and loads the port's native libraries at first use.

Takes the place of native/Makefile and the ctypes loading of
pbrt_tpu/accel/build.py:46-114.  Two shared libraries with a plain C interface, loaded with ctypes:

* ``csrc/bvh4_traverse.cu`` -> the Hopper BVH traversal kernel, compiled with
  ``nvcc -gencode arch=compute_90a,code=sm_90a`` (needs the CUDA toolkit);
* ``csrc/host/bvh_builder.cpp`` -> the host SAH BVH builder, compiled with
  ``g++ -O3 -fPIC -shared`` (no ``-march=native``).

Both land in ``build/`` at the repository root (listed in .gitignore), named
by a hash of their source and flags, so an edited source is rebuilt and two
processes that build at once each write a private file and rename it into
place.  Nothing here runs when the module is imported.
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
CUDA_SRC = PKG / "csrc" / "bvh4_traverse.cu"
HOST_SRC = PKG / "csrc" / "host" / "bvh_builder.cpp"

# -fmad=false: the kernel's float arithmetic then rounds exactly as the
# plain PyTorch version's separate multiplies and adds do.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
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
                       f"{CUDA_SRC.name}")


def _target(src: Path, flags: list[str], stem: str) -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"lib{stem}_{h[:12]}.so"


def _compile_cmd(compiler: str, flags: list[str], src: Path, out: Path):
    return [compiler, *flags, "-o", str(out), str(src)]


def _start(kind: str):
    """Start the compiler for `kind` ("cuda" | "host") unless its library is
    already built.  Returns (target, process or None, tmp path or None)."""
    if kind == "cuda":
        src, flags, stem, cc = CUDA_SRC, NVCC_FLAGS, "bvh4_traverse", None
    else:
        src, flags, stem, cc = HOST_SRC, GXX_FLAGS, "bvh_builder", "g++"
    out = _target(src, flags, stem)
    if out.exists():
        return out, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cc = cc or _nvcc()
    proc = subprocess.Popen(
        _compile_cmd(cc, flags, src, Path(tmp)),
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
    os.replace(tmp, out)
    return out


def build(kinds=("cuda", "host")) -> dict:
    """Build the named libraries, all compilers started together.
    Returns {kind: path}."""
    started = {k: _start(k) for k in kinds}
    return {k: _finish(*v) for k, v in started.items()}


@functools.cache
def cuda_lib() -> ctypes.CDLL:
    """The traversal kernel's library, built on first call."""
    lib = ctypes.CDLL(str(build(("cuda",))["cuda"]))
    vp = ctypes.c_void_p
    lib.bvh4_traverse.restype = ctypes.c_int
    lib.bvh4_traverse.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp,
                                  ctypes.c_int, vp]
    lib.bvh4_stack_size.restype = ctypes.c_int
    lib.bvh4_stack_size.argtypes = []
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
