"""Build the CUDA kernels of ``csrc/`` at first use and load them with ctypes.

``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
-Xcompiler -fPIC`` compiles ``csrc/*.cu`` into a shared library with a plain
C interface under ``janus_tpu_torch/_build/`` (git-ignored), named by a hash
of the sources, so an edited source rebuilds and an unchanged one loads from
the cache. No PyTorch headers are compiled: a cold build of every
instantiation (D = 1..16, float and double) takes under a minute on an H100
host. A missing ``nvcc`` or a failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lib = None


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256()
    for p in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels of "
                       "janus_tpu_torch cannot be built")


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu into the cached shared library; returns its path."""
    out = BUILD_DIR / f"libjanus_kernels_{_source_hash()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, *map(str, _sources())]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        if verbose:
            print(res.stdout + res.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load_library(verbose: bool = False):
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build(verbose)))
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.janus_lu_factor_t.argtypes = [vp, vp, i32, i64, i32, vp]
        lib.janus_lu_factor_t.restype = i32
        lib.janus_lu_solve_t.argtypes = [vp, vp, vp, i32, i64, i32, vp]
        lib.janus_lu_solve_t.restype = i32
        _lib = lib
    return _lib
