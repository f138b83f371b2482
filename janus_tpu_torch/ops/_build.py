"""Build the CUDA kernels of ``csrc/`` at first use and load them with ctypes.

``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
-Xcompiler -fPIC -Xptxas -v -c`` compiles each ``csrc/*.cu`` (one nvcc per
source, all started together; ``SOURCE_FLAGS`` names the two sources built
otherwise) and one ``nvcc -shared`` links them, device code included, into a
shared library with a plain C interface under ``janus_tpu_torch/_build/``
(git-ignored), named by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads from the cache. ptxas's report
(registers, spills, per kernel) is kept beside the library
(``ptxas_log``). No PyTorch headers are compiled. A missing ``nvcc`` or a failed build raises: there is no
fallback.
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
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
# -fmad=false: each kernel does its twin's IEEE operations one by one. With
# a*b + c contracted to FMAs, the cancellations in K4's step (the error
# estimate f0 + ze, the warm-start polynomial) amplified last-bit
# differences of one attempt to 3.7e-9 of the h row in f64 and 1.1e-1 of
# err_old in f32 (VdP, H100), and an ill-conditioned f32 lane put K3 5.5e-5
# of the largest entry away from its twin. The LU kernels are memory bound,
# K4 latency bound: contraction buys them little.
FMAD_OFF = ["-fmad=false"]
# K4 calls pow in double from pow_fmad.cu, built with contraction as
# PyTorch builds its kernels (the twin's pow; see that file), so both are
# relocatable device code, joined when the library is linked.
SOURCE_FLAGS = {"radau_fused.cu": ["-fmad=false", "-rdc=true"],
                "pow_fmad.cu": ["-fmad=true", "-rdc=true"]}

_lib = None


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256()
    for p in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    h.update(repr(sorted(SOURCE_FLAGS.items())).encode())
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


def _library_path() -> Path:
    return BUILD_DIR / f"libjanus_kernels_{_source_hash()}.so"


def ptxas_log() -> str:
    """ptxas -v's report of the build (built if need be)."""
    return build().with_suffix(".ptxas.txt").read_text()


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu into the cached shared library; returns its path.
    One nvcc per source, all started together, then one link. verbose
    prints ptxas's report of a fresh build."""
    out = _library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    flags = [*ARCH_FLAGS, *NVCC_FLAGS, "-Xptxas", "-v"]
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [nvcc, *flags, *SOURCE_FLAGS.get(src.name, FMAD_OFF), "-c",
                   "-o", obj, str(src)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
            objs.append(obj)
        logs, failed = [], []
        for cmd, proc in procs:
            log = proc.communicate()[0]
            logs.append(log)
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n"
                              f"{' '.join(cmd)}\n{log}")
        if failed:
            raise RuntimeError("\n".join(failed))
        lib = os.path.join(tmp, out.name)
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-Xcompiler", "-fPIC", "-o", lib,
               *objs]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        log = "".join(logs) + res.stdout + res.stderr
        if verbose:
            print(log)
        out.with_suffix(".ptxas.txt").write_text(log)
        os.replace(lib, out)
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
        lib.janus_linsolve_fused.argtypes = [vp, vp, vp, i32, i64, i32, vp]
        lib.janus_linsolve_fused.restype = i32
        lib.janus_radau5_step.argtypes = [vp, vp, vp, i64, ctypes.c_char_p,
                                          i32, i32, i32, vp, i32, vp]
        lib.janus_radau5_step.restype = i32
        lib.janus_radau5_attributes.argtypes = [ctypes.c_char_p, i32, vp]
        lib.janus_radau5_attributes.restype = i32
        _lib = lib
    return _lib
