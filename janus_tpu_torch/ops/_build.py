"""Build the CUDA kernels of ``csrc/`` at first use and load them with ctypes.

``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
-Xcompiler -fPIC -Xptxas -v -c`` compiles each ``csrc/*.cu`` (one nvcc per
source, all started together; ``SOURCE_FLAGS`` names the sources built
otherwise) and one ``nvcc -shared`` links them, device code included, into a
shared library with a plain C interface under ``janus_tpu_torch/_build/``
(git-ignored), named by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads from the cache. ptxas's report
(registers, spills, per kernel) is kept beside the library
(``ptxas_log``). No PyTorch headers are compiled. A missing ``nvcc`` or a
failed build raises: there is no fallback.

``build_unit`` builds one generated K4 translation unit
(``ops.rhs_codegen``: a functor, ``csrc/radau5_step.cuh`` and its entries)
into ``_build/libjanus_rhs_<hash>.so`` with K4's flags, linked with
``pow_fmad.cu`` and ``libm_fmad.cu`` (compiled once into
``_build/fmad_<hash>/``); the hash (``unit_hash``) covers the generated
source, the headers it includes, the -fmad=true sources and the flags.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
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
# K1/K3's tile kernel is instantiated for Q = 2, 4 and 8 rows a thread at
# most, each with __launch_bounds__(threads a block, blocks a SM): 64, 128
# and 255 registers a thread. Stated here only: compiled in as
# JANUS_TILE_Q<Q>_THREADS / _BLOCKS, and read by ops/smalllu.py's geometry.
TILE_BOUNDS = {2: (512, 2), 4: (512, 1), 8: (128, 2)}
SOURCE_FLAGS = {"radau_fused.cu": ["-fmad=false", "-rdc=true"],
                "pow_fmad.cu": ["-fmad=true", "-rdc=true"],
                "libm_fmad.cu": ["-fmad=true", "-rdc=true"],
                "smalllu_tile.cu": FMAD_OFF + [
                    f"-DJANUS_TILE_Q{q}_{what}={n}"
                    for q, bounds in TILE_BOUNDS.items()
                    for what, n in zip(("THREADS", "BLOCKS"), bounds)]}
# a generated unit: K4's flags; the functions PyTorch's kernels compute
# with contraction come from these two sources (rhs_ops.cuh)
UNIT_FLAGS = SOURCE_FLAGS["radau_fused.cu"]
FMAD_SOURCES = ("pow_fmad.cu", "libm_fmad.cu")
UNIT_HEADERS = ("radau5_step.cuh", "rhs_ops.cuh", "dual.cuh")

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
        lib.janus_lu_tile.argtypes = [vp, vp, vp, i32, i64, i32, i32, i32,
                                      i32, i32, i64, vp]
        lib.janus_lu_tile.restype = i32
        lib.janus_lu_tile_attributes.argtypes = [i32, i32, i32, i32, i32, i32,
                                                 i64, vp]
        lib.janus_lu_tile_attributes.restype = i32
        lib.janus_radau5_step.argtypes = [vp, vp, vp, i64, ctypes.c_char_p,
                                          i32, i32, i32, vp, i32, vp]
        lib.janus_radau5_step.restype = i32
        lib.janus_radau5_attributes.argtypes = [ctypes.c_char_p, i32, vp]
        lib.janus_radau5_attributes.restype = i32
        _lib = lib
    return _lib


# ---- generated K4 units ------------------------------------------------------

_fmad_lock = threading.Lock()


def unit_hash(source: str) -> str:
    """The name of a generated unit: a hash of its source, the headers it
    includes, the -fmad=true sources it links and the flags."""
    h = hashlib.sha256(source.encode())
    for name in UNIT_HEADERS + FMAD_SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS + UNIT_FLAGS).encode())
    h.update(repr([SOURCE_FLAGS[n] for n in FMAD_SOURCES]).encode())
    return h.hexdigest()[:16]


def unit_library_path(name: str) -> Path:
    return BUILD_DIR / f"libjanus_rhs_{name}.so"


def _fmad_objects(nvcc) -> list:
    """pow_fmad.cu and libm_fmad.cu as relocatable objects for the units,
    compiled once (cached by their hash)."""
    h = hashlib.sha256()
    for name in FMAD_SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
        h.update(" ".join(SOURCE_FLAGS[name]).encode())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    where = BUILD_DIR / f"fmad_{h.hexdigest()[:16]}"
    objs = [where / (Path(n).stem + ".o") for n in FMAD_SOURCES]
    with _fmad_lock:
        if all(o.exists() for o in objs):
            return objs
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
        procs = []
        for name in FMAD_SOURCES:
            cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, *SOURCE_FLAGS[name], "-c",
                   "-o", str(tmp / (Path(name).stem + ".o")),
                   str(CSRC / name)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        for cmd, proc in procs:
            log = proc.communicate()[0]
            if proc.returncode != 0:
                shutil.rmtree(tmp, ignore_errors=True)
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{log}")
        try:
            os.replace(tmp, where)
        except OSError:                 # another process made it first
            shutil.rmtree(tmp, ignore_errors=True)
    return objs


def build_unit(name: str, source: str, verbose: bool = False) -> Path:
    """Compile a generated K4 unit (``ops.rhs_codegen``) into its cached
    shared library; returns its path. The unit's source and ptxas's report
    are kept beside it (``.cu``, ``.ptxas.txt``)."""
    out = unit_library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        src = Path(tmp) / f"rhs_{name}.cu"
        src.write_text(source)
        obj = Path(tmp) / f"rhs_{name}.o"
        cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-Xptxas", "-v", *UNIT_FLAGS,
               "-I", str(CSRC), "-c", "-o", str(obj), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        fmad = _fmad_objects(nvcc)          # while the unit compiles
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{log}")
        lib = Path(tmp) / out.name
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-Xcompiler", "-fPIC", "-o",
               str(lib), str(obj), *map(str, fmad)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        log += res.stdout + res.stderr
        if verbose:
            print(log)
        out.with_suffix(".ptxas.txt").write_text(log)
        out.with_suffix(".cu").write_text(source)
        os.replace(lib, out)
    return out
