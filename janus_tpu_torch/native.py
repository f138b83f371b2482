"""ctypes bindings to the framework-free C++ runtime (``native/janus_native.cpp``
at the root of the repository).

The port's own copy of ``janus_tpu/native/__init__.py``, with the same
functions and the same file format, so that each package reads the other's
trajectory files. The library is compiled with ``g++`` at first use into
``janus_tpu_torch/_build/`` (git-ignored), named by a hash of the source and
the flags, written beside its final name and renamed into place: processes
that build at the same time never load a half-written file. A failed build
raises. Provides:
- ``radau5_cpu``: an independent single-trajectory CPU Radau5 oracle;
- ``traj_write`` / ``traj_read``: the binary trajectory-dataset IO of the
  NN training workflows.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parents[1] / "native" / "janus_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libjanus_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if its cached copy is missing; returns its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"g++ not found: {e}") from e
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({res.returncode}):\n{' '.join(cmd)}"
                           f"\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    dp = ctypes.POINTER(ctypes.c_double)
    i64 = ctypes.c_int64
    lib.radau5_solve_builtin.restype = ctypes.c_int
    lib.radau5_solve_builtin.argtypes = [
        ctypes.c_int, ctypes.c_double, ctypes.c_double, dp, ctypes.c_int,
        dp, ctypes.c_double, ctypes.c_double, ctypes.c_long,
        ctypes.POINTER(ctypes.c_long)]
    lib.traj_write.restype = ctypes.c_int
    lib.traj_write.argtypes = [ctypes.c_char_p, dp, i64, i64]
    lib.traj_info.restype = ctypes.c_int
    lib.traj_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(i64),
                              ctypes.POINTER(i64)]
    lib.traj_read.restype = ctypes.c_int
    lib.traj_read.argtypes = [ctypes.c_char_p, dp, i64]
    _lib = lib
    return lib


RHS_VDP = 0


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def radau5_cpu(rhs_id: int, t0: float, tf: float, y0, params,
               rtol: float = 1e-8, atol: float = 1e-11,
               max_steps: int = 1000000) -> Tuple[np.ndarray, dict]:
    """Solve one trajectory with the native CPU Radau5 oracle; returns the
    final state and the counters (nsteps, naccept, nreject, nfev, njev,
    nlu)."""
    lib = load()
    # the C solver writes the final state in place: always a fresh copy, so
    # the caller's y0 is never overwritten
    y = np.array(y0, np.float64, order="C", copy=True)
    p = np.ascontiguousarray(np.asarray(params, np.float64))
    stats = np.zeros(6, np.int64)
    rc = lib.radau5_solve_builtin(
        rhs_id, t0, tf, _ptr(y), y.size, _ptr(p), rtol, atol, max_steps,
        stats.ctypes.data_as(ctypes.POINTER(ctypes.c_long)))
    if rc != 0:
        raise RuntimeError(f"radau5_cpu failed with code {rc}")
    keys = ("nsteps", "naccept", "nreject", "nfev", "njev", "nlu")
    return y, dict(zip(keys, stats.tolist()))


def traj_write(path: str | os.PathLike, data) -> None:
    """Write a [n_records, record_len] float64 dataset."""
    lib = load()
    arr = np.ascontiguousarray(np.asarray(data, np.float64))
    if arr.ndim != 2:
        raise ValueError("traj_write expects [n_records, record_len]")
    rc = lib.traj_write(str(path).encode(), _ptr(arr), arr.shape[0],
                        arr.shape[1])
    if rc != 0:
        raise RuntimeError(f"traj_write failed with code {rc}")


def traj_read(path: str | os.PathLike) -> np.ndarray:
    """Read a dataset written by ``traj_write`` (of either package)."""
    lib = load()
    n, r = ctypes.c_int64(), ctypes.c_int64()
    rc = lib.traj_info(str(path).encode(), ctypes.byref(n), ctypes.byref(r))
    if rc != 0:
        raise RuntimeError(f"traj_info failed with code {rc}")
    out = np.empty((n.value, r.value), np.float64)
    rc = lib.traj_read(str(path).encode(), _ptr(out), out.size)
    if rc != 0:
        raise RuntimeError(f"traj_read failed with code {rc}")
    return out
