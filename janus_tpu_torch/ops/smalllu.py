"""Batched small-matrix LU in the SoA layout: the CUDA kernels K1/K2/K3 and
their plain torch twins.

The counterpart of ``janus_tpu/ops/smalllu_pallas.py``. Signatures keep the
reference's SoA layout with the trajectory on the last axis: a_t / lu_t
[D·D, M] (row-major matrix entries), b_t / x_t [D, M]. Pivot-free.

- ``lu_factor_t`` (K1), ``lu_solve_t`` (K2) and ``linsolve_fused`` (K3)
  launch the kernels of ``csrc/smalllu.cu`` for a CUDA tensor, or raise; for
  a CPU tensor they run the twins ``lu_factor_t_ref`` / ``lu_solve_t_ref`` /
  ``linsolve_fused_ref``. Nothing else selects the twin: a kernel that fails
  to build or launch raises.
- D = 1..16 run kernels instantiated for their D (unrolled, in registers);
  any larger D runs the kernels' run-time-D form, one lane a thread in
  place in device memory (K3 on a work copy of A), with the same
  arithmetic.
- Each wrapper counts its kernel launches in ``.launches`` (a plain int).
- The kernels have no derivative rule (the reference's ``pallas_call`` has
  JVP and batching rules; these are raw launches). So a CUDA launch is
  refused with a ValueError (``refuse_derivatives``) when an input carries
  a derivative: it requires grad while grad mode is on, it is a forward-AD
  dual, or a ``torch.func`` transform wraps it. The result would otherwise
  carry no tangent and no grad_fn, and the derivative would be lost
  silently. The ways out: the solvers' IND sweeps (``tangents=``,
  ``args_tangents=``), which call the kernels on plain tensors, or the plain
  route (``Options(kernel_lu=False)``).

Arithmetic (kernels and twins): K1/K2 that of ``janus_tpu.linalg.smalllu``
with pivot=False — divide by the pivot / diagonal, zero guarded to 1. K3 that
of the reference's own fused kernel: multiplier ``a[i][k] * (1/a[k][k])``
with no zero guard, b eliminated in the same loop, back substitution
dividing by the diagonal. The kernels are built without FMA contraction
and do the twins' IEEE operations: on the card they agree to the bit.
"""

from __future__ import annotations

import math

import torch
from torch.autograd import forward_ad

from janus_tpu_torch.solve.common import tree_leaves

MAX_UNROLLED_D = 16   # D = 1..16 unroll in registers; above, D at run time
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}


def _dim(n: int, what: str) -> int:
    d = math.isqrt(n)
    if d * d != n:
        raise ValueError(f"{what}: leading axis {n} is not D·D")
    return d


def lu_factor_t_ref(a_t):
    """Plain torch twin of K1: packed pivot-free L\\U of a_t [D·D, M]."""
    d = _dim(a_t.shape[0], "lu_factor_t")
    a = [[a_t[i * d + j] for j in range(d)] for i in range(d)]
    for k in range(d):
        piv = a[k][k]
        safe = torch.where(piv == 0.0, 1.0, piv)
        for i in range(k + 1, d):
            mult = a[i][k] / safe
            a[i][k] = mult
            for j in range(k + 1, d):
                a[i][j] = a[i][j] - mult * a[k][j]
    return torch.stack([a[i][j] for i in range(d) for j in range(d)])


def lu_solve_t_ref(lu_t, b_t):
    """Plain torch twin of K2: x_t [D, M] from K1's factors and b_t [D, M]."""
    d = _dim(lu_t.shape[0], "lu_solve_t")
    v = [b_t[i] for i in range(d)]
    for i in range(1, d):
        for j in range(i):
            v[i] = v[i] - lu_t[i * d + j] * v[j]
    for i in reversed(range(d)):
        for j in range(i + 1, d):
            v[i] = v[i] - lu_t[i * d + j] * v[j]
        diag = lu_t[i * d + i]
        v[i] = v[i] / torch.where(diag == 0.0, 1.0, diag)
    return torch.stack(v)


def linsolve_fused_ref(a_t, b_t):
    """Plain torch twin of K3: x_t [D, M] solving A x = b, one pass."""
    d = _dim(a_t.shape[0], "linsolve_fused")
    a = [[a_t[i * d + j] for j in range(d)] for i in range(d)]
    b = [b_t[i] for i in range(d)]
    for k in range(d):
        inv = a[k][k].new_tensor(1.0) / a[k][k]
        for i in range(k + 1, d):
            mult = a[i][k] * inv
            for j in range(k + 1, d):
                a[i][j] = a[i][j] - mult * a[k][j]
            b[i] = b[i] - mult * b[k]
    x = [None] * d
    for i in reversed(range(d)):
        acc = b[i]
        for j in range(i + 1, d):
            acc = acc - a[i][j] * x[j]
        x[i] = acc / a[i][i]
    return torch.stack(x)


def derivative_carrier(t):
    """Why the tensor t carries a derivative that a raw kernel launch would
    drop ("wrapped by a torch.func transform", "requires grad", "is a
    forward-AD dual"), or None."""
    if not isinstance(t, torch.Tensor):
        return None
    if torch._C._functorch.is_functorch_wrapped_tensor(t):
        return "is wrapped by a torch.func transform (jvp, vmap, grad)"
    if t.requires_grad and torch.is_grad_enabled():
        return "requires grad while grad mode is on"
    if forward_ad.unpack_dual(t).tangent is not None:
        return "is a forward-AD dual"
    return None


def refuse_derivatives(name, *trees):
    """Raise ValueError when a tensor leaf of ``trees`` carries a derivative
    (``derivative_carrier``): the kernels K1-K4 have no derivative rule."""
    for leaf in tree_leaves(trees):
        why = derivative_carrier(leaf)
        if why is not None:
            raise ValueError(
                f"{name}: an input {why}, and the CUDA kernels K1-K4 have no "
                "derivative rule (the result would carry no tangent and no "
                "grad_fn). Take forward sensitivities with the solvers' IND "
                "sweep (tangents=, args_tangents=), or differentiate on the "
                "plain route (Options(kernel_lu=False))")


def _check_cuda(name, *ts):
    for t in ts:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: tensor on {t.device}, expected CUDA")
        if t.device != ts[0].device:
            raise ValueError(f"{name}: tensors on {ts[0].device} and "
                             f"{t.device}")
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"{name}: dtype {t.dtype} (kernel takes float32 "
                            "or float64)")
        if t.dtype != ts[0].dtype:
            raise TypeError(f"{name}: mixed dtypes {ts[0].dtype}, {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: input must be contiguous (the SoA "
                             "boundary makes it so)")


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed "
                           f"(cudaError {rc})")


def lu_factor_t(a_t):
    """K1: packed pivot-free L\\U in the SoA layout [D·D, M]."""
    if a_t.ndim != 2:
        raise ValueError(f"lu_factor_t: a_t must be [D·D, M], got "
                         f"{tuple(a_t.shape)}")
    d = _dim(a_t.shape[0], "lu_factor_t")
    if a_t.device.type == "cpu":
        return lu_factor_t_ref(a_t)
    refuse_derivatives("lu_factor_t (K1)", a_t)
    _check_cuda("lu_factor_t", a_t)
    out = torch.empty_like(a_t)
    m = a_t.shape[1]
    if m == 0:
        return out
    from janus_tpu_torch.ops._build import load_library
    lib = load_library()
    with torch.cuda.device(a_t.device):
        rc = lib.janus_lu_factor_t(
            a_t.data_ptr(), out.data_ptr(), d, m, _DTYPE_CODE[a_t.dtype],
            torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "lu_factor_t")
    lu_factor_t.launches += 1
    return out


def lu_solve_t(lu_t, b_t):
    """K2: substitution with packed SoA factors lu_t [D·D, M], b_t [D, M]."""
    if lu_t.ndim != 2 or b_t.ndim != 2:
        raise ValueError("lu_solve_t: lu_t must be [D·D, M] and b_t [D, M]")
    d = _dim(lu_t.shape[0], "lu_solve_t")
    if b_t.shape != (d, lu_t.shape[1]):
        raise ValueError(f"lu_solve_t: b_t {tuple(b_t.shape)} does not match "
                         f"lu_t {tuple(lu_t.shape)}")
    if lu_t.device.type == "cpu" and b_t.device.type == "cpu":
        return lu_solve_t_ref(lu_t, b_t)
    refuse_derivatives("lu_solve_t (K2)", lu_t, b_t)
    _check_cuda("lu_solve_t", lu_t, b_t)
    out = torch.empty_like(b_t)
    m = b_t.shape[1]
    if m == 0:
        return out
    from janus_tpu_torch.ops._build import load_library
    lib = load_library()
    with torch.cuda.device(b_t.device):
        rc = lib.janus_lu_solve_t(
            lu_t.data_ptr(), b_t.data_ptr(), out.data_ptr(), d, m,
            _DTYPE_CODE[b_t.dtype], torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "lu_solve_t")
    lu_solve_t.launches += 1
    return out


def linsolve_fused(a_t, b_t):
    """K3: x_t [D, M] solving A x = b for a_t [D·D, M], b_t [D, M] in one
    pass (factor and solve fused; nothing but x is written)."""
    if a_t.ndim != 2 or b_t.ndim != 2:
        raise ValueError("linsolve_fused: a_t must be [D·D, M] and b_t "
                         "[D, M]")
    d = _dim(a_t.shape[0], "linsolve_fused")
    if b_t.shape != (d, a_t.shape[1]):
        raise ValueError(f"linsolve_fused: b_t {tuple(b_t.shape)} does not "
                         f"match a_t {tuple(a_t.shape)}")
    if a_t.device.type == "cpu" and b_t.device.type == "cpu":
        return linsolve_fused_ref(a_t, b_t)
    refuse_derivatives("linsolve_fused (K3)", a_t, b_t)
    _check_cuda("linsolve_fused", a_t, b_t)
    out = torch.empty_like(b_t)
    m = b_t.shape[1]
    if m == 0:
        return out
    # the run-time-D kernel eliminates a copy of A in place
    work = torch.empty_like(a_t) if d > MAX_UNROLLED_D else None
    from janus_tpu_torch.ops._build import load_library
    lib = load_library()
    with torch.cuda.device(b_t.device):
        rc = lib.janus_linsolve_fused(
            a_t.data_ptr(), b_t.data_ptr(), out.data_ptr(),
            None if work is None else work.data_ptr(), d, m,
            _DTYPE_CODE[b_t.dtype], torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "linsolve_fused")
    linsolve_fused.launches += 1
    return out


lu_factor_t.launches = 0
lu_solve_t.launches = 0
linsolve_fused.launches = 0


def reset_launch_counts():
    lu_factor_t.launches = 0
    lu_solve_t.launches = 0
    linsolve_fused.launches = 0
