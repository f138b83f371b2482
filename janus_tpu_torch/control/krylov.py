"""Matrix-free Newton–Krylov (the PETSc SNES+GMRES role).

The port of ``janus_tpu/control/krylov.py``: J·v by ``torch.func.jvp``
(exact, no finite difference), a restarted GMRES, a damped outer Newton,
for systems too large for the dense unrolled LU (method-of-lines
residuals, say).

The reference calls ``jax.scipy.sparse.linalg.gmres`` on the whole [M, N]
array: ONE restarted GMRES whose inner products sum over every lane, so
that the lanes share one Krylov space and one stopping test. ``gmres``
below is that algorithm (``solve_method='batched'``): per restart,
``restart`` Arnoldi steps of A(M(v)) with one classical Gram–Schmidt pass
and an early stop at breakdown, the least squares by the normal equations
and a Cholesky factor, then x += V·y and the preconditioned residual; the
restarts stop at ‖M(b − A·x)‖ ≤ max(tol·‖b‖, atol) or after ``maxiter``.
It is not ``linalg.gmres.gmres_batched``, whose lanes are independent. A
host loop with one read an Arnoldi step and one a restart; the Newton has
one read an iteration and one before each Armijo trial (the trials stop
once every running lane accepted, which changes no bit).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from janus_tpu_torch.control.newton import (NewtonResult, atleast_2d,
                                            fnorm_of)
from janus_tpu_torch.solve.common import LOCKSTEP, _HostSyncs, host_any


def _norm(x):
    return torch.sqrt(torch.sum(x * x))


def _safe_normalize(x, thresh=None):
    """(x/‖x‖, ‖x‖), or (0, 0) where ‖x‖ ≤ thresh (default eps)."""
    norm = _norm(x)
    if thresh is None:
        thresh = torch.finfo(x.dtype).eps
    use = norm > thresh
    return (torch.where(use, x / norm, 0.0), torch.where(use, norm, 0.0))


def _restart(matvec, precond, b, x0, unit_residual, residual_norm, restart,
             syncs):
    """One restart: the Arnoldi basis of K(M·A, r0), the projected least
    squares, x0 + V·y, and the new preconditioned residual."""
    dtype = b.dtype
    eps = torch.finfo(dtype).eps
    basis = [unit_residual]
    h_rows = torch.eye(restart, restart + 1, dtype=dtype, device=b.device)
    for k in range(restart):
        v = precond(matvec(basis[k]))
        _, v_norm_0 = _safe_normalize(v)
        vs = torch.stack(basis, dim=-1)
        h = torch.einsum("...n,...->n", vs, v)     # one Gram–Schmidt pass
        v = v - vs @ h
        unit_v, v_norm_1 = _safe_normalize(v, thresh=eps * v_norm_0)
        basis.append(unit_v)
        row = torch.zeros(restart + 1, dtype=dtype, device=b.device)
        row[:k + 1] = h
        row[k + 1] = v_norm_1
        h_rows[k] = row
        if syncs.any(v_norm_1 == 0.0):              # breakdown
            break
    while len(basis) < restart + 1:
        basis.append(torch.zeros_like(b))
    beta_vec = torch.zeros(restart + 1, dtype=dtype, device=b.device)
    beta_vec[0] = residual_norm
    # least squares min ‖Hᵀy − β e₁‖ by the normal equations (H Hᵀ) y = Hβ
    a2 = h_rows @ h_rows.T
    b2 = h_rows @ beta_vec
    chol, info = torch.linalg.cholesky_ex(a2)
    y = torch.cholesky_solve(b2[:, None], chol)[:, 0]
    y = torch.where(info == 0, y, float("nan"))
    x = x0 + torch.stack(basis[:-1], dim=-1) @ y
    unit_residual, residual_norm = _safe_normalize(precond(b - matvec(x)))
    return x, unit_residual, residual_norm


def gmres(matvec: Callable, b, tol: float = 1e-5, atol: float = 0.0,
          restart: int = 20, maxiter: Optional[int] = None,
          precond: Optional[Callable] = None):
    """x with ‖M(b − A·x)‖ ≤ max(tol·‖b‖, atol) by restarted GMRES over
    the whole array b (one Krylov space for all of it), from x0 = 0.
    matvec: v -> A·v, precond: v -> M·v (left), each on b's shape. Raises
    ``NotImplementedError`` inside ``parallel.lockstep``, and so does
    ``newton_krylov``, which calls it."""
    if LOCKSTEP.get() is not None:
        raise NotImplementedError(
            "krylov.gmres cannot run in parallel.lockstep: one Krylov space "
            "over the whole array, whose gates are scalars of that one "
            "system (sharded, they would be norms over every rank's rows)")
    syncs = _HostSyncs()
    pc = precond if precond is not None else (lambda v: v)
    size = b.numel()
    maxiter = 10 * size if maxiter is None else maxiter
    restart = min(restart, size)
    x = torch.zeros_like(b)
    atol = torch.clamp(tol * _norm(b), min=atol)
    unit, rnorm = _safe_normalize(pc(b - matvec(x)))
    k = 0
    while k < maxiter and syncs.any(rnorm > atol):
        x, unit, rnorm = _restart(matvec, pc, b, x, unit, rnorm, restart,
                                  syncs)
        k += 1
    return x


def newton_krylov(f: Callable, x0, tol: float = 1e-8, max_iter: int = 30,
                  gmres_tol: float = 1e-4, gmres_restart: int = 20,
                  gmres_maxiter: int = 40,
                  preconditioner: Optional[Callable] = None,
                  precond: Optional[object] = None,
                  precond_block: int = 4, device=None) -> NewtonResult:
    """Solve f(x)=0 with matrix-free Newton-GMRES, batched over M instances.

    f: [M, N] -> [M, N]. J·v is an exact jvp of the batched residual.
    preconditioner: optional FIXED preconditioner callable v -> M⁻¹v.
    precond: a preconditioner rebuilt at every Newton iteration:
      "block_jacobi" (with precond_block), "tridiag", or a factory
      x -> (v -> M⁻¹v) built from ``control.precond``. A torch x0 stays on
      its device; any other goes to ``device``, by default the CUDA card.
    """
    from janus_tpu_torch.control import precond as _pc

    if precond == "block_jacobi":
        def factory(xx):
            return _pc.block_jacobi_precond(f, xx, precond_block)
    elif precond == "tridiag":
        def factory(xx):
            return _pc.tridiag_precond(f, xx)
    elif callable(precond):
        factory = precond
    elif precond is None:
        factory = None
    else:
        raise ValueError(f"unknown precond {precond!r}")

    x = atleast_2d(x0, device)
    m = x.shape[0]
    dev = x.device
    fn = fnorm_of(f(x))
    convd = torch.zeros(m, dtype=torch.bool, device=dev)
    it = torch.zeros(m, dtype=torch.int32, device=dev)
    running = torch.ones(m, dtype=torch.bool, device=dev)
    while host_any(running):
        def jv(v, _x=x):
            return torch.func.jvp(f, (_x,), (v,))[1]

        m_apply = factory(x) if factory is not None else preconditioner
        step = gmres(jv, -f(x), tol=gmres_tol, restart=gmres_restart,
                     maxiter=gmres_maxiter, precond=m_apply)
        step = torch.where(torch.isfinite(step), step, 0.0)

        # Armijo backtracking (up to 4 trials)
        lam = torch.ones(m, dtype=x.dtype, device=dev)
        best_x = x + step
        best_fn = fnorm_of(f(best_x))
        accepted = best_fn <= (1.0 - 1e-4) * fn
        for _ in range(4):
            if not host_any(running & ~accepted):
                break
            lam = torch.where(accepted, lam, lam * 0.5)
            cand = x + lam[:, None] * step
            cfn = fnorm_of(f(cand))
            better = ~accepted & (cfn < fn)
            best_x = torch.where(better[:, None], cand, best_x)
            best_fn = torch.where(better, cfn, best_fn)
            accepted = accepted | better

        x = torch.where(running[:, None], best_x, x)
        fn = torch.where(running, best_fn, fn)
        it = it + running.to(torch.int32)
        conv_now = running & (fn < tol)
        stalled = running & (it >= max_iter)
        convd = convd | conv_now
        running = running & ~conv_now & ~stalled
    return NewtonResult(x=x, fnorm=fn, converged=convd, iters=it)
