"""Batched damped Newton for the outer nonlinear systems.

The port of ``janus_tpu/control/newton.py``: Jacobian columns by forward
mode through the residual (which may hold whole adaptive ODE solves: they
are ``torch.func.jvp``-differentiable on the plain route), the pivoted
batched LU of ``linalg.smalllu`` and Armijo backtracking, over M problem
instances in lockstep.

The reference runs the iteration under one ``lax.while_loop``; here it is a
host loop with one read an iteration (``any`` lane still running) and one
read before each Armijo trial. The trials stop once every running lane has
accepted a step (the reference unrolls all ``max_backtracks``, and later
trials change nothing of a lane that accepted), and f(x) is evaluated once
an iteration (the reference writes it twice and XLA merges the two). The
last trial's norm stands in for the reference's fresh norm of the
fallback point, which is the same point. x, fnorm and iters are equal to
the bit to running every trial (``tests/test_torch_control.py``).
``newton_solve.host_syncs`` counts the reads of the last call.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from janus_tpu_torch.linalg.smalllu import lu_factor, lu_ok, lu_solve
from janus_tpu_torch.solve.common import host_any, on_device


@dataclasses.dataclass
class NewtonResult:
    x: torch.Tensor            # [M, N]
    fnorm: torch.Tensor        # [M]
    converged: torch.Tensor    # [M] bool
    iters: torch.Tensor        # [M] int32


def atleast_2d(x0, device=None):
    """x0 as a tensor (``solve.common.on_device``) with a batch axis."""
    x0 = on_device(x0, device)
    return x0.reshape(1, -1) if x0.ndim < 2 else x0


def fnorm_of(fx):
    """‖f‖₂ per lane of a batched residual value [M, N]."""
    return torch.linalg.vector_norm(fx, dim=-1)


def fd_or_ad_jacobian(f: Callable, x, mode: str = "ad"):
    """[M, N, N] Jacobian of a batched residual f: [M, N] -> [M, N].

    'ad': one ``torch.func.vmap`` over ``torch.func.jvp`` of f along the N
    basis directions. 'fd': forward differences with the step
    h = √eps·max(|x_j|, 1).
    """
    n = x.shape[-1]
    if mode == "ad":
        basis = torch.eye(n, dtype=x.dtype, device=x.device)[:, None, :] \
            .expand((n,) + tuple(x.shape))
        cols = torch.func.vmap(
            lambda t: torch.func.jvp(f, (x,), (t,))[1])(basis)
        return torch.movedim(cols, 0, -1)
    eps = math.sqrt(torch.finfo(x.dtype).eps)
    f0 = f(x)
    cols = []
    for j in range(n):
        h = eps * torch.clamp(torch.abs(x[..., j]), min=1.0)
        xp = x.clone()
        xp[..., j] = x[..., j] + h
        cols.append((f(xp) - f0) / h[..., None])
    return torch.stack(cols, dim=-1)


def newton_solve(f: Callable, x0, tol: float = 1e-8, max_iter: int = 50,
                 jac_mode: str = "ad", max_backtracks: int = 8,
                 armijo: float = 1e-4,
                 jac: Optional[Callable] = None,
                 device=None) -> NewtonResult:
    """Solve f(x) = 0 for a batch of instances; f: [M, N] -> [M, N].

    jac: optional user Jacobian ``jac(x) -> [M, N, N]`` replacing the AD/FD
    default, e.g. built from ``solve_radau(tangents=...)`` (one primal solve
    with N tangent directions instead of N jvp's through the solve). A
    torch x0 stays on its device; any other goes to ``device``, by default
    the CUDA card.
    """
    x = atleast_2d(x0, device)
    m = x.shape[0]
    dev = x.device
    syncs = 0
    fn = fnorm_of(f(x))
    convd = torch.zeros(m, dtype=torch.bool, device=dev)
    it = torch.zeros(m, dtype=torch.int32, device=dev)
    running = torch.ones(m, dtype=torch.bool, device=dev)
    while True:
        syncs += 1
        if not host_any(running):
            break
        jmat = jac(x) if jac is not None else fd_or_ad_jacobian(f, x,
                                                                jac_mode)
        lu, piv = lu_factor(jmat)
        ok = lu_ok(lu)
        fx = f(x)
        step = lu_solve(lu, piv, -fx)
        step = torch.where(ok[:, None], step, -fx * 0.01)  # gradient-ish

        # Armijo backtracking, stopped once every running lane accepted
        lam = torch.ones(m, dtype=x.dtype, device=dev)
        best_x = x + step
        best_fn = fnorm_of(f(best_x))
        cfn = best_fn
        accepted = best_fn <= (1.0 - armijo) * fn
        for _ in range(max_backtracks):
            syncs += 1
            if not host_any(running & ~accepted):
                break
            lam = torch.where(accepted, lam, lam * 0.5)
            cand = x + lam[:, None] * step
            cfn = fnorm_of(f(cand))
            better = ~accepted & (cfn <= (1.0 - armijo * lam) * fn)
            best_x = torch.where(better[:, None], cand, best_x)
            best_fn = torch.where(better, cfn, best_fn)
            accepted = accepted | better
        # nothing passed Armijo: the last (most damped) candidate, whose
        # norm the last trial computed
        fallback = ~accepted
        best_x = torch.where(fallback[:, None], x + lam[:, None] * step,
                             best_x)
        best_fn = torch.where(fallback, cfn, best_fn)

        x = torch.where(running[:, None], best_x, x)
        fn = torch.where(running, best_fn, fn)
        it = it + running.to(torch.int32)
        conv_now = running & (fn < tol)
        stalled = running & (it >= max_iter)
        convd = convd | conv_now
        running = running & ~conv_now & ~stalled
    newton_solve.host_syncs = syncs
    return NewtonResult(x=x, fnorm=fn, converged=convd, iters=it)


newton_solve.host_syncs = 0
