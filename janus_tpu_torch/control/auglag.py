"""Augmented Lagrangian for equality-constrained minimization.

The port of ``janus_tpu/control/auglag.py``: minimize f(x) s.t. c(x)=0 via
L_A(x; λ, μ) = f + λᵀc + (μ/2)‖c‖²; the inner solve is the damped Newton
of ``control.newton`` on ∇ₓL_A (its Jacobian, the Hessian, by forward over
reverse: ``torch.func.jvp`` of ``torch.func.grad``), the outer update
λ ← λ + μ·c, with μ escalated where the violation decays too slowly.
Batched over M instances.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from janus_tpu_torch.control.newton import atleast_2d, newton_solve


@dataclasses.dataclass
class AugLagResult:
    x: torch.Tensor
    lam: torch.Tensor          # [M, C] multipliers
    cviol: torch.Tensor        # [M] final ‖c(x)‖∞
    converged: torch.Tensor
    outer_iters: int


def augmented_lagrangian(obj: Callable, con: Callable, x0,
                         mu0: float = 10.0, outer_iters: int = 10,
                         inner_tol: float = 1e-9, inner_iters: int = 40,
                         ctol: float = 1e-8, mu_growth: float = 10.0,
                         device=None) -> AugLagResult:
    """obj: [M, N] -> [M] batched objective; con: [M, N] -> [M, C] equality
    constraints. A torch x0 stays on its device; any other goes to
    ``device``, by default the CUDA card."""
    x = atleast_2d(x0, device)
    m = x.shape[0]
    ncon = con(x).shape[-1]
    lam = x.new_zeros((m, ncon))
    mu = x.new_full((m,), mu0)
    prev_viol = x.new_full((m,), float("inf"))

    def grad_la(x, lam, mu):
        def la_sum(xx):
            c = con(xx)
            return torch.sum(obj(xx) + torch.sum(lam * c, -1)
                             + 0.5 * mu * torch.sum(c * c, -1))
        return torch.func.grad(la_sum)(x)

    for _ in range(outer_iters):      # the outer loop is short and static
        res = newton_solve(lambda xx: grad_la(xx, lam, mu), x,
                           tol=inner_tol, max_iter=inner_iters)
        x = res.x
        c = con(x)
        viol = torch.amax(torch.abs(c), dim=-1)
        lam = lam + mu[:, None] * c
        slow = viol > 0.25 * prev_viol
        mu = torch.where(slow, mu * mu_growth, mu)
        prev_viol = viol

    return AugLagResult(x=x, lam=lam, cviol=prev_viol,
                        converged=prev_viol < ctol, outer_iters=outer_iters)
