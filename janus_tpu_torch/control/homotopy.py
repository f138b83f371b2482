"""Adaptive homotopy / continuation driver.

The port of ``janus_tpu/control/homotopy.py``: one lockstep driver in which
each of the M instances tracks its own λ ∈ [0, 1] with an adaptive step,
corrected by a fixed number of Newton iterations at each λ; failed
corrections halve Δλ, easy ones grow it. The reference's ``lax.while_loop``
is a host loop with one read an iteration.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from janus_tpu_torch.control.newton import (atleast_2d, fd_or_ad_jacobian,
                                            fnorm_of)
from janus_tpu_torch.linalg.smalllu import lu_factor, lu_ok, lu_solve
from janus_tpu_torch.solve.common import host_any


@dataclasses.dataclass
class HomotopyResult:
    x: torch.Tensor
    lam: torch.Tensor          # [M] final λ reached (1.0 = success)
    converged: torch.Tensor
    iters: torch.Tensor


def homotopy(g: Callable, x0, dlam0: float = 0.1, tol: float = 1e-8,
             newton_iters: int = 8, max_steps: int = 200,
             dlam_min: float = 1e-6, jac_mode: str = "ad",
             dlam_fn: Optional[Callable] = None,
             device=None) -> HomotopyResult:
    """Track g(x, λ)=0 from λ=0 to λ=1.

    g: batched ``g(x [M, N], lam [M]) -> [M, N]``; x0 must satisfy
    g(x0, 0)≈0. dlam_fn: optional continuation-step policy ``(x [M, N],
    lam [M], dlam [M]) -> dlam_next [M]`` consulted after each ACCEPTED
    point (the hook for a learned step controller); failed corrections still
    halve Δλ. Default: the reactive grow rule min(1.5·Δλ, 0.25). A torch x0
    stays on its device; any other goes to ``device``, by default the CUDA
    card.
    """
    x = atleast_2d(x0, device)
    m = x.shape[0]
    dev = x.device

    def correct(x, lam):
        """fixed-iteration Newton at fixed λ; returns (x, ok)."""
        for _ in range(newton_iters):
            jmat = fd_or_ad_jacobian(lambda xx: g(xx, lam), x, jac_mode)
            lu, piv = lu_factor(jmat)
            ok = lu_ok(lu)
            step = lu_solve(lu, piv, -g(x, lam))
            x = x + torch.where(ok[:, None], step, 0.0)
        res = fnorm_of(g(x, lam))
        return x, torch.isfinite(res) & (res < tol)

    lam = torch.zeros(m, dtype=x.dtype, device=dev)
    dlam = torch.full((m,), dlam0, dtype=x.dtype, device=dev)
    it = torch.zeros(m, dtype=torch.int32, device=dev)
    running = torch.ones(m, dtype=torch.bool, device=dev)
    while host_any(running):
        lam_try = torch.clamp(lam + dlam, max=1.0)
        x_cand, ok = correct(x, lam_try)
        adv = running & ok
        x = torch.where(adv[:, None], x_cand, x)
        lam = torch.where(adv, lam_try, lam)
        if dlam_fn is None:
            dlam_grow = torch.clamp(dlam * 1.5, max=0.25)
        else:
            dlam_grow = torch.clamp(dlam_fn(x, lam, dlam), dlam_min, 1.0)
        dlam_new = torch.where(adv, dlam_grow, dlam * 0.5)
        dlam = torch.where(running, dlam_new, dlam)
        it = it + running.to(torch.int32)
        done = running & (lam >= 1.0)
        failed = running & (dlam < dlam_min)
        exhausted = running & (it >= max_steps)
        running = running & ~done & ~failed & ~exhausted
    return HomotopyResult(x=x, lam=lam, converged=lam >= 1.0, iters=it)


def convex_homotopy(f: Callable, x0):
    """The SSSC convex homotopy G(x, λ) = λ·F(x) + (1−λ)·(x−x₀)
    (G(·, 0) has the trivial root x₀)."""
    x0 = atleast_2d(x0)

    def g(x, lam):
        return lam[:, None] * f(x) + (1.0 - lam)[:, None] * (x - x0)

    return g
