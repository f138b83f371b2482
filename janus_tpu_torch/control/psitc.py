"""Pseudo-transient continuation (Ψtc) with SER-A / SER-B controllers.

The port of ``janus_tpu/control/psitc.py``. Kelley's Ψtc globalizes Newton
on F(x)=0 by solving (I/δₖ + J(xₖ))·s = −F(xₖ) and evolving the
pseudo-timestep δ from residual norms:

- SER-A:  δₖ₊₁ = δₖ · ‖F(xₖ)‖ / ‖F(xₖ₊₁)‖      (switched evolution relaxation)
- SER-B:  δₖ₊₁ = δ₀ / ‖F(xₖ₊₁)‖                 (inverse-residual rule)

both clipped to [δ_min, δ_max]; batched over M instances in lockstep. The
reference's ``lax.while_loop`` is a host loop with one read an iteration.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from janus_tpu_torch.control.newton import (atleast_2d, fd_or_ad_jacobian,
                                            fnorm_of)
from janus_tpu_torch.linalg.smalllu import lu_factor, lu_ok, lu_solve
from janus_tpu_torch.solve.common import host_any


@dataclasses.dataclass
class PsitcResult:
    x: torch.Tensor
    fnorm: torch.Tensor
    converged: torch.Tensor
    iters: torch.Tensor
    delta: torch.Tensor


def psitc(f: Callable, x0, delta0: float = 1e-2, controller: str = "ser-b",
          tol: float = 1e-8, max_iter: int = 200, delta_max: float = 1e6,
          delta_min: float = 1e-12, jac_mode: str = "ad",
          device=None) -> PsitcResult:
    """Solve f(x)=0 by Ψtc; f: [M, N] -> [M, N] batched. A torch x0 stays on
    its device; any other goes to ``device``, by default the CUDA card."""
    if controller not in ("ser-a", "ser-b"):
        raise ValueError(f"unknown Ψtc controller {controller!r}")
    x = atleast_2d(x0, device)
    m, n = x.shape
    dev = x.device
    eye = torch.eye(n, dtype=x.dtype, device=dev)
    fn = fnorm_of(f(x))
    delta = torch.full((m,), delta0, dtype=x.dtype, device=dev)
    convd = torch.zeros(m, dtype=torch.bool, device=dev)
    it = torch.zeros(m, dtype=torch.int32, device=dev)
    running = torch.ones(m, dtype=torch.bool, device=dev)
    while host_any(running):
        jmat = fd_or_ad_jacobian(f, x, jac_mode)
        amat = eye[None] / delta[:, None, None] + jmat
        lu, piv = lu_factor(amat)
        ok = lu_ok(lu)
        step = lu_solve(lu, piv, -f(x))
        x_cand = x + torch.where(ok[:, None], step, 0.0)
        fn_cand = fnorm_of(f(x_cand))
        # reject a step that blows up: halve delta instead
        good = ok & torch.isfinite(fn_cand) & (fn_cand < 4.0 * fn)
        x_new = torch.where((running & good)[:, None], x_cand, x)
        fn_new = torch.where(running & good, fn_cand, fn)
        if controller == "ser-a":
            delta_new = delta * fn / torch.clamp(fn_new, min=1e-300)
        else:
            delta_new = delta0 / torch.clamp(fn_new, min=1e-300)
        delta_new = torch.where(good, delta_new, delta * 0.5)
        delta_new = torch.clamp(delta_new, delta_min, delta_max)
        delta = torch.where(running, delta_new, delta)
        x, fn = x_new, fn_new
        it = it + running.to(torch.int32)
        conv_now = running & (fn < tol)
        stalled = running & (it >= max_iter)
        convd = convd | conv_now
        running = running & ~conv_now & ~stalled
    return PsitcResult(x=x, fnorm=fn, converged=convd, iters=it, delta=delta)
