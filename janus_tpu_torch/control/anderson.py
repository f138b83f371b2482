"""Anderson-accelerated fixed-point / nonlinear solver (the NGMRES role).

The port of ``janus_tpu/control/anderson.py``: F(x)=0 as the fixed point of
x → x + βF(x), mixed over a window of the last K iterates and residuals,
with the small K×K least squares solved per lane by ``linalg.linsolve``. The
reference's ``lax.while_loop`` is a host loop with one read an iteration.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from janus_tpu_torch.control.newton import atleast_2d, fnorm_of
from janus_tpu_torch.linalg.smalllu import linsolve
from janus_tpu_torch.solve.common import host_any


@dataclasses.dataclass
class AndersonResult:
    x: torch.Tensor
    fnorm: torch.Tensor
    converged: torch.Tensor
    iters: torch.Tensor


def anderson_solve(f: Callable, x0, window: int = 5, beta: float = 1.0,
                   tol: float = 1e-8, max_iter: int = 200,
                   reg: float = 1e-10, device=None) -> AndersonResult:
    """Solve f(x)=0 with Anderson acceleration; f batched [M, N] -> [M, N].
    A torch x0 stays on its device; any other goes to ``device``, by
    default the CUDA card."""
    x = atleast_2d(x0, device)
    m, n = x.shape
    dtype, dev = x.dtype, x.device
    k_win = window
    slots = torch.arange(k_win, device=dev)
    eye = torch.eye(k_win, dtype=dtype, device=dev)

    # histories of iterates and residuals
    fx = f(x)
    xh = x.new_zeros((m, k_win, n))
    fh = x.new_zeros((m, k_win, n))
    xh[:, 0] = x
    fh[:, 0] = fx
    nh = torch.ones(m, dtype=torch.int32, device=dev)
    convd = torch.zeros(m, dtype=torch.bool, device=dev)
    it = torch.zeros(m, dtype=torch.int32, device=dev)
    running = torch.ones(m, dtype=torch.bool, device=dev)
    while host_any(running):
        kcur = torch.clamp(nh, max=k_win)
        # least squares: minimize ‖Σ α_i f_i‖ s.t. Σ α = 1 via the normal
        # equations on the Gram matrix (small K×K per lane)
        gram = torch.einsum("mkn,mln->mkl", fh, fh)
        valid = slots[None, :] < kcur[:, None]
        vmask = valid[:, :, None] & valid[:, None, :]
        scale = torch.clamp(torch.amax(torch.abs(gram), dim=(-2, -1)),
                            min=1e-300)
        gram = torch.where(vmask, gram,
                           (scale * 1e20)[:, None, None] * eye[None])
        # regularize RELATIVE to the Gram scale (an absolute shift swamps
        # the tiny residual Gram near convergence)
        gram = gram + (reg * scale)[:, None, None] * eye[None]
        alpha = linsolve(gram, valid.to(dtype))
        alpha = alpha / torch.sum(alpha, dim=-1, keepdim=True)
        alpha = torch.where(valid, alpha, 0.0)

        x_new = torch.einsum("mk,mkn->mn", alpha, xh + beta * fh)
        f_new = f(x_new)
        ok = torch.all(torch.isfinite(f_new), dim=-1)
        # fall back to damped Picard where the LS step misbehaves
        x_pic = x + beta * 0.5 * fx
        x_new = torch.where(ok[:, None], x_new, x_pic)
        f_new = torch.where(ok[:, None], f_new, f(x_pic))

        rowsel = (slots[None, :] == (nh % k_win)[:, None])[..., None]
        upd = running
        xh = torch.where(upd[:, None, None] & rowsel, x_new[:, None, :], xh)
        fh = torch.where(upd[:, None, None] & rowsel, f_new[:, None, :], fh)
        x = torch.where(upd[:, None], x_new, x)
        fx = torch.where(upd[:, None], f_new, fx)
        nh = nh + upd.to(torch.int32)
        it = it + upd.to(torch.int32)
        fn = fnorm_of(fx)
        conv_now = running & (fn < tol)
        stalled = running & (it >= max_iter)
        convd = convd | conv_now
        running = running & ~conv_now & ~stalled
    return AndersonResult(x=x, fnorm=fnorm_of(fx), converged=convd,
                          iters=it)
