"""Dynamics [ṗ, ẋ] and Jacobians from a user Hamiltonian H(x, p[, u], args),
as ``janus_tpu.ham.core``, on ``torch.func``.

Conventions (the reference's):
- state vector ``y = [p, x]`` with the costate FIRST;
- dynamics are ``ṗ = +∂H/∂x, ẋ = +∂H/∂p``: any PMP sign flips are baked
  into H itself (``pmp_dynamics_u`` is the one exception, with the standard
  signs).

The user H is a per-sample scalar ``H(x, p, args) -> ()`` (a 0-dim tensor,
as ``torch.func.grad`` needs) for x, p of shape [D]. An optimal-control
hook ``u(x, p, args)`` may be folded in. Every derivative is per sample and
vmapped over the leading batch axis with ``in_dims=(0, 0, None)``: args are
not mapped, so a per-lane [M] parameter inside args is not supported.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.func import grad, jacfwd, vmap


def split_px(y):
    """y = [p, x] → (p, x). D must be even over the last axis."""
    dim = y.shape[-1] // 2
    return y[..., :dim], y[..., dim:]


def join_px(p, x):
    return torch.cat([p, x], dim=-1)


def _fold_control(ham: Callable, u: Optional[Callable]) -> Callable:
    if u is None:
        return ham

    def hc(x, p, args):
        return ham(x, p, u(x, p, args), args)

    return hc


def _lane_times(t, y):
    """t (a number or [M]) as an [M] tensor on y's device."""
    return torch.as_tensor(t, dtype=y.dtype, device=y.device).broadcast_to(
        y.shape[:-1])


def _batched(single, mapped):
    """single(t, y, *rest, args) vmapped over t, y and the first
    ``mapped - 2`` of rest; args is not mapped."""
    in_dims = (0,) * mapped + (None,)

    def batched_f(t, y, *rest):
        return vmap(single, in_dims=in_dims)(_lane_times(t, y), y, *rest)

    return batched_f


def hamiltonian_dynamics(ham: Callable, u: Optional[Callable] = None,
                         batched: bool = True) -> Callable:
    """Build ``f(t, y, args) -> [ṗ, ẋ]`` from a scalar Hamiltonian.

    ham: H(x, p, args) -> scalar (or H(x, p, u, args) when ``u`` is given).
    Returns a dynamics function with the solver signature ``f(t, y, args)``;
    with ``batched=True`` it takes y of shape [M, 2D] (t: a number or [M]).
    """
    hc = _fold_control(ham, u)

    def single(t, y, args):
        p, x = split_px(y)
        # one reverse pass for both partials (the reference takes two; the
        # results are equal to the bit)
        gx, gp = grad(lambda xx, pp: hc(xx, pp, args), argnums=(0, 1))(x, p)
        return join_px(gx, gp)  # ṗ = +∂H/∂x, ẋ = +∂H/∂p

    return _batched(single, 2) if batched else single


def hamiltonian_jacobian(ham: Callable, u: Optional[Callable] = None,
                         batched: bool = True) -> Callable:
    """Build ``J(t, y, args) -> ∂f/∂y`` ([2D, 2D] per sample) by
    forward-over-reverse AD (``jacfwd`` of the ``grad``s)."""
    single = hamiltonian_dynamics(ham, u, batched=False)

    def jac_single(t, y, args):
        return jacfwd(lambda yy: single(t, yy, args))(y)

    return _batched(jac_single, 2) if batched else jac_single


# -- individual partials (per sample) ---------------------------------------

def grad_x(ham, u=None):
    hc = _fold_control(ham, u)
    return lambda x, p, args: grad(lambda xx: hc(xx, p, args))(x)


def grad_p(ham, u=None):
    hc = _fold_control(ham, u)
    return lambda x, p, args: grad(lambda pp: hc(x, pp, args))(p)


def hessian_xx(ham, u=None):
    gx = grad_x(ham, u)
    return lambda x, p, args: jacfwd(lambda xx: gx(xx, p, args))(x)


def hessian_pp(ham, u=None):
    gp = grad_p(ham, u)
    return lambda x, p, args: jacfwd(lambda pp: gp(x, pp, args))(p)


def hessian_xp(ham, u=None):
    gx = grad_x(ham, u)
    return lambda x, p, args: jacfwd(lambda pp: gx(x, pp, args))(p)


# -- explicit-control variants: H takes u EXPLICITLY, H(x, p, u, args) -> () -

def grad_u(ham):
    """∂H/∂u for an explicit-control Hamiltonian (per sample; u: [K])."""
    return lambda x, p, u, args: grad(lambda uu: ham(x, p, uu, args))(u)


def hessian_uu(ham):
    gu = grad_u(ham)
    return lambda x, p, u, args: jacfwd(lambda uu: gu(x, p, uu, args))(u)


def hessian_ux(ham):
    """∂²H/∂u∂x (rows: u components, cols: x components)."""
    gu = grad_u(ham)
    return lambda x, p, u, args: jacfwd(lambda xx: gu(xx, p, u, args))(x)


def hessian_up(ham):
    gu = grad_u(ham)
    return lambda x, p, u, args: jacfwd(lambda pp: gu(x, pp, u, args))(p)


def _dynamics_u(ham: Callable, sign: float, batched: bool) -> Callable:
    def single(t, y, u, args):
        p, x = split_px(y)
        gx, gp = grad(lambda xx, pp: ham(xx, pp, u, args),
                      argnums=(0, 1))(x, p)
        return join_px(gx if sign > 0 else -gx, gp)

    return _batched(single, 3) if batched else single


def hamiltonian_dynamics_u(ham: Callable, batched: bool = True) -> Callable:
    """``f(t, y, u, args)`` with an explicit control input, in the baked-sign
    convention (ṗ = +∂H/∂x, ẋ = +∂H/∂p); u is mapped with y."""
    return _dynamics_u(ham, 1.0, batched)


def pmp_dynamics_u(ham: Callable, batched: bool = True) -> Callable:
    """``f(t, y, u, args)`` with the STANDARD PMP signs: ẋ = +∂H/∂p,
    ṗ = −∂H/∂x, for H = L(x, u) + p·f(x, u) written directly (coupled
    p·f(x) terms make baking the signs into one scalar impossible). The
    state layout stays y = [p, x]."""
    return _dynamics_u(ham, -1.0, batched)


def stationarity_residual(ham: Callable, batched: bool = True) -> Callable:
    """PMP interior-arc stationarity residual ``r(x, p, u, args) = ∂H/∂u``
    (zero along an optimal interior arc); stacked over trajectory nodes it
    closes a direct or indirect transcription system."""
    gu = grad_u(ham)
    if not batched:
        return gu

    def batched_r(x, p, u, args):
        return vmap(gu, in_dims=(0, 0, 0, None))(x, p, u, args)

    return batched_r


def safe_dynamics(ham: Callable, u: Optional[Callable] = None,
                  batched: bool = True, fill: float = 0.0) -> Callable:
    """Dynamics with non-finite entries replaced by ``fill``, for
    Hamiltonians with singular points: one bad trajectory does not poison
    the batch with NaNs (the lockstep solver rejects or min-steps that lane
    instead)."""
    f = hamiltonian_dynamics(ham, u, batched)

    def safe(t, y, args):
        dy = f(t, y, args)
        return torch.where(torch.isfinite(dy), dy, fill)

    return safe
