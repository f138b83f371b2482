"""Canonical test problems (the subset the ported slice uses).

All RHS are batched: f(t[M], y[M,D], args) -> [M,D]. ``args`` follows the
reference's conventions: a scalar, an [M] tensor, or a dict of them.

``DEVICE_PROBLEMS`` is the device-problem registry of the fused Radau5 step
(``solve_ivp(method='radau_fused')`` on a CUDA tensor): it maps a port RHS
to the CUDA functor of ``csrc/problems.cuh`` that computes the same f on
the card, with the functor's parameters by name in the functor's order. To
add a problem, write the torch RHS here, its functor template in
``problems.cuh`` (registered in ``csrc/radau_fused.cu``'s dispatch), and a
``DeviceProblem`` entry below.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

ROBERTSON_DEFAULTS = {"a": 0.04, "b": 1e4, "c": 3e7}


def _mu(args, y):
    mu = args["mu"] if isinstance(args, dict) else args
    return mu.to(y.dtype) if isinstance(mu, torch.Tensor) else mu


def vdp_rhs(t, y, args):
    """Stiff Van der Pol: y0' = y1, y1' = μ((1−y0²)y1) − y0. args: μ [M] or scalar."""
    mu = _mu(args, y)
    x, v = y[..., 0], y[..., 1]
    return torch.stack([v, mu * (1.0 - x * x) * v - x], dim=-1)


def vdp_jac(t, y, args):
    """Analytic Jacobian [M,2,2] of vdp_rhs."""
    mu = _mu(args, y)
    x, v = y[..., 0], y[..., 1]
    row0 = torch.stack([torch.zeros_like(x), torch.ones_like(x)], dim=-1)
    row1 = torch.stack([-2.0 * mu * x * v - 1.0, mu * (1.0 - x * x)], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def _vdp_params(args):
    return (args["mu"] if isinstance(args, dict) else args,)


def _robertson_params(args):
    """(a, b, c): from a dict by name, each defaulting to the classic rate;
    any other args (None included) give the defaults, as the reference."""
    given = args if isinstance(args, dict) else {}
    return tuple(given.get(k, v) for k, v in ROBERTSON_DEFAULTS.items())


def robertson_rhs(t, y, args):
    """Robertson chemical kinetics — the canonical extreme-stiffness test.
    y = [y1, y2, y3], rates (a, b, c) from args or the classic defaults."""
    a, b, c = (p.to(y.dtype) if isinstance(p, torch.Tensor) else p
               for p in _robertson_params(args))
    y1, y2, y3 = y[..., 0], y[..., 1], y[..., 2]
    d1 = -a * y1 + b * y2 * y3
    d3 = c * y2 * y2
    return torch.stack([d1, -d1 - d3, d3], dim=-1)


@dataclasses.dataclass(frozen=True)
class DeviceProblem:
    """A port RHS as the fused-step kernel evaluates it on the card."""

    functor: str                       # name in csrc/radau_fused.cu's dispatch
    dim: int                           # D
    params: Tuple[str, ...]            # parameter names, functor order
    values: Callable[..., tuple]       # args -> one value per name (scalar or [M])


DEVICE_PROBLEMS = {
    vdp_rhs: DeviceProblem("vdp", 2, ("mu",), _vdp_params),
    robertson_rhs: DeviceProblem("robertson", 3, tuple(ROBERTSON_DEFAULTS),
                                 _robertson_params),
}
