"""Canonical test problems (the subset the ported slice uses).

All RHS are batched: f(t[M], y[M,D], args) -> [M,D]. ``args`` follows the
reference's conventions: a scalar, an [M] tensor, or ``{"mu": …}``.
"""

from __future__ import annotations

import torch


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
