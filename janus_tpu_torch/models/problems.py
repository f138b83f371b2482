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
import torch.nn.functional as F

ROBERTSON_DEFAULTS = {"a": 0.04, "b": 1e4, "c": 3e7}


def _mu(args, y):
    mu = args["mu"] if isinstance(args, dict) else args
    return mu.to(y.dtype) if isinstance(mu, torch.Tensor) else mu


def harmonic_rhs(t, y, args):
    """y = [q, v]: q' = v, v' = −ω² q. args: ω (scalar, [M], or {'omega'})."""
    omega = args["omega"] if isinstance(args, dict) else args
    q, v = y[..., 0], y[..., 1]
    return torch.stack([v, -(omega ** 2) * q], dim=-1)


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


# 2-D method-of-lines problems for the matrix-free stage path: 5-point
# Laplacian stencils on an [ny, nx] grid, Dirichlet-0 boundaries, flattened
# row-major so each grid ROW is one line of length nx
# (Options(precond='lines', precond_block=nx)).

def laplacian_2d(u, nx, ny, dx):
    """5-point Dirichlet-0 Laplacian of u [M, ny*nx] -> [M, ny*nx]."""
    g = u.reshape(u.shape[0], ny, nx)
    left = F.pad(g[:, :, :-1], (1, 0))
    right = F.pad(g[:, :, 1:], (0, 1))
    up = F.pad(g[:, :-1, :], (0, 0, 1, 0))
    down = F.pad(g[:, 1:, :], (0, 0, 0, 1))
    lap = (left + right + up + down - 4.0 * g) / dx ** 2
    return lap.reshape(u.shape)


def heat_2d_rhs(nx, ny, dx):
    """u' = ν·Δu + r·u(1−u) (2-D Fisher-KPP), y [M, ny*nx], args (ν, r)."""
    def rhs(t, y, args):
        nu, r = args
        return nu * laplacian_2d(y, nx, ny, dx) + r * y * (1.0 - y)
    return rhs


def brusselator_2d_rhs(nx, ny, dx):
    """2-D Brusselator, SPECIES-MAJOR layout y = [u (ny·nx), v (ny·nx)]:

        u' = Du·Δu + a − (b+1)·u + u²v
        v' = Dv·Δv + b·u − u²v

    args (a, b, Du, Dv); a/b may carry a batch axis [M] or [M, 1].
    With Options(precond='lines', precond_block=nx) the cross-species
    coupling is diagonal at offset ±ny·nx: choose ny ODD so it lands in the
    opposite line-parity group of the 6-color probe (exact in-line bands).
    """
    def rhs(t, y, args):
        a, b, du_, dv_ = args
        n = nx * ny
        u, v = y[..., :n], y[..., n:]
        a = a[..., None] if getattr(a, "ndim", 0) == 1 else a
        b = b[..., None] if getattr(b, "ndim", 0) == 1 else b
        uu = u * u * v
        fu = du_ * laplacian_2d(u, nx, ny, dx) + a - (b + 1.0) * u + uu
        fv = dv_ * laplacian_2d(v, nx, ny, dx) + b * u - uu
        return torch.cat([fu, fv], dim=-1)
    return rhs


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
