"""Canonical test problems: Van der Pol (the reference workload), the
harmonic oscillator, Robertson, the Hamiltonians of ``ham``, Dubins,
Brusselator, Pleiades, the Hairer II stiff set (HIRES, Oregonator, E5) and
the 2-D method-of-lines grids.

All RHS are batched: f(t[M], y[M,D], args) -> [M,D]. ``args`` follows the
reference's conventions: a scalar, an [M] tensor, or a dict of them.

``DEVICE_PROBLEMS`` maps the two right-hand sides the fused Radau5 step
(``solve_ivp(method='radau_fused')`` on a CUDA tensor) runs through a
hand-written CUDA functor (``csrc/problems.cuh``, dispatched by name in
``csrc/radau_fused.cu``, its parameters by name in the functor's order).
Every other f, these library RHS and a user's alike, runs through a
functor ``ops.rhs_codegen`` generates from its trace (D <= 8); an entry
here is needed only to keep a hand-written functor.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from janus_tpu_torch.solve.common import like

ROBERTSON_DEFAULTS = {"a": 0.04, "b": 1e4, "c": 3e7}


def _mu(args, y):
    mu = args["mu"] if isinstance(args, dict) else args
    return mu.to(y.dtype) if isinstance(mu, torch.Tensor) else mu


def harmonic_hamiltonian(x, p, args):
    """H = (p² + ω²x²)/2 per sample; x, p shape [1]."""
    omega = args["omega"] if isinstance(args, dict) else args
    return 0.5 * (torch.sum(p * p) + omega ** 2 * torch.sum(x * x))


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


def vdp_hamiltonian(x, p, args):
    """PMP-style Hamiltonian whose dynamics reproduce the augmented VdP
    system (costates ride along): H = p·f(x), with the sign convention
    baked in. x: [2] state, p: [2] costate; args: {'mu': μ} or μ (a scalar:
    ``ham`` does not map args over the batch)."""
    mu = args["mu"] if isinstance(args, dict) else args
    f0 = x[1]
    f1 = mu * (1.0 - x[0] ** 2) * x[1] - x[0]
    return p[0] * f0 + p[1] * f1


def dubins_rhs(t, y, args):
    """Dubins car [x, y, θ] with turn-rate control from args:
    args = {'v': speed, 'u': callable u(t) or scalar}, or the control
    alone. Batched."""
    v = args.get("v", 1.0) if isinstance(args, dict) else 1.0
    u = args["u"] if isinstance(args, dict) else args
    uval = u(t) if callable(u) else u
    th = y[..., 2]
    return torch.stack([v * torch.cos(th), v * torch.sin(th),
                        like(uval, th).broadcast_to(th.shape)], dim=-1)


def dubins_pmp_rhs(t, y, args):
    """Smoothed min-time Dubins PMP system, y = [x, y, θ, p1, p2, p3]:
    u* = −umax·tanh(p3/ε) (bang-bang as ε → 0, reached by homotopy)."""
    v = args.get("v", 1.0)
    umax = args.get("umax", 1.0)
    eps = args.get("eps", 0.1)
    th, p1, p2, p3 = y[..., 2], y[..., 3], y[..., 4], y[..., 5]
    u = -umax * torch.tanh(p3 / eps)
    zero = torch.zeros_like(th)
    return torch.stack([
        v * torch.cos(th), v * torch.sin(th), u, zero, zero,
        p1 * v * torch.sin(th) - p2 * v * torch.cos(th),
    ], dim=-1)


def brusselator_rhs(t, y, args):
    """Brusselator oscillator: x' = a + x²y − (b+1)x, y' = bx − x²y.
    args: {'a', 'b'} (defaults 1 and 3) or b alone."""
    a = args.get("a", 1.0) if isinstance(args, dict) else 1.0
    b = args.get("b", 3.0) if isinstance(args, dict) else args
    x, z = y[..., 0], y[..., 1]
    return torch.stack([a + x * x * z - (b + 1.0) * x, b * x - x * x * z],
                       dim=-1)


def pleiades_rhs(t, y, args):
    """Pleiades 7-body problem (Hairer's non-stiff test set):
    y = [q (14), v (14)]."""
    q, v = y[..., :14], y[..., 14:]
    x = q[..., :7]
    z = q[..., 7:]
    masses = torch.arange(1.0, 8.0, dtype=y.dtype, device=y.device)
    dx = x[..., :, None] - x[..., None, :]
    dz = z[..., :, None] - z[..., None, :]
    r2 = dx * dx + dz * dz + torch.eye(7, dtype=y.dtype, device=y.device)
    r32 = r2 ** 1.5
    ax = torch.sum(masses[None, None, :] * dx / r32, dim=-1) * -1.0
    az = torch.sum(masses[None, None, :] * dz / r32, dim=-1) * -1.0
    return torch.cat([v, ax, az], dim=-1)


# -- Hairer II stiff test set ----------------------------------------------
# Published benchmark problems (Hairer & Wanner, "Solving ODEs II", 1996;
# also the Bari IVP test set): the published problem definitions.

HIRES_Y0 = (1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0057)
HIRES_TF = 321.8122


def hires_rhs(t, y, args):
    """HIRES (High Irradiance RESponse, 8 species plant-physiology
    kinetics): the Hairer II 'chemistry' stiff benchmark."""
    y1, y2, y3, y4, y5, y6, y7, y8 = [y[..., i] for i in range(8)]
    r67 = 280.0 * y6 * y8
    return torch.stack([
        -1.71 * y1 + 0.43 * y2 + 8.32 * y3 + 0.0007,
        1.71 * y1 - 8.75 * y2,
        -10.03 * y3 + 0.43 * y4 + 0.035 * y5,
        8.32 * y2 + 1.71 * y3 - 1.12 * y4,
        -1.745 * y5 + 0.43 * y6 + 0.43 * y7,
        -r67 + 0.69 * y4 + 1.71 * y5 - 0.43 * y6 + 0.69 * y7,
        r67 - 1.81 * y7,
        -r67 + 1.81 * y7,
    ], dim=-1)


OREGO_Y0 = (1.0, 2.0, 3.0)
OREGO_TF = 360.0


def orego_rhs(t, y, args):
    """Oregonator (Belousov-Zhabotinsky 3-species limit cycle): stiff, with
    state magnitudes swinging over 5 decades along the orbit."""
    y1, y2, y3 = y[..., 0], y[..., 1], y[..., 2]
    return torch.stack([
        77.27 * (y2 + y1 * (1.0 - 8.375e-6 * y1 - y2)),
        (y3 - (1.0 + y1) * y2) / 77.27,
        0.161 * (y1 - y3),
    ], dim=-1)


E5_Y0 = (1.76e-3, 0.0, 0.0, 0.0)
E5_TF = 1e3      # the classic horizon is 1e13; 1e3 already has the cliff


def e5_rhs(t, y, args):
    """E5 chemical pyrolysis (Hairer II): extreme dynamic range (the
    classic atol is ~1.7e-24), here on a shortened horizon as a test of
    the error weighting."""
    y1, y2, y3, y4 = y[..., 0], y[..., 1], y[..., 2], y[..., 3]
    a, b, c, m_ = 7.89e-10, 1.1e7, 1.13e3, 1.0e6
    d1 = -a * y1 - b * y1 * y3
    d2 = a * y1 - m_ * c * y2 * y3
    d4 = b * y1 * y3 - c * y4
    d3 = d2 - d4
    return torch.stack([d1, d2, d3, d4], dim=-1)


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
