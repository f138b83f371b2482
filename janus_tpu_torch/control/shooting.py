"""Single and multiple shooting for two-point BVPs (PMP optimal control).

The port of ``janus_tpu/control/shooting.py``: ALL segments of ALL
instances integrate in one lockstep batch (an M instances × S segments
solve is one ``solve_ivp`` call of batch M·S with per-lane (t0, tf)), and
the outer Newton differentiates through it.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from janus_tpu_torch.control.newton import NewtonResult, newton_solve
from janus_tpu_torch.solve.common import like, tree_map
from janus_tpu_torch.solve.options import Options


def single_shooting(residual: Callable, u0, tol: float = 1e-8,
                    max_iter: int = 30, jac_mode: str = "ad",
                    device=None) -> NewtonResult:
    """Newton on a user-built shooting residual ``residual(u [M, N]) ->
    [M, N]`` (typically: integrate the Hamiltonian system from the initial
    guesses in u and return the boundary/transversality defects)."""
    return newton_solve(residual, u0, tol=tol, max_iter=max_iter,
                        jac_mode=jac_mode, device=device)


def multiple_shooting_residual(f: Callable, t_nodes, y_bc: Callable,
                               method: str = "radau", args: Any = None,
                               options: Optional[Options] = None):
    """Build the batched multiple-shooting residual.

    f        : batched RHS (solver signature)
    t_nodes  : [S+1] shooting mesh over [t0, tf] (made a tensor of z's
               dtype on z's device; a tensor elsewhere is refused)
    y_bc     : ``y_bc(y_start [M, D], y_end [M, D]) -> [M, B]`` boundary
               residual (B + (S-1)·D == S·D, so that the system is square in
               the unknown segment starts)

    Returns ``residual(z [M, S·D]) -> [M, S·D]`` where z stacks the S
    segment start states; the continuity defects come from integrating all
    M·S segments in ONE lockstep batch. A tensor leaf of ``args`` with
    leading dimension M is an instance's parameter and is repeated over its
    segments.
    """
    # imported here: solve.adjoint imports control.precond, so this package
    # loads while janus_tpu_torch.solve is still loading
    from janus_tpu_torch.solve import solve_ivp

    n_seg = len(t_nodes) - 1

    def residual(z):
        m = z.shape[0]
        dim = z.shape[-1] // n_seg
        nodes = like(t_nodes, z)
        starts = z.reshape(m * n_seg, dim)                    # [M·S, D]
        t0s = nodes[:-1].repeat(m)
        tfs = nodes[1:].repeat(m)
        seg_args = tree_map(
            lambda a: torch.repeat_interleave(a, n_seg, dim=0)
            if isinstance(a, torch.Tensor) and a.ndim >= 1
            and a.shape[0] == m else a, args)
        sol = solve_ivp(f, (t0s, tfs), starts, method=method, args=seg_args,
                        options=options)
        ends = sol.y.reshape(m, n_seg, dim)
        starts_m = starts.reshape(m, n_seg, dim)
        # continuity: end of segment i == start of segment i+1
        cont = (ends[:, :-1, :] - starts_m[:, 1:, :]).reshape(m, -1)
        bc = y_bc(starts_m[:, 0, :], ends[:, -1, :])
        return torch.cat([cont, bc], dim=-1)

    return residual
