"""Hamiltonian calculus: dynamics and Jacobians derived from a scalar H, as
``janus_tpu.ham``, on ``torch.func.grad``/``jacfwd``/``vmap``. Forward
sensitivities come from ``torch.func.jvp`` over these functions (or from
Jets, ``janus_tpu_torch.jet``)."""

from janus_tpu_torch.ham.core import (
    hamiltonian_dynamics,
    hamiltonian_jacobian,
    safe_dynamics,
    grad_x,
    grad_p,
    hessian_xx,
    hessian_pp,
    hessian_xp,
    grad_u,
    hessian_uu,
    hessian_ux,
    hessian_up,
    hamiltonian_dynamics_u,
    pmp_dynamics_u,
    stationarity_residual,
    split_px,
    join_px,
)

__all__ = [
    "hamiltonian_dynamics",
    "hamiltonian_jacobian",
    "safe_dynamics",
    "grad_x",
    "grad_p",
    "hessian_xx",
    "hessian_pp",
    "hessian_xp",
    "grad_u",
    "hessian_uu",
    "hessian_ux",
    "hessian_up",
    "hamiltonian_dynamics_u",
    "pmp_dynamics_u",
    "stationarity_residual",
    "split_px",
    "join_px",
]
