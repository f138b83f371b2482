"""Outer nonlinear layer: shooting, pseudo-transient continuation, homotopy,
augmented Lagrangian, Anderson, Newton–Krylov, implicit differentiation and
Newton-CG (the port of ``janus_tpu/control``).

Generic batched algorithms: every solver runs M problem instances in
lockstep as a host loop with one read an iteration, Jacobians come from
forward mode through the (jvp-differentiable) adaptive solvers or from one
IND solve (``newton_solve(jac=...)``), and the segment integrations of
multiple shooting fold into the batch axis.
"""

from janus_tpu_torch.control.anderson import anderson_solve
from janus_tpu_torch.control.auglag import AugLagResult, augmented_lagrangian
from janus_tpu_torch.control.homotopy import HomotopyResult, homotopy
from janus_tpu_torch.control.implicit import implicit_root
from janus_tpu_torch.control.krylov import newton_krylov
from janus_tpu_torch.control.newton import NewtonResult, newton_solve
from janus_tpu_torch.control.optimize import (OptimizeResult, cg_steihaug,
                                              newton_cg)
from janus_tpu_torch.control.precond import (block_jacobi_precond,
                                             probe_colored_jacobian,
                                             tridiag_precond, tridiag_solve)
from janus_tpu_torch.control.psitc import PsitcResult, psitc
from janus_tpu_torch.control.shooting import (multiple_shooting_residual,
                                              single_shooting)

__all__ = [
    "implicit_root",
    "newton_solve", "NewtonResult",
    "newton_krylov", "anderson_solve",
    "block_jacobi_precond", "tridiag_precond", "tridiag_solve",
    "probe_colored_jacobian",
    "psitc", "PsitcResult",
    "homotopy", "HomotopyResult",
    "augmented_lagrangian", "AugLagResult",
    "single_shooting", "multiple_shooting_residual",
    "newton_cg", "cg_steihaug", "OptimizeResult",
]
