"""janus_tpu_torch: the PyTorch/CUDA port of janus_tpu for NVIDIA Hopper.

The package mirrors ``janus_tpu``'s layout module for module
(``janus_tpu_torch/solve/radau.py`` ↔ ``janus_tpu/solve/radau.py``) and is
held against it by the ``tests/test_torch_*.py`` parity tests. It imports
torch and numpy only, never jax.

What is ported so far: the fixed-stage Radau IIA solve with the dense stage
LU and forward sensitivities by internal differentiation
(``solve.solve_radau``, ``solve.solve_ivp(method='radau*')``), with the
pivot-free stage factor/solve running through the hand-written CUDA kernels
of ``ops/smalllu.py`` when ``Options(kernel_lu=True)`` and the tensors lie
on a CUDA device; the fused Radau5 solve ``solve.solve_ivp(method=
'radau_fused')``, whose whole step attempt per lane is the CUDA kernel of
``ops/radau_fused.py``; the fused small solve ``ops.linsolve_fused``; and
the matrix-free Radau path for method-of-lines systems
(``Options(stage_solver='gmres'|'tridiag')``: batched GMRES with probed
tridiagonal, line or block preconditioners, ``linalg/gmres.py`` and
``control/precond.py``) with mass matrices (``mass=``), which is plain torch
as it is plain jnp in the reference; dense output, ``t_eval=`` and
quadratures on ``solve_radau``; the continuous adjoint
``solve.radau_adjoint`` (``solve/adjoint.py``), a ``torch.autograd.Function``
whose backward sweeps the forward solve's accepted-step mesh, plain torch too;
events (``solve/events.py``) on solve_radau, solve_rodas and radau_adjoint;
RODAS4 (``solve/rodas.py``, through K1/K2 under ``kernel_lu``) with its
discrete adjoint ``solve.rodas_adjoint`` (``solve/adjoint_rodas.py``); the
explicit Dormand–Prince pairs (``solve/dopri.py``, ``solve_ivp``'s default
method) with their discrete adjoint ``solve.dopri_adjoint`` (the
neural-ODE training path, ``models/neural.py``), both discrete adjoints on
``solve/discrete.py``; ``step_args=``, ``record_steps`` (``diag/record.py``)
and ``qr_fallback`` (``linalg/qr.py``) on the Radau solve, and its
Hessian-vector products ``solve.radau_hvp``; the variable-order NDF/BDF
(``solve/ndf.py``, its corrector through K1/K2 under ``kernel_lu``) with
its discrete adjoint ``solve.ndf_adjoint`` (``solve/adjoint_ndf.py``);
SEULEX (``solve/seulex.py``) with its discrete adjoint
``solve.seulex_adjoint`` (``solve/adjoint_seulex.py``); the variable-order
Radau ladder (``solve/radaup.py``, ``solve_ivp(method='radaup')``) with its
continuous adjoint, and the legacy steppers BDF2 (``solve/bdf.py``), GRK4T
(``solve/rosenbrock.py``) and the fixed-grid ``solve.fixed.odeint_fixed``,
all of them through K1/K2 under ``kernel_lu`` where they factor; forward
mode (``torch.func.jvp``) through every method, with the norms' square root
``solve.common.safe_sqrt`` zero-differentiated at 0 as in the reference;
the Hamiltonian-first API ``ham`` (dynamics, Jacobians and partials of a
scalar H on ``torch.func``), the dual numbers ``jet`` (``Jet`` and its ops,
``jet.solve.dual_solve_ivp`` and ``solve_with_sensitivities``: the IND
sweep where the method has one, else ``torch.func.vmap`` over
``torch.func.jvp`` of the solve) and the problem library
(``models/problems.py``: Hamiltonians, Dubins, Brusselator, Pleiades,
HIRES, OREGO, E5); the outer control layer ``control`` (Newton, Ψtc,
homotopy, augmented Lagrangian, Anderson, Newton–Krylov, shooting,
``implicit_root``, Newton-CG) and the piecewise controls
(``models/controls.py``). The CUDA kernels have no derivative rule: on a
CUDA tensor a derivative through them is refused, never dropped
(``ops.smalllu.refuse_derivatives``). The infrastructure: ``config``
(float64 or float32 as torch's default dtype), ``utils`` (checkpoints on
``torch.save``), ``native`` (the port's own ctypes binding of the C++
oracle and dataset IO in ``native/``), ``diag``'s profiler hooks on
``torch.profiler`` (``trace``, ``annotate``, ``scope``,
``device_memory_stats``, ``marginal_seconds``), and ``parallel``: the batch
sharded over the ranks of a ``torch.distributed`` process group as
``DTensor`` s, each rank solving its own rows with the solver's gates read
over every rank (``parallel.lockstep``); and the examples that need them
(``examples/``: ``stiff_vdp_batch``, ``sharded_sweep``,
``train_nn_hamiltonian``, ``learned_continuation``, each runnable as
``python3 -m janus_tpu_torch.examples.<name>``).

Precision: f32 contractions must not be demoted to TF32 on the card (a
demoted contraction stalls the f32 Newton) — the role of the reference's
``_EINSUM_PRECISION = HIGHEST``. Both TF32 switches are turned off here.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from janus_tpu_torch import config as config  # noqa: E402
from janus_tpu_torch.jet.core import Jet  # noqa: E402
from janus_tpu_torch.solve import Solution, solve_ivp  # noqa: E402

__all__ = ["Jet", "solve_ivp", "Solution", "config", "__version__"]
