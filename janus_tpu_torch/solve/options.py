"""Solver options: a frozen dataclass with ``replace``.

Same fields and defaults as ``janus_tpu.solve.options.Options``, with one
rename: ``pallas_lu`` is ``kernel_lu`` here (stage factor and solves through
the CUDA kernels K1/K2 of ``janus_tpu_torch.ops.smalllu``).
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Options:
    """Common adaptive-control options (Hairer naming); see the reference's
    ``janus_tpu/solve/options.py`` for what each knob does."""

    rtol: float = 1e-6
    atol: float = 1e-9
    h0: float = 0.0          # 0 → automatic initial step (Hairer hinit)
    max_step: float = math.inf
    safety: float = 0.9      # Safe
    min_factor: float = 0.2  # FacL: hnew >= FacL*h on reject
    max_factor: float = 8.0  # FacR: hnew <= FacR*h
    beta: float = -1.0       # PI stabilization (explicit controllers)
    max_steps: int = 100000  # per-trajectory step budget

    # implicit-solver knobs
    newton_tol: float = 0.0      # 0 → derived from rtol (Hairer FNewt)
    newton_max_iter: int = 7     # Nit
    jac_recompute: float = 1e-3  # Θ threshold to reuse the Jacobian
    quot1: float = 1.0           # deadzone: keep h if quot1 < hnew/h < quot2
    quot2: float = 1.2
    gustafsson: bool = True      # predictive step controller
    min_stages: int = 3
    max_stages: int = 3
    seulex_kmax: int = 13
    record_steps: int = 0
    record_states: bool = False
    # compensated (double-word) accumulation of y and t across steps
    compensated: bool = False
    # partial pivoting in the stage LU
    pivoting: bool = True
    # stage factor/solves through the CUDA kernels K1/K2 (pivot-free; the
    # reference's pallas_lu). On CPU tensors the kernels' plain torch twins
    # run the same arithmetic.
    kernel_lu: bool = False
    qr_fallback: bool = False
    stage_solver: str = "lu"
    gmres_iters: int = 20
    precond: str = "tridiag"
    precond_block: int = 0
    adjoint_steps: int = 256
    nind1: int = 0
    nind2: int = 0
    nind3: int = 0

    def replace(self, **changes) -> "Options":
        return dataclasses.replace(self, **changes)
