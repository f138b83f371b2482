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
``ops/radau_fused.py``; and the fused small solve ``ops.linsolve_fused``.

Precision: f32 contractions must not be demoted to TF32 on the card (a
demoted contraction stalls the f32 Newton) — the role of the reference's
``_EINSUM_PRECISION = HIGHEST``. Both TF32 switches are turned off here.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from janus_tpu_torch.solve import Solution, solve_ivp  # noqa: E402

__all__ = ["solve_ivp", "Solution", "__version__"]
