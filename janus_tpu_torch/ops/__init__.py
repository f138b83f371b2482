"""Hand-written CUDA kernels for Hopper, each beside its plain torch twin.

K1-K3 are exported here, as ``janus_tpu.ops`` exports its Pallas kernels;
the fused Radau5 step K4 is ``janus_tpu_torch.ops.radau_fused.radau5_step``.
"""

from janus_tpu_torch.ops.smalllu import (linsolve_fused, linsolve_fused_ref,
                                         lu_factor_t, lu_factor_t_ref,
                                         lu_solve_t, lu_solve_t_ref)

__all__ = ["lu_factor_t", "lu_solve_t", "linsolve_fused", "lu_factor_t_ref",
           "lu_solve_t_ref", "linsolve_fused_ref"]
