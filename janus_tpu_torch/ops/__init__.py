"""Hand-written CUDA kernels for Hopper, each beside its plain torch twin."""

from janus_tpu_torch.ops.smalllu import (lu_factor_t, lu_factor_t_ref,
                                         lu_solve_t, lu_solve_t_ref)

__all__ = ["lu_factor_t", "lu_solve_t", "lu_factor_t_ref", "lu_solve_t_ref"]
