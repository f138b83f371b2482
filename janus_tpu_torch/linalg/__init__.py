"""Batched small dense linear algebra (the subset the ported slices use)."""

from janus_tpu_torch.linalg.qr import qr_factor, qr_linsolve, qr_solve
from janus_tpu_torch.linalg.smalllu import (linsolve, lu_factor, lu_ok,
                                            lu_solve, solve_real_complex)

__all__ = ["linsolve", "lu_factor", "lu_ok", "lu_solve", "qr_factor",
           "qr_solve", "qr_linsolve", "solve_real_complex"]
