"""Batched small dense linear algebra (the subset the ported slices use)."""

from janus_tpu_torch.linalg.qr import qr_factor, qr_linsolve, qr_solve
from janus_tpu_torch.linalg.smalllu import lu_factor, lu_ok, lu_solve

__all__ = ["lu_factor", "lu_ok", "lu_solve", "qr_factor", "qr_solve",
           "qr_linsolve"]
