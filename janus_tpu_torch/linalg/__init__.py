"""Batched small dense linear algebra (the subset the ported slice uses)."""

from janus_tpu_torch.linalg.smalllu import lu_factor, lu_ok, lu_solve

__all__ = ["lu_factor", "lu_ok", "lu_solve"]
