"""Problem library (the subset the ported slice uses)."""

from janus_tpu_torch.models.problems import vdp_jac, vdp_rhs

__all__ = ["vdp_rhs", "vdp_jac"]
