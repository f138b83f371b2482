"""Problem library (the subset the ported slice uses)."""

from janus_tpu_torch.models.problems import (DEVICE_PROBLEMS, DeviceProblem,
                                             robertson_rhs, vdp_jac, vdp_rhs)

__all__ = ["vdp_rhs", "vdp_jac", "robertson_rhs", "DEVICE_PROBLEMS",
           "DeviceProblem"]
