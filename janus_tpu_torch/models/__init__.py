"""Problem library (the subset the ported slice uses)."""

from janus_tpu_torch.models.problems import (DEVICE_PROBLEMS, DeviceProblem,
                                             brusselator_2d_rhs, heat_2d_rhs,
                                             laplacian_2d, robertson_rhs,
                                             vdp_jac, vdp_rhs)

__all__ = ["vdp_rhs", "vdp_jac", "robertson_rhs", "laplacian_2d",
           "heat_2d_rhs", "brusselator_2d_rhs", "DEVICE_PROBLEMS",
           "DeviceProblem"]
