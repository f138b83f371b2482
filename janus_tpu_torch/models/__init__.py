"""Problem library: the reference's recurring test systems (the names of
``janus_tpu.models``), the control schedules and the neural fields."""

from janus_tpu_torch.models.problems import (DEVICE_PROBLEMS, DeviceProblem,
                                             brusselator_2d_rhs,
                                             harmonic_hamiltonian,
                                             harmonic_rhs, heat_2d_rhs,
                                             laplacian_2d, robertson_rhs,
                                             vdp_hamiltonian, vdp_jac,
                                             vdp_rhs)

from janus_tpu_torch.models.controls import (piecewise_constant,
                                             piecewise_linear)
from janus_tpu_torch.models.neural import (mlp_apply, mlp_init,
                                           nn_hamiltonian)

__all__ = ["harmonic_hamiltonian", "harmonic_rhs", "vdp_hamiltonian",
           "mlp_init", "mlp_apply", "nn_hamiltonian",
           "vdp_rhs", "vdp_jac", "robertson_rhs", "laplacian_2d",
           "heat_2d_rhs", "brusselator_2d_rhs", "DEVICE_PROBLEMS",
           "DeviceProblem", "piecewise_constant", "piecewise_linear"]
