"""The port's hamiltonian_vdp (janus_tpu_torch/examples/) against the
reference's (examples/hamiltonian_vdp.py), on the CPU in float64: y(T) and
the [5, 8, 4] sensitivities with the final-time column within 1e-9 of the
reference's, at the reference's TPU tolerances (rtol 1e-5, atol 1e-8) to
keep the case short.
"""

import jax.numpy as jnp
import numpy as np
import torch

from janus_tpu import ham as j_ham
from janus_tpu.jet.solve import solve_with_sensitivities as j_sens
from janus_tpu.models.problems import vdp_hamiltonian as j_vdp_ham
from janus_tpu.solve import Options as JOptions
from janus_tpu_torch.examples import hamiltonian_vdp as hv

torch.set_num_threads(1)
CPU = torch.device("cpu")


def test_hamiltonian_vdp_sensitivities_match_reference():
    rtol, atol = 1e-5, 1e-8
    y0 = hv.inputs(8, CPU)
    yj, ok = hv.sensitivities(y0, 100.0, rtol, atol)
    f = j_ham.hamiltonian_dynamics(j_vdp_ham)
    want, _ = j_sens(f, (0.0, 1.0), jnp.asarray(y0.numpy()),
                     args={"mu": 100.0},
                     options=JOptions(rtol=rtol, atol=atol), wrt_tf=True)
    assert ok
    assert tuple(yj.d.shape) == (5, 8, 4)
    np.testing.assert_allclose(yj.r.numpy(), np.asarray(want.r), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(yj.d.numpy(), np.asarray(want.d), rtol=0,
                               atol=1e-9)
