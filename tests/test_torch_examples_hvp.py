"""The port's newton_cg_hvp (janus_tpu_torch/examples/) against the
reference's (examples/newton_cg_hvp.py), on the CPU in float64.

- one value-and-gradient (radau_adjoint with cost=) and one
  Hessian-vector product (radau_hvp) within 1e-8, the port's forward
  through the K1/K2 twins (kernel_lu=True on CPU tensors), at the
  reference's float32 tolerances (rtol 1e-5, atol 1e-8) in float64 to keep
  the case short;
- ``slow``: ``main`` at the reference test's newton_iters=4
  (tests/test_hvp_example.py): both final losses within 1e-6 of the
  reference's, and Newton-CG below gradient descent.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janus_tpu.solve import Options as JOptions
from janus_tpu.solve import radau_adjoint as j_radau_adjoint
from janus_tpu.solve import radau_hvp as j_radau_hvp
from janus_tpu_torch.examples import newton_cg_hvp as nc

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))
import newton_cg_hvp as nc_ref  # noqa: E402

torch.set_num_threads(1)
CPU = torch.device("cpu")
F64 = torch.float64


def test_newton_cg_value_gradient_and_hvp_match_reference():
    rtol, atol = 1e-5, 1e-8
    _, vg, hvp = nc.make_problem(CPU, kernel_lu=True, rtol=rtol, atol=atol)
    th0 = nc.theta0(CPU)
    v = {"c": torch.tensor(1.0, dtype=F64), "k": torch.tensor(0.5,
                                                               dtype=F64)}
    val, g = vg(th0)
    h = hvp(th0, v)

    rng = np.random.RandomState(3)
    y0 = jnp.asarray(rng.uniform(-1.0, 1.0, (nc_ref.M, 2)))
    opts = JOptions(rtol=rtol, atol=atol, adjoint_steps=1024, pivoting=False)

    def loss_terms(yT, q, th):
        return jnp.sum(yT ** 2) + nc_ref.RHO * jnp.sum(q)

    def loss_j(th):                    # the reference's make_problem
        yT, q = j_radau_adjoint(nc_ref.rhs, (0.0, nc_ref.T), y0, args=th,
                                options=opts, cost=nc_ref.cost)
        return loss_terms(yT, q, th)

    def hvp_j(th, vv):
        (_, h_th), _ = j_radau_hvp(nc_ref.rhs, (0.0, nc_ref.T), y0, th,
                                   loss=loss_terms, v_args=vv, options=opts,
                                   cost=nc_ref.cost)
        return h_th

    th0_j = {"c": jnp.asarray(0.2), "k": jnp.asarray(4.0)}
    want_val, want_g = jax.jit(jax.value_and_grad(loss_j))(th0_j)
    want_h = jax.jit(hvp_j)(th0_j, {"c": jnp.asarray(1.0),
                                    "k": jnp.asarray(0.5)})
    np.testing.assert_allclose(float(val), float(want_val), rtol=1e-8)
    for k in ("c", "k"):
        np.testing.assert_allclose(float(g[k]), float(want_g[k]), rtol=1e-8)
        np.testing.assert_allclose(float(h[k]), float(want_h[k]), rtol=1e-8)


@pytest.mark.slow
def test_newton_cg_hvp_main_matches_reference():
    """The reference test's newton_iters=4 (tests/test_hvp_example.py); ~16
    min on the CPU."""
    l_newton, l_gd = nc.main(newton_iters=4, device="cpu")
    want_newton, want_gd = nc_ref.main(newton_iters=4)
    assert l_newton < l_gd
    np.testing.assert_allclose(l_newton, want_newton, rtol=1e-6)
    np.testing.assert_allclose(l_gd, want_gd, rtol=1e-6)
