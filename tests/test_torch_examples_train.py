"""The port's training examples (janus_tpu_torch/examples/) against the
reference's (examples/), on the CPU in float64: event_time_training and
neural_ode_dopri.

- event_time_training: one gradient step of ``main`` (the loss after it and
  θ1 = θ0 − 0.3·∇L(θ0)) within 1e-8 of the reference's ``main``;
- neural_ode_dopri: on the reference's draws (jax.random, carried across
  with interop.tree_to_torch): the ground-truth samples within 1e-12, one
  fitting loss (relative) and its gradient (absolute; the gradient's
  entries are O(1)) through dopri_adjoint within 1e-10, with
  and without the kinetic-energy running cost (reg > 0);
- ``slow``: event_time_training's whole ``main`` (60 iterations, which do
  not converge: the reference's quirk) against the reference's numbers.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janus_tpu.solve.adjoint_dopri import dopri_adjoint as j_dopri_adjoint
from janus_tpu_torch.examples import event_time_training as et
from janus_tpu_torch.examples import neural_ode_dopri as nd
from janus_tpu_torch.interop import tree_to_torch
from janus_tpu_torch.solve.common import tree_leaves

_HERE = os.path.dirname(__file__)
sys.path.insert(0, os.path.join(_HERE, ".."))          # janus_tpu, for
sys.path.insert(0, os.path.join(_HERE, "..", "examples"))  # the examples
import event_time_training as et_ref  # noqa: E402
import neural_ode_dopri as nd_ref  # noqa: E402

torch.set_num_threads(1)
CPU = torch.device("cpu")


def test_event_time_training_one_step_matches_reference():
    loss1, theta1 = et.main(n_iter=1, verbose=False, device="cpu")
    want_loss1, want_theta1 = et_ref.main(n_iter=1, verbose=False)
    np.testing.assert_allclose(theta1, np.asarray(want_theta1), rtol=1e-8)
    g0 = (np.asarray(et.THETA0) - theta1) / et.LR
    want_g0 = (np.asarray(et.THETA0) - np.asarray(want_theta1)) / et.LR
    np.testing.assert_allclose(g0, want_g0, rtol=1e-8)
    np.testing.assert_allclose(loss1, want_loss1, rtol=1e-8)


def _pairs(tree_t, tree_j):
    return [(a, b) for k in ("w", "b") for a, b in zip(tree_t[k], tree_j[k])]


def test_neural_ode_loss_and_gradient_on_reference_draws():
    k_data, k_net = jax.random.split(jax.random.PRNGKey(0))
    y0_j, ts_j, ys_j = nd_ref.make_data(k_data)
    params_j = nd_ref.mlp_init(k_net, nd.SIZES, dtype=jnp.float64)
    y0 = torch.as_tensor(np.array(y0_j))
    ts, ys_true = nd.make_data(y0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(ts_j), rtol=1e-15)
    np.testing.assert_allclose(ys_true.numpy(), np.asarray(ys_j), rtol=0,
                               atol=1e-12)
    for reg in (0.0, 1e-3):
        def loss_j(p):                 # the reference main's loss_fn
            if reg > 0.0:
                ys, q = j_dopri_adjoint(
                    nd_ref.nn_rhs, (0.0, nd_ref.T_FINAL), y0_j, args=p,
                    options=nd_ref.OPTS, t_eval=ts_j, method="dopri5",
                    cost=lambda t, y, pp: jnp.sum(
                        nd_ref.mlp_apply(pp, y) ** 2, axis=-1))
                return jnp.mean((ys - ys_j) ** 2) + reg * jnp.mean(q)
            ys = j_dopri_adjoint(nd_ref.nn_rhs, (0.0, nd_ref.T_FINAL), y0_j,
                                 args=p, options=nd_ref.OPTS, t_eval=ts_j,
                                 method="dopri5")
            return jnp.mean((ys - ys_j) ** 2)

        lj, gj = jax.jit(jax.value_and_grad(loss_j))(params_j)
        params = tree_to_torch(params_j, device="cpu")
        for p in tree_leaves(params):
            p.requires_grad_(True)
        lt = nd.loss_fn(params, y0, ts, ys_true, reg)
        lt.backward()
        np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-10)
        for a, b in _pairs(params, gj):
            np.testing.assert_allclose(a.grad.numpy(), np.asarray(b),
                                       rtol=0, atol=1e-10)


# ---- slow: the heavy examples end to end ------------------------------------

@pytest.mark.slow
def test_event_time_training_reproduces_the_reference_iterates():
    """60 iterations at lr 0.3 from (1.5, 0.1): the reference does not
    converge (θ ≈ (−0.99946, −43.81616), loss ≈ 5.125); the port must land
    on the same iterates. Tolerance 1e-9 relative: measured on the CPU
    2.0e-12 in θ and 6.9e-14 in the loss after the 60 steps."""
    loss, theta = et.main(device="cpu", verbose=False)
    want_loss, want_theta = et_ref.main(verbose=False)
    np.testing.assert_allclose(theta, np.asarray(want_theta), rtol=1e-9)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-9)
    assert abs(theta[0] - et.A_TRUE) > 1.0     # the quirk: no convergence
