"""The port's fit_mu_gauss_newton (janus_tpu_torch/examples/) against the
reference's (examples/fit_mu_gauss_newton.py), on the CPU in float64: the
reference's draws (np.random.RandomState(0)) and one Gauss–Newton step on
16 lanes, μ̂ within 1e-10, through the K1/K2 twins (kernel_lu=True on CPU
tensors; the reference's stage LU is pivot-free as well).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from janus_tpu.models.problems import vdp_jac as j_vdp_jac
from janus_tpu.models.problems import vdp_rhs as j_vdp_rhs
from janus_tpu.solve import Options as JOptions
from janus_tpu.solve.radau import solve_radau as j_solve_radau
from janus_tpu_torch.examples import fit_mu_gauss_newton as fm

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))
import fit_mu_gauss_newton as fm_ref  # noqa: E402

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _ref_solver(m, opts):
    """The reference's solve of one horizon (``observe``'s, and with
    ``args_tangents=ones`` ``gn_step``'s IND sweep), jitted once with tf
    traced, so that the three horizons share one compile."""
    y0 = jnp.tile(jnp.array([[2.0, 0.0]]), (m, 1))

    @jax.jit
    def solve(mu, tf):
        return j_solve_radau(j_vdp_rhs, 0.0, tf, y0, args=mu, options=opts,
                             jac=j_vdp_jac).y

    @jax.jit
    def sweep(mu, tf):
        sol = j_solve_radau(j_vdp_rhs, 0.0, tf, y0, args=mu, options=opts,
                            jac=j_vdp_jac, args_tangents=jnp.ones((1, m)))
        return sol.y, sol.sens[0]

    return solve, sweep


def _ref_gn_step(mu_hat, data, sweep):
    """The reference's gn_step (examples/fit_mu_gauss_newton.py:60-75; a
    closure of its main)."""
    r_rows, j_rows = [], []
    for h, tf in enumerate(fm_ref.HORIZONS):
        y, dy = sweep(mu_hat, tf)
        r_rows.append(y - data[:, h])
        j_rows.append(dy)
    r = jnp.concatenate(r_rows, axis=-1)
    J = jnp.concatenate(j_rows, axis=-1)
    step = -jnp.sum(J * r, axis=-1) / (jnp.sum(J * J, axis=-1) + 1e-12)
    step = jnp.clip(step, -0.3 * mu_hat, 0.3 * mu_hat)
    return mu_hat + step, jnp.sqrt(jnp.mean(r * r, axis=-1))


def test_fit_mu_one_gauss_newton_step_matches_reference():
    m = 16
    mu_true, data = fm.problem(m, CPU, kernel_lu=True)
    mu_hat, rn, sols = fm.gn_step(fm.mu_start(m, CPU), data,
                                  fm.options(kernel_lu=True))
    assert all(bool(torch.isfinite(s.sens).all()) for s in sols)

    rng = np.random.RandomState(0)
    mu_true_j = jnp.asarray(10.0 ** rng.uniform(0.8, 2.2, m))
    solve, sweep = _ref_solver(
        m, JOptions(rtol=1e-7, atol=1e-10, pivoting=False))
    # the reference's observe (examples/fit_mu_gauss_newton.py:32-41)
    data_j = jnp.stack([solve(mu_true_j, tf) for tf in fm_ref.HORIZONS],
                       axis=1)
    data_j = data_j + 1e-4 * jnp.asarray(rng.randn(*data_j.shape))
    np.testing.assert_array_equal(mu_true.numpy(), np.asarray(mu_true_j))
    np.testing.assert_allclose(data.numpy(), np.asarray(data_j), rtol=0,
                               atol=1e-12)
    want, want_rn = _ref_gn_step(jnp.full((m,), 30.0), data_j, sweep)
    np.testing.assert_allclose(mu_hat.numpy(), np.asarray(want), rtol=1e-10)
    np.testing.assert_allclose(rn.numpy(), np.asarray(want_rn), rtol=1e-9)
