"""The port's vdp_min_time (janus_tpu_torch/examples/) against the
reference's (examples/vdp_min_time.py), on the CPU in float64.

- one Levenberg–Marquardt iteration of ``newton_free_tf`` on 4 lanes of
  the umax grid: ``residual_and_jac`` (the IND p-columns and the
  endpoint-velocity tF column), four damping candidates a lane in one
  16-lane residual solve, the first smallest |F| picked by argmin and
  gather where the reference runs a select tournament, then
  ``residual_and_jac`` at the new iterate: z, |F|, y(tF) and the IND
  tangents within 1e-9. At solve_grid's default options (rtol 1e-8, atol
  1e-11), so the reference's module-level jitted solves keep the options
  its own test compiles them with; the lanes start from tF = 0.3 to keep
  the solves short;
- ``slow``: ``solve_grid`` on the four-lane grid of the reference's
  tests/test_min_time.py with the asserts of that test that the reference
  passes, and z and the Hamiltonian against the reference's solve_grid.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janus_tpu.solve import Options as JOptions
from janus_tpu.solve.radau import solve_radau as j_solve_radau
from janus_tpu_torch.examples import vdp_min_time as mt
from janus_tpu_torch.solve import Options
from janus_tpu_torch.solve.radau import solve_radau

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))
import vdp_min_time as mt_ref  # noqa: E402

torch.set_num_threads(1)
F64 = torch.float64
UMAX = np.linspace(0.8, 2.0, 4)
Z = np.array([[0.6, 0.6, 0.3], [0.4, 0.7, 0.3], [0.8, 0.3, 0.3],
              [0.5, 0.5, 0.3]])


def _args(eps):
    return ((mt.MU, torch.as_tensor(UMAX), torch.tensor(eps, dtype=F64)),
            (mt_ref.MU, jnp.asarray(UMAX), jnp.asarray(eps)))


def test_one_lm_step_matches_reference():
    args_t, args_j = _args(0.5)
    opts_j = JOptions(rtol=1e-8, atol=1e-11)
    opts_t = Options(rtol=1e-8, atol=1e-11)
    z1, fn1, sol = mt.newton_free_tf(torch.as_tensor(Z), args_t, opts_t,
                                     iters=1)
    want_z, want_fn, want_sol = mt_ref.newton_free_tf(
        jnp.asarray(Z), args_j, opts_j, iters=1)
    assert not np.array_equal(z1.numpy(), Z)        # some lane moved
    np.testing.assert_allclose(z1.numpy(), np.asarray(want_z), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(fn1.numpy(), np.asarray(want_fn), rtol=0,
                               atol=1e-9)
    # residual_and_jac at the new iterate: y(tF) and the IND p-columns
    assert bool((sol.status == 1).all())
    np.testing.assert_allclose(sol.y.numpy(), np.asarray(want_sol.y),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(sol.sens.numpy(), np.asarray(want_sol.sens),
                               rtol=0, atol=1e-9)


@pytest.mark.slow
def test_solve_grid_four_lanes_as_the_reference_test():
    """tests/test_min_time.py's checks on the port's solve_grid, and tF, |F|
    and H against the reference's solve_grid. H at 0.3·tF is held to the
    reference's H there, not to 0: the reference's own test fails its
    H ≈ 0 assert at 0.3·tF (lanes 2 and 3: 1.6e-2 and 8.2e-4, measured on
    the CPU), since H is not a first integral of the ε-smoothed flow
    (ROADMAP.md, Queue 3, quirks of the reference)."""
    umax = torch.as_tensor(UMAX)
    z, fn, args = mt.solve_grid(umax)
    assert bool((fn < 1e-8).all()), fn
    tf = z[:, 2].numpy()
    assert np.all(np.diff(tf) < 0.0), tf
    assert np.all(tf > 0.2) and np.all(tf < 10.0)
    zj, fnj, args_j = mt_ref.solve_grid(jnp.asarray(UMAX))
    assert bool(jnp.all(fnj < 1e-8))
    np.testing.assert_allclose(tf, np.asarray(zj[:, 2]), rtol=1e-6)
    np.testing.assert_allclose(z[:, :2].numpy(), np.asarray(zj[:, :2]),
                               rtol=1e-6)
    hs = mt.hamiltonian_samples(z, args, fracs=(0.3, 0.7, 1.0)).numpy()
    np.testing.assert_allclose(hs[1:], 0.0, atol=5e-5)
    opts_j = JOptions(rtol=1e-9, atol=1e-12)
    y0_j = jnp.concatenate([jnp.tile(mt_ref.X0[None], (4, 1)), zj[:, :2]],
                           axis=-1)
    h_ref = mt_ref.hamiltonian(j_solve_radau(
        mt_ref.pmp_rhs, 0.0, zj[:, 2] * 0.3, y0_j, args=args_j,
        options=opts_j).y, args_j)
    np.testing.assert_allclose(hs[0], np.asarray(h_ref), rtol=1e-4,
                               atol=5e-5)
    opts = Options(rtol=1e-9, atol=1e-12)
    y0 = torch.cat([torch.tensor([mt.X0], dtype=F64).repeat(4, 1), z[:, :2]],
                   dim=-1)
    sol_t = solve_radau(mt.pmp_rhs, 0.0, z[:, 2], y0, args=args,
                        options=opts)
    np.testing.assert_allclose(sol_t.y[:, :2].numpy(), 0.0, atol=1e-7)
    u = -UMAX[:, None] * np.tanh(sol_t.y[:, 3:4].numpy() / float(args[2]))
    assert np.all(np.abs(u) <= UMAX[:, None] + 1e-9)
