"""The port's control examples (janus_tpu_torch/examples/) against the
reference's (examples/), on the CPU in float64: bratu_psitc, dubins_pmp and
vdp_pmp_energy.

- bratu_psitc: 20 Ψtc (SER-A) iterations, where some of the five λ lanes
  converge: iterations and convergence equal, x within 1e-10; one
  Newton–Krylov step (tridiagonal preconditioner, GMRES(10) × 2): x within
  1e-10. On N = 16 interior points, not the example's 48: the reference
  compiles its unrolled N×N LU, ~6 s at 16 and ~22 s at 48;
- dubins_pmp: the first ε rung's shooting residual at p0 = (0.1, 0.1, 0.1)
  within 1e-9 (one Radau solve at rtol 1e-9; the whole ε ladder is the
  probe's, on the card);
- vdp_pmp_energy: the single-shooting residual at μ = 0 from p0 = 0 within
  1e-9, and the multiple-shooting residual's first iterate; ``pmp_rhs`` is
  the one definition ``bench.control`` uses.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from janus_tpu.control import newton_krylov as j_newton_krylov
from janus_tpu.control import psitc as j_psitc
from janus_tpu_torch.bench import control as control_probe
from janus_tpu_torch.examples import bratu_psitc as br
from janus_tpu_torch.examples import dubins_pmp as db
from janus_tpu_torch.examples import vdp_pmp_energy as pe

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))
import bratu_psitc as br_ref  # noqa: E402
import dubins_pmp as db_ref  # noqa: E402
import vdp_pmp_energy as pe_ref  # noqa: E402

torch.set_num_threads(1)
CPU = torch.device("cpu")
F64 = torch.float64


def test_bratu_psitc_and_newton_krylov_match_reference():
    n = 16
    u0 = br.u0(CPU, n)
    res = br.solve_psitc(u0, max_iter=20)
    want = j_psitc(lambda u: -br_ref.bratu_residual(u), jnp.zeros((5, n)),
                   controller="ser-a", delta0=1e-2, tol=1e-9, max_iter=20)
    np.testing.assert_array_equal(res.iters.numpy(), np.asarray(want.iters))
    np.testing.assert_array_equal(res.converged.numpy(),
                                  np.asarray(want.converged))
    assert 0 < int(res.converged.sum()) < 5         # both outcomes occur
    np.testing.assert_allclose(res.x.numpy(), np.asarray(want.x), rtol=0,
                               atol=1e-10)

    nk = br.solve_newton_krylov(u0, max_iter=1)
    want_nk = j_newton_krylov(br_ref.bratu_residual, jnp.zeros((5, n)),
                              precond="tridiag", tol=1e-9, max_iter=1,
                              gmres_restart=10, gmres_maxiter=2)
    np.testing.assert_array_equal(nk.iters.numpy(), np.asarray(want_nk.iters))
    np.testing.assert_allclose(nk.x.numpy(), np.asarray(want_nk.x), rtol=0,
                               atol=1e-10)


def test_dubins_first_rung_residual_matches_reference():
    p0 = np.array([[0.1, 0.1, 0.1]])
    got = db.residual(torch.as_tensor(p0), db.EPS_LADDER[0])
    want = jax.jit(lambda p: db_ref.residual(p, 0.2))(jnp.asarray(p0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-9)


def test_vdp_pmp_energy_residuals_match_reference():
    assert control_probe.pmp_rhs is pe.pmp_rhs
    p0 = np.zeros((1, 2))
    got = pe.shooting_residual(torch.as_tensor(p0), 0.0)
    want = jax.jit(lambda p: pe_ref.shooting_residual(p, 0.0))(
        jnp.asarray(p0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-9)
    # the multiple-shooting residual at mu = 1 on a z of the segment starts
    z = np.tile(np.array([[1.0, 0.5, 0.1, -0.2]]), (1, pe.N_SEG))
    got_ms = pe.multishoot_residual(1.0)(torch.as_tensor(z))
    want_ms = jax.jit(lambda zz: pe_ref.multishoot_residual(1.0)(zz))(
        jnp.asarray(z))
    np.testing.assert_allclose(got_ms.numpy(), np.asarray(want_ms), rtol=0,
                               atol=1e-9)
