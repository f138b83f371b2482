"""The matrix-free Radau path of the port against the JAX package's
``solve_radau``, on the CPU in float64.

Both packages solve the same small method-of-lines batches (the problems of
``test_torch_mol_cases``, inputs made from a seed with numpy): the D=32
Fisher-KPP line with ``stage_solver='tridiag'`` and ``'gmres'`` (k=12), an
8×8 heat grid with ``precond='lines'``, and the cell-interleaved stiff
2-species line with ``precond='block'``. On the CPU both run the Thomas
sweeps (the port picks the tridiagonal algorithm from the tensor's device).

Tolerances: status and the per-lane counters naccept, nreject, nsteps,
njev, nlu, nfev, nnewton equal; y to rtol 1e-8 / atol 1e-10; IND
sensitivities through the GMRES solvers to 1e-6 relative to the largest
entry of the reference's, and to 5e-4 against a central finite difference
of the port's own solves.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janus_tpu.solve import Options as RefOptions
from janus_tpu.solve.radau import solve_radau as ref_solve_radau
from janus_tpu_torch.interop import options_from_jax, tree_to_torch
from janus_tpu_torch.solve import Options, solve_ivp
from janus_tpu_torch.solve.radau import solve_radau
from test_torch_mol_cases import (as_jax, close, heat_case, interleaved_case,
                                  line_case)

torch.set_num_threads(1)

STATS = ("naccept", "nreject", "nsteps", "njev", "nlu", "nfev", "nnewton")

CASES = {
    "line-tridiag": dict(case=line_case, tf=0.4, opts=dict(
        rtol=1e-6, atol=1e-9, stage_solver="tridiag", pivoting=False)),
    "line-gmres12": dict(case=line_case, tf=0.4, opts=dict(
        rtol=1e-4, atol=1e-7, stage_solver="gmres", gmres_iters=12)),
    "line-gmres12-radau9": dict(case=line_case, tf=0.2, opts=dict(
        rtol=1e-4, atol=1e-7, stage_solver="gmres", gmres_iters=12,
        min_stages=5, max_stages=5)),
    "heat-lines-gmres8": dict(case=heat_case, tf=0.3, opts=dict(
        rtol=1e-4, atol=1e-7, stage_solver="gmres", gmres_iters=8,
        precond="lines", precond_block=8)),
    "heat-lines-direct": dict(case=heat_case, tf=0.3, opts=dict(
        rtol=1e-4, atol=1e-7, stage_solver="tridiag", precond="lines",
        precond_block=8)),
    "interleaved-block-gmres10": dict(case=interleaved_case, tf=0.5, opts=dict(
        rtol=1e-5, atol=1e-8, stage_solver="gmres", gmres_iters=10,
        precond="block", precond_block=2)),
}


def _to_torch(x):
    return tree_to_torch(x, device="cpu")


def _compare(got, ref):
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    for k in STATS:
        np.testing.assert_array_equal(got.stats[k].numpy(),
                                      np.asarray(ref.stats[k]), err_msg=k)
    np.testing.assert_allclose(got.y.numpy(), np.asarray(ref.y), rtol=1e-8,
                               atol=1e-10)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), rtol=1e-12)


# the Radau9 ladder compiles two complex stage pairs in the reference
SLOW = {"line-gmres12-radau9"}


@pytest.mark.parametrize("name", [
    pytest.param(n, marks=pytest.mark.slow) if n in SLOW else n
    for n in CASES])
def test_solve_radau_matrix_free_matches_reference(name):
    c = CASES[name]
    ref_f, f, y0, args = c["case"]()
    ref_opts = RefOptions(**c["opts"])
    ref = ref_solve_radau(ref_f, 0.0, c["tf"], jnp.asarray(y0),
                          args=as_jax(args), options=ref_opts)
    got = solve_radau(f, 0.0, c["tf"], _to_torch(y0), args=_to_torch(args),
                      options=options_from_jax(ref_opts))
    assert bool((got.status == 1).all())
    _compare(got, ref)
    # one sync per attempt, per Newton trip, and per refined-estimate gate
    assert solve_radau.host_syncs >= 3 * int(got.stats["nsteps"].max())


def test_gmres_ind_tangents_match_reference_and_fd():
    """K=2 seed directions (a bump in y0; the reaction rate) through the
    frozen GMRES stage solvers."""
    ref_f, f, y0, (nu, rates) = line_case(d=16, m=2)
    m, d = y0.shape
    xg = np.linspace(0, 1, d + 2)[1:-1]
    bump = np.tile(np.exp(-50 * (xg - 0.5) ** 2)[None], (m, 1))
    seeds = np.stack([bump, np.zeros((m, d))])
    args_t = (np.zeros(2), np.stack([np.zeros((m, 1)), np.ones((m, 1))]))
    kw = dict(rtol=1e-6, atol=1e-9, stage_solver="gmres", gmres_iters=10)
    tf = 0.1
    ref = ref_solve_radau(ref_f, 0.0, tf, jnp.asarray(y0),
                          args=(jnp.asarray(nu), jnp.asarray(rates)),
                          options=RefOptions(**kw),
                          tangents=jnp.asarray(seeds),
                          args_tangents=as_jax(args_t))

    def port(z, r, sens=False):
        extra = dict(tangents=_to_torch(seeds),
                     args_tangents=_to_torch(args_t)) if sens else {}
        return solve_radau(f, 0.0, tf, _to_torch(z),
                           args=(torch.tensor(nu, dtype=torch.float64),
                                 _to_torch(r)),
                           options=Options(**kw), **extra)

    got = port(y0, rates, sens=True)
    _compare(got, ref)
    close(got.sens, ref.sens, 1e-6, "sens")
    eps = 1e-4
    fd_y = (port(y0 + eps * bump, rates).y - port(y0 - eps * bump, rates).y) \
        / (2 * eps)
    fd_r = (port(y0, rates + eps).y - port(y0, rates - eps).y) / (2 * eps)
    torch.testing.assert_close(got.sens[0], fd_y, rtol=5e-4, atol=5e-7)
    torch.testing.assert_close(got.sens[1], fd_r, rtol=5e-4, atol=5e-7)


def test_solve_ivp_carries_the_matrix_free_options():
    ref_f, f, y0, args = line_case(d=16, m=2)
    kw = dict(rtol=1e-5, atol=1e-8, stage_solver="tridiag")
    ref = ref_solve_radau(ref_f, 0.0, 0.2, jnp.asarray(y0), args=as_jax(args),
                          options=RefOptions(**kw))
    got = solve_ivp(f, (0.0, 0.2), y0, method="radau5", args=_to_torch(args),
                    device="cpu", **kw)
    _compare(got, ref)


def test_options_from_jax_carries_the_matrix_free_fields():
    ref = RefOptions(stage_solver="gmres", gmres_iters=9, precond="block",
                     precond_block=4)
    assert options_from_jax(ref) == Options(
        stage_solver="gmres", gmres_iters=9, precond="block", precond_block=4)


def test_matrix_free_guards():
    y0 = torch.zeros((1, 4), dtype=torch.float64)
    f = lambda t, y, a: -y                                       # noqa: E731
    for solver in ("gmres", "tridiag"):
        with pytest.raises(ValueError, match="matrix-free"):
            solve_radau(f, 0.0, 1.0, y0, options=Options(stage_solver=solver),
                        jac=lambda t, y, a: torch.zeros((1, 4, 4)))
    with pytest.raises(ValueError, match="unknown precond"):
        solve_radau(f, 0.0, 1.0, y0,
                    options=Options(stage_solver="gmres", precond="ilu"))
    with pytest.raises(ValueError, match="needs precond_block"):
        solve_radau(f, 0.0, 1.0, y0, options=Options(
            stage_solver="gmres", precond="lines", precond_block=3))
    # kernel_lu asks for the LU kernels; the matrix-free path has no LU
    sol = solve_radau(f, 0.0, 1.0, y0 + 1.0, options=Options(
        stage_solver="tridiag", kernel_lu=True, pivoting=False))
    np.testing.assert_allclose(sol.y.numpy(), np.exp(-1.0), rtol=1e-5)
