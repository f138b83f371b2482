"""Newton–Krylov, its restarted GMRES, and Anderson acceleration of the port
against the JAX reference, on the CPU: the twins of
``tests/test_krylov_controls.py`` (Newton–Krylov) and of the Anderson cases
of ``tests/test_qr_anderson.py``.

``control.krylov.gmres`` is the algorithm the reference calls,
``jax.scipy.sparse.linalg.gmres(solve_method='batched')`` on the whole
[M, N] array: one restarted GMRES whose inner products sum over every lane.
Held against it on random [M, N] systems, left-preconditioned or not,
converged and cut short by ``maxiter``: measured 1.5e-16 to 1.4e-15
relative to the largest entry (the sums of its Gram–Schmidt pass and its
least squares add in another order), so the bound is 1e-13. Roots of
``newton_krylov`` and ``anderson_solve``: 1e-10 of the reference's (the same
iteration counts); one Anderson step (pure algebra): 1e-13.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.sparse.linalg import gmres as ref_gmres

from janus_tpu.control import newton_solve as ref_newton_solve
from janus_tpu.control.anderson import anderson_solve as ref_anderson
from janus_tpu.control.krylov import newton_krylov as ref_newton_krylov
from janus_tpu_torch.control import anderson_solve, newton_krylov, newton_solve
from janus_tpu_torch.control.krylov import gmres

torch.set_num_threads(1)

F64 = torch.float64
GMRES_BOUND = 1e-13
ROOT = 1e-10


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("precond", [False, True],
                         ids=["plain", "preconditioned"])
@pytest.mark.parametrize("m,n,restart,maxiter,tol", [
    (2, 16, 20, 40, 1e-10), (3, 10, 5, 40, 1e-10), (2, 30, 8, 3, 1e-12),
    (4, 8, 20, 40, 1e-4)], ids=["full", "restarted", "cut", "loose"])
def test_gmres_is_the_references_global_gmres(rng, m, n, restart, maxiter,
                                               tol, precond):
    a = rng.standard_normal((m, n, n)) * 0.3 + 2.0 * np.eye(n)
    b = rng.standard_normal((m, n))
    p = np.linalg.inv(a + 0.1 * rng.standard_normal(a.shape))
    mv_r = lambda v: jnp.einsum("mij,mj->mi", jnp.asarray(a), v)  # noqa
    mv = lambda v: torch.einsum("mij,mj->mi", _t(a), v)            # noqa
    pc_r = (lambda v: jnp.einsum("mij,mj->mi", jnp.asarray(p), v)) \
        if precond else None
    pc = (lambda v: torch.einsum("mij,mj->mi", _t(p), v)) if precond \
        else None
    want, _ = ref_gmres(mv_r, jnp.asarray(b), tol=tol, restart=restart,
                        maxiter=maxiter, M=pc_r)
    got = gmres(mv, _t(b), tol=tol, restart=restart, maxiter=maxiter,
                precond=pc)
    err = float(np.abs(got.numpy() - np.asarray(want)).max()
                / np.abs(np.asarray(want)).max())
    assert err <= GMRES_BOUND, err


def _bratu(lib, n):
    hgrid = 1.0 / (n + 1)

    def residual(x):
        if lib is jnp:
            lap = jnp.roll(x, 1, -1) + jnp.roll(x, -1, -1) - 2 * x
            lap = lap.at[..., 0].set(x[..., 1] - 2 * x[..., 0])
            lap = lap.at[..., -1].set(x[..., -2] - 2 * x[..., -1])
        else:
            lap = torch.cat([x[..., 1:2] - 2 * x[..., :1],
                             x[..., :-2] + x[..., 2:] - 2 * x[..., 1:-1],
                             x[..., -2:-1] - 2 * x[..., -1:]], dim=-1)
        return lap / hgrid ** 2 + 2.0 * lib.exp(x)
    return residual


@pytest.mark.parametrize("precond", [None, "tridiag", "block_jacobi"])
def test_newton_krylov_bratu_line_matches_reference(precond):
    """1-D Bratu-style line problem (method-of-lines flavor), N=64,
    matrix-free."""
    n = 64
    want = ref_newton_krylov(_bratu(jnp, n), jnp.zeros((2, n)), tol=1e-8,
                             precond=precond)
    got = newton_krylov(_bratu(torch, n), torch.zeros((2, n), dtype=F64),
                        tol=1e-8, precond=precond)
    assert got.converged.all()
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    close(got.x, want.x, ROOT, 1e-12)
    close(_bratu(torch, n)(got.x), 0.0, 0.0, 1e-7)
    assert float(got.x.max()) > 0.1      # nontrivial solution


def test_newton_krylov_matches_dense():
    def f(lib):
        return lambda x: x ** 3 + x - lib.arange(1.0, 4.0, dtype=x.dtype)
    x0 = np.ones((1, 3))
    a = newton_krylov(f(torch), _t(x0), tol=1e-10)
    b = newton_solve(f(torch), _t(x0), tol=1e-10)
    close(a.x, b.x, 1e-8)
    want = ref_newton_krylov(f(jnp), jnp.asarray(x0), tol=1e-10)
    close(a.x, want.x, ROOT)
    close(b.x, ref_newton_solve(f(jnp), jnp.asarray(x0), tol=1e-10).x, ROOT)


def test_newton_krylov_rejects_unknown_precond():
    with pytest.raises(ValueError, match="precond"):
        newton_krylov(lambda x: x, torch.ones((1, 2), dtype=F64),
                      precond="ilu")


@pytest.mark.parametrize("max_iter", [1, 200])
def test_anderson_linear_system_matches_reference(rng, max_iter):
    amat = rng.standard_normal((2, 3, 3)) * 0.1 + np.eye(3)
    bvec = rng.standard_normal((2, 3))

    def f(lib):
        return lambda x: lib.asarray(bvec) - lib.einsum(
            "mij,mj->mi", lib.asarray(amat), x)

    want = ref_anderson(f(jnp), jnp.zeros((2, 3)), tol=1e-10,
                        max_iter=max_iter)
    got = anderson_solve(lambda x: _t(bvec) - torch.einsum(
        "mij,mj->mi", _t(amat), x), torch.zeros((2, 3), dtype=F64),
        tol=1e-10, max_iter=max_iter)
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    tol = 1e-13 if max_iter == 1 else ROOT
    close(got.x, want.x, tol, 1e-14)
    if max_iter > 1:
        assert got.converged.all()
        expect = np.linalg.solve(amat, bvec[..., None])[..., 0]
        close(got.x, expect, 1e-7, 1e-9)


def test_anderson_nonlinear_beats_picard():
    """cos fixed point: Anderson converges much faster than plain Picard."""
    want = ref_anderson(lambda x: jnp.cos(x) - x, jnp.zeros((1, 1)),
                        tol=1e-12, beta=1.0)
    got = anderson_solve(lambda x: torch.cos(x) - x,
                         torch.zeros((1, 1), dtype=F64), tol=1e-12,
                         beta=1.0)
    assert got.converged[0]
    close(got.x[0, 0], 0.7390851332151607, 1e-10)
    close(got.x, want.x, ROOT)
    assert int(got.iters[0]) == int(want.iters[0]) < 20


def test_anderson_picard_fallback_matches_reference():
    """A residual that is non-finite away from the origin sends the
    least-squares step back to damped Picard on some lanes."""
    def f(lib):
        return lambda x: lib.where(lib.abs(x) < 2.0, 0.5 * lib.sin(x) - x,
                                   jnp.inf if lib is jnp else float("inf"))
    x0 = np.array([[0.5, -0.3], [1.5, 1.9]])
    want = ref_anderson(f(jnp), jnp.asarray(x0), tol=1e-12, beta=1.5)
    got = anderson_solve(f(torch), _t(x0), tol=1e-12, beta=1.5)
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    close(got.x, want.x, ROOT, 1e-14)
