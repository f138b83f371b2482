"""The port's GMRES and tridiagonal solves (janus_tpu_torch.linalg.gmres)
and the shifted matrix-free solvers of janus_tpu_torch.solve.radau against
the JAX package's, on the CPU in float64.

The same numpy inputs, made from a seed, go through both packages.
Tolerances: ``gmres_batched`` x to 1e-12 relative to the largest entry of
the reference's x and resnorm to 1e-12 absolute, on dense well-conditioned
systems (A = 5·I + N(0,1)), including k > N (Krylov exhaustion), A = I
(lucky breakdown) and a lane with b = 0; Thomas, complex Thomas, PCR and
complex PCR to 1e-13; ``tridiag_bands_of`` exactly; ``gmres_dense_solve`` to
1e-12; ``gmres_shifted_solver`` and ``gmres_shifted_solver_T`` to 1e-11, on
the stencils of ``test_torch_mol_cases`` with each preconditioner, with and
without a mass matrix, by GMRES(8) and by the direct structure solve.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janus_tpu.control import precond as ref_pc
from janus_tpu.linalg import gmres as ref_gm
from janus_tpu.solve import radau as ref_radau
from janus_tpu_torch.linalg import gmres as gm
from janus_tpu_torch.solve import radau
from test_torch_mol_cases import CASES, as_jax, as_torch, close

torch.set_num_threads(1)

M, N = 4, 12

GMRES_CASES = {
    "k<N": dict(iters=6),
    "k=N": dict(iters=N),
    "k>N-exhaustion": dict(iters=N + 5),
    "identity-breakdown": dict(iters=4, identity=True),
    "zero-rhs-lane": dict(iters=N, zero_lane=True),
    "tridiag-preconditioned": dict(iters=5, precond=True),
}


@pytest.mark.parametrize("case", list(GMRES_CASES))
def test_gmres_batched(case):
    c = GMRES_CASES[case]
    rng = np.random.default_rng(0)
    a = rng.normal(size=(M, N, N)) + 5.0 * np.eye(N)
    if c.get("identity"):
        a = np.broadcast_to(np.eye(N), (M, N, N)).copy()
    b = rng.normal(size=(M, N))
    if c.get("zero_lane"):
        b[1] = 0.0
    ja, ta = jnp.asarray(a), torch.from_numpy(a)
    ref_p = got_p = None
    if c.get("precond"):
        bands = [np.ascontiguousarray(x) for x in (
            np.pad(np.diagonal(a, -1, 1, 2), ((0, 0), (1, 0))),
            np.diagonal(a, 0, 1, 2),
            np.pad(np.diagonal(a, 1, 1, 2), ((0, 0), (0, 1))))]
        jb, tb = [jnp.asarray(x) for x in bands], \
            [torch.from_numpy(x) for x in bands]
        ref_p = lambda v: ref_pc.tridiag_solve(*jb, v)          # noqa: E731
        got_p = lambda v: gm.tridiag_solve(*tb, v)              # noqa: E731
    x_ref, r_ref = ref_gm.gmres_batched(
        lambda v: jnp.einsum("mij,mj->mi", ja, v), jnp.asarray(b), ref_p,
        c["iters"])
    x, r = gm.gmres_batched(
        lambda v: torch.einsum("mij,mj->mi", ta, v), torch.from_numpy(b),
        got_p, c["iters"])
    assert bool(torch.isfinite(x).all())
    close(x, x_ref, 1e-12, "x")
    np.testing.assert_allclose(r.numpy(), np.asarray(r_ref), rtol=0,
                               atol=1e-12)
    if c["iters"] >= N or c.get("identity"):     # the full space: exact
        want = np.linalg.solve(a, b[..., None])[..., 0]
        np.testing.assert_allclose(x.numpy(), want, rtol=1e-9, atol=1e-11)


def _real_system(n, seed):
    rng = np.random.default_rng(seed)
    dl, du, b = rng.normal(size=(3, 3, n))
    return dl, rng.normal(size=(3, n)) + 6.0, du, b


def _complex_system(n, seed):
    rng = np.random.default_rng(seed)

    def z():
        return rng.normal(size=(3, n))
    return (z(), z()), (z() + 6.0, z()), (z(), z()), (z(), z())


SIZES = [1, 2, 3, 7, 48, 65]


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("algo", ["thomas", "pcr"])
def test_tridiag_real(algo, n):
    sys_ = _real_system(n, 100 + n)
    ref_fn = {"thomas": ref_pc.tridiag_solve,
              "pcr": ref_gm.tridiag_solve_pcr}[algo]
    fn = {"thomas": gm.tridiag_solve, "pcr": gm.tridiag_solve_pcr}[algo]
    got = fn(*map(torch.from_numpy, sys_))
    close(got, ref_fn(*map(jnp.asarray, sys_)), 1e-13)
    torch.testing.assert_close(
        gm.tridiag_solve_auto(*map(torch.from_numpy, sys_), method=algo),
        got, rtol=0, atol=0)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("algo", ["thomas", "pcr"])
def test_tridiag_complex(algo, n):
    sys_ = _complex_system(n, 200 + n)
    ref_fn = {"thomas": ref_gm.tridiag_solve_complex,
              "pcr": ref_gm.tridiag_solve_complex_pcr}[algo]
    fn = {"thomas": gm.tridiag_solve_complex,
          "pcr": gm.tridiag_solve_complex_pcr}[algo]
    tsys = [tuple(map(torch.from_numpy, p)) for p in sys_]
    got = fn(*tsys)
    ref = ref_fn(*[tuple(map(jnp.asarray, p)) for p in sys_])
    auto = gm.tridiag_solve_complex_auto(*tsys, method=algo)
    for g, r, a in zip(got, ref, auto):
        close(g, r, 1e-13)
        torch.testing.assert_close(a, g, rtol=0, atol=0)


def test_tridiag_auto_follows_the_tensor():
    """A CPU tensor gets Thomas (the arithmetic the reference runs on the
    CPU); the choice is never taken from a global backend."""
    sys_ = tuple(map(torch.from_numpy, _real_system(48, 7)))
    torch.testing.assert_close(gm.tridiag_solve_auto(*sys_),
                               gm.tridiag_solve(*sys_), rtol=0, atol=0)
    csys = [tuple(map(torch.from_numpy, p)) for p in _complex_system(48, 8)]
    for a, g in zip(gm.tridiag_solve_complex_auto(*csys),
                    gm.tridiag_solve_complex(*csys)):
        torch.testing.assert_close(a, g, rtol=0, atol=0)
    assert gm.CUDA_TRIDIAG in ("thomas", "pcr")
    with pytest.raises(ValueError, match="unknown tridiagonal method"):
        gm.tridiag_solve_auto(*sys_, method="cyclic")


def test_pcr_matches_thomas():
    for n in SIZES:
        sys_ = tuple(map(torch.from_numpy, _real_system(n, 300 + n)))
        torch.testing.assert_close(gm.tridiag_solve_pcr(*sys_),
                                   gm.tridiag_solve(*sys_), rtol=1e-9,
                                   atol=1e-11)


def test_tridiag_bands_of_and_dense_solve():
    rng = np.random.default_rng(3)
    n = 16
    fem = (np.eye(n) * 2.0 / 3.0 + np.eye(n, k=1) / 6.0
           + np.eye(n, k=-1) / 6.0)
    mats = fem[None] + 0.01 * rng.normal(size=(M, n, n))
    rhs = rng.normal(size=(M, n))
    for got, ref in zip(gm.tridiag_bands_of(torch.from_numpy(mats)),
                        ref_gm.tridiag_bands_of(jnp.asarray(mats))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    for mat in (mats, fem):                       # per lane, and shared [N, N]
        got = gm.gmres_dense_solve(torch.from_numpy(mat),
                                   torch.from_numpy(rhs), 8)
        close(got, ref_gm.gmres_dense_solve(jnp.asarray(mat),
                                            jnp.asarray(rhs), 8), 1e-12)
    want = np.linalg.solve(fem, rhs.T).T          # tridiagonal mass: exact
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-12)


SHIFTED = [("line", "tridiag"), ("heat", "lines"), ("brusselator", "lines"),
           ("interleaved", "block"), ("heat", "block")]


@pytest.mark.parametrize("transposed", [False, True],
                         ids=["forward", "transposed"])
@pytest.mark.parametrize("iters", [0, 8])
@pytest.mark.parametrize("with_mass", [False, True], ids=["nomass", "mass"])
@pytest.mark.parametrize("name,precond", SHIFTED)
def test_gmres_shifted_solver(name, precond, with_mass, iters, transposed):
    case, line, blk = CASES[name]
    ref_f, f, y0, args = case()
    m, dim = y0.shape
    block = {"tridiag": 0, "lines": line, "block": blk}[precond]
    rng = np.random.default_rng(31)
    y = y0 + 0.05 * rng.normal(size=y0.shape)
    a_coef = 5.0 + rng.uniform(size=m)
    b_coef = 0.1 + 0.05 * rng.uniform(size=m)
    rhs = rng.normal(size=(m, dim))
    mass = None
    if with_mass:
        mass = (np.eye(dim) * 2.0 / 3.0 + np.eye(dim, k=1) / 6.0
                + np.eye(dim, k=-1) / 6.0)
        mass = mass[None] * (1.0 + 0.1 * rng.uniform(size=(m, 1, 1)))
    ja, ta = as_jax(args), as_torch(args)
    jt, tt = jnp.zeros(m), torch.zeros(m, dtype=torch.float64)
    jy, ty = jnp.asarray(y), torch.from_numpy(y)

    ref_pd = ref_radau.precond_probe_fn(ref_f, precond, block, dim)(jt, jy, ja)
    pd = radau.precond_probe_fn(f, precond, block, dim)(tt, ty, ta)
    close(pd, ref_pd, 1e-14, "probe data")

    ref_make = ref_radau.gmres_shifted_solver_T if transposed \
        else ref_radau.gmres_shifted_solver
    make = radau.gmres_shifted_solver_T if transposed \
        else radau.gmres_shifted_solver
    ref_out = ref_make(ref_f, jt, jy, ja, ref_pd, jnp.asarray(a_coef),
                       jnp.asarray(b_coef),
                       None if mass is None else jnp.asarray(mass), iters,
                       precond=precond, block=block)
    out = make(f, tt, ty, ta, pd, torch.from_numpy(a_coef),
               torch.from_numpy(b_coef),
               None if mass is None else torch.from_numpy(mass), iters,
               precond=precond, block=block)
    if transposed:
        ref_solve, solve = ref_out, out
    else:
        (ref_solve, ref_mdotv), (solve, mdotv) = ref_out, out
        close(mdotv(torch.from_numpy(rhs)), ref_mdotv(jnp.asarray(rhs)),
              1e-14, "mdotv")
    close(solve(torch.from_numpy(rhs)), ref_solve(jnp.asarray(rhs)), 1e-11)


def test_precond_probe_fn_guards():
    f = lambda t, y, a: -y                                       # noqa: E731
    with pytest.raises(ValueError, match="unknown precond"):
        radau.precond_probe_fn(f, "ilu", 0, 8)
    for precond in ("lines", "block"):
        with pytest.raises(ValueError, match="needs precond_block"):
            radau.precond_probe_fn(f, precond, 0, 8)
        with pytest.raises(ValueError, match="needs precond_block"):
            radau.precond_probe_fn(f, precond, 3, 8)
