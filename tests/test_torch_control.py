"""The outer control layer of the port against the JAX reference, on the CPU:
``linalg.linsolve`` / ``solve_real_complex``, ``control.newton``,
``psitc``, ``homotopy`` (with ``convex_homotopy``), ``auglag`` and
``shooting``; the twins of ``tests/test_control.py``.

The same inputs, made from a seed with numpy, in f64. Tolerances:
- pure algebra (``linsolve`` and its jvp and vjp, ``solve_real_complex``,
  ``fd_or_ad_jacobian``, one Newton or Ψtc step): 1e-13 relative (the two
  packages do the same IEEE operations; a sum of a few terms in another
  order moves the last bit);
- converged roots: 1e-10 (measured: equal to ~1e-15 on these algebraic
  systems, with the same iteration counts);
- the multiple-shooting and single-shooting roots through whole solves:
  1e-10 of the reference.

``newton_solve`` stops its Armijo trials once every running lane accepted
and computes f(x) once an iteration; a literal transcription of the
reference's body (all trials, f(x) twice, the fallback's norm recomputed)
must give x, fnorm and iters equal to the bit on lanes that need trials and
fallbacks.

The reference marks ``tests/test_control.py`` slow (jacfwd through
solves); its twins here are slow too (Ψtc to convergence, the cubic
homotopy, the augmented-Lagrangian KKT point, LQR single and multiple
shooting against the Riccati oracle, forward mode through a whole
shooting Newton). The fast tier keeps one Ψtc step, a homotopy with a
step policy, and the algebra above.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.integrate import solve_ivp as scipy_ivp

from janus_tpu import control as ref_control
from janus_tpu.control.homotopy import convex_homotopy as ref_convex
from janus_tpu.linalg import smalllu as ref_lu
from janus_tpu.solve import Options as RefOptions
from janus_tpu_torch import control
from janus_tpu_torch.control.homotopy import convex_homotopy
from janus_tpu_torch.control.newton import fd_or_ad_jacobian, fnorm_of
from janus_tpu_torch.linalg import linsolve, lu_factor, lu_ok, lu_solve
from janus_tpu_torch.linalg import solve_real_complex
from janus_tpu_torch.solve import Options, solve_ivp

torch.set_num_threads(1)

F64 = torch.float64
SLOW = pytest.mark.slow
ALG = 1e-13
ROOT = 1e-10


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


# ---- linsolve, solve_real_complex ----------------------------------------

@pytest.mark.parametrize("rhs", ["vector", "matrix"])
def test_linsolve_and_its_rules_match_reference(rng, rhs):
    m, d = 6, 4
    a = rng.standard_normal((m, d, d)) + 3.0 * np.eye(d)
    b = rng.standard_normal((m, d) if rhs == "vector" else (m, d, 2))
    da, db = rng.standard_normal(a.shape), rng.standard_normal(b.shape)
    xr, dxr = jax.jvp(ref_lu.linsolve, (jnp.asarray(a), jnp.asarray(b)),
                      (jnp.asarray(da), jnp.asarray(db)))
    x, dx = torch.func.jvp(linsolve, (_t(a), _t(b)), (_t(da), _t(db)))
    close(x, xr, ALG, ALG)
    close(dx, dxr, ALG, ALG)
    # reverse mode: the reference transposes its custom_jvp
    w = rng.standard_normal(b.shape)
    ga_r, gb_r = jax.grad(lambda aa, bb: jnp.sum(
        ref_lu.linsolve(aa, bb) * w), argnums=(0, 1))(jnp.asarray(a),
                                                     jnp.asarray(b))
    at, bt = _t(a).requires_grad_(True), _t(b).requires_grad_(True)
    (linsolve(at, bt) * _t(w)).sum().backward()
    close(at.grad, ga_r, ALG, ALG)
    close(bt.grad, gb_r, ALG, ALG)
    # vmap over jvp: N directions, one factorization
    dirs = rng.standard_normal((3,) + b.shape)
    cols = torch.func.vmap(lambda v: torch.func.jvp(
        lambda bb: linsolve(_t(a), bb), (_t(b),), (v,))[1])(_t(dirs))
    cols_r = jax.vmap(lambda v: jax.jvp(
        lambda bb: ref_lu.linsolve(jnp.asarray(a), bb), (jnp.asarray(b),),
        (v,))[1])(jnp.asarray(dirs))
    close(cols, cols_r, ALG, ALG)


def test_solve_real_complex_matches_reference(rng):
    m, d = 5, 3
    ar, ai = (rng.standard_normal((m, d, d)) + 3.0 * np.eye(d),
              rng.standard_normal((m, d, d)))
    br, bi = rng.standard_normal((m, d)), rng.standard_normal((m, d))
    want = ref_lu.solve_real_complex(*(jnp.asarray(v) for v in
                                       (ar, ai, br, bi)))
    got = solve_real_complex(*(_t(v) for v in (ar, ai, br, bi)))
    for g, w in zip(got, want):
        close(g, w, ALG, ALG)
    z = np.linalg.solve(ar + 1j * ai, (br + 1j * bi)[..., None])[..., 0]
    close(got[0], z.real, 1e-12, 1e-12)
    close(got[1], z.imag, 1e-12, 1e-12)


# ---- newton --------------------------------------------------------------

def _cubic(lib):
    """A coupled cubic system with one root per lane; lanes far from it
    need Armijo trials, and the lane at x0 = (-3, 3) needs the fallback."""
    def f(x):
        u, v = x[..., 0], x[..., 1]
        return lib.stack([u ** 3 + v - 1.0, lib.sin(u) + 2.0 * v - 0.5 * u],
                         -1)
    return f


X0_CUBIC = np.array([[0.2, 0.1], [4.0, -3.0], [-3.0, 3.0], [10.0, 0.0],
                     [0.0, 0.0]])


@pytest.mark.parametrize("mode", ["ad", "fd"])
def test_fd_or_ad_jacobian_matches_reference(mode):
    from janus_tpu.control.newton import fd_or_ad_jacobian as ref_jac
    want = ref_jac(_cubic(jnp), jnp.asarray(X0_CUBIC), mode)
    got = fd_or_ad_jacobian(_cubic(torch), _t(X0_CUBIC), mode)
    close(got, want, ALG, ALG)


@pytest.mark.parametrize("mode", ["ad", "fd"])
@pytest.mark.parametrize("max_iter", [1, 50])
def test_newton_matches_reference(max_iter, mode):
    want = ref_control.newton_solve(_cubic(jnp), jnp.asarray(X0_CUBIC),
                                    tol=1e-12, max_iter=max_iter,
                                    jac_mode=mode)
    got = control.newton_solve(_cubic(torch), _t(X0_CUBIC), tol=1e-12,
                               max_iter=max_iter, jac_mode=mode)
    tol = ALG if max_iter == 1 else ROOT
    close(got.x, want.x, tol, tol)
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    if max_iter == 1:
        close(got.fnorm, want.fnorm, ALG, ALG)
    else:
        assert got.converged.all()


def _newton_all_trials(f, x0, tol, max_iter, max_backtracks, armijo=1e-4):
    """The reference's body transcribed literally in torch: every Armijo
    trial, f(x) written twice, the fallback's norm evaluated afresh."""
    x = x0
    m = x.shape[0]
    fn = fnorm_of(f(x))
    convd = torch.zeros(m, dtype=torch.bool)
    it = torch.zeros(m, dtype=torch.int32)
    running = torch.ones(m, dtype=torch.bool)
    while bool(running.any()):
        jmat = fd_or_ad_jacobian(f, x, "ad")
        lu, piv = lu_factor(jmat)
        ok = lu_ok(lu)
        step = lu_solve(lu, piv, -f(x))
        step = torch.where(ok[:, None], step, -f(x) * 0.01)
        lam = torch.ones(m, dtype=x.dtype)
        best_x = x + step
        best_fn = fnorm_of(f(best_x))
        accepted = best_fn <= (1.0 - armijo) * fn
        for _ in range(max_backtracks):
            lam = torch.where(accepted, lam, lam * 0.5)
            cand = x + lam[:, None] * step
            cfn = fnorm_of(f(cand))
            better = ~accepted & (cfn <= (1.0 - armijo * lam) * fn)
            best_x = torch.where(better[:, None], cand, best_x)
            best_fn = torch.where(better, cfn, best_fn)
            accepted = accepted | better
        fallback = ~accepted
        best_x = torch.where(fallback[:, None], x + lam[:, None] * step,
                             best_x)
        best_fn = torch.where(fallback, fnorm_of(f(best_x)), best_fn)
        x = torch.where(running[:, None], best_x, x)
        fn = torch.where(running, best_fn, fn)
        it = it + running.to(torch.int32)
        conv_now = running & (fn < tol)
        stalled = running & (it >= max_iter)
        convd = convd | conv_now
        running = running & ~conv_now & ~stalled
    return x, fn, convd, it


@pytest.mark.parametrize("max_backtracks", [8, 2, 0])
def test_newton_trial_stop_and_single_f_change_no_bit(max_backtracks):
    """Stopping the trials once every running lane accepted, and one f(x)
    an iteration, leave x, fnorm and iters equal to the bit."""
    f = _cubic(torch)
    got = control.newton_solve(f, _t(X0_CUBIC), tol=1e-12,
                               max_iter=40, max_backtracks=max_backtracks)
    want = _newton_all_trials(f, _t(X0_CUBIC), 1e-12, 40, max_backtracks)
    for g, w in zip((got.x, got.fnorm, got.converged, got.iters), want):
        assert torch.equal(g, w)
    # some lanes needed trials (else the test shows nothing)
    assert int(got.iters.max()) > 5


# ---- psitc, homotopy, auglag ---------------------------------------------

@pytest.mark.parametrize("controller", ["ser-a", "ser-b"])
@pytest.mark.parametrize("max_iter", [1, pytest.param(200, marks=SLOW)])
def test_psitc_arctan_matches_reference(controller, max_iter):
    """Plain Newton diverges on arctan from |x| > 1.39; Ψtc converges."""
    x0 = np.array([[3.0], [-2.0], [10.0]])
    want = ref_control.psitc(lambda x: jnp.arctan(5.0 * x), jnp.asarray(x0),
                             delta0=0.5, controller=controller, tol=1e-10,
                             max_iter=max_iter)
    got = control.psitc(lambda x: torch.atan(5.0 * x), _t(x0), delta0=0.5,
                        controller=controller, tol=1e-10, max_iter=max_iter)
    tol = ALG if max_iter == 1 else ROOT
    close(got.x, want.x, tol, 1e-300 if max_iter == 1 else 1e-12)
    close(got.delta, want.delta, ALG)
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    if max_iter > 1:
        assert got.converged.all()
        close(got.x, 0.0, 0.0, 1e-9)


@pytest.mark.slow
def test_psitc_heterogeneous_lanes():
    """Lanes with different conditioning converge independently."""
    x0 = np.array([[4.0, 2.0], [-4.0, -3.0]])

    def f(lib, atan):
        return lambda x: lib.stack([atan(3 * x[:, 0]),
                                    x[:, 1] ** 3 + x[:, 1] - 1.0], -1)

    want = ref_control.psitc(f(jnp, jnp.arctan), jnp.asarray(x0),
                             delta0=0.5, tol=1e-10)
    got = control.psitc(f(torch, torch.atan), _t(x0), delta0=0.5, tol=1e-10)
    assert got.converged.all()
    close(got.x, want.x, ROOT, 1e-12)
    close(got.x[:, 0], 0.0, 0.0, 1e-8)
    close(got.x[:, 1], 0.6823278038280193, 1e-8)   # real root of x³+x−1


def test_psitc_rejects_unknown_controller():
    with pytest.raises(ValueError, match="controller"):
        control.psitc(lambda x: x, torch.zeros(1, 1, dtype=F64),
                      controller="ser-c")


@pytest.mark.parametrize("policy", [pytest.param("reactive", marks=SLOW),
                                    "learned"])
def test_homotopy_cubic_matches_reference(policy):
    """x³ − 3x + 3 = 0: Newton from 0 cycles; homotopy tracks the root."""
    x0 = np.zeros((2, 1))
    kw = {}
    if policy == "learned":
        kw_ref = {"dlam_fn": lambda x, lam, dl: 0.7 * dl + 0.02}
        kw = {"dlam_fn": lambda x, lam, dl: 0.7 * dl + 0.02}
    else:
        kw_ref = {}
    g_ref = ref_convex(lambda x: x ** 3 - 3.0 * x + 3.0, jnp.asarray(x0))
    want = ref_control.homotopy(g_ref, jnp.asarray(x0), dlam0=0.05,
                                tol=1e-10, **kw_ref)
    g = convex_homotopy(lambda x: x ** 3 - 3.0 * x + 3.0, _t(x0))
    got = control.homotopy(g, _t(x0), dlam0=0.05, tol=1e-10, **kw)
    assert got.converged.all()
    close(got.x, want.x, ROOT)
    close(got.lam, want.lam, 0.0)
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    close(got.x, -2.1038034027355366, 1e-8)


@pytest.mark.slow
def test_auglag_quadratic_kkt_matches_reference():
    """min ½‖x‖² s.t. Σx = 1 → x = 1/n, λ = −1/n."""
    want = ref_control.augmented_lagrangian(
        lambda x: 0.5 * jnp.sum(x * x, -1),
        lambda x: (jnp.sum(x, -1) - 1.0)[:, None], jnp.zeros((2, 4)))
    got = control.augmented_lagrangian(
        lambda x: 0.5 * torch.sum(x * x, -1),
        lambda x: (torch.sum(x, -1) - 1.0)[:, None],
        torch.zeros((2, 4), dtype=F64))
    assert got.converged.all() and got.outer_iters == want.outer_iters
    close(got.x, want.x, ROOT)
    close(got.lam, want.lam, ROOT)
    close(got.x, 0.25, 1e-6)
    close(got.lam, -0.25, 1e-4)


# ---- shooting (slow, as the reference's) ---------------------------------

A_, B_, Q_, R_, T_ = -1.0, 1.0, 2.0, 1.0, 1.0


def _lqr_rhs(lib):
    def rhs(t, y, args):
        x, p = y[..., 0], y[..., 1]
        return lib.stack([A_ * x - (B_ ** 2 / R_) * p, -Q_ * x - A_ * p],
                         -1)
    return rhs


def _riccati_p0():
    sol = scipy_ivp(lambda t, P: -(2 * A_ * P - (B_ ** 2 / R_) * P ** 2
                                   + Q_), (T_, 0.0), [0.0], rtol=1e-12,
                    atol=1e-14)
    return sol.y[0, -1]


@pytest.mark.slow
def test_lqr_single_shooting_vs_riccati():
    x0s = np.array([1.0, 2.0, -0.5])

    def residual(p0):
        y0 = torch.stack([_t(x0s), p0[:, 0]], dim=-1)
        sol = solve_ivp(_lqr_rhs(torch), (0.0, T_), y0, method="radau",
                        rtol=1e-10, atol=1e-13)
        return sol.y[:, 1:2]            # p(T) = 0

    res = control.single_shooting(residual, torch.zeros((3, 1), dtype=F64),
                                  tol=1e-10)
    assert res.converged.all()
    close(res.x[:, 0], _riccati_p0() * x0s, 1e-7)


@pytest.mark.slow
def test_lqr_multiple_shooting_matches_reference():
    x0 = 1.5
    t_nodes = np.linspace(0.0, T_, 5)   # 4 segments

    def bc(lib):
        return lambda ya, yb: lib.stack([ya[:, 0] - x0, yb[:, 1]], -1)

    ref_res = ref_control.multiple_shooting_residual(
        _lqr_rhs(jnp), jnp.asarray(t_nodes), bc(jnp), method="radau",
        options=RefOptions(rtol=1e-10, atol=1e-13))
    res_fn = control.multiple_shooting_residual(
        _lqr_rhs(torch), t_nodes, bc(torch), method="radau",
        options=Options(rtol=1e-10, atol=1e-13))
    z0 = np.tile(np.array([[x0, 0.0]]), (1, 4))
    want = ref_control.newton_solve(ref_res, jnp.asarray(z0), tol=1e-9)
    got = control.newton_solve(res_fn, _t(z0), tol=1e-9)
    assert got.converged.all()
    close(got.x, want.x, ROOT, 1e-12)
    close(float(got.x[0, 1]), _riccati_p0() * x0, 1e-6)


@pytest.mark.slow
def test_shooting_is_differentiable_forward_mode():
    """torch.func.jacfwd through a whole single-shooting Newton (its host
    loop reads primals): dp0/dx0 of the LQR problem, linear in x0."""
    def solve_p0(x0):
        def residual(p0):
            y0 = torch.stack([x0.expand(1), p0[:, 0]], dim=-1)
            sol = solve_ivp(_lqr_rhs(torch), (0.0, T_), y0, method="radau",
                            rtol=1e-10, atol=1e-13)
            return sol.y[:, 1:2]
        return control.single_shooting(
            residual, torch.zeros((1, 1), dtype=F64), tol=1e-10).x[0, 0]

    x0 = torch.tensor(1.0, dtype=F64)
    close(float(solve_p0(x0)), _riccati_p0(), 1e-7)
    close(float(torch.func.jacfwd(solve_p0)(x0)), _riccati_p0(), 1e-5)
