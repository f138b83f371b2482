"""Shooting for PMP optimal control in the port against the JAX reference,
on the CPU: the main path of ``janus_tpu_torch.bench.control`` (batched
multiple-shooting PMP Van der Pol, Newton with the Jacobian from one IND
solve) and the twins of ``tests/test_pmp_vdp.py``,
``tests/test_pmp_stationarity.py``, ``tests/test_dubins.py`` and the
IND-Jacobian Newton of ``tests/test_radau_tangents.py:266``.

Fast tier (the main path's parity on a cheap case, 4 instances, mu =
linspace(0, 1, 4), S = 4 segments, Radau5 rtol 1e-8): the multiple-shooting
residual against the reference's at z0 and at a perturbed point
(solve-bearing residual: 1e-10), the IND block Jacobian against the AD
Jacobian (``torch.func.vmap`` over jvp of the residual) and one Newton
iteration through each. The AD Jacobian differentiates the step-size
controller too, which the IND sweep leaves out (an O(rtol) term, as in
both packages): measured 1.5e-6 relative to the Jacobian's largest entry
and 9.4e-6 in x after one iteration (|x| ~ 1.8), so the bounds are 1e-5 and
5e-5; the converged roots agree within 1e-7 (the bound of the reference's
IND-Newton test; measured 1.8e-10 here and 7.1e-10 at 1,024 instances on
the card). Slow tier (the reference marks these files slow): the Newtons
to convergence against the reference's root (1e-10 for the AD route's,
1e-7 between the IND and AD roots), the homotopy to mu = 5, single
shooting, the Dubins steering and stationarity problems.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janus_tpu import control as ref_control
from janus_tpu.solve import Options as RefOptions
from janus_tpu.solve import solve_ivp as ref_solve_ivp
from janus_tpu_torch import control, ham
from janus_tpu_torch.bench import control as probe
from janus_tpu_torch.control.newton import fd_or_ad_jacobian
from janus_tpu_torch.models.problems import dubins_pmp_rhs, dubins_rhs
from janus_tpu_torch.solve import Options, solve_ivp

torch.set_num_threads(1)

F64 = torch.float64
CPU = torch.device("cpu")
RESIDUAL = 1e-10
IND_VS_AD_JACOBIAN = 1e-5
IND_VS_AD_STEP = 5e-5
ROOTS_IND_VS_AD = 1e-7
ROOT = 1e-10
SLOW = pytest.mark.slow


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def ref_pmp_rhs(t, y, mu):
    x1, x2, p1, p2 = y[..., 0], y[..., 1], y[..., 2], y[..., 3]
    mu = jnp.broadcast_to(jnp.asarray(mu, y.dtype), x1.shape)
    return jnp.stack([
        x2,
        mu * (1 - x1 ** 2) * x2 - x1 - p2,
        p2 * (2 * mu * x1 * x2 + 1.0),
        -p1 - p2 * mu * (1 - x1 ** 2),
    ], axis=-1)


def ref_ms_residual(mu, nseg=probe.NSEG):
    x0 = jnp.asarray(probe.X0)

    def bc(y_start, y_end):
        return jnp.concatenate([y_start[:, :2] - x0[None], y_end[:, :2]],
                               axis=-1)

    return ref_control.multiple_shooting_residual(
        ref_pmp_rhs, jnp.linspace(0.0, probe.TF, nseg + 1), bc,
        method="radau", args=mu,
        options=RefOptions(rtol=1e-8, atol=1e-11))


def _point(perturbed):
    z = probe.z0(4, CPU)
    if perturbed:
        z = z + 0.1 * _t(np.random.default_rng(7).standard_normal(z.shape))
    return z


@pytest.mark.parametrize("perturbed", [False, True], ids=["z0", "z0+dz"])
def test_ms_residual_matches_reference(perturbed):
    mu = probe.mus(4, CPU)
    z = _point(perturbed)
    want = ref_ms_residual(jnp.asarray(mu.numpy()))(jnp.asarray(z.numpy()))
    for kernel_lu in (False, True):
        got = probe.ms_residual(mu, kernel_lu)(z)
        close(got, want, RESIDUAL, RESIDUAL)


def test_ms_ind_jacobian_and_one_newton_step_match_ad():
    """The IND block Jacobian (one solve with identity tangents) against
    the AD Jacobian of the residual, and one Newton iteration through
    each."""
    mu = probe.mus(4, CPU)
    z = probe.z0(4, CPU)
    j_ind = probe.ind_jacobian(mu, True)(z)
    j_ad = fd_or_ad_jacobian(probe.ms_residual(mu, False), z, "ad")
    err = float((j_ind - j_ad).abs().max() / j_ad.abs().max())
    assert err <= IND_VS_AD_JACOBIAN, err
    one_ind = control.newton_solve(probe.ms_residual(mu, True), z,
                                   max_iter=1, jac=lambda zz: j_ind)
    one_ad = control.newton_solve(probe.ms_residual(mu, False), z,
                                  max_iter=1, jac=lambda zz: j_ad)
    close(one_ind.x, one_ad.x, 0.0, IND_VS_AD_STEP)
    np.testing.assert_array_equal(one_ind.iters.numpy(), [1, 1, 1, 1])


@SLOW
def test_ms_newton_ind_and_ad_match_reference():
    mu = probe.mus(4, CPU)
    r_ind = probe.ind_newton(mu, True)
    r_ad = control.newton_solve(probe.ms_residual(mu, False),
                                probe.z0(4, CPU), tol=probe.NEWTON_TOL)
    want = ref_control.newton_solve(ref_ms_residual(jnp.asarray(mu.numpy())),
                                    jnp.asarray(probe.z0(4, CPU).numpy()),
                                    tol=probe.NEWTON_TOL)
    assert r_ind.converged.all() and r_ad.converged.all()
    close(r_ad.x, want.x, ROOT, ROOT)
    close(r_ind.x, r_ad.x, 0.0, ROOTS_IND_VS_AD)
    np.testing.assert_array_equal(r_ad.iters.numpy(), np.asarray(want.iters))
    assert probe.forward_worst(r_ind.x, mu) <= probe.FORWARD_BOUND


@SLOW
def test_single_shooting_mild():
    def residual(p0):
        y0 = torch.cat([_t([probe.X0]).expand(p0.shape[0], 2), p0], dim=-1)
        sol = solve_ivp(probe.pmp_rhs, (0.0, probe.TF), y0, method="radau",
                        args=1.0, options=Options(rtol=1e-9, atol=1e-12))
        return sol.y[:, :2]

    res = control.single_shooting(residual, torch.zeros((1, 2), dtype=F64),
                                  tol=1e-8)
    assert res.converged[0] and float(res.fnorm[0]) < 1e-8


@SLOW
def test_multishoot_homotopy_to_stiff():
    """Continuation 0 → mu=5 on the multiple-shooting unknowns."""
    mu_t = 5.0
    zero = torch.zeros(1, dtype=F64)
    res = control.newton_solve(probe.ms_residual(zero, False),
                               probe.z0(1, CPU), tol=1e-8)
    assert res.converged[0]

    def g(z, lam):
        return probe.ms_residual(lam * mu_t, False)(z)

    h = control.homotopy(g, res.x, dlam0=0.5, tol=1e-6, newton_iters=5)
    assert h.converged[0], float(h.lam[0])
    final = probe.ms_residual(torch.full((1,), mu_t, dtype=F64), False)(h.x)
    assert float(torch.linalg.vector_norm(final)) < 1e-6
    # the terminal state reaches the origin when integrated forward
    sol = solve_ivp(probe.pmp_rhs, (0.0, probe.TF), h.x[:, :4].contiguous(),
                    method="radau", args=mu_t,
                    options=Options(rtol=1e-10, atol=1e-13))
    close(sol.y[0, :2], 0.0, 0.0, 1e-5)


# ---- the IND-Jacobian Newton of tests/test_radau_tangents.py:266 -----------

@SLOW
def test_shooting_newton_with_ind_jacobian_matches_reference():
    """Hit a y-target for a batch of damped oscillators with the Newton
    Jacobian from ONE IND solve; it must match the AD-Jacobian Newton and
    the reference's root."""
    from janus_tpu_torch.solve.radau import solve_radau

    m, d = 3, 2
    target = np.array([[0.3, -0.1], [0.0, 0.5], [-0.2, -0.2]])
    ks = np.array([1.0, 2.0, 4.0])
    tf = 1.3

    def rhs(lib):
        return lambda t, y, k: lib.stack(
            [y[..., 1], -k * y[..., 0] - 0.2 * y[..., 1]], -1)

    opts = Options(rtol=1e-10, atol=1e-13)
    seeds = torch.eye(d, dtype=F64)[:, None, :].expand(d, m, d).contiguous()

    def residual(x):
        return solve_radau(rhs(torch), 0.0, tf, x, args=_t(ks),
                           options=opts).y - _t(target)

    def ind_jac(x):
        sol = solve_radau(rhs(torch), 0.0, tf, x, args=_t(ks), options=opts,
                          tangents=seeds)
        return sol.sens.permute(1, 2, 0)            # [M, D(out), D(in)]

    x0 = torch.zeros((m, d), dtype=F64)
    r_ind = control.newton_solve(residual, x0, tol=1e-9, jac=ind_jac)
    r_ad = control.newton_solve(residual, x0, tol=1e-9)
    assert r_ind.converged.all() and r_ad.converged.all()
    close(r_ind.x, r_ad.x, 1e-7, 1e-9)
    want = ref_control.newton_solve(
        lambda x: ref_solve_ivp(rhs(jnp), (0.0, tf), x, method="radau",
                                args=jnp.asarray(ks),
                                options=RefOptions(rtol=1e-10, atol=1e-13)).y
        - jnp.asarray(target), jnp.zeros((m, d)), tol=1e-9)
    close(r_ad.x, want.x, ROOT, 1e-12)
    close(residual(r_ind.x) + _t(target), target, 1e-7, 1e-8)


# ---- Dubins ----------------------------------------------------------------

@SLOW
def test_dubins_circle():
    """Constant turn rate traces a circle of radius v/u."""
    sol = solve_ivp(dubins_rhs, (0.0, 2 * np.pi / 0.5),
                    torch.zeros((1, 3), dtype=F64),
                    args={"v": 1.0, "u": 0.5}, rtol=1e-10, atol=1e-12)
    close(sol.y[0], [0.0, 0.0, 2 * np.pi], 0.0, 1e-6)


@SLOW
def test_dubins_pmp_steering():
    """Steer to a target position (free heading) in fixed time by shooting
    on the initial costates (smoothed control)."""
    args = {"v": 1.0, "umax": 2.0, "eps": 0.2}
    target = _t([1.2, 0.8])
    tf = 2.0

    def residual(p0):
        y0 = torch.cat([torch.zeros((p0.shape[0], 3), dtype=F64), p0],
                       dim=-1)
        sol = solve_ivp(dubins_pmp_rhs, (0.0, tf), y0, method="radau",
                        args=args, options=Options(rtol=1e-9, atol=1e-12))
        return torch.cat([sol.y[:, :2] - target[None], sol.y[:, 5:6]],
                         dim=-1)

    res = control.single_shooting(residual, _t([[0.1, 0.1, 0.1]]),
                                  tol=1e-8)
    assert res.converged[0], float(res.fnorm[0])
    y0 = torch.cat([torch.zeros((1, 3), dtype=F64), res.x], dim=-1)
    sol = solve_ivp(dubins_pmp_rhs, (0.0, tf), y0, method="radau",
                    args=args, options=Options(rtol=1e-10, atol=1e-13))
    close(sol.y[0, :2], target, 0.0, 1e-7)


# ---- PMP stationarity (Hu partials) ------------------------------------------

V, LAM, TF_D, N_INT = 1.0, 0.5, 2.0, 6
TARGET = (1.2, 0.8)


def dubins_h(x, p, u, args):
    """H = L + p·f for min time + (lam/2)u² regularization."""
    th = x[2]
    return (1.0 + 0.5 * LAM * u[0] ** 2 + p[0] * V * torch.cos(th)
            + p[1] * V * torch.sin(th) + p[2] * u[0])


@SLOW
def test_grad_u_fd_vs_ad():
    rng = np.random.RandomState(0)
    x, p, u = _t(rng.randn(3)), _t(rng.randn(3)), _t(rng.randn(1))
    gu = ham.grad_u(dubins_h)(x, p, u, None)
    eps = 1e-6
    fd = (dubins_h(x, p, u + eps, None) - dubins_h(x, p, u - eps, None)) \
        / (2 * eps)
    close(float(gu[0]), float(fd), 1e-6)
    close(float(ham.hessian_uu(dubins_h)(x, p, u, None)[0, 0]), LAM, 1e-10)
    close(ham.hessian_up(dubins_h)(x, p, u, None), [[0.0, 0.0, 1.0]], 0.0,
          1e-12)


@SLOW
def test_pmp_dynamics_u_signs():
    """pmp_dynamics_u gives xdot = +dH/dp, pdot = −dH/dx."""
    f = ham.pmp_dynamics_u(dubins_h, batched=True)
    dy = f(0.0, _t([[0.3, -0.2, 0.7, 0.1, 0.2, 1.1]]), _t([[0.4]]), None)
    th = 1.1
    close(dy[0, 3:], [V * np.cos(th), V * np.sin(th), 0.4], 1e-6)
    close(dy[0, :3], [0.0, 0.0, 0.3 * V * np.sin(th)
                      - (-0.2) * V * np.cos(th)], 1e-6, 1e-12)


def _solve_continuous():
    """Folded-feedback reference: u* = −p3/lam (from dH/du = 0) inside f."""
    def rhs(t, y, args):
        p, x = y[..., :3], y[..., 3:]
        u = -p[..., 2:3] / LAM
        th = x[..., 2]
        xdot = torch.stack([V * torch.cos(th), V * torch.sin(th),
                            u[..., 0]], -1)
        pdot = torch.stack([torch.zeros_like(th), torch.zeros_like(th),
                            p[..., 0] * V * torch.sin(th)
                            - p[..., 1] * V * torch.cos(th)], -1)
        return torch.cat([pdot, xdot], -1)

    opts = Options(rtol=1e-7, atol=1e-10)

    def residual(p0):
        y0 = torch.cat([p0, torch.zeros_like(p0)], -1)
        sol = solve_ivp(rhs, (0.0, TF_D), y0, method="dopri853",
                        options=opts)
        return torch.cat([sol.y[:, 3:5] - _t([TARGET]), sol.y[:, 2:3]], -1)

    res = control.newton_solve(residual, _t([[1.5, 1.3, 0.3]]), tol=1e-7)
    assert res.converged[0]
    y0 = torch.cat([res.x, torch.zeros_like(res.x)], -1)
    dt = TF_D / N_INT
    nodes = solve_ivp(rhs, (0.0, TF_D), y0, method="dopri853", options=opts,
                      t_eval=torch.arange(N_INT, dtype=F64) * dt)
    mids = solve_ivp(rhs, (0.0, TF_D), y0, method="dopri853", options=opts,
                     t_eval=torch.arange(N_INT, dtype=F64) * dt + dt / 2)
    return res.x, -nodes.ys[:, :, 2] / LAM, -mids.ys[:, :, 2] / LAM


def test_odeint_fixed_runs_a_torch_func_rhs():
    """odeint_fixed with remat (the default) runs an rhs built on
    torch.func (ham.pmp_dynamics_u), plainly and under torch.func.jvp,
    equal to the bit to remat=False: a step is checkpointed only when
    autograd records it (the checkpoint's hooks refuse torch.func)."""
    from janus_tpu_torch.solve.fixed import odeint_fixed

    f_u = ham.pmp_dynamics_u(dubins_h, batched=True)

    def rhs(t, y, a):
        return f_u(t, y, a[1][:, None], None)

    y0 = _t([[1.5, 1.3, 0.3, 0.0, 0.0, 0.0]])
    slab = _t(np.linspace(-0.5, 0.5, 16)[:, None])

    def run(yy, remat):
        return odeint_fixed(rhs, 0.0, TF_D, yy, 16, step_args=slab,
                            remat=remat)

    assert torch.equal(run(y0, True), run(y0, False))
    dy = torch.ones_like(y0)
    assert torch.equal(torch.func.jvp(lambda yy: run(yy, True), (y0,),
                                      (dy,))[1],
                       torch.func.jvp(lambda yy: run(yy, False), (y0,),
                                      (dy,))[1])


@SLOW
def test_dubins_solved_via_stationarity_residual():
    """Direct transcription on a fixed control-aligned grid: unknowns
    [p0, u_1..u_N], residuals = boundary conditions + dH/du = 0 at the
    interval midpoints; warm-started from a perturbed folded-feedback
    solution, Newton must agree with the continuous solve."""
    from janus_tpu_torch.solve.fixed import odeint_fixed

    spi = 8                                  # fixed RK4 steps per interval
    f_u = ham.pmp_dynamics_u(dubins_h, batched=True)
    r_stat = ham.stationarity_residual(dubins_h, batched=True)

    def rhs(t, y, a):
        _, u_k = a                           # per-step control slab [M]
        return f_u(t, y, u_k[:, None], None)

    def residual(z):
        m = z.shape[0]
        p0, us = z[:, :3], z[:, 3:]
        y0 = torch.cat([p0, torch.zeros_like(p0)], -1)
        slab = us[:, torch.arange(N_INT * spi) // spi].T      # [S, M]
        y_end, traj = odeint_fixed(rhs, 0.0, TF_D, y0, N_INT * spi,
                                   step_args=slab, save_trajectory=True)
        bc = torch.cat([y_end[:, 3:5] - _t([TARGET]), y_end[:, 2:3]], -1)
        nodes = traj[spi // 2::spi][:N_INT]                    # [N, M, 6]
        pk = nodes[:, :, :3].reshape(N_INT * m, 3)
        xk = nodes[:, :, 3:].reshape(N_INT * m, 3)
        uk = us.T.reshape(N_INT * m, 1)
        stat = r_stat(xk, pk, uk, None).reshape(N_INT, m).T   # [M, N]
        return torch.cat([bc, stat], -1)

    p0_cont, u_nodes, u_mids = _solve_continuous()
    z0 = torch.cat([p0_cont * 1.15 + 0.02, u_nodes * 1.2 - 0.05], -1)
    assert float(torch.linalg.vector_norm(residual(z0))) > 1e-2
    res = control.newton_solve(residual, z0, tol=1e-8, max_iter=30)
    assert res.converged[0], float(res.fnorm[0])
    close(res.x[:, :3], p0_cont, 0.08, 0.03)
    us_sol = res.x[0, 3:].numpy()
    close(us_sol, u_mids[0], 0.25, 0.25)
    assert np.ptp(us_sol) > 1e-3             # nontrivial arc
