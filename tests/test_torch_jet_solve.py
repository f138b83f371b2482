"""The port's dual-number solves (``janus_tpu_torch.jet.solve``) against the
JAX reference's ``janus_tpu.jet.solve``, on the CPU in float64; the twin of
``tests/test_dual_solve_and_training.py`` and of the routing tests
``test_ndf.py:365``, ``test_radaup.py:208``, ``test_rodas.py:208`` and
``test_seulex.py:216``.

Tolerances: against the reference, status and the counters equal, y to
1e-10 and the sensitivities to 1e-7 relative to the largest entry (the
families' parity bounds, ROADMAP Queue 3); the transform path against the
closed form to 1e-8. The reference's own oracles (central differences of
re-solves, dy/dT = f(T, y(T)), forward against reverse mode, the training
loss drop) run on the port at the reference's bounds. The routing tests
hold the fast path to "no fallback warning" (the warning turned into an
error by its text: torch's own deprecation warnings are not the
reference's concern) and the fallback to the reference's warning, word for
word. The reference's tight-tolerance cases (rtol 1e-10..1e-11) take the
eager port 10-30 s each on one CPU core, so they are ``slow`` and a cheaper
case of each runs in the fast tier.
"""

import contextlib
import re
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janus_tpu.jet.core import Jet as RefJet
from janus_tpu.jet.solve import dual_solve_ivp as ref_dual_solve_ivp
from janus_tpu.models.neural import mlp_apply as ref_mlp_apply
from janus_tpu.models.neural import mlp_init as ref_mlp_init
from janus_tpu.models.problems import harmonic_rhs as ref_harmonic_rhs
from janus_tpu.solve import Options as RefOptions
from janus_tpu.solve.fixed import odeint_fixed as ref_odeint_fixed
from janus_tpu_torch.interop import tree_to_torch
from janus_tpu_torch.jet import Jet, seed_identity
from janus_tpu_torch.jet.solve import dual_solve_ivp, solve_with_sensitivities
from janus_tpu_torch.models.neural import mlp_apply
from janus_tpu_torch.models.problems import harmonic_rhs, vdp_rhs
from janus_tpu_torch.solve import SUCCESS, Event, Options, solve_ivp
from janus_tpu_torch.solve.fixed import odeint_fixed

torch.set_num_threads(1)
F64 = torch.float64
FALLBACK = "dual_solve_ivp: falling back"
STATS = ("nfev", "njev", "nlu", "nsteps", "naccept", "nreject", "nnewton")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(float(np.abs(want).max()),
                                              1e-300))


@contextlib.contextmanager
def no_fallback():
    """A context in which the transform's fallback warning raises."""
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=FALLBACK)
        yield


def _seeds(m, dim, n):
    """[n, m, dim] unit seeds in the first min(n, dim) components."""
    s = np.zeros((n, m, dim))
    for k in range(min(n, dim)):
        s[k, :, k] = 1.0
    return s


# -- against the reference ----------------------------------------------------

def test_transform_path_matches_reference_and_closed_form():
    """dopri5 has no IND sweep: vmap over jvp of the whole solve, with a
    Jet omega and a Jet y0 (N = 3)."""
    rng = np.random.default_rng(20)
    m = 3
    y0 = rng.standard_normal((m, 2))
    om = rng.uniform(0.5, 2.0, m)
    s_y0 = _seeds(m, 2, 3)
    s_om = np.zeros((3, m))
    s_om[2] = 1.0
    ry, rt, rsol = ref_dual_solve_ivp(
        ref_harmonic_rhs, (0.0, 2.0), RefJet(jnp.asarray(y0),
                                             jnp.asarray(s_y0)),
        method="dopri5", args=RefJet(jnp.asarray(om), jnp.asarray(s_om)),
        options=RefOptions(rtol=1e-10, atol=1e-12))
    gy, gt, gsol = dual_solve_ivp(
        harmonic_rhs, (0.0, 2.0), Jet(_t(y0), _t(s_y0)), method="dopri5",
        args=Jet(_t(om), _t(s_om)), rtol=1e-10, atol=1e-12)
    for k in ("naccept", "nreject", "nfev"):
        np.testing.assert_array_equal(gsol.stats[k].numpy(),
                                      np.asarray(rsol.stats[k]))
    close(gy.r, ry.r, 1e-10)
    close(gy.d, ry.d, 1e-7)
    close(gt.d, rt.d, 0.0)
    # the closed form of q'' = -omega^2 q
    t = 2.0
    q0, v0, w = y0[:, 0], y0[:, 1], om
    c, s = np.cos(w * t), np.sin(w * t)
    want = np.stack([
        np.stack([c, -w * s], -1), np.stack([s / w, c], -1),
        np.stack([-q0 * t * s + v0 * (t * c / w - s / w ** 2),
                  -q0 * (s + w * t * c) - v0 * t * s], -1)])
    np.testing.assert_allclose(gy.d.numpy(), want, atol=1e-8)


def _ham_case():
    """The card's Hamiltonian VdP cell at 4 lanes: y = [p, x], x0 = (2, 0),
    p0 = (linspace(0.1, 1, 4), 0), mu = 100, t in [0, 0.1], Radau9, rtol
    1e-6, pivoting=False; N = 6 directions: the identity in y0, a mu
    column (a Jet args leaf) and a tf column (a Jet tf)."""
    y0 = np.zeros((4, 4))
    y0[:, 0] = np.linspace(0.1, 1.0, 4)
    y0[:, 2] = 2.0
    s_y0 = _seeds(4, 4, 6)
    s_mu = np.eye(6)[4]
    s_tf = np.eye(6)[5]
    return y0, s_y0, s_mu, s_tf


def test_ham_fast_path_matches_reference():
    """dual_solve_ivp on ham.hamiltonian_dynamics(vdp_hamiltonian) with its
    ham.hamiltonian_jacobian, a Jet y0, a Jet mu and a Jet tf at once,
    through the kernels' twins (kernel_lu=True), against the reference's
    (pallas_lu=False: the same pivot-free arithmetic)."""
    from janus_tpu import ham as ref_ham
    from janus_tpu.models.problems import (
        vdp_hamiltonian as ref_vdp_hamiltonian)
    from janus_tpu_torch import ham
    from janus_tpu_torch.models.problems import vdp_hamiltonian

    y0, s_y0, s_mu, s_tf = _ham_case()
    ry, rt, rsol = ref_dual_solve_ivp(
        ref_ham.hamiltonian_dynamics(ref_vdp_hamiltonian),
        (0.0, RefJet(jnp.asarray(0.1), jnp.asarray(s_tf))),
        RefJet(jnp.asarray(y0), jnp.asarray(s_y0)), method="radau9",
        args={"mu": RefJet(jnp.asarray(100.0), jnp.asarray(s_mu))},
        jac=ref_ham.hamiltonian_jacobian(ref_vdp_hamiltonian),
        options=RefOptions(rtol=1e-6, atol=1e-9, pivoting=False))
    with no_fallback():
        gy, gt, gsol = dual_solve_ivp(
            ham.hamiltonian_dynamics(vdp_hamiltonian),
            (0.0, Jet(torch.tensor(0.1, dtype=F64), _t(s_tf))),
            Jet(_t(y0), _t(s_y0)), method="radau9",
            args={"mu": Jet(torch.tensor(100.0, dtype=F64), _t(s_mu))},
            jac=ham.hamiltonian_jacobian(vdp_hamiltonian),
            options=Options(rtol=1e-6, atol=1e-9, pivoting=False,
                            kernel_lu=True))
    np.testing.assert_array_equal(gsol.status.numpy(), np.asarray(rsol.status))
    for k in STATS:
        np.testing.assert_array_equal(gsol.stats[k].numpy(),
                                      np.asarray(rsol.stats[k]))
    close(gy.r, ry.r, 1e-10)
    close(gy.d, ry.d, 1e-7)
    close(gt.r, rt.r, 1e-10)
    close(gt.d, rt.d, 0.0)


def test_solve_with_sensitivities_is_the_seeded_dual_solve():
    """solve_with_sensitivities(wrt_tf=True) is dual_solve_ivp with the
    identity in y0 and a unit tf column, to the bit."""
    from janus_tpu_torch import ham
    from janus_tpu_torch.models.problems import vdp_hamiltonian

    y0, s_y0, _, _ = _ham_case()
    f = ham.hamiltonian_dynamics(vdp_hamiltonian)
    kw = dict(method="radau9", args={"mu": 100.0},
              jac=ham.hamiltonian_jacobian(vdp_hamiltonian),
              options=Options(rtol=1e-6, atol=1e-9, pivoting=False))
    with no_fallback():
        yj, sol = solve_with_sensitivities(f, (0.0, 0.02), _t(y0),
                                           wrt_tf=True, **kw)
    assert yj.nsens == 5
    tf_d = torch.zeros((5, 4), dtype=F64)
    tf_d[4] = 1.0
    want, _, _ = dual_solve_ivp(
        f, (0.0, Jet(torch.full((4,), 0.02, dtype=F64), tf_d)),
        Jet(_t(y0), _t(_seeds(4, 4, 5))), **kw)
    assert torch.equal(yj.r, want.r) and torch.equal(yj.d, want.d)
    assert torch.equal(yj.d[4], f(sol.t, yj.r, {"mu": 100.0}))


# -- routing: the fast path for the reference's methods and blockers ----------

def _decay(t, y, a):
    return -a * y


def _decay_case():
    """y' = -a y on [0, 1], y0 = (1, 2), a = 0.7: N = 2 seeds (dy0_0 and
    da), so d[0] = (e, 0) and d[1] = -(1, 2) e with e = exp(-0.7)."""
    y0 = torch.tensor([[1.0, 2.0]], dtype=F64)
    seeds = torch.zeros((2, 1, 2), dtype=F64)
    seeds[0, :, 0] = 1.0
    a = Jet(torch.tensor(0.7, dtype=F64), torch.tensor([0.0, 1.0],
                                                       dtype=F64))
    e = float(np.exp(-0.7))
    want = np.array([[[e, 0.0]], [[-e, -2.0 * e]]])
    return Jet(y0, seeds), a, want


IND_METHODS = ["radau", "radau5", "radau9", "radau13", "radaup", "seulex",
               "rodas", "bdf", "ndf", "bdf_classic"]


@pytest.mark.parametrize("method", IND_METHODS)
def test_fast_path_routes_to_ind(method):
    """The reference's IND methods take the fast path with no warning: the
    Jet equals solve_ivp(tangents=, args_tangents=) to the bit."""
    y0, a, want = _decay_case()
    with no_fallback():
        yj, tj, sol = dual_solve_ivp(_decay, (0.0, 1.0), y0, method=method,
                                     args=a, rtol=1e-8, atol=1e-10)
    ind = solve_ivp(_decay, (0.0, 1.0), y0.r, method=method, args=a.r,
                    rtol=1e-8, atol=1e-10, tangents=y0.d, args_tangents=a.d)
    assert sol.sens is not None
    assert torch.equal(yj.d, ind.sens) and torch.equal(yj.r, ind.y)
    np.testing.assert_allclose(yj.d.numpy(), want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("method", ["radau", "radaup"])
def test_fast_path_takes_t_eval_and_events(method):
    """Radau and radaup take t_eval and events on the fast path; an event
    lane's time tangent comes back in t's Jet (sens_t)."""
    y0, a, _ = _decay_case()
    ev = Event(lambda t, y, args: y[:, 0] - 0.8, terminal=True)
    with no_fallback():
        yj, tj, sol = dual_solve_ivp(
            _decay, (0.0, 1.0), y0, method=method, args=a, rtol=1e-8,
            atol=1e-10, t_eval=torch.tensor([0.2, 0.3], dtype=F64),
            events=ev)
    assert int(sol.status[0]) == 5                     # EVENT_TERMINATED
    # y0_0 e^(-a t*) = 0.8: t* = ln(1.25)/a, dt*/dy0_0 = 1/a,
    # dt*/da = -t*/a
    ts = np.log(1.25) / 0.7
    np.testing.assert_allclose(float(tj.r[0]), ts, rtol=1e-7)
    np.testing.assert_allclose(tj.d[:, 0].numpy(), [1 / 0.7, -ts / 0.7],
                               rtol=1e-5)


@pytest.mark.parametrize("method", ["dopri5", "dopri853", "grk4t"])
def test_methods_with_no_ind_take_the_transform_silently(method):
    """Methods outside the IND set go straight to the transform, with no
    warning (as the reference's)."""
    y0, a, want = _decay_case()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        yj, tj, sol = dual_solve_ivp(_decay, (0.0, 1.0), y0, method=method,
                                     args=a, rtol=1e-8, atol=1e-10)
    assert not [w for w in caught if FALLBACK in str(w.message)]
    assert sol.sens is None
    np.testing.assert_allclose(yj.d.numpy(), want, rtol=1e-5, atol=1e-7)


def _reference_words(blockers):
    return re.escape(
        "dual_solve_ivp: falling back to the vmapped-jvp transform "
        f"(~3x slower than internal differentiation) because: {blockers}")


@pytest.mark.parametrize("case", ["terminal_only", "variable_stages",
                                  "tf_with_events", "gmres"])
def test_fallback_warns_in_the_reference_words(case):
    """Each blocker of the reference's fast path falls back to the
    transform with the reference's warning, word for word, and the
    transform's sensitivities equal a jvp of the solve (the a column)."""
    y0, a, want = _decay_case()
    tf, method = 1.0, "radau"
    if case == "terminal_only":
        method = "seulex"
        kw = dict(t_eval=torch.tensor([0.5, 1.0], dtype=F64))
        words = "kwargs ['t_eval'] (seulex IND is terminal-mode only)"
    elif case == "variable_stages":
        kw = dict(min_stages=3, max_stages=5)
        words = "variable stage count (min_stages != max_stages)"
    elif case == "tf_with_events":
        kw = dict(events=Event(lambda t, y, args: y[:, 0] - 0.1,
                               terminal=True))
        tf = Jet(torch.tensor(1.0, dtype=F64), torch.zeros(2, dtype=F64))
        words = "tf tangents with mass/events"
    else:
        method = "rodas"
        kw = dict(stage_solver="gmres")
        words = ("stage_solver='gmres' (IND rides the matrix-free stage "
                 "solvers in radau and bdf only)")
    with pytest.warns(UserWarning, match=_reference_words(words)):
        yj, tj, sol = dual_solve_ivp(_decay, (0.0, tf), y0, method=method,
                                     args=a, rtol=1e-8, atol=1e-10, **kw)
    np.testing.assert_allclose(yj.d.numpy(), want, rtol=1e-5, atol=1e-7)

    def final(z, aa):
        return solve_ivp(_decay, (0.0, 1.0), z, method=method, args=aa,
                         rtol=1e-8, atol=1e-10, **kw).y

    jv = torch.func.jvp(final, (y0.r, a.r), (y0.d[1], a.d[1]))[1]
    np.testing.assert_allclose(yj.d[1].numpy(), jv.numpy(), rtol=0,
                               atol=1e-14)


def test_no_jet_raises():
    with pytest.raises(ValueError, match="no Jet inputs"):
        dual_solve_ivp(vdp_rhs, (0.0, 1.0),
                       torch.tensor([[2.0, 0.0]], dtype=F64), args=5.0)


def _jvp_of_solve(method, y0, seed, **kw):
    def final(z):
        return solve_ivp(vdp_rhs, (0.0, 1.0), z, method=method, **kw).y
    return torch.func.jvp(final, (y0,), (seed,))[1]


@pytest.mark.slow
def test_ndf_ind_dual_solve_routing():
    m = 2
    mu = torch.tensor([2.0, 10.0], dtype=F64)
    y0 = torch.stack([torch.full((m,), 2.0, dtype=F64),
                      torch.zeros(m, dtype=F64)], dim=-1)
    seeds = torch.zeros((1, m, 2), dtype=F64)
    seeds[0, :, 0] = 1.0
    with no_fallback():
        yj, tj, sol = dual_solve_ivp(vdp_rhs, (0.0, 1.0), Jet(y0, seeds),
                                     method="bdf", args=mu, rtol=1e-8,
                                     atol=1e-10)
    assert yj.d.shape == (1, m, 2)
    want = _jvp_of_solve("bdf", y0, seeds[0], args=mu,
                         options=Options(rtol=1e-8, atol=1e-10))
    np.testing.assert_allclose(yj.d[0].numpy(), want.numpy(), rtol=0,
                               atol=3e-6)


@pytest.mark.slow
def test_radaup_dual_fast_path_routes_ind():
    mus = torch.tensor([30.0, 1000.0], dtype=F64)
    y0 = torch.tensor([[2.0, 0.0]], dtype=F64).repeat(2, 1)
    with no_fallback():
        yj, tj, sol = dual_solve_ivp(vdp_rhs, (0.0, 1.0), seed_identity(y0),
                                     method="radaup", args=mus, rtol=1e-9,
                                     atol=1e-12)
    assert bool((sol.status == SUCCESS).all())
    for k in range(2):
        seed = torch.zeros_like(y0)
        seed[:, k] = 1.0
        want = _jvp_of_solve("radaup", y0, seed, args=mus, rtol=1e-9,
                             atol=1e-12)
        np.testing.assert_allclose(yj.d[k].numpy(), want.numpy(), rtol=3e-4,
                                   atol=1e-6)


def test_rodas_ind_terminal_only_and_routing():
    y0 = torch.tensor([[2.0, 0.0]], dtype=F64)
    seeds = _t(_seeds(1, 2, 2))
    with pytest.raises(ValueError):
        solve_ivp(vdp_rhs, (0.0, 1.0), y0, method="rodas", args=5.0,
                  tangents=seeds,
                  t_eval=torch.linspace(0.0, 1.0, 5, dtype=F64))
    with no_fallback():
        yj, _, sol = dual_solve_ivp(vdp_rhs, (0.0, 1.0), Jet(y0, seeds),
                                    args=5.0, method="rodas", rtol=1e-5,
                                    atol=1e-8)
    assert yj.d.shape == (2, 1, 2)
    assert sol.sens is not None


@pytest.mark.slow
def test_dual_solve_ivp_routes_seulex_to_ind():
    y0 = torch.tensor([[2.0, 0.0]], dtype=F64)
    seeds = _t(_seeds(1, 2, 2))
    opts = Options(rtol=1e-9, atol=1e-12)
    with no_fallback():
        yj, tj, sol = dual_solve_ivp(vdp_rhs, (0.0, 1.0), Jet(y0, seeds),
                                     method="seulex", args=100.0,
                                     options=opts)
    assert sol.sens is not None
    for k in range(2):
        want = _jvp_of_solve("seulex", y0, seeds[k], args=100.0,
                             options=opts)
        np.testing.assert_allclose(yj.d[k].numpy(), want.numpy(), rtol=5e-4,
                                   atol=1e-7)


# -- the reference's own oracles on the port ----------------------------------

def _fd_resolve_check(rtol, atol, tf, fd_tol):
    mu = 100.0
    y0 = torch.tensor([[2.0, 0.5]], dtype=F64)
    opts = Options(rtol=rtol, atol=atol)
    yj, sol = solve_with_sensitivities(vdp_rhs, (0.0, tf), y0, args=mu,
                                       options=opts)
    assert int(sol.status[0]) == SUCCESS
    eps = 1e-6
    e = eps * torch.eye(2, dtype=F64)
    both = solve_ivp(vdp_rhs, (0.0, tf), torch.cat([y0 + e, y0 - e]),
                     args=mu, method="radau", options=opts).y
    fd = (both[:2] - both[2:]) / (2 * eps)          # [j, D]
    for j in range(2):
        np.testing.assert_allclose(yj.d[j, 0].numpy(), fd[j].numpy(),
                                   **fd_tol)


@pytest.mark.slow
def test_sensitivities_vs_fd_resolve_stiff():
    """dy(T)/dy0 on stiff VdP against central differences of re-solves
    at the reference's tolerances (rtol 1e-10)."""
    _fd_resolve_check(1e-10, 1e-13, 0.5, dict(rtol=1e-3, atol=1e-4))


def _final_time_column(rtol, atol):
    mu = 10.0
    yj, sol = solve_with_sensitivities(
        vdp_rhs, (0.0, 1.0), torch.tensor([[2.0, 0.0]], dtype=F64), args=mu,
        options=Options(rtol=rtol, atol=atol), wrt_tf=True)
    assert yj.nsens == 3
    np.testing.assert_allclose(yj.d[2].numpy(),
                               vdp_rhs(1.0, yj.r, mu).numpy(), rtol=1e-6,
                               atol=1e-8)


@pytest.mark.slow
def test_final_time_sensitivity_column():
    """dy(T)/dT equals f(T, y(T)) (rtol 1e-11, the reference's)."""
    _final_time_column(1e-11, 1e-14)


@pytest.mark.slow
def test_parameter_sensitivity_via_jet_args():
    """Jet-valued args: dy(T)/dmu against central differences (rtol
    1e-11, the reference's)."""
    y0 = torch.tensor([[2.0, 0.0]], dtype=F64)
    opts = Options(rtol=1e-11, atol=1e-14)
    mu = Jet(torch.tensor(10.0, dtype=F64), torch.ones(1, dtype=F64))
    yj, tj, sol = dual_solve_ivp(vdp_rhs, (0.0, 1.0), y0, args=mu,
                                 options=opts)
    eps = 1e-6
    y2 = solve_ivp(vdp_rhs, (0.0, 1.0), y0.repeat(2, 1),
                   args=torch.tensor([10.0 + eps, 10.0 - eps], dtype=F64),
                   method="radau", options=opts).y
    fd = (y2[0] - y2[1]) / (2 * eps)
    np.testing.assert_allclose(yj.d[0, 0].numpy(), fd.numpy(), rtol=1e-4,
                               atol=1e-6)


def _forward_vs_reverse(rtol, atol, n_steps, bound):
    y0 = torch.tensor([[1.0, 0.2]], dtype=F64)
    target = torch.tensor([[0.3, -0.5]], dtype=F64)

    def loss_adaptive(om):
        sol = solve_ivp(harmonic_rhs, (0.0, 2.0), y0, args=om,
                        method="radau", rtol=rtol, atol=atol)
        return torch.sum((sol.y - target) ** 2)

    def loss_fixed(om):
        y_end = odeint_fixed(harmonic_rhs, 0.0, 2.0, y0, n_steps=n_steps,
                             args=om)
        return torch.sum((y_end - target) ** 2)

    om = torch.tensor(1.3, dtype=F64)
    g_fwd = torch.func.jacfwd(loss_adaptive)(om)
    om_r = om.clone().requires_grad_()
    (g_rev,) = torch.autograd.grad(loss_fixed(om_r), om_r)
    np.testing.assert_allclose(float(g_fwd), float(g_rev), rtol=bound)


@pytest.mark.slow
def test_forward_vs_reverse_gradients_agree():
    """Forward mode through the ADAPTIVE solve against reverse mode
    through the FIXED-step solve (rtol 1e-11, 400 rk4 steps)."""
    _forward_vs_reverse(1e-11, 1e-14, 400, 1e-5)


def _nn_rhs(p):
    def h_single(yy):
        return torch.sum(mlp_apply(p, yy))

    def single(yy):
        g = torch.func.grad(h_single)(yy)
        # canonical: q' = ∂H/∂v, v' = −∂H/∂q  (y = [q, v])
        return torch.stack([g[1], -g[0]])

    return lambda t, y, args: torch.func.vmap(single)(y)


@pytest.mark.slow
def test_train_nn_hamiltonian_through_solver():
    """Fit an MLP Hamiltonian so the learned dynamics reproduce
    harmonic-oscillator flows: the first loss and gradient equal the
    reference's on the same weights and data, and after 300 Adam steps
    (torch.optim.Adam for optax.adam) the loss has dropped more than 100x
    and the field generalizes."""
    key = jax.random.PRNGKey(0)
    ref_params = ref_mlp_init(key, [2, 32, 32, 1], jnp.float64)
    key, k1, _ = jax.random.split(key, 3)
    y0s_ref = jax.random.normal(k1, (64, 2))
    dt = 0.5
    y1s_ref = ref_odeint_fixed(ref_harmonic_rhs, 0.0, dt, y0s_ref,
                               n_steps=64, args=1.0)

    def ref_rhs(t, y, p):
        def single(yy):
            g = jax.grad(lambda z: jnp.sum(ref_mlp_apply(p, z)))(yy)
            return jnp.stack([g[1], -g[0]])
        return jax.vmap(single)(y)

    def ref_loss(p):
        pred = ref_odeint_fixed(ref_rhs, 0.0, dt, y0s_ref, n_steps=16,
                                args=p)
        return jnp.mean((pred - y1s_ref) ** 2)

    l0_ref, g0_ref = jax.value_and_grad(ref_loss)(ref_params)

    params = tree_to_torch(ref_params, device="cpu")
    for leaf in params["w"] + params["b"]:
        leaf.requires_grad_()
    y0s = _t(y0s_ref)
    y1s = odeint_fixed(harmonic_rhs, 0.0, dt, y0s, n_steps=64, args=1.0)
    close(y1s, y1s_ref, 1e-13)

    def loss_fn(p):
        # remat=False: torch.func.grad inside the rhs does not compose
        # with torch.utils.checkpoint's saved-tensor hooks; remat only
        # trades memory for recomputation
        pred = odeint_fixed(lambda t, y, a: _nn_rhs(a)(t, y, None), 0.0, dt,
                            y0s, n_steps=16, args=p, remat=False)
        return torch.mean((pred - y1s) ** 2)

    leaves = params["w"] + params["b"]
    l0 = loss_fn(params)
    # the output bias is a constant of H: its gradient is zero, as jax's
    g0 = torch.autograd.grad(l0, leaves, materialize_grads=True)
    close(l0, l0_ref, 1e-12)
    for g, w in zip(g0, list(g0_ref["w"]) + list(g0_ref["b"])):
        close(g, w, 1e-10)

    opt = torch.optim.Adam(leaves, lr=3e-3)
    for _ in range(300):
        opt.zero_grad()
        loss = loss_fn(params)
        loss.backward()
        opt.step()
    l1 = float(loss)
    assert l1 < float(l0) / 100, (float(l0), l1)
    ytest = torch.tensor([[0.7, -0.3]], dtype=F64)
    with torch.no_grad():
        pred = odeint_fixed(lambda t, y, a: _nn_rhs(params)(t, y, None), 0.0,
                            dt, ytest, n_steps=64)
    true = odeint_fixed(harmonic_rhs, 0.0, dt, ytest, n_steps=64, args=1.0)
    np.testing.assert_allclose(pred.detach().numpy(), true.numpy(),
                               atol=0.05)


def test_tf_jet_fast_path_no_fallback():
    """A Jet tf rides the IND fast path: the terminal-time column is the
    one-rhs-call correction dy(T)/dT = f(T, y(T))."""
    y0 = Jet(torch.tensor([[2.0, 0.0]], dtype=F64), _t(_seeds(1, 2, 2)))
    opts = Options(rtol=1e-5, atol=1e-8)
    with no_fallback():
        yj, tj, sol = dual_solve_ivp(
            vdp_rhs, (0.0, Jet(torch.tensor(1.0, dtype=F64),
                               torch.zeros(2, dtype=F64))), y0, args=10.0,
            options=opts)
    ref = solve_ivp(vdp_rhs, (0.0, 1.0), y0.r, args=10.0, method="radau",
                    options=opts, tangents=y0.d)
    np.testing.assert_allclose(yj.d.numpy(), ref.sens.numpy(), rtol=1e-9,
                               atol=1e-12)
    with no_fallback():
        yj2, tj2, _ = dual_solve_ivp(
            vdp_rhs, (0.0, Jet(torch.tensor(1.0, dtype=F64),
                               torch.tensor([0.0, 1.0], dtype=F64))), y0,
            args=10.0, options=opts)
    np.testing.assert_allclose(
        yj2.d[1].numpy(), (ref.sens[1] + vdp_rhs(1.0, yj2.r, 10.0)).numpy(),
        rtol=1e-6, atol=1e-9)
    np.testing.assert_array_equal(tj2.d.numpy(), [[0.0], [1.0]])


@pytest.mark.slow
def test_events_fast_path_exposes_event_time_tangents():
    """Terminal events ride the IND fast path (fixed-stage radau): y* and
    t* tangents come back as Jets, matching central FD re-solves."""
    def f(t, y, args):
        return torch.stack([y[..., 1], -args * y[..., 0]], dim=-1)

    ev = Event(lambda t, y, a: y[..., 0], terminal=True, direction=-1)
    y0r = torch.tensor([[1.0, 0.0]], dtype=F64)
    seeds = _t(_seeds(1, 2, 2))
    opts = Options(rtol=1e-11, atol=1e-14)
    with no_fallback():
        yj, tj, sol = dual_solve_ivp(f, (0.0, 4.0), Jet(y0r, seeds),
                                     args=4.0, options=opts, events=ev)
    assert int(sol.status[0]) == 5                     # EVENT_TERMINATED
    np.testing.assert_allclose(float(tj.r[0]), np.pi / 4, rtol=1e-8)
    eps = 1e-6
    both = solve_ivp(f, (0.0, 4.0),
                     torch.cat([y0r + eps * seeds[:, 0],
                                y0r - eps * seeds[:, 0]]),
                     args=4.0, method="radau", options=opts, events=ev)
    fd_y = (both.y[:2] - both.y[2:]) / (2 * eps)
    fd_t = (both.t[:2] - both.t[2:]) / (2 * eps)
    # central FD of a component with zero first derivative leaves an
    # O(eps)*curvature residual (~1.3e-7 here): atol sits above it
    np.testing.assert_allclose(yj.d[:, 0].numpy(), fd_y.numpy(), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(tj.d[:, 0].numpy(), fd_t.numpy(), rtol=1e-4,
                               atol=1e-6)
