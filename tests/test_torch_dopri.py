"""The port's explicit Dormand–Prince solvers against the JAX package, on the
CPU in float64.

The cases of ``tests/test_dopri.py``, each run through both packages in the
same process on the same inputs (made with numpy from a seed): status and
every counter equal per lane; y, ys, ``interpolate`` and ``quad`` within
1e-10 relative to the array's largest entry (measured: ~1e-13, rounding
of a different summation order in the dense-output contractions). Each case
also keeps the reference test's own oracle (exact solution, scipy).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.integrate import solve_ivp as scipy_solve
from torch.func import jvp

from janus_tpu.models.problems import harmonic_rhs as ref_harmonic
from janus_tpu.models.problems import vdp_rhs as ref_vdp
from janus_tpu.solve import solve_ivp as ref_solve_ivp
from janus_tpu.solve.events import Event as RefEvent
from janus_tpu_torch.models.problems import harmonic_rhs, vdp_rhs
from janus_tpu_torch.solve import SUCCESS, Event, solve_erk, solve_ivp

torch.set_num_threads(1)

RHS = {"harmonic": (ref_harmonic, harmonic_rhs), "vdp": (ref_vdp, vdp_rhs)}


def _close(got, ref, what, tol=1e-10):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref), err_msg=what)
    np.testing.assert_allclose(got, ref, rtol=0, equal_nan=True,
                               atol=tol * float(np.nanmax(np.abs(ref))),
                               err_msg=what)


def _f64(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float64))


def _both(rhs, tspan, y0, args, **kw):
    """The same solve through both packages; holds status, counters, t, y
    (and ys, quad where asked) equal. Returns (reference, port)."""
    ref_f, f = RHS[rhs]
    conv = {k: v for k, v in kw.items() if k not in ("events", "quad")}
    ref = ref_solve_ivp(ref_f, tuple(jnp.asarray(x) for x in tspan),
                        jnp.asarray(y0), args=jnp.asarray(args), **conv,
                        **{k: v[0] for k, v in kw.items()
                           if k in ("events", "quad")})
    sol = solve_ivp(f, tuple(_f64(x) for x in tspan), _f64(y0),
                    args=_f64(args), **conv,
                    **{k: v[1] for k, v in kw.items()
                       if k in ("events", "quad")})
    np.testing.assert_array_equal(sol.status.numpy(), np.asarray(ref.status))
    assert set(sol.stats) == set(ref.stats)
    for k in ref.stats:
        np.testing.assert_array_equal(sol.stats[k].numpy(),
                                      np.asarray(ref.stats[k]), err_msg=k)
    _close(sol.t, ref.t, "t")
    _close(sol.y, ref.y, "y")
    if ref.ys is not None:
        _close(sol.ys, ref.ys, "ys")
    if ref.quad is not None:
        _close(sol.quad, ref.quad, "quad")
    return ref, sol


def _lanes(m, lo, hi, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, m)


@pytest.mark.parametrize("method", ["dopri5", "dopri853"])
def test_harmonic_vs_exact(method):
    m, omega, tf = 16, 2.0, 10.0
    q0 = np.sort(_lanes(m, 0.5, 1.5, 1))
    y0 = np.stack([q0, np.zeros(m)], axis=-1)
    _, sol = _both("harmonic", (0.0, tf), y0, omega, method=method,
                   rtol=1e-8, atol=1e-10)
    assert bool((sol.status == SUCCESS).all())
    np.testing.assert_allclose(sol.y[:, 0], q0 * np.cos(omega * tf),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sol.y[:, 1], -q0 * omega * np.sin(omega * tf),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("method,oracle", [("dopri5", "RK45"),
                                           ("dopri853", "DOP853")])
def test_vdp_nonstiff_vs_scipy(method, oracle):
    mu, y0 = 1.0, np.array([2.0, 0.0])
    rtol, atol = 1e-7, 1e-9
    _, sol = _both("vdp", (0.0, 10.0), y0[None, :], mu, method=method,
                   rtol=rtol, atol=atol)
    ref = scipy_solve(lambda t, y: [y[1], mu * (1 - y[0] ** 2) * y[1] - y[0]],
                      (0.0, 10.0), y0, method=oracle, rtol=rtol, atol=atol)
    np.testing.assert_allclose(sol.y[0], ref.y[:, -1], rtol=1e-5, atol=1e-6)
    assert int(sol.stats["nsteps"][0]) < 2 * ref.t.size + 50


@pytest.mark.parametrize("method", ["dopri5", "dopri853"])
def test_dense_output_grid(method):
    y0 = np.array([[1.0, 0.0], [0.5, 0.0]])
    t_eval = np.linspace(0.0, 5.0, 21)
    _, sol = _both("harmonic", (0.0, 5.0), y0, 1.0, method=method,
                   rtol=1e-9, atol=1e-11, t_eval=t_eval)
    np.testing.assert_allclose(sol.ys[:, :, 0],
                               y0[:, :1] * np.cos(t_eval)[None, :],
                               rtol=1e-6, atol=1e-7)
    assert not bool(torch.isnan(sol.ys).any())


def test_reverse_time():
    y0 = np.array([[1.0, 0.3]])
    _, fwd = _both("harmonic", (0.0, 4.0), y0, 1.3, rtol=1e-10, atol=1e-12)
    _, back = _both("harmonic", (4.0, 0.0), fwd.y.numpy(), 1.3, rtol=1e-10,
                    atol=1e-12)
    assert int(back.status[0]) == SUCCESS
    np.testing.assert_allclose(back.y, y0, rtol=1e-7, atol=1e-8)


def test_per_trajectory_tf():
    m = 4
    tfs = np.array([1.0, 2.0, 3.0, 4.0])
    y0 = np.tile([[1.0, 0.0]], (m, 1))
    _, sol = _both("harmonic", (np.zeros(m), tfs), y0, 1.0, rtol=1e-9,
                   atol=1e-11)
    np.testing.assert_allclose(sol.t, tfs, rtol=1e-12)
    np.testing.assert_allclose(sol.y[:, 0], np.cos(tfs), rtol=1e-6)


def test_batch_heterogeneous_mu():
    mus = np.array([0.5, 1.0, 2.0, 5.0])
    y0 = np.tile([[2.0, 0.0]], (4, 1))
    _, sol = _both("vdp", (0.0, 5.0), y0, mus, rtol=1e-7, atol=1e-9)
    assert bool((sol.status == SUCCESS).all())
    for i, mu in enumerate(mus):
        ref = scipy_solve(
            lambda t, y: [y[1], mu * (1 - y[0] ** 2) * y[1] - y[0]],
            (0.0, 5.0), [2.0, 0.0], method="RK45", rtol=1e-7, atol=1e-9)
        np.testing.assert_allclose(sol.y[i], ref.y[:, -1], rtol=1e-4,
                                   atol=1e-5)


def test_forward_sensitivity_jvp_through_solve():
    """torch.func.jvp through the adaptive solve (the loop's host syncs read
    primal values) against jax.jvp through the reference's: the tangent
    within 1e-10, and d q(T)/d q0 = cos(ωT) within 1e-6."""
    tf = 2.0

    def final_q(xp, solve, f, q0):
        y0 = xp.stack([q0, xp.zeros_like(q0)], -1)
        return solve(f, (0.0, tf), y0, args=1.0, rtol=1e-10,
                     atol=1e-12).y[:, 0]

    q0 = np.array([1.0, 0.7])
    _, t_ref = jax.jvp(lambda q: final_q(jnp, ref_solve_ivp, ref_harmonic, q),
                       (jnp.asarray(q0),), (jnp.ones(2),))
    _, t_got = jvp(lambda q: final_q(torch, solve_ivp, harmonic_rhs, q),
                   (torch.from_numpy(q0),),
                   (torch.ones(2, dtype=torch.float64),))
    _close(t_got, t_ref, "tangent")
    np.testing.assert_allclose(t_got, np.cos(tf) * np.ones(2), rtol=1e-6)


@pytest.mark.parametrize("method,tol", [("dopri5", 1e-13),
                                        ("dopri853", 1e-11)])
def test_dense_mesh_interpolate(method, tol):
    """Solution.interpolate on the stored power-basis rows equals the
    reference's within 1e-10, and the t_eval path to the reference test's
    bound (dop853's rows: the exact map of its Horner cascade)."""
    y0 = np.array([[1.0, 0.0], [0.5, 0.2]])
    ts = np.linspace(0.0, 10.0, 37)
    ref, sol = _both("harmonic", (0.0, 10.0), y0, 1.0, method=method,
                     rtol=1e-9, atol=1e-12, dense=512)
    yi = sol.interpolate(torch.from_numpy(ts))
    _close(yi, ref.interpolate(jnp.asarray(ts)), "interpolate")
    _, grid = _both("harmonic", (0.0, 10.0), y0, 1.0, method=method,
                    rtol=1e-9, atol=1e-12, t_eval=ts)
    np.testing.assert_allclose(yi, grid.ys, rtol=0, atol=tol)
    np.testing.assert_allclose(yi[0, :, 0], np.cos(ts), atol=5e-9)


@pytest.mark.parametrize("method", ["dopri5", "dopri853"])
def test_quad_analytic(method):
    # ∫ cos² over [0, 10] = 5 + sin(20)/4
    lq = (lambda t, y, a: y[:, 0] ** 2,) * 2
    _, sol = _both("harmonic", (0.0, 10.0), np.array([[1.0, 0.0]]), 1.0,
                   method=method, rtol=1e-9, atol=1e-12, quad=lq)
    np.testing.assert_allclose(float(sol.quad[0]), 5.0 + np.sin(20.0) / 4.0,
                               rtol=1e-7)


def test_quad_event_truncation():
    """Terminal event x = 0 (t* = π/2): quad = ∫ cos² to π/2 = π/4, and the
    event time, state and index equal the reference's."""
    def g(t, y, a):
        return y[..., 0]

    evs = (RefEvent(g, terminal=True, direction=-1.0),
           Event(g, terminal=True, direction=-1.0))
    lq = (lambda t, y, a: y[:, 0] ** 2,) * 2
    ref, sol = _both("harmonic", (0.0, 10.0), np.array([[1.0, 0.0]]), 1.0,
                     rtol=1e-9, atol=1e-12, events=evs, quad=lq)
    _close(sol.event_t, ref.event_t, "event_t")
    _close(sol.event_y, ref.event_y, "event_y")
    np.testing.assert_array_equal(sol.event_idx.numpy(),
                                  np.asarray(ref.event_idx))
    np.testing.assert_allclose(float(sol.quad[0]), np.pi / 4.0, rtol=1e-6)


def test_solve_erk_records_steps_and_h0():
    """record_steps logs every attempt (accepted ones sum to the span), and
    a warm start _h0 takes the asked first step."""
    from janus_tpu_torch.solve import Options
    from janus_tpu_torch.solve.dopri import TABLEAUS
    y0 = torch.tensor([[1.0, 0.0], [0.5, 0.2]], dtype=torch.float64)
    sol = solve_erk(TABLEAUS["dopri5"], harmonic_rhs, 0.0, 3.0, y0, 1.0,
                    Options(rtol=1e-8, atol=1e-10, record_steps=256),
                    _h0=torch.tensor([0.01, 0.0], dtype=torch.float64))
    dyn = sol.dyn
    assert torch.equal(dyn["idx"], sol.stats["nsteps"])
    assert torch.equal(dyn["accepted"].sum(dim=1).to(torch.int32),
                       sol.stats["naccept"])
    span = torch.where(dyn["accepted"], dyn["h"], 0.0).sum(dim=1)
    torch.testing.assert_close(span, torch.full((2,), 3.0,
                                                dtype=torch.float64))
    assert float(dyn["h"][0, 0]) == 0.01 and float(dyn["h"][1, 0]) != 0.01


def test_probe_cells_on_small_batches():
    """The card probe's cells (``janus_tpu_torch.bench.dopri``) at a few
    lanes on the CPU, with the checks the card runs: the forward solve
    against scipy, the no-accept share read off the step log, the
    neural-ODE gradient finite, the step_args headline equal to the plain
    solve to the bit, and the qr_fallback batch against its exact
    solutions."""
    from janus_tpu_torch.bench import dopri as probe
    cpu = torch.device("cpu")
    sol = probe.forward_solve("dopri5", 16, cpu, record_steps=300)
    assert bool((sol.status == SUCCESS).all())
    mus = probe._logspace(-1.0, 0.5, 16, torch.float64, cpu).numpy()
    assert probe.scipy_worst("dopri5", sol.y.numpy(), mus,
                             probe._lanes(16, 3)) <= 1.0
    share, trips = probe.no_accept_share(sol.dyn)
    assert trips == int(sol.stats["nsteps"].max()) and 0.0 <= share < 0.5
    loss, grads = probe.node_gradient(probe.node_params(torch.float64, cpu),
                                      probe.node_data(4, torch.float64, cpu))
    assert bool(torch.isfinite(loss)) and all(
        bool(torch.isfinite(g).all()) for g in grads)
    plain = probe.headline_solve(cpu, False, m=8)
    slab = probe.headline_solve(cpu, True, m=8)
    assert torch.equal(plain.y, slab.y) and all(
        torch.equal(plain.stats[k], slab.stats[k]) for k in plain.stats)
    qr = probe.qr_solve_lanes(8, cpu)
    y0 = probe.qr_inputs(8, cpu)[0].numpy()
    assert bool((qr.status == SUCCESS).all())
    np.testing.assert_allclose(qr.y.numpy(), probe.qr_exact(y0), rtol=1e-8,
                               atol=1e-11)
