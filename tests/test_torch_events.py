"""Events of the port (``solve/events.py``, ``events=`` on solve_radau,
solve_rodas and radau_adjoint) against the JAX reference, on the CPU in
float64, on the same inputs.

- the cases of ``tests/test_events.py`` through both packages' ``solve_ivp``
  (radau, and rodas where the reference's test runs it; five of them in the
  slow tier, each a reference compile of ~7 s): status, t, y,
  event_t, event_y and event_idx per lane, and the t_eval samples with their
  NaN past t*, to 1e-10 relative to the array's largest entry (the meshes
  agree to ~1e-13 here; the bisection resolves θ to 2⁻⁶⁰);
- ``handle_events`` alone on a hand-made step: a tie between two events and
  a lane where nothing crossed (a row of +inf), equal to the reference's,
  with and without a solve's host-sync counter (one sync for the gate);
- radau's IND tangents at a terminal event (sens, sens_t, sens_ys masked
  past t*, quad and sens_quad truncated at t*) to 1e-8 of the largest entry;
- radau_adjoint with terminal events, without and with t_eval (and a
  cost), gradients to 1e-7 of the largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janus_tpu.solve import Options as RefOptions
from janus_tpu.solve import solve_ivp as ref_solve_ivp
from janus_tpu.solve.adjoint import radau_adjoint as ref_radau_adjoint
from janus_tpu.solve import events as ref_events
from janus_tpu_torch.interop import options_from_jax
from janus_tpu_torch.solve import (EVENT_TERMINATED, Event, radau_adjoint,
                                   solve_ivp)
from janus_tpu_torch.solve import events as events_mod
from janus_tpu_torch.solve.common import _HostSyncs

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clear_caches_each_test():
    yield
    jax.clear_caches()


def _harmonic(xp):
    def rhs(t, y, w):
        return xp.stack([y[:, 1], -w * w * y[:, 0]], -1)
    return rhs


def _vdp(xp):
    def rhs(t, y, mu):
        x, v = y[:, 0], y[:, 1]
        return xp.stack([v, mu * (1.0 - x * x) * v - x], -1)
    return rhs


def _close(got, ref, tol, what):
    ref = np.asarray(ref)
    got = got.detach().numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref), err_msg=what)
    scale = max(float(np.nanmax(np.abs(ref))), 1e-300)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale,
                               err_msg=what)


def _ev(xp, ev_cls, thr=0.0, col=0, terminal=True, direction=0.0):
    thr = xp.asarray(np.asarray(thr, dtype=np.float64))
    return ev_cls(lambda t, y, a: y[:, col] - thr, terminal=terminal,
                  direction=direction)


# name -> (y0, tspan, solve keywords (xp, Event) -> dict, methods): the cases
# of tests/test_events.py
CASES = {
    "terminal-zero-crossing": (
        [[1.0, 0.0], [1.0, 0.0]], (0.0, 10.0),
        lambda xp, E: dict(events=_ev(xp, E)), ("radau", "rodas")),
    "direction-filter": (
        [[1.0, 0.0]], (0.0, 10.0),
        lambda xp, E: dict(events=_ev(xp, E, direction=1.0)), ("radau",)),
    "non-terminal-records": (
        [[1.0, 0.0]], (0.0, 10.0),
        lambda xp, E: dict(events=_ev(xp, E, terminal=False)), ("radau",)),
    "earliest-wins": (
        [[1.0, 0.0]], (0.0, 10.0),
        lambda xp, E: dict(events=[_ev(xp, E), _ev(xp, E, -0.5, col=1)]),
        ("radau",)),
    "per-lane": (
        [[1.0, 0.0], [0.0, 1.0]], (0.0, 10.0),
        lambda xp, E: dict(events=_ev(xp, E, 0.5)), ("radau",)),
    "t_eval": (
        [[1.0, 0.0], [1.0, 0.0]], (0.0, 3.0),
        lambda xp, E: dict(events=_ev(xp, E, [0.0, -2.0]),
                           t_eval=xp.asarray(np.linspace(0.0, 3.0, 13))),
        ("radau", "rodas")),
    "t_eval-reverse-time": (
        [[1.0, 0.0]], (3.0, 0.0),
        lambda xp, E: dict(events=E(lambda t, y, a: t - 1.5),
                           t_eval=xp.asarray(np.linspace(3.0, 0.0, 13))),
        ("radau",)),
    "earlier-non-terminal": (
        [[1.0, 0.0]], (0.0, 10.0),
        lambda xp, E: dict(events=[_ev(xp, E, 1e-3, terminal=False),
                                   _ev(xp, E)]), ("radau",)),
}


# the paths these cover are also taken by the fast cases and by the
# handle_events test; each costs a reference compile (~7 s)
SLOW_CASES = ("direction-filter", "non-terminal-records", "earliest-wins",
              "per-lane")


@pytest.mark.parametrize("name,method", [
    pytest.param(n, m, marks=[pytest.mark.slow] if n in SLOW_CASES else [])
    for n, c in CASES.items() for m in c[3]])
def test_events_match_reference(name, method):
    y0, tspan, kw, _ = CASES[name]
    tol = dict(rtol=1e-8, atol=1e-10)
    ref = ref_solve_ivp(_harmonic(jnp), tspan, jnp.asarray(y0), method=method,
                        args=1.0, **tol, **kw(jnp, ref_events.Event))
    got = solve_ivp(_harmonic(torch), tspan,
                    torch.tensor(y0, dtype=torch.float64), method=method,
                    args=1.0, **tol, **kw(torch, Event))
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    np.testing.assert_array_equal(got.event_idx.numpy(),
                                  np.asarray(ref.event_idx))
    for k in ("t", "y", "event_t", "event_y", "ys"):
        if getattr(ref, k) is not None:
            _close(getattr(got, k), getattr(ref, k), 1e-10, k)
    if name == "terminal-zero-crossing":
        assert bool((got.status == EVENT_TERMINATED).all())
        np.testing.assert_allclose(got.event_t.numpy(), np.pi / 2, rtol=1e-7)


@pytest.mark.slow
def test_stiff_event_matches_reference():
    """A terminal event inside a stiff Van der Pol solve (μ = 100)."""
    kw = dict(method="radau", args=100.0, rtol=1e-8, atol=1e-11)
    ref = ref_solve_ivp(_vdp(jnp), (0.0, 200.0), jnp.array([[2.0, 0.0]]),
                        events=_ev(jnp, ref_events.Event), **kw)
    got = solve_ivp(_vdp(torch), (0.0, 200.0),
                    torch.tensor([[2.0, 0.0]], dtype=torch.float64),
                    events=_ev(torch, Event), **kw)
    assert int(got.status[0]) == EVENT_TERMINATED
    for k in ("t", "y", "event_t", "event_y"):
        _close(getattr(got, k), getattr(ref, k), 1e-10, k)


def _step_case(xp):
    """A hand-made accepted step for handle_events: lane 0 crosses both
    (identical) terminal events at the same θ, a tie; lane 1 crosses only
    the non-terminal event (its terminal row is all +inf); lane 2, going
    backward in time, crosses the non-terminal event first and the terminal
    ones later; lane 3 does not accept (a row of +inf)."""
    y_old = xp.asarray(np.array([[1.0, 0.0], [1.0, 0.0], [1.0, 0.0],
                                 [1.0, 0.0]]))
    y_new = xp.asarray(np.array([[-1.0, 0.0], [0.8, 0.0], [-0.5, 0.0],
                                 [-1.0, 0.0]]))
    t_old = xp.asarray(np.array([0.0, 0.0, 1.0, 0.0]))
    h = xp.asarray(np.array([0.5, 0.5, -0.25, 0.5]))
    accept = xp.asarray(np.array([True, True, True, False]))

    def interp(theta):
        return y_old[:, None, :] + theta[..., None] * (y_new - y_old)[:, None]

    return y_old, y_new, t_old, h, accept, interp


def _step_specs(ev_cls):
    return [ev_cls(lambda t, y, a: y[:, 0] - 0.25 * a, terminal=True),
            ev_cls(lambda t, y, a: y[:, 0] - 0.25 * a, terminal=True),
            ev_cls(lambda t, y, a: y[:, 0] - 0.9, terminal=False)]


@pytest.mark.parametrize("counted", [True, False])
def test_handle_events_tie_and_empty_row(counted):
    y_old, y_new, t_old, h, accept, interp = _step_case(jnp)
    specs = _step_specs(ref_events.Event)
    st = ref_events.init_event_state(specs, 4, 2, t_old, y_old, 1.0,
                                     jnp.float64)
    ref = ref_events.handle_events(specs, st, t_old, h, y_old, t_old + h,
                                   y_new, interp, accept, 1.0)
    y_old, y_new, t_old, h, accept, interp = _step_case(torch)
    specs = _step_specs(Event)
    st = events_mod.init_event_state(specs, 4, 2, t_old, y_old, 1.0)
    syncs = _HostSyncs() if counted else None
    got = events_mod.handle_events(specs, st, t_old, h, t_old + h, y_new,
                                   interp, accept, 1.0, syncs)
    if counted:
        assert syncs.count == 1                  # the bisection's gate
    # XLA contracts t + θ·h into one rounding: times agree to an ulp
    for k in ref[0]:
        np.testing.assert_allclose(got[0][k].numpy(), np.asarray(ref[0][k]),
                                   rtol=1e-15, err_msg=k)
    for i, what in enumerate(("terminate", "t_ev", "y_ev", "idx"), start=1):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref[i]),
                                   rtol=1e-15, err_msg=what)
    # the tie goes to the first event, a row of +inf to index 0
    assert got[4].tolist() == [0, 2, 0, 0]
    assert got[1].tolist() == [True, False, True, False]
    assert got[0]["event_idx"].tolist() == [0, 2, 0, -1]


def test_radau_tangents_and_quad_at_event_match_reference():
    """IND at a terminal event: sens = yd(t*) + ẏ*·dt*, sens_t = dt*,
    sens_ys NaN past t*, quad and sens_quad truncated at t*."""
    mus = np.array([5.0, 10.0, 3.0])
    y0 = np.array([[2.0, 0.0], [1.5, 0.3], [2.0, 0.0]])
    thr = np.array([0.0, 0.0, -5.0])           # lane 2 never fires
    seeds = np.stack([np.tile(np.eye(2)[j], (3, 1)) for j in range(2)])
    dmu = np.stack([mus * 0.01, np.array([1.0, -0.5, 0.2])])
    t_eval = np.linspace(0.0, 6.0, 9)
    kw = dict(method="radau", rtol=1e-8, atol=1e-10)

    def run(xp, solve, ev_cls):
        return solve(_vdp(xp), (0.0, 6.0), xp.asarray(y0),
                     args=xp.asarray(mus), events=_ev(xp, ev_cls, thr),
                     tangents=xp.asarray(seeds), args_tangents=xp.asarray(dmu),
                     t_eval=xp.asarray(t_eval),
                     quad=lambda t, y, a: y[:, 0] ** 2 + a * y[:, 1], **kw)

    ref = run(jnp, ref_solve_ivp, ref_events.Event)
    got = run(torch, solve_ivp, Event)
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    assert got.status.tolist() == [5, 5, 1]
    for k, tol in (("t", 1e-10), ("y", 1e-10), ("ys", 1e-10), ("quad", 1e-10),
                   ("sens", 1e-8), ("sens_t", 1e-8), ("sens_ys", 1e-8),
                   ("sens_quad", 1e-8)):
        _close(getattr(got, k), getattr(ref, k), tol, k)


def _adj_case(xp, adj, opts, p, ev_cls, t_eval):
    """Σ y*² + 2 Σ t* (+ the fit of the samples and a cost with t_eval)."""
    ev = _ev(xp, ev_cls, xp.asarray(np.array([0.0, -50.0, 0.5])),
             direction=-1.0)
    if t_eval:
        ys, y, t, q = adj(_vdp(xp), (0.0, 3.0), p["y0"], args=p["mu"],
                          options=opts, events=ev, cost=lambda t, y, a:
                          y[:, 0] ** 2,
                          t_eval=xp.asarray(np.array([0.5, 1.0, 2.0, 3.0])))
        fit = xp.sum(xp.where(xp.isfinite(ys), ys, 0.0) ** 2) + xp.sum(q)
    else:
        y, t = adj(_vdp(xp), (0.0, 3.0), p["y0"], args=p["mu"], options=opts,
                   events=ev)
        fit = 0.0
    return xp.sum(y ** 2) + 2.0 * xp.sum(t) + fit, (y, t)


@pytest.mark.parametrize("t_eval", [False, True], ids=["terminal", "t_eval"])
def test_radau_adjoint_events_match_reference(t_eval):
    rng = np.random.default_rng(5)
    inputs = {"y0": np.tile([[2.0, 0.0]], (3, 1))
              + 0.1 * rng.standard_normal((3, 2)),
              "mu": np.array([2.0, 5.0, 20.0])}
    ref_opts = RefOptions(rtol=1e-6, atol=1e-9, adjoint_steps=256)
    (_, (y_ref, t_ref)), g_ref = jax.value_and_grad(
        lambda a, b: _adj_case(jnp, ref_radau_adjoint, ref_opts,
                               {"y0": a, "mu": b}, ref_events.Event, t_eval),
        argnums=(0, 1), has_aux=True)(jnp.asarray(inputs["y0"]),
                                      jnp.asarray(inputs["mu"]))
    p = {n: torch.tensor(v, requires_grad=True) for n, v in inputs.items()}
    loss, (y, t) = _adj_case(torch, radau_adjoint, options_from_jax(ref_opts),
                             p, Event, t_eval)
    loss.backward()
    assert float(t[0].detach()) < 3.0 and float(t[1].detach()) == 3.0
    _close(y, y_ref, 1e-10, "y*")
    _close(t, t_ref, 1e-10, "t*")
    for n, g in zip(("y0", "mu"), g_ref):
        _close(p[n].grad, g, 1e-7, f"gradient of {n}")


def test_radau_adjoint_event_guards():
    y0 = torch.tensor([[2.0, 0.0]], dtype=torch.float64)
    with pytest.raises(ValueError, match="terminal"):
        radau_adjoint(_vdp(torch), (0.0, 1.0), y0, args=1.0,
                      events=Event(lambda t, y, a: y[:, 0], terminal=False))
    with pytest.raises(ValueError, match="checkpoints"):
        radau_adjoint(_vdp(torch), (0.0, 1.0), y0, args=1.0, checkpoints=2,
                      events=Event(lambda t, y, a: y[:, 0]))
