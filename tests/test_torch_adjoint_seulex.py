"""The port's discrete adjoint ``seulex_adjoint`` on the CPU in float64.

(a) Against the JAX reference, in the same process, on the same inputs from
a numpy seed (M ≤ 3 lanes): one loss per case, written once for both
packages; ``jax.grad`` and ``loss.backward()`` give the gradients with
respect to y0, the parameters and, where the case has them, t0, tf and the
sample times. The primal to 1e-10 and every gradient to 1e-7, both relative
to the array's largest entry (measured: ~1e-13). The reference's adjoint
compiles in 13-30 s a case at ``seulex_kmax=4``, so one case is in the fast
tier and the rest (all ``slow`` in the reference's own tests) are ``slow``
here too.

(b) The port against itself: the replay at each recorded (t, h, y, k) slot
reproduces the next recorded state (the recording forward refreshes J at
every step point, so to the bit); the backward sweep equals torch autograd
of the frozen replay chain to 1e-10 (the reference's own oracle: the sweep
is the vjp of that chain by construction); the per-(lane, level) live mask
keeps the leaves' gradients finite where a dead slot's benign replay
overflows; NaN on mesh overflow; dispatch and what raises. No transpose
oracle: the gradient differentiates through the iteration matrix, the IND
tangents drop ∂A/∂y (a W-method).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janus_tpu.solve import Options as RefOptions
from janus_tpu.solve import events as ref_events
from janus_tpu.solve.adjoint_seulex import seulex_adjoint as ref_adjoint
from janus_tpu_torch.interop import options_from_jax
from janus_tpu_torch.solve import (Event, Options, seulex_adjoint,
                                   solve_adjoint)
from janus_tpu_torch.solve import adjoint_seulex as adj
from janus_tpu_torch.solve.radau import default_jacobian
from janus_tpu_torch.solve.seulex import solve_seulex

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clear_caches_each_test():
    yield
    jax.clear_caches()


def _vdp(xp):
    def rhs(t, y, mu):
        x, v = y[:, 0], y[:, 1]
        return xp.stack([v, mu * (1.0 - x * x) * v - x], -1)
    return rhs


def _forced_vdp(xp):
    """VdP with a per-lane μ and a shared drive in a dict."""
    def rhs(t, y, p):
        x, v = y[:, 0], y[:, 1]
        return xp.stack([v, p["mu"] * (1.0 - x * x) * v - x
                         + p["drive"] * xp.sin(t)], -1)
    return rhs


def _rob_dae(xp):
    """Robertson in semi-explicit index-1 form: 0 = 1 − y1 − y2 − y3."""
    def rhs(t, y, k):
        k1, k2, k3 = k[..., 0], k[..., 1], k[..., 2]
        y1, y2, y3 = y[:, 0], y[:, 1], y[:, 2]
        return xp.stack([-k1 * y1 + k3 * y2 * y3,
                         k1 * y1 - k2 * y2 ** 2 - k3 * y2 * y3,
                         1.0 - y1 - y2 - y3], -1)
    return rhs


_DAE_MASS = np.diag([1.0, 1.0, 0.0])


def _event(xp):
    """Lane 0 triggers (x falls through 1.2), lane 1 never."""
    thr = xp.asarray(np.array([1.2, -50.0]))
    cls = ref_events.Event if xp is jnp else Event
    return cls(lambda t, y, a: y[:, 0] - thr, terminal=True, direction=-1.0)


def _lq(t, y, mu):
    return y[:, 0] ** 2 + 0.1 * y[:, 1] ** 2


def _case_terminal(xp, fn, opts, p):
    y = fn(_vdp(xp), (p["t0"], p["tf"]), p["y0"], args=p["mu"], options=opts)
    return xp.sum(y ** 2), y


def _case_pytree(xp, fn, opts, p):
    y = fn(_forced_vdp(xp), (0.0, 2.0), p["y0"],
           args={"mu": p["mu"], "drive": p["drive"]}, options=opts)
    return xp.sum(y[:, 0] ** 2), y


def _case_t_eval(xp, fn, opts, p):
    ys = fn(_vdp(xp), (0.0, 3.0), p["y0"], args=p["mu"], options=opts,
            t_eval=p["ts"])
    return xp.sum(ys ** 2), ys


def _case_events(xp, fn, opts, p):
    y, t = fn(_vdp(xp), (0.0, 2.0), p["y0"], args=p["mu"], options=opts,
              events=_event(xp))
    return xp.sum(y ** 2) + 2.0 * xp.sum(t), y


def _case_events_t_eval(xp, fn, opts, p):
    ys, y, t = fn(_vdp(xp), (0.0, 2.0), p["y0"], args=p["mu"], options=opts,
                  events=_event(xp),
                  t_eval=xp.asarray(np.array([0.5, 1.0, 1.5, 2.0])))
    fit = xp.sum(xp.where(xp.isfinite(ys), ys, 0.0) ** 2)
    return fit + xp.sum(y[:, 1] ** 2) + 2.0 * xp.sum(t), y


def _case_cost(xp, fn, opts, p):
    y, q = fn(_vdp(xp), (p["t0"], p["tf"]), p["y0"], args=p["mu"],
              options=opts, cost=_lq)
    return xp.sum(y ** 2) + xp.sum(q), y


def _case_events_cost(xp, fn, opts, p):
    y, t, q = fn(_vdp(xp), (0.0, 2.0), p["y0"], args=p["mu"], options=opts,
                 events=_event(xp), cost=_lq)
    return xp.sum(y ** 2) + 2.0 * xp.sum(t) + xp.sum(q), y


def _case_dae(xp, fn, opts, p):
    y = fn(_rob_dae(xp), (p["t0"], p["tf"]), p["y0"], args=p["k"],
           options=opts, mass=xp.asarray(_DAE_MASS), n_alg=1)
    return xp.sum(y[:, 1] ** 2 * 1e8) + xp.sum(y ** 2), y


def _case_mass(xp, fn, opts, p):
    mass = xp.asarray(np.array([[2.0, 0.3], [0.1, 1.5]]))
    y = fn(_vdp(xp), (0.0, 1.0), p["y0"], args=p["mu"], options=opts,
           mass=mass)
    return xp.sum(y ** 2), y


def _vdp_inputs(m=2):
    rng = np.random.default_rng(43)
    y0 = np.tile([[2.0, 0.0]], (m, 1)) + 0.1 * rng.standard_normal((m, 2))
    return {"y0": y0, "mu": np.array([5.0, 30.0, 2.0])[:m]}


_K4 = dict(rtol=1e-7, atol=1e-10, adjoint_steps=256, seulex_kmax=4)
_EVENTS = dict(rtol=1e-8, atol=1e-11, adjoint_steps=1024, seulex_kmax=4)
_EV_INPUTS = {"y0": np.array([[2.0, 0.0], [2.0, 0.5]]),
              "mu": np.array([2.0, 2.0])}
_DAE_INPUTS = {"y0": np.tile([1.0, 0.0, 0.0], (2, 1)),
               "k": np.array([[0.04, 3e7, 1e4], [0.052, 3e7, 1e4]]),
               "t0": np.float64(0.0), "tf": np.float64(10.0)}
PARITY = {
    "terminal-t0-tf": (_case_terminal,
                       {**_vdp_inputs(), "t0": np.float64(0.0),
                        "tf": np.float64(2.0)}, _K4),
}
PARITY_SLOW = {
    "events-mixed": (_case_events, _EV_INPUTS, _EVENTS),
    "pytree-heterogeneous": (
        _case_pytree, {"y0": _vdp_inputs(3)["y0"],
                       "mu": np.array([1.0, 100.0, 400.0]),
                       "drive": np.float64(0.3)}, _K4),
    "t_eval": (_case_t_eval, {**_vdp_inputs(),
                              "ts": np.array([0.7, 1.4, 2.1, 3.0])}, _K4),
    "events-t_eval": (_case_events_t_eval, _EV_INPUTS, _EVENTS),
    "cost": (_case_cost, {**_vdp_inputs(), "t0": np.float64(0.0),
                          "tf": np.float64(2.0)}, _K4),
    "events-cost": (_case_events_cost, _EV_INPUTS, _EVENTS),
    "dae-n_alg": (_case_dae, _DAE_INPUTS,
                  dict(rtol=1e-7, atol=1e-12, adjoint_steps=512,
                       seulex_kmax=6)),
    "mass": (_case_mass, _vdp_inputs(), _K4),
}


def _parity(case, inputs, okw):
    ref_opts = RefOptions(**okw)
    names = sorted(inputs)
    (_, y_ref), g_ref = jax.value_and_grad(
        lambda *a: case(jnp, ref_adjoint, ref_opts, dict(zip(names, a))),
        argnums=tuple(range(len(names))), has_aux=True)(
            *(jnp.asarray(inputs[n]) for n in names))
    p = {n: torch.tensor(inputs[n], dtype=torch.float64, requires_grad=True)
         for n in names}
    loss, y = case(torch, seulex_adjoint, options_from_jax(ref_opts), p)
    loss.backward()

    def close(got, ref, tol, what):
        ref = np.asarray(ref)
        got = got.detach().numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref),
                                      err_msg=what)
        np.testing.assert_allclose(
            got, ref, rtol=0, atol=tol * float(np.nanmax(np.abs(ref))),
            err_msg=what)

    close(y, y_ref, 1e-10, "primal")
    for n, g in zip(names, g_ref):
        assert np.all(np.isfinite(np.asarray(g))), n
        close(p[n].grad, g, 1e-7, f"gradient of {n}")


@pytest.mark.parametrize("name", list(PARITY))
def test_gradients_match_reference(name):
    _parity(*PARITY[name])


@pytest.mark.slow
@pytest.mark.parametrize("name", list(PARITY_SLOW))
def test_gradients_match_reference_slow(name):
    _parity(*PARITY_SLOW[name])


# ---- (b) the port against itself -------------------------------------------

_OPTS = Options(rtol=1e-6, atol=1e-9, adjoint_steps=64, seulex_kmax=6)


def _recorded(opts=_OPTS):
    y0 = torch.tensor([[2.0, 0.0], [1.0, 1.0], [1.5, 0.5]],
                      dtype=torch.float64)
    mu = torch.tensor([3.0, 15.0, 200.0], dtype=torch.float64)
    sol = solve_seulex(_vdp(torch), 0.0, 2.0, y0, mu, opts,
                       _mesh_size=opts.adjoint_steps, _force_jac=True)
    assert bool((sol.status == 1).all())
    return y0, mu, sol


def _replay(mesh, i, nacc, y, mu, opts=_OPTS):
    """The frozen step map at slot i, as the backward sweep calls it."""
    live = i < nacc
    k_rec = torch.where(live, mesh["k"][:, i].to(torch.int64), 1)
    top = int(torch.where(live, mesh["k"][:, i], -1).max())
    return adj._one_step(
        lambda t, yy, a: _vdp(torch)(t, yy, a[0]),
        default_jacobian(lambda t, yy, a: _vdp(torch)(t, yy, a[0])), None,
        opts, torch.where(live, mesh["t"][:, i], 0.0),
        torch.where(live, mesh["h"][:, i], 1.0), y, k_rec, top, [mu], live)


def test_replay_reproduces_forward_mesh():
    """_one_step at each recorded slot gives the next slot's state, and at
    each lane's last slot its final state, to the bit."""
    _, mu, sol = _recorded()
    mesh, nacc = sol.mesh, sol.stats["naccept"]
    for i in range(int(nacc.max())):
        y_rep = _replay(mesh, i, nacc, mesh["y"][:, i], mu)
        nxt = torch.where((i + 1 < nacc)[:, None], mesh["y"][:, i + 1],
                          sol.y)
        live = i < nacc
        assert torch.equal(y_rep[live], nxt[live]), i


def test_sweep_equals_autograd_of_the_frozen_chain():
    """seulex_adjoint's gradient equals torch autograd through the chain of
    replays on the recorded mesh to 1e-10 (the sweep is the vjp of that
    chain by construction)."""
    y0, mu, sol = _recorded()
    mesh, nacc = sol.mesh, sol.stats["naccept"]
    y0c = y0.clone().requires_grad_()
    muc = mu.clone().requires_grad_()
    y = y0c
    for i in range(int(nacc.max())):
        y = torch.where((i < nacc)[:, None], _replay(mesh, i, nacc, y, muc),
                        y)
    torch.sum(y ** 2).backward()
    y0a = y0.clone().requires_grad_()
    mua = mu.clone().requires_grad_()
    y_end = seulex_adjoint(_vdp(torch), (0.0, 2.0), y0a, args=mua,
                           options=_OPTS)
    assert torch.equal(y_end.detach(), sol.y)
    torch.sum(y_end ** 2).backward()
    assert seulex_adjoint.host_syncs == 1
    for got, ref in ((y0a.grad, y0c.grad), (mua.grad, muc.grad)):
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=1e-10 * float(ref.abs().max()))


def _dae_gradient():
    y0 = torch.tensor(_DAE_INPUTS["y0"], requires_grad=True)
    k = torch.tensor(_DAE_INPUTS["k"], requires_grad=True)
    y = seulex_adjoint(_rob_dae(torch), (0.0, 10.0), y0, args=k,
                       options=Options(rtol=1e-7, atol=1e-12,
                                       adjoint_steps=512, seulex_kmax=6),
                       mass=torch.from_numpy(_DAE_MASS), n_alg=1)
    (torch.sum(y[:, 1] ** 2 * 1e8) + torch.sum(y ** 2)).backward()
    return y0.grad, k.grad


def test_live_mask_keeps_dead_levels_finite(monkeypatch):
    """Robertson's benign dead slot: the lanes finish at different step
    counts, so the sweep replays dead slots at (t0, h = 1, y0). With the
    per-(lane, level) live mask the gradients are finite; a replay that
    integrates every lane up to the slot's top level (the mask removed)
    overflows there and poisons the shared leaves' gradients with NaN."""
    g_y0, g_k = _dae_gradient()
    assert bool(torch.isfinite(g_y0).all() & torch.isfinite(g_k).all())

    one_step = adj._one_step

    def unmasked(f, jac_fn, mass, opts, t, h, y, k_rec, top, args, live,
                 want_interp=False):
        every = torch.ones_like(live)
        return one_step(f, jac_fn, mass, opts, t, h, y,
                        torch.full_like(k_rec, top), top, args, every,
                        want_interp)

    monkeypatch.setattr(adj, "_one_step", unmasked)
    g_y0, g_k = _dae_gradient()
    assert not bool(torch.isfinite(g_k).all())


def test_overflow_poisons_gradient():
    y0 = torch.tensor([[2.0, 0.0]], dtype=torch.float64, requires_grad=True)
    y = seulex_adjoint(_vdp(torch), (0.0, 3.0), y0,
                       args=torch.tensor([50.0], dtype=torch.float64),
                       options=Options(rtol=1e-9, atol=1e-12,
                                       adjoint_steps=4, seulex_kmax=6))
    torch.sum(y ** 2).backward()
    assert bool(torch.isnan(y0.grad).all())


def test_solve_adjoint_dispatches_to_seulex():
    y0 = torch.tensor([[2.0, 0.0]], dtype=torch.float64, requires_grad=True)
    mu = torch.tensor([5.0], dtype=torch.float64)
    opts = Options(rtol=1e-6, atol=1e-9, adjoint_steps=64, seulex_kmax=5)
    a = solve_adjoint(_vdp(torch), (0.0, 1.0), y0, method="seulex", args=mu,
                      options=opts)
    b = seulex_adjoint(_vdp(torch), (0.0, 1.0), y0, args=mu, options=opts)
    assert torch.equal(a, b)
    (ga,) = torch.autograd.grad(a.sum(), y0)
    (gb,) = torch.autograd.grad(b.sum(), y0)
    assert torch.equal(ga, gb)


def test_seulex_adjoint_raises():
    y0 = torch.zeros((1, 2), dtype=torch.float64)
    with pytest.raises(ValueError, match="terminal"):
        seulex_adjoint(_vdp(torch), (0.0, 1.0), y0, args=1.0,
                       events=Event(lambda t, y, a: y[:, 0], terminal=False))
    with pytest.raises(ValueError, match="n_alg"):
        seulex_adjoint(_vdp(torch), (0.0, 1.0), y0, args=1.0, n_alg=1)
