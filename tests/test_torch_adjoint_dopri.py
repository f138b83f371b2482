"""The port's discrete adjoint ``dopri_adjoint`` on the CPU in float64.

(a) Against the JAX reference, in the same process, on the same inputs from
a numpy seed (M ≤ 3 lanes): one loss per case, written once for both
packages; ``jax.grad`` and ``loss.backward()`` give the gradients with
respect to y0, the parameters (a dict with a per-lane and a shared leaf in
one case) and, where the case has them, t0, tf and the sample times. The
primal to 1e-10 and every gradient to 1e-9, both relative to the array's
largest entry (measured: ~1e-13). The reference's adjoint compiles in
~10 s (dopri5) to ~30–60 s (dopri853), so three dopri5 cases are in the
fast tier and the rest are marked ``slow``; JAX's caches are cleared after
every test.

(b) The port against itself: the replay of every recorded slot equals the
next recorded state to the bit (the FSAL value is a fresh f(t, y)), NaN on
mesh overflow, finite gradients where a stiff lane's dead slots would
overflow an unmasked cascade, the dispatch and what raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janus_tpu.solve import Options as RefOptions
from janus_tpu.solve.adjoint_dopri import dopri_adjoint as ref_dopri_adjoint
from janus_tpu.solve import events as ref_events
from janus_tpu_torch.interop import options_from_jax
from janus_tpu_torch.models.problems import vdp_rhs
from janus_tpu_torch.solve import (Event, Options, dopri_adjoint,
                                   solve_adjoint)
from janus_tpu_torch.solve import dopri as dp
from janus_tpu_torch.solve.adjoint_dopri import _one_step

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


def _forced(xp):
    """Van der Pol with a shared forcing amplitude: args {'mu': [M],
    'drive': scalar}."""
    def rhs(t, y, p):
        x, v = y[:, 0], y[:, 1]
        return xp.stack([v, p["mu"] * (1.0 - x * x) * v - x
                         + p["drive"] * xp.sin(t)], -1)
    return rhs


def _event(xp):
    """Lane 0 and 2 trigger (x falls through the threshold), lane 1 never."""
    thr = xp.asarray(np.array([1.2, -50.0, 0.5]))
    cls = ref_events.Event if xp is jnp else Event
    return cls(lambda t, y, a: y[:, 0] - thr, terminal=True, direction=-1.0)


def _lq(t, y, mu):
    return y[:, 0] ** 2 + 0.1 * mu * y[:, 1] ** 2


def _case_terminal(xp, adj, opts, p, method):
    y = adj(_vdp(xp), (p["t0"], p["tf"]), p["y0"], args=p["mu"],
            options=opts, method=method)
    return xp.sum(xp.asarray(np.array([1.0, 0.7])) * y ** 2), y


def _case_t_eval_pytree(xp, adj, opts, p, method):
    """The sample times and both leaves of a dict args differentiated."""
    ys = adj(_forced(xp), (0.0, 4.0), p["y0"],
             args={"mu": p["mu"], "drive": p["drive"]}, options=opts,
             t_eval=p["ts"], method=method)
    return xp.sum(ys ** 2), ys


def _case_events(xp, adj, opts, p, method):
    y, t = adj(_vdp(xp), (0.0, 3.0), p["y0"], args=p["mu"], options=opts,
               events=_event(xp), method=method)
    return xp.sum(y ** 2) + 2.0 * xp.sum(t), y


def _case_events_t_eval(xp, adj, opts, p, method):
    """A fit of the samples (NaN past t* masked) plus y*, t*."""
    ys, y, t = adj(_vdp(xp), (0.0, 3.0), p["y0"], args=p["mu"], options=opts,
                   events=_event(xp),
                   t_eval=xp.asarray(np.array([0.5, 1.0, 2.0, 3.0])),
                   method=method)
    fit = xp.sum(xp.where(xp.isfinite(ys), ys, 0.0) ** 2)
    return fit + xp.sum(y[:, 1] ** 2) + 2.0 * xp.sum(t), y


def _case_cost(xp, adj, opts, p, method):
    y, q = adj(_vdp(xp), (p["t0"], p["tf"]), p["y0"], args=p["mu"],
               options=opts, cost=_lq, method=method)
    return xp.sum(y ** 2) + xp.sum(q), y


def _case_cost_t_eval(xp, adj, opts, p, method):
    ys, q = adj(_vdp(xp), (0.0, 2.0), p["y0"], args=p["mu"], options=opts,
                t_eval=xp.asarray(np.array([0.7, 1.4, 2.0])), cost=_lq,
                method=method)
    return xp.sum(ys ** 2) + xp.sum(q), ys


def _case_cost_events(xp, adj, opts, p, method):
    y, t, q = adj(_vdp(xp), (0.0, 3.0), p["y0"], args=p["mu"], options=opts,
                  events=_event(xp), cost=_lq, method=method)
    return xp.sum(y[:, 1] ** 2) + 2.0 * xp.sum(t) + xp.sum(q), y


def _vdp_inputs(m=3):
    rng = np.random.default_rng(41)
    y0 = np.tile([[2.0, 0.0]], (m, 1)) + 0.1 * rng.standard_normal((m, 2))
    return {"y0": y0, "mu": np.array([0.5, 1.0, 2.0])[:m]}


_OPTS = dict(rtol=1e-8, atol=1e-11, adjoint_steps=256)
_T = {"t0": np.float64(0.1), "tf": np.float64(2.5)}
PARITY = {
    "terminal-t0-tf-dopri5": (_case_terminal, {**_vdp_inputs(), **_T},
                              _OPTS, "dopri5"),
    "events-t_eval-dopri5": (_case_events_t_eval, _vdp_inputs(), _OPTS,
                             "dopri5"),
    "cost-t0-tf-dopri5": (_case_cost, {**_vdp_inputs(), **_T}, _OPTS,
                          "dopri5"),
}
PARITY_SLOW = {
    "terminal-t0-tf-dopri853": (_case_terminal, {**_vdp_inputs(), **_T},
                                _OPTS, "dopri853"),
    "t_eval-pytree-dopri853": (
        _case_t_eval_pytree,
        {**_vdp_inputs(2), "drive": np.float64(0.3),
         "ts": np.array([1.0, 2.2, 3.1, 4.0])}, _OPTS, "dopri853"),
    "events-dopri5": (_case_events, _vdp_inputs(), _OPTS, "dopri5"),
    "events-dopri853": (_case_events, _vdp_inputs(), _OPTS, "dopri853"),
    "events-t_eval-dopri853": (_case_events_t_eval, _vdp_inputs(), _OPTS,
                               "dopri853"),
    "cost-t0-tf-dopri853": (_case_cost, {**_vdp_inputs(), **_T}, _OPTS,
                            "dopri853"),
    "cost-t_eval-dopri5": (_case_cost_t_eval, _vdp_inputs(), _OPTS,
                           "dopri5"),
    "cost-events-dopri5": (_case_cost_events, _vdp_inputs(), _OPTS,
                           "dopri5"),
}


def _parity(case, inputs, okw, method):
    ref_opts = RefOptions(**okw)
    names = sorted(inputs)
    (_, y_ref), g_ref = jax.value_and_grad(
        lambda *a: case(jnp, ref_dopri_adjoint, ref_opts,
                        dict(zip(names, a)), method),
        argnums=tuple(range(len(names))), has_aux=True)(
            *(jnp.asarray(inputs[n]) for n in names))
    p = {n: torch.tensor(inputs[n], dtype=torch.float64, requires_grad=True)
         for n in names}
    loss, y = case(torch, dopri_adjoint, options_from_jax(ref_opts), p,
                   method)
    loss.backward()

    def close(got, ref, tol, what):
        ref = np.asarray(ref)
        got = got.detach().numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref),
                                      err_msg=what)
        np.testing.assert_allclose(
            got, ref, rtol=0, equal_nan=True,
            atol=tol * float(np.nanmax(np.abs(ref))), err_msg=what)

    close(y, y_ref, 1e-10, "primal")
    for n, g in zip(names, g_ref):
        assert np.all(np.isfinite(np.asarray(g))), n
        close(p[n].grad, g, 1e-9, f"gradient of {n}")


@pytest.mark.parametrize("name", list(PARITY))
def test_gradients_match_reference(name):
    _parity(*PARITY[name])


@pytest.mark.slow
@pytest.mark.parametrize("name", list(PARITY_SLOW))
def test_gradients_match_reference_slow(name):
    _parity(*PARITY_SLOW[name])


# ---- (b) the port against itself -------------------------------------------

@pytest.mark.parametrize("method", ["dopri5", "dopri853"])
def test_replay_reproduces_forward_mesh(method):
    """_one_step at every recorded (t, h, y) slot equals the next recorded
    step start, and at a lane's last slot its final state, to the bit."""
    tab = dp.TABLEAUS[method]
    y0 = torch.tensor([[2.0, 0.0], [1.5, 0.5]], dtype=torch.float64)
    mu = torch.tensor([0.5, 2.0], dtype=torch.float64)
    sol = dp.solve_erk(tab, vdp_rhs, 0.0, 4.0, y0, mu,
                       Options(rtol=1e-8, atol=1e-11), _mesh_size=256)
    assert bool((sol.status == 1).all())
    nacc = sol.stats["naccept"].tolist()
    mesh = sol.mesh
    for i in range(max(nacc)):
        y_rep = _one_step(tab, vdp_rhs, mesh["t"][:, i], mesh["h"][:, i],
                          mesh["y"][:, i], mu)
        for lane, n in enumerate(nacc):
            want = mesh["y"][lane, i + 1] if i + 1 < n else sol.y[lane]
            if i < n:
                assert torch.equal(y_rep[lane], want), (method, lane, i)


def test_overflow_poisons_gradient():
    opts = Options(rtol=1e-10, atol=1e-13, adjoint_steps=4)
    y0 = torch.tensor([[2.0, 0.0]], dtype=torch.float64, requires_grad=True)
    mu = torch.tensor([3.0], dtype=torch.float64, requires_grad=True)
    y = dopri_adjoint(vdp_rhs, (0.0, 4.0), y0, args=mu, options=opts)
    torch.sum(y ** 2).backward()
    assert bool(torch.isnan(y0.grad).all())
    assert bool(torch.isnan(mu.grad).all())


def test_dead_slot_stiff_args_stay_finite():
    """A stiff lane finishes in fewer slots than the slow one: its dead
    slots replay the identity (masked cascade), so its stiff parameter
    cannot overflow into NaN leaf gradients; the slow lane's d/dp against a
    central difference of the full solve (1e-4)."""
    opts = Options(rtol=1e-6, atol=1e-9, adjoint_steps=512)

    def rhs(t, y, p):
        return torch.stack([-p * y[..., 0], y[..., 1] * 0.1], dim=-1)

    y0 = torch.ones((2, 2), dtype=torch.float64, requires_grad=True)
    p = torch.tensor([800.0, 0.1], dtype=torch.float64, requires_grad=True)
    torch.sum(dopri_adjoint(rhs, (0.0, 1.0), y0, args=p,
                            options=opts) ** 2).backward()
    assert bool(torch.isfinite(y0.grad).all() & torch.isfinite(p.grad).all())

    def lfd(pv):
        s = dp.solve_erk(dp.TABLEAUS["dopri5"], rhs, 0.0, 1.0, y0.detach(),
                         pv, opts)
        return float(torch.sum(s.y ** 2))

    eps = 1e-5
    e = torch.tensor([0.0, eps], dtype=torch.float64)
    fd = (lfd(p.detach() + e) - lfd(p.detach() - e)) / (2 * eps)
    assert abs(float(p.grad[1]) - fd) <= 1e-4 * max(abs(fd), 1e-10)


def test_solve_adjoint_dispatches_to_dopri():
    y0 = torch.tensor(_vdp_inputs()["y0"], requires_grad=True)
    mu = torch.tensor(_vdp_inputs()["mu"])
    opts = Options(rtol=1e-6, atol=1e-9)
    for method, canonical in (("dopri5", "dopri5"), ("dop853", "dopri853")):
        a = solve_adjoint(vdp_rhs, (0.0, 1.0), y0, method=method, args=mu,
                          options=opts)
        b = dopri_adjoint(vdp_rhs, (0.0, 1.0), y0, args=mu, options=opts,
                          method=canonical)
        assert torch.equal(a, b)


def test_guards():
    with pytest.raises(ValueError, match="terminal"):
        dopri_adjoint(vdp_rhs, (0.0, 1.0), torch.zeros((1, 2)),
                      events=Event(lambda t, y, a: y[:, 0], terminal=False))
    with pytest.raises(ValueError, match="unknown method"):
        dopri_adjoint(vdp_rhs, (0.0, 1.0), torch.zeros((1, 2)),
                      method="rk4")


# ---- the neural-ODE training path (models.neural + dopri_adjoint) ----------

def test_mlp_matches_reference():
    """mlp_apply and nn_hamiltonian on the reference's mlp_init parameters
    carried across by interop.tree_to_torch, and the port's own mlp_init
    (seeded torch Generator): shapes, He scale, zero biases."""
    from janus_tpu.models import neural as ref_neural
    from janus_tpu_torch.interop import tree_to_torch
    from janus_tpu_torch.models.neural import (mlp_apply, mlp_init,
                                               nn_hamiltonian)

    ref_params = ref_neural.mlp_init(jax.random.PRNGKey(3), [2, 16, 16, 2],
                                     dtype=jnp.float64)
    params = tree_to_torch(ref_params, device="cpu")
    x = np.random.default_rng(5).standard_normal((7, 2))
    got = mlp_apply(params, torch.from_numpy(x))
    ref = np.asarray(ref_neural.mlp_apply(ref_params, jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-13 * np.abs(ref).max())
    h_ref = float(ref_neural.nn_hamiltonian(ref_params)(
        jnp.asarray(x[0, :1]), jnp.asarray(x[0, 1:]), None))
    h_got = float(nn_hamiltonian(params)(torch.from_numpy(x[0, :1]),
                                         torch.from_numpy(x[0, 1:]), None))
    assert abs(h_got - h_ref) <= 1e-13 * max(abs(h_ref), 1.0)
    own = mlp_init([2, 64, 3], torch.Generator().manual_seed(0),
                   dtype=torch.float64, device="cpu")
    assert [tuple(w.shape) for w in own["w"]] == [(2, 64), (64, 3)]
    assert all(bool((b == 0).all()) for b in own["b"])
    again = mlp_init([2, 64, 3], torch.Generator().manual_seed(0),
                     dtype=torch.float64, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(own["w"], again["w"]))
    assert abs(float(own["w"][1].std()) - (2.0 / 64) ** 0.5) < 0.03


@pytest.mark.parametrize("reg", [0.0, 1e-3])
def test_neural_ode_gradient_matches_reference(reg):
    """The example's loss (fit of t_eval samples, + reg · the kinetic
    running cost) on an MLP [2, 8, 8, 2] whose weights the reference made:
    the loss to 1e-10 and every weight's gradient to 1e-9 of the JAX
    package's, on 3 lanes."""
    from janus_tpu.models import neural as ref_neural
    from janus_tpu_torch.interop import tree_to_torch
    from janus_tpu_torch.models.neural import mlp_apply

    ref_params = ref_neural.mlp_init(jax.random.PRNGKey(0), [2, 8, 8, 2],
                                     dtype=jnp.float64)
    rng = np.random.default_rng(9)
    y0 = rng.uniform(-1.5, 1.5, (3, 2))
    target = rng.standard_normal((3, 3, 2)) * 0.3
    ts = np.array([0.5, 1.0, 1.5])
    okw = dict(rtol=1e-6, atol=1e-9, adjoint_steps=64)

    def loss(xp, adj, mlp, opts, params):
        def f(t, y, p):
            return mlp(p, y)

        def kin(t, y, p):
            return xp.sum(mlp(p, y) ** 2, -1)

        if reg:
            ys, q = adj(f, (0.0, 1.5), xp.asarray(y0), args=params,
                        options=opts, t_eval=xp.asarray(ts), cost=kin)
            return xp.mean((ys - xp.asarray(target)) ** 2) + reg * xp.mean(q)
        ys = adj(f, (0.0, 1.5), xp.asarray(y0), args=params, options=opts,
                 t_eval=xp.asarray(ts))
        return xp.mean((ys - xp.asarray(target)) ** 2)

    l_ref, g_ref = jax.value_and_grad(
        lambda p: loss(jnp, ref_dopri_adjoint, ref_neural.mlp_apply,
                       RefOptions(**okw), p))(ref_params)
    params = tree_to_torch(ref_params, device="cpu")
    leaves = params["w"] + params["b"]
    for leaf in leaves:
        leaf.requires_grad_()
    lv = loss(torch, dopri_adjoint, mlp_apply,
              options_from_jax(RefOptions(**okw)), params)
    lv.backward()
    assert abs(float(lv.detach()) - float(l_ref)) <= 1e-10 * abs(
        float(l_ref))
    for got, ref in zip(leaves, g_ref["w"] + g_ref["b"]):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.grad.numpy(), ref, rtol=0,
                                   atol=1e-9 * np.abs(ref).max())
