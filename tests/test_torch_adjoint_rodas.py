"""The port's discrete adjoint ``rodas_adjoint`` on the CPU in float64.

(a) Against the JAX reference, in the same process, on the same inputs from
a numpy seed (M ≤ 3 lanes): one loss per case, written once for both
packages; ``jax.grad`` and ``loss.backward()`` give the gradients with
respect to y0, the parameters and, where the case has them, t0, tf and the
sample times. The primal to 1e-10 and every gradient to 1e-7, both relative
to the array's largest entry (measured: ~1e-13). The reference's adjoint
compiles in ~10 s, so four cases are in the fast tier and four are marked
``slow``; JAX's caches are cleared after every test.

(b) The port against itself: the transpose oracle (grad·δ equals
ȳ·``solve_rodas(tangents=[δ]).sens`` to 1e-10: the two are transposes of the
same frozen-mesh linear map), bench.py's configuration at four lanes with
the d/dμ check the card runs (central differences of the full solve, within
1e-4 relative at rtol 1e-4), NaN on mesh overflow, and what raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janus_tpu.solve import Options as RefOptions
from janus_tpu.solve.adjoint_rodas import rodas_adjoint as ref_rodas_adjoint
from janus_tpu.solve import events as ref_events
from janus_tpu_torch.bench import rodas as rodas_probe
from janus_tpu_torch.interop import options_from_jax
from janus_tpu_torch.models.problems import vdp_rhs
from janus_tpu_torch.solve import (Event, Options, rodas_adjoint,
                                   solve_adjoint)
from janus_tpu_torch.solve.rodas import solve_rodas

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


def _rob_dae(xp):
    """Robertson-style semi-explicit index-1 DAE, mass = diag(2, 1, 0), a
    dict of per-lane rates."""
    def rhs(t, y, k):
        k1, k2, k3 = k["k1"], k["k2"], k["k3"]
        x1, x2, z = y[:, 0], y[:, 1], y[:, 2]
        return xp.stack([2.0 * (-k1 * x1 + k3 * x2 * z),
                         k1 * x1 - k2 * x2 ** 2 - k3 * x2 * z,
                         x1 + x2 + z - 1.0], -1)
    return rhs


def _ev_cls(xp):
    return ref_events.Event if xp is jnp else Event


def _event(xp):
    """Lane 0 and 2 trigger (x falls through the threshold), lane 1 never."""
    thr = xp.asarray(np.array([0.0, -50.0, 0.5]))
    return _ev_cls(xp)(lambda t, y, a: y[:, 0] - thr, terminal=True,
                       direction=-1.0)


def _lq(t, y, mu):
    return y[:, 0] ** 2 + 0.1 * mu * y[:, 1] ** 2


W2 = np.array([1.0, 0.7])


def _case_terminal(xp, adj, opts, p):
    """Σ w·y(T)² with t0 and tf differentiated too."""
    y = adj(_vdp(xp), (p["t0"], p["tf"]), p["y0"], args=p["mu"], options=opts)
    return xp.sum(xp.asarray(W2) * y ** 2), y


def _case_cost(xp, adj, opts, p):
    y, q = adj(_vdp(xp), (0.0, 1.5), p["y0"], args=p["mu"], options=opts,
               cost=_lq)
    return xp.sum(y ** 2) + xp.sum(q), y


def _case_events(xp, adj, opts, p):
    y, t = adj(_vdp(xp), (0.0, 3.0), p["y0"], args=p["mu"], options=opts,
               events=_event(xp))
    return xp.sum(y ** 2) + 2.0 * xp.sum(t), y


def _case_events_cost(xp, adj, opts, p):
    y, t, q = adj(_vdp(xp), (0.0, 3.0), p["y0"], args=p["mu"], options=opts,
                  events=_event(xp), cost=_lq)
    return xp.sum(y ** 2) + 2.0 * xp.sum(t) + xp.sum(q), y


def _case_events_t_eval(xp, adj, opts, p):
    """A fit of the samples (NaN past t* masked) plus y*, t*."""
    ys, y, t = adj(_vdp(xp), (0.0, 3.0), p["y0"], args=p["mu"], options=opts,
                   events=_event(xp),
                   t_eval=xp.asarray(np.array([0.5, 1.0, 2.0, 3.0])))
    fit = xp.sum(xp.where(xp.isfinite(ys), ys, 0.0) ** 2)
    return fit + xp.sum(y[:, 1] ** 2) + 2.0 * xp.sum(t), y


def _case_t_eval_cost(xp, adj, opts, p):
    """The sample times are differentiated too."""
    ys, q = adj(_vdp(xp), (0.0, 1.2), p["y0"], args=p["mu"], options=opts,
                t_eval=p["ts"], cost=_lq)
    return xp.sum(ys ** 2) + 0.5 * xp.sum(q), ys


def _case_mass(xp, adj, opts, p):
    mass = xp.asarray(np.array([[2.0, 0.3], [0.1, 1.5]]))
    y = adj(_vdp(xp), (0.0, 1.0), p["y0"], args=p["mu"], options=opts,
            mass=mass)
    return xp.sum(y ** 2), y


def _case_dae(xp, adj, opts, p):
    """n_alg=1: z0 from the differential slots; t0 and tf differentiated
    through the constrained velocity."""
    xd = p["x0"]
    y0 = xp.concatenate([xd, (1.0 - xd[:, 0] - xd[:, 1])[:, None]], -1)
    k = {"k1": p["k1"], "k2": p["k2"], "k3": p["k3"]}
    y = adj(_rob_dae(xp), (p["t0"], p["tf"]), y0, args=k, options=opts,
            mass=xp.asarray(np.diag([2.0, 1.0, 0.0])), n_alg=1)
    return xp.sum(xp.asarray(np.array([0.6, 1.1, 1.7])) * y ** 2), y


def _vdp_inputs(m=3):
    rng = np.random.default_rng(31)
    y0 = np.tile([[2.0, 0.0]], (m, 1)) + 0.1 * rng.standard_normal((m, 2))
    return {"y0": y0, "mu": np.array([2.0, 5.0, 20.0])[:m]}


_TIGHT = dict(rtol=1e-6, atol=1e-9, adjoint_steps=256)
PARITY = {
    "terminal-t0-tf": (_case_terminal,
                       {**_vdp_inputs(), "t0": np.float64(0.1),
                        "tf": np.float64(1.4)}, _TIGHT),
    "events-cost": (_case_events_cost, _vdp_inputs(), _TIGHT),
    "events-t_eval": (_case_events_t_eval, _vdp_inputs(), _TIGHT),
    "dae-n_alg": (_case_dae,
                  {"x0": np.array([[1.0, 0.2], [0.8, 0.4]]),
                   "k1": np.array([0.5, 0.7]), "k2": np.array([10.0, 6.0]),
                   "k3": np.array([2.0, 3.0]), "t0": np.float64(0.0),
                   "tf": np.float64(2.0)},
                  dict(rtol=1e-7, atol=1e-10, adjoint_steps=256)),
}
PARITY_SLOW = {
    "cost": (_case_cost, _vdp_inputs(), _TIGHT),
    "events": (_case_events, _vdp_inputs(), _TIGHT),
    "t_eval-cost-sample-times": (
        _case_t_eval_cost, {**_vdp_inputs(2), "ts": np.array([0.4, 0.8, 1.2])},
        _TIGHT),
    "mass": (_case_mass, _vdp_inputs(), _TIGHT),
}


def _parity(case, inputs, okw):
    ref_opts = RefOptions(**okw)
    names = sorted(inputs)
    (_, y_ref), g_ref = jax.value_and_grad(
        lambda *a: case(jnp, ref_rodas_adjoint, ref_opts,
                        dict(zip(names, a))),
        argnums=tuple(range(len(names))), has_aux=True)(
            *(jnp.asarray(inputs[n]) for n in names))
    p = {n: torch.tensor(inputs[n], dtype=torch.float64, requires_grad=True)
         for n in names}
    loss, y = case(torch, rodas_adjoint, options_from_jax(ref_opts), p)
    loss.backward()

    def close(got, ref, tol, what):
        ref = np.asarray(ref)
        assert np.all(np.isfinite(ref)), what
        np.testing.assert_allclose(
            got.detach().numpy(), ref, rtol=0,
            atol=tol * float(np.abs(ref).max()), err_msg=what)

    close(y, y_ref, 1e-10, "primal")
    for n, g in zip(names, g_ref):
        close(p[n].grad, g, 1e-7, f"gradient of {n}")


@pytest.mark.parametrize("name", list(PARITY))
def test_gradients_match_reference(name):
    _parity(*PARITY[name])


@pytest.mark.slow
@pytest.mark.parametrize("name", list(PARITY_SLOW))
def test_gradients_match_reference_slow(name):
    _parity(*PARITY_SLOW[name])


# ---- (b) the port against itself -------------------------------------------

def test_transpose_of_ind_tangents():
    """<∂L/∂(y0, μ), δ> == ȳ·sens(δ) to 1e-10: the adjoint and the forward
    IND tangents are transposes of the same frozen-mesh linear map."""
    opts = Options(rtol=1e-6, atol=1e-9, adjoint_steps=256)
    p = {n: torch.tensor(v) for n, v in _vdp_inputs().items()}
    y0 = p["y0"].clone().requires_grad_()
    mu = p["mu"].clone().requires_grad_()
    y = rodas_adjoint(vdp_rhs, (0.0, 2.0), y0, args=mu, options=opts)
    torch.sum(y ** 2).backward()
    rng = np.random.default_rng(4)
    for _ in range(2):
        d_y0 = torch.from_numpy(rng.standard_normal((3, 2)))
        d_mu = torch.from_numpy(rng.standard_normal(3))
        sol = solve_rodas(vdp_rhs, 0.0, 2.0, p["y0"], p["mu"], opts,
                          tangents=d_y0[None], args_tangents=d_mu[None])
        lhs = float(torch.sum(y0.grad * d_y0) + torch.sum(mu.grad * d_mu))
        rhs = float(torch.sum(2.0 * sol.y * sol.sens[0]))
        assert abs(lhs - rhs) <= 1e-10 * abs(rhs), (lhs, rhs)


def test_bench_configuration_checks_on_four_lanes():
    """bench.py's rodas-adjoint gradient (μ = logspace(1.5, 3), rtol 1e-4,
    adjoint_steps=128, Σ y(T)²) at 4 lanes, with the checks the card runs:
    finite, the transpose oracle, d/dμ of 3 lanes against central
    differences of the full solve (measured 9.6e-8; the bound is rtol, 1e-4:
    the frozen-mesh gradient differs from the solver's derivative by the
    controller's O(rtol) mesh sensitivity)."""
    dev = torch.device("cpu")
    g = rodas_probe.gradient(4, torch.float64, dev)
    assert all(bool(torch.isfinite(x).all()) for x in g[1:])
    errs = rodas_probe.check_gradient(g, torch.float64, dev)
    assert errs["transpose"] <= 1e-10 and errs["fd_mu"] <= 1e-4, errs


def test_overflow_poisons_gradient():
    opts = Options(rtol=1e-8, atol=1e-11, adjoint_steps=8)
    y0 = torch.tensor([[2.0, 0.0], [2.0, 0.1]], dtype=torch.float64,
                      requires_grad=True)
    mu = torch.tensor([50.0, 1.0], dtype=torch.float64, requires_grad=True)
    y = rodas_adjoint(vdp_rhs, (0.0, 3.0), y0, args=mu, options=opts)
    torch.sum(y ** 2).backward()
    assert bool(torch.isnan(y0.grad).all()) and bool(torch.isnan(mu.grad).all())


def test_solve_adjoint_dispatches_to_rodas():
    y0 = torch.tensor(_vdp_inputs()["y0"], requires_grad=True)
    mu = torch.tensor(_vdp_inputs()["mu"])
    opts = Options(rtol=1e-6, atol=1e-9)
    a = solve_adjoint(vdp_rhs, (0.0, 1.0), y0, method="rodas", args=mu,
                      options=opts)
    b = rodas_adjoint(vdp_rhs, (0.0, 1.0), y0, args=mu, options=opts)
    assert torch.equal(a, b)


def test_rodas_adjoint_raises():
    y0 = torch.tensor([[2.0, 0.0]], dtype=torch.float64)
    with pytest.raises(ValueError, match="no backward"):
        rodas_adjoint(vdp_rhs, (0.0, 1.0), y0, args=1.0,
                      options=Options(kernel_lu=True, pivoting=False))
    with pytest.raises(ValueError, match="terminal"):
        rodas_adjoint(vdp_rhs, (0.0, 1.0), y0, args=1.0,
                      events=Event(lambda t, y, a: y[:, 0], terminal=False))
    with pytest.raises(ValueError, match="needs mass"):
        rodas_adjoint(vdp_rhs, (0.0, 1.0), y0, args=1.0, n_alg=1)
    with pytest.raises(ValueError, match="must be scalars"):
        rodas_adjoint(vdp_rhs, (0.0, torch.ones(1, dtype=torch.float64)), y0,
                      args=1.0, t_eval=np.array([0.5, 1.0]))
