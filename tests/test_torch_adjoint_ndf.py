"""The port's discrete adjoint ``ndf_adjoint`` on the CPU in float64.

(a) Against the JAX reference, in the same process, on the same inputs from
a numpy seed (M ≤ 4 lanes): one loss per case, written once for both
packages; ``jax.grad`` and ``loss.backward()`` give the gradients with
respect to y0, the parameters and, where the case has them, t0, tf and the
sample times. The primal to 1e-10 and every gradient to 1e-7, both relative
to the array's largest entry (measured: ~1e-14). The reference's adjoint
compiles in ~10 s a case, so seven cases are in the fast tier and the rest
of the reference's own adjoint tests (all ``slow`` there) are ``slow`` here
too; JAX's caches are cleared after every test.

(b) The port against itself: the mesh invariants (the recorded transforms
chain the accept-updates, and y(T) is the last update's slot 0), the
transpose oracle (grad·δ against ȳ·``solve_bdf(tangents=[δ]).sens``: the two
are transposes of one frozen-mesh map up to how far each converges its
corrector, so they agree to O(newton_tol): measured 2.4e-8 at the default
tolerance on bench.py's configuration, 4e-16 at newton_tol 1e-12), central
differences of the full solve, NaN on mesh overflow, and what raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janus_tpu.solve import Options as RefOptions
from janus_tpu.solve import events as ref_events
from janus_tpu.solve.adjoint_ndf import ndf_adjoint as ref_ndf_adjoint
from janus_tpu_torch.bench import ndf as ndf_probe
from janus_tpu_torch.bench.mol import fisher_kpp_rhs as line_rhs
from janus_tpu_torch.interop import options_from_jax
from janus_tpu_torch.models.problems import vdp_rhs
from janus_tpu_torch.solve import Event, Options, ndf_adjoint, solve_adjoint
from janus_tpu_torch.solve import ndf as nd
from janus_tpu_torch.solve.ndf import solve_bdf
from test_torch_mol_cases import ref_line_rhs

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
    """Robertson in semi-explicit index-1 form: 0 = y1 + y2 + y3 − 1."""
    def rhs(t, y, k):
        k1, k2, k3 = k[..., 0], k[..., 1], k[..., 2]
        y1, y2, y3 = y[:, 0], y[:, 1], y[:, 2]
        return xp.stack([-k1 * y1 + k3 * y2 * y3,
                         k1 * y1 - k2 * y2 ** 2 - k3 * y2 * y3,
                         1.0 - y1 - y2 - y3], -1)
    return rhs


def _line(xp, d):
    """bench.py's Fisher-KPP line at width d, args (ν, r)."""
    dx = 1.0 / (d + 1)
    return ref_line_rhs(dx) if xp is jnp else line_rhs(dx)


def _event(xp):
    """Lane 0 triggers (x falls through 1.2), lane 1 never."""
    thr = xp.asarray(np.array([1.2, -50.0]))
    cls = ref_events.Event if xp is jnp else Event
    return cls(lambda t, y, a: y[:, 0] - thr, terminal=True, direction=-1.0)


def _lq(t, y, mu):
    return y[:, 0] ** 2 + 0.1 * y[:, 1] ** 2


def _case_terminal(xp, adj, opts, p):
    y = adj(_vdp(xp), (p["t0"], p["tf"]), p["y0"], args=p["mu"], options=opts)
    return xp.sum(y ** 2), y


def _case_pytree(xp, adj, opts, p):
    y = adj(_forced_vdp(xp), (0.0, 1.0), p["y0"],
            args={"mu": p["mu"], "drive": p["drive"]}, options=opts)
    return xp.sum(y[:, 0] ** 2), y


def _case_t_eval(xp, adj, opts, p):
    ys = adj(_vdp(xp), (0.0, 1.5), p["y0"], args=p["mu"], options=opts,
             t_eval=p["ts"])
    return xp.sum(ys ** 2), ys


def _case_events(xp, adj, opts, p):
    y, t = adj(_vdp(xp), (0.0, 2.0), p["y0"], args=p["mu"], options=opts,
               events=_event(xp))
    return xp.sum(y ** 2) + 2.0 * xp.sum(t), y


def _case_cost(xp, adj, opts, p):
    y, q = adj(_vdp(xp), (p["t0"], p["tf"]), p["y0"], args=p["mu"],
               options=opts, cost=_lq)
    return xp.sum(y ** 2) + xp.sum(q), y


def _case_dae(xp, adj, opts, p):
    y = adj(_rob_dae(xp), (p["t0"], p["tf"]), p["y0"], args=p["k"],
            options=opts, mass=xp.asarray(np.diag([1.0, 1.0, 0.0])),
            n_alg=1)
    return xp.sum(y[:, 1] ** 2 * 1e8) + xp.sum(y ** 2), y


def _case_tridiag(xp, adj, opts, p):
    d = p["y0"].shape[1]
    w = xp.asarray(np.linspace(0.0, 1.0, d))
    y = adj(_line(xp, d), (0.0, 0.2), p["y0"], args=(0.01, p["rates"]),
            options=opts)
    return xp.sum(w * y ** 2), y


def _case_classic(xp, adj, opts, p):
    y = adj(_vdp(xp), (0.0, 2.0), p["y0"], args=p["mu"], options=opts,
            ndf=False)
    return xp.sum(y ** 2), y


def _case_events_cost(xp, adj, opts, p):
    y, t, q = adj(_vdp(xp), (0.0, 2.0), p["y0"], args=p["mu"], options=opts,
                  events=_event(xp), cost=_lq)
    return xp.sum(y ** 2) + 2.0 * xp.sum(t) + xp.sum(q), y


def _case_events_t_eval(xp, adj, opts, p):
    ys, y, t = adj(_vdp(xp), (0.0, 2.0), p["y0"], args=p["mu"], options=opts,
                   events=_event(xp),
                   t_eval=xp.asarray(np.array([0.5, 1.0, 1.5, 2.0])))
    fit = xp.sum(xp.where(xp.isfinite(ys), ys, 0.0) ** 2)
    return fit + xp.sum(y[:, 1] ** 2) + 2.0 * xp.sum(t), y


def _case_gmres(xp, adj, opts, p):
    return _case_tridiag(xp, adj, opts, p)


def _case_mass(xp, adj, opts, p):
    mass = xp.asarray(np.array([[2.0, 0.3], [0.1, 1.5]]))
    y = adj(_vdp(xp), (0.0, 1.0), p["y0"], args=p["mu"], options=opts,
            mass=mass)
    return xp.sum(y ** 2), y


def _vdp_inputs(m=2):
    rng = np.random.default_rng(41)
    y0 = np.tile([[2.0, 0.0]], (m, 1)) + 0.1 * rng.standard_normal((m, 2))
    return {"y0": y0, "mu": np.array([5.0, 30.0, 2.0, 100.0])[:m]}


def _line_inputs(d=12):
    dx = 1.0 / (d + 1)
    xg = np.linspace(dx, 1.0 - dx, d)
    return {"y0": np.tile(np.exp(-100 * (xg - 0.3) ** 2)[None], (2, 1)),
            "rates": np.array([[1.0], [8.0]])}


_TIGHT = dict(rtol=1e-7, atol=1e-10, adjoint_steps=512)
_EVENTS = dict(rtol=1e-7, atol=1e-10, adjoint_steps=1024, max_steps=4096)
_EV_INPUTS = {"y0": np.array([[2.0, 0.0], [2.0, 0.5]]),
              "mu": np.array([2.0, 2.0])}
PARITY = {
    "terminal-t0-tf": (_case_terminal,
                       {**_vdp_inputs(), "t0": np.float64(0.0),
                        "tf": np.float64(2.0)}, _TIGHT),
    "pytree-heterogeneous": (
        _case_pytree, {"y0": _vdp_inputs(3)["y0"],
                       "mu": np.array([1.0, 100.0, 400.0]),
                       "drive": np.float64(0.3)}, _TIGHT),
    "t_eval": (_case_t_eval, {**_vdp_inputs(),
                              "ts": np.array([0.5, 1.0, 1.5])}, _TIGHT),
    "events-mixed": (_case_events, _EV_INPUTS, _EVENTS),
    "cost": (_case_cost, {**_vdp_inputs(), "t0": np.float64(0.0),
                          "tf": np.float64(1.5)}, _TIGHT),
    "dae-n_alg": (_case_dae,
                  {"y0": np.tile([1.0, 0.0, 0.0], (2, 1)),
                   "k": np.array([[0.04, 3e7, 1e4], [0.052, 3e7, 1e4]]),
                   "t0": np.float64(0.0), "tf": np.float64(10.0)},
                  dict(rtol=1e-7, atol=1e-11, adjoint_steps=512)),
    "tridiag-backward": (_case_tridiag, _line_inputs(),
                         dict(stage_solver="tridiag", rtol=1e-7, atol=1e-10,
                              adjoint_steps=512)),
}
PARITY_SLOW = {
    "classic-bdf": (_case_classic, _vdp_inputs(), _TIGHT),
    "events-cost": (_case_events_cost, _EV_INPUTS, _EVENTS),
    "events-t_eval": (_case_events_t_eval, _EV_INPUTS, _EVENTS),
    "gmres-backward": (_case_gmres, _line_inputs(),
                       dict(stage_solver="gmres", gmres_iters=25, rtol=1e-7,
                            atol=1e-10, adjoint_steps=512)),
    "mass": (_case_mass, _vdp_inputs(), _TIGHT),
}


def _parity(case, inputs, okw):
    ref_opts = RefOptions(**okw)
    names = sorted(inputs)
    (_, y_ref), g_ref = jax.value_and_grad(
        lambda *a: case(jnp, ref_ndf_adjoint, ref_opts, dict(zip(names, a))),
        argnums=tuple(range(len(names))), has_aux=True)(
            *(jnp.asarray(inputs[n]) for n in names))
    p = {n: torch.tensor(inputs[n], dtype=torch.float64, requires_grad=True)
         for n in names}
    loss, y = case(torch, ndf_adjoint, options_from_jax(ref_opts), p)
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

def test_mesh_chain_and_terminal_invariants():
    """The recorded mesh is the forward evolution: each step's composed
    transform maps the previous accept-update onto the next prediction
    basis, and y(T) is the last update's slot 0."""
    y0 = torch.tensor([[2.0, 0.0], [1.5, 0.5]], dtype=torch.float64)
    mu = torch.tensor([5.0, 30.0], dtype=torch.float64)
    sol = solve_bdf(vdp_rhs, 0.0, 3.0, y0, mu,
                    Options(rtol=1e-7, atol=1e-10), _mesh_size=512)
    assert bool((sol.status == 1).all())
    nacc = sol.stats["naccept"].tolist()
    mesh = sol.mesh
    assert int(mesh["k"][0, :nacc[0]].max()) >= 3
    for i in range(min(nacc) - 1):
        dh = nd._hist_update(mesh["D"][:, i], mesh["d"][:, i],
                             mesh["k"][:, i].long())
        torch.testing.assert_close(nd._apply_ru(mesh["T"][:, i + 1], dh),
                                   mesh["D"][:, i + 1], rtol=0, atol=1e-12)
    for lane in range(2):
        i = nacc[lane] - 1
        dh = nd._hist_update(mesh["D"][:, i], mesh["d"][:, i],
                             mesh["k"][:, i].long())
        torch.testing.assert_close(dh[lane, 0], sol.y[lane], rtol=0,
                                   atol=1e-13)


def test_transpose_of_ind_tangents():
    """<∂L/∂(y0, μ), δ> against ȳ·sens(δ): the forward's Richardson and
    the backward's transposed solve converge the same corrector map, so at
    newton_tol 1e-12 they agree to 1e-12 (measured 4e-16)."""
    opts = Options(rtol=1e-6, atol=1e-9, adjoint_steps=512, newton_tol=1e-12)
    p = {n: torch.tensor(v) for n, v in _vdp_inputs(3).items()}
    y0 = p["y0"].clone().requires_grad_()
    mu = p["mu"].clone().requires_grad_()
    y = ndf_adjoint(vdp_rhs, (0.0, 2.0), y0, args=mu, options=opts)
    torch.sum(y ** 2).backward()
    rng = np.random.default_rng(4)
    for _ in range(2):
        d_y0 = torch.from_numpy(rng.standard_normal((3, 2)))
        d_mu = torch.from_numpy(rng.standard_normal(3))
        sol = solve_bdf(vdp_rhs, 0.0, 2.0, p["y0"], p["mu"], opts,
                        tangents=d_y0[None], args_tangents=d_mu[None])
        lhs = float(torch.sum(y0.grad * d_y0) + torch.sum(mu.grad * d_mu))
        rhs = float(torch.sum(2.0 * sol.y * sol.sens[0]))
        assert abs(lhs - rhs) <= 1e-12 * abs(rhs), (lhs, rhs)


def test_bench_configuration_checks_on_four_lanes():
    """bench.py's stiff adjoint configuration (μ = logspace(1.5, 3), rtol
    1e-4, pivot-free, adjoint_steps=128, Σ y(T)²) at 4 lanes with the checks
    the card runs: finite, the transpose oracle within 1e-6 (measured
    2.4e-8 at the default newton_tol), d/dμ of 3 lanes against central
    differences of the full solve within 1e-3 (measured 2.7e-4: the frozen
    mesh leaves out the controller's O(rtol) dependence on μ)."""
    dev = torch.device("cpu")
    g = ndf_probe.gradient(4, torch.float64, dev)
    assert all(bool(torch.isfinite(x).all()) for x in g[1:])
    errs = ndf_probe.check_gradient(g, torch.float64, dev)
    assert errs["transpose"] <= ndf_probe.TRANSPOSE_BOUND, errs
    assert errs["fd_mu"] <= ndf_probe.FD_BOUND, errs


def test_central_differences_of_the_full_solve():
    """d/dy0 and d/dμ against central differences of solve_bdf (no JAX):
    the frozen-mesh gradient differs from the solver's derivative by the
    controller's O(rtol) mesh sensitivity (rtol 1e-9 here)."""
    opts = Options(rtol=1e-9, atol=1e-12, adjoint_steps=2048)
    y0 = torch.tensor([[2.0, 0.0], [1.5, 0.5]], dtype=torch.float64,
                      requires_grad=True)
    mu = torch.tensor([5.0, 30.0], dtype=torch.float64, requires_grad=True)
    torch.sum(ndf_adjoint(vdp_rhs, (0.0, 1.0), y0, args=mu,
                          options=opts) ** 2).backward()

    def lv(y0v, muv):
        return float(torch.sum(solve_bdf(vdp_rhs, 0.0, 1.0, y0v, muv,
                                         opts).y ** 2))

    eps = 1e-6
    for i in range(2):
        e = torch.zeros(2, dtype=torch.float64)
        e[i] = eps * float(mu.detach()[i])
        fd = (lv(y0.detach(), mu.detach() + e)
              - lv(y0.detach(), mu.detach() - e)) / (2 * e[i])
        assert abs(float(mu.grad[i]) - fd) <= 5e-5 * abs(fd) + 1e-6
        for j in range(2):
            e = torch.zeros((2, 2), dtype=torch.float64)
            e[i, j] = eps
            fd = (lv(y0.detach() + e, mu.detach())
                  - lv(y0.detach() - e, mu.detach())) / (2 * eps)
            assert abs(float(y0.grad[i, j]) - fd) <= 5e-5 * abs(fd) + 1e-6


def test_overflow_poisons_gradient():
    opts = Options(rtol=1e-9, atol=1e-12, adjoint_steps=8)
    y0 = torch.tensor([[2.0, 0.0]], dtype=torch.float64, requires_grad=True)
    mu = torch.tensor([50.0], dtype=torch.float64, requires_grad=True)
    y = ndf_adjoint(vdp_rhs, (0.0, 3.0), y0, args=mu, options=opts)
    torch.sum(y ** 2).backward()
    assert bool(torch.isnan(y0.grad).all()) and bool(torch.isnan(mu.grad).all())


def test_zero_length_lane_passes_the_cotangent():
    """A lane with no accepted step (t0 = tf) returns y0: its gradient is
    ȳ, and t̄0 = −t̄f."""
    y0 = torch.tensor([[2.0, 0.0]], dtype=torch.float64, requires_grad=True)
    t0 = torch.tensor(0.5, dtype=torch.float64, requires_grad=True)
    tf = torch.tensor(0.5, dtype=torch.float64, requires_grad=True)
    y = ndf_adjoint(vdp_rhs, (t0, tf), y0, args=3.0)
    torch.sum(y ** 2).backward()
    torch.testing.assert_close(y0.grad, 2.0 * y0.detach())
    torch.testing.assert_close(t0.grad, -tf.grad)


def test_solve_adjoint_dispatches_to_ndf():
    y0 = torch.tensor(_vdp_inputs()["y0"], requires_grad=True)
    mu = torch.tensor(_vdp_inputs()["mu"])
    opts = Options(rtol=1e-6, atol=1e-9)
    for method, flag in (("bdf", True), ("ndf", True),
                         ("bdf_classic", False)):
        a = solve_adjoint(vdp_rhs, (0.0, 1.0), y0, method=method, args=mu,
                          options=opts)
        b = ndf_adjoint(vdp_rhs, (0.0, 1.0), y0, args=mu, options=opts,
                        ndf=flag)
        assert torch.equal(a, b), method


def test_ndf_adjoint_raises():
    y0 = torch.tensor([[2.0, 0.0]], dtype=torch.float64)
    with pytest.raises(ValueError, match="terminal"):
        ndf_adjoint(vdp_rhs, (0.0, 1.0), y0, args=1.0,
                    events=Event(lambda t, y, a: y[:, 0], terminal=False))
    with pytest.raises(ValueError, match="needs mass"):
        ndf_adjoint(vdp_rhs, (0.0, 1.0), y0, args=1.0, n_alg=1)
    with pytest.raises(ValueError, match="drop jac="):
        ndf_adjoint(vdp_rhs, (0.0, 1.0), y0, args=1.0,
                    options=Options(stage_solver="tridiag"),
                    jac=lambda t, y, a: torch.zeros((1, 2, 2)))
    with pytest.raises(ValueError, match="must be scalars"):
        ndf_adjoint(vdp_rhs, (0.0, torch.ones(1, dtype=torch.float64)), y0,
                    args=1.0, t_eval=np.array([0.5, 1.0]))
