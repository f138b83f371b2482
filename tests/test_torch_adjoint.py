"""The port's continuous adjoint ``radau_adjoint`` on the CPU in float64.

(a) Against the JAX reference, in the same process, on the same inputs from
a numpy seed (M ≤ 4 lanes). Each case is one loss, written once for both
packages; ``jax.grad`` and ``loss.backward()`` give the gradients with
respect to y0, the parameters and, where the case has them, t0 and tf.
Tolerances: the primal to 1e-10 and every gradient to 1e-7, both relative to
the array's largest entry (the backward iteration stops on a flag over the
whole batch, so both packages make the same trips). The reference's adjoint
compiles slowly on the CPU, so the fast tier keeps eight cases and the others
are marked ``slow``; JAX's caches are cleared after every test.

(b) The mode restrictions and what is not ported yet raise (the adjoint's
terminal events are held against the reference in ``test_torch_events.py``,
the rodas adjoint in ``test_torch_adjoint_rodas.py``). The port is held
against itself (central differences, IND, the Function's plumbing) in
``test_torch_adjoint_fd.py``, which takes its cases from here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janus_tpu.solve import Options as RefOptions
from janus_tpu.solve.adjoint import radau_adjoint as ref_radau_adjoint
from janus_tpu_torch.interop import options_from_jax
from janus_tpu_torch.models.problems import vdp_jac, vdp_rhs
from janus_tpu_torch.solve import (Event, Options, radau_adjoint,
                                   solve_adjoint)
from test_torch_mol_cases import line_case

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clear_caches_each_test():
    yield
    jax.clear_caches()


# ---- problems, written once for both packages (xp: jnp or torch) ------------

def _vdp(xp):
    def rhs(t, y, mu):
        x, v = y[:, 0], y[:, 1]
        return xp.stack([v, mu * (1.0 - x * x) * v - x], -1)
    return rhs


def _rob_dae(xp):
    """Robertson-style semi-explicit index-1 DAE, mass = diag(2, 1, 0), as
    the reference's tests define it."""
    def rhs(t, y, k):
        k1, k2, k3 = k["k1"], k["k2"], k["k3"]
        x1, x2, z = y[:, 0], y[:, 1], y[:, 2]
        return xp.stack([2.0 * (-k1 * x1 + k3 * x2 * z),
                         k1 * x1 - k2 * x2 ** 2 - k3 * x2 * z,
                         x1 + x2 + z - 1.0], -1)
    return rhs


def _vdp_inputs(m=4, mu_max=50.0):
    rng = np.random.default_rng(21)
    y0 = np.tile([[2.0, 0.0]], (m, 1)) + 0.1 * rng.standard_normal((m, 2))
    return {"y0": y0, "mu": np.geomspace(2.0, mu_max, m)}


W2 = np.array([1.0, 0.7])


def _case_terminal(xp, adj, opts, p):
    """Σ w·y(T)² with t0 and tf differentiated too."""
    y = adj(_vdp(xp), (p["t0"], p["tf"]), p["y0"], args=p["mu"], options=opts)
    return xp.sum(xp.asarray(W2) * y ** 2), y


def _case_t_eval_cost(xp, adj, opts, p):
    """A trajectory fit over 3 sample times plus an integral cost."""
    ys, q = adj(_vdp(xp), (0.0, 1.2), p["y0"], args=p["mu"], options=opts,
                t_eval=xp.asarray(np.array([0.4, 0.8, 1.2])),
                cost=lambda t, y, mu: y[:, 0] ** 2 + 0.1 * mu * y[:, 1] ** 2)
    return xp.sum(ys ** 2) + 0.5 * xp.sum(q), ys


def _case_mass(xp, adj, opts, p):
    mass = xp.asarray(np.array([[2.0, 0.3], [0.1, 1.5]]))
    y = adj(_vdp(xp), (0.0, 1.0), p["y0"], args=p["mu"], options=opts,
            mass=mass)
    return xp.sum(y ** 2), y


def _case_dae(xp, adj, opts, p):
    """n_alg=1: z0 rebuilt from the differential slots, the loss touches
    the algebraic terminal value too."""
    xd = p["x0"]
    y0 = xp.concatenate([xd, (1.0 - xd[:, 0] - xd[:, 1])[:, None]], -1)
    k = {"k1": p["k1"], "k2": p["k2"], "k3": p["k3"]}
    y = adj(_rob_dae(xp), (0.0, 2.0), y0, args=k, options=opts,
            mass=xp.asarray(np.diag([2.0, 1.0, 0.0])), n_alg=1)
    return xp.sum(xp.asarray(np.array([0.6, 1.1, 1.7])) * y ** 2), y


def _case_checkpoints(xp, adj, opts, p):
    y, q = adj(_vdp(xp), (0.0, 1.2), p["y0"], args=p["mu"], options=opts,
               checkpoints=3, cost=lambda t, y, mu: y[:, 0] ** 2)
    return xp.sum(y ** 2) + xp.sum(q), y


def _case_reverse(xp, adj, opts, p):
    """tf < t0, with mild μ: backward in time this flow expands."""
    y = adj(_vdp(xp), (1.0, 0.5), p["y0"], args=p["mu"], options=opts)
    return xp.sum(y ** 2), y


def _case_line(xp, adj, opts, p):
    """bench.py's MOL-adjoint loss on the D=16 Fisher-KPP line; ν is a
    Python number (no leaf), the rates [M, 1] are broadcast by f."""
    ref_f, f, _, _ = line_case(d=16, m=3)
    y = adj(ref_f if xp is jnp else f, (0.0, 0.4), p["y0"],
            args=(0.01, p["rates"]), options=opts)
    xg = np.linspace(0, 1, 18)[1:-1]
    return xp.sum(xp.asarray(xg) * y ** 2), y


def _line_inputs():
    _, _, y0, (_, rates) = line_case(d=16, m=3)
    return {"y0": y0, "rates": rates}


def _dae_inputs():
    return {"x0": np.array([[1.0, 0.2], [0.8, 0.4]]),
            "k1": np.array([0.5, 0.7]), "k2": np.array([10.0, 6.0]),
            "k3": np.array([2.0, 3.0])}


_TIGHT = dict(rtol=1e-6, atol=1e-9, adjoint_steps=128)
_MOL = dict(rtol=1e-4, atol=1e-7, pivoting=False, adjoint_steps=48)

# name -> (case, inputs, options): the options are the reference's, read
# across by interop.options_from_jax
PARITY = {
    "terminal-t0-tf": (_case_terminal,
                       {**_vdp_inputs(), "t0": np.float64(0.1),
                        "tf": np.float64(1.1)}, _TIGHT),
    "t_eval-cost": (_case_t_eval_cost, _vdp_inputs(3), _TIGHT),
    "mass": (_case_mass, _vdp_inputs(3), _TIGHT),
    "dae-n_alg": (_case_dae, _dae_inputs(),
                  dict(rtol=1e-7, atol=1e-10, adjoint_steps=128)),
    "line-tridiag": (_case_line, _line_inputs(),
                     dict(stage_solver="tridiag", **_MOL)),
    "line-gmres8": (_case_line, _line_inputs(),
                    dict(stage_solver="gmres", gmres_iters=8, **_MOL)),
    "checkpoints-cost": (_case_checkpoints, _vdp_inputs(3), _TIGHT),
    "reverse-time": (_case_reverse, _vdp_inputs(3, 5.0), _TIGHT),
}
PARITY_SLOW = {
    "mass-gmres": (_case_mass, _vdp_inputs(3),
                   dict(stage_solver="gmres", gmres_iters=4, **_TIGHT)),
    "line-lines": (_case_line, _line_inputs(),
                   dict(stage_solver="gmres", gmres_iters=6, precond="lines",
                        precond_block=8, **_MOL)),
    "line-block": (_case_line, _line_inputs(),
                   dict(stage_solver="gmres", gmres_iters=12, precond="block",
                        precond_block=4, **_MOL)),
    "dae-n_alg-gmres": (_case_dae, _dae_inputs(),
                        dict(rtol=1e-7, atol=1e-10, adjoint_steps=128,
                             stage_solver="gmres", gmres_iters=6)),
}


def _parity(case, inputs, okw):
    ref_opts = RefOptions(**okw)
    names = sorted(inputs)
    (_, y_ref), g_ref = jax.value_and_grad(
        lambda *a: case(jnp, ref_radau_adjoint, ref_opts,
                        dict(zip(names, a))),
        argnums=tuple(range(len(names))), has_aux=True)(
            *(jnp.asarray(inputs[n]) for n in names))
    p = {n: torch.tensor(inputs[n], dtype=torch.float64, requires_grad=True)
         for n in names}
    loss, y = case(torch, radau_adjoint, options_from_jax(ref_opts), p)
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


# ---- (b) what raises --------------------------------------------------------

def test_mode_restrictions_raise():
    y0 = torch.tensor([[2.0, 0.0]], dtype=torch.float64)
    kw = dict(args=5.0, options=Options(rtol=1e-5, atol=1e-8))
    with pytest.raises(ValueError, match="needs the singular mass"):
        radau_adjoint(vdp_rhs, (0.0, 1.0), y0, n_alg=1, **kw)
    with pytest.raises(ValueError, match="terminal-mode only"):
        radau_adjoint(vdp_rhs, (0.0, 1.0), y0, checkpoints=2,
                      t_eval=np.array([0.5, 1.0]), **kw)
    per_lane = torch.tensor([1.0], dtype=torch.float64)
    with pytest.raises(ValueError, match="checkpoints=.*must be scalars"):
        radau_adjoint(vdp_rhs, (0.0, per_lane), y0, checkpoints=2, **kw)
    with pytest.raises(ValueError, match="t_eval=.*must be scalars"):
        radau_adjoint(vdp_rhs, (0.0, per_lane), y0,
                      t_eval=np.array([0.5, 1.0]), **kw)
    with pytest.raises(ValueError, match="non-empty 1-D grid"):
        radau_adjoint(vdp_rhs, (0.0, 1.0), y0, t_eval=np.zeros((2, 2)), **kw)
    with pytest.raises(ValueError, match="matrix-free; drop jac="):
        radau_adjoint(vdp_rhs, (0.0, 1.0), y0, args=5.0, jac=vdp_jac,
                      options=Options(stage_solver="gmres"))


@pytest.mark.parametrize("what", ["events", "variable-stages", "radaup",
                                  "rodas", "dopri5"])
def test_unported_adjoints_raise(what):
    """Every adjoint is ported now. Of what is ported the restrictions the
    reference keeps raise ValueError (non-terminal events on radau and
    dopri5, the kernels K1/K2 on rodas); the variable-order ladder
    (min_stages != max_stages, or method='radaup') gives a finite
    gradient; a method with no reverse mode (grk4t) raises ValueError."""
    y0 = torch.tensor([[2.0, 0.0]], dtype=torch.float64)
    if what == "events":       # non-terminal events have no gradient
        with pytest.raises(ValueError, match="terminal"):
            radau_adjoint(vdp_rhs, (0.0, 1.0), y0, args=5.0,
                          events=Event(lambda t, y, a: y[:, 0],
                                       terminal=False))
    elif what == "rodas":      # the kernels K1/K2 have no backward
        with pytest.raises(ValueError, match="no backward"):
            solve_adjoint(vdp_rhs, (0.0, 1.0), y0, method=what, args=5.0,
                          options=Options(kernel_lu=True, pivoting=False))
    elif what == "dopri5":     # non-terminal events have no gradient
        with pytest.raises(ValueError, match="terminal"):
            solve_adjoint(vdp_rhs, (0.0, 1.0), y0, method=what, args=5.0,
                          events=Event(lambda t, y, a: y[:, 0],
                                       terminal=False))
    else:                      # the ladder: a finite gradient
        mu = torch.tensor(5.0, dtype=torch.float64, requires_grad=True)
        y0g = y0.clone().requires_grad_()
        if what == "variable-stages":
            y = radau_adjoint(vdp_rhs, (0.0, 1.0), y0g, args=mu,
                              options=Options(min_stages=3, max_stages=7))
        else:
            y = solve_adjoint(vdp_rhs, (0.0, 1.0), y0g, method=what, args=mu)
        grads = torch.autograd.grad(torch.sum(y ** 2), (y0g, mu))
        assert all(bool(torch.isfinite(g).all()) for g in grads)
    with pytest.raises(ValueError, match="no reverse mode"):
        solve_adjoint(vdp_rhs, (0.0, 1.0), y0, method="grk4t", args=5.0)
