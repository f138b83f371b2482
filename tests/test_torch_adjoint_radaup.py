"""The continuous adjoint over the variable-order ladder
(``radau_adjoint`` / ``solve_adjoint(method='radaup')`` with min_stages=1,
max_stages=7) against ``jax.grad`` through the JAX reference's, on the CPU
in float64, on the same inputs made from a numpy seed.

Each case is one loss, written once for both packages (the cases of
``test_torch_adjoint.py`` where they fit); ``jax.grad`` and
``loss.backward()`` give the gradients with respect to y0, the parameters
and, where the case has them, t0 and tf. Tolerances: the primal to 1e-10,
every gradient to 1e-7, both relative to the array's largest entry. Lanes
of μ over two decades put the ladder at different orders. Then the
port alone: the recorded mesh is the forward solve's (padded to s=7), a
ladder of one order gives the fixed-stage gradient, and the forward
through the twins of K1/K2 (``kernel_lu``) gives the plain forward's
gradient to the bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janus_tpu.solve import Options as RefOptions
from janus_tpu.solve import events as ref_events
from janus_tpu.solve import solve_adjoint as ref_solve_adjoint
from janus_tpu.solve.adjoint import radau_adjoint as ref_radau_adjoint
from janus_tpu_torch.interop import options_from_jax
from janus_tpu_torch.solve import (Event, Options, radau_adjoint,
                                   solve_adjoint)
from janus_tpu_torch.solve.radaup import solve_radau_vo
from test_torch_adjoint import (_case_mass, _case_t_eval_cost,
                                _case_terminal, _vdp)
from test_torch_method_cases import close

torch.set_num_threads(1)

LADDER = dict(min_stages=1, max_stages=7)
OPTS = dict(rtol=1e-6, atol=1e-9, adjoint_steps=128, **LADDER)


@pytest.fixture(autouse=True)
def _clear_caches_each_test():
    yield
    jax.clear_caches()


def _inputs(m=3):
    rng = np.random.default_rng(31)
    y0 = np.tile([[2.0, 0.0]], (m, 1)) + 0.1 * rng.standard_normal((m, 2))
    return {"y0": y0, "mu": np.geomspace(3.0, 300.0, m)}


def _case_event(xp, adj, opts, p):
    """Σ y*² + 2 Σ t* with a terminal event x = 0 (falling), on two lanes
    that cross before T and one that does not."""
    cls = ref_events.Event if xp is jnp else Event
    ev = cls(lambda t, y, a: y[..., 0] - xp.asarray(np.array([0.0, 0.5,
                                                             -50.0])),
             terminal=True, direction=-1.0)
    y, t = adj(_vdp(xp), (0.0, 3.0), p["y0"], args=p["mu"], options=opts,
               events=ev)
    return xp.sum(y ** 2) + 2.0 * xp.sum(t), y


def _case_solve_adjoint(xp, adj, opts, p):
    """solve_adjoint(method='radaup') with the options' default stages:
    the dispatcher sets the ladder 1..7 in both packages."""
    sa = ref_solve_adjoint if xp is jnp else solve_adjoint
    y = sa(_vdp(xp), (0.0, 1.0), p["y0"], method="radaup", args=p["mu"],
           options=opts)
    return xp.sum(y ** 2), y


# name -> (case, inputs, options keywords)
PARITY = {
    "terminal-t0-tf": (_case_terminal, {**_inputs(), "t0": np.float64(0.1),
                                        "tf": np.float64(1.1)}, OPTS),
    "t_eval-cost": (_case_t_eval_cost, _inputs(), OPTS),
    "terminal-event": (_case_event, _inputs(), OPTS),
    "mass": (_case_mass, _inputs(), OPTS),
    "solve_adjoint": (_case_solve_adjoint, _inputs(),
                      dict(rtol=1e-6, atol=1e-9, adjoint_steps=128)),
}


@pytest.mark.parametrize("name", list(PARITY))
def test_gradients_match_reference(name):
    case, inputs, okw = PARITY[name]
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
    close(y, y_ref, 1e-10, "primal")
    for n, g in zip(names, g_ref):
        assert np.all(np.isfinite(np.asarray(g))), n
        close(p[n].grad, g, 1e-7, f"gradient of {n}")


def _gradient(opts, kernel=False):
    p = _inputs()
    y0 = torch.tensor(p["y0"], requires_grad=True)
    mu = torch.tensor(p["mu"], requires_grad=True)
    o = Options(**opts)
    if kernel:
        o = o.replace(kernel_lu=True, pivoting=False)
    y = radau_adjoint(_vdp(torch), (0.0, 1.0), y0, args=mu, options=o)
    torch.sum(y ** 2).backward()
    return y.detach(), y0.grad, mu.grad


def test_recorded_mesh_is_the_forward_solve():
    """The Function's forward records the ladder's own mesh: its rings
    equal solve_radau_vo's with _mesh_size to the bit, padded to s=7, and
    its y(T) is the plain solve's."""
    p = _inputs()
    y0, mu = torch.tensor(p["y0"]), torch.tensor(p["mu"])
    opts = Options(**OPTS)
    sol = solve_radau_vo(_vdp(torch), 0.0, 1.0, y0, mu, opts,
                         _mesh_size=opts.adjoint_steps)
    plain = solve_radau_vo(_vdp(torch), 0.0, 1.0, y0, mu, opts)
    assert torch.equal(sol.y, plain.y)
    assert tuple(sol.mesh["q"].shape) == (3, 128, 7, 2)
    y = radau_adjoint(_vdp(torch), (0.0, 1.0), y0.clone().requires_grad_(),
                      args=mu, options=opts)
    assert torch.equal(y.detach(), plain.y)
    rings = y.grad_fn.saved_tensors[-5:]
    assert torch.equal(rings[0], sol.stats["naccept"])
    for ring, key in zip(rings[1:], ("t", "h", "y", "q")):
        assert torch.equal(ring, sol.mesh[key]), key
    # the recorded steps span the ladder: some polynomials reach degree 7,
    # others stop at degree 3 or below (zero high coefficients)
    live = torch.arange(128)[None, :] < sol.stats["naccept"][:, None]
    q = sol.mesh["q"]
    assert bool(((q[:, :, 5:] != 0).any(dim=-1).any(dim=-1) & live).any())
    assert bool(((q[:, :, 3:] == 0).all(dim=-1).all(dim=-1) & live).any())


def test_single_order_ladder_is_fixed_stage():
    """min_stages=3, max_stages=4 is the ladder (3,): the fixed-stage
    adjoint's gradient to the bit."""
    a = _gradient(dict(OPTS, min_stages=3, max_stages=4))
    b = _gradient(dict(OPTS, min_stages=3, max_stages=3))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_kernel_lu_forward_equals_plain():
    """The forward through the twins of K1/K2, the backward on the plain
    LU: the plain pivot-free forward's gradient to the bit."""
    a = _gradient(OPTS, kernel=True)
    b = _gradient(dict(OPTS, pivoting=False))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
