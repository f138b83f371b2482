"""The legacy steppers of the port against the JAX reference, on the CPU in
float64, on the same inputs made from a numpy seed: ``solve/bdf.py``
(``solve_bdf2``, variable-step BDF2), ``solve/rosenbrock.py``
(``solve_ros4``, Kaps-Rentrop GRK4T) and ``solve/fixed.py``
(``odeint_fixed``, rk4 and midpoint over a fixed grid, differentiated by
autograd).

Tolerances: status and every counter equal per lane; y and the t_eval
samples to 1e-10 relative to the array's largest entry. Two findings
(ROADMAP Queue 3) set what is compared where that cannot hold:
- bdf2's ``nlu`` counts a new factorization whenever α/h differs from the
  factored one, which after a deadzone step (h kept) depends on whether
  (t + h) − t rounds back to h. Once the two packages' meshes part at
  rounding level (XLA fuses the compiled loop; the port equals the
  reference run op by op under ``jax.disable_jit``, every counter, the slow
  test below) that is a coin flip per deadzone step: nlu differs by up to
  7 of 328 (2.1%) and 2 of 76 (2.6%) while every other counter is equal,
  so nlu is held within 3% + 2.
- grk4t on Robertson rejects ~40% of its attempts and its controller
  amplifies rounding without bound: the reference's compiled and op-by-op
  runs part by 47 steps, the port against itself under a one-ulp change
  of y0 by 17. There y and the samples are held within ten times the
  port's own one-ulp spread plus 1e-10, naccept within 10%.

``odeint_fixed``: y to 1e-12 and its autograd gradient to ``jax.grad`` of
the reference's to 1e-10, with and without ``step_args`` and ``remat``;
with ``remat`` and an rhs built on ``torch.func`` (``vmap(grad(H))``) the
gradient to 1e-12 relative, through ``.backward()`` and
``torch.autograd.grad``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janus_tpu.solve import solve_ivp as ref_solve_ivp
from janus_tpu.solve.fixed import odeint_fixed as ref_odeint_fixed
from janus_tpu_torch.solve import (FEATURES, Options, solve_adjoint,
                                   solve_ivp)
from janus_tpu_torch.solve.bdf import solve_bdf2
from janus_tpu_torch.solve.fixed import odeint_fixed
from janus_tpu_torch.solve.rosenbrock import solve_ros4
from test_torch_method_cases import (STATS7, close, linear_problems,
                                     linear_rhs, robertson_xp, vdp_rhs_xp)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clear_caches_each_test():
    yield
    jax.clear_caches()


def _linear():
    a, y0, _, tf = linear_problems()
    return linear_rhs, 0.0, tf, y0, a, dict(rtol=1e-8, atol=1e-11)


# the cases of tests/test_stiff_methods.py and the linear stiff sweep of
# tests/test_method_zoo_linear.py: (rhs, t0, tf, y0, args, tolerances)
CASES = {
    "mild-vdp": (vdp_rhs_xp, 0.0, 10.0, np.tile([[2.0, 0.0]], (2, 1)),
                 np.array([5.0, 3.0]), dict(rtol=1e-6, atol=1e-9)),
    "stiff-vdp": (vdp_rhs_xp, 0.0, 2.0, np.tile([[2.0, 0.0]], (2, 1)),
                  np.array([1000.0, 300.0]), dict(rtol=1e-7, atol=1e-10)),
    "robertson": (robertson_xp, 0.0, 100.0,
                  np.array([[1.0, 0.0, 0.0], [0.9, 1e-5, 0.1]]), None,
                  dict(rtol=1e-6, atol=1e-10)),
    "linear-sweep": _linear(),
}


def _solves(method, case, nudge=False, **okw):
    prob, t0, tf, y0, args, tols = case
    t_eval = np.linspace(t0, tf, 6)
    ref = ref_solve_ivp(prob(jnp), (t0, tf), jnp.asarray(y0), method=method,
                        args=None if args is None else jnp.asarray(args),
                        t_eval=jnp.asarray(t_eval), **tols, **okw)
    ys = (y0, np.nextafter(y0, 3.0)) if nudge else (y0,)
    return ref, [solve_ivp(prob(torch), (t0, tf), torch.from_numpy(y),
                           method=method,
                           args=None if args is None
                           else torch.from_numpy(args),
                           t_eval=t_eval, **tols, **okw) for y in ys]


def _counters(got, ref, names):
    for k in names:
        np.testing.assert_array_equal(got.stats[k].numpy(),
                                      np.asarray(ref.stats[k]), err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_bdf2_matches_reference(name):
    ref, (got,) = _solves("bdf2", CASES[name])
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    assert bool((got.status == 1).all())
    _counters(got, ref, [k for k in STATS7 if k != "nlu"])
    r = np.asarray(ref.stats["nlu"])
    assert np.all(np.abs(got.stats["nlu"].numpy() - r) <= 0.03 * r + 2)
    for k in ("t", "y", "ys"):
        close(getattr(got, k), getattr(ref, k), 1e-10, k)


@pytest.mark.parametrize("name", list(CASES))
def test_grk4t_matches_reference(name):
    chaotic = name == "robertson"
    ref, sols = _solves("grk4t", CASES[name], nudge=chaotic)
    got = sols[0]
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    assert bool((got.status == 1).all())
    if not chaotic:
        _counters(got, ref, ("nfev", "njev", "nlu", "nsteps", "naccept",
                             "nreject"))
        for k in ("t", "y", "ys"):
            close(getattr(got, k), getattr(ref, k), 1e-10, k)
        return
    r = np.asarray(ref.stats["naccept"])
    assert np.all(np.abs(got.stats["naccept"].numpy() - r) <= 0.1 * r)
    for k in ("y", "ys"):
        a, rr = getattr(got, k).numpy(), np.asarray(getattr(ref, k))
        axes = tuple(range(1, a.ndim))
        spread = np.nanmax(np.abs(a - getattr(sols[1], k).numpy()), axis=axes)
        assert np.all(np.nanmax(np.abs(a - rr), axis=axes)
                      <= 10.0 * spread + 1e-10 * np.nanmax(np.abs(rr))), k


@pytest.mark.slow
def test_bdf2_equals_the_op_by_op_reference():
    """Run op by op (jax.disable_jit: no fusion), the reference's bdf2 and
    the port's agree on every counter, nlu included, where the compiled
    reference's nlu parts (77/79 against 75/81 here)."""
    y0 = np.tile([[2.0, 0.0]], (2, 1))
    mu = np.array([1000.0, 300.0])
    with jax.disable_jit():
        ref = ref_solve_ivp(vdp_rhs_xp(jnp), (0.0, 0.5), jnp.asarray(y0),
                            method="bdf2", args=jnp.asarray(mu), rtol=1e-7,
                            atol=1e-10)
    got = solve_ivp(vdp_rhs_xp(torch), (0.0, 0.5), torch.from_numpy(y0),
                    method="bdf2", args=torch.from_numpy(mu), rtol=1e-7,
                    atol=1e-10)
    _counters(got, ref, STATS7)
    close(got.y, ref.y, 1e-12, "y")


@pytest.mark.parametrize("solver", [solve_bdf2, solve_ros4])
def test_kernel_lu_equals_plain_lu(solver):
    """kernel_lu=True (the twins of K1/K2 on CPU tensors) and the plain
    pivot-free LU: the same arithmetic, equal to the bit."""
    y0 = torch.tensor([[2.0, 0.0]] * 3, dtype=torch.float64)
    mus = torch.tensor([1000.0, 50.0, 5.0], dtype=torch.float64)
    opts = Options(rtol=1e-6, atol=1e-9, pivoting=False)
    a, b = (solver(vdp_rhs_xp(torch), 0.0, 1.0, y0, mus,
                   opts.replace(kernel_lu=k),
                   t_eval=torch.linspace(0.0, 1.0, 5, dtype=torch.float64))
            for k in (False, True))
    for k in ("t", "y", "ys", "status"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    for k in a.stats:
        assert torch.equal(a.stats[k], b.stats[k]), k
    with pytest.raises(ValueError, match="pivoting=False"):
        solver(vdp_rhs_xp(torch), 0.0, 1.0, y0, mus, Options(kernel_lu=True))


def test_dispatch():
    """The reference's rows of FEATURES (jac and t_eval only), the aliases
    of grk4t, and no reverse mode for either."""
    assert FEATURES["bdf2"] == (True, False, False, True)
    assert FEATURES["grk4t"] == (True, False, False, True)
    y0 = torch.tensor([[2.0, 0.0]], dtype=torch.float64)
    kw = dict(args=5.0, rtol=1e-6, atol=1e-9)
    ros = solve_ros4(vdp_rhs_xp(torch), 0.0, 0.5, y0, 5.0,
                     Options(rtol=1e-6, atol=1e-9))
    for method in ("grk4t", "ros4", "rosenbrock"):
        sol = solve_ivp(vdp_rhs_xp(torch), (0.0, 0.5), y0, method=method,
                        **kw)
        assert torch.equal(sol.y, ros.y), method
    for method in ("bdf2", "grk4t", "ros4"):
        with pytest.raises(ValueError, match="no reverse mode"):
            solve_adjoint(vdp_rhs_xp(torch), (0.0, 0.5), y0, method=method,
                          args=5.0)
        with pytest.raises(ValueError, match="does not support"):
            solve_ivp(vdp_rhs_xp(torch), (0.0, 0.5), y0, method=method,
                      mass=torch.eye(2, dtype=torch.float64), **kw)


# ---- odeint_fixed ----------------------------------------------------------

def _slab_vdp(xp):
    """VdP whose μ takes a per-step slab: f(t, y, (μ, slab_k))."""
    def rhs(t, y, a):
        mu, extra = (a[0], a[1][..., 0]) if isinstance(a, tuple) else (a, 0.0)
        x, v = y[:, 0], y[:, 1]
        return xp.stack([v, (mu + extra) * (1.0 - x * x) * v - x], -1)
    return rhs


@pytest.mark.parametrize("method", ["rk4", "midpoint"])
@pytest.mark.parametrize("slabs", [False, True], ids=["plain", "step_args"])
@pytest.mark.parametrize("remat", [False, True], ids=["keep", "remat"])
def test_odeint_fixed_matches_reference(method, slabs, remat):
    """y(T) and the trajectory to 1e-12; the gradient of a loss of both
    in y0, μ, tf (and the slabs) to jax.grad's to 1e-10."""
    rng = np.random.default_rng(3)
    inputs = {"y0": rng.standard_normal((3, 2)),
              "mu": np.array([0.5, 1.0, 2.0]), "tf": np.float64(1.5)}
    if slabs:
        inputs["slabs"] = rng.uniform(0.0, 1.0, (20, 3, 1))
    names = sorted(inputs)

    def loss(xp, fn, p):
        y, traj = fn(_slab_vdp(xp), 0.0, p["tf"], p["y0"], 20, p["mu"],
                     method=method, step_args=p.get("slabs"), remat=remat,
                     save_trajectory=True)
        return xp.sum(y ** 2) + xp.sum(traj ** 3), (y, traj)

    (_, (y_ref, traj_ref)), g_ref = jax.value_and_grad(
        lambda *a: loss(jnp, ref_odeint_fixed, dict(zip(names, a))),
        argnums=tuple(range(len(names))), has_aux=True)(
            *(jnp.asarray(inputs[n]) for n in names))
    p = {n: torch.tensor(inputs[n], requires_grad=True) for n in names}
    out, (y, traj) = loss(torch, odeint_fixed, p)
    out.backward()
    close(y, y_ref, 1e-12, "y")
    close(traj, traj_ref, 1e-12, "trajectory")
    for n, g in zip(names, g_ref):
        close(p[n].grad, g, 1e-10, f"gradient of {n}")


def _ham_rhs(xp, vmap, grad):
    """q' = ∂H/∂p, p' = −∂H/∂q of H = p²/2 + μq²/2 + q⁴/10, one μ a lane,
    by ``vmap(grad(H))``."""
    def ham(y, mu):
        q, p = y[0], y[1]
        return p * p / 2 + mu * q * q / 2 + q ** 4 / 10

    dh = vmap(grad(ham))

    def rhs(t, y, mu):
        g = dh(y, mu)
        return xp.stack([g[:, 1], -g[:, 0]], -1)
    return rhs


@pytest.mark.parametrize("via", ["backward", "autograd_grad",
                                 "torch_func_grad"])
def test_odeint_fixed_remat_through_torch_func_rhs(via):
    """Reverse mode through odeint_fixed(remat=True) of a ``torch.func``
    rhs (2 lanes, 20 rk4 steps): the gradient in y0 and μ equals jax.grad
    of the reference's to 1e-12 relative (under ``torch.func.grad`` the
    steps keep their stages)."""
    y0 = np.array([[1.0, 0.3], [-0.4, 0.8]])
    mu = np.array([0.7, 2.0])
    w = np.array([[1.0, -2.0], [0.5, 3.0]])

    def loss(xp, rhs, fn, yy, mm):
        return xp.sum(xp.asarray(w) * fn(rhs, 0.0, 1.3, yy, 20, mm,
                                         remat=True) ** 2)

    j_rhs = _ham_rhs(jnp, jax.vmap, jax.grad)
    g_ref = jax.grad(lambda a, b: loss(jnp, j_rhs, ref_odeint_fixed, a, b),
                     argnums=(0, 1))(jnp.asarray(y0), jnp.asarray(mu))
    t_rhs = _ham_rhs(torch, torch.func.vmap, torch.func.grad)
    yy = torch.tensor(y0, requires_grad=True)
    mm = torch.tensor(mu, requires_grad=True)
    if via == "torch_func_grad":
        got = torch.func.grad(lambda a, b: loss(torch, t_rhs, odeint_fixed,
                                                a, b), argnums=(0, 1))(
            yy.detach(), mm.detach())
    elif via == "backward":
        loss(torch, t_rhs, odeint_fixed, yy, mm).backward()
        got = (yy.grad, mm.grad)
    else:
        got = torch.autograd.grad(loss(torch, t_rhs, odeint_fixed, yy, mm),
                                  (yy, mm))
    for name, g, want in zip(("y0", "mu"), got, g_ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=1e-12,
                                   atol=0, err_msg=name)


def test_odeint_fixed_shapes_and_device():
    """A [D] y0 is one lane; a numpy y0 goes to the asked device."""
    y = odeint_fixed(lambda t, y, a: -y, 0.0, 1.0, np.array([1.0, 2.0]), 10,
                     device="cpu")
    assert tuple(y.shape) == (1, 2)
    torch.testing.assert_close(y, torch.tensor([[1.0, 2.0]],
                                               dtype=torch.float64)
                               * np.exp(-1.0), rtol=1e-6, atol=0)
