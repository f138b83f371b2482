"""Implicit differentiation through the root solvers (``implicit_root``) and
the matrix-free Newton-CG (``newton_cg``, ``cg_steihaug``) of the port
against the JAX reference, on the CPU: the twins of
``tests/test_implicit.py`` and ``tests/test_optimize.py``.

``implicit_root`` is a torch.autograd.Function: the forward runs a root
engine under no_grad, the backward solves (∂F/∂x)ᵀw = x̄ at the root (the
transposed Jacobian's LU, or GMRES on vjp pulls) and pulls −w through F in
the parameters. Oracles as the reference's: analytic gradients, central
differences of re-solves, 'lu' against 'gmres', a Ψtc engine against the
default Newton, NaN on a lane that did not converge, a zero cotangent for
x0; plus the reference's own gradients: 1e-10 relative (converged roots,
one linear solve; measured ~1e-15). ``newton_cg``: the reference's iterates
and counters (x within 1e-10, iters, nhvp and nfev equal).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janus_tpu.control import cg_steihaug as ref_cg
from janus_tpu.control import implicit_root as ref_implicit
from janus_tpu.control import newton_cg as ref_newton_cg
from janus_tpu_torch.control import (cg_steihaug, implicit_root, newton_cg,
                                     psitc)

torch.set_num_threads(1)

F64 = torch.float64
GRAD = 1e-10


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def _grad(loss, *args):
    leaves = [a.clone().requires_grad_(True) for a in args]
    loss(*leaves).backward()
    return [leaf.grad for leaf in leaves]


def test_cube_root_analytic_gradient():
    """x³ = θ per lane: dx*/dθ = 1/(3 θ^{2/3})."""
    theta = np.array([1.0, 8.0, 27.0])

    def loss(th):
        x = implicit_root(lambda x, a: x ** 3 - a[:, None],
                          torch.ones((3, 1), dtype=F64), th, tol=1e-12)
        return x.sum()

    g, = _grad(loss, _t(theta))
    close(g, 1.0 / (3.0 * theta ** (2.0 / 3)), 1e-8)
    want = jax.grad(lambda th: jnp.sum(ref_implicit(
        lambda x, a: x ** 3 - a[:, None], jnp.ones((3, 1)), th,
        tol=1e-12)))(jnp.asarray(theta))
    close(g, want, GRAD)


def test_multivariate_tree_grads_match_reference_and_fd():
    """2-D nonlinear system with a dict of parameters and an int leaf that
    rides along undifferentiated; gradients against central differences
    of re-solves and against the reference."""
    m = 2
    p0 = {"a": np.array([1.3, 0.7]), "b": np.array([0.4, 0.9])}
    wts = np.array([[1.0, 2.0]])

    def resid(lib):
        def r(x, p):
            u, v = x[:, 0], x[:, 1]
            return lib.stack([u + p["a"] * lib.tanh(v) - 1.0,
                              v ** p["n"] + p["b"] * u - 2.0], -1)
        return r

    def loss(a, b):
        x = implicit_root(resid(torch), torch.ones((m, 2), dtype=F64),
                          {"a": a, "b": b, "n": 2}, tol=1e-12)
        return (x ** 2 * _t(wts)).sum()

    ga, gb = _grad(loss, _t(p0["a"]), _t(p0["b"]))
    want = jax.grad(lambda p: jnp.sum(ref_implicit(
        resid(jnp), jnp.ones((m, 2)), {**p, "n": np.int32(2)},
        tol=1e-12) ** 2 * wts))({k: jnp.asarray(v) for k, v in p0.items()})
    close(ga, want["a"], GRAD)
    close(gb, want["b"], GRAD)
    eps = 1e-6
    for name, g in (("a", ga), ("b", gb)):
        for i in range(m):
            e = np.zeros(m)
            e[i] = eps
            args = {k: _t(v) for k, v in p0.items()}
            up = dict(args, **{name: _t(p0[name] + e)})
            dn = dict(args, **{name: _t(p0[name] - e)})
            fd = (float(loss(up["a"], up["b"])) - float(loss(dn["a"],
                                                              dn["b"]))) \
                / (2 * eps)
            close(float(g[i]), fd, 2e-5, 1e-10)


def _diffusion(lib):
    def resid(x, th):
        lap = -2.0 * x + lib.roll(x, 1, -1) + lib.roll(x, -1, -1)
        return 0.5 * lap - th[None, :] * x ** 3 + 1.0
    return resid


@pytest.mark.parametrize("linear", ["lu", "gmres"])
def test_diffusion_gradient(linear):
    """A 16-D diffusion-like system: the dense-LU backward against the
    reference's, and the matrix-free one (Jᵀ·v by vjp pulls) against the
    dense LU's, as the reference's test holds its two."""
    n = 16
    theta = 1.0 + 0.1 * np.random.default_rng(3).uniform(size=n)

    def loss(th, lin):
        x = implicit_root(_diffusion(torch), torch.full((1, n), 0.5,
                                                        dtype=F64),
                          th, tol=1e-12, linear=lin, gmres_iters=n + 4)
        return torch.sin(x).sum()

    g, = _grad(lambda th: loss(th, linear), _t(theta))
    if linear == "lu":
        want = jax.grad(lambda th: jnp.sum(jnp.sin(ref_implicit(
            _diffusion(jnp), jnp.full((1, n), 0.5), th,
            tol=1e-12))))(jnp.asarray(theta))
        close(g, want, GRAD, 1e-14)
    else:
        g_lu, = _grad(lambda th: loss(th, "lu"), _t(theta))
        close(g, g_lu, 1e-7, 1e-12)


def test_custom_solver_engine_psitc():
    """Swapping the forward engine (Ψtc) leaves the gradient unchanged."""
    def loss(th, solver):
        x = implicit_root(lambda x, a: x ** 3 - a[:, None],
                          torch.ones((1, 1), dtype=F64), th, solver=solver)
        return x.sum()

    g_newton, = _grad(lambda th: loss(th, None), _t([2.0]))
    g_psitc, = _grad(lambda th: loss(th, lambda g, x0: psitc(g, x0,
                                                             tol=1e-12)),
                     _t([2.0]))
    close(g_psitc, g_newton, 1e-7)
    with pytest.raises(ValueError, match="extra keywords"):
        implicit_root(lambda x, a: x, torch.ones((1, 1), dtype=F64), None,
                      solver=lambda g, x0: x0, tol=1e-3)


def test_nonconverged_lane_poisons_gradient():
    def loss(th):
        x = implicit_root(lambda x, a: x ** 2 + a[:, None] + 1.0,
                          torch.ones((1, 1), dtype=F64), th, tol=1e-12,
                          max_iter=5)                 # no real root
        return x.sum()

    g, = _grad(loss, _t([1.0]))
    assert not torch.isfinite(g).all()


def test_x0_gets_zero_cotangent():
    def loss(x0):
        x = implicit_root(lambda x, a: x ** 3 - a[:, None], x0, _t([8.0]),
                          tol=1e-12)
        return x.sum()

    g, = _grad(loss, torch.full((1, 1), 1.5, dtype=F64))
    assert torch.equal(g, torch.zeros_like(g))


def test_bilevel_ode_steady_state():
    """Fit the steady state of q' = v, v' = −k q − 0.4 v + 1: q* = 1/k, so
    dL/dk = 2(q* − 0.75)·(−1/k²)."""
    k = np.array([1.0, 2.0, 3.0])

    def loss(kk):
        x = implicit_root(lambda x, kk: torch.stack(
            [x[:, 1], -kk * x[:, 0] - 0.4 * x[:, 1] + 1.0], -1),
            torch.zeros((3, 2), dtype=F64), kk, tol=1e-13)
        return ((x[:, 0] - 0.75) ** 2).sum()

    g, = _grad(loss, _t(k))
    qs = 1.0 / k
    close(g, 2 * (qs - 0.75) * (-qs ** 2), 1e-6)


@pytest.mark.slow
@pytest.mark.parametrize("linear", ["gmres", "lu"])
def test_bilevel_through_ode_shooting_vs_analytic(linear):
    """Reverse mode through a shooting root whose residual holds a whole
    adaptive solve: radau_adjoint in the residual, FD Jacobians in the
    forward Newton, the backward's pulls through the continuous adjoint.
    Oracle: the harmonic BVP's closed form."""
    from janus_tpu_torch.solve import Options
    from janus_tpu_torch.solve.adjoint import radau_adjoint

    q0, q_end, t_end = 1.0, 0.3, 1.0
    opts = Options(rtol=1e-10, atol=1e-13, adjoint_steps=256)

    def rhs(t, y, k):
        return torch.stack([y[:, 1], -k * y[:, 0]], dim=-1)

    def resid(v0, k):
        y0 = torch.cat([torch.full((v0.shape[0], 1), q0, dtype=F64), v0],
                       dim=-1)
        return radau_adjoint(rhs, (0.0, t_end), y0, args=k,
                             options=opts)[:, :1] - q_end

    def loss(k):
        v0 = implicit_root(resid, torch.zeros((2, 1), dtype=F64), k,
                           linear=linear, gmres_iters=4, jac_mode="fd",
                           tol=1e-10)
        return (v0[:, 0] ** 2).sum()

    def v0_star(k):
        w = np.sqrt(k)
        return (q_end - q0 * np.cos(w * t_end)) * w / np.sin(w * t_end)

    k = np.array([1.0, 2.5])
    eps = 1e-7
    expected = 2.0 * v0_star(k) * (v0_star(k + eps) - v0_star(k - eps)) \
        / (2 * eps)
    g, = _grad(loss, _t(k))
    close(g, expected, 1e-6)


# ---- newton_cg, cg_steihaug ------------------------------------------------

def test_quadratic_one_step():
    """Exact CG on a pd quadratic converges in one Newton step."""
    a = np.array([[3.0, 0.5], [0.5, 1.0]])
    b = np.array([1.0, -2.0])

    def vg(x):
        x = x.detach().requires_grad_(True)
        v = 0.5 * x @ _t(a) @ x - _t(b) @ x
        g, = torch.autograd.grad(v, x)
        return v.detach(), g

    res = newton_cg(vg, lambda x, v: _t(a) @ v, torch.zeros(2, dtype=F64),
                    max_iter=3, cg_iters=2, tol=1e-12)
    want = ref_newton_cg(jax.value_and_grad(
        lambda x: 0.5 * x @ a @ x - b @ x), lambda x, v: a @ v,
        jnp.zeros(2), max_iter=3, cg_iters=2, tol=1e-12)
    assert res.converged and res.iters <= 2
    close(res.x, np.linalg.solve(a, b), 1e-10)
    close(res.x, want.x, GRAD)
    assert (res.iters, res.nhvp, res.nfev) == (want.iters, want.nhvp,
                                               want.nfev)


def test_rosenbrock_tree_matches_reference():
    """Nonconvex start (negative curvature along the valley wall) over a
    dict of parameters; exact CG (tight cg_rtol) is true Newton."""
    def f(p):
        return (1 - p["x"]) ** 2 + 100.0 * (p["y"] - p["x"] ** 2) ** 2

    def vg(p):
        return f(p), torch.func.grad(f)(p)

    def hvp(p, v):
        return torch.func.jvp(torch.func.grad(f), (p,), (v,))[1]

    x0 = {"x": torch.tensor(-1.2, dtype=F64), "y": torch.tensor(1.0,
                                                                dtype=F64)}
    res = newton_cg(vg, hvp, x0, max_iter=40, cg_iters=10, cg_rtol=1e-12,
                    tol=1e-10)
    want = ref_newton_cg(
        jax.value_and_grad(f),
        lambda p, v: jax.jvp(jax.grad(f), (p,), (v,))[1],
        {"x": jnp.asarray(-1.2), "y": jnp.asarray(1.0)}, max_iter=40,
        cg_iters=10, cg_rtol=1e-12, tol=1e-10)
    assert res.converged
    close(float(res.x["x"]), 1.0, 1e-6)
    close(float(res.x["y"]), 1.0, 1e-6)
    for k in ("x", "y"):
        close(float(res.x[k]), float(want.x[k]), GRAD)
    assert (res.iters, res.nhvp, res.nfev) == (want.iters, want.nhvp,
                                               want.nfev)


def test_cg_steihaug_negative_curvature_and_cap():
    """Indefinite H: first-direction negative curvature falls back to the
    (scaled) gradient direction; step_cap bounds the step norm."""
    h = np.diag([-2.0, 1.0])
    g = np.array([1.0, 0.0])
    d, n = cg_steihaug(lambda v: _t(h) @ v, _t(g), max_iter=5, step_cap=0.3)
    d_r, n_r = ref_cg(lambda v: h @ v, jnp.asarray(g), max_iter=5,
                      step_cap=0.3)
    assert n == n_r == 1
    close(float(torch.linalg.norm(d)), 0.3, 1e-12)
    close(d, d_r, 1e-15)
    assert float(d @ _t(g)) < 0               # still a descent direction

    h2 = np.eye(2) * 1e-3                     # huge Newton step, capped
    g2 = np.array([1.0, 1.0])
    d2, n2 = cg_steihaug(lambda v: _t(h2) @ v, _t(g2), max_iter=5,
                         step_cap=0.5)
    d2_r, n2_r = ref_cg(lambda v: h2 @ v, jnp.asarray(g2), max_iter=5,
                        step_cap=0.5)
    assert float(torch.linalg.norm(d2)) <= 0.5 + 1e-12
    assert n2 == n2_r
    close(d2, d2_r, 1e-15)


def test_zero_gradient_immediate():
    def vg(x):
        return (x ** 2).sum(), 2.0 * x

    res = newton_cg(vg, lambda x, v: 2.0 * v, torch.zeros(3, dtype=F64),
                    tol=1e-12)
    assert res.converged and res.nhvp == 0 and res.iters == 1
