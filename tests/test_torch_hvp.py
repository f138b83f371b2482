"""The port's ``radau_hvp`` (forward-over-adjoint Hessian-vector products)
on the CPU in float64.

Against the JAX package in the same process, on the same inputs: h_y0,
h_args and gdotv within 1e-6 relative to each array's largest entry
(``radau_adjoint``'s gradients are held to 1e-7; the augmented solve's step
sizes amplify rounding the same way, ROADMAP Queue 3). The reference's
oracles kept: the analytic Hessian of a linear flow, central differences of
the port's own ``radau_adjoint`` gradient, and gdotv = ⟨∇L, v⟩. The
reference's compiles of the augmented adjoint take ~10–60 s each, so the
heavy cases are marked ``slow``.

First check of this file: ``radau_adjoint``'s backward pulls a
``torch.func.vjp`` through the ``torch.func.jvp`` inside the augmented
right-hand side (vjp over jvp), in ``test_vjp_over_jvp_composes``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jvp, vjp

from janus_tpu.models.problems import vdp_rhs as ref_vdp
from janus_tpu.solve import Options as RefOptions
from janus_tpu.solve.hvp import radau_hvp as ref_radau_hvp
from janus_tpu_torch.interop import options_from_jax
from janus_tpu_torch.models.problems import vdp_rhs
from janus_tpu_torch.solve import Options, radau_adjoint, radau_hvp

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clear_caches_each_test():
    yield
    jax.clear_caches()


def _close(got, ref, what, tol=1e-6):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0,
                               atol=tol * float(np.abs(ref).max()),
                               err_msg=what)


def _linear(xp):
    def f(t, y, aa):
        return aa[:, None] * y
    return f


def _osc(xp):
    def f(t, y, a):
        return xp.stack([y[:, 1], -a * y[:, 0] - 0.2 * y[:, 1]], -1)
    return f


def _both(f_ref, f, tspan, y0, args, okw, **kw):
    """radau_hvp through both packages on the same inputs; the port's
    ((h_y0, h_args), gdotv) after holding it to the reference's."""
    conv = {k: v for k, v in kw.items() if k not in ("loss", "cost")}
    (h_y0r, h_ar), gr = ref_radau_hvp(
        f_ref, tspan, jnp.asarray(y0), jax.tree_util.tree_map(
            jnp.asarray, args), loss=kw["loss"][0],
        cost=kw.get("cost", (None, None))[0], options=RefOptions(**okw),
        **{k: jax.tree_util.tree_map(jnp.asarray, v)
           for k, v in conv.items()})
    targs = {k: torch.as_tensor(v) for k, v in args.items()} \
        if isinstance(args, dict) else torch.as_tensor(args)
    (h_y0, h_a), g = radau_hvp(
        f, tspan, torch.from_numpy(np.asarray(y0)), targs,
        loss=kw["loss"][1], cost=kw.get("cost", (None, None))[1],
        options=options_from_jax(RefOptions(**okw)),
        **{k: {kk: torch.as_tensor(vv) for kk, vv in v.items()}
           if isinstance(v, dict) else torch.as_tensor(v)
           for k, v in conv.items()})
    _close(h_y0, h_y0r, "h_y0")
    _close(g, gr, "gdotv")
    if isinstance(args, dict):
        for k, v in h_ar.items():
            if np.asarray(v).dtype.kind == "f":
                _close(h_a[k], v, f"h_args[{k}]")
            else:
                assert h_a[k] is None, k
    else:
        _close(h_a, h_ar, "h_args")
    return (h_y0, h_a), g


def test_vjp_over_jvp_composes():
    """The augmented right-hand side [f, ∂f·(δ, v_θ)] pulled by
    torch.func.vjp equals its closed form on the linear flow."""
    a = torch.tensor([0.4, -0.7], dtype=torch.float64)
    va = torch.tensor([0.7, 0.2], dtype=torch.float64)
    yy = torch.tensor([[1.3, 0.3], [0.8, -1.1]], dtype=torch.float64)

    def f_aug(y, aa):
        prim, tang = jvp(lambda q, ll: _linear(torch)(0.0, q, ll),
                         (y[:, :1], aa), (y[:, 1:], va))
        return torch.cat([prim, tang], -1)

    w = torch.tensor([[0.5, 2.0], [-1.0, 0.25]], dtype=torch.float64)
    gy, ga = vjp(f_aug, yy, a)[1](w)
    # f_aug = [a y, a δ + v y]: ∂/∂y = (a w0 + v w1), ∂/∂δ = a w1,
    # ∂/∂a = y w0 + δ w1
    torch.testing.assert_close(gy, torch.stack(
        [a * w[:, 0] + va * w[:, 1], a * w[:, 1]], -1), rtol=0, atol=0)
    torch.testing.assert_close(ga, yy[:, 0] * w[:, 0] + yy[:, 1] * w[:, 1],
                               rtol=0, atol=0)


def test_linear_flow_analytic_and_reference():
    """y' = a·y, L = Σ y(T)²: the closed-form Hessian, and the reference."""
    a = np.array([0.4, -0.7])
    y0 = np.array([[1.3], [0.8]])
    v_y0 = np.array([[0.3], [-1.1]])
    v_a = np.array([0.7, 0.2])
    tf = 1.5
    (h_y0, h_a), g = _both(
        _linear(jnp), _linear(torch), (0.0, tf), y0, a,
        dict(rtol=1e-11, atol=1e-13, adjoint_steps=256),
        loss=(lambda yT, aa: jnp.sum(yT ** 2),
              lambda yT, aa: torch.sum(yT ** 2)), v_y0=v_y0, v_args=v_a)
    e2 = np.exp(a * tf) ** 2
    np.testing.assert_allclose(h_y0[:, 0], 2 * e2 * v_y0[:, 0]
                               + 4 * tf * y0[:, 0] * e2 * v_a, rtol=1e-8)
    np.testing.assert_allclose(h_a, 4 * tf * y0[:, 0] * e2 * v_y0[:, 0]
                               + 4 * tf ** 2 * y0[:, 0] ** 2 * e2 * v_a,
                               rtol=1e-8)
    np.testing.assert_allclose(float(g), float(np.sum(
        2 * y0[:, 0] * e2 * v_y0[:, 0]
        + 2 * tf * y0[:, 0] ** 2 * e2 * v_a)), rtol=1e-8)


@pytest.mark.slow
def test_stiff_vdp_against_reference_and_fd():
    """Stiff VdP, mixed (y0, μ) direction: the reference's H·v, central
    differences of the port's adjoint gradient (eps 1e-3: the difference of
    two independently meshed gradients carries their O(rtol) mesh error),
    and gdotv = ⟨∇L, v⟩."""
    y0 = np.array([[2.0, 0.0], [1.5, 0.5]])
    mus = np.array([30.0, 80.0])
    v_y0 = np.array([[0.5, -0.3], [0.2, 0.9]])
    v_mu = np.array([1.0, -0.4])
    okw = dict(rtol=1e-10, atol=1e-13, adjoint_steps=1536)

    def loss(xp):
        return lambda yT, mm: xp.sum(yT ** 2) + 1e-3 * xp.sum(mm * yT[:, 0])

    (h_y0, h_mu), g = _both(ref_vdp, vdp_rhs, (0.0, 1.0), y0, mus, okw,
                            loss=(loss(jnp), loss(torch)), v_y0=v_y0,
                            v_args=v_mu)
    opts = Options(**okw)

    def grad(z, mm):
        z = torch.from_numpy(z).requires_grad_()
        mm = torch.from_numpy(mm).requires_grad_()
        loss(torch)(radau_adjoint(vdp_rhs, (0.0, 1.0), z, args=mm,
                                  options=opts), mm).backward()
        return z.grad, mm.grad

    eps = 1e-3
    gp = grad(y0 + eps * v_y0, mus + eps * v_mu)
    gm = grad(y0 - eps * v_y0, mus - eps * v_mu)
    np.testing.assert_allclose(h_y0, (gp[0] - gm[0]) / (2 * eps), rtol=1e-3,
                               atol=1e-8)
    np.testing.assert_allclose(h_mu, (gp[1] - gm[1]) / (2 * eps), rtol=5e-3,
                               atol=1e-8)
    g0 = grad(y0, mus)
    gv = float(torch.sum(g0[0] * torch.from_numpy(v_y0))
               + torch.sum(g0[1] * torch.from_numpy(v_mu)))
    np.testing.assert_allclose(float(g), gv, rtol=1e-6)


@pytest.mark.slow
def test_integral_cost_and_mass_against_reference():
    """loss(yT, q, θ) with a running cost and an invertible mass matrix."""
    mass = np.array([[2.0, 0.3], [0.1, 1.5]])
    y0 = np.array([[1.0, 0.0], [0.5, 0.3]])

    def cost(t, y, a):
        return a * y[:, 0] ** 2

    def loss(xp):
        return lambda yT, q, a: xp.sum(q) + 0.3 * xp.sum(yT ** 2)

    _both(_osc(jnp), _osc(torch), (0.0, 3.0), y0, np.float64(1.7),
          dict(rtol=1e-10, atol=1e-13, adjoint_steps=1536),
          loss=(loss(jnp), loss(torch)), cost=(cost, cost),
          v_y0=np.array([[0.2, -0.1], [0.4, 0.3]]), v_args=np.float64(0.6),
          mass=mass)


@pytest.mark.slow
def test_pytree_args_and_zero_direction_against_reference():
    """Dict args with an integer leaf: v_args=None is the pure-y0 direction,
    and the integer slot's h_args is None (the reference's float0)."""
    def f(xp):
        return lambda t, y, a: (ref_vdp if xp is jnp else vdp_rhs)(
            t, y, a["mu"])

    _both(f(jnp), f(torch), (0.0, 1.0), np.array([[2.0, 0.0]]),
          {"mu": np.array([20.0]), "n": np.array([3])},
          dict(rtol=1e-10, atol=1e-13, adjoint_steps=1536),
          loss=(lambda yT, a: jnp.sum(yT ** 2),
                lambda yT, a: torch.sum(yT ** 2)),
          v_y0=np.array([[1.0, -0.5]]))


@pytest.mark.slow
def test_full_hessian_by_directions():
    """Full Hessian of the linear flow in the parameters: one radau_hvp per
    unit direction (a loop; torch.func.vmap cannot pass the solver's host
    syncs), exact and diagonal; and the same rows with the two directions
    stacked along the lane axis in one solve."""
    a = torch.tensor([0.4, -0.7], dtype=torch.float64)
    y0 = torch.tensor([[1.3], [0.8]], dtype=torch.float64)
    tf = 1.5
    opts = Options(rtol=1e-11, atol=1e-13, adjoint_steps=512)

    def loss(yT, aa):
        return torch.sum(yT ** 2)

    rows = [radau_hvp(_linear(torch), (0.0, tf), y0, a, loss=loss,
                      v_args=e, options=opts)[0][1]
            for e in torch.eye(2, dtype=torch.float64)]
    hess = torch.stack(rows)
    exact = torch.diag(4 * tf ** 2 * y0[:, 0] ** 2 * torch.exp(a * tf) ** 2)
    torch.testing.assert_close(hess, exact, rtol=1e-8, atol=1e-12)
    # both directions in one solve: lanes (k, i) = direction k, lane i
    (_, h_st), _ = radau_hvp(_linear(torch), (0.0, tf), y0.repeat(2, 1),
                             a.repeat(2), loss=loss,
                             v_args=torch.eye(2, dtype=torch.float64)
                             .reshape(-1), options=opts)
    torch.testing.assert_close(h_st.reshape(2, 2), exact, rtol=1e-8,
                               atol=1e-12)


def test_v_args_none_leaves_and_guards():
    """A None leaf of v_args is a zero direction; a singular mass raises."""
    y0 = torch.tensor([[1.0, 0.1]], dtype=torch.float64)
    args = {"c": torch.tensor(0.5, dtype=torch.float64),
            "k": torch.tensor(1.0, dtype=torch.float64)}
    opts = Options(rtol=1e-7, atol=1e-10, adjoint_steps=512)

    def f(t, y, a):
        return torch.stack([y[:, 1], -a["k"] * y[:, 0] - a["c"] * y[:, 1]],
                           -1)

    def lss(yT, a):
        return torch.sum(yT ** 2)

    (_, h_none), _ = radau_hvp(f, (0.0, 2.0), y0, args, loss=lss,
                               v_args={"c": None, "k": 1.0}, options=opts)
    (_, h_zero), _ = radau_hvp(f, (0.0, 2.0), y0, args, loss=lss,
                               v_args={"c": 0.0, "k": 1.0}, options=opts)
    for k in ("c", "k"):
        assert torch.equal(h_none[k], h_zero[k]), k
    with pytest.raises(ValueError, match="singular"):
        radau_hvp(f, (0.0, 1.0), torch.zeros((1, 2), dtype=torch.float64),
                  args, loss=lss, options=opts,
                  mass=torch.diag(torch.tensor([1.0, 0.0],
                                               dtype=torch.float64)))
