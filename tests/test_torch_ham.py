"""The port's Hamiltonian calculus (``janus_tpu_torch.ham``) against the JAX
reference ``janus_tpu.ham``, on the CPU in float64, the twin of
``tests/test_ham.py``.

Every exported function gets the same numpy-seeded inputs in both packages
and is held to the reference within 1e-14 relative to the largest entry
(grad, jacfwd and the vmap may add in their own order); the reference's own
checks (central differences, symmetry, the sign convention, the explicit
VdP system, the control hook, batched against single, the singular lane)
run on the port as well.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janus_tpu import ham as ref_ham
from janus_tpu.models import problems as ref_problems
from janus_tpu_torch import ham
from janus_tpu_torch.models.problems import vdp_hamiltonian, vdp_rhs

torch.set_num_threads(1)
TOL = 1e-14


def _h(xp):
    # a smooth nonlinear H mixing x and p
    def h(x, p, args):
        return (xp.sum(p * p) * 0.5 + xp.sum(xp.cos(x) * p)
                + xp.sum(x ** 4) / 4)
    return h


def _h_u(xp):
    """An explicit-control H(x, p, u, args)."""
    def h(x, p, u, args):
        return (xp.sum(p * u) - 0.5 * args * xp.sum(u * u)
                + xp.sum(xp.sin(x) * p * u) + xp.sum(x * x * p))
    return h


def _t(a):
    return torch.from_numpy(np.asarray(a))


def close(got, want, tol=TOL):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


# -- every exported function against the reference --------------------------

SINGLE = ["grad_x", "grad_p", "hessian_xx", "hessian_pp", "hessian_xp"]
CONTROL = ["grad_u", "hessian_uu", "hessian_ux", "hessian_up"]


@pytest.mark.parametrize("name", SINGLE)
def test_partials_match_reference(rng, name):
    x, p = rng.standard_normal(3), rng.standard_normal(3)
    want = getattr(ref_ham, name)(_h(jnp))(jnp.asarray(x), jnp.asarray(p),
                                           None)
    close(getattr(ham, name)(_h(torch))(_t(x), _t(p), None), want)


@pytest.mark.parametrize("name", CONTROL)
def test_control_partials_match_reference(rng, name):
    x, p, u = (rng.standard_normal(3) for _ in range(3))
    want = getattr(ref_ham, name)(_h_u(jnp))(
        jnp.asarray(x), jnp.asarray(p), jnp.asarray(u), 0.7)
    close(getattr(ham, name)(_h_u(torch))(_t(x), _t(p), _t(u), 0.7), want)


@pytest.mark.parametrize("batched", [True, False])
@pytest.mark.parametrize("name", ["hamiltonian_dynamics",
                                  "hamiltonian_jacobian", "safe_dynamics"])
def test_dynamics_match_reference(rng, name, batched):
    y = rng.standard_normal((5, 6) if batched else 6)
    t = np.linspace(0.0, 1.0, 5) if batched else 0.3
    want = getattr(ref_ham, name)(_h(jnp), batched=batched)(
        jnp.asarray(t), jnp.asarray(y), None)
    close(getattr(ham, name)(_h(torch), batched=batched)(
        _t(t) if batched else t, _t(y), None), want)


@pytest.mark.parametrize("batched", [True, False])
@pytest.mark.parametrize("name", ["hamiltonian_dynamics_u",
                                  "pmp_dynamics_u"])
def test_control_dynamics_match_reference(rng, name, batched):
    shape = (5,) if batched else ()
    y = rng.standard_normal(shape + (6,))
    u = rng.standard_normal(shape + (3,))
    want = getattr(ref_ham, name)(_h_u(jnp), batched=batched)(
        0.2, jnp.asarray(y), jnp.asarray(u), 0.7)
    close(getattr(ham, name)(_h_u(torch), batched=batched)(
        0.2, _t(y), _t(u), 0.7), want)


@pytest.mark.parametrize("batched", [True, False])
def test_stationarity_residual_matches_reference(rng, batched):
    shape = (5,) if batched else ()
    x, p, u = (rng.standard_normal(shape + (3,)) for _ in range(3))
    want = ref_ham.stationarity_residual(_h_u(jnp), batched=batched)(
        jnp.asarray(x), jnp.asarray(p), jnp.asarray(u), 0.7)
    close(ham.stationarity_residual(_h_u(torch), batched=batched)(
        _t(x), _t(p), _t(u), 0.7), want)


def test_split_join_match_reference(rng):
    y = rng.standard_normal((4, 6))
    for got, want in zip(ham.split_px(_t(y)),
                         ref_ham.split_px(jnp.asarray(y))):
        close(got, want, 0.0)
    p, x = rng.standard_normal((4, 3)), rng.standard_normal((4, 3))
    close(ham.join_px(_t(p), _t(x)), ref_ham.join_px(jnp.asarray(p),
                                                     jnp.asarray(x)), 0.0)


def test_control_hook_matches_reference(rng):
    def hook(xp):
        def h_u(x, p, u, args):
            return xp.sum(p * u) - 0.5 * xp.sum(u * u) + xp.sum(x * p)
        return h_u

    y = rng.standard_normal((4, 4))
    want = ref_ham.hamiltonian_dynamics(hook(jnp), u=lambda x, p, a: p)(
        0.0, jnp.asarray(y), None)
    close(ham.hamiltonian_dynamics(hook(torch), u=lambda x, p, a: p)(
        0.0, _t(y), None), want)


def test_vdp_hamiltonian_system_matches_reference(rng):
    """vdp_hamiltonian's dynamics and Jacobian, the system of the card's
    Hamiltonian VdP cell, against the reference's."""
    y = rng.standard_normal((6, 4))
    t = rng.uniform(0.0, 1.0, 6)
    for name in ("hamiltonian_dynamics", "hamiltonian_jacobian"):
        want = getattr(ref_ham, name)(ref_problems.vdp_hamiltonian)(
            jnp.asarray(t), jnp.asarray(y), {"mu": 1e3})
        close(getattr(ham, name)(vdp_hamiltonian)(_t(t), _t(y),
                                                  {"mu": 1e3}), want)


def test_jvp_through_dynamics_matches_reference(rng):
    """The IND sweep's J·v: a jvp of the vmap(grad) rhs."""
    y, v = rng.standard_normal((5, 4)), rng.standard_normal((5, 4))
    f_ref = ref_ham.hamiltonian_dynamics(ref_problems.vdp_hamiltonian)
    f = ham.hamiltonian_dynamics(vdp_hamiltonian)
    _, want = jax.jvp(lambda z: f_ref(0.0, z, 30.0), (jnp.asarray(y),),
                      (jnp.asarray(v),))
    _, got = torch.func.jvp(lambda z: f(0.0, z, 30.0), (_t(y),), (_t(v),))
    close(got, want)


# -- the reference's own checks on the port ----------------------------------

def test_grads_vs_fd(rng):
    h = _h(torch)
    gx = ham.grad_x(h)
    gp = ham.grad_p(h)
    x = _t(rng.standard_normal(3))
    p = _t(rng.standard_normal(3))
    eps = 1e-6
    for i in range(3):
        e = torch.zeros(3, dtype=torch.float64)
        e[i] = eps
        fdx = (h(x + e, p, None) - h(x - e, p, None)) / (2 * eps)
        fdp = (h(x, p + e, None) - h(x, p - e, None)) / (2 * eps)
        np.testing.assert_allclose(gx(x, p, None)[i], fdx, rtol=1e-6)
        np.testing.assert_allclose(gp(x, p, None)[i], fdp, rtol=1e-6)


def test_hessians_symmetry(rng):
    h = _h(torch)
    x = _t(rng.standard_normal(3))
    p = _t(rng.standard_normal(3))
    hxx = ham.hessian_xx(h)(x, p, None)
    hpp = ham.hessian_pp(h)(x, p, None)
    np.testing.assert_allclose(hxx, hxx.T, atol=1e-12)
    np.testing.assert_allclose(hpp, torch.eye(3, dtype=torch.float64),
                               atol=1e-12)
    hxp = ham.hessian_xp(h)(x, p, None)
    hpx = torch.func.jacfwd(lambda xx: ham.grad_p(h)(xx, p, None))(x)
    np.testing.assert_allclose(hxp, hpx.T, atol=1e-12)


def test_dynamics_sign_convention(rng):
    """ṗ = +∂H/∂x, ẋ = +∂H/∂p exactly."""
    h = _h(torch)
    f = ham.hamiltonian_dynamics(h, batched=False)
    p = _t(rng.standard_normal(3))
    x = _t(rng.standard_normal(3))
    dy = f(0.0, torch.cat([p, x]), None)
    np.testing.assert_allclose(dy[:3], ham.grad_x(h)(x, p, None), rtol=1e-12)
    np.testing.assert_allclose(dy[3:], ham.grad_p(h)(x, p, None), rtol=1e-12)


def test_pmp_signs(rng):
    """pmp_dynamics_u: ṗ = −∂H/∂x where the baked convention has +."""
    h = _h_u(torch)
    y, u = _t(rng.standard_normal((4, 6))), _t(rng.standard_normal((4, 3)))
    a = ham.hamiltonian_dynamics_u(h)(0.0, y, u, 0.7)
    b = ham.pmp_dynamics_u(h)(0.0, y, u, 0.7)
    np.testing.assert_array_equal(b[:, :3], -a[:, :3])
    np.testing.assert_array_equal(b[:, 3:], a[:, 3:])


def test_vdp_explicit_vs_hamiltonian(rng):
    """The PMP VdP Hamiltonian's ẋ part equals the explicit VdP RHS."""
    mu = 3.0
    f = ham.hamiltonian_dynamics(vdp_hamiltonian, batched=True)
    x = _t(rng.standard_normal((5, 2)))
    p = _t(rng.standard_normal((5, 2)))
    dy = f(torch.zeros(5, dtype=torch.float64), torch.cat([p, x], dim=-1),
           {"mu": mu})
    np.testing.assert_allclose(dy[:, 2:], vdp_rhs(0.0, x, {"mu": mu}),
                               rtol=1e-12)


def test_jacobian_vs_fd(rng):
    h = _h(torch)
    jfn = ham.hamiltonian_jacobian(h, batched=False)
    ffn = ham.hamiltonian_dynamics(h, batched=False)
    y = _t(rng.standard_normal(6))
    jac = jfn(0.0, y, None)
    eps = 1e-6
    for i in range(6):
        e = torch.zeros(6, dtype=torch.float64)
        e[i] = eps
        fd = (ffn(0.0, y + e, None) - ffn(0.0, y - e, None)) / (2 * eps)
        np.testing.assert_allclose(jac[:, i], fd, rtol=2e-5, atol=1e-7)


def test_control_hook(rng):
    """u*(x, p) folded into H."""
    def h_u(x, p, u, args):
        return torch.sum(p * u) - 0.5 * torch.sum(u * u) + torch.sum(x * p)

    f = ham.hamiltonian_dynamics(h_u, u=lambda x, p, args: p, batched=False)
    x = _t(rng.standard_normal(2))
    p = _t(rng.standard_normal(2))
    dy = f(0.0, torch.cat([p, x]), None)
    # with u* = p: H = |p|²/2 + x·p ⇒ ∂H/∂x = p, ∂H/∂p = p + x
    np.testing.assert_allclose(dy[:2], p, rtol=1e-12)
    np.testing.assert_allclose(dy[2:], p + x, rtol=1e-12)


def test_batched_matches_single(rng):
    h = _h(torch)
    fb = ham.hamiltonian_dynamics(h, batched=True)
    fs = ham.hamiltonian_dynamics(h, batched=False)
    y = _t(rng.standard_normal((4, 6)))
    out = fb(torch.zeros(4, dtype=torch.float64), y, None)
    for i in range(4):
        np.testing.assert_allclose(out[i], fs(0.0, y[i], None), rtol=1e-12)


def test_safe_dynamics_masks_singularities():
    """A Hamiltonian with a pole emits no NaN; the regular lane is
    untouched."""
    def h_sing(x, p, args):
        return torch.sum(p * p) / (2.0 * x[0])   # pole at x0 = 0

    f = ham.safe_dynamics(h_sing, batched=True)
    p = torch.tensor([[1.0, 0.0], [1.0, 0.0]], dtype=torch.float64)
    x = torch.tensor([[0.0, 1.0], [2.0, 1.0]], dtype=torch.float64)
    y = torch.cat([p, x], dim=-1)
    dy = f(torch.zeros(2, dtype=torch.float64), y, None)
    assert bool(torch.isfinite(dy).all())
    fr = ham.hamiltonian_dynamics(h_sing, batched=True)(
        torch.zeros(2, dtype=torch.float64), y, None)
    np.testing.assert_allclose(dy[1], fr[1], rtol=1e-12)
