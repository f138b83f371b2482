"""Forward-mode sensitivities through the port's solves on locally
polynomial dynamics, the twin of ``tests/test_sens_degenerate.py``.

Constant-derivative dynamics make every error estimate and second Newton
correction EXACTLY zero, where d(√u) = du/(2√u) is 0/0. The port's
``solve.common.safe_sqrt`` is a ``torch.autograd.Function`` with a zero
derivative at 0 (the reference's ``custom_jvp``), so ``torch.func.jacfwd``
through every method returns the exact constant sensitivity: (2, 4) at the
reference's bound (rtol 1e-6, atol 1e-8). Its forward is ``torch.sqrt``
to the bit, NaN included, so no forward number moves: the Radau9 headline
configuration is held equal to the bit with the plain sqrt in its place.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janus_tpu.solve.common import safe_sqrt as ref_safe_sqrt
from janus_tpu_torch.models.problems import vdp_jac, vdp_rhs
from janus_tpu_torch.solve import Options, solve_ivp
from janus_tpu_torch.solve import common as cm
from janus_tpu_torch.solve.common import safe_sqrt
from janus_tpu_torch.solve.radau import solve_radau

torch.set_num_threads(1)


def rhs(t, y, a):
    return torch.stack([a, 2.0 * a], dim=-1).broadcast_to(y.shape)


METHODS = ["dopri5", "dopri853", "radau", "radaup", "bdf", "bdf2", "rodas",
           "grk4t", "seulex"]


@pytest.mark.parametrize("method", METHODS)
def test_jacfwd_constant_dynamics(method):
    def final(a):
        sol = solve_ivp(rhs, (0.0, 2.0),
                        torch.tensor([[0.1, 0.2]], dtype=torch.float64),
                        method=method, args=a,
                        options=Options(rtol=1e-7, atol=1e-10))
        return sol.y

    jac = torch.func.jacfwd(final)(torch.tensor(0.3, dtype=torch.float64))
    assert not bool(torch.isnan(jac).any()), jac
    # y(T) = y0 + T*(a, 2a)  =>  dy/da = (T, 2T) = (2, 4)
    np.testing.assert_allclose(jac.numpy().ravel(), [2.0, 4.0],
                               rtol=1e-6, atol=1e-8)


def test_vmap_jvp_through_a_solve():
    """vmap over jvp (the jet transform's shape) through a solve."""
    def final(a):
        return solve_ivp(rhs, (0.0, 2.0),
                         torch.tensor([[0.1, 0.2]], dtype=torch.float64),
                         method="radau", args=a,
                         options=Options(rtol=1e-7, atol=1e-10)).y

    a = torch.tensor(0.3, dtype=torch.float64)
    seeds = torch.tensor([1.0, -2.0], dtype=torch.float64)
    tans = torch.func.vmap(lambda s: torch.func.jvp(final, (a,), (s,))[1])(
        seeds)
    np.testing.assert_allclose(tans.numpy().reshape(2, 2),
                               [[2.0, 4.0], [-4.0, -8.0]], rtol=1e-6,
                               atol=1e-8)


def test_safe_sqrt_tangent_at_zero():
    val, tan = torch.func.jvp(safe_sqrt, (torch.tensor(0.0),),
                              (torch.tensor(0.0),))
    assert float(val) == 0.0 and float(tan) == 0.0
    val, tan = torch.func.jvp(safe_sqrt, (torch.tensor(0.0),),
                              (torch.tensor(1.0),))
    assert float(val) == 0.0 and float(tan) == 0.0
    val, tan = torch.func.jvp(safe_sqrt, (torch.tensor(4.0),),
                              (torch.tensor(1.0),))
    np.testing.assert_allclose([float(val), float(tan)], [2.0, 0.25])


def test_safe_sqrt_against_reference(rng):
    """Value and tangent equal the reference's custom_jvp on the same
    inputs (zeros, positives, a NaN, a negative, inf) within an ulp: XLA's
    sqrt inside the jvp rule rounds one value of eleven the other way."""
    x = np.concatenate([[0.0, 0.0, np.nan, -1.0, np.inf],
                        rng.uniform(0.0, 10.0, 11)])
    dx = rng.standard_normal(x.shape)
    rv, rt = jax.jvp(ref_safe_sqrt, (jnp.asarray(x),), (jnp.asarray(dx),))
    pv, pt = torch.func.jvp(safe_sqrt, (torch.from_numpy(x),),
                            (torch.from_numpy(dx),))
    np.testing.assert_allclose(pv.numpy(), np.asarray(rv), rtol=1e-15,
                               atol=0)
    np.testing.assert_allclose(pt.numpy(), np.asarray(rt), rtol=1e-15,
                               atol=0)
    assert (pt.numpy()[:2] == 0.0).all()


def test_safe_sqrt_reverse_rules():
    """backward, torch.func.vjp and torch.func.grad: the same rule
    transposed, zero at 0 (where torch.sqrt's is inf)."""
    x = torch.tensor([0.0, 4.0, 9.0], dtype=torch.float64,
                     requires_grad=True)
    (g,) = torch.autograd.grad(safe_sqrt(x).sum(), x)
    np.testing.assert_array_equal(g.numpy(), [0.0, 0.25, 1.0 / 6.0])
    _, pull = torch.func.vjp(safe_sqrt, x.detach())
    np.testing.assert_array_equal(pull(torch.ones(3, dtype=torch.float64))[0]
                                  .numpy(), g.numpy())
    np.testing.assert_array_equal(
        torch.func.grad(lambda z: safe_sqrt(z).sum())(x.detach()).numpy(),
        g.numpy())


def test_safe_sqrt_forward_is_sqrt_to_the_bit(rng):
    x = torch.from_numpy(np.concatenate([
        [0.0, -0.0, np.nan, -1.0, np.inf, 1e-300, 5e-324],
        rng.uniform(0.0, 1e3, 64)]))
    for dtype in (torch.float64, torch.float32):
        got, want = safe_sqrt(x.to(dtype)), torch.sqrt(x.to(dtype))
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        ok = ~torch.isnan(want)
        assert torch.equal(got[ok], want[ok])
        assert torch.equal(torch.signbit(got[ok]), torch.signbit(want[ok]))


def test_safe_sqrt_vmap_jvp():
    x = torch.tensor([0.0, 4.0, 16.0], dtype=torch.float64)
    tans = torch.func.vmap(
        lambda v: torch.func.jvp(safe_sqrt, (x,), (v,))[1])(
        torch.tensor([[1.0, 1.0, 1.0], [2.0, 2.0, 2.0]], dtype=torch.float64))
    np.testing.assert_array_equal(tans.numpy(), [[0.0, 0.25, 0.125],
                                                 [0.0, 0.5, 0.25]])


def _headline(m=8):
    y0 = torch.tensor([[2.0, 0.0]], dtype=torch.float64).repeat(m, 1)
    mus = torch.full((m,), 1e3, dtype=torch.float64)
    seeds = torch.zeros((2, m, 2), dtype=torch.float64)
    seeds[0, :, 0] = 1.0
    seeds[1, :, 1] = 1.0
    return solve_radau(vdp_rhs, 0.0, 1.0, y0, args=mus,
                       options=Options(rtol=1e-6, atol=1e-9, pivoting=False,
                                       min_stages=5, max_stages=5,
                                       kernel_lu=True),
                       jac=vdp_jac, tangents=seeds)


def test_headline_forward_unchanged_to_the_bit(monkeypatch):
    """The Radau9 headline configuration (K=2 IND, kernel_lu, 8 lanes)
    with safe_sqrt equals the same solve with the plain torch.sqrt."""
    a = _headline()
    monkeypatch.setattr(cm, "safe_sqrt", torch.sqrt)
    b = _headline()
    for k in ("t", "y", "sens", "status", "h_next"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    for k in a.stats:
        assert torch.equal(a.stats[k], b.stats[k]), k
