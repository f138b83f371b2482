"""Piecewise control parameterizations (``models.controls``) of the port
against the JAX reference, on the CPU: the twins of the piecewise cases of
``tests/test_krylov_controls.py``.

``piecewise_constant`` (``torch.searchsorted(right=True)`` with the
reference's two clips) and ``piecewise_linear`` (``jnp.interp``'s clamped
linear interpolation, written out: torch has no ``interp``) at the knots,
between them and outside them, for values [K], [K, U] and, for the
constant, a batched [M, K, U]: equal to the reference within 1e-13
(measured equal to the bit); and a bang-bang control inside an adaptive
solve.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janus_tpu.models.controls import piecewise_constant as ref_constant
from janus_tpu.models.controls import piecewise_linear as ref_linear
from janus_tpu_torch.models import piecewise_constant, piecewise_linear
from janus_tpu_torch.solve import solve_ivp

torch.set_num_threads(1)

F64 = torch.float64
KNOTS = np.array([0.0, 0.5, 1.25, 2.0, 3.0])
# at the knots, between them, outside them, and a knot's neighbours
TIMES = np.concatenate([KNOTS, [-1.0, 0.1, 0.75, 1.9999, 2.5, 3.0001, 7.0],
                        np.nextafter(KNOTS, np.inf),
                        np.nextafter(KNOTS, -np.inf)])


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


@pytest.mark.parametrize("shape", [(5,), (5, 3), (2, 5, 3)],
                         ids=["K", "KxU", "MxKxU"])
def test_piecewise_constant_matches_reference(rng, shape):
    values = rng.standard_normal(shape)
    want = ref_constant(jnp.asarray(KNOTS), jnp.asarray(values))(
        jnp.asarray(TIMES))
    got = piecewise_constant(_t(KNOTS), _t(values))(_t(TIMES))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13,
                               atol=0.0)


@pytest.mark.parametrize("shape", [(5,), (5, 3)], ids=["K", "KxU"])
def test_piecewise_linear_matches_reference(rng, shape):
    values = rng.standard_normal(shape)
    want = ref_linear(jnp.asarray(KNOTS), jnp.asarray(values))(
        jnp.asarray(TIMES))
    got = piecewise_linear(_t(KNOTS), _t(values))(_t(TIMES))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13,
                               atol=1e-15)
    u = piecewise_linear(_t([0.0, 1.0]), _t([0.0, 2.0]))
    np.testing.assert_allclose(u(_t([0.25, 0.5])).numpy(), [0.5, 1.0])


def test_piecewise_linear_zero_width_knot_matches_reference():
    """A repeated knot (a jump) takes the left value at it, as jnp.interp's
    zero-width guard does."""
    knots = np.array([0.0, 1.0, 1.0, 2.0])
    values = np.array([0.0, 1.0, 3.0, 4.0])
    times = np.array([0.5, 1.0, 1.5, np.nextafter(1.0, 0.0)])
    want = ref_linear(jnp.asarray(knots), jnp.asarray(values))(
        jnp.asarray(times))
    got = piecewise_linear(_t(knots), _t(values))(_t(times))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_piecewise_controls_follow_the_device_rule():
    """Numpy values go to the asked device (by default the card, which the
    CPU has not: ValueError); the knots follow them."""
    u = piecewise_linear([0.0, 1.0], np.array([0.0, 2.0]), device="cpu")
    np.testing.assert_allclose(u(0.25).numpy(), 0.5)
    v = piecewise_constant([0.0, 1.0], np.array([3.0, 4.0]), device="cpu")
    assert float(v(1.5)) == 4.0
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="no CUDA device"):
            piecewise_linear([0.0, 1.0], np.array([0.0, 2.0]))


def test_piecewise_constant_control_in_solver():
    """Bang-bang forcing through the adaptive solver."""
    u = piecewise_constant(_t([0.0, 1.0, 2.0]), _t([1.0, -1.0]))

    def rhs(t, y, args):
        return u(t)[..., None].expand(y.shape)

    sol = solve_ivp(rhs, (0.0, 2.0), torch.zeros((1, 1), dtype=F64),
                    method="dopri5", rtol=1e-9, atol=1e-12,
                    t_eval=_t([0.5, 1.0, 1.5, 2.0]))
    # ∫u: 0.5, 1.0, then back down 0.5, 0.0
    np.testing.assert_allclose(sol.ys[0, :, 0].numpy(), [0.5, 1.0, 0.5, 0.0],
                               atol=1e-6)
