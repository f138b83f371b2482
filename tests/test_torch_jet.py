"""The port's dual numbers (``janus_tpu_torch.jet``) against the JAX
reference's ``janus_tpu.jet`` Jet, op by op, on the CPU in float64; the
twin of ``tests/test_jet.py``.

Each op gets the same numpy-seeded Jet in both packages (a reference Jet
converted by ``interop.jet_from_jax``) and its primal and tangents are held
to the reference's within 1e-14 relative to the largest entry. The
reference's own property checks (tangents against ``torch.func.jvp`` and
central differences) run on the port too, with tensors on the left of the
operators and a Python loop in place of ``lax.scan``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janus_tpu import jet as RJ
from janus_tpu.jet.core import maximum as ref_maximum
from janus_tpu.jet.core import minimum as ref_minimum
from janus_tpu_torch import jet as J
from janus_tpu_torch.interop import jet_from_jax
from janus_tpu_torch.jet.core import maximum, minimum

torch.set_num_threads(1)
TOL = 1e-14


def make_pair(rng, shape=(4, 3), n=5, positive=False):
    """(reference Jet, port Jet) on the same numpy draw."""
    r = rng.standard_normal(shape)
    if positive:
        r = np.abs(r) + 0.5
    d = rng.standard_normal((n,) + shape)
    ref = RJ.jet(jnp.asarray(r), jnp.asarray(d))
    return ref, jet_from_jax(ref, device="cpu")


def close(got, want, tol=TOL):
    """A port Jet (or tensor) against a reference Jet (or array)."""
    if isinstance(got, J.Jet):
        close(got.r, want.r, tol)
        close(got.d, want.d, tol)
        return
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _fn(xp_name, jet_method):
    """A unary op that calls the Jet method on Jets and the array
    library's function on arrays."""
    def op(z):
        if isinstance(z, (J.Jet, RJ.Jet)):
            return getattr(z, jet_method)()
        if isinstance(z, torch.Tensor):
            return getattr(torch, xp_name)(z)
        return getattr(jnp, xp_name)(z)
    return op


UNARY = [
    lambda z: z + 2.5,
    lambda z: 2.5 - z,
    lambda z: z * 3.0,
    lambda z: z / 1.7,
    lambda z: 1.0 / z,
    lambda z: -z,
    lambda z: z ** 3,
    _fn("exp", "exp"),
    _fn("sin", "sin"),
    _fn("cos", "cos"),
    _fn("tanh", "tanh"),
    _fn("square", "square"),
    lambda z: z.reciprocal() if isinstance(z, (J.Jet, RJ.Jet)) else 1.0 / z,
    _fn("sqrt", "sqrt"),
    _fn("log", "log"),
    abs,
]


@pytest.mark.parametrize("op_idx", range(len(UNARY)))
def test_unary_matches_reference(rng, op_idx):
    op = UNARY[op_idx]
    ref, port = make_pair(rng, positive=True)
    close(op(port), op(ref))


@pytest.mark.parametrize("op_idx", range(len(UNARY) - 3))
def test_unary_tangents_match_jvp(rng, op_idx):
    op = UNARY[op_idx]
    _, x = make_pair(rng, positive=True)
    out = op(x)
    for k in range(x.nsens):
        _, expect = torch.func.jvp(op, (x.r,), (x.d[k],))
        np.testing.assert_allclose(out.d[k], expect, rtol=1e-10, atol=1e-12)


BINARY = [lambda u, v: u + v, lambda u, v: u - v, lambda u, v: u * v,
          lambda u, v: u / v, lambda u, v: u ** v]


@pytest.mark.parametrize("op_idx", range(len(BINARY)))
def test_binary_jet_jet_matches_reference(rng, op_idx):
    op = BINARY[op_idx]
    ra, pa = make_pair(rng, positive=True)
    rb, pb = make_pair(rng, positive=True)
    close(op(pa, pb), op(ra, rb))


@pytest.mark.parametrize("op_idx", range(len(BINARY) - 1))
def test_tensor_on_the_left_matches_reference(rng, op_idx):
    """tensor (op) Jet reaches the Jet's reflected operator, as array (op)
    Jet does in the reference."""
    op = BINARY[op_idx]
    c = rng.standard_normal((4, 3)) + 3.0
    ref, port = make_pair(rng, positive=True)
    got = op(torch.from_numpy(c), port)
    assert isinstance(got, J.Jet)
    close(got, op(jnp.asarray(c), ref))
    close(op(2.0, port), op(2.0, ref))


def test_tensor_on_the_left_matmul(rng):
    ref, port = make_pair(rng, (2, 4, 6))
    c = rng.standard_normal((2, 3, 4))
    got = torch.from_numpy(c) @ port
    assert isinstance(got, J.Jet)
    close(got, jnp.asarray(c) @ ref)


def test_binary_jet_jet(rng):
    _, a = make_pair(rng)
    _, b = make_pair(rng)
    b = J.jet(b.r + 3.0, b.d)
    for op in BINARY[:4]:
        out = op(a, b)
        for k in range(a.nsens):
            _, expect = torch.func.jvp(op, (a.r, b.r), (a.d[k], b.d[k]))
            np.testing.assert_allclose(out.d[k], expect, rtol=1e-10,
                                       atol=1e-12)


def test_matmul_einsum(rng):
    ra, a = make_pair(rng, (2, 3, 4))
    rb, b = make_pair(rng, (2, 4, 6))
    out = a @ b
    oute = J.einsum("bij,bjk->bik", a, b)
    close(out, ra @ rb)
    close(oute, RJ.einsum("bij,bjk->bik", ra, rb))
    for k in range(5):
        _, expect = torch.func.jvp(lambda x, y: x @ y, (a.r, b.r),
                                   (a.d[k], b.d[k]))
        np.testing.assert_allclose(out.d[k], expect, rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(oute.d[k], expect, rtol=1e-10, atol=1e-12)
    # a constant operand on either side
    c = rng.standard_normal((2, 4, 6))
    close(J.matmul(a, torch.from_numpy(c)), RJ.matmul(ra, jnp.asarray(c)))
    close(J.einsum("bij,bjk->bik", torch.from_numpy(c.transpose(0, 2, 1)
                                                    [:, :3, :4].copy()), b),
          RJ.einsum("bij,bjk->bik", jnp.asarray(c.transpose(0, 2, 1)
                                                 [:, :3, :4].copy()), rb))


def test_lift_generic(rng):
    ref, x = make_pair(rng)
    close(J.lift(lambda z: torch.sum(torch.sin(z) * z, dim=-1), x),
          RJ.lift(lambda z: jnp.sum(jnp.sin(z) * z, axis=-1), ref))
    f = lambda z: torch.sum(torch.sin(z) * z, dim=-1)
    out = J.lift(f, x)
    for k in range(x.nsens):
        _, expect = torch.func.jvp(f, (x.r,), (x.d[k],))
        np.testing.assert_allclose(out.d[k], expect, rtol=1e-10, atol=1e-12)


def test_lift_mixed_const_and_tuple_out(rng):
    ref, x = make_pair(rng)
    c = rng.standard_normal((4, 3))
    got = J.lift(lambda a, b: (a * b + torch.cos(b), a.sum()), x,
                 torch.from_numpy(c))
    want = RJ.lift(lambda a, b: (a * b + jnp.cos(b), a.sum()), ref,
                   jnp.asarray(c))
    assert isinstance(got, tuple) and len(got) == 2
    for g, w in zip(got, want):
        close(g, w)


def test_jvp_call(rng):
    ref, x = make_pair(rng)
    c = rng.standard_normal(3)
    close(J.jvp_call(lambda z, w: torch.tanh(z) @ w, x, torch.from_numpy(c)),
          RJ.jvp_call(lambda z, w: jnp.tanh(z) @ w, ref, jnp.asarray(c)))


def test_where_select(rng):
    ra, a = make_pair(rng)
    rb, b = make_pair(rng)
    close(J.where(a.r > 0, a, b), RJ.where(ra.r > 0, ra, rb))
    close(J.where(a > 0, a, 0.5), RJ.where(ra > 0, ra, ra.const_like(0.5)))


def test_concat_stack_sum(rng):
    ra, a = make_pair(rng, (4, 3))
    rb, b = make_pair(rng, (4, 2))
    c = J.concatenate([a, b], axis=-1)
    assert c.shape == (4, 5)
    assert c.d.shape == (5, 4, 5)
    close(c, RJ.concatenate([ra, rb], axis=-1))
    close(J.concatenate([a, torch.ones(4, 1, dtype=torch.float64)], axis=1),
          RJ.concatenate([ra, jnp.ones((4, 1))], axis=1))
    rc, cc = make_pair(rng, (4, 3))
    close(J.stack([a, cc], axis=1), RJ.stack([ra, rc], axis=1))
    for axis, keep in ((-1, False), (0, True), (None, False), (None, True)):
        close(a.sum(axis=axis, keepdims=keep),
              ra.sum(axis=axis, keepdims=keep))
        close(J.jsum(a, axis=axis, keepdims=keep),
              RJ.jsum(ra, axis=axis, keepdims=keep))


def test_getitem_reshape(rng):
    ref, x = make_pair(rng, (4, 3))
    for idx in (1, (slice(None), 0), (Ellipsis, 2), slice(1, 3)):
        close(x[idx], ref[idx])
    close(x.reshape(3, 4), ref.reshape(3, 4))
    close(x.reshape((12,)), ref.reshape((12,)))


def test_max_min_dual(rng):
    ref, a = make_pair(rng, (6, 4))
    for axis, keep in ((-1, False), (0, True)):
        close(J.max_dual(a, axis=axis, keepdims=keep),
              RJ.max_dual(ref, axis=axis, keepdims=keep))
        close(J.min_dual(a, axis=axis, keepdims=keep),
              RJ.min_dual(ref, axis=axis, keepdims=keep))
    close(minimum(a, a.const_like(0.0)),
          ref_minimum(ref, ref.const_like(0.0)))
    close(maximum(a, a.const_like(0.0)),
          ref_maximum(ref, ref.const_like(0.0)))


def test_comparisons_on_the_primal(rng):
    ra, a = make_pair(rng)
    rb, b = make_pair(rng)
    for op in (lambda u, v: u < v, lambda u, v: u <= v, lambda u, v: u > v,
               lambda u, v: u >= v, lambda u, v: u == v, lambda u, v: u != v):
        np.testing.assert_array_equal(op(a, b).numpy(), np.asarray(op(ra, rb)))
        np.testing.assert_array_equal(op(a, 0.1).numpy(),
                                      np.asarray(op(ra, 0.1)))


def test_constructors(rng):
    y = np.arange(6.0).reshape(2, 3)
    jt = J.seed_identity(torch.from_numpy(y), extra=2)
    assert jt.nsens == 5
    close(jt, RJ.seed_identity(jnp.asarray(y), extra=2), 0.0)
    np.testing.assert_allclose(jt.d[0, :, 0], 1.0)
    np.testing.assert_allclose(jt.d[1, :, 0], 0.0)
    np.testing.assert_allclose(jt.d[3], 0.0)   # extra column zero-seeded
    close(J.const(torch.from_numpy(y), 3), RJ.const(jnp.asarray(y), 3), 0.0)
    with pytest.raises(ValueError, match="incompatible"):
        J.jet(torch.zeros(2, 3), torch.zeros(4, 3, 2))
    ref, x = make_pair(rng)
    for name in ("zeros_like", "ones_like"):
        close(getattr(x, name)(), getattr(ref, name)(), 0.0)
    close(x.const_like(1.5), ref.const_like(1.5), 0.0)


def test_jet_through_a_python_loop(rng):
    """A Python loop in place of lax.scan: Jets are carried as plain
    objects."""
    ref, x = make_pair(rng, (3,), n=2)
    out, want = x, ref
    for _ in range(5):
        out = out * 1.1 + 0.1
    want, _ = jax.lax.scan(lambda c, _: (c * 1.1 + 0.1, None), ref, None,
                           length=5)
    close(out, want)


def test_jet_fd_property(rng):
    """FD-vs-tangent property on a composite expression."""
    _, x = make_pair(rng, (8,), n=3)
    g = lambda z: torch.tanh(z) * torch.exp(-0.5 * z * z) + z / (1.0 + z * z)
    out = J.lift(g, x)
    eps = 1e-6
    for k in range(3):
        fd = (g(x.r + eps * x.d[k]) - g(x.r - eps * x.d[k])) / (2 * eps)
        np.testing.assert_allclose(out.d[k], fd, rtol=1e-6, atol=1e-8)


def test_tf32_off():
    """The role of the reference's Precision.HIGHEST contractions: the
    package turns TF32 off, so f32 jet contractions stay f32 on a card."""
    import janus_tpu_torch  # noqa: F401
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_jet_f32_dtype(rng):
    """Jet arithmetic in float32 stays at f32 accuracy against f64."""
    _, a64 = make_pair(rng, (16, 8), n=3)
    _, b64 = make_pair(rng, (8, 4), n=3)
    to32 = lambda j: J.Jet(j.r.float(), j.d.float())
    a32, b32 = to32(a64), to32(b64)
    out64, out32 = J.matmul(a64, b64), J.matmul(a32, b32)
    np.testing.assert_allclose(out32.r.double(), out64.r, rtol=3e-6,
                               atol=3e-6)
    np.testing.assert_allclose(out32.d.double(), out64.d, rtol=3e-5,
                               atol=3e-5)
    g = lambda z: torch.tanh(z) * torch.exp(-0.5 * z) + z * z
    l64, l32 = J.lift(g, a64), J.lift(g, a32)
    np.testing.assert_allclose(l32.r.double(), l64.r, rtol=3e-6, atol=3e-6)
    np.testing.assert_allclose(l32.d.double(), l64.d, rtol=3e-5, atol=3e-5)
