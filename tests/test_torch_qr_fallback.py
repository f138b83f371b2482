"""``Options(qr_fallback=True)`` in the port: the per-lane Householder-QR
rescue of a broken stage LU, on the CPU in float64, against the JAX package.

The trigger is the reference test's: pivot-free LU on a permuted mass
matrix whose iteration matrix γ/h·M − J has a structural zero leading pivot
at every h. Each case runs through both packages in the same process on the
same inputs: status and every counter equal per lane, y (and the IND
tangents) within 1e-10 relative to the largest entry; and the reference
test's exact-solution oracle. ``linalg.qr`` against the reference's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janus_tpu.linalg import qr as ref_qr
from janus_tpu.solve import Options as RefOptions
from janus_tpu.solve.radau import solve_radau as ref_solve_radau
from janus_tpu_torch.interop import options_from_jax
from janus_tpu_torch.linalg import qr_factor, qr_linsolve, qr_solve
from janus_tpu_torch.solve import SUCCESS
from janus_tpu_torch.solve.radau import solve_radau

torch.set_num_threads(1)

# M y' = f with M = [[0,1],[1,0]]: row0 ⇒ y1' = -y1, row1 ⇒ y0' = y1 - y0.
# A = γ/h·M − J = [[0, γ/h+1], [γ/h+1, -1]]: A[0,0] ≡ 0.
MASS = np.array([[0.0, 1.0], [1.0, 0.0]])
Y0 = np.array([[1.0, 0.5], [0.3, -0.7]])


def _rhs(xp):
    def f(t, y, args):
        return xp.stack([-y[:, 1], y[:, 1] - y[:, 0]], -1)
    return f


def _mixed_rhs(xp):
    """Lane 0: y' = [-y0, -2 y1] on the identity mass (a healthy LU); lane
    1: the permuted system (a broken one)."""
    def f(t, y, args):
        plain = xp.stack([-y[:, 0], -2.0 * y[:, 1]], -1)
        perm = xp.stack([-y[:, 1], y[:, 1] - y[:, 0]], -1)
        lane = xp.arange(y.shape[0])[:, None]
        return xp.where(lane == 0, plain, perm)
    return f


def _exact(t, y0):
    a, b = y0
    return np.array([(a + b * t) * np.exp(-t), b * np.exp(-t)])


def _close(got, ref, what):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-10 * float(np.abs(ref).max()),
                               err_msg=what)


def _both(rhs, mass, okw, tangents=None):
    ref_opts = RefOptions(**okw)
    ref = ref_solve_radau(rhs(jnp), 0.0, 2.0, jnp.asarray(Y0),
                          mass=jnp.asarray(mass), options=ref_opts,
                          tangents=None if tangents is None
                          else jnp.asarray(tangents))
    sol = solve_radau(rhs(torch), 0.0, 2.0, torch.from_numpy(Y0),
                      mass=torch.from_numpy(mass),
                      options=options_from_jax(ref_opts),
                      tangents=None if tangents is None
                      else torch.from_numpy(tangents))
    np.testing.assert_array_equal(sol.status.numpy(), np.asarray(ref.status))
    for k in ref.stats:
        np.testing.assert_array_equal(sol.stats[k].numpy(),
                                      np.asarray(ref.stats[k]), err_msg=k)
    if bool((sol.status == SUCCESS).all()):
        _close(sol.y, ref.y, "y")
        if tangents is not None:
            _close(sol.sens, ref.sens, "sens")
    return sol


def test_pivot_free_lu_fails_structurally():
    sol = _both(_rhs, MASS, dict(rtol=1e-9, atol=1e-12, pivoting=False))
    assert not bool((sol.status == SUCCESS).any())


def test_qr_fallback_rescues_and_matches_exact():
    sol = _both(_rhs, MASS, dict(rtol=1e-9, atol=1e-12, pivoting=False,
                                 qr_fallback=True))
    assert bool((sol.status == SUCCESS).all())
    for i in range(2):
        np.testing.assert_allclose(sol.y[i], _exact(2.0, Y0[i]), rtol=1e-8,
                                   atol=1e-11)


def test_qr_fallback_mixed_batch():
    """The healthy lane never leaves the LU: its y is the fallback-off
    run's to the bit; the broken lane rides QR in the same batch."""
    mass_b = np.stack([np.eye(2), MASS])
    okw = dict(rtol=1e-9, atol=1e-12, pivoting=False, qr_fallback=True)
    sol = _both(_mixed_rhs, mass_b, okw)
    assert bool((sol.status == SUCCESS).all())
    np.testing.assert_allclose(sol.y[0], Y0[0] * np.exp([-2.0, -4.0]),
                               rtol=1e-8)
    np.testing.assert_allclose(sol.y[1], _exact(2.0, Y0[1]), rtol=1e-8,
                               atol=1e-11)
    off = solve_radau(_mixed_rhs(torch), 0.0, 2.0, torch.from_numpy(Y0),
                      mass=torch.from_numpy(mass_b),
                      options=options_from_jax(RefOptions(
                          **{**okw, "qr_fallback": False})))
    assert torch.equal(off.y[0], sol.y[0])


def test_qr_fallback_with_ind_tangents():
    """The stage solvers with QR carry the IND tangent sweeps too."""
    seeds = np.zeros((1, 2, 2))
    seeds[0, :, 0] = 1.0
    sol = _both(_rhs, MASS, dict(rtol=1e-10, atol=1e-13, pivoting=False,
                                 qr_fallback=True), tangents=seeds)
    assert bool((sol.status == SUCCESS).all())
    np.testing.assert_allclose(sol.sens[0, :, 0], np.exp(-2.0), rtol=1e-7)
    np.testing.assert_allclose(sol.sens[0, :, 1], 0.0, atol=1e-9)


def test_qr_fallback_default_off_is_untouched():
    """Flag off, pivoting on: the permuted system solves by pivoting."""
    sol = _both(_rhs, MASS, dict(rtol=1e-9, atol=1e-12, pivoting=True))
    assert bool((sol.status == SUCCESS).all())
    for i in range(2):
        np.testing.assert_allclose(sol.y[i], _exact(2.0, Y0[i]), rtol=1e-8,
                                   atol=1e-11)


@pytest.mark.parametrize("d", [2, 4, 6])
def test_qr_matches_reference(d):
    """qr_factor / qr_solve / qr_linsolve against the reference's on random
    batches (1e-12 relative to the largest entry)."""
    rng = np.random.default_rng(d)
    a = rng.standard_normal((5, d, d))
    b = rng.standard_normal((5, d))
    vs, r = qr_factor(torch.from_numpy(a))
    vs_ref, r_ref = ref_qr.qr_factor(jnp.asarray(a))
    for got, ref in ((vs, vs_ref), (r, r_ref),
                     (qr_solve(vs, r, torch.from_numpy(b)),
                      ref_qr.qr_solve(vs_ref, r_ref, jnp.asarray(b))),
                     (qr_linsolve(torch.from_numpy(a), torch.from_numpy(b)),
                      np.linalg.solve(a, b[..., None])[..., 0])):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-12 * np.abs(ref).max())
