"""The port's problem library (``janus_tpu_torch.models.problems``) against
the JAX reference's, and its stiff and non-stiff cases through the ported
families against scipy; the twin of ``tests/test_problem_library.py``.

Each right-hand side (and Hamiltonian) gets the same numpy-seeded inputs in
both packages and is held to the reference's within 1e-14 relative to the
largest entry; the constants are equal. The integrations are held to scipy
at the reference test's bounds. The port runs them eagerly: OREGO (3,216
radau steps) takes ~70 s and HIRES ~18 s on one CPU core, Robertson and the
Brusselator 4-6 s, so those four are ``slow``; E5 and Pleiades run in the
fast tier.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.integrate import solve_ivp as ss

from janus_tpu.models import problems as R
from janus_tpu_torch.models import problems as P
from janus_tpu_torch.solve import SUCCESS, solve_ivp

torch.set_num_threads(1)


def close(got, want, tol=1e-14):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(float(np.abs(want).max()),
                                              1e-300))


def _args(name, xp):
    if name == "dubins_rhs":
        return {"v": 1.3, "u": 0.4}
    if name == "dubins_rhs_callable":
        return {"v": 1.3, "u": lambda t: xp.sin(t)}
    if name == "dubins_pmp_rhs":
        return {"v": 1.3, "umax": 0.8, "eps": 0.05}
    if name == "brusselator_rhs":
        return {"a": 1.1, "b": 2.7}
    if name == "brusselator_rhs_scalar":
        return 2.5
    return None


RHS = {"dubins_rhs": 3, "dubins_rhs_callable": 3, "dubins_pmp_rhs": 6,
       "brusselator_rhs": 2, "brusselator_rhs_scalar": 2, "pleiades_rhs": 28,
       "hires_rhs": 8, "orego_rhs": 3, "e5_rhs": 4}


@pytest.mark.parametrize("name", sorted(RHS))
def test_rhs_matches_reference(rng, name):
    fn = name.replace("_callable", "").replace("_scalar", "")
    y = rng.standard_normal((6, RHS[name]))
    t = rng.uniform(0.0, 2.0, 6)
    want = getattr(R, fn)(jnp.asarray(t), jnp.asarray(y), _args(name, jnp))
    got = getattr(P, fn)(torch.from_numpy(t), torch.from_numpy(y),
                         _args(name, torch))
    close(got, want)


@pytest.mark.parametrize("name", ["harmonic_hamiltonian", "vdp_hamiltonian"])
def test_hamiltonians_match_reference(rng, name):
    x, p = rng.standard_normal(2 if name == "vdp_hamiltonian" else 1), \
        rng.standard_normal(2 if name == "vdp_hamiltonian" else 1)
    for args in (1.7, {"omega": 1.7, "mu": 1.7}):
        want = getattr(R, name)(jnp.asarray(x), jnp.asarray(p), args)
        got = getattr(P, name)(torch.from_numpy(x), torch.from_numpy(p),
                               args)
        close(got, want)


def test_constants_match_reference():
    for name in ("HIRES_Y0", "HIRES_TF", "OREGO_Y0", "OREGO_TF", "E5_Y0",
                 "E5_TF"):
        assert getattr(P, name) == getattr(R, name), name


def _scipy(f, tf, y0, **kw):
    return ss(lambda t, y: f(t, torch.from_numpy(y)[None, :], None)[0]
              .numpy(), (0.0, tf), list(y0), **kw).y[:, -1]


@pytest.mark.slow
def test_robertson_long_horizon():
    ref = ss(lambda t, y: [-0.04 * y[0] + 1e4 * y[1] * y[2],
                           0.04 * y[0] - 1e4 * y[1] * y[2] - 3e7 * y[1] ** 2,
                           3e7 * y[1] ** 2],
             (0.0, 1e4), [1.0, 0.0, 0.0], method="Radau",
             rtol=1e-9, atol=1e-13)
    sol = solve_ivp(P.robertson_rhs, (0.0, 1e4),
                    torch.tensor([[1.0, 0.0, 0.0]], dtype=torch.float64),
                    method="radau", rtol=1e-7, atol=1e-11)
    assert int(sol.status[0]) == SUCCESS
    np.testing.assert_allclose(sol.y[0].numpy(), ref.y[:, -1], rtol=1e-3,
                               atol=1e-9)
    np.testing.assert_allclose(float(sol.y[0].sum()), 1.0, rtol=1e-9)


@pytest.mark.slow
def test_brusselator_limit_cycle():
    ref = ss(lambda t, y: [1 + y[0] ** 2 * y[1] - 4 * y[0],
                           3 * y[0] - y[0] ** 2 * y[1]],
             (0.0, 10.0), [1.5, 3.0], method="Radau", rtol=1e-10, atol=1e-13)
    sol = solve_ivp(P.brusselator_rhs, (0.0, 10.0),
                    torch.tensor([[1.5, 3.0]], dtype=torch.float64),
                    method="radau", args={"a": 1.0, "b": 3.0},
                    rtol=1e-8, atol=1e-11)
    np.testing.assert_allclose(sol.y[0].numpy(), ref.y[:, -1], rtol=1e-5,
                               atol=1e-7)


def test_pleiades_explicit():
    """The 7-body problem with dopri853 against scipy's DOP853."""
    q0 = np.array([3.0, 3.0, -1.0, -3.0, 2.0, -2.0, 2.0,
                   3.0, -3.0, 2.0, 0.0, 0.0, -4.0, 4.0])
    v0 = np.array([0.0, 0.0, 0.0, 0.0, 0.0, 1.75, -1.5,
                   0.0, 0.0, 0.0, -1.25, 1.0, 0.0, 0.0])
    y0 = np.concatenate([q0, v0])
    ref = _scipy(P.pleiades_rhs, 1.0, y0, method="DOP853", rtol=1e-10,
                 atol=1e-12)
    sol = solve_ivp(P.pleiades_rhs, (0.0, 1.0), torch.from_numpy(y0)[None],
                    method="dopri853", rtol=1e-10, atol=1e-12)
    assert int(sol.status[0]) == SUCCESS
    np.testing.assert_allclose(sol.y[0].numpy(), ref, rtol=1e-7, atol=1e-8)


@pytest.mark.slow
def test_hires_vs_scipy():
    """HIRES over its full horizon through the variable-order radaup."""
    ref = _scipy(P.hires_rhs, P.HIRES_TF, P.HIRES_Y0, method="Radau",
                 rtol=1e-10, atol=1e-12)
    sol = solve_ivp(P.hires_rhs, (0.0, P.HIRES_TF),
                    torch.tensor([P.HIRES_Y0], dtype=torch.float64),
                    method="radaup", rtol=1e-8, atol=1e-10)
    assert int(sol.status[0]) == SUCCESS
    np.testing.assert_allclose(sol.y[0].numpy(), ref, rtol=1e-4, atol=1e-8)


@pytest.mark.slow
def test_orego_vs_scipy():
    """The Oregonator's limit cycle through fixed-order radau."""
    ref = _scipy(P.orego_rhs, P.OREGO_TF, P.OREGO_Y0, method="Radau",
                 rtol=1e-10, atol=1e-12)
    sol = solve_ivp(P.orego_rhs, (0.0, P.OREGO_TF),
                    torch.tensor([P.OREGO_Y0], dtype=torch.float64),
                    method="radau", rtol=1e-8, atol=1e-10)
    assert int(sol.status[0]) == SUCCESS
    np.testing.assert_allclose(sol.y[0].numpy(), ref, rtol=5e-4, atol=1e-8)


def test_e5_short_horizon_vs_scipy():
    """E5 on its shortened horizon through seulex: per-component error
    weighting with atol far below every state scale."""
    ref = _scipy(P.e5_rhs, P.E5_TF, P.E5_Y0, method="Radau", rtol=1e-11,
                 atol=1e-22)
    sol = solve_ivp(P.e5_rhs, (0.0, P.E5_TF),
                    torch.tensor([P.E5_Y0], dtype=torch.float64),
                    method="seulex", rtol=1e-9, atol=1e-20)
    assert int(sol.status[0]) == SUCCESS
    np.testing.assert_allclose(sol.y[0].numpy(), ref, rtol=1e-4, atol=1e-25)
