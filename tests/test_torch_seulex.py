"""SEULEX of the port (``solve/seulex.py``) against the JAX reference
``janus_tpu.solve.seulex.solve_seulex``, on the CPU in float64, on the same
inputs made from a numpy seed.

Tolerances: status and all seven counters (nfev, njev, nlu, nsteps,
naccept, nreject, order) equal per lane; t and y to 1e-10 relative to the
array's largest entry; ``sens`` to 1e-7; the t_eval samples, ``quad`` and
the event times to 1e-10; the mesh rings t, h, y to 1e-8 and the accepted
levels equal (on stiff Van der Pol lanes); ``interpolate``, which
evaluates each lane's polynomial on that mesh, to 1e-8. Step sizes amplify
rounding (ROADMAP Queue 3): on the harmonic oscillator at rtol 1e-8 the
error estimates that set h are differences of extrapolation rows a few
hundred ulps wide, and the two packages' meshes part by up to 2.2e-7 in t
(5.6e-6 of it) with the counters equal and y(T) within 1e-14; the
mass-matrix dense case's interpolants then differ by 4e-10.

The reference's ladder unrolls every level, so the cases cap it with
``seulex_kmax`` ≤ 6 (but Robertson to 1e4, at the default 13) and compile
the reference once each; the heavy cases are ``slow``, as the reference's
own SEULEX tests are.

With ``kernel_lu=True`` the port runs the plain twins of the CUDA kernels
K1/K2 on CPU tensors and the reference with ``pallas_lu=True`` its
pivot-free LU off the TPU, the same arithmetic; the port's kernel path also
equals its own plain pivot-free LU path to the bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janus_tpu.solve import Options as RefOptions
from janus_tpu.solve import seulex as ref_sx
from janus_tpu.solve.events import Event as RefEvent
from janus_tpu_torch.interop import options_from_jax
from janus_tpu_torch.solve import Event, Options, solve_ivp
from janus_tpu_torch.solve import seulex as sx

torch.set_num_threads(1)

STATS = ("nfev", "njev", "nlu", "nsteps", "naccept", "nreject", "order")


@pytest.fixture(autouse=True)
def _clear_caches_each_test():
    yield
    jax.clear_caches()


def _vdp(xp):
    def rhs(t, y, mu):
        mu = mu["mu"] if isinstance(mu, dict) else mu
        x, v = y[:, 0], y[:, 1]
        return xp.stack([v, mu * (1.0 - x * x) * v - x], -1)
    return rhs


def _vdp_jac(xp):
    def jac(t, y, mu):
        x, v = y[:, 0], y[:, 1]
        zero = xp.zeros_like(x)
        return xp.stack([xp.stack([zero, zero + 1.0], -1),
                         xp.stack([-2.0 * mu * x * v - 1.0,
                                   mu * (1.0 - x * x)], -1)], -2)
    return jac


def _slab_vdp(xp):
    """VdP with a per-step slab added to μ: f(t, y, (μ, slab))."""
    def rhs(t, y, a):
        mu, slab = a
        return _vdp(xp)(t, y, mu + slab[..., 0])
    return rhs


def _harmonic(xp):
    def rhs(t, y, w):
        return xp.stack([y[:, 1], -(w * w) * y[:, 0]], -1)
    return rhs


def _robertson(xp):
    def rhs(t, y, a):
        d1 = -0.04 * y[:, 0] + 1e4 * y[:, 1] * y[:, 2]
        d3 = 3e7 * y[:, 1] ** 2
        return xp.stack([d1, -d1 - d3, d3], -1)
    return rhs


def _square(xp):
    """y' = y², blowing up at t = 1/y0: the explosive start."""
    return lambda t, y, a: y * y


def _dae(xp):
    """Index-1: y0' = −y0, 0 = y1 − y0² (mass diag(1, 0))."""
    return lambda t, y, a: xp.stack([-y[:, 0], y[:, 1] - y[:, 0] ** 2], -1)


def _damped(xp):
    """A damped oscillator under an invertible mass."""
    return lambda t, y, a: xp.stack([y[:, 1], -a * y[:, 0] - 0.2 * y[:, 1]],
                                    -1)


def _vdp_y0(m):
    rng = np.random.default_rng(9)
    return np.tile([[2.0, 0.0]], (m, 1)) + 0.1 * rng.standard_normal((m, 2))


def _quad(xp):
    return lambda t, y, a: xp.stack([y[:, 0] ** 2, t * y[:, 1]], -1)


def _event(xp):
    cls = RefEvent if xp is jnp else Event
    return cls(lambda t, y, a: y[..., 0], terminal=True, direction=-1.0)


def _unit_seeds(m):
    return np.stack([np.tile(np.eye(2)[j], (m, 1)) for j in range(2)])


# name -> (problem, t0, tf, inputs () -> (y0, args), keywords (xp) -> dict,
# Options keywords)
_K6 = dict(seulex_kmax=6)
CASES = {
    "robertson": (
        _robertson, 0.0, 100.0,
        lambda: (np.array([[1.0, 0.0, 0.0], [0.9, 1e-5, 0.1]]), None),
        lambda xp: {}, dict(rtol=1e-6, atol=1e-10, **_K6)),
    "explosive-start": (
        _square, 0.0, 0.999, lambda: (np.array([[1.0], [0.9]]), None),
        lambda xp: {}, dict(rtol=1e-6, atol=1e-9, **_K6)),
    "mass-dae": (
        _dae, 0.0, 1.0,
        lambda: (np.array([[1.0, 1.0], [0.5, 0.25]]), None),
        lambda xp: dict(mass=xp.asarray(np.diag([1.0, 0.0]))),
        dict(rtol=1e-8, atol=1e-11, **_K6)),
    "events-t_eval-quad": (
        _harmonic, 0.0, 10.0,
        lambda: (np.array([[1.0, 0.0], [2.0, 0.3]]), np.array([1.0, 1.5])),
        lambda xp: dict(events=_event(xp),
                        t_eval=xp.asarray(np.linspace(0.0, 3.0, 7)),
                        quad=_quad(xp)),
        dict(rtol=1e-8, atol=1e-11, **_K6)),
    "ind-kernel-analytic-jac": (
        _vdp, 0.0, 1.0, lambda: (_vdp_y0(2), np.array([1000.0, 300.0])),
        lambda xp: dict(jac=_vdp_jac(xp),
                        tangents=xp.asarray(_unit_seeds(2))),
        dict(rtol=1e-6, atol=1e-9, pivoting=False, pallas_lu=True, **_K6)),
}
REVERSE_TIME = (
    _harmonic, 2.0, 0.0,
    lambda: (np.array([[np.cos(2.0), -np.sin(2.0)], [1.0, 0.5]]), 1.0),
    lambda xp: {}, dict(rtol=1e-8, atol=1e-11, **_K6))
HETEROGENEOUS = (
    _vdp, 0.0, 2.0,
    lambda: (np.tile([[2.0, 0.0]], (4, 1)),
             np.array([1.0, 10.0, 100.0, 1000.0])),
    lambda xp: dict(dense=64), dict(rtol=1e-6, atol=1e-9, **_K6))
CASES_SLOW = {
    "heterogeneous-mu-dense": HETEROGENEOUS,
    "reverse-time": REVERSE_TIME,
    "ind-mass": (
        _damped, 0.0, 3.0, lambda: (np.array([[1.0, 0.0], [0.5, 0.2]]), 1.7),
        lambda xp: dict(mass=xp.asarray(np.array([[2.0, 0.3], [0.1, 1.5]])),
                        tangents=xp.asarray(_unit_seeds(2))),
        dict(rtol=1e-9, atol=1e-12, **_K6)),
    "robertson-long": (
        _robertson, 0.0, 1e4, lambda: (np.array([[1.0, 0.0, 0.0]]), None),
        lambda xp: {}, dict(rtol=1e-7, atol=1e-12)),
    "ind-args-tangents": (
        _vdp, 0.0, 1.0,
        lambda: (_vdp_y0(3), {"mu": np.array([50.0, 200.0, 5.0])}),
        lambda xp: dict(
            tangents=xp.asarray(np.stack([np.tile([1.0, 0.0], (3, 1)),
                                          np.zeros((3, 2))])),
            args_tangents={"mu": xp.asarray(np.stack([np.zeros(3),
                                                      np.ones(3)]))}),
        dict(rtol=1e-9, atol=1e-12, **_K6)),
    "dense-mass": (
        lambda xp: (lambda t, y, a: 2.0 * _harmonic(xp)(t, y, a)), 0.0, 3.0,
        lambda: (np.array([[1.0, 0.0]]), 1.0),
        lambda xp: dict(mass=xp.asarray(2.0 * np.eye(2)), dense=256),
        dict(rtol=1e-8, atol=1e-11, **_K6)),
}


def _close(got, ref, tol, what):
    ref = np.asarray(ref)
    got = got.numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref), err_msg=what)
    np.testing.assert_allclose(
        got, ref, rtol=0, atol=tol * max(float(np.nanmax(np.abs(ref))), 1e-300),
        err_msg=what)


def _args(a, xp):
    if isinstance(a, dict):
        return {k: _args(v, xp) for k, v in a.items()}
    if isinstance(a, tuple):
        return tuple(_args(v, xp) for v in a)
    if isinstance(a, np.ndarray):
        return jnp.asarray(a) if xp is jnp else torch.from_numpy(a)
    return a


def _solves(case, **extra):
    prob, t0, tf, inputs, kw, okw = case
    y0, args = inputs()
    ref_opts = RefOptions(**okw)
    ref = ref_sx.solve_seulex(prob(jnp), t0, tf, jnp.asarray(y0),
                              _args(args, jnp), ref_opts, **kw(jnp),
                              **_args(extra, jnp))
    got = sx.solve_seulex(prob(torch), t0, tf, torch.from_numpy(y0),
                          _args(args, torch), options_from_jax(ref_opts),
                          **kw(torch), **_args(extra, torch))
    return ref, got


def _compare(got, ref, tol=1e-10):
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    for k in STATS:
        np.testing.assert_array_equal(got.stats[k].numpy(),
                                      np.asarray(ref.stats[k]), err_msg=k)
    for k, tk in (("t", tol), ("y", tol), ("ys", tol), ("quad", tol),
                  ("event_t", tol), ("sens", 1e-7)):
        r = getattr(ref, k)
        assert (r is None) == (getattr(got, k) is None), k
        if r is not None:
            _close(getattr(got, k), r, tk, k)
    if ref.event_idx is not None:
        np.testing.assert_array_equal(got.event_idx.numpy(),
                                      np.asarray(ref.event_idx))


def _check_case(case):
    ref, got = _solves(case)
    assert bool(((got.status == 1) | (got.status == 5)).all())
    _compare(got, ref)
    # one sync an attempt, one a level climbed past level 0
    assert sx.solve_seulex.host_syncs >= int(got.stats["nsteps"].max())
    if got.mesh is not None:
        ts = np.linspace(0.05, 2.95, 11)
        _close(got.interpolate(torch.from_numpy(ts)),
               ref.interpolate(jnp.asarray(ts)), 1e-8, "interpolate")


@pytest.mark.parametrize("name", list(CASES))
def test_solve_seulex_matches_reference(name):
    _check_case(CASES[name])


@pytest.mark.slow
@pytest.mark.parametrize("name", list(CASES_SLOW))
def test_solve_seulex_matches_reference_slow(name):
    _check_case(CASES_SLOW[name])


def test_dense_interpolate_equals_t_eval():
    """dense= stores the interpolant the t_eval samples evaluate: the two
    routes agree, queries beyond the span clamp to it, and a lane whose
    steps overflow the ring interpolates to NaN (the port alone)."""
    y0 = torch.from_numpy(_vdp_y0(3))
    mu = torch.tensor([5.0, 100.0, 800.0], dtype=torch.float64)
    ts = torch.linspace(0.1, 2.0, 13, dtype=torch.float64)
    for kw, rhs in ((dict(), _vdp(torch)),
                    (dict(mass=torch.eye(2, dtype=torch.float64) * 2.0),
                     lambda t, y, a: 2.0 * _vdp(torch)(t, y, a))):
        opts = Options(rtol=1e-7, atol=1e-10, seulex_kmax=6)
        s_d = solve_ivp(rhs, (0.0, 2.0), y0, method="seulex", args=mu,
                        options=opts, dense=256, **kw)
        s_t = solve_ivp(rhs, (0.0, 2.0), y0, method="seulex", args=mu,
                        options=opts, t_eval=ts, **kw)
        assert bool((s_d.status == 1).all())
        torch.testing.assert_close(s_d.interpolate(ts), s_t.ys, rtol=0,
                                   atol=1e-13)
        ye = s_d.interpolate(torch.tensor([2.0, 99.0], dtype=torch.float64))
        # the polynomial at θ = 1 sums its powers: y(T) to rounding
        torch.testing.assert_close(ye, s_d.y[:, None, :].expand_as(ye),
                                   rtol=0, atol=1e-13)
    over = solve_ivp(_vdp(torch), (0.0, 2.0), y0, method="seulex", args=mu,
                     options=opts, dense=4)
    assert bool(torch.isnan(over.interpolate(ts)).all())


@pytest.mark.slow
def test_step_args_match_reference():
    """step_args: slab row k drives a lane's k-th accepted-step attempt;
    the lane that runs out fails with PARAMS_EXHAUSTED."""
    rng = np.random.default_rng(12)
    y0 = _vdp_y0(2)
    slabs = rng.uniform(0.0, 2.0, (40, 2, 1))
    slabs[:, 1] = rng.uniform(0.0, 0.5, (40, 1))
    ro = RefOptions(rtol=1e-5, atol=1e-8, seulex_kmax=6)
    ref = ref_sx.solve_seulex(_slab_vdp(jnp), 0.0, 3.0, jnp.asarray(y0),
                              jnp.asarray([5.0, 20.0]), ro,
                              step_args=jnp.asarray(slabs))
    got = sx.solve_seulex(_slab_vdp(torch), 0.0, 3.0, torch.from_numpy(y0),
                          torch.tensor([5.0, 20.0], dtype=torch.float64),
                          options_from_jax(ro),
                          step_args=torch.from_numpy(slabs))
    _compare(got, ref)
    assert int(got.stats["naccept"].max()) > 5


def test_mesh_rings_match_reference():
    """The adjoint's recording on heterogeneous μ (the lanes settle at
    different target levels), with dense=: _force_jac refreshes J at every
    new step point; per accepted step t, h, y and the accepted level, and
    the interpolant. The levels are equal; t, h and y are held within ten
    times the port's own spread under a one-ulp change of y0 (plus 1e-8):
    the controller amplifies a one-ulp difference in the error estimate to
    1e-8..1e-5 of h within a few steps, in either package (ROADMAP Queue
    3)."""
    case = HETEROGENEOUS
    ref, got = _solves(case, _mesh_size=64, _force_jac=True)
    _compare(got, ref)
    ts = np.linspace(0.05, 1.95, 11)
    _close(got.interpolate(torch.from_numpy(ts)),
           ref.interpolate(jnp.asarray(ts)), 1e-8, "interpolate")
    np.testing.assert_array_equal(got.stats["njev"].numpy(),
                                  got.stats["naccept"].numpy())
    np.testing.assert_array_equal(got.mesh["k"].numpy(),
                                  np.asarray(ref.mesh["k"]))
    assert int(got.mesh["k"].max()) >= 3
    y0, mu = case[3]()
    nudged = sx.solve_seulex(_vdp(torch), 0.0, 2.0,
                             torch.from_numpy(np.nextafter(y0, 3.0)),
                             torch.from_numpy(mu),
                             options_from_jax(RefOptions(**case[5])),
                             _mesh_size=64, _force_jac=True)
    for key in ("t", "h", "y"):
        a, r = got.mesh[key].numpy(), np.asarray(ref.mesh[key])
        spread = np.abs(a - nudged.mesh[key].numpy())
        assert np.all(np.abs(a - r) <= 10.0 * spread
                      + 1e-8 * np.abs(r).max()), key


def test_kernel_lu_equals_plain_lu():
    """kernel_lu=True (the twins of K1/K2 on CPU tensors) and the plain
    pivot-free LU: the same arithmetic, equal to the bit, tangents too."""
    y0 = torch.from_numpy(_vdp_y0(3))
    mus = torch.tensor([1000.0, 50.0, 5.0], dtype=torch.float64)
    seeds = torch.from_numpy(_unit_seeds(3))
    opts = Options(rtol=1e-6, atol=1e-9, pivoting=False, seulex_kmax=8)
    a, b = (solve_ivp(_vdp(torch), (0.0, 1.0), y0, method="seulex",
                      args=mus, options=opts.replace(kernel_lu=k),
                      tangents=seeds)
            for k in (False, True))
    for k in ("t", "y", "sens", "status"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    for k in STATS:
        assert torch.equal(a.stats[k], b.stats[k]), k


def test_helpers_match_reference():
    for kmax in (4, 6, 13):
        assert sx._nseq(kmax) == ref_sx._nseq(kmax)
    np.testing.assert_array_equal(sx._QI, ref_sx._QI)
    for name in ("STEPFAC1", "STEPFAC2", "STEPFAC3", "STEPFAC4", "STEPFAC5",
                 "KFAC1", "KFAC2", "COST_FUNC", "COST_JAC", "COST_LU",
                 "COST_SOLVE"):
        assert getattr(sx, name) == getattr(ref_sx, name), name


def test_raises():
    y0 = torch.zeros((1, 2), dtype=torch.float64)
    seeds = torch.zeros((1, 1, 2), dtype=torch.float64)

    def f(t, y, a):
        return -y

    for kw in (dict(t_eval=np.array([0.5, 1.0])),
               dict(events=Event(lambda t, y, a: y[..., 0] - 0.5))):
        with pytest.raises(ValueError,
                           match="terminal-mode.*torch.func.jvp") as err:
            solve_ivp(f, (0.0, 1.0), y0, method="seulex", tangents=seeds,
                      **kw)
        assert "jax" not in str(err.value)
    with pytest.raises(ValueError, match="pivoting=False"):
        solve_ivp(f, (0.0, 1.0), y0, method="seulex", kernel_lu=True)
    with pytest.raises(ValueError, match="nind2/nind3"):
        solve_ivp(f, (0.0, 1.0), y0, method="seulex", nind2=1)
    with pytest.raises(ValueError, match="tangents"):
        solve_ivp(f, (0.0, 1.0), y0, method="seulex", tangents=seeds,
                  step_args=torch.zeros((4, 1)))
    with pytest.raises(ValueError, match="discrete adjoint"):
        sx.solve_seulex(f, 0.0, 1.0, y0, step_args=torch.zeros((4, 1)),
                        _mesh_size=8)
