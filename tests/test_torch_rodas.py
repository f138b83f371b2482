"""RODAS4 of the port (``solve/rodas.py``) against the JAX reference, on the
CPU in float64, on the same inputs from a numpy seed.

Tolerances: status and all six counters (naccept, nreject, nsteps, njev,
nlu, nfev) equal per lane; t, y, the t_eval samples, ``interpolate`` and
``quad`` to 1e-10 and ``sens`` to 1e-9, each relative to the array's
largest entry. A Rosenbrock step has no iteration, so the two packages'
meshes agree to ~1e-15 here (measured) and these bounds are loose.

With ``kernel_lu=True`` the port runs the plain twins of the CUDA kernels
K1/K2 on CPU tensors and the reference with ``pallas_lu=True`` its
pivot-free jnp LU off the TPU, the same arithmetic; the port's kernel path
also equals its own plain pivot-free LU path to the bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janus_tpu.solve import Options as RefOptions
from janus_tpu.solve.rodas import solve_rodas as ref_solve_rodas
from janus_tpu_torch.interop import options_from_jax
from janus_tpu_torch.solve import Options, solve_ivp
from janus_tpu_torch.solve.rodas import solve_rodas

torch.set_num_threads(1)

STATS = ("naccept", "nreject", "nsteps", "njev", "nlu", "nfev")


@pytest.fixture(autouse=True)
def _clear_caches_each_test():
    yield
    jax.clear_caches()


def _vdp(xp):
    def rhs(t, y, mu):
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


def _robertson(xp):
    def rhs(t, y, k):
        a, b, c = 0.04, 1e4, 3e7
        d1 = -a * y[:, 0] + b * y[:, 1] * y[:, 2]
        d3 = c * y[:, 1] ** 2
        return xp.stack([d1, -d1 - d3, d3], -1)
    return rhs


def _dae(xp):
    """y1' = −y1, 0 = y2 − y1² (mass diag(1, 0))."""
    def rhs(t, y, k):
        return xp.stack([-k * y[:, 0], y[:, 1] - y[:, 0] ** 2], -1)
    return rhs


def _forced(xp):
    """Non-autonomous: the jvp in t (f_t) is not zero."""
    def rhs(t, y, mu):
        x, v = y[:, 0], y[:, 1]
        return xp.stack([v, mu * (1.0 - x * x) * v - x + xp.sin(3.0 * t)],
                        -1)
    return rhs


def _vdp_inputs(m=4):
    rng = np.random.default_rng(11)
    y0 = np.tile([[2.0, 0.0]], (m, 1)) + 0.1 * rng.standard_normal((m, 2))
    mus = np.geomspace(3.0, 100.0, m)
    seeds = np.stack([np.tile(np.eye(2)[j], (m, 1)) for j in range(2)])
    dmus = np.stack([mus * 1e-2, rng.standard_normal(m)])
    return y0, mus, seeds, dmus


def _cost(xp):
    return lambda t, y, mu: xp.stack([y[:, 0] ** 2 + 0.1 * mu * y[:, 1] ** 2,
                                      t * y[:, 0]], -1)


# name -> (problem, t0, tf, inputs () -> (y0, args), keywords (xp) -> dict,
# reference Options keywords)
_TIGHT = dict(rtol=1e-6, atol=1e-9)
CASES = {
    "vdp-ind-pivot": (
        _vdp, 0.0, 1.0, lambda: _vdp_inputs()[:2],
        lambda xp: dict(tangents=xp.asarray(_vdp_inputs()[2]),
                        args_tangents=xp.asarray(_vdp_inputs()[3])), _TIGHT),
    "vdp-ind-kernel-jac": (
        _vdp, 0.0, 1.0, lambda: _vdp_inputs()[:2],
        lambda xp: dict(jac=_vdp_jac(xp),
                        tangents=xp.asarray(_vdp_inputs()[2])),
        dict(pivoting=False, pallas_lu=True, **_TIGHT)),
    "forced-t_eval-quad-dense": (
        _forced, 0.0, 1.5, lambda: _vdp_inputs(3)[:2],
        lambda xp: dict(t_eval=xp.asarray(np.linspace(0.0, 1.5, 7)),
                        quad=_cost(xp), dense=256), _TIGHT),
    "mass-dae-index1": (
        _dae, 0.0, 1.0, lambda: (np.array([[1.0, 1.0], [0.5, 0.25]]),
                                 np.array([1.0, 2.0])),
        lambda xp: dict(mass=xp.asarray(np.diag([1.0, 0.0]))),
        dict(rtol=1e-8, atol=1e-11)),
    "robertson": (
        _robertson, 0.0, 100.0,
        lambda: (np.array([[1.0, 0.0, 0.0], [0.9, 0.0, 0.1]]), None),
        lambda xp: {}, dict(rtol=1e-7, atol=1e-11)),
    "reverse-time": (
        _vdp, 1.0, 0.0, lambda: (_vdp_inputs(3)[0], np.array([1.0, 2.0, 3.0])),
        lambda xp: dict(tangents=xp.asarray(_vdp_inputs(3)[2])), _TIGHT),
}


def _close(got, ref, tol, what):
    ref = np.asarray(ref)
    got = got.numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref), err_msg=what)
    np.testing.assert_allclose(
        got, ref, rtol=0, atol=tol * max(float(np.nanmax(np.abs(ref))), 1e-300),
        err_msg=what)


def _compare(got, ref):
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    for k in STATS:
        np.testing.assert_array_equal(got.stats[k].numpy(),
                                      np.asarray(ref.stats[k]), err_msg=k)
    for k, tol in (("t", 1e-10), ("y", 1e-10), ("ys", 1e-10),
                   ("quad", 1e-10), ("sens", 1e-9)):
        r = getattr(ref, k)
        assert (r is None) == (getattr(got, k) is None), k
        if r is not None:
            _close(getattr(got, k), r, tol, k)


def _solves(name):
    prob, t0, tf, inputs, kw, okw = CASES[name]
    y0, args = inputs()
    ref_opts = RefOptions(**okw)
    ref = ref_solve_rodas(prob(jnp), t0, tf, jnp.asarray(y0),
                          None if args is None else jnp.asarray(args),
                          ref_opts, **kw(jnp))
    got = solve_rodas(prob(torch), t0, tf, torch.from_numpy(y0),
                      None if args is None else torch.from_numpy(args),
                      options_from_jax(ref_opts), **kw(torch))
    return ref, got


@pytest.mark.parametrize("name", list(CASES))
def test_solve_rodas_matches_reference(name):
    ref, got = _solves(name)
    assert bool((got.status == 1).all())
    _compare(got, ref)
    assert solve_rodas.host_syncs >= int(got.stats["nsteps"].max())
    if got.mesh is not None:
        # the CONTRO cubic stored per step: interpolate() anywhere
        ts = np.linspace(0.05, 1.45, 11)
        _close(got.interpolate(torch.from_numpy(ts)),
               ref.interpolate(jnp.asarray(ts)), 1e-10, "interpolate")
        # and on the t_eval grid the two routes give the same samples
        torch.testing.assert_close(got.interpolate(got.ts), got.ys,
                                   rtol=0, atol=1e-13)


def test_kernel_lu_equals_plain_lu():
    """kernel_lu=True (the twins of K1/K2 on CPU tensors) and the plain
    pivot-free LU: the same arithmetic, equal to the bit, tangents too."""
    y0, mus, seeds, dmus = (torch.from_numpy(a) for a in _vdp_inputs())
    opts = Options(rtol=1e-6, atol=1e-9, pivoting=False)
    a, b = (solve_ivp(_vdp(torch), (0.0, 1.0), y0, method="rodas", args=mus,
                      options=opts.replace(kernel_lu=k), tangents=seeds,
                      args_tangents=dmus) for k in (False, True))
    for k in ("t", "y", "sens", "status"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    for k in STATS:
        assert torch.equal(a.stats[k], b.stats[k]), k


def test_rodas_raises():
    y0 = torch.tensor([[2.0, 0.0]], dtype=torch.float64)
    seeds = torch.ones((1, 1, 2), dtype=torch.float64)
    with pytest.raises(ValueError, match="nind2/nind3"):
        solve_rodas(_vdp(torch), 0.0, 1.0, y0, 1.0, Options(nind2=1))
    with pytest.raises(ValueError, match="terminal-mode only"):
        solve_rodas(_vdp(torch), 0.0, 1.0, y0, 1.0, tangents=seeds,
                    t_eval=np.array([0.5, 1.0]))
    with pytest.raises(ValueError, match="terminal-mode only"):
        solve_rodas(_vdp(torch), 0.0, 1.0, y0, 1.0, tangents=seeds,
                    events=lambda t, y, a: y[:, 0])
    with pytest.raises(ValueError, match="pivoting=False"):
        solve_rodas(_vdp(torch), 0.0, 1.0, y0, 1.0, Options(kernel_lu=True))
    # step_args= has one contract with radau (tests/test_torch_step_args.py)
    with pytest.raises(ValueError, match="step_args= does not compose"):
        solve_ivp(_vdp(torch), (0.0, 1.0), y0, method="rodas", args=1.0,
                  step_args=torch.ones((3, 1), dtype=torch.float64),
                  tangents=seeds)
