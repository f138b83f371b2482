"""Per-accepted-step parameter slabs (``step_args=``) and the step log
(``Options(record_steps=)``) in the port, on the CPU in float64.

Against the JAX package in the same process, on the same inputs: status and
every counter equal per lane, y within 1e-10 relative to its largest entry,
and the ``record_steps`` buffers: the iteration counts, accept flags and
write index equal, t and h within 1e-8 relative to their largest entry (the
step-mesh bound of ``tests/test_torch_dense_quad.py``: step sizes amplify
rounding), and the error norm, in units of the tolerance, within 1e-6
absolute (an estimate far below 1 is rounding noise of the stages: on the
forcing problems below, whose steps are exact, every estimate is). Against
the port itself: constant slab rows reproduce the plain run to the bit on
radau, rodas, dopri5 and dopri853, a lane that runs out of rows stops with
PARAMS_EXHAUSTED after exactly S accepted steps (with y equal to the
reference's where the step control acts on estimates above rounding noise),
and radau and rodas share
one contract for what does not compose with step_args (that test does not
compare against the reference, whose rodas guard differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jvp

from janus_tpu.solve import Options as RefOptions
from janus_tpu.solve import solve_ivp as ref_solve_ivp
from janus_tpu_torch.interop import options_from_jax
from janus_tpu_torch.solve import (PARAMS_EXHAUSTED, SUCCESS, Options,
                                   solve_ivp)
from janus_tpu_torch.solve.radau import STEP_ARGS_GUARD, solve_radau
from janus_tpu_torch.solve.rodas import solve_rodas

torch.set_num_threads(1)

METHODS = ["dopri5", "dopri853", "rodas", "radau"]


def _vdp(xp):
    def rhs(t, y, a):
        mu = a[0] * a[1] if isinstance(a, tuple) else a
        x, v = y[..., 0], y[..., 1]
        return xp.stack([v, mu * (1 - x * x) * v - x], -1)
    return rhs


def _forcing(xp):
    """ydot = u, the lane's current slab row."""
    def rhs(t, y, a):
        _, u = a
        return u[:, None] + 0.0 * y
    return rhs


def _close(got, ref, what, tol=1e-10):
    ref = np.asarray(ref)
    got = got.numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref), err_msg=what)
    np.testing.assert_allclose(got, ref, rtol=0, equal_nan=True,
                               atol=tol * float(np.nanmax(np.abs(ref))),
                               err_msg=what)


def _dyn_close(got, ref):
    assert set(got) == set(ref)
    for k, buf in ref.items():
        buf = np.asarray(buf)
        if k == "err":
            np.testing.assert_allclose(got[k].numpy(), buf, rtol=0,
                                       atol=1e-6, equal_nan=True)
        elif buf.dtype.kind == "f":
            _close(got[k], buf, f"dyn[{k}]", tol=1e-8)
        else:
            np.testing.assert_array_equal(got[k].numpy(), buf, err_msg=k)


def _both(rhs, method, tf, y0, args, slabs, opts, y_tol=1e-10):
    """The slabbed solve through both packages, held equal (y_tol=None:
    status and counters only); returns the port's."""
    ref = ref_solve_ivp(rhs(jnp), (0.0, tf), jnp.asarray(y0), method=method,
                        args=None if args is None else jnp.asarray(args),
                        options=RefOptions(**opts),
                        step_args=jnp.asarray(slabs))
    sol = solve_ivp(rhs(torch), (0.0, tf), torch.from_numpy(y0),
                    method=method,
                    args=None if args is None else torch.from_numpy(args),
                    options=options_from_jax(RefOptions(**opts)),
                    step_args=torch.from_numpy(slabs))
    np.testing.assert_array_equal(sol.status.numpy(), np.asarray(ref.status))
    for k in ref.stats:
        np.testing.assert_array_equal(sol.stats[k].numpy(),
                                      np.asarray(ref.stats[k]), err_msg=k)
    if y_tol is not None:
        _close(sol.y, ref.y, "y", tol=y_tol)
    if ref.dyn is not None:
        _dyn_close(sol.dyn, ref.dyn)
    return sol


def _mus(method):
    # the explicit pairs on a nonstiff batch, the stiff solvers on a stiff one
    return (np.array([0.5, 2.0]), 2.0) if method.startswith("dopri") \
        else (np.array([5.0, 50.0]), 1.0)


@pytest.mark.parametrize("method", METHODS)
def test_constant_slabs_match_plain_run_and_reference(method):
    """Rows all 1: the plain run to the bit (same mesh, same stages; every
    counter equal but nfev, where dopri re-evaluates stage 0), and the
    reference's slabbed run."""
    mu, tf = _mus(method)
    y0 = np.tile([[2.0, 0.0]], (2, 1))
    opts = dict(rtol=1e-7, atol=1e-10)
    sol = _both(_vdp, method, tf, y0, mu, np.ones(512), opts)
    plain = solve_ivp(_vdp(torch), (0.0, tf), torch.from_numpy(y0),
                      method=method, args=torch.from_numpy(mu),
                      options=Options(**opts))
    assert bool((sol.status == SUCCESS).all())
    assert torch.equal(sol.y, plain.y) and torch.equal(sol.t, plain.t)
    for k in plain.stats:
        if k != "nfev":
            assert torch.equal(sol.stats[k], plain.stats[k]), k


@pytest.mark.parametrize("method", METHODS)
def test_exhaustion_status(method):
    """3 rows for a span that takes many more steps: PARAMS_EXHAUSTED after
    exactly 3 accepted steps, status and counters as the reference's, and y
    the state after the 3rd accepted step of the port's plain run, to the
    bit. y is not held to the reference's: at rtol 1e-9 the first step's
    error estimate is 3e-7 to 6e-8 of the tolerance, a sum that cancels to
    ~1,000 ulps of the stages, so the two packages' rounding (XLA:CPU
    contracts multiply-adds, torch does not) moves it by 0.2% (dopri5) to
    24% (radau), and the next h by 4e-8 to 2.7%, in the plain runs alike
    (measured)."""
    def rhs(xp):
        def f(t, y, a):
            _, slab = a
            return xp.stack([y[..., 1], -y[..., 0]], -1) \
                * (1.0 + 0.0 * slab[:, None])
        return f

    opts = dict(rtol=1e-9, atol=1e-12, max_step=1.0)
    sol = _both(rhs, method, 50.0, np.array([[1.0, 0.0]]), None, np.ones(3),
                opts, y_tol=None)
    assert int(sol.status[0]) == PARAMS_EXHAUSTED
    assert int(sol.stats["naccept"][0]) == 3
    # the plain run, cut a few attempts later: its 4th accepted step starts
    # from the slabbed run's end state
    plain = solve_ivp(lambda t, y, a: rhs(torch)(t, y, (a, torch.ones(1))),
                      (0.0, 50.0), torch.tensor([[1.0, 0.0]]).double(),
                      method=method, dense=8, options=Options(
                          **opts, max_steps=int(sol.stats["nsteps"][0]) + 8))
    assert int(plain.stats["naccept"][0]) >= 4
    assert torch.equal(sol.y[0], plain.mesh["y"][0, 3])


@pytest.mark.parametrize("method", METHODS)
def test_exhaustion_matches_reference(method):
    """6 rows on Van der Pol (mu = 5) at rtol 1e-4: PARAMS_EXHAUSTED after
    exactly 6 accepted steps, with status, counters and y equal to the
    reference's (y within 1e-10). Here the error estimates of the third
    accepted step on are 7e-3 to 0.27 of the tolerance (measured on dopri5,
    dopri853 and radau5), so the step control that sets the mesh acts on
    values well above rounding noise."""
    def rhs(xp):
        def f(t, y, a):
            mu, slab = a
            x, v = y[..., 0], y[..., 1]
            return xp.stack([v, mu * (1 - x * x) * v - x], -1) \
                * (1.0 + 0.0 * slab[:, None])
        return f

    opts = dict(rtol=1e-4, atol=1e-7, max_step=1.0)
    sol = _both(rhs, method, 50.0, np.array([[2.0, 0.0]]), np.array([5.0]),
                np.ones(6), opts)
    assert int(sol.status[0]) == PARAMS_EXHAUSTED
    assert int(sol.stats["naccept"][0]) == 6


def test_step_indexed_forcing_with_playback():
    """Row k = k/S, ydot = u: y(T) = Σ_k (k/S)·h_k over the accepted steps
    read back from the step log, which equals the reference's."""
    s = 256
    opts = dict(rtol=1e-8, atol=1e-11, record_steps=256, max_step=0.25)
    sol = _both(_forcing, "dopri853", 3.0, np.zeros((2, 1)), None,
                np.arange(s, dtype=np.float64) / s, opts)
    assert bool((sol.status == SUCCESS).all())
    for lane in range(2):
        hs = sol.dyn["h"][lane][sol.dyn["accepted"][lane]].numpy()
        np.testing.assert_allclose(float(sol.y[lane, 0]),
                                   float(np.sum(np.arange(hs.size) / s * hs)),
                                   rtol=1e-12, atol=1e-12)


def test_per_lane_slab_table():
    """A leaf with second axis M is a per-lane table [S, M]: each lane
    integrates its own staircase."""
    s = 128
    base = np.linspace(0.1, 1.0, s)
    table = base[:, None] * np.array([1.0, 2.0, -1.0])[None, :]
    opts = dict(rtol=1e-8, atol=1e-11, record_steps=256, max_step=0.25)
    sol = _both(_forcing, "dopri5", 2.0, np.zeros((3, 1)), None, table, opts)
    for lane in range(3):
        hs = sol.dyn["h"][lane][sol.dyn["accepted"][lane]].numpy()
        np.testing.assert_allclose(float(sol.y[lane, 0]),
                                   float(np.sum(table[:hs.size, lane] * hs)),
                                   rtol=1e-12, atol=1e-12)


def test_slab_tangents_forward_mode():
    """torch.func.jvp through the adaptive solve in the slab table against
    jax.jvp through the reference's and a central difference (the reference
    test's 5e-3: the two difference meshes are chosen apart). The tangent
    carries the derivative of every step size through the error estimate,
    which amplifies rounding as the mesh does: held to the reference's
    within 1e-5 (measured 7.1e-7)."""
    s = 64
    slabs0 = np.linspace(0.2, 0.8, s)
    seed = np.sin(np.arange(s) * 0.3)
    opts = dict(rtol=1e-8, atol=1e-11, max_step=0.25)

    def run(xp, solve, opt, sl):
        def rhs(t, y, a):
            return a[1][:, None] - 0.5 * y
        return solve(rhs, (0.0, 2.0), xp.zeros((1, 1), dtype=xp.float64),
                     method="dopri5", options=opt, step_args=sl).y[0, 0]

    _, t_ref = jax.jvp(lambda sl: run(jnp, ref_solve_ivp,
                                      RefOptions(**opts), sl),
                       (jnp.asarray(slabs0),), (jnp.asarray(seed),))
    p_run = lambda sl: run(torch, solve_ivp, Options(**opts), sl)  # noqa
    _, t_got = jvp(p_run, (torch.from_numpy(slabs0),),
                   (torch.from_numpy(seed),))
    assert abs(float(t_got) - float(t_ref)) <= 1e-5 * abs(float(t_ref))
    eps = 1e-4
    fd = (p_run(torch.from_numpy(slabs0 + eps * seed))
          - p_run(torch.from_numpy(slabs0 - eps * seed))) / (2 * eps)
    np.testing.assert_allclose(float(t_got), float(fd), rtol=5e-3)


def test_radau_record_steps_and_states_match_reference():
    """solve_radau's step log with the accepted states, against the
    reference's (every attempt: t, h, err, Newton iterations, accepted, y)."""
    y0 = np.array([[2.0, 0.0], [1.8, 0.3]])
    mu = np.array([10.0, 100.0])
    opts = RefOptions(rtol=1e-6, atol=1e-9, record_steps=64,
                      record_states=True)
    ref = ref_solve_ivp(_vdp(jnp), (0.0, 1.0), jnp.asarray(y0),
                        method="radau5", args=jnp.asarray(mu), options=opts)
    sol = solve_ivp(_vdp(torch), (0.0, 1.0), torch.from_numpy(y0),
                    method="radau5", args=torch.from_numpy(mu),
                    options=options_from_jax(opts))
    assert set(ref.dyn) == {"t", "h", "err", "niter", "accepted", "idx",
                            "y"}
    _dyn_close(sol.dyn, ref.dyn)
    assert torch.equal(sol.dyn["idx"], sol.stats["nsteps"])


def test_one_contract_for_radau_and_rodas():
    """step_args= with tangents=, the adjoint's mesh or dense= raises the
    same ValueError in both families (the reference's rodas lets dense=
    through; the port does not)."""
    y0 = torch.tensor([[2.0, 0.0]], dtype=torch.float64)
    slabs = torch.ones((8,), dtype=torch.float64)
    seeds = torch.ones((1, 1, 2), dtype=torch.float64)
    for solve in (solve_radau, solve_rodas):
        for kw in (dict(tangents=seeds), dict(_mesh_size=16),
                   dict(dense=16)):
            with pytest.raises(ValueError) as err:
                solve(_vdp(torch), 0.0, 1.0, y0, 5.0, step_args=slabs, **kw)
            assert str(err.value) == STEP_ARGS_GUARD, (solve, kw)


def test_methods_without_step_args():
    y0 = torch.zeros((1, 2), dtype=torch.float64)
    with pytest.raises(ValueError, match="step_args"):
        solve_ivp(lambda t, y, a: -y, (0.0, 1.0), y0, method="radau_fused",
                  step_args=torch.ones((4,), dtype=torch.float64))
    # the variable-order ladder has no slab-row contract (the reference's
    # ValueErrors: its methods' table for 'radaup', the fixed-stage one for
    # a 'radau' ladder)
    with pytest.raises(ValueError, match="step_args=.*fixed-stage 'radau'"):
        solve_ivp(lambda t, y, a: -y, (0.0, 1.0), y0, method="radaup",
                  step_args=torch.ones((4,), dtype=torch.float64))
    with pytest.raises(ValueError, match="step_args= needs a fixed-stage"):
        solve_ivp(lambda t, y, a: -y, (0.0, 1.0), y0, method="radau",
                  min_stages=1, max_stages=7,
                  step_args=torch.ones((4,), dtype=torch.float64))
