"""The variable-order Radau ladder of the port (``solve/radaup.py``) against
the JAX reference ``janus_tpu.solve.radaup.solve_radau_vo``, on the CPU in
float64, on the same inputs made from a numpy seed.

Tolerances: status and all seven counters (nfev, njev, nlu, nsteps,
naccept, nreject, nnewton) equal per lane; t and y to 1e-10 relative to the
array's largest entry (1e-8 on the matrix-free ladder, whose tridiagonal
solves sum in another order); ``sens`` and ``sens_t`` to 1e-7; the t_eval
samples, ``quad`` and the event times to 1e-10. The adjoint's mesh rings
(``dense=``) are held as ROADMAP Queue 3's "meshes part" findings allow:
the step sizes of the two packages part at rounding level and the
controller amplifies it, so t, h and y are held within ten times the
port's own spread under a one-ulp change of y0 (plus 1e-8), the padded
polynomials and ``interpolate`` to 1e-8.

The reference's ladder compiles slowly on the CPU (6-10 s a solve), so each
case is one reference solve with several checks on it, and the heavy cases
are ``slow``, as the reference's own radaup tests are. With
``kernel_lu=True`` the port runs the plain twins of the CUDA kernels K1/K2
on CPU tensors; that route equals the plain pivot-free LU to the bit.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janus_tpu.solve import Options as RefOptions
from janus_tpu.solve import radaup as ref_rp
from janus_tpu.solve.events import Event as RefEvent
from janus_tpu_torch.interop import options_from_jax
from janus_tpu_torch.solve import Event, Options, solve_adjoint, solve_ivp
from janus_tpu_torch.solve import radaup as rp
from janus_tpu_torch.solve.radau import solve_radau
from test_torch_method_cases import (STATS7, close, linear_problems,
                                     linear_rhs, vdp_rhs_xp)
from test_torch_mol_cases import line_case

torch.set_num_threads(1)

LADDER = dict(min_stages=1, max_stages=7)


@pytest.fixture(autouse=True)
def _clear_caches_each_test():
    yield
    jax.clear_caches()


def _harmonic(xp):
    def rhs(t, y, w):
        return xp.stack([y[:, 1], -(w * w) * y[:, 0]], -1)
    return rhs


def _damped(xp):
    """A damped oscillator under an invertible mass."""
    return lambda t, y, a: xp.stack([y[:, 1], -a * y[:, 0] - 0.2 * y[:, 1]],
                                    -1)


def _event(xp):
    cls = RefEvent if xp is jnp else Event
    return cls(lambda t, y, a: y[..., 0], terminal=True, direction=-1.0)


def _conv(a, xp):
    if isinstance(a, dict):
        return {k: _conv(v, xp) for k, v in a.items()}
    if isinstance(a, tuple):
        return tuple(_conv(v, xp) for v in a)
    if isinstance(a, np.ndarray):
        return jnp.asarray(a) if xp is jnp else torch.from_numpy(a)
    return a


def _solves(prob, t0, tf, y0, args, okw, **kw):
    """The reference's and the port's solve of one case, and the port's
    solve from y0 nudged by one ulp."""
    ro = RefOptions(**okw)

    def extra(xp):
        return {k: v(xp) if callable(v) and k != "quad" else _conv(v, xp)
                for k, v in kw.items()}

    ref = ref_rp.solve_radau_vo(prob(jnp), t0, tf, jnp.asarray(y0),
                                _conv(args, jnp), ro, **extra(jnp))
    got, nudged = (rp.solve_radau_vo(prob(torch), t0, tf,
                                     torch.from_numpy(y), _conv(args, torch),
                                     options_from_jax(ro), **extra(torch))
                   for y in (y0, np.nextafter(y0, 3.0)))
    return ref, got, nudged


def _within_spread(got, ref, nudged, tol, what):
    """got within ten times the port's own spread under a one-ulp change of
    y0 (got against nudged) plus tol of ref's largest entry, per lane (the
    leading lane axis; a tangent axis K first is kept)."""
    a, r = got.numpy(), np.asarray(ref)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(r), err_msg=what)
    lane = 1 if what.startswith("sens") else 0
    axes = tuple(i for i in range(a.ndim) if i != lane)

    def lane_max(x):
        return np.nanmax(np.abs(x), axis=axes) if axes else np.abs(x)

    bound = 10.0 * lane_max(a - nudged.numpy()) + tol * np.nanmax(np.abs(r))
    assert np.all(lane_max(a - r) <= bound), what


def _compare(got, ref, nudged, tol=1e-10):
    """Status and the seven counters equal; t and y within tol; what the
    mesh decides (the t_eval samples, quad, the event times, the IND
    tangents) within ten times the port's one-ulp spread plus its own
    tolerance (tol; 1e-7 for the tangents)."""
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    for k in STATS7:
        np.testing.assert_array_equal(got.stats[k].numpy(),
                                      np.asarray(ref.stats[k]), err_msg=k)
    for k in ("t", "y"):
        close(getattr(got, k), getattr(ref, k), tol, k)
    for k, tk in (("ys", tol), ("quad", tol), ("event_t", tol),
                  ("sens", 1e-7), ("sens_ys", 1e-7), ("sens_t", 1e-7)):
        r = getattr(ref, k)
        assert (r is None) == (getattr(got, k) is None), k
        if r is not None:
            _within_spread(getattr(got, k), r, getattr(nudged, k), tk, k)
    if ref.event_idx is not None:
        np.testing.assert_array_equal(got.event_idx.numpy(),
                                      np.asarray(ref.event_idx))


# ---- the heterogeneous Van der Pol ladder, with t_eval and dense= ---------

HETERO = dict(y0=np.tile([[2.0, 0.0]], (4, 1)),
              mu=np.array([1.0, 10.0, 100.0, 1000.0]))
T_EVAL = np.linspace(0.0, 2.0, 9)


@pytest.fixture(scope="module")
def hetero():
    """One solve of the mixed-order ladder (μ over three decades, so lanes
    sit at different orders), with t_eval and the dense= rings, in both
    packages, and the port's from y0 nudged by one ulp."""
    out = _solves(vdp_rhs_xp, 0.0, 2.0, HETERO["y0"], HETERO["mu"],
                  dict(rtol=1e-6, atol=1e-9, **LADDER), t_eval=T_EVAL,
                  dense=64)
    jax.clear_caches()
    return out


def test_heterogeneous_ladder_matches_reference(hetero):
    """Counters equal, y(T) to 1e-10. On the μ = 1 lane the order-7 error
    estimate is rounding noise and both packages' steps part by ~1e-3 of h
    (the port's own one-ulp spread is 1.3e-3), which moves a t_eval sample
    by ~4e-10."""
    ref, got, nudged = hetero
    assert bool((got.status == 1).all())
    _compare(got, ref, nudged)
    # the ladder moved: more LU blocks than one per step at s=3
    assert bool((got.stats["nlu"] > 2 * got.stats["nsteps"]).any())


def test_mesh_rings_and_interpolate(hetero):
    """dense=: each accepted step's polynomial, zero-padded to s=7 (the
    padded power basis), within ten times the port's one-ulp spread."""
    ref, got, nudged = hetero
    assert tuple(got.mesh["q"].shape) == (4, 64, 7, 2)
    for key in ("t", "h", "y", "q"):
        _within_spread(got.mesh[key], ref.mesh[key], nudged.mesh[key], 1e-8,
                       key)
    ts = torch.from_numpy(np.linspace(0.05, 1.95, 11))
    _within_spread(got.interpolate(ts), ref.interpolate(jnp.asarray(ts)),
                   nudged.interpolate(ts), 1e-8, "interpolate")
    # the polynomial evaluated at the t_eval grid is the t_eval sample
    torch.testing.assert_close(got.interpolate(torch.from_numpy(T_EVAL[1:])),
                               got.ys[:, 1:], rtol=0, atol=1e-12)


def test_linear_stiff_sweep_matches_reference():
    """The random stiff linear systems of tests/test_method_zoo_linear.py
    (eigenvalues over four decades), rtol 1e-8: against the reference and
    the exact solution; with record_steps, each attempt's iteration count
    and accept flag equal, its t, h and error norm within ten times the
    port's one-ulp spread (the decayed lanes' estimates are noise: t and h
    part by up to 8.5e-5, the port against itself by 1.1e-5)."""
    a, y0, y_exact, tf = linear_problems()
    ref, got, nudged = _solves(linear_rhs, 0.0, tf, y0, a,
                               dict(rtol=1e-8, atol=1e-11, record_steps=64,
                                    **LADDER))
    _compare(got, ref, nudged)
    np.testing.assert_allclose(got.y.numpy(), y_exact, rtol=1e-5, atol=1e-7)
    assert set(got.dyn) == set(ref.dyn)
    for k in ("niter", "accepted", "idx"):
        np.testing.assert_array_equal(got.dyn[k].numpy(),
                                      np.asarray(ref.dyn[k]), err_msg=k)
    for k in ("t", "h", "err"):
        _within_spread(got.dyn[k], ref.dyn[k], nudged.dyn[k], 1e-8,
                       f"dyn[{k}]")


def test_ind_tangents_and_args_tangents_match_reference():
    """IND with y0 seeds and parameter seeds together (K=2), each riding
    the lane's own order."""
    rng = np.random.default_rng(4)
    y0 = np.tile([[2.0, 0.0]], (3, 1)) + 0.1 * rng.standard_normal((3, 2))
    mu = np.array([30.0, 300.0, 1000.0])
    seeds = np.stack([np.tile([1.0, 0.0], (3, 1)), np.zeros((3, 2))])
    ref, got, nudged = _solves(
        vdp_rhs_xp, 0.0, 1.0, y0, mu, dict(rtol=1e-7, atol=1e-10, **LADDER),
        tangents=seeds, args_tangents=np.stack([np.zeros(3), np.ones(3)]))
    _compare(got, ref, nudged)
    assert rp.solve_radau_vo.host_syncs >= int(got.stats["nsteps"].max())


def test_events_with_sens_t_match_reference():
    """A terminal event with IND tangents: the implicit-function jump at
    t* (sens) and the event-time tangents (sens_t), with t_eval samples
    past t* NaN. The jump cancels the tangent's x-component to ~1e-5 of
    its O(1) terms, so sens is held as the mesh: the two packages differ
    by 2.0e-8 (sens) and 1.2e-8 (sens_t), the port against itself under a
    one-ulp change of y0 by 3.2e-8 and 2.1e-8."""
    y0 = np.array([[2.0, 0.0], [1.5, 0.5]])
    ref, got, nudged = _solves(
        vdp_rhs_xp, 0.0, 10.0, y0, np.array([3.0, 8.0]),
        dict(rtol=1e-8, atol=1e-11, **LADDER), events=_event,
        t_eval=np.linspace(0.0, 4.0, 6),
        tangents=np.stack([np.ones((2, 2)), np.tile([0.0, 1.0], (2, 1))]))
    _compare(got, ref, nudged)
    assert bool((got.status == 5).all())
    assert bool(torch.isnan(got.ys[:, -1]).all())


def test_quad_and_mass_match_reference():
    """quad= (Gauss-Legendre on the lane's interpolant) under an
    invertible mass matrix, with a quad that refuses tangents."""
    y0 = np.array([[1.0, 0.0], [0.5, 0.2]])
    mass = np.array([[2.0, 0.3], [0.1, 1.5]])
    quad = {jnp: lambda t, y, a: jnp.stack([y[:, 0] ** 2, t * y[:, 1]], -1),
            torch: lambda t, y, a: torch.stack([y[:, 0] ** 2, t * y[:, 1]],
                                               -1)}
    ro = RefOptions(rtol=1e-8, atol=1e-11, **LADDER)
    ref = ref_rp.solve_radau_vo(_damped(jnp), 0.0, 3.0, jnp.asarray(y0), 1.7,
                                ro, mass=jnp.asarray(mass), quad=quad[jnp])
    got, nudged = (rp.solve_radau_vo(_damped(torch), 0.0, 3.0,
                                     torch.from_numpy(y), 1.7,
                                     options_from_jax(ro),
                                     mass=torch.from_numpy(mass),
                                     quad=quad[torch])
                   for y in (y0, np.nextafter(y0, 3.0)))
    _compare(got, ref, nudged)
    with pytest.raises(ValueError, match="sens_quad"):
        rp.solve_radau_vo(_damped(torch), 0.0, 3.0, torch.from_numpy(y0),
                          1.7, quad=quad[torch],
                          tangents=torch.zeros((1, 2, 2),
                                               dtype=torch.float64))


def test_f32_caps_the_ladder():
    """float32 caps the ladder at s=5 with a warning (the mesh polynomials
    are five wide), status equal to the reference's. The counters are held
    within 10% + 1 of the reference's: in f32 at rtol 1e-5 the error
    estimates sit near the rounding, and the reference parts from itself
    as far, its compiled solve against its op-by-op one (jax.disable_jit)
    by one step on one lane of the first three (11/13/14 against 12/13/14
    naccept), the port from the compiled one by one step on two (nlu 29/35
    against 32/35, nfev 124/135 against 135/146)."""
    for opts in (RefOptions(**LADDER), RefOptions(min_stages=5, max_stages=7),
                 RefOptions(min_stages=7, max_stages=7),
                 RefOptions(min_stages=3, max_stages=5)):
        for dt, jdt in ((torch.float32, jnp.float32),
                        (torch.float64, jnp.float64)):
            assert rp.ladder_orders(options_from_jax(opts), dt) == \
                ref_rp.ladder_orders(opts, jdt)
    m = 6
    mus = np.logspace(0.5, 3.0, m).astype(np.float32)
    y0 = np.tile(np.array([[2.0, 0.0]], np.float32), (m, 1))
    ro = RefOptions(rtol=1e-5, atol=1e-8, pivoting=False, **LADDER)
    with pytest.warns(UserWarning, match="capping"):
        ref = ref_rp.solve_radau_vo(vdp_rhs_xp(jnp), 0.0, 1.0,
                                    jnp.asarray(y0), jnp.asarray(mus), ro)
    with pytest.warns(UserWarning, match="capping"):
        got = rp.solve_radau_vo(vdp_rhs_xp(torch), 0.0, 1.0,
                                torch.from_numpy(y0), torch.from_numpy(mus),
                                options_from_jax(ro), dense=32)
    assert bool((got.status == 1).all())
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    assert tuple(got.mesh["q"].shape) == (m, 32, 5, 2)
    for k in STATS7:
        r = np.asarray(ref.stats[k])
        assert np.all(np.abs(got.stats[k].numpy() - r) <= 0.1 * r + 1), k


@pytest.mark.slow
@pytest.mark.parametrize("stage_solver", ["tridiag", "gmres"])
def test_matrix_free_ladder_matches_reference(stage_solver):
    """The D=16 Fisher-KPP line through the per-order matrix-free stage
    solvers and the per-lane γ0 error solve, with an IND seed."""
    ref_f, f, y0, (nu, rates) = line_case(d=16, m=2)
    ro = RefOptions(rtol=1e-6, atol=1e-9, stage_solver=stage_solver,
                    gmres_iters=20, min_stages=1, max_stages=5)
    seeds = np.zeros((1, 2, 16))
    seeds[0, :, 8] = 1.0
    ref = ref_rp.solve_radau_vo(ref_f, 0.0, 0.4, jnp.asarray(y0),
                                (nu, jnp.asarray(rates)), ro,
                                tangents=jnp.asarray(seeds))
    got, nudged = (rp.solve_radau_vo(f, 0.0, 0.4, torch.from_numpy(y),
                                     (nu, torch.from_numpy(rates)),
                                     options_from_jax(ro),
                                     tangents=torch.from_numpy(seeds))
                   for y in (y0, np.nextafter(y0, 3.0)))
    _compare(got, ref, nudged, tol=1e-8)
    assert int(got.stats["nlu"].max()) == 0


@pytest.mark.slow
def test_reverse_time_and_h0_match_reference():
    """Backward in time with a fixed first step."""
    y0 = np.array([[np.cos(2.0), -np.sin(2.0)], [1.0, 0.5]])
    ref, got, nudged = _solves(_harmonic, 2.0, 0.0, y0, 1.0,
                               dict(rtol=1e-8, atol=1e-11, h0=1e-3,
                                    **LADDER))
    _compare(got, ref, nudged)


def test_kernel_lu_equals_plain_lu():
    """kernel_lu=True (the twins of K1/K2 on CPU tensors, K1 on every
    order's real and split-complex blocks) and the plain pivot-free LU:
    the same arithmetic, equal to the bit, tangents too."""
    y0 = torch.tensor([[2.0, 0.0]] * 3, dtype=torch.float64)
    mus = torch.tensor([1000.0, 50.0, 5.0], dtype=torch.float64)
    seeds = torch.stack([torch.eye(2, dtype=torch.float64)[j].expand(3, 2)
                         for j in range(2)])
    opts = Options(rtol=1e-6, atol=1e-9, pivoting=False, **LADDER)
    a, b = (solve_ivp(vdp_rhs_xp(torch), (0.0, 1.0), y0, method="radaup",
                      args=mus, options=opts.replace(kernel_lu=k),
                      tangents=seeds)
            for k in (False, True))
    for k in ("t", "y", "sens", "status"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    for k in STATS7:
        assert torch.equal(a.stats[k], b.stats[k]), k
    assert int(a.stats["nlu"].max()) > 2 * int(a.stats["nsteps"].max())


def test_dispatch():
    """'radaup' is the ladder over stages 1..7; options that pin a ladder
    keep it; a ladder of one order is fixed-stage radau; 'radau' with
    min_stages != max_stages is the ladder; step_args= raises the
    reference's ValueErrors (on 'radaup' the methods' table, on a 'radau'
    ladder the fixed-stage one)."""
    y0 = torch.tensor([[2.0, 0.0]], dtype=torch.float64)
    f = vdp_rhs_xp(torch)
    kw = dict(args=20.0, rtol=1e-6, atol=1e-9)
    full = rp.solve_radau_vo(f, 0.0, 1.0, y0, 20.0,
                             Options(rtol=1e-6, atol=1e-9, **LADDER))
    for method, okw in (("radaup", {}), ("radau", LADDER)):
        sol = solve_ivp(f, (0.0, 1.0), y0, method=method, **okw, **kw)
        assert torch.equal(sol.y, full.y), method
    pinned = solve_ivp(f, (0.0, 1.0), y0, method="radaup", min_stages=3,
                       max_stages=5, **kw)
    assert torch.equal(pinned.y, rp.solve_radau_vo(
        f, 0.0, 1.0, y0, 20.0, Options(rtol=1e-6, atol=1e-9, min_stages=3,
                                       max_stages=5)).y)
    one = rp.solve_radau_vo(f, 0.0, 1.0, y0, 20.0,
                            Options(min_stages=3, max_stages=4))
    fixed = solve_radau(f, 0.0, 1.0, y0, 20.0, Options(min_stages=3,
                                                       max_stages=3))
    assert torch.equal(one.y, fixed.y)
    slabs = torch.ones((4,), dtype=torch.float64)
    with pytest.raises(ValueError, match="step_args= needs a fixed-stage"):
        solve_ivp(f, (0.0, 1.0), y0, method="radau", step_args=slabs,
                  **LADDER, **kw)
    with pytest.raises(ValueError, match="step_args=.*fixed-stage 'radau'"):
        solve_ivp(f, (0.0, 1.0), y0, method="radaup", step_args=slabs, **kw)
    with pytest.raises(ValueError, match="pivoting=False"):
        solve_ivp(f, (0.0, 1.0), y0, method="radaup", kernel_lu=True, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        y = solve_adjoint(f, (0.0, 1.0), y0.clone().requires_grad_(),
                          method="radaup", args=20.0,
                          options=Options(rtol=1e-6, atol=1e-9))
    assert torch.equal(y.detach(), full.y)
