"""The step mesh, dense output, t_eval and quadratures of the port's
solve_radau against the JAX reference, on the CPU in float64.

Inputs come from a numpy seed: 4 Van der Pol lanes, μ from 2 to 50, rtol
1e-6. Both packages take the same steps (naccept equal per lane). The final
state agrees to 1e-10 and ``interpolate``, the t_eval samples ``ys`` /
``sens_ys`` and ``quad`` / ``sens_quad`` to 1e-9, each relative to the
array's largest entry. The accepted-step mesh (t, h, y, q) is held to 1e-8:
a step size comes from the error estimate, a difference of stage values
that agree to ~1e-5 of it, so the two packages' rounding (summation order in
the stage contractions) shows in h at 1e-12 to 1e-11 relative from the
second step on and grows along the solve (measured: up to 4e-9 in h and
1.4e-9 in t on the μ = 50 lane after 70 steps). What is computed ON the mesh
does not inherit that: the solution at a given time depends on the mesh only
through the local error.
The tests without the reference hold the port against itself: interpolate
against t_eval, quad against an augmented state, overflow to NaN.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janus_tpu.models.problems import vdp_rhs as ref_vdp_rhs
from janus_tpu.solve import Options as RefOptions
from janus_tpu.solve.radau import solve_radau as ref_solve_radau
from janus_tpu_torch.interop import options_from_jax
from janus_tpu_torch.models.problems import vdp_rhs
from janus_tpu_torch.solve import Options, solve_ivp
from janus_tpu_torch.solve.radau import solve_radau

torch.set_num_threads(1)

M = 4


@pytest.fixture(autouse=True)
def _clear_caches_each_test():
    yield
    jax.clear_caches()


def _problem():
    rng = np.random.default_rng(7)
    y0 = np.tile([[2.0, 0.0]], (M, 1)) + 0.1 * rng.standard_normal((M, 2))
    mus = np.geomspace(2.0, 50.0, M)
    seeds = np.stack([np.tile(np.eye(2)[j], (M, 1)) for j in range(2)])
    dmus = np.stack([mus * 1e-2, rng.standard_normal(M)])
    return y0, mus, seeds, dmus


def _close(got, ref, tol, what):
    ref = np.asarray(ref)
    np.testing.assert_allclose(
        got.numpy(), ref, rtol=0,
        atol=tol * max(float(np.nanmax(np.abs(ref))), 1e-300), err_msg=what)


def _cost(xp):
    def cost(t, y, mu):
        return xp.stack([y[:, 0] ** 2 + 0.1 * mu * y[:, 1] ** 2,
                         t * y[:, 0]], -1)
    return cost


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_mesh_dense_t_eval_quad_match_reference():
    """One reference solve with every feature on: the mesh rings, the t_eval
    samples and their tangents, the quadratures and theirs."""
    y0, mus, seeds, dmus = _problem()
    ref_opts = RefOptions(rtol=1e-6, atol=1e-9)
    t_eval = np.linspace(0.0, 1.5, 7)
    kw = dict(dense=96, _mesh_size=0)
    ref = ref_solve_radau(ref_vdp_rhs, 0.0, 1.5, jnp.asarray(y0),
                          args=jnp.asarray(mus), options=ref_opts,
                          t_eval=jnp.asarray(t_eval),
                          tangents=jnp.asarray(seeds),
                          args_tangents=jnp.asarray(dmus), quad=_cost(jnp),
                          **kw)
    got = solve_radau(vdp_rhs, 0.0, 1.5, _t(y0), args=_t(mus),
                      options=options_from_jax(ref_opts), t_eval=t_eval,
                      tangents=_t(seeds), args_tangents=_t(dmus),
                      quad=_cost(torch), **kw)
    assert bool((got.status == 1).all())
    np.testing.assert_array_equal(got.stats["naccept"].numpy(),
                                  np.asarray(ref.stats["naccept"]))
    assert int(got.stats["naccept"].max()) <= 96
    for key in ("t", "h", "y", "q"):
        _close(got.mesh[key], ref.mesh[key], 1e-8, f"mesh[{key}]")
    _close(got.y, ref.y, 1e-10, "y")
    _close(got.ys, ref.ys, 1e-9, "ys")
    _close(got.sens_ys, ref.sens_ys, 1e-9, "sens_ys")
    _close(got.quad, ref.quad, 1e-9, "quad")
    _close(got.sens_quad, ref.sens_quad, 1e-9, "sens_quad")
    _close(got.h_next, ref.h_next, 1e-8, "h_next")      # a step size
    # shared and per-lane query times, the ends of the span among them
    rng = np.random.default_rng(8)
    for ts in (np.linspace(0.0, 1.5, 11), 1.5 * rng.random((M, 5))):
        _close(got.interpolate(ts), ref.interpolate(jnp.asarray(ts)), 1e-9,
               "interpolate")


def test_reverse_time_warm_start_matches_reference():
    """tf < t0 (with μ a tenth: backward in time this flow expands) with a
    per-lane ``_h0`` (0 = automatic) and a scalar quad. Of the mesh only the
    first step is compared, the one ``_h0`` sets (to 1e-12): what the later
    step sizes differ by grows with this flow (measured: 1.3e-8 in t after
    12 steps), and the forward case above holds the whole mesh."""
    y0, mus, _, _ = _problem()
    mus = mus / 10.0
    ref_opts = RefOptions(rtol=1e-6, atol=1e-9)
    h0 = np.array([0.0, 0.002, -0.005, 0.0])

    def quad(t, y, mu):
        return y[:, 0] * y[:, 1]

    ts = np.linspace(1.0, 0.5, 6)
    ref = ref_solve_radau(ref_vdp_rhs, 1.0, 0.5, jnp.asarray(y0),
                          args=jnp.asarray(mus), options=ref_opts,
                          t_eval=jnp.asarray(ts), quad=quad, dense=64,
                          _h0=jnp.asarray(h0))
    got = solve_radau(vdp_rhs, 1.0, 0.5, _t(y0), args=_t(mus),
                      options=options_from_jax(ref_opts), t_eval=ts,
                      quad=quad, dense=64, _h0=_t(h0))
    assert bool((got.status == 1).all())
    np.testing.assert_array_equal(got.stats["naccept"].numpy(),
                                  np.asarray(ref.stats["naccept"]))
    assert got.quad.shape == (M,)
    for key in ("t", "h", "y", "q"):
        _close(got.mesh[key][:, 0], ref.mesh[key][:, 0], 1e-12,
               f"mesh[{key}][:, 0]")
    assert bool((got.mesh["h"][:, 0] < 0).all())
    _close(got.ys, ref.ys, 1e-9, "ys")
    _close(got.quad, ref.quad, 1e-9, "quad")
    _close(got.interpolate(ts), ref.interpolate(jnp.asarray(ts)), 1e-9,
           "interpolate")


# ---- the port against itself ------------------------------------------------

def _solve(**kw):
    y0, mus, _, _ = _problem()
    return solve_ivp(vdp_rhs, (0.0, 1.5), _t(y0), method="radau5",
                     args=_t(mus), rtol=1e-6, atol=1e-9, **kw)


def test_interpolate_agrees_with_t_eval_and_the_final_state():
    ts = np.linspace(0.0, 1.5, 9)
    sol = _solve(dense=96, t_eval=ts)
    dense = sol.interpolate(ts)
    torch.testing.assert_close(dense, sol.ys, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(dense[:, -1], sol.y, rtol=1e-12, atol=1e-12)
    y0 = _t(_problem()[0])
    torch.testing.assert_close(dense[:, 0], y0, rtol=0, atol=0)
    # queries outside the span are clamped to its ends
    out = sol.interpolate(np.array([-1.0, 9.0]))
    torch.testing.assert_close(out[:, 0], y0, rtol=0, atol=0)
    torch.testing.assert_close(out[:, 1], sol.y, rtol=1e-12, atol=1e-12)


def test_mesh_overflow_interpolates_to_nan_and_keeps_the_solve():
    full, short = _solve(dense=96), _solve(dense=40)
    nacc = short.stats["naccept"]
    assert int(nacc.min()) <= 40 < int(nacc.max())     # both kinds of lane
    torch.testing.assert_close(short.y, full.y, rtol=0, atol=0)
    out = short.interpolate(np.linspace(0.0, 1.5, 4))
    over = nacc > 40
    assert bool(torch.isnan(out[over]).all())
    assert bool(torch.isfinite(out[~over]).all())
    torch.testing.assert_close(short.mesh["q"][:, :40], full.mesh["q"][:, :40],
                               rtol=0, atol=0)


def test_mesh_costs_no_host_sync_and_changes_no_number():
    plain = _solve()
    syncs = solve_radau.host_syncs
    meshed = _solve(dense=96)
    assert solve_radau.host_syncs == syncs
    torch.testing.assert_close(meshed.y, plain.y, rtol=0, atol=0)
    for key in plain.stats:
        assert torch.equal(meshed.stats[key], plain.stats[key])
    assert plain.mesh is None and plain.ys is None and plain.quad is None


def test_quad_matches_an_augmented_state():
    """∫ l dt by the step's quadrature against l carried as a third state."""
    y0, mus, _, _ = _problem()

    def aug(t, y, mu):
        return torch.cat([vdp_rhs(t, y[:, :2], mu),
                          (y[:, 0] ** 2)[:, None]], dim=-1)

    y_aug = torch.cat([_t(y0), torch.zeros(M, 1, dtype=torch.float64)], -1)
    kw = dict(method="radau5", args=_t(mus), rtol=1e-9, atol=1e-12)
    ref = solve_ivp(aug, (0.0, 1.5), y_aug, **kw)
    got = solve_ivp(vdp_rhs, (0.0, 1.5), _t(y0),
                    quad=lambda t, y, mu: y[:, 0] ** 2, **kw)
    torch.testing.assert_close(got.quad, ref.y[:, 2], rtol=1e-7, atol=1e-9)


def test_interpolate_and_quad_raise_on_misuse():
    with pytest.raises(ValueError, match="dense=N"):
        _solve().interpolate(np.array([0.5]))
    with pytest.raises(ValueError, match=r"quad must return \[M\] or"):
        _solve(quad=lambda t, y, mu: y[0])
    with pytest.raises(ValueError, match="dense="):
        solve_ivp(vdp_rhs, (0.0, 1.0), _t(_problem()[0]),
                  method="radau_fused", args=5.0, dense=8)
    assert Options().adjoint_steps == 256
