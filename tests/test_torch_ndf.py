"""The variable-order BDF/NDF of the port (``solve/ndf.py``) against the JAX
reference ``janus_tpu.solve.ndf.solve_bdf``, on the CPU in float64, on the
same inputs made from a numpy seed.

The helpers first: the constant maps, the per-lane R(order, factor)
transforms and the history algebra, each against the reference's function
on seeded inputs, equal to the bit (both add the small slot sums in
sequence).

Then whole solves. Tolerances: status and all eight counters (nfev, njev,
nlu, nsteps, naccept, nreject, nnewton, order) equal per lane; t and y to
1e-10 relative to the array's largest entry on the LU path and 1e-8 on the
matrix-free path (a GMRES or tridiagonal solve sums in another order);
``sens`` to 1e-7; the t_eval samples, ``interpolate``, ``quad``, the event
times and the adjoint's mesh rings to 1e-10 (1e-8 matrix-free).

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
from janus_tpu.solve import adjoint_ndf as ref_adj
from janus_tpu.solve import ndf as ref_ndf
from janus_tpu.solve.events import Event as RefEvent
from janus_tpu_torch.bench.mol import fisher_kpp_rhs as line_rhs
from janus_tpu_torch.interop import options_from_jax
from janus_tpu_torch.solve import Event, Options, solve_ivp
from janus_tpu_torch.solve import ndf
from test_torch_mol_cases import ref_line_rhs

torch.set_num_threads(1)

STATS = ("nfev", "njev", "nlu", "nsteps", "naccept", "nreject", "nnewton",
         "order")


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


def _harmonic(xp):
    def rhs(t, y, w):
        return xp.stack([y[:, 1], -(w * w) * y[:, 0]], -1)
    return rhs


def _rob_dae(xp):
    """Robertson in semi-explicit index-1 form (mass diag(1, 1, 0))."""
    def rhs(t, y, k):
        k1, k2, k3 = k[..., 0], k[..., 1], k[..., 2]
        y1, y2, y3 = y[:, 0], y[:, 1], y[:, 2]
        return xp.stack([-k1 * y1 + k3 * y2 * y3,
                         k1 * y1 - k2 * y2 * y2 - k3 * y2 * y3,
                         y1 + y2 + y3 - 1.0], -1)
    return rhs


def _line(xp, d):
    """bench.py's Fisher-KPP line at width d, args (ν, r)."""
    dx = 1.0 / (d + 1)
    return ref_line_rhs(dx) if xp is jnp else line_rhs(dx)


def _line_y0(d, m):
    dx = 1.0 / (d + 1)
    xg = np.linspace(dx, 1.0 - dx, d)
    return np.tile(np.exp(-100 * (xg - 0.3) ** 2)[None], (m, 1))


def _fem_mass(d):
    return (np.eye(d) * 2.0 / 3.0 + np.eye(d, k=1) / 6.0
            + np.eye(d, k=-1) / 6.0)


def _vdp_y0(m):
    rng = np.random.default_rng(8)
    return np.tile([[2.0, 0.0]], (m, 1)) + 0.1 * rng.standard_normal((m, 2))


def _quad(xp):
    return lambda t, y, mu: xp.stack([y[:, 0] ** 2, t * y[:, 1]], -1)


# name -> (problem, t0, tf, inputs () -> (y0, args), keywords (xp) -> dict,
# reference Options keywords, y tolerance)
_LINE = dict(rtol=1e-7, atol=1e-10, gmres_iters=15)
CASES = {
    "vdp-stiff": (
        _vdp, 0.0, 2.0, lambda: (_vdp_y0(2), np.array([1000.0, 400.0])),
        lambda xp: {}, dict(rtol=1e-7, atol=1e-10), 1e-10),
    "heterogeneous-mu": (
        _vdp, 0.0, 3.0,
        lambda: (np.tile([[2.0, 0.0]], (4, 1)),
                 np.array([1.0, 10.0, 100.0, 1000.0])),
        lambda xp: {}, dict(rtol=1e-6, atol=1e-9), 1e-10),
    "reverse-time": (
        _harmonic, 2.0, 0.0,
        lambda: (np.array([[np.cos(2.0), -np.sin(2.0)], [1.0, 0.5]]), 1.0),
        lambda xp: {}, dict(rtol=1e-8, atol=1e-11), 1e-10),
    "bdf-classic": (
        _vdp, 0.0, 2.0, lambda: (_vdp_y0(2), np.array([100.0, 30.0])),
        lambda xp: dict(ndf=False), dict(rtol=1e-7, atol=1e-10), 1e-10),
    "analytic-jac-kernel": (
        _vdp, 0.0, 2.0, lambda: (_vdp_y0(3), np.array([1000.0, 50.0, 5.0])),
        lambda xp: dict(jac=_vdp_jac(xp)),
        dict(rtol=1e-7, atol=1e-10, pivoting=False, pallas_lu=True), 1e-10),
    "mass-invertible": (
        lambda xp: _line(xp, 8), 0.0, 0.5,
        lambda: (_line_y0(8, 2), (0.02, np.array([[4.0], [1.0]]))),
        lambda xp: dict(mass=xp.asarray(_fem_mass(8))),
        dict(rtol=1e-9, atol=1e-12), 1e-10),
    "robertson-dae": (
        _rob_dae, 0.0, 100.0,
        lambda: (np.tile([1.0, 0.0, 0.0], (2, 1)),
                 np.array([[0.04, 3e7, 1e4], [0.05, 2e7, 1e4]])),
        lambda xp: dict(mass=xp.asarray(np.diag([1.0, 1.0, 0.0]))),
        dict(rtol=1e-8, atol=1e-12), 1e-10),
    "tridiag-line": (
        lambda xp: _line(xp, 24), 0.0, 0.4,
        lambda: (_line_y0(24, 2), (0.01, np.array([[1.0], [8.0]]))),
        lambda xp: {}, dict(stage_solver="tridiag", **_LINE), 1e-8),
    "gmres-line": (
        lambda xp: _line(xp, 24), 0.0, 0.4,
        lambda: (_line_y0(24, 2), (0.01, np.array([[1.0], [8.0]]))),
        lambda xp: {}, dict(stage_solver="gmres", **_LINE), 1e-8),
    "ind-vdp": (
        _vdp, 0.0, 1.0,
        lambda: (_vdp_y0(4), {"mu": np.array([1.0, 5.0, 20.0, 50.0])}),
        lambda xp: dict(
            tangents=xp.asarray(np.stack([np.tile([1.0, 0.0], (4, 1)),
                                          np.zeros((4, 2))])),
            args_tangents={"mu": xp.asarray(np.stack([np.zeros(4),
                                                      np.ones(4)]))}),
        dict(rtol=1e-8, atol=1e-10), 1e-10),
    "ind-kernel": (
        _vdp, 0.0, 1.0, lambda: (_vdp_y0(2), np.array([1000.0, 300.0])),
        lambda xp: dict(jac=_vdp_jac(xp), tangents=xp.asarray(
            np.stack([np.tile(np.eye(2)[j], (2, 1)) for j in range(2)]))),
        dict(rtol=1e-6, atol=1e-9, pivoting=False, pallas_lu=True), 1e-10),
    "ind-mass-dae": (
        _rob_dae, 0.0, 10.0,
        lambda: (np.tile([1.0, 0.0, 0.0], (2, 1)),
                 np.array([[0.04, 3e7, 1e4], [0.05, 3e7, 1e4]])),
        lambda xp: dict(mass=xp.asarray(np.diag([1.0, 1.0, 0.0])),
                        tangents=xp.asarray(np.tile([1.0, 0.0, -1.0],
                                                    (1, 2, 1)))),
        dict(rtol=1e-8, atol=1e-11), 1e-10),
    "ind-gmres": (
        lambda xp: _line(xp, 16), 0.0, 0.2,
        lambda: (_line_y0(16, 2), (0.01, np.array([[1.0], [4.0]]))),
        lambda xp: dict(tangents=xp.asarray(
            np.sin(np.pi * np.linspace(0, 1, 16))[None, None]
            .repeat(2, axis=1))),
        dict(stage_solver="gmres", rtol=1e-7, atol=1e-10, gmres_iters=8),
        1e-8),
    "t_eval-quad": (
        _vdp, 0.0, 3.0, lambda: (_vdp_y0(2), np.array([10.0, 200.0])),
        lambda xp: dict(t_eval=xp.asarray(np.linspace(0.0, 3.0, 13)),
                        quad=_quad(xp)),
        dict(rtol=1e-8, atol=1e-11), 1e-10),
    "dense": (
        _vdp, 0.0, 3.0, lambda: (_vdp_y0(2), np.array([10.0, 200.0])),
        lambda xp: dict(dense=1024), dict(rtol=1e-8, atol=1e-11), 1e-10),
    "events-terminal": (
        _harmonic, 0.0, 10.0,
        lambda: (np.array([[1.0, 0.0], [2.0, 0.3]]), np.array([1.0, 1.5])),
        lambda xp: dict(events=(RefEvent if xp is jnp else Event)(
            lambda t, y, a: y[..., 0], terminal=True, direction=-1.0),
            t_eval=xp.asarray(np.linspace(0.0, 3.0, 7)), quad=_quad(xp)),
        dict(rtol=1e-8, atol=1e-11), 1e-10),
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


def _solves(name, **extra):
    prob, t0, tf, inputs, kw, okw, _ = CASES[name]
    y0, args = inputs()
    ref_opts = RefOptions(**okw)
    ref = ref_ndf.solve_bdf(prob(jnp), t0, tf, jnp.asarray(y0),
                            _args(args, jnp), ref_opts, **kw(jnp), **extra)
    got = ndf.solve_bdf(prob(torch), t0, tf, torch.from_numpy(y0),
                        _args(args, torch), options_from_jax(ref_opts),
                        **kw(torch), **extra)
    return ref, got


def _compare(got, ref, tol):
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


@pytest.mark.parametrize("name", list(CASES))
def test_solve_bdf_matches_reference(name):
    ref, got = _solves(name)
    assert bool((got.status == 1).all() | (got.status == 5).all())
    _compare(got, ref, CASES[name][-1])
    assert ndf.solve_bdf.host_syncs >= int(got.stats["nsteps"].max())
    if got.mesh is not None:
        ts = np.linspace(0.05, 2.95, 11)
        _close(got.interpolate(torch.from_numpy(ts)),
               ref.interpolate(jnp.asarray(ts)), 1e-10, "interpolate")


def test_mesh_rings_match_reference():
    """The adjoint's recording: per accepted step t, h, order, d, the
    post-clamp D' and the composed transform T, and the first step h0."""
    ref, got = _solves("heterogeneous-mu", _mesh_size=256)
    _compare(got, ref, 1e-10)
    assert int(got.stats["naccept"].max()) <= 256
    np.testing.assert_array_equal(got.mesh["k"].numpy(),
                                  np.asarray(ref.mesh["k"]))
    # the meshes part at ~1e-12 from the first order change, where the error
    # estimate of a tiny startup step is rounding noise, and reach ~3e-8 of
    # a lane's own h (ROADMAP Queue 3): held to 1e-8 of the ring's largest
    # entry, as the Radau mesh is
    for key in ("t", "h", "d", "D", "T", "h0"):
        _close(got.mesh[key], ref.mesh[key], 1e-8, key)
    # orders vary along the recorded mesh
    assert int(got.mesh["k"].max()) >= 3


def test_kernel_lu_equals_plain_lu():
    """kernel_lu=True (the twins of K1/K2 on CPU tensors) and the plain
    pivot-free LU: the same arithmetic, equal to the bit, tangents too."""
    y0 = torch.from_numpy(_vdp_y0(3))
    mus = torch.tensor([1000.0, 50.0, 5.0], dtype=torch.float64)
    seeds = torch.stack([torch.eye(2, dtype=torch.float64)[j].expand(3, 2)
                         for j in range(2)])
    opts = Options(rtol=1e-6, atol=1e-9, pivoting=False)
    a, b = (solve_ivp(_vdp(torch), (0.0, 1.0), y0, method="bdf", args=mus,
                      options=opts.replace(kernel_lu=k), tangents=seeds)
            for k in (False, True))
    for k in ("t", "y", "sens", "status"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    for k in STATS:
        assert torch.equal(a.stats[k], b.stats[k]), k


# ---- the helpers, each against the reference function ----------------------

def _orders_factors(m=64):
    rng = np.random.default_rng(3)
    order = rng.integers(1, ndf.MAX_ORDER + 1, m)
    factor = np.where(rng.random(m) < 0.2, 1.0, rng.uniform(0.2, 8.0, m))
    return order, factor


def test_constants_match_reference():
    np.testing.assert_array_equal(ndf._C_BDF_POW, ref_ndf._C_BDF_POW)
    np.testing.assert_array_equal(ndf._W_BDF_AT0, ref_ndf._W_BDF_AT0)
    np.testing.assert_array_equal(ndf._KAPPA_NDF, ref_ndf._KAPPA_NDF)
    assert (ndf.MAX_ORDER, ndf._K, ndf._SLOTS, ndf.NEWTON_MAXITER) == (
        ref_ndf.MAX_ORDER, ref_ndf._K, ref_ndf._SLOTS, ref_ndf.NEWTON_MAXITER)
    for flag in (True, False):
        alpha, _, gamma_slots = ndf.method_constants(flag, torch.float64,
                                                     torch.device("cpu"))
        r_alpha, r_gamma = ref_adj._alpha_gamma(flag, jnp.float64)
        np.testing.assert_array_equal(alpha.numpy(), np.asarray(r_alpha))
        np.testing.assert_array_equal(gamma_slots.numpy(),
                                      np.asarray(r_gamma))


def test_transforms_match_reference():
    order, factor = _orders_factors()
    o_t, f_t = torch.from_numpy(order), torch.from_numpy(factor)
    o_j, f_j = jnp.asarray(order, jnp.int32), jnp.asarray(factor)
    np.testing.assert_array_equal(
        ndf._r_matrix(o_t, f_t).numpy(),
        np.asarray(ref_ndf._r_matrix(o_j, f_j, jnp.float64)))
    ru = ndf._ru_matrix(o_t, f_t)
    ru_ref = ref_ndf._ru_matrix(o_j, f_j, jnp.float64)
    np.testing.assert_array_equal(ru.numpy(), np.asarray(ru_ref))
    rng = np.random.default_rng(4)
    D = rng.standard_normal((64, ndf._SLOTS, 6))
    np.testing.assert_array_equal(
        ndf._apply_ru(ru, torch.from_numpy(D)).numpy(),
        np.asarray(ref_ndf._apply_ru(ru_ref, jnp.asarray(D))))
    np.testing.assert_array_equal(
        ndf._change_D(torch.from_numpy(D), o_t, f_t).numpy(),
        np.asarray(ref_ndf._change_D(jnp.asarray(D), o_j, f_j)))
    p = rng.standard_normal((64, ndf._K, ndf._K))
    np.testing.assert_array_equal(
        ndf._compose_ru(torch.from_numpy(p), ru).numpy(),
        np.asarray(ref_ndf._compose_ru(jnp.asarray(p), ru_ref)))
    # R(order, 1) is an involution on each lane's block
    r1 = ndf._r_matrix(o_t, torch.ones_like(f_t))
    torch.testing.assert_close(ndf._matmul_seq(r1, r1),
                               torch.eye(ndf._K, dtype=torch.float64)
                               .expand(64, -1, -1), rtol=0, atol=1e-12)


def test_history_algebra_matches_reference():
    order, _ = _orders_factors()
    rng = np.random.default_rng(5)
    D = rng.standard_normal((64, ndf._SLOTS, 3))
    d = rng.standard_normal((64, 3))
    o_t, o_j = torch.from_numpy(order), jnp.asarray(order, jnp.int32)
    D_t, D_j = torch.from_numpy(D), jnp.asarray(D)
    np.testing.assert_array_equal(ndf._pick_slot(D_t, o_t).numpy(),
                                  np.asarray(ref_ndf._pick_slot(D_j, o_j)))
    vec = rng.standard_normal(ndf._K)
    np.testing.assert_array_equal(
        ndf._pick(torch.from_numpy(vec), o_t).numpy(),
        np.asarray(ref_ndf._pick(jnp.asarray(vec), o_j)))
    np.testing.assert_array_equal(
        ndf._hist_update(D_t, torch.from_numpy(d), o_t).numpy(),
        np.asarray(ref_adj._hist_update(D_j, jnp.asarray(d), o_j)))
    alpha, _, gamma_slots = ndf.method_constants(True, torch.float64,
                                                 torch.device("cpu"))
    r_alpha, r_gamma = ref_adj._alpha_gamma(True, jnp.float64)
    for got, ref in zip(ndf._predict(D_t, o_t, gamma_slots, alpha),
                        ref_adj._predict(D_j, o_j, r_gamma, r_alpha)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    t = rng.uniform(0.0, 1.0, 64)
    h = rng.uniform(1e-3, 0.1, 64)
    th = rng.uniform(0.0, 1.0, 64)
    got = ndf._bdf_interp(D_t, torch.from_numpy(t), torch.from_numpy(h),
                          o_t)(torch.from_numpy(th)[:, None])[:, 0]
    ref = ref_adj._bdf_interp(D_j, jnp.asarray(t), jnp.asarray(h),
                              o_j)(jnp.asarray(th))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-14)


def test_terminal_mode_raises():
    y0 = torch.zeros((1, 2), dtype=torch.float64)
    seeds = torch.zeros((1, 1, 2), dtype=torch.float64)

    def f(t, y, a):
        return -y

    for kw in (dict(t_eval=np.array([0.5, 1.0])),
               dict(events=Event(lambda t, y, a: y[..., 0] - 0.5))):
        with pytest.raises(ValueError,
                           match="terminal-mode.*torch.func.jvp") as err:
            solve_ivp(f, (0.0, 1.0), y0, method="bdf", tangents=seeds, **kw)
        assert "jax" not in str(err.value)
    for kw in (dict(quad=lambda t, y, a: y[:, 0]), dict(dense=8)):
        with pytest.raises(ValueError, match="terminal-mode"):
            solve_ivp(f, (0.0, 1.0), y0, method="bdf", tangents=seeds, **kw)
    with pytest.raises(ValueError, match="pivoting=False"):
        solve_ivp(f, (0.0, 1.0), y0, method="bdf", kernel_lu=True)
    with pytest.raises(ValueError, match="drop jac="):
        solve_ivp(f, (0.0, 1.0), y0, method="bdf",
                  jac=lambda t, y, a: torch.zeros((1, 2, 2)),
                  options=Options(stage_solver="gmres"))
    with pytest.raises(ValueError, match="_mesh_size"):
        ndf.solve_bdf(f, 0.0, 1.0, y0, dense=8, _mesh_size=8)


@pytest.mark.slow
def test_robertson_long_horizon_matches_reference():
    def rob(xp):
        def rhs(t, y, a):
            d1 = -0.04 * y[:, 0] + 1e4 * y[:, 1] * y[:, 2]
            d3 = 3e7 * y[:, 1] ** 2
            return xp.stack([d1, -d1 - d3, d3], -1)
        return rhs

    y0 = np.array([[1.0, 0.0, 0.0]])
    o = RefOptions(rtol=1e-7, atol=1e-12)
    ref = ref_ndf.solve_bdf(rob(jnp), 0.0, 1e5, jnp.asarray(y0), None, o)
    got = ndf.solve_bdf(rob(torch), 0.0, 1e5, torch.from_numpy(y0), None,
                        options_from_jax(o))
    _compare(got, ref, 1e-10)


@pytest.mark.slow
def test_order_climbs_on_a_long_run_matches_reference():
    y0 = np.array([[2.0, 0.0]])
    o = RefOptions(rtol=1e-7, atol=1e-10)
    ref = ref_ndf.solve_bdf(_vdp(jnp), 0.0, 50.0, jnp.asarray(y0),
                            jnp.asarray([100.0]), o)
    got = ndf.solve_bdf(_vdp(torch), 0.0, 50.0, torch.from_numpy(y0),
                        torch.tensor([100.0], dtype=torch.float64),
                        options_from_jax(o))
    _compare(got, ref, 1e-10)
    assert int(got.stats["order"][0]) >= 3
