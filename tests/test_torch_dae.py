"""Mass matrices (``mass=``) in the port's ``solve_radau`` against the JAX
package's, on the CPU in float64.

The index-1 and batched-mass cases of the reference's own DAE tests, and an
FEM-style tridiagonal mass on a Fisher-KPP line, each through the dense
stage LU (pivoted, pivot-free, and the kernels' plain twins with
``kernel_lu=True``, as the reference with ``pallas_lu=True``) and through
the matrix-free solvers. Inputs are made with numpy. Tolerances: status and
the per-lane counters equal, y to rtol 1e-8 / atol 1e-10; IND sensitivities
with a mass to 1e-8 relative to the largest entry of the reference's.

The constrained oscillator runs at rtol 1e-8 here, where the reference's own
test runs it at 1e-10. At 1e-10 the error estimate is a difference of stage
values that agree to ~1e-6 of it, so the two packages' rounding (a different
summation order in the stage contractions) moves the proposed step by ~3e-7
of itself from the first attempt that leaves the controller's deadzone
(attempt 141, y still equal to the bit), and after ~400 steps one package
takes a step more than the other. ``test_oscillator_at_the_rounding_floor``
holds that run to y within 1e-8 and the step counts within 2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janus_tpu.solve import Options as RefOptions
from janus_tpu.solve.radau import solve_radau as ref_solve_radau
from janus_tpu_torch.interop import options_from_jax, tree_to_torch
from janus_tpu_torch.solve import solve_ivp
from janus_tpu_torch.solve.radau import solve_radau
from test_torch_mol_cases import as_jax, close, line_case

torch.set_num_threads(1)

STATS = ("naccept", "nreject", "nsteps", "njev", "nlu", "nfev", "nnewton")


def _stack(xp, cols):
    return xp.stack(cols, **({"axis": -1} if xp is jnp else {"dim": -1}))


def _exponential(xp):
    """M = diag(1,0):  y1' = −y1 ;  0 = y2 − y1  ⇒ y1 = y2 = e^{−t}."""
    return lambda t, y, args: _stack(xp, [-y[..., 0], y[..., 1] - y[..., 0]])


def _oscillator(xp):
    """q' = v, v' = −q, 0 = z − q² (index 1): M = diag(1,1,0)."""
    def f(t, y, args):
        q, v, z = y[..., 0], y[..., 1], y[..., 2]
        return _stack(xp, [v, -q, z - q * q])
    return f


PROBLEMS = {
    "index1-exponential": dict(
        f=_exponential, y0=np.array([[1.0, 1.0]]), tf=2.0,
        mass=np.diag([1.0, 0.0]), rtol=1e-9, atol=1e-12,
        exact=lambda y: np.testing.assert_allclose(y[0], np.exp(-2.0),
                                                   rtol=1e-7)),
    "index1-oscillator": dict(
        f=_oscillator, y0=np.array([[1.0, 0.0, 1.0]]), tf=3.0,
        mass=np.diag([1.0, 1.0, 0.0]), rtol=1e-8, atol=1e-11,
        exact=lambda y: np.testing.assert_allclose(
            y[0, [0, 2]], [np.cos(3.0), np.cos(3.0) ** 2], rtol=1e-6)),
    "batched-mass": dict(
        f=_exponential, y0=np.array([[1.0, 1.0], [1.0, 1.0]]), tf=1.0,
        mass=np.stack([np.diag([1.0, 0.0]), np.eye(2)]), rtol=1e-9,
        atol=1e-12,
        exact=lambda y: np.testing.assert_allclose(
            [y[0, 0], y[0, 1], y[1, 0]], np.exp(-1.0), rtol=1e-7)),
}

SOLVERS = {
    "lu-pivot": dict(),
    "lu-nopivot": dict(pivoting=False),
    "lu-kernel-twins": dict(pivoting=False, pallas_lu=True),
    "gmres": dict(stage_solver="gmres", gmres_iters=6),
}


def _compare(got, ref):
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    for k in STATS:
        np.testing.assert_array_equal(got.stats[k].numpy(),
                                      np.asarray(ref.stats[k]), err_msg=k)
    np.testing.assert_allclose(got.y.numpy(), np.asarray(ref.y), rtol=1e-8,
                               atol=1e-10)


@pytest.mark.parametrize("solver", list(SOLVERS))
@pytest.mark.parametrize("problem", list(PROBLEMS))
def test_mass_matches_reference(problem, solver):
    p = PROBLEMS[problem]
    ref_opts = RefOptions(rtol=p["rtol"], atol=p["atol"], **SOLVERS[solver])
    ref = ref_solve_radau(p["f"](jnp), 0.0, p["tf"], jnp.asarray(p["y0"]),
                          mass=jnp.asarray(p["mass"]), options=ref_opts)
    got = solve_radau(p["f"](torch), 0.0, p["tf"],
                      tree_to_torch(p["y0"], device="cpu"),
                      mass=tree_to_torch(p["mass"], device="cpu"),
                      options=options_from_jax(ref_opts))
    assert bool((got.status == 1).all())
    _compare(got, ref)
    p["exact"](got.y.numpy())


def test_oscillator_at_the_rounding_floor():
    p = PROBLEMS["index1-oscillator"]
    ref_opts = RefOptions(rtol=1e-10, atol=1e-13)
    ref = ref_solve_radau(p["f"](jnp), 0.0, p["tf"], jnp.asarray(p["y0"]),
                          mass=jnp.asarray(p["mass"]), options=ref_opts)
    got = solve_radau(p["f"](torch), 0.0, p["tf"],
                      tree_to_torch(p["y0"], device="cpu"),
                      mass=tree_to_torch(p["mass"], device="cpu"),
                      options=options_from_jax(ref_opts))
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    np.testing.assert_allclose(got.y.numpy(), np.asarray(ref.y), rtol=1e-8,
                               atol=1e-10)
    for k in ("naccept", "nsteps"):
        assert abs(int(got.stats[k][0]) - int(ref.stats[k][0])) <= 2, k
    p["exact"](got.y.numpy())


@pytest.mark.parametrize("solver", ["gmres", "tridiag"])
def test_tridiagonal_mass_on_a_line(solver):
    """FEM-style mass (2/3, 1/6, 1/6) on the D=24 Fisher-KPP line: the mass
    bands join the probed Jacobian bands in the preconditioner."""
    ref_f, f, y0, args = line_case(d=24, m=2)
    d = y0.shape[1]
    mass = np.eye(d) * 2.0 / 3.0 + np.eye(d, k=1) / 6.0 + np.eye(d, k=-1) / 6.0
    ref_opts = RefOptions(rtol=1e-5, atol=1e-8, stage_solver=solver,
                          gmres_iters=10)
    ref = ref_solve_radau(ref_f, 0.0, 0.2, jnp.asarray(y0), args=as_jax(args),
                          mass=jnp.asarray(mass), options=ref_opts)
    got = solve_radau(f, 0.0, 0.2, tree_to_torch(y0, device="cpu"),
                      args=tree_to_torch(args, device="cpu"),
                      mass=tree_to_torch(mass, device="cpu"),
                      options=options_from_jax(ref_opts))
    assert bool((got.status == 1).all())
    _compare(got, ref)


def test_mass_with_ind_tangents():
    p = PROBLEMS["batched-mass"]
    seeds = np.stack([np.tile(np.eye(2)[j], (2, 1)) for j in range(2)])
    ref_opts = RefOptions(rtol=1e-8, atol=1e-11)
    ref = ref_solve_radau(p["f"](jnp), 0.0, 1.0, jnp.asarray(p["y0"]),
                          mass=jnp.asarray(p["mass"]), options=ref_opts,
                          tangents=jnp.asarray(seeds))
    got = solve_radau(p["f"](torch), 0.0, 1.0,
                      tree_to_torch(p["y0"], device="cpu"),
                      mass=tree_to_torch(p["mass"], device="cpu"),
                      options=options_from_jax(ref_opts),
                      tangents=tree_to_torch(seeds, device="cpu"))
    _compare(got, ref)
    close(got.sens, ref.sens, 1e-8, "sens")


def test_index2_weights_with_a_mass():
    """Options(nind1/nind2) reach the norms when a mass is given: an
    index-2 Hessenberg system  x' = −x + z, 0 = x − e^{−t}·c  written with
    M = diag(1, 0) and its second component weighted as index 2."""
    mass = np.diag([1.0, 0.0])

    def make(xp):
        def f(t, y, args):
            x, z = y[..., 0], y[..., 1]
            return _stack(xp, [-x + z, x - xp.exp(-2.0 * t)])
        return f

    ref_opts = RefOptions(rtol=1e-6, atol=1e-9, nind1=1, nind2=1, h0=1e-3)
    y0 = np.array([[1.0, -1.0]])
    ref = ref_solve_radau(make(jnp), 0.0, 0.5, jnp.asarray(y0),
                          mass=jnp.asarray(mass), options=ref_opts)
    got = solve_radau(make(torch), 0.0, 0.5, tree_to_torch(y0, device="cpu"),
                      mass=tree_to_torch(mass, device="cpu"),
                      options=options_from_jax(ref_opts))
    _compare(got, ref)
    np.testing.assert_allclose(got.y.numpy()[0, 0], np.exp(-1.0), rtol=1e-5)


def test_solve_ivp_takes_a_mass_and_checks_its_shape():
    p = PROBLEMS["index1-exponential"]
    got = solve_ivp(p["f"](torch), (0.0, 2.0), p["y0"], method="radau5",
                    mass=p["mass"], device="cpu", rtol=1e-9, atol=1e-12)
    p["exact"](got.y.numpy())
    with pytest.raises(ValueError, match="mass must be"):
        solve_radau(p["f"](torch), 0.0, 1.0, torch.from_numpy(p["y0"]),
                    mass=torch.eye(3, dtype=torch.float64))
    with pytest.raises(ValueError, match="does not support a mass"):
        solve_ivp(p["f"](torch), (0.0, 1.0), torch.from_numpy(p["y0"]),
                  method="radau_fused", mass=torch.eye(2, dtype=torch.float64))
