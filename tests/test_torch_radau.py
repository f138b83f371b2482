"""Fixed-stage Radau IIA of the port against the JAX reference, on the CPU.

Both packages solve the same stiff Van der Pol batch (M = 32 lanes,
μ = logspace(1, 3), t ∈ [0, 1], rtol 1e-6, float64), its state carried
across by janus_tpu_torch.interop. Tolerances: status and the per-lane
counters naccept, nreject, nsteps, njev, nlu, nfev and nnewton equal; t and
y to rtol 1e-10; sens per lane to rtol 1e-8 of the lane's largest
component plus 10× the port's own spread: how far the port's sens move
when its inputs y0 and μ change by one ulp (a second port solve). The
stiff lanes' sensitivities are that ill-conditioned: measured, a one-ulp
input change moves them by up to ~4e-7 of the lane's largest component
for μ seeds and ~4e-10 for y0 seeds, and the two packages' rounding
differs by the same order.

With kernel_lu=True the port runs the plain twins of the CUDA kernels on
CPU tensors, and the reference with pallas_lu=True runs its pivot-free jnp
LU off the TPU: the same arithmetic.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janus_tpu.models.problems import vdp_jac as ref_vdp_jac
from janus_tpu.models.problems import vdp_rhs as ref_vdp_rhs
from janus_tpu.solve import Options as RefOptions
from janus_tpu.solve import solve_ivp as ref_solve_ivp
from janus_tpu.solve.radau import solve_radau as ref_solve_radau
from janus_tpu_torch.interop import options_from_jax, tree_to_torch
from janus_tpu_torch.models.problems import vdp_jac, vdp_rhs
from janus_tpu_torch.solve import Options, solve_ivp
from janus_tpu_torch.solve.radau import solve_radau

torch.set_num_threads(1)

M = 32
STATS = ("naccept", "nreject", "nsteps", "njev", "nlu", "nfev", "nnewton")


def _problem():
    rng = np.random.default_rng(1)
    y0 = np.tile([[2.0, 0.0]], (M, 1)) + 0.1 * rng.standard_normal((M, 2))
    mus = np.logspace(1, 3, M)
    seeds = np.stack([np.tile(np.eye(2)[j], (M, 1)) for j in range(2)])
    dmus = np.stack([mus * 1e-2, rng.standard_normal(M)])    # [K, M]
    return y0, mus, seeds, dmus


def _compare(got, ref, spread=None):
    """spread: the port's sens under a one-ulp input change (None: no sens)."""
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    for k in STATS:
        np.testing.assert_array_equal(got.stats[k].numpy(),
                                      np.asarray(ref.stats[k]), err_msg=k)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), rtol=1e-10)
    np.testing.assert_allclose(got.y.numpy(), np.asarray(ref.y), rtol=1e-10)
    if spread is None:
        assert got.sens is None and ref.sens is None
        return
    ref_sens = np.asarray(ref.sens)
    lane = (0, 2)                            # [K, M, D]: per-lane maxima
    err = np.abs(got.sens.numpy() - ref_sens).max(axis=lane)
    own = np.abs(got.sens.numpy() - spread.numpy()).max(axis=lane)
    bound = 1e-8 * np.abs(ref_sens).max(axis=lane) + 10.0 * own
    assert np.all(err <= bound), (err, bound)


CASES = {
    "s3-jac-pivot": dict(s=3, jac=True, pivoting=True),
    "s3-autojac-nopivot-sens-args": dict(s=3, jac=False, pivoting=False,
                                         tangents=True, args_tangents=True),
    # the bench.py main path: Radau9, pivot-free stage LU through K1/K2
    "s5-jac-kernel-sens": dict(s=5, jac=True, pivoting=False, kernel_lu=True,
                               tangents=True),
    "s5-autojac-pivot-compensated-sens": dict(s=5, jac=False, pivoting=True,
                                              compensated=True, tangents=True),
    "s5-jac-kernel-compensated-args": dict(s=5, jac=True, pivoting=False,
                                           kernel_lu=True, compensated=True,
                                           args_tangents=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_solve_radau_matches_reference(case):
    c = CASES[case]
    y0, mus, seeds, dmus = _problem()
    ref_opts = RefOptions(rtol=1e-6, atol=1e-9, min_stages=c["s"],
                          max_stages=c["s"], pivoting=c["pivoting"],
                          pallas_lu=c.get("kernel_lu", False),
                          compensated=c.get("compensated", False))
    opts = options_from_jax(ref_opts)
    assert opts.kernel_lu == c.get("kernel_lu", False)
    tan = seeds if c.get("tangents") else None
    atan = dmus if c.get("args_tangents") else None
    use_sens = tan is not None or atan is not None

    ref = ref_solve_radau(
        ref_vdp_rhs, 0.0, 1.0, jnp.asarray(y0), args=jnp.asarray(mus),
        options=ref_opts, jac=ref_vdp_jac if c["jac"] else None,
        tangents=None if tan is None else jnp.asarray(tan),
        args_tangents=None if atan is None else jnp.asarray(atan))
    def port(ulp):
        return solve_radau(
            vdp_rhs, 0.0, 1.0, tree_to_torch(y0 * (1 + ulp)),
            args=tree_to_torch(mus * (1 + ulp)), options=opts,
            jac=vdp_jac if c["jac"] else None,
            tangents=tree_to_torch(tan), args_tangents=tree_to_torch(atan))

    got = port(0.0)
    syncs = solve_radau.host_syncs
    assert bool((got.status == 1).all())
    _compare(got, ref, spread=port(2.0 ** -52).sens if use_sens else None)
    assert syncs >= int(got.stats["nsteps"].max())


def test_solve_ivp_radau9_matches_reference():
    y0, mus, _, _ = _problem()
    kw = dict(rtol=1e-6, atol=1e-9, pivoting=False)
    ref = ref_solve_ivp(ref_vdp_rhs, (0.0, 1.0), jnp.asarray(y0),
                        method="radau9", args={"mu": jnp.asarray(mus)},
                        jac=ref_vdp_jac, pallas_lu=True, **kw)
    got = solve_ivp(vdp_rhs, (0.0, 1.0), tree_to_torch(y0), method="radau9",
                    args=tree_to_torch({"mu": mus}), jac=vdp_jac,
                    kernel_lu=True, **kw)
    _compare(got, ref)


def test_options_from_jax_reads_every_field():
    ref = RefOptions(rtol=1e-7, atol=1e-10, max_step=0.5, min_stages=5,
                     max_stages=5, pivoting=False, pallas_lu=True,
                     compensated=True, newton_max_iter=9, max_steps=123)
    got = options_from_jax(ref)
    assert got == Options(rtol=1e-7, atol=1e-10, max_step=0.5, min_stages=5,
                          max_stages=5, pivoting=False, kernel_lu=True,
                          compensated=True, newton_max_iter=9, max_steps=123)
    assert options_from_jax(RefOptions()) == Options()


UNPORTED = {
    "t_eval": dict(t_eval=np.linspace(0.0, 1.0, 3)),
    "events": dict(events=lambda t, y, a: y[:, 0]),
    "dense": dict(dense=8),
    "quad": dict(quad=lambda t, y, a: y[:, 0]),
    "mass": dict(mass=torch.eye(2, dtype=torch.float64)),
    "step_args": dict(step_args=torch.ones((3, 1), dtype=torch.float64)),
    "record_steps": dict(options=Options(record_steps=4)),
    "qr_fallback": dict(options=Options(qr_fallback=True)),
    "stage_solver": dict(options=Options(stage_solver="gmres")),
    "_mesh_size": dict(_mesh_size=16),
}


@pytest.mark.parametrize("feature", list(UNPORTED))
def test_unported_features_raise(feature):
    y0 = torch.tensor([[2.0, 0.0]], dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="ported"):
        solve_radau(vdp_rhs, 0.0, 1.0, y0, args=10.0, **UNPORTED[feature])


def test_guards_and_methods_raise():
    y0 = torch.tensor([[2.0, 0.0]], dtype=torch.float64)
    with pytest.raises(ValueError, match="needs pivoting=False"):
        solve_radau(vdp_rhs, 0.0, 1.0, y0, args=10.0,
                    options=Options(kernel_lu=True))
    with pytest.raises(ValueError, match="mutually exclusive"):
        solve_radau(vdp_rhs, 0.0, 1.0, y0, args=10.0,
                    options=Options(kernel_lu=True, pivoting=False,
                                    qr_fallback=True))
    with pytest.raises(ValueError, match="unknown stage_solver"):
        solve_radau(vdp_rhs, 0.0, 1.0, y0, args=10.0,
                    options=Options(stage_solver="cg"))
    for method in ("dopri5", "rodas", "bdf", "radaup"):
        with pytest.raises(NotImplementedError, match="not ported"):
            solve_ivp(vdp_rhs, (0.0, 1.0), y0, method=method, args=10.0)
    with pytest.raises(NotImplementedError, match="variable-order"):
        solve_ivp(vdp_rhs, (0.0, 1.0), y0, method="radau", args=10.0,
                  min_stages=3, max_stages=7)
