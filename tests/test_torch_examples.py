"""The port's examples (janus_tpu_torch/examples/) against the reference's
(examples/), on the CPU in float64 unless stated.

- stiff_vdp_batch at 256 lanes against the reference's solve_radau with the
  same options;
- learned_continuation's corrector and dataset on 4 instances against the
  reference's, and the homotopy's step counts under the reference's trained
  policy carried across with interop.tree_to_torch;
- train_nn_hamiltonian's learned field and the loss gradient through
  odeint_fixed on the reference's parameters, and one optax Adam update
  against torch.optim.Adam (the optimizer the port's examples use);
- both training examples end to end with their own asserts.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from janus_tpu.control.homotopy import homotopy as j_homotopy
from janus_tpu.models.neural import mlp_apply as j_mlp_apply
from janus_tpu.models.neural import mlp_init as j_mlp_init
from janus_tpu.models.problems import vdp_jac as j_vdp_jac
from janus_tpu.models.problems import vdp_rhs as j_vdp_rhs
from janus_tpu.solve import Options as JOptions
from janus_tpu.solve.fixed import odeint_fixed as j_odeint_fixed
from janus_tpu.solve.radau import solve_radau as j_solve_radau
from janus_tpu_torch.control.homotopy import homotopy
from janus_tpu_torch.examples import learned_continuation as lc
from janus_tpu_torch.examples import stiff_vdp_batch
from janus_tpu_torch.examples import train_nn_hamiltonian as tnh
from janus_tpu_torch.interop import tree_to_torch
from janus_tpu_torch.solve.common import tree_leaves
from janus_tpu_torch.solve.fixed import odeint_fixed

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))
import learned_continuation as lc_ref  # noqa: E402
import train_nn_hamiltonian as tnh_ref  # noqa: E402

CPU = torch.device("cpu")


def test_stiff_vdp_batch_matches_reference():
    m = 256
    y, status, nsteps = stiff_vdp_batch.main(m, device="cpu")
    y0 = jnp.tile(jnp.array([[2.0, 0.0]]), (m, 1)) + 1e-6
    sol = jax.jit(lambda z, mm: j_solve_radau(
        j_vdp_rhs, 0.0, 1.0, z, args=mm, jac=j_vdp_jac,
        options=JOptions(rtol=1e-8, atol=1e-11, pivoting=False)))(
            y0, jnp.logspace(1, 3, m))
    np.testing.assert_array_equal(status.numpy(), np.asarray(sol.status))
    assert bool((status == 1).all())
    np.testing.assert_array_equal(nsteps.numpy(),
                                  np.asarray(sol.stats["nsteps"]))
    np.testing.assert_allclose(y.numpy(), np.asarray(sol.y), rtol=1e-10,
                               atol=1e-12)


CS4 = np.array([0.1, 0.4, 0.7, 0.8])


def test_corrector_and_dataset_match_reference():
    lam = np.array([0.3, 0.6, 0.9, 1.0])
    x0 = np.zeros((4, 2))
    xj, okj = lc_ref.corrector_survives(lc_ref.family_g(jnp.asarray(CS4)),
                                        jnp.asarray(x0), jnp.asarray(lam))
    xt, okt = lc.corrector_survives(
        lc.family_g(torch.as_tensor(CS4)), torch.as_tensor(x0),
        torch.as_tensor(lam))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert 0 < int(okt.sum()) < 4          # both outcomes occur
    fin = np.isfinite(np.asarray(xj))
    np.testing.assert_allclose(xt.numpy()[fin], np.asarray(xj)[fin],
                               rtol=1e-12, atol=1e-12)
    fj, lj = lc_ref.generate_dataset(CS4)
    ft, lt = lc.generate_dataset(CS4, device="cpu")
    np.testing.assert_array_equal(ft, np.asarray(fj))
    np.testing.assert_array_equal(lt, np.asarray(lj))


def test_homotopy_steps_under_the_reference_policy():
    feats, labels = lc.generate_dataset(CS4, device="cpu")
    params_j, _ = lc_ref.train_policy(feats, labels, steps=100)
    params_t = tree_to_torch(params_j, device="cpu")
    cs_test = np.linspace(0.15, 0.79, 16)
    ct_j, ct_t = jnp.asarray(cs_test), torch.as_tensor(cs_test)

    def policy_j(x, lam, dlam):     # the reference main's dlam_policy
        f = jnp.stack([lam, ct_j], axis=-1).astype(jnp.float32)
        return 0.8 * jnp.exp(j_mlp_apply(params_j, f)[:, 0]).astype(x.dtype)

    rj = j_homotopy(lc_ref.family_g(ct_j), jnp.zeros((16, 2)), dlam0=0.05,
                    tol=lc_ref.TOL, dlam_fn=policy_j)
    rt = homotopy(lc.family_g(ct_t), torch.zeros((16, 2),
                                                 dtype=torch.float64),
                  dlam0=0.05, tol=lc.TOL, dlam_fn=lc.policy(params_t, ct_t))
    np.testing.assert_array_equal(rt.iters.numpy(), np.asarray(rj.iters))
    np.testing.assert_array_equal(rt.converged.numpy(),
                                  np.asarray(rj.converged))
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-9,
                               atol=1e-12)


def _ref_params():
    return j_mlp_init(jax.random.PRNGKey(0), [2, 32, 32, 1], jnp.float64)


def _pairs(tree_t, tree_j):
    """Matching leaves of the port's and the reference's MLP trees (jax
    orders dict keys, the port keeps insertion order)."""
    return [(a, b) for k in ("w", "b") for a, b in zip(tree_t[k], tree_j[k])]


def test_learned_field_and_training_gradient_match_reference():
    params_j = _ref_params()
    params_t = tree_to_torch(params_j, device="cpu")
    x = np.random.default_rng(0).standard_normal((16, 2))
    target = np.random.default_rng(1).standard_normal((16, 2))
    np.testing.assert_allclose(
        tnh.nn_rhs(None, torch.as_tensor(x), params_t).numpy(),
        np.asarray(tnh_ref.nn_rhs(None, jnp.asarray(x), params_j)),
        rtol=1e-13, atol=1e-14)

    def loss_j(p):
        pred = j_odeint_fixed(tnh_ref.nn_rhs, 0.0, 0.5, jnp.asarray(x),
                              n_steps=16, args=p)
        return jnp.mean((pred - target) ** 2)

    lj, gj = jax.value_and_grad(loss_j)(params_j)
    for p in tree_leaves(params_t):
        p.requires_grad_()
    pred = odeint_fixed(tnh.nn_rhs, 0.0, 0.5, torch.as_tensor(x), n_steps=16,
                        args=params_t, remat=False)
    lt = torch.mean((pred - torch.as_tensor(target)) ** 2)
    lt.backward()
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-13)
    for a, b in _pairs(params_t, gj):
        # the output bias does not enter dH/dy: no grad here, zeros there
        got = torch.zeros_like(a) if a.grad is None else a.grad
        np.testing.assert_allclose(got.numpy(), np.asarray(b), rtol=1e-10,
                                   atol=1e-14)


def test_one_adam_update_matches_optax():
    params_j = _ref_params()
    rng = np.random.default_rng(2)
    grads = [jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape)), params_j)
        for _ in range(2)]
    opt = optax.adam(3e-3)
    st = opt.init(params_j)
    pj = params_j
    for g in grads:
        up, st = opt.update(g, st)
        pj = optax.apply_updates(pj, up)
    params_t = tree_to_torch(params_j, device="cpu")
    topt = torch.optim.Adam(tree_leaves(params_t), lr=3e-3)
    for g in grads:
        for p, gg in _pairs(params_t, g):
            p.grad = torch.as_tensor(np.asarray(gg))
        topt.step()
    for a, b in _pairs(params_t, pj):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-14, atol=1e-16)


def test_learned_continuation_end_to_end():
    r_fixed, _, r_ml = lc.main(device="cpu")
    assert bool(r_ml.converged.all())
    assert float(r_ml.iters.double().mean()) < float(
        r_fixed.iters.double().mean())


@pytest.mark.slow
def test_train_nn_hamiltonian_end_to_end(tmp_path):
    rep = {}
    err = tnh.main(workdir=tmp_path, device="cpu", report=rep)
    assert err < 0.05 and rep["loss"] < rep["loss0"]
