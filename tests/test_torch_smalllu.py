"""Small batched LU of the port against the JAX reference, on the CPU.

- linalg.smalllu (lu_factor with and without pivoting, lu_ok, lu_solve)
  against janus_tpu.linalg.smalllu, d ∈ {2,3,4,6}, batch [M] and [M, P]:
  rtol 1e-13 with an absolute floor of 1e-13 on these O(1) matrices (the
  reference swaps pivot rows by one-hot arithmetic, x_k + (x_p − x_k),
  which rounds; the port swaps exactly).
- The plain twins of the CUDA kernels K1/K2 (ops.smalllu.lu_factor_t_ref /
  lu_solve_t_ref) against the Pallas kernels in interpret mode and against
  numpy, with a ragged M = 700: f64 rtol 1e-12; f32 rtol 1e-5 (the Pallas
  kernel multiplies by a reciprocal where the twin divides).
- The twin of K3 (ops.smalllu.linsolve_fused_ref) against the Pallas
  linsolve_fused in interpret mode (same arithmetic: f64 rtol 1e-12, f32
  rtol 1e-5 relative to the largest entry), against numpy and against the
  K1+K2 twins, d ∈ {2,3,4,6}, M = 700.
- The kernel wrappers run the twin only for CPU tensors and count no launch
  there; any other device raises.
- ``import janus_tpu_torch`` loads no jax.

The kernels themselves are checked on the card by test_torch_kernels_gpu.py.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janus_tpu.linalg import smalllu as ref_lu
from janus_tpu.ops.smalllu_pallas import linsolve_fused as pallas_fused
from janus_tpu.ops.smalllu_pallas import lu_factor_t as pallas_factor_t
from janus_tpu.ops.smalllu_pallas import lu_solve_t as pallas_solve_t
from janus_tpu_torch.linalg import smalllu as port_lu
from janus_tpu_torch.ops import smalllu as port_ops

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _matrices(rng, batch, d, singular_every=0):
    a = rng.standard_normal(batch + (d, d))
    if singular_every:
        # a few exactly singular lanes so lu_ok has something to reject
        flat = a.reshape(-1, d, d)
        flat[::singular_every, -1, :] = 0.0
    return a


@pytest.mark.parametrize("batch", [(40,), (12, 3)], ids=["M", "MxP"])
@pytest.mark.parametrize("pivot", [True, False], ids=["pivot", "nopivot"])
@pytest.mark.parametrize("d", [2, 3, 4, 6])
def test_lu_matches_reference(rng, d, pivot, batch):
    a = _matrices(rng, batch, d, singular_every=7)
    if not pivot:
        a = a + 5.0 * np.eye(d)          # pivot-free needs dominance
    b = rng.standard_normal(batch + (d,))
    bm = rng.standard_normal(batch + (d, 3))

    lu_r, piv_r = ref_lu.lu_factor(jnp.asarray(a), pivot=pivot)
    lu_p, piv_p = port_lu.lu_factor(torch.from_numpy(a), pivot=pivot)
    np.testing.assert_array_equal(piv_p.numpy(), np.asarray(piv_r))
    np.testing.assert_allclose(lu_p.numpy(), np.asarray(lu_r),
                               rtol=1e-13, atol=1e-13)
    np.testing.assert_array_equal(port_lu.lu_ok(lu_p).numpy(),
                                  np.asarray(ref_lu.lu_ok(lu_r)))

    for rhs in (b, bm):
        x_r = ref_lu.lu_solve(lu_r, piv_r, jnp.asarray(rhs))
        x_p = port_lu.lu_solve(lu_p, piv_p, torch.from_numpy(rhs))
        ok = np.asarray(ref_lu.lu_ok(lu_r))
        np.testing.assert_allclose(x_p.numpy()[ok], np.asarray(x_r)[ok],
                                   rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("d", [2, 3, 4, 6])
def test_twins_match_pallas_and_numpy(rng, d, dtype):
    m = 700                               # not a multiple of the 512 tile
    rtol = {"float32": 1e-5, "float64": 1e-12}[dtype]
    a = rng.standard_normal((m, d, d)) + 5.0 * np.eye(d)
    b = rng.standard_normal((m, d))
    a_t = np.ascontiguousarray(a.transpose(1, 2, 0).reshape(d * d, m)
                               ).astype(dtype)
    b_t = np.ascontiguousarray(b.T).astype(dtype)

    lu_twin = port_ops.lu_factor_t_ref(torch.from_numpy(a_t))
    x_twin = port_ops.lu_solve_t_ref(lu_twin, torch.from_numpy(b_t))
    lu_pl = pallas_factor_t(jnp.asarray(a_t), interpret=True)
    x_pl = pallas_solve_t(lu_pl, jnp.asarray(b_t), interpret=True)
    scale = np.abs(np.asarray(lu_pl)).max()
    np.testing.assert_allclose(lu_twin.numpy(), np.asarray(lu_pl),
                               rtol=rtol, atol=rtol * scale)
    np.testing.assert_allclose(x_twin.numpy(), np.asarray(x_pl),
                               rtol=rtol, atol=rtol)
    expect = np.linalg.solve(a, b[..., None])[..., 0]
    np.testing.assert_allclose(x_twin.numpy().T.astype(np.float64), expect,
                               rtol=100 * rtol, atol=100 * rtol)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("d", [2, 3, 4, 6])
def test_linsolve_fused_twin_matches_pallas_and_numpy(rng, d, dtype):
    m = 700                               # not a multiple of the 512 tile
    rtol = {"float32": 1e-5, "float64": 1e-12}[dtype]
    a = rng.standard_normal((m, d, d)) + 5.0 * np.eye(d)
    b = rng.standard_normal((m, d))
    a_t = np.ascontiguousarray(a.transpose(1, 2, 0).reshape(d * d, m)
                               ).astype(dtype)
    b_t = np.ascontiguousarray(b.T).astype(dtype)

    x_twin = port_ops.linsolve_fused_ref(torch.from_numpy(a_t),
                                         torch.from_numpy(b_t)).numpy()
    x_pl = np.asarray(pallas_fused(jnp.asarray(a_t), jnp.asarray(b_t),
                                   interpret=True))
    scale = np.abs(x_pl).max()
    np.testing.assert_allclose(x_twin, x_pl, rtol=rtol, atol=rtol * scale)
    # the K1+K2 twins solve the same systems (test_pallas_ops.py's check)
    lu = port_ops.lu_factor_t_ref(torch.from_numpy(a_t))
    x_k12 = port_ops.lu_solve_t_ref(lu, torch.from_numpy(b_t)).numpy()
    np.testing.assert_allclose(x_twin, x_k12, rtol=10 * rtol,
                               atol=10 * rtol * scale)
    expect = np.linalg.solve(a, b[..., None])[..., 0]
    np.testing.assert_allclose(x_twin.T.astype(np.float64), expect,
                               rtol=100 * rtol, atol=100 * rtol)


def test_wrappers_take_twin_only_on_cpu(rng):
    d, m = 3, 50
    a_t = torch.from_numpy(rng.standard_normal((d * d, m)))
    a_t[[0, 4, 8]] += 5.0                 # the diagonal entries
    b_t = torch.from_numpy(rng.standard_normal((d, m)))
    port_ops.reset_launch_counts()
    lu = port_ops.lu_factor_t(a_t)
    x = port_ops.lu_solve_t(lu, b_t)
    xf = port_ops.linsolve_fused(a_t, b_t)
    torch.testing.assert_close(xf, port_ops.linsolve_fused_ref(a_t, b_t),
                               rtol=0, atol=0)
    assert port_ops.linsolve_fused.launches == 0
    torch.testing.assert_close(lu, port_ops.lu_factor_t_ref(a_t), rtol=0,
                               atol=0)
    torch.testing.assert_close(x, port_ops.lu_solve_t_ref(lu, b_t), rtol=0,
                               atol=0)
    assert port_ops.lu_factor_t.launches == 0
    assert port_ops.lu_solve_t.launches == 0
    # any device other than the CPU must launch the kernel or raise: the
    # meta device has no kernel, so the wrapper raises (no twin fallback)
    with pytest.raises(ValueError, match="expected CUDA"):
        port_ops.lu_factor_t(a_t.to("meta"))
    with pytest.raises(ValueError, match="expected CUDA"):
        port_ops.lu_solve_t(lu.to("meta"), b_t.to("meta"))
    with pytest.raises(ValueError, match="expected CUDA"):
        port_ops.linsolve_fused(a_t.to("meta"), b_t.to("meta"))
    with pytest.raises(ValueError, match="D·D"):
        port_ops.lu_factor_t(torch.zeros(5, m, dtype=torch.float64))


def test_import_leaves_jax_out():
    code = ("import sys, janus_tpu_torch, janus_tpu_torch.interop, "
            "janus_tpu_torch.ops._build, janus_tpu_torch.models, "
            "janus_tpu_torch.linalg, janus_tpu_torch.ops.radau_fused, "
            "janus_tpu_torch.solve.radau_fused\n"
            "bad = [k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'janus_tpu')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
