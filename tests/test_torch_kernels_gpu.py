"""The CUDA kernels K1-K4 against their plain torch twins, on a CUDA card.

Marked ``gpu``: skips where torch.cuda.is_available() is false. Imports no
jax, so on the GPU machine it runs without the repo's conftest:

    python -m pytest tests/test_torch_kernels_gpu.py --noconftest -q

K1-K3: M = 65,536 and a ragged 700, D ∈ {2, 3, 4, 6}; random diagonally
dominant matrices (+5·I). Tolerance, relative to the largest entry of the
twin's result: f64 1e-12, f32 1e-5. The kernels are built without FMA
contraction and measured equal to their twins to the bit; the bounds leave
room for a compiler that orders an operation otherwise.

K4 (one fused Radau5 step attempt): M = 65,536 and 700 lanes of stiff Van
der Pol (μ = logspace(1, 3)) and Robertson (tf = logspace(−2, 2)), each
after five twin attempts so that warm start, controller history and
rejections are live; one kernel attempt against one ``_step_ref`` attempt.
Flags and counters exactly equal on at least 99.9% of lanes (the rest sit
at a decision boundary where an ulp of libm ``pow`` flips a compare);
on the agreeing lanes every value row within f64 1e-12 / f32 1e-5 of that
row's largest entry.
"""

import numpy as np
import pytest
import torch

from janus_tpu_torch.models.problems import robertson_rhs, vdp_rhs
from janus_tpu_torch.ops import radau_fused as k4
from janus_tpu_torch.ops import smalllu
from janus_tpu_torch.solve import Options
from janus_tpu_torch.solve import radau_fused as rf

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 1e-5)])
@pytest.mark.parametrize("m", [65536, 700])
@pytest.mark.parametrize("d", [2, 3, 4, 6])
def test_kernels_match_twins_on_card(d, m, dtype, rtol):
    dev = _card()
    rng = np.random.default_rng(d * 7919 + m)
    a = rng.standard_normal((m, d, d)) + 5.0 * np.eye(d)
    b = rng.standard_normal((m, d))
    a_t = torch.from_numpy(np.ascontiguousarray(
        a.transpose(1, 2, 0).reshape(d * d, m))).to(dev, dtype)
    b_t = torch.from_numpy(np.ascontiguousarray(b.T)).to(dev, dtype)
    lu_ref = smalllu.lu_factor_t_ref(a_t)
    launches = (smalllu.lu_factor_t.launches, smalllu.lu_solve_t.launches,
                smalllu.linsolve_fused.launches)
    for got, ref in ((smalllu.lu_factor_t(a_t), lu_ref),
                     (smalllu.lu_solve_t(lu_ref, b_t),
                      smalllu.lu_solve_t_ref(lu_ref, b_t)),
                     (smalllu.linsolve_fused(a_t, b_t),
                      smalllu.linsolve_fused_ref(a_t, b_t))):
        torch.cuda.synchronize()
        assert float((got - ref).abs().max()) <= rtol * float(ref.abs().max())
    assert (smalllu.lu_factor_t.launches, smalllu.lu_solve_t.launches,
            smalllu.linsolve_fused.launches) == tuple(n + 1 for n in launches)


def k4_setup(problem, m, dtype, dev, seed=0):
    """(f, args, packed state after five twin attempts, tf_row, consts)."""
    rng = np.random.default_rng(seed)
    if problem == "vdp":
        f, tf = vdp_rhs, 1.0
        y0 = np.tile([2.0, 0.0], (m, 1)) + 0.1 * rng.standard_normal((m, 2))
        args = torch.logspace(1, 3, m, dtype=dtype, device=dev)
        opts = Options(rtol=1e-6, atol=1e-9)
    else:
        f, args = robertson_rhs, None
        tf = torch.logspace(-2, 2, m, dtype=dtype, device=dev)
        y0 = np.tile([1.0, 0.0, 0.0], (m, 1))
        opts = Options(rtol=1e-6, atol=1e-10)
    y0 = torch.from_numpy(y0).to(dev, dtype)
    state, tf_row = rf.initial_state(f, 0.0, tf, y0, args, opts)
    consts = rf.step_consts(opts, dtype)
    rows, treedef = rf.arg_rows(args, state[0])
    for _ in range(5):
        state = rf._step_ref(state, tf_row, rows, f, treedef, consts)
    return f, args, state, tf_row, consts


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 1e-5)])
@pytest.mark.parametrize("m", [65536, 700])
@pytest.mark.parametrize("problem", ["vdp", "robertson"])
def test_k4_one_attempt_matches_twin_on_card(problem, m, dtype, rtol):
    dev = _card()
    f, args, state, tf_row, consts = k4_setup(problem, m, dtype, dev)
    dim = (state.shape[0] - 15) // 5
    rows, treedef = rf.arg_rows(args, state[0])
    ref = rf._step_ref(state, tf_row, rows, f, treedef, consts)
    n = k4.radau5_step.launches
    got = k4.radau5_step(state.clone(), tf_row, f, args, consts)
    torch.cuda.synchronize()
    assert k4.radau5_step.launches == n + 1
    share, errs, _ = rf.state_agreement(got, ref, dim)
    assert share >= 0.999, share
    assert max(errs.values()) <= rtol, errs


@pytest.mark.gpu
def test_k4_refuses_unregistered_f_on_card():
    dev = _card()
    _, args, state, tf_row, consts = k4_setup("vdp", 64, torch.float64, dev)
    with pytest.raises(ValueError, match="registered problems"):
        k4.radau5_step(state, tf_row, lambda t, y, a: vdp_rhs(t, y, a),
                       args, consts)
