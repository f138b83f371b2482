"""The CUDA kernels K1-K4 against their plain torch twins, on a CUDA card.

Marked ``gpu``: skips where torch.cuda.is_available() is false. Imports no
jax, so on the GPU machine it runs without the repo's conftest:

    python -m pytest tests/test_torch_kernels_gpu.py --noconftest -q

K1-K3: M = 65,536 and a ragged 700, D ∈ {2, 3, 4, 6}; random diagonally
dominant matrices (+5·I). Tolerance, relative to the largest entry of the
twin's result: f64 1e-12, f32 1e-5. The kernels are built without FMA
contraction and measured equal to their twins to the bit; the bounds leave
room for a compiler that orders an operation otherwise. Above the unrolled
sizes (K1/K3's tile kernels, K2's run-time-D kernel): D ∈ {15, 16, 17, 24,
28, 32, 56, 64}, M ∈ {65,536, 700, 65,535}, f64 and f32, with and without
exact zero pivots (K1's guard; K3's inf/NaN, NaN positions equal), each
equal to its twin to the bit (torch.equal); K1/K3 at 3-5 rows a thread
(D = 65, 100, 129, 700 lanes, zero pivots) to the bit; the tile and unrolled forms of K1/K3
at D = 9-16 both equal to the twins; the tile launch's own shared bytes,
occupancy and local bytes (none) against ops.smalllu.tile_geometry; a D
whose one lane does not fit refused by name.

K4 (fused Radau5 step attempts): lanes of stiff Van der Pol with
heterogeneous μ = logspace(1, 3) and of Robertson (tf = logspace(−2, 2)),
each after five twin attempts so that warm start, controller history and
rejections are live; a launch of up to 1 or 32 attempts against as many
``_step_ref`` attempts, at M = 65,536, a ragged 700, 4,096 (below one wave
of the card) and 4 × 65,536 (more lanes than the card holds at once),
f64 and f32, D = 2 and 3. Tolerance: none: every flag, counter and value
row equal to the bit (the kernel is built without FMA contraction and does the twin's
IEEE operations). Also K4's build on the card: at most 128 registers, so
that 65,536 lanes are resident at once (VdP, and Robertson in f32;
Robertson in f64 is built for 2 blocks per SM and spills nothing); a
numpy y0 solving on the card by default, and a CUDA y0 accepted with
device="cuda" or "cuda:0".

The matrix-free Radau path (no hand-written kernel): Thomas against PCR on
a CUDA tensor, real and complex, D=128, to 1e-10 relative, and the
tridiagonal algorithm a CUDA tensor gets by default; the D=128 Fisher-KPP
line with stage_solver='tridiag' on the card against the same solve on the
CPU for 8 lanes (status and step counts equal, y to rtol 1e-6 / atol 1e-9:
the card runs ``CUDA_TRIDIAG`` where the CPU runs Thomas, and they agree to
~1e-12 per solve).

The continuous adjoint on the card against the CPU, gradients to 1e-8
relative to their largest entry: the D=128 line's gradient (4 lanes,
'tridiag'), and a Van der Pol gradient whose forward solve goes through
K1/K2 (``kernel_lu=True``; K1 and K2 must have been launched), with the
interpolant of a ``dense=`` solve to 1e-9 and its mesh to 1e-7 (step sizes
amplify the two devices' rounding, as they do between the two packages).

The explicit family, its discrete adjoint and the rest of the Radau surface
(``janus_tpu_torch.bench.dopri``, chip_smoke's phase 16) on the card:
dopri5 and dopri853 on 256 Van der Pol lanes against the CPU (status and
counters equal, y to 1e-10 relative) with K1-K4 launched 0 times; the
neural-ODE gradient of 4 lanes against the CPU, and dL/dy0 of 4 lanes of a
256-lane batch against the CPU's gradient of those lanes alone (1e-7); the
Radau9 headline with constant step_args rows and record_steps equal to the
plain solve to the bit with the same K1/K2 launches (4,096 lanes);
radau_hvp on 256 lanes through K1/K2 against central differences of
radau_adjoint gradients; the qr_fallback mixed batch (4,096 lanes) against
its exact solutions and the CPU.

RODAS4, its discrete adjoint and events (``janus_tpu_torch.bench.rodas``,
chip_smoke's phase 15) on the card: solve_rodas with kernel_lu=True launches
K1 and K2 and equals the plain pivot-free LU on the card to 1e-12 (the
kernels equal their twins to the bit; the plain LU's batched ops may round
otherwise), tangents too; bench.py's rodas-adjoint gradient on 64 lanes
finite, the transpose oracle to 1e-10 and d/dμ against central differences
to 1e-4, and 4 lanes against the CPU to 1e-7; a terminal event on 256
Radau5 lanes: event_t, event_idx and status against the CPU (event_t to
1e-8 relative).

The NDF/BDF family (``janus_tpu_torch.bench.ndf``, chip_smoke's phase 17)
on the card: solve_bdf on 4,096 headline lanes (VdP μ = 1e3, rtol 1e-6,
K=2 IND) with kernel_lu=True launches K1 and K2 and matches the plain
pivot-free LU with all eight counters equal, y to 1e-10 and sens to 1e-5
relative to their largest entries; 4 lanes of the ndf_adjoint gradient of
the stiff adjoint configuration (through K1/K2) against the CPU to 1e-7.

SEULEX (``janus_tpu_torch.bench.seulex``, chip_smoke's phase 18) on the
card: solve_seulex on 4,096 headline lanes (K=2 IND) with kernel_lu=True
launches K1 and K2 and matches the plain pivot-free LU with all seven
counters equal, y to 1e-10 and sens to 1e-8; seulex_adjoint's gradient of
the stiff adjoint configuration (the recording forward through K1/K2) on
64 lanes: the replay reproduces the recorded mesh (1e-12), autograd of the
frozen replay chain agrees to 1e-10, d/dμ of 3 lanes to central
differences within 1e-4, and 4 lanes against the CPU to 1e-7.

The variable-order Radau ladder and the legacy steppers
(``janus_tpu_torch.bench.radaup``, chip_smoke's phase 19) on the card:
solve_radau_vo on 4,096 headline lanes (K=2 IND), and bdf2 and grk4t on
4,096 lanes of the chip-matrix batch, with kernel_lu=True launch K1 and K2
and equal the plain pivot-free LU to the bit (counters, y, sens); the
radaup gradient on 64 lanes: d/dμ of 3 lanes to central differences within
1e-4 and 4 lanes against the CPU to 1e-7; odeint_fixed's gradient on 1,024
harmonic lanes against the CPU to 1e-10.

The Hamiltonian-first API and the dual numbers
(``janus_tpu_torch.bench.ham``, chip_smoke's phase 20) on the card: the
Hamiltonian Van der Pol sensitivities (``solve_with_sensitivities`` with
the tf column, D=4, so K1 factors real 4x4 and split-complex 8x8 blocks) on
4,096 lanes through K1/K2 equal the plain pivot-free LU to the bit (status,
counters, y, Jet.d), K1 and K2 launched; forward mode through all nine
methods on CUDA tensors gives (2, 4) for y' = (a, 2a) (rtol 1e-6, atol
1e-8); the transform path (dopri5, a Jet omega and a Jet y0) on 256
harmonic lanes within 1e-10 of the CPU.

The infrastructure (``janus_tpu_torch.bench.infra``, chip_smoke's phase
22) on the card: bench.py's headline configuration at 8,192 lanes of
heterogeneous μ = logspace(1, 3) split over two processes on the one card
(a gloo group with its mesh on the host, ``parallel.lockstep``, each rank's
half through K1/K2, gathered through the group): y, sens, status and
naccept equal to the one-process solve to the bit; ``diag.trace`` around a
headline solve through K1/K2: the trace file, the radau.jacobian,
radau.factorize and radau.newton spans once an attempt with device time
under the last two (K1/K2 run there), no QR-fallback span (kernel_lu
refuses it); ``diag.device_memory_stats``'s keys.

The last eleven examples (``janus_tpu_torch.bench.examples``, chip_smoke's
phase 23) on the card: ``events_poincare`` and ``fit_mu_gauss_newton`` (one
Gauss–Newton step) at 8,192 lanes through K1/K2 equal to the plain
pivot-free LU to the bit (events: y, status, event_t, event_y; the fit:
μ̂, the residual and every IND sweep's y and sens), K1 and K2 launched;
``reverse_time.main`` on the card (the round trip within 1e-7).

K1-K3 beyond D = 16 (their run-time-D kernels): D = 17, 24 and 32, M =
4,096, f32 and f64, equal to their twins to the bit.

K4 through functors generated from a traced f (``ops.rhs_codegen``), on
``bench.fused_any``'s cases at D = 2, 3, 4, 6 and 8 (brusselator,
orego, ham_vdp, dubins_pmp, hires) in f64 and f32, at the lanes their
solves run (4,096; 65,536 at D = 6 and 8, and at D = 6 and 8 also the
ragged 700, 4,099 and 65,535 lanes, past a block's and a group's edge): a
launch of 1 and of 32 attempts from the initial state equal to as many
``_step_ref`` attempts to the bit; K4's layout at D = 5..8
(``ops.radau_fused.geometry``: threads a lane, lanes a block, the group
layout's scratch and blocks a SM) in the built unit's attributes, its
local bytes below the local-memory layout's readings and its registers
ptxas's, with D = 5 and 7 (``torch_rhs_cases.ring_rhs``) also equal to
``_step_ref`` on 4,099 lanes; the functor's f and Jacobian columns
(``Unit.eval_on_card``) equal to f and torch.func.jvp on the card to the
bit, and the test rhs of ``tests/test_torch_rhs_codegen.py`` (where,
maximum, minimum, clamp, exp, log, sqrt, abs, pow by -1, -2, 0.5, 1.5,
-0.5, a division by a number and one by a row) likewise, on 2^20 lanes;
a lambda around vdp_rhs and robertson_rhs equal to the hand-written
functor to the bit (solve and K4 rounds); an f that closes over tensors
on the card (a [D] row, a 0-dim tensor) and a 0-dim CPU tensor solved by
generated K4 equal to the twin loop to the bit; an f with an op the
tracer refuses raises ValueError naming it on a CUDA tensor without
running the twin.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from janus_tpu_torch import diag
from janus_tpu_torch.bench import dopri as dopri_probe
from janus_tpu_torch.bench import ham as ham_probe
from janus_tpu_torch.bench import infra
from janus_tpu_torch.bench import mol
from janus_tpu_torch.bench import ndf as ndf_probe
from janus_tpu_torch.bench import radaup as radaup_probe
from janus_tpu_torch.bench import rodas as rodas_probe
from janus_tpu_torch.bench import seulex as seulex_probe
from janus_tpu_torch.interop import tree_to_torch
from janus_tpu_torch.linalg import gmres as gm
from janus_tpu_torch.models.problems import robertson_rhs, vdp_rhs
from janus_tpu_torch.ops import radau_fused as k4
from janus_tpu_torch.ops import smalllu
from janus_tpu_torch.models.problems import vdp_jac
from janus_tpu_torch.solve import Options, radau_adjoint, solve_ivp
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


def _k4_against_twin(problem, m, dtype, max_attempts):
    """(kernel state, twin state) after max_attempts attempts of each."""
    dev = _card()
    f, args, state, tf_row, consts = k4_setup(problem, m, dtype, dev)
    rows, treedef = rf.arg_rows(args, state[0])
    ref = state
    for _ in range(max_attempts):
        ref = rf._step_ref(ref, tf_row, rows, f, treedef, consts)
    n = k4.radau5_step.launches
    got = k4.radau5_step(state.clone(), tf_row, f, args, consts,
                         max_attempts=max_attempts)
    torch.cuda.synchronize()
    assert k4.radau5_step.launches == n + 1
    return got, ref


def _assert_bit_equal(got, ref):
    dim = (got.shape[0] - 15) // 5
    share, errs, abs_err = rf.state_agreement(got, ref, dim)
    assert (share, abs_err) == (1.0, 0.0), (share, errs)
    assert torch.equal(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("m", [65536, 700])
@pytest.mark.parametrize("problem", ["vdp", "robertson"])
def test_k4_one_attempt_matches_twin_on_card(problem, m, dtype):
    _assert_bit_equal(*_k4_against_twin(problem, m, dtype, 1))


@pytest.mark.gpu
@pytest.mark.parametrize("max_attempts", [1, 32])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("m", [700, 4096, 4 * 65536])
@pytest.mark.parametrize("problem", ["vdp", "robertson"])
def test_k4_equals_twin_to_the_bit(problem, m, dtype, max_attempts):
    _assert_bit_equal(*_k4_against_twin(problem, m, dtype, max_attempts))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("f", [vdp_rhs, robertson_rhs])
def test_k4_registers_and_residency(f, dtype):
    """At most 128 registers and 65,536 lanes resident at once, except
    Robertson in f64, built for 2 blocks per SM and spilling nothing; the
    runtime's register count is ptxas's."""
    _card()
    from janus_tpu_torch.bench.kernels import k4_ptxas
    from janus_tpu_torch.ops._build import ptxas_log
    a = k4.kernel_attributes(f, dtype)
    name = f"{k4.DEVICE_PROBLEMS[f].functor} {str(dtype)[6:]}"
    regs, _, spill_st, spill_ld = k4_ptxas(ptxas_log())[name]
    assert regs == a["registers"], (regs, a)
    if f is robertson_rhs and dtype == torch.float64:
        assert a["blocks_per_sm"] >= 2 and (spill_st, spill_ld) == (0, 0), a
    else:
        assert regs <= 128 and a["resident_lanes"] >= 65536, a


@pytest.mark.gpu
def test_numpy_y0_solves_on_the_card():
    _card()
    y0 = np.tile([2.0, 0.0], (64, 1))
    for method in ("radau_fused", "radau5"):
        sol = solve_ivp(vdp_rhs, (0.0, 1.0), y0, method=method, args=100.0,
                        rtol=1e-6, atol=1e-9)
        assert sol.y.device.type == "cuda" and bool((sol.status == 1).all())
    assert tree_to_torch({"y": y0})["y"].device.type == "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("device", ["cuda", "cuda:0"])
@pytest.mark.parametrize("method", ["radau_fused", "radau5"])
def test_cuda_y0_with_device_cuda_solves(method, device):
    """A CUDA tensor y0 with device="cuda" (no index) or its own index
    solves where it lies; the CPU is refused."""
    dev = _card()
    y0 = torch.tensor([[2.0, 0.0]], dtype=torch.float64,
                      device=dev).repeat(64, 1)
    kw = dict(method=method, args=100.0, rtol=1e-6, atol=1e-9)
    sol = solve_ivp(vdp_rhs, (0.0, 1.0), y0, device=device, **kw)
    ref = solve_ivp(vdp_rhs, (0.0, 1.0), y0, **kw)
    assert sol.y.device == y0.device and torch.equal(sol.y, ref.y)
    with pytest.raises(ValueError, match="not copied"):
        solve_ivp(vdp_rhs, (0.0, 1.0), y0, device="cpu", **kw)


@pytest.mark.gpu
def test_k4_refuses_unregistered_f_on_card():
    """An f that is not registered and that the tracer refuses (an op
    outside its list) raises on the card, naming the op."""
    dev = _card()
    _, args, state, tf_row, consts = k4_setup("vdp", 64, torch.float64, dev)
    with pytest.raises(ValueError, match="aten.cumsum"):
        k4.radau5_step(state, tf_row,
                       lambda t, y, a: torch.cumsum(vdp_rhs(t, y, a), -1),
                       args, consts)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1024, 65536])
def test_thomas_matches_pcr_on_card(m):
    dev = _card()
    rng = np.random.default_rng(m)

    def z(shift=0.0):
        return torch.as_tensor(rng.normal(size=(m, 128)) + shift, device=dev)

    real = (z(), z(6.0), z(), z())
    x_t = gm.tridiag_solve_auto(*real, method="thomas")
    x_p = gm.tridiag_solve_auto(*real, method="pcr")
    assert float((x_t - x_p).abs().max() / x_t.abs().max()) <= 1e-10
    default = {"thomas": x_t, "pcr": x_p}[gm.CUDA_TRIDIAG]
    assert torch.equal(gm.tridiag_solve_auto(*real), default)
    cplx = ((z(), z()), (z(6.0), z()), (z(), z()), (z(), z()))
    c_t = torch.stack(gm.tridiag_solve_complex_auto(*cplx, method="thomas"))
    c_p = torch.stack(gm.tridiag_solve_complex_auto(*cplx, method="pcr"))
    assert float((c_t - c_p).abs().max() / c_t.abs().max()) <= 1e-10
    default = {"thomas": c_t, "pcr": c_p}[gm.CUDA_TRIDIAG]
    assert torch.equal(torch.stack(gm.tridiag_solve_complex_auto(*cplx)),
                       default)


@pytest.mark.gpu
@pytest.mark.parametrize("solver", ["tridiag", "gmres"])
def test_mol_solve_on_card_matches_cpu(solver):
    dev = _card()
    opts = Options(stage_solver=solver, gmres_iters=6, **mol.MOL_OPTS)
    sols = {}
    for where in (dev, torch.device("cpu")):
        rhs, y0, args = mol.mol_line(8, torch.float64, where)
        sols[where.type] = mol.solve_radau(rhs, 0.0, mol.TF_LINE, y0,
                                           args=args, options=opts)
    got, ref = sols["cuda"], sols["cpu"]
    assert got.y.is_cuda and bool((got.status == 1).all())
    assert torch.equal(got.status.cpu(), ref.status)
    for k in ("naccept", "nreject", "nnewton"):
        assert torch.equal(got.stats[k].cpu(), ref.stats[k]), k
    torch.testing.assert_close(got.y.cpu(), ref.y, rtol=1e-6, atol=1e-9)


@pytest.mark.gpu
def test_mol_gradient_on_card_matches_cpu():
    dev = _card()
    opts = Options(stage_solver="tridiag", adjoint_steps=mol.ADJ_STEPS,
                   **mol.MOL_OPTS)
    got = mol.line_gradient(4, torch.float64, dev, opts)
    ref = mol.line_gradient(4, torch.float64, torch.device("cpu"), opts)
    for a, b in zip(got, ref):
        assert a.is_cuda and bool(torch.isfinite(a).all())
        assert float((a.cpu() - b).abs().max() / b.abs().max()) <= 1e-8


@pytest.mark.gpu
def test_vdp_gradient_through_kernels_on_card_matches_cpu():
    dev = _card()
    opts = Options(rtol=1e-6, atol=1e-9, pivoting=False, kernel_lu=True,
                   adjoint_steps=128)
    rng = np.random.default_rng(17)
    y0_np = np.tile([[2.0, 0.0]], (64, 1)) + 0.1 * rng.standard_normal((64, 2))
    mu_np = np.geomspace(2.0, 1e3, 64)
    out = {}
    for where in (dev, torch.device("cpu")):
        y0 = torch.from_numpy(y0_np).to(where).requires_grad_()
        mu = torch.from_numpy(mu_np).to(where).requires_grad_()
        smalllu.reset_launch_counts()
        y = radau_adjoint(vdp_rhs, (0.0, 1.0), y0, args=mu, options=opts,
                          jac=vdp_jac)
        (y ** 2).sum().backward()
        if where.type == "cuda":
            assert smalllu.lu_factor_t.launches > 0
            assert smalllu.lu_solve_t.launches > 0
        sol = solve_ivp(vdp_rhs, (0.0, 1.0), y0.detach(), method="radau5",
                        args=mu.detach(), jac=vdp_jac, options=opts,
                        dense=128)
        out[where.type] = (y.detach().cpu(), y0.grad.cpu(), mu.grad.cpu(),
                           sol.interpolate(np.linspace(0, 1, 9)).cpu(),
                           sol.mesh["q"].cpu())
    names = ("y", "dL/dy0", "dL/dmu", "interpolate", "mesh q")
    errs = {n: float((a - b).abs().max() / b.abs().max())
            for n, a, b in zip(names, out["cuda"], out["cpu"])}
    assert all(bool(torch.isfinite(a).all()) for a in out["cuda"])
    for n, tol in zip(names, (1e-10, 1e-8, 1e-8, 1e-9, 1e-7)):
        assert errs[n] <= tol, errs


@pytest.mark.gpu
def test_rodas_kernels_on_card_match_plain_lu():
    dev = _card()
    smalllu.reset_launch_counts()
    got = rodas_probe.forward_solve(dev, True, m=1024)
    assert smalllu.lu_factor_t.launches > 0 and smalllu.lu_solve_t.launches > 0
    ref = rodas_probe.forward_solve(dev, False, m=1024)
    assert bool((got.status == 1).all())
    for k in ("naccept", "nreject"):
        assert torch.equal(got.stats[k], ref.stats[k]), k
    for k in ("y", "sens"):
        a, b = getattr(got, k), getattr(ref, k)
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-12, k


@pytest.mark.gpu
def test_rodas_adjoint_on_card_checks():
    dev = _card()
    g = rodas_probe.gradient(64, torch.float64, dev)
    assert all(x.is_cuda and bool(torch.isfinite(x).all()) for x in g[1:])
    errs = rodas_probe.check_gradient(g, torch.float64, dev)
    assert errs["transpose"] <= 1e-10 and errs["fd_mu"] <= 1e-4, errs
    got = rodas_probe.gradient(4, torch.float64, dev)
    ref = rodas_probe.gradient(4, torch.float64, torch.device("cpu"))
    for a, b in zip(got[1:], ref[1:]):
        assert float((a.cpu() - b).abs().max() / b.abs().max()) <= 1e-7


@pytest.mark.gpu
def test_events_on_card_match_cpu():
    dev = _card()
    got = rodas_probe.event_solve(256, dev)
    ref = rodas_probe.event_solve(256, torch.device("cpu"))
    assert torch.equal(got.event_idx.cpu(), ref.event_idx)
    assert torch.equal(got.status.cpu(), ref.status)
    hit = ref.event_idx >= 0
    assert 0 < int(hit.sum()) < 256
    rel = (got.event_t.cpu()[hit] - ref.event_t[hit]).abs() \
        / ref.event_t[hit].abs()
    assert float(rel.max()) <= 1e-8


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["dopri5", "dopri853"])
def test_dopri_on_card_matches_cpu(method):
    dev = _card()
    mol._reset_kernel_launches()
    got = dopri_probe.forward_solve(method, 256, dev)
    torch.cuda.synchronize()
    assert not any(mol._kernel_launches().values())
    ref = dopri_probe.forward_solve(method, 256, torch.device("cpu"))
    assert bool((got.status == 1).all())
    assert torch.equal(got.status.cpu(), ref.status)
    for k in ref.stats:
        assert torch.equal(got.stats[k].cpu(), ref.stats[k]), k
    assert float((got.y.cpu() - ref.y).abs().max() / ref.y.abs().max()) \
        <= 1e-10


@pytest.mark.gpu
def test_neural_ode_gradient_on_card_matches_cpu():
    assert dopri_probe.node_cpu_check(_card(), torch.float64, 0.0) <= 1e-7


@pytest.mark.gpu
def test_neural_ode_batch_lanes_on_card_match_cpu():
    dev = _card()
    data = dopri_probe.node_data(256, torch.float64, dev)
    data[0].requires_grad_()
    params = dopri_probe.node_params(torch.float64, dev)
    grads = dopri_probe.node_gradient(params, data, dopri_probe.REG)[1]
    assert dopri_probe.node_lane_check(params, data, dopri_probe.REG,
                                       grads[-1], [0, 85, 170, 255]) <= 1e-7


@pytest.mark.gpu
def test_step_args_headline_on_card():
    rec = dopri_probe.step_args_phase(_card(), m=4096)
    assert rec["launches"]["K1"] > 0 and rec["launches"]["K2"] > 0


@pytest.mark.gpu
def test_hvp_through_kernels_on_card():
    rec = dopri_probe.hvp_phase(_card(), m=256, smoke=True)
    assert rec["launches"]["K1"] > 0 and rec["fd_worst"] <= 1.0


@pytest.mark.gpu
def test_qr_fallback_on_card():
    rec = dopri_probe.qr_phase(_card(), m=4096)
    assert rec["cpu"] <= 1e-10


@pytest.mark.gpu
def test_ndf_kernels_on_card_match_plain_lu():
    dev = _card()
    smalllu.reset_launch_counts()
    got = ndf_probe.forward_solve(dev, True, m=4096)
    assert smalllu.lu_factor_t.launches > 0 and smalllu.lu_solve_t.launches > 0
    ref = ndf_probe.forward_solve(dev, False, m=4096)
    assert bool((got.status == 1).all())
    for k in ndf_probe.STATS:
        assert torch.equal(got.stats[k], ref.stats[k]), k
    for k, tol in (("y", 1e-10), ("sens", 1e-5)):
        a, b = getattr(got, k), getattr(ref, k)
        assert float((a - b).abs().max() / b.abs().max()) <= tol, k


@pytest.mark.gpu
def test_ndf_adjoint_on_card_matches_cpu():
    dev = _card()
    got = ndf_probe.gradient(4, torch.float64, dev)
    ref = ndf_probe.gradient(4, torch.float64, torch.device("cpu"))
    for a, b in zip(got[1:], ref[1:]):
        assert a.is_cuda and bool(torch.isfinite(a).all())
        assert float((a.cpu() - b).abs().max() / b.abs().max()) <= 1e-7


@pytest.mark.gpu
def test_seulex_kernels_on_card_match_plain_lu():
    dev = _card()
    smalllu.reset_launch_counts()
    got = seulex_probe.forward_solve(dev, True, m=4096)
    assert smalllu.lu_factor_t.launches > 0 and smalllu.lu_solve_t.launches > 0
    ref = seulex_probe.forward_solve(dev, False, m=4096)
    assert bool((got.status == 1).all())
    for k in seulex_probe.STATS:
        assert torch.equal(got.stats[k], ref.stats[k]), k
    for k, tol in (("y", 1e-10), ("sens", 1e-8)):
        a, b = getattr(got, k), getattr(ref, k)
        assert float((a - b).abs().max() / b.abs().max()) <= tol, k


@pytest.mark.gpu
def test_seulex_adjoint_on_card_checks():
    dev = _card()
    g = seulex_probe.gradient(64, torch.float64, dev)
    assert all(x.is_cuda and bool(torch.isfinite(x).all()) for x in g[1:])
    errs = seulex_probe.check_gradient(g, torch.float64, dev)
    assert errs["replay"] <= seulex_probe.REPLAY_BOUND, errs
    assert errs["chain"] <= 1e-10 and errs["fd_mu"] <= 1e-4, errs
    got = seulex_probe.gradient(4, torch.float64, dev)
    ref = seulex_probe.gradient(4, torch.float64, torch.device("cpu"))
    for a, b in zip(got[1:], ref[1:]):
        assert float((a.cpu() - b).abs().max() / b.abs().max()) <= 1e-7


def _bitwise(got, ref, stats, what):
    for k in stats:
        assert torch.equal(got.stats[k], ref.stats[k]), k
    for k in what:
        assert torch.equal(getattr(got, k), getattr(ref, k)), k


@pytest.mark.gpu
def test_radaup_kernels_on_card_equal_plain_lu():
    dev = _card()
    smalllu.reset_launch_counts()
    got = radaup_probe.forward_solve(dev, True, m=4096)
    assert smalllu.lu_factor_t.launches > 0 and smalllu.lu_solve_t.launches > 0
    ref = radaup_probe.forward_solve(dev, False, m=4096)
    assert bool((got.status == 1).all())
    _bitwise(got, ref, radaup_probe.STATS, ("t", "y", "sens"))


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["bdf2", "grk4t"])
def test_legacy_kernels_on_card_equal_plain_lu(method):
    dev = _card()
    smalllu.reset_launch_counts()
    got = radaup_probe.legacy_solve(method, dev, True, m=4096)
    assert smalllu.lu_factor_t.launches > 0 and smalllu.lu_solve_t.launches > 0
    ref = radaup_probe.legacy_solve(method, dev, False, m=4096)
    assert bool((got.status == 1).all())
    _bitwise(got, ref, got.stats, ("t", "y", "status"))


@pytest.mark.gpu
def test_radaup_adjoint_on_card_checks():
    dev = _card()
    g = radaup_probe.gradient(64, torch.float64, dev)
    assert all(x.is_cuda and bool(torch.isfinite(x).all()) for x in g[1:])
    y0, mus = radaup_probe.adj_inputs(64, torch.float64, dev)
    assert radaup_probe.fd_check(g[2], mus, y0, [0, 32, 63]) <= 1e-4
    got = radaup_probe.gradient(4, torch.float64, dev)
    ref = radaup_probe.gradient(4, torch.float64, torch.device("cpu"))
    for a, b in zip(got[1:], ref[1:]):
        assert float((a.cpu() - b).abs().max() / b.abs().max()) <= 1e-7


@pytest.mark.gpu
def test_odeint_fixed_on_card_matches_cpu():
    dev = _card()
    y0, om = radaup_probe.fixed_inputs(1024)
    got = radaup_probe.fixed_gradient(y0.to(dev), om.to(dev))
    ref = radaup_probe.fixed_gradient(y0, om)
    for a, b in zip(got, ref):
        assert a.is_cuda
        assert float((a.cpu() - b).abs().max() / b.abs().max()) <= 1e-10


@pytest.mark.gpu
def test_ham_sensitivities_through_kernels_equal_plain_lu():
    dev = _card()
    y0 = ham_probe.ham_y0(4096, dev)
    smalllu.reset_launch_counts()
    got_j, got = ham_probe.ham_solve(y0, True)
    assert smalllu.lu_factor_t.launches > 0 and smalllu.lu_solve_t.launches > 0
    ref_j, ref = ham_probe.ham_solve(y0, False)
    assert bool((got.status == 1).all())
    _bitwise(got, ref, ham_probe.STATS, ("t", "status"))
    assert torch.equal(got_j.r, ref_j.r) and torch.equal(got_j.d, ref_j.d)


@pytest.mark.gpu
@pytest.mark.parametrize("method", ham_probe.METHODS)
def test_forward_mode_through_every_method_on_card(method):
    dev = _card()
    tan = ham_probe.f1_tangent(method, dev)
    assert tan.is_cuda
    np.testing.assert_allclose(tan.cpu().numpy().ravel(), [2.0, 4.0],
                               rtol=1e-6, atol=1e-8)


@pytest.mark.gpu
def test_transform_path_on_card_matches_cpu():
    dev = _card()
    got, _, _ = ham_probe.transform_solve(*ham_probe.harmonic_inputs(256, dev))
    ref, _, _ = ham_probe.transform_solve(
        *ham_probe.harmonic_inputs(256, torch.device("cpu")))
    assert got.d.is_cuda
    for a, b in ((got.r, ref.r), (got.d, ref.d)):
        assert float((a.cpu() - b).abs().max()) <= 1e-10


SHARDED_WORKER = r"""
import sys
from pathlib import Path
import numpy as np, torch
rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          Path(sys.argv[4]))
from janus_tpu_torch.bench.infra import sharded_headline
from janus_tpu_torch.parallel import initialize, make_mesh
initialize(coordinator_address=f"localhost:{port}", num_processes=world,
           process_id=rank, backend="gloo")
mesh = make_mesh(device="cpu")
mus = torch.logspace(1, 3, 8192, dtype=torch.float64)
whole, _, launches = sharded_headline(mesh, 8192, "cuda", True, mus=mus)
if not (launches["K1"] > 0 and launches["K2"] > 0):
    raise SystemExit(f"rank {rank}: K1/K2 not launched: {launches}")
if rank == 0:
    np.savez(out / "gathered.npz", **{k: v.numpy() for k, v in whole.items()})
"""


@pytest.mark.gpu
def test_sharded_headline_on_two_processes_equals_one_process(tmp_path):
    dev = _card()
    script = tmp_path / "worker.py"
    script.write_text(SHARDED_WORKER)
    procs = infra.start_workers(2, tmp_path, cmd=[sys.executable, str(script)])
    # the workers' mu, made on the CPU (the card's logspace rounds otherwise)
    mus = torch.logspace(1, 3, 8192, dtype=torch.float64).to(dev)
    one = infra.headline_solve(*infra.headline_inputs(8192, dev, mus), True)
    rcs, logs = infra.wait_workers(procs, tmp_path, timeout=600)
    assert rcs == [0, 0], "\n---\n".join(o[-3000:] for o in logs)
    got = np.load(tmp_path / "gathered.npz")
    assert bool((one.status == 1).all())
    for key, v in (("y", one.y), ("sens", one.sens), ("status", one.status),
                   ("naccept", one.stats["naccept"])):
        np.testing.assert_array_equal(got[key], v.cpu().numpy(), err_msg=key)


@pytest.mark.gpu
def test_trace_spans_and_memory_stats_on_card(tmp_path):
    dev = _card()
    y0, mus, seeds = infra.headline_inputs(1024, dev)
    infra.headline_solve(y0, mus, seeds, True)          # K1/K2 built
    with diag.trace(str(tmp_path)):
        sol = infra.headline_solve(y0, mus, seeds, True)
    (path,) = tmp_path.glob("*.pt.trace.json")
    spans = infra.trace_spans(path)
    attempts = int(sol.stats["nsteps"].max())
    for name in ("radau.jacobian", "radau.factorize", "radau.newton"):
        assert spans[name]["calls"] == attempts, (name, spans[name])
    for name in ("radau.factorize", "radau.newton"):
        assert spans[name]["device_ms"] > 0, (name, spans[name])
    assert spans["radau.qr_fallback"]["calls"] == 0
    mem = diag.device_memory_stats()
    assert mem["peak_bytes_in_use"] > 0
    assert mem["bytes_in_use"] == mem["allocated_bytes.all.current"]
    assert mem["peak_bytes_in_use"] == mem["allocated_bytes.all.peak"]


@pytest.mark.gpu
def test_sharded_sweep_entry_point_on_one_card():
    """``python3 -m janus_tpu_torch.examples.sharded_sweep`` as one process:
    a one-rank NCCL group of its own, the sweep on the card."""
    import subprocess
    _card()
    env = dict(os.environ)
    env["PYTHONPATH"] = str(infra._REPO) + os.pathsep + env.get(
        "PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-m",
                          "janus_tpu_torch.examples.sharded_sweep"],
                         env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    assert "success fraction: 1.0000" in res.stdout


@pytest.mark.gpu
def test_events_poincare_through_kernels_equals_plain_lu():
    from janus_tpu_torch.examples import events_poincare as ep
    dev = _card()
    mol._reset_kernel_launches()
    _, sk = ep.solve(8192, dev, ep.options(kernel_lu=True))
    launches = mol._kernel_launches()
    assert launches["K1"] > 0 and launches["K2"] > 0, launches
    _, sp = ep.solve(8192, dev, Options(rtol=ep.RTOL, atol=ep.ATOL,
                                        pivoting=False))
    assert bool((sk.status == ep.EVENT_TERMINATED).all())
    for what in ("y", "t", "status", "event_t", "event_y"):
        assert torch.equal(getattr(sk, what), getattr(sp, what)), what


@pytest.mark.gpu
def test_fit_mu_step_through_kernels_equals_plain_lu():
    from janus_tpu_torch.examples import fit_mu_gauss_newton as fm
    dev = _card()
    m = 8192
    out = {}
    for k in (True, False):
        mol._reset_kernel_launches()
        _, data = fm.problem(m, dev, kernel_lu=k)
        mu0 = torch.full((m,), 30.0, dtype=torch.float64, device=dev)
        out[k] = fm.gn_step(mu0, data, fm.options(k))
        launches = mol._kernel_launches()
        assert (launches["K1"] > 0 and launches["K2"] > 0) == k, launches
    (mk, rk, sk), (mp, rp, sp) = out[True], out[False]
    assert torch.equal(mk, mp) and torch.equal(rk, rp)
    for a, b in zip(sk, sp):
        assert bool(torch.isfinite(a.sens).all())
        assert torch.equal(a.y, b.y) and torch.equal(a.sens, b.sens)


@pytest.mark.gpu
def test_reverse_time_round_trip_on_card():
    from janus_tpu_torch.examples import reverse_time
    _card()
    err, err8 = reverse_time.main()
    assert err < 1e-7 and err8 < 1e-7


# K1/K3 above MAX_UNROLLED_D (11-15) run the tile kernels
# (csrc/smalllu_tile.cu), K2 above 16 its run-time-D kernel
_BEYOND = [15, 16, 17, 24, 28, 32, 56, 64]


def _soa(d, m, dtype, dev, zero_pivots=False):
    """Random SoA a_t, b_t (+max(5, 2 sqrt(d))·I); with zero_pivots, every
    7th lane's row 3 is zero (an exact zero pivot at k = 3: K1 guards it to
    1, K3 divides by it) and every 11th lane's a[0][0] is 0."""
    rng = np.random.default_rng(d * 7919 + m)
    a = rng.standard_normal((m, d, d)) + max(5.0, 2.0 * d ** 0.5) * np.eye(d)
    if zero_pivots:
        a[::7, 3, :] = 0.0
        a[1::11, 0, 0] = 0.0
    b = rng.standard_normal((m, d))
    return (torch.from_numpy(np.ascontiguousarray(
        a.transpose(1, 2, 0).reshape(d * d, m))).to(dev, dtype),
        torch.from_numpy(np.ascontiguousarray(b.T)).to(dev, dtype))


def _equal_with_nans(got, ref):
    """torch.equal, NaN positions equal (K3 on a zero pivot)."""
    nan = torch.isnan(ref)
    return (torch.equal(torch.isnan(got), nan)
            and torch.equal(got[~nan], ref[~nan]))


@pytest.mark.gpu
@pytest.mark.parametrize("zero_pivots", [False, True], ids=["", "zero_pivots"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("m", [65536, 700, 65535])
@pytest.mark.parametrize("d", _BEYOND)
def test_kernels_beyond_16_equal_twins_to_the_bit(d, m, dtype, zero_pivots):
    dev = _card()
    a_t, b_t = _soa(d, m, dtype, dev, zero_pivots)
    lu_ref = smalllu.lu_factor_t_ref(a_t)
    x_ref = smalllu.linsolve_fused_ref(a_t, b_t)
    for got, ref in ((smalllu.lu_factor_t(a_t), lu_ref),
                     (smalllu.lu_solve_t(lu_ref, b_t),
                      smalllu.lu_solve_t_ref(lu_ref, b_t)),
                     (smalllu.linsolve_fused(a_t, b_t), x_ref)):
        torch.cuda.synchronize()
        assert _equal_with_nans(got, ref)
    assert bool(torch.isnan(x_ref).any()) == zero_pivots


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("d", [65, 100, 129])
def test_tile_kernel_at_4_and_8_rows_a_thread_equals_twins(d, dtype):
    """Above D = 64 a thread owns 3-4 rows (Q = 4) or 5-8 (Q = 8): K1
    and K3 equal to their twins to the bit on 700 lanes, some with an exact
    zero pivot (the twins' element loops take ~10 s a call at D = 129)."""
    dev = _card()
    a_t, b_t = _soa(d, 700, dtype, dev, zero_pivots=True)
    assert torch.equal(smalllu.lu_factor_t(a_t), smalllu.lu_factor_t_ref(a_t))
    assert _equal_with_nans(smalllu.linsolve_fused(a_t, b_t),
                            smalllu.linsolve_fused_ref(a_t, b_t))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("d", [9, 11, 12, 13, 14, 15, 16])
def test_tile_and_unrolled_forms_agree_to_the_bit(d, dtype):
    """Either side of the switch both forms give the twins' bits."""
    dev = _card()
    a_t, b_t = _soa(d, 65536, dtype, dev, zero_pivots=True)
    for form in (smalllu._tile, smalllu._unrolled):
        assert torch.equal(form(a_t), smalllu.lu_factor_t_ref(a_t))
        assert _equal_with_nans(form(a_t, b_t),
                                smalllu.linsolve_fused_ref(a_t, b_t))


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [False, True], ids=["K1", "K3"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("d", [17, 24, 28, 32, 56, 64, 100, 169])
def test_tile_geometry_is_the_launch_s(d, dtype, fused):
    """The launch's own reckoning (janus_lu_tile_attributes) of the
    geometry: the dynamic shared bytes tile_geometry states, at least its
    blocks a SM (the occupancy query), no local memory."""
    _card()
    at = smalllu.tile_attributes(d, dtype, fused)
    geo = at["geometry"]
    assert at["smem_bytes"] == geo.smem_bytes
    assert at["blocks_per_sm"] >= geo.blocks_per_sm
    assert at["local_bytes"] == 0
    assert at["max_threads"] >= geo.threads_per_block


@pytest.mark.gpu
def test_tile_refuses_what_does_not_fit_by_name():
    dev = _card()
    for d, dtype in ((170, torch.float64), (242, torch.float32)):
        a_t = torch.zeros(d * d, 4, dtype=dtype, device=dev)
        with pytest.raises(ValueError, match=f"D={d} .*does not fit"):
            smalllu.lu_factor_t(a_t)
        with pytest.raises(ValueError, match=f"D={d} .*does not fit"):
            smalllu.linsolve_fused(a_t, torch.zeros(d, 4, dtype=dtype,
                                                    device=dev))


_GENERATED = {2: "brusselator", 3: "orego", 4: "ham_vdp", 6: "dubins_pmp",
              8: "hires"}


def _generated_case(d, dtype):
    from janus_tpu_torch.bench import fused_any
    name = _GENERATED[d]
    case = fused_any.CASES[name]
    return fused_any, name, dataclasses.replace(case, dtype=dtype)


# the group layout's ragged widths: past a block's edge, past a group's in
# a warp, and one lane short of a full last block (16 lanes a block)
_RAGGED = [700, 4099, 65535]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("d,m", [(d, None) for d in sorted(_GENERATED)]
                         + [(d, m) for d in (6, 8) for m in _RAGGED])
def test_generated_k4_equals_twin_to_the_bit(d, m, dtype, monkeypatch):
    """1 and 32 attempts of K4 through the generated functor from the
    initial state of all the case's lanes (65,536 at D = 6 and 8; at D = 6
    and 8 also the ragged widths m): equal to _step_ref (fused_any.rounds
    raises otherwise)."""
    dev = _card()
    fused_any, name, case = _generated_case(d, dtype)
    monkeypatch.setitem(fused_any.CASES, name, case)
    width = case.m if m is None else m
    n = k4.radau5_step.launches
    out = fused_any.rounds(name, dev, width)
    assert [r["attempts"] for r in out] == [1, 32]
    assert all(r["state"].shape[1] == width for r in out)
    assert k4.radau5_step.launches == n + 2


# local bytes a thread of the layout that held the factors in local memory
# (f64, H100), which the group layout replaced
_LOCAL_LAYOUT_BYTES = {6: 2288, 8: 3688}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("d", [5, 6, 7, 8])
def test_generated_k4_layout_on_card(d, dtype):
    """K4's layout at D = 5..8 (the group layout; the lane layout at D =
    5, 6 in float): the unit's attributes are what ops.radau_fused.geometry
    says, its local bytes a thread are below the local-memory layout's
    readings at D = 6 and 8 (the factors' 5 D^2 f64 values at D = 5 and 7);
    in the group layout the block's shared memory holds the factors, 5 D
    values a thread, and the local bytes stay below a lane's factor bytes
    in the dtype; the runtime's register count is ptxas's;
    at D = 5 and 7, which no fused_any case has, K4 equals _step_ref after
    1 and 32 attempts on 4,099 lanes."""
    from janus_tpu_torch.bench.kernels import k4_ptxas
    from janus_tpu_torch.ops import rhs_codegen
    dev = _card()
    sys.path.insert(0, os.path.dirname(__file__))
    from torch_rhs_cases import ring_rhs
    if d in _GENERATED:
        fused_any, name, case = _generated_case(d, dtype)
        f, args = fused_any.case_f(name)
    else:
        f, args = ring_rhs, None
    unit = rhs_codegen.lower(f, args, d, dtype, dev)
    geo = k4.geometry(d, dtype)
    a = k4.kernel_attributes(None, dtype, unit=unit)
    assert (a["threads_per_lane"], a["lanes_per_block"]) == (
        geo.threads_per_lane, geo.lanes_per_block), a
    assert a["local_bytes"] < _LOCAL_LAYOUT_BYTES.get(d, 5 * d * d * 8), a
    if geo.threads_per_lane > 1:
        itemsize = torch.finfo(dtype).bits // 8
        assert (a["smem_bytes"], a["smem_values_per_lane"]) == (
            geo.smem_bytes, geo.scratch_per_lane), a
        assert geo.smem_bytes >= 5 * d * geo.threads_per_block * itemsize
        assert a["blocks_per_sm"] >= geo.blocks_per_sm, a
        assert a["local_bytes"] < 5 * d * d * itemsize, a
    regs = k4_ptxas(unit.ptxas_log())[f"generated {str(dtype)[6:]}"][0]
    assert regs == a["registers"], (regs, a)
    if d in _GENERATED:
        return
    m = 4099
    rng = np.random.default_rng(d)
    y0 = torch.from_numpy(0.5 + rng.random((m, d))).to(dev, dtype)
    opts = Options(rtol=1e-4 if dtype == torch.float32 else 1e-6,
                   atol=1e-7 if dtype == torch.float32 else 1e-9)
    state, tf_row = rf.initial_state(f, 0.0, 1.0, y0, args, opts)
    consts = rf.step_consts(opts, dtype)
    rows, treedef = rf.arg_rows(args, state[0])
    route = k4.kernel_route(f, args, state)
    for n in (1, 32):
        ref = state
        for _ in range(n):
            ref = rf._step_ref(ref, tf_row, rows, f, treedef, consts)
        got = k4.radau5_step(state.clone(), tf_row, f, args, consts,
                             max_attempts=n, route=route)
        torch.cuda.synchronize()
        _assert_bit_equal(got, ref)


def _rhs_inputs(unit, m, dev, dtype, seed):
    rng = np.random.default_rng(seed)
    t = torch.from_numpy(rng.random(m)).to(dev, dtype)
    y = torch.from_numpy(0.2 + rng.random((unit.dim, m))).to(dev, dtype)
    rows = torch.from_numpy(0.5 + rng.random((unit.n_params, m))).to(
        dev, dtype)
    return t, y, rows


def _functor_equals_f_on_card(f, args, dim, dtype, m=1 << 20):
    from torch.func import jvp
    from janus_tpu_torch.ops import rhs_codegen
    dev = _card()
    unit = rhs_codegen.lower(f, args, dim, dtype, dev)
    t, y_t, rows = _rhs_inputs(unit, m, dev, dtype, dim)
    f_k, jac_k = unit.eval_on_card(t, y_t, rows)
    leaves, treedef = rf.arg_rows(args, y_t[0])
    a1 = None if treedef is None else treedef(list(rows))
    y = y_t.T.contiguous()
    want = f(t, y, a1)
    torch.cuda.synchronize()
    assert torch.equal(f_k, want.T.contiguous()), float(
        (f_k - want.T).abs().max())
    for j in range(dim):
        tang = torch.zeros_like(y)
        tang[:, j] = 1.0
        _, col = jvp(lambda yy: f(t, yy, a1), (y,), (tang,))
        got = jac_k.reshape(dim, dim, m)[:, j]
        assert torch.equal(got, col.T.contiguous()), (j, float(
            (got - col.T).abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", ["dubins_pmp", "hires", "ham_vdp", "orego",
                                  "e5", "brusselator", "mixed_ops_rhs"])
def test_generated_functor_equals_f_and_jvp_on_card(name, dtype):
    from janus_tpu_torch.bench import fused_any
    if name == "mixed_ops_rhs":
        sys.path.insert(0, os.path.dirname(__file__))
        from torch_rhs_cases import mixed_ops_rhs
        f, args, dim = mixed_ops_rhs, {"k": 2.0}, 3
    else:
        f, args = fused_any.case_f(name)
        dim = fused_any.CASES[name].dim
    _functor_equals_f_on_card(f, args, dim, dtype)


@pytest.mark.gpu
def test_lambdas_equal_hand_written_functors_on_card():
    """The generated route of a lambda around vdp_rhs / robertson_rhs
    equals the hand-written functor to the bit (fused_any.run_case raises
    otherwise), each through its own K4 launches."""
    from janus_tpu_torch.bench import fused_any
    dev = _card()
    started = {"units": fused_any.lower_units(
        ["vdp_lambda", "robertson_lambda"], dev), "scipy": {},
        "widths": {"vdp_lambda": 4096, "robertson_lambda": 4096}}
    for name in ("vdp_lambda", "robertson_lambda"):
        rec = fused_any.run_case(name, dev, started, smoke=True)
        assert rec["hand_written_equal"] and rec["launches"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_closure_tensors_on_card_run_generated_k4(dtype):
    """f closes over a [D] row and a 0-dim tensor on the card and a 0-dim
    CPU tensor: traced on the card, solved by generated K4 equal to the
    twin loop to the bit."""
    from janus_tpu_torch.bench.fused_any import same_solution
    dev = _card()
    w = torch.tensor([1.0, 2.0, 3.0], dtype=dtype, device=dev)
    s_card = torch.tensor(7.0, dtype=dtype, device=dev)
    s_cpu = torch.tensor(3.0, dtype=dtype)

    def f(t, y, a):
        return (-(w * y) / s_card - y / s_cpu
                + a[:, None] * torch.cos(t)[:, None])

    rng = np.random.default_rng(5)
    m = 4096
    y0 = torch.from_numpy(rng.random((m, 3))).to(dev, dtype)
    args = torch.from_numpy(rng.random(m)).to(dev, dtype)
    opts = Options(rtol=1e-4 if dtype == torch.float32 else 1e-6,
                   atol=1e-7 if dtype == torch.float32 else 1e-9)
    n = k4.radau5_step.launches
    sol = solve_ivp(f, (0.0, 2.0), y0, method="radau_fused", args=args,
                    options=opts)
    assert k4.radau5_step.launches > n
    ref = rf.solve_radau_fused_ref(f, 0.0, 2.0, y0, args, opts)
    assert same_solution(sol, ref)
    assert bool((sol.status == 1).all())


@pytest.mark.gpu
def test_refused_op_raises_on_card_without_the_twin(monkeypatch):
    dev = _card()
    _, args, state, tf_row, consts = k4_setup("vdp", 64, torch.float64, dev)

    def no_twin(*a, **k):
        raise AssertionError("the twin ran on the card")

    monkeypatch.setattr(rf, "_step_ref", no_twin)
    n = k4.radau5_step.launches
    with pytest.raises(ValueError, match="aten.cumsum"):
        k4.radau5_step(state, tf_row,
                       lambda t, y, a: torch.cumsum(vdp_rhs(t, y, a), -1),
                       args, consts)
    with pytest.raises(ValueError, match="D=9 > 8"):
        k4.kernel_route(lambda t, y, a: -y, None,
                        state.new_zeros((5 * 9 + 15, 64)))
    assert k4.radau5_step.launches == n
