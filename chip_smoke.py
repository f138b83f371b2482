#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (janus_tpu_torch) on one NVIDIA GPU.

Usage, from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases, one line each (everything is made from fixed seeds):
1. device: torch's name for the card and nvidia-smi's name and power limit;
2. build: compiles the CUDA kernels from janus_tpu_torch/csrc (first use)
   while phase 25 traces its cases, then starts phase 25's unit builds
   (one thread and one nvcc a unit) and scipy workers beside phases 3-24;
3. kernels: K1 (lu_factor_t) and K2 (lu_solve_t) against their plain torch
   twins on the card, M = 65,536 and a ragged 700, D in {2, 4, 3, 6}; f64 at
   rtol 1e-12 and f32 at rtol 1e-5, each relative to the largest entry of
   the twin's result (the kernels are built without FMA contraction and
   agree to the bit; the bound leaves room for another operation order);
   each kernel's time next to its twin's (CUDA events), next to its bound
   (the bytes it must move over the card's memory rate) and next to the
   PyTorch call that computes the same function (torch.linalg.lu_factor
   with pivot=False, lu_solve), at D=4, M=65,536 f64; then D = 17, 28 and
   56 (K1's tile kernel, K2's run-time-D kernel; 28 and 56 the Pleiades
   blocks of phase 26), M=65,536, f64 and f32: K1 and K2 equal to their
   twins to the bit, each time beside its twin's, the library call's and
   its bound;
4. headline f64: bench.py's configuration through the port -- 65,536 stiff
   Van der Pol lanes (mu = 1e3, t in [0, 1]), Radau IIA s=5, rtol 1e-6,
   atol 1e-9, pivot-free stage LU through K1/K2, analytic Jacobian, K = 2
   IND sensitivities; the kernels' launch counts and host syncs of that run,
   seconds per solve (one timed run after a warm-up); the same with
   kernel_lu=False (plain torch LU), whose y and sens must agree within
   rtol 1e-5 (10x the solve's rtol: an ulp of difference may flip one step
   decision);
5. heterogeneous mu = logspace(1, 3, 65536) through solve_ivp('radau9'):
   8 lanes against scipy's Radau at rtol 1e-10 (within 1e-4 relative plus
   1e-6 absolute);
6. headline f32 with compensated accumulation: finite, success >= 0.99;
7. K3 (linsolve_fused) against its twin, shapes and tolerances as phase 3,
   its time at D=4, M=65,536 f64 next to the twin's, its bound and the
   pivoted torch.linalg.solve; at D = 17, 28 and 56 (the tile kernel) in
   f64 and f32 equal to its twin to the bit, with the same times; then the
   public op janus_tpu_torch.ops.linsolve_fused once, counting its
   launches;
8. K4 (radau5_step): its registers and local bytes per instantiation
   (cudaFuncGetAttributes) and ptxas's spill bytes (the build's report),
   the shared memory it keeps per lane, resident
   warps per SM (occupancy query) and the waves 65,536 lanes take; one
   attempt (max_attempts=1) on the packed state of the 65,536 headline
   lanes, initial and after five attempts, against _step_ref on the card:
   every flag, counter and value row equal to the bit; the time of one
   launch next to one twin attempt;
9. radau_fused headline f64: the same lanes as phase 4 through
   solve_ivp(..., method='radau_fused'), Radau5, rtol 1e-6, atol 1e-9:
   success 1.0, K4 launches and host syncs of that solve, seconds per solve
   (one timed run after a warm-up); K4's time per solve and per attempt
   (CUDA events around each call of the K4 wrapper, median of 3) beside
   its bound (the operations of the attempts and Newton trips the run's
   counters record over the card's f64 rate); the warp efficiency of the
   per-lane attempt and Newton-trip counts (sum / (32 x sum over warps of
   the warp's largest)); the twin loop on the card (y equal to the bit) and
   the eager solve_ivp('radau5', kernel_lu=True) (y within 1e-6 relative
   plus 1e-9 absolute), each with its time; then 4 x 65,536 copies of the
   headline lanes: success 1.0, every copy's y equal to the headline's,
   K4's device time;
10. radau_fused with mu = logspace(1, 3, 65536): success 1.0, 8 lanes
    against scipy as phase 5, K4's device time and the warp efficiency;
11. radau_fused on Robertson (D=3), 4,096 lanes, tf = logspace(-2, 2):
    success 1.0, y and counters equal to the twin loop's to the bit, K4's
    device time;
12. radau_fused f32 at rtol 1e-4, atol 1e-7: finite, success >= 0.99, K4's
    device time;
13. the matrix-free Radau path (janus_tpu_torch.bench.mol, where each phase
    is described; run with smoke=True: one timed run a cell (each adjoint
    cell timed by its checked calls), no profile, GMRES(25) over a
    sixty-fourth of the span, the block line over a hundred-and-twenty-
    eighth of its span, the IND solves over a hundred-and-twenty-eighth of
    the line's): Thomas against PCR on the card (D=128, M = 1,024 and
    65,536, real and complex; agreement to 1e-10 relative, both times);
    bench.py's method-of-lines configuration at full width -- the D=128
    Fisher-KPP line, stage_solver='tridiag', rtol 1e-4 -- at M = 1,024 in
    f64 and f32 and at M = 65,536 in f64: every lane SUCCESS, three lanes
    against scipy's Radau, ms per solve, steps, host syncs, and that no
    hand-written kernel was launched (this
    path runs none, as it runs no Pallas kernel in the reference); the same
    lines through GMRES(8), and through GMRES(25) over part of the span; a
    32x32 heat grid with precond='lines'; the interleaved 2-species
    line with precond='block'; K=2 IND sensitivities through the GMRES stage
    solvers (part of the span) against a central difference;
14. the continuous adjoint radau_adjoint (janus_tpu_torch.bench.mol, phases
    ``adjoint`` and ``vdp_adjoint``): bench.py's MOL-adjoint gradient -- the
    D=128 line, stage_solver='tridiag', adjoint_steps=48, loss sum(x y(T)^2),
    gradient in y0 and the rates by loss.backward() -- at M = 1,024 in f64
    and f32 and at M = 65,536 in f64: gradients finite, ms per gradient and
    of the forward alone, host syncs, launches, busy share, max(naccept),
    mesh bytes, peak memory (the busy share only in the probe); at 1,024 lanes the rate gradient of three lanes
    against central differences, the y0 gradient against IND, and 4 lanes on
    the card against the CPU; K1-K4 launch 0 times there (the path runs no
    kernel, as it runs no Pallas kernel in the reference). Then the adjoint
    whose forward solve goes through K1/K2: 65,536 Van der Pol lanes, Radau5,
    kernel_lu=True: K1 and K2 launched, gradients finite, ms per gradient,
    d/dmu against a central difference;
15. RODAS4, its discrete adjoint and events (janus_tpu_torch.bench.rodas,
    its shortest check): bench.py's rodas-adjoint gradient -- 8,192 Van der
    Pol lanes, mu = logspace(1.5, 3), rtol 1e-4, adjoint_steps=128, loss
    sum(y(T)^2), gradient in y0 and mu -- in f64: finite, ms per gradient,
    host syncs, max(naccept), against the transpose oracle (the IND tangents
    of solve_rodas, to 1e-10), d/dmu of three lanes against central
    differences (1e-4) and 4 lanes against the CPU (1e-7); solve_rodas on the
    65,536 headline lanes with K=2 IND tangents and kernel_lu=True, where K1
    factors E and K2 does every stage and tangent solve: their launch counts
    (``launches_rodas`` in the kernels line), y and sens within 1e-5 of the
    plain LU; a terminal event on 65,536 Radau5 lanes of heterogeneous mu:
    event_t and event_idx of 4 lanes against the CPU;
16. the explicit family, its discrete adjoint and the rest of the Radau
    surface (janus_tpu_torch.bench.dopri, its shortest check): dopri5 on
    65,536 Van der Pol lanes, mu = logspace(-1, 0.5), t in [0, 10], rtol
    1e-7 (the reference's dopri test widened), every lane SUCCESS, K1-K4
    launched 0 times, 8 lanes against scipy's RK45 (within 1e-5 relative +
    1e-6); the neural-ODE gradient of examples/neural_ode_dopri.py (MLP
    [2, 64, 64, 2], 8 t_eval samples, dopri_adjoint) at 8,192 lanes in
    f64, finite, dL/dy0 of 4 of its lanes against the CPU's gradient of
    those lanes alone, and the weight gradient of a 4-lane batch against
    the CPU (each 1e-7); the Radau9 headline lanes
    with kernel_lu=True, constant step_args rows and record_steps=64 equal
    to the plain solve to the bit with the same K1/K2 launches
    (``launches_step_args`` in the kernels line); radau_hvp on 1,024 VdP
    lanes whose augmented D=4 forward goes through K1/K2
    (``launches_hvp``), 3 lanes against central differences of
    radau_adjoint gradients;
17. the variable-order NDF/BDF family and its discrete adjoint
    (janus_tpu_torch.bench.ndf, its shortest check): solve_bdf on the
    65,536 headline lanes (mu = 1e3, rtol 1e-6, f64, pivoting=False, K=2
    IND) through K1/K2 (K1 factors M - c*J, K2 does every Newton and
    tangent solve; ``launches_ndf`` in the kernels line) and through the
    plain pivot-free LU, one turn each: every lane SUCCESS, the eight
    counters equal, y within 1e-8 and sens within 1e-5 of the plain route,
    lane 0 against scipy's Radau; ndf_adjoint's gradient at 8,192 lanes
    (mu = logspace(1.5, 3), rtol 1e-4, adjoint_steps=128, f64, through
    K1/K2: ``launches_ndf_adjoint``): finite, the transpose oracle against
    solve_bdf's IND tangents (1e-6), d/dmu of three lanes against central
    differences (1e-3) and 4 lanes against the CPU (1e-7);
18. SEULEX and its discrete adjoint (janus_tpu_torch.bench.seulex, its
    shortest check): solve_seulex on the 65,536 headline lanes (mu = 1e3,
    rtol 1e-6, f64, pivoting=False, K=2 IND) through K1/K2 (K1 factors
    every ladder level's M/h' - J, K2 does every substep, stability-check
    and tangent solve; ``launches_seulex`` in the kernels line) and through
    the plain pivot-free LU, one turn each: every lane SUCCESS, the seven
    counters equal, y within 1e-10 and sens within 1e-8 of the plain route,
    8 lanes (and 8 of a mu = logspace(1, 3) solve) against scipy's Radau;
    seulex_adjoint's gradient at 8,192 lanes (mu = logspace(1.5, 3), rtol
    1e-4, adjoint_steps=128, seulex_kmax=5, f64, the recording forward
    through K1/K2: ``launches_seulex_adjoint``): finite, the replay of the
    recorded mesh, autograd of the frozen replay chain (1e-10), d/dmu of
    three lanes against central differences (1e-4) and 4 lanes against the
    CPU (1e-7);
19. the variable-order Radau ladder, its adjoint and the legacy steppers
    (janus_tpu_torch.bench.radaup, its shortest check): solve_radau_vo
    (stages 1..7) on the 65,536 headline lanes (mu = 1e3, rtol 1e-6, f64,
    pivoting=False, K=2 IND) through K1/K2 (K1 factors each order's real
    and split-complex blocks, K2 does every Newton, error-estimate and
    tangent solve; ``launches_radaup`` in the kernels line) and through
    the plain pivot-free LU, one turn each: every lane SUCCESS, the seven
    counters, y and sens equal to the bit, 8 lanes (and 8 of a mu =
    logspace(1, 3) solve, where the ladder mixes orders) against scipy's
    Radau; solve_adjoint(method='radaup') at 8,192 lanes (mu = logspace(1,
    3), rtol 1e-4, adjoint_steps=128, f64, the forward through K1/K2:
    ``launches_radaup_adjoint``): finite, d/dmu of three lanes against
    central differences (1e-4) and 4 lanes against the CPU (1e-7); bdf2
    and grk4t on the 65,536-lane chip-matrix batch (mu = 10^U(1, 3), rtol
    1e-4, f64) through K1/K2 (``launches_bdf2``, ``launches_grk4t``) and
    the plain pivot-free LU: counters and y equal to the bit, success
    fraction 1, 8 lanes against scipy's Radau; odeint_fixed rk4 on 65,536
    harmonic lanes, its gradient through the checkpointed loop against the
    CPU (1e-10);
20. the Hamiltonian-first API and the dual numbers
    (janus_tpu_torch.bench.ham, its shortest check): the Hamiltonian Van
    der Pol sensitivities -- ham.hamiltonian_dynamics(vdp_hamiltonian) and
    its ham.hamiltonian_jacobian on 65,536 lanes y = [p, x] (x0 = (2, 0),
    p0 = (linspace(0.1, 1), 0), mu = 1e3, Radau9, rtol 1e-6, f64,
    pivoting=False) through solve_with_sensitivities(wrt_tf=True), the IND
    fast path with N = 5 directions -- through K1/K2 (K1 factors the real
    4x4 and split-complex 8x8 stage blocks, K2 every Newton, error-estimate
    and tangent solve; ``launches_ham`` in the kernels line) and through
    the plain pivot-free LU, one turn each: status, counters, y and the
    sensitivities equal to the bit, the tf column against f(T, y(T))
    (1e-6), dy(T)/dy0 of three lanes against central differences (1e-5), 8
    lanes against scipy's Radau on the explicit costate system and their
    success against the CPU port's, K1/K2 alone at D=4 and 2D=8; the
    transform path (dual_solve_ivp, dopri5, a Jet omega and a Jet y0 on
    65,536 harmonic lanes) against the closed form (1e-8) and 4 lanes
    against the CPU (1e-10); torch.func.jvp of y(T) for y' = (a, 2a)
    through all nine methods on CUDA tensors: (2, 4);
21. the outer control layer (janus_tpu_torch.bench.control, its shortest
    check): batched multiple-shooting PMP Van der Pol -- 16,384 instances x
    4 segments = 65,536 lanes (D=4, mu = linspace(0, 1), Radau5, rtol 1e-8,
    atol 1e-11, pivoting=False) through control.newton_solve with the
    Jacobian from one IND solve of the segment lanes, through K1/K2 (K1
    factors the 4x4 and split-complex 8x8 stage blocks, K2 every Newton,
    error-estimate and tangent solve; ``launches_control`` in the kernels
    line) and through the plain pivot-free LU, one turn each: every
    instance converged (fnorm < 1e-8), x, iters and fnorm equal to the bit,
    8 instances against the CPU (1e-9; the CPU's Newton runs in a worker
    process beside the card's turns), the solution integrated forward
    reaches x(2) = 0 (1e-5); the
    default AD Jacobian (torch.func.vmap over jvp of the residual) on the
    plain route at 1,024 instances, from the IND Newton's solution moved by
    1e-5 (one iteration), against the IND Newton (1e-7), and the same through
    kernel_lu=True refused by the kernels' ValueError (they have no
    derivative rule); the forward check at rtol 1e-8;
22. the infrastructure and the four examples that use it
    (janus_tpu_torch.bench.infra, its shortest check): examples.
    stiff_vdp_batch at 65,536 lanes (mu = logspace(1, 3), Radau5, rtol 1e-8)
    through K1/K2 (``launches_examples`` in the kernels line) and the plain
    LU: every lane SUCCESS, y, status, nsteps equal to the bit, traj/s;
    bench.py's headline split over two processes on the one card (a gloo
    group, parallel.lockstep, 32,768 lanes a rank through K1/K2, gathered
    through the group): y, sens, status, naccept equal to the one-process
    solve to the bit, each rank's K1/K2 launches (``launches_sharded``), the
    wall times; examples.sharded_sweep on the same group; diag.trace around
    a headline solve through K1/K2 and one on the plain LU with
    qr_fallback: the four radau.* spans, device_memory_stats, the host cost
    of record_function; examples.train_nn_hamiltonian (the native library,
    150 of its 400 Adam steps, the checkpoint restored to the bit, held-out
    error < 0.05) and
    examples.learned_continuation (the learned policy converges in fewer
    steps than the fixed schedule);
23. the last eleven examples (janus_tpu_torch.bench.examples, its shortest
    check; each cut is stated in that module's docstring):
    examples.events_poincare at 65,536 lanes (mu = 10^linspace(0, 1.5), the
    terminal falling x1 = 0 crossing, Radau5, rtol 1e-8) and
    examples.fit_mu_gauss_newton at 65,536 lanes (one Gauss-Newton step,
    three IND sweeps) through K1/K2 (``launches_poincare``,
    ``launches_fit_mu`` in the kernels line) and the plain pivot-free LU,
    one turn each: every lane crosses, y, t, status, event_t, event_y, mu_hat
    and the residual equal to the bit between the routes, every IND sweep
    finite; reverse_time over [0, 0.5]; hamiltonian_vdp at rtol 1e-5;
    bratu_psitc whole; the dubins_pmp and vdp_pmp_energy shooting
    residuals; event_time_training's first 3 steps; neural_ode_dopri's
    first 5 Adam steps (the loss falls); newton_cg_hvp's value-and-gradient
    and one H.v through K1/K2 (``launches_newton_cg``) and the plain LU,
    equal to the bit; vdp_min_time's first residual and its exact Jacobian
    on four lanes. Each of these but reverse_time, bratu_psitc and
    neural_ode_dopri is also held to the port's own CPU result on the same
    inputs, at the CPU tests' tolerances (1e-9 absolute, 1e-8 relative for
    event_time_training and newton_cg_hvp), computed in worker processes
    beside the card's work.
24. parallel.lockstep for every family (janus_tpu_torch.bench.lockstep,
    its shortest check): two gloo ranks on the one card, 32,768 lanes a
    rank, each family's headline (rodas, grk4t, bdf2, dopri5, dopri853,
    NDF, classic BDF, SEULEX, radaup through K1/K2 with K=2 IND where the
    family takes tangents; radau_fused through K4; mu = logspace(1, 3)
    where the headline has one mu, so that the lanes' step counts differ)
    gathered through the group equal to the one-process 65,536-lane solve
    to the bit, each
    rank's K1/K2 and K4 launches equal to the one-process solve's
    (``launches_lockstep`` on the K1/K2 rows, ``launches_sharded`` on K4's);
    the four discrete adjoints' and the radaup gradient at 2 x 4,096 lanes
    (lambda(t0) equal to the bit, the shared gradient all-reduced within
    1e-12); one multiple-shooting PMP Newton iteration on 2 x 1,024
    instances equal to the bit; and in this process each family's first
    32,768 lanes solved alone equal to those lanes of the 65,536-lane
    solve.
25. K4 for any right-hand side up to D = 8 (janus_tpu_torch.bench.
    fused_any, its shortest check): solve_ivp(..., method='radau_fused')
    through functors generated from the traced f (ops.rhs_codegen) on
    dubins_pmp_rhs (D=6) and hires_rhs (D=8) at 65,536 lanes, the
    Hamiltonian VdP (mu in a closure), orego, e5, brusselator, lambdas
    around vdp_rhs and robertson_rhs at 4,096 lanes, and orego in f32:
    every lane SUCCESS (f32 >= 0.99), K4 launched; 1 and 32 attempts of K4
    on every lane the solve runs equal to _step_ref to the bit, and at D = 6
    and 8 (at D = 8 the group layout, a lane over 8 threads, the factors
    in shared memory; at D = 6 in f32 the lane layout) also through the
    f32 units; the lambdas equal to the
    hand-written functors to the bit; 8 lanes against scipy's Radau; K4's
    ms a solve beside its bound, the unit's layout (threads a lane, lanes a
    block, blocks a SM, registers, spills, local bytes) and cold build
    seconds; then K4's ms a solve of dubins_pmp and HIRES beside
    nvidia-smi's name and power limit of the card.
26. K1 and K2 above 16 on a solver's path (janus_tpu_torch.bench.lu_tile,
    its shortest check): Radau5 on Pleiades (D = 28; Hairer's initial
    value, each lane's velocities scaled in [0.99, 1.01] from a seed) at
    65,536 lanes in f64 over t in [0, 0.5] (the probe's whole span is
    [0, 3]), rtol 1e-6, atol 1e-8, through kernel_lu=True (K1's tile
    kernel factors the 28 x 28 and 56 x 56 blocks, K2 solves them;
    ``launches_pleiades`` by D in the kernels line) and the plain
    pivot-free LU: every lane SUCCESS on both, y within rtol 1e-5 of the
    plain route's, 8 lanes against scipy's DOP853 at rtol 1e-10 (within
    1e-7 relative + 1e-8), s a solve of each route and the ms inside K1
    and K2.

Then one JSON line with the kernels' records, nvidia-smi's line, and last
{"ok": true, "device": {...}}. Any failed check raises; no phase's failure
is caught. Without a CUDA device, or without the package beside this
script, it exits non-zero before printing any result.
"""

import json
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

M = 65_536


def _fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _solve_seconds(fn):
    """Seconds of one call of fn (CUDA events), after fn ran once (the
    probes keep their medians)."""
    from janus_tpu_torch.bench.kernels import events_ms
    return events_ms(fn, 1) / 1e3


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "janus_tpu_torch")):
        print("chip_smoke: janus_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, here)

    from janus_tpu_torch import ops as janus_ops
    from janus_tpu_torch.bench import control as control_probe
    from janus_tpu_torch.bench import dopri as dopri_probe
    from janus_tpu_torch.bench import examples as examples_probe
    from janus_tpu_torch.bench import fused_any as fused_any_probe
    from janus_tpu_torch.bench import ham as ham_probe
    from janus_tpu_torch.bench import infra as infra_probe
    from janus_tpu_torch.bench import kernels as bench
    from janus_tpu_torch.bench import lockstep as lockstep_probe
    from janus_tpu_torch.bench import lu_tile as lu_tile_probe
    from janus_tpu_torch.bench import mol
    from janus_tpu_torch.bench import ndf as ndf_probe
    from janus_tpu_torch.bench import rodas as rodas_probe
    from janus_tpu_torch.bench import radaup as radaup_probe
    from janus_tpu_torch.bench import seulex as seulex_probe
    from janus_tpu_torch.models.problems import (DEVICE_PROBLEMS,
                                                 robertson_rhs, vdp_jac,
                                                 vdp_rhs)
    from janus_tpu_torch.ops import _build, smalllu
    from janus_tpu_torch.ops import radau_fused as k4
    from janus_tpu_torch.solve import Options, solve_ivp
    from janus_tpu_torch.solve import radau_fused as rf
    from janus_tpu_torch.solve.radau import solve_radau

    dev = torch.device("cuda:0")
    t_start = time.perf_counter()

    # ---- 1. device ---------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"[device] {kind} | nvidia-smi: {smi} | torch {torch.__version__}"
          f" cuda {torch.version.cuda} | count {torch.cuda.device_count()}",
          flush=True)

    # ---- 2. build ----------------------------------------------------------
    # the kernels' nvcc runs in a thread while phase 25 traces its cases;
    # their unit builds and scipy workers start once it is done, and run
    # beside phases 3-24
    t_b = time.perf_counter()
    built = {}

    def build_kernels():
        built["path"] = _build.build()
        built["t"] = time.perf_counter()

    main_build = threading.Thread(target=build_kernels, daemon=True)
    main_build.start()
    fused_started = fused_any_probe.start(dev, smoke=True, launch=False)
    main_build.join()
    if "path" not in built:
        _build.build()                  # raises the build's error here
    _build.load_library()
    fused_any_probe.launch_builds(fused_started)
    print(f"[build] phase 25: {len(fused_started['units'])} generated units "
          f"traced in {fused_started['trace_s']:.2f} s, building in the "
          "background", flush=True)
    print(f"[build] K1-K4 from janus_tpu_torch/csrc/*.cu with "
          f"{' '.join(_build.ARCH_FLAGS)}: {built['t'] - t_b:.2f} s",
          flush=True)

    # ---- 3. kernels against their twins ------------------------------------
    rng = np.random.default_rng(0)
    err = {"K1": {}, "K2": {}}
    times = {}
    for dtype, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        for m in (M, 700):
            for d in (2, 4, 3, 6):
                a = rng.standard_normal((m, d, d)) + 5.0 * np.eye(d)
                b = rng.standard_normal((m, d))
                a_t = torch.from_numpy(
                    np.ascontiguousarray(a.transpose(1, 2, 0).reshape(d * d, m))
                ).to(dev, dtype)
                b_t = torch.from_numpy(np.ascontiguousarray(b.T)).to(dev, dtype)
                lu_ref = smalllu.lu_factor_t_ref(a_t)
                x_ref = smalllu.lu_solve_t_ref(lu_ref, b_t)
                lu_k = smalllu.lu_factor_t(a_t)
                x_k = smalllu.lu_solve_t(lu_ref, b_t)
                torch.cuda.synchronize()
                for name, got, ref in (("K1", lu_k, lu_ref), ("K2", x_k, x_ref)):
                    e = float((got - ref).abs().max())
                    scale = float(ref.abs().max())
                    if not e <= rtol * scale:
                        _fail(f"{name} D={d} M={m} {dtype}: max|err| {e:.3e} "
                              f"> {rtol:g} * {scale:.3e}")
                    key = str(dtype).replace("torch.", "")
                    err[name][key] = max(err[name].get(key, 0.0), e)
                if m == M and d in (2, 4):
                    k1 = bench.events_ms(lambda: smalllu.lu_factor_t(a_t), 50)
                    k1p = bench.events_ms(lambda: smalllu.lu_factor_t_ref(a_t), 50)
                    k2 = bench.events_ms(lambda: smalllu.lu_solve_t(lu_ref, b_t), 50)
                    k2p = bench.events_ms(
                        lambda: smalllu.lu_solve_t_ref(lu_ref, b_t), 50)
                    extra = {}
                    for name in ("lu_factor_t", "lu_solve_t"):
                        lib = bench.library_call(name, a_t, b_t, lu_ref)
                        extra[name] = (
                            *bench.bound_ms(*bench.lu_work(name, d, m, dtype),
                                            dtype), bench.events_ms(lib, 50))
                    times[(dtype, d)] = (k1, k1p, k2, k2p, extra)
                    print(f"[kernels] D={d} M={m} {dtype}: K1 {k1:.4f} ms "
                          f"(twin {k1p:.4f}, bound {extra['lu_factor_t'][0]:.4f}"
                          f" by {extra['lu_factor_t'][1]}, torch.linalg."
                          f"lu_factor {extra['lu_factor_t'][2]:.4f}), K2 "
                          f"{k2:.4f} ms (twin {k2p:.4f}, bound "
                          f"{extra['lu_solve_t'][0]:.4f} by "
                          f"{extra['lu_solve_t'][1]}, torch.linalg.lu_solve "
                          f"{extra['lu_solve_t'][2]:.4f})", flush=True)
    print(f"[kernels] agree with twins: max|err| K1 {err['K1']}, "
          f"K2 {err['K2']}", flush=True)
    # above the unrolled sizes: K1's tile kernel and K2's run-time-D kernel
    # at D = 17 and the Pleiades blocks 28 and 56 (phase 26), to the bit
    tile = {"lu_factor_t": [], "lu_solve_t": [], "linsolve_fused": []}

    def tile_inputs(d, dtype):
        """SoA a_t (+max(5, 2 sqrt(d))·I: pivot-free elimination stays
        well conditioned at these D) and b_t, M = 65,536, drawn on the card
        from a seed by D (on the host, 0.2-1.6 GB a case took tens of
        seconds beside phase 25's builds)."""
        g = torch.Generator(device=dev).manual_seed(d)
        a_t = torch.randn(d * d, M, generator=g, device=dev,
                          dtype=torch.float64)
        a_t[::d + 1] += max(5.0, 2 * d ** 0.5)      # rows (i, i)
        b_t = torch.randn(d, M, generator=g, device=dev, dtype=torch.float64)
        return a_t.to(dtype), b_t.to(dtype)

    def beyond_16(d, dtype, kernels):
        """kernels: (name, kernel, twin, inputs) at D = d, M = 65,536: each
        equal to its twin to the bit, its time (CUDA events) beside the
        library call's and the bound; a record each in tile[name]."""
        for name, kern, twin, ins in kernels:
            out = []
            plain_ms = bench.events_ms(lambda: out.append(twin(*ins)), 1)
            ref = out[0]
            got = kern(*ins)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                _fail(f"{name} D={d} {dtype}: not equal to its twin to the "
                      f"bit (max|err| {float((got - ref).abs().max()):.3e})")
            bms, by = bench.bound_ms(*bench.lu_work(name, d, M, dtype), dtype)
            lib = bench.library_call(name, a_t, b_t, ins[0])
            lib()                   # the library's first-call setup, untimed
            tile[name].append({
                "D": d, "dtype": str(dtype).replace("torch.", ""),
                "ms": bench.events_ms(lambda: kern(*ins), 5),
                "plain_ms": plain_ms,
                "bound_ms": bms, "bound_by": by,
                "library_ms": bench.events_ms(lib, 5), "max_abs_err": 0.0})
            del lib

    def tile_line(names):
        return "; ".join(
            f"{n} D={r['D']} {r['dtype']} {r['ms']:.4f} ms (library "
            f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} by "
            f"{r['bound_by']}, twin {r['plain_ms']:.1f})"
            for n in names for r in tile[n])

    t_tile = time.perf_counter()
    for dtype in (torch.float64, torch.float32):
        for d in (17, 28, 56):
            a_t, b_t = tile_inputs(d, dtype)
            lu_ref = smalllu.lu_factor_t_ref(a_t)
            beyond_16(d, dtype, (
                ("lu_factor_t", smalllu.lu_factor_t, smalllu.lu_factor_t_ref,
                 (a_t,)),
                ("lu_solve_t", smalllu.lu_solve_t, smalllu.lu_solve_t_ref,
                 (lu_ref, b_t))))
            del a_t, b_t, lu_ref
    print("[kernels D > 16] M=65536, K1 the tile kernel, K2 its run-time-D "
          "kernel, each equal to its twin to the bit: "
          + tile_line(("lu_factor_t", "lu_solve_t"))
          + f" | {time.perf_counter() - t_tile:.1f} s", flush=True)

    # ---- 4. headline, f64 --------------------------------------------------
    def headline(dtype, kernel_lu, compensated=False):
        y0 = torch.tensor([[2.0, 0.0]], dtype=dtype, device=dev).repeat(M, 1)
        mus = torch.full((M,), 1e3, dtype=dtype, device=dev)
        seeds = torch.zeros((2, M, 2), dtype=dtype, device=dev)
        seeds[0, :, 0] = 1.0
        seeds[1, :, 1] = 1.0
        opts = Options(rtol=1e-6, atol=1e-9, pivoting=False,
                       compensated=compensated, min_stages=5, max_stages=5,
                       kernel_lu=kernel_lu)
        return solve_radau(vdp_rhs, 0.0, 1.0, y0, args=mus, options=opts,
                           jac=vdp_jac, tangents=seeds)

    def fractions(sol):
        st = sol.stats
        success = float((sol.status == 1).double().mean())
        accept = float((st["naccept"].double()
                        / st["nsteps"].clamp(min=1).double()).mean())
        return success, accept

    torch.cuda.synchronize()
    smalllu.reset_launch_counts()
    sol_k = headline(torch.float64, True)
    torch.cuda.synchronize()
    launches = {"K1": smalllu.lu_factor_t.launches,
                "K2": smalllu.lu_solve_t.launches}
    syncs = solve_radau.host_syncs
    succ, acc = fractions(sol_k)
    if succ != 1.0:
        _fail(f"f64 headline success_fraction {succ} != 1.0")
    if min(launches.values()) <= 0:
        _fail(f"a kernel was not launched on the main path: {launches}")
    if not (torch.isfinite(sol_k.y).all() and torch.isfinite(sol_k.sens).all()):
        _fail("f64 headline: non-finite y or sens")
    sec_k = _solve_seconds(lambda: headline(torch.float64, True))

    sol_p = headline(torch.float64, False)
    sec_p = _solve_seconds(lambda: headline(torch.float64, False))
    for name, got, ref in (("y", sol_k.y, sol_p.y),
                           ("sens", sol_k.sens, sol_p.sens)):
        if not torch.allclose(got, ref, rtol=1e-5,
                              atol=1e-5 * float(ref.abs().max())):
            e = float(((got - ref).abs() / ref.abs().clamp(min=1e-300)).max())
            _fail(f"f64 headline {name}: kernel vs plain LU differ, max rel "
                  f"{e:.3e} > 1e-5")
    print(f"[headline f64] M={M} Radau9 rtol 1e-6 K=2 IND: success_fraction "
          f"{succ} accept_fraction {acc:.4f} launches {launches} host_syncs "
          f"{syncs} | s/solve kernel_lu {sec_k:.4f}, plain LU {sec_p:.4f} | "
          f"y(1) lane0 {sol_k.y[0].tolist()}", flush=True)

    # ---- 5. heterogeneous mu, f64, against scipy --------------------------
    from scipy.integrate import solve_ivp as scipy_ivp

    def scipy_worst(y_got, mus, what):
        """Worst error / bound of 8 lanes against scipy's Radau."""
        worst = 0.0
        for i in np.linspace(0, M - 1, 8).round().astype(int):
            mu = float(mus[i])
            ref = scipy_ivp(
                lambda t, y: [y[1], mu * (1 - y[0] ** 2) * y[1] - y[0]],
                (0.0, 1.0), [2.0, 0.0], method="Radau", rtol=1e-10,
                atol=1e-12,
                jac=lambda t, y: [[0.0, 1.0], [-2 * mu * y[0] * y[1] - 1,
                                               mu * (1 - y[0] ** 2)]]
            ).y[:, -1]
            e = np.abs(y_got[i] - ref)
            if not np.all(e <= 1e-4 * np.abs(ref) + 1e-6):
                _fail(f"{what} lane {i} (mu={mu:.4g}): y {y_got[i]} vs "
                      f"scipy {ref}")
            worst = max(worst, float(np.max(e / (1e-4 * np.abs(ref) + 1e-6))))
        return worst

    mus = torch.logspace(1, 3, M, dtype=torch.float64, device=dev)
    y0 = torch.tensor([[2.0, 0.0]], dtype=torch.float64, device=dev).repeat(M, 1)
    seeds = torch.zeros((2, M, 2), dtype=torch.float64, device=dev)
    seeds[0, :, 0] = 1.0
    seeds[1, :, 1] = 1.0
    t_h = time.perf_counter()
    sol_h = solve_ivp(vdp_rhs, (0.0, 1.0), y0, method="radau9", args=mus,
                      jac=vdp_jac, tangents=seeds, rtol=1e-6, atol=1e-9,
                      pivoting=False, kernel_lu=True)
    torch.cuda.synchronize()
    sec_h = time.perf_counter() - t_h
    succ_h, acc_h = fractions(sol_h)
    if succ_h != 1.0:
        _fail(f"heterogeneous mu: success_fraction {succ_h} != 1.0")
    worst = scipy_worst(sol_h.y.cpu().numpy(), mus, "heterogeneous mu")
    print(f"[hetero mu f64] M={M} mu=logspace(1,3): success_fraction {succ_h}"
          f" accept_fraction {acc_h:.4f} host_syncs {solve_radau.host_syncs}"
          f" | {sec_h:.4f} s (one solve, host clock) | 8 lanes vs scipy "
          f"Radau: worst error / bound {worst:.3e}", flush=True)

    # ---- 6. headline, f32 compensated -------------------------------------
    sol_f = headline(torch.float32, True, compensated=True)
    sec_f = _solve_seconds(lambda: headline(torch.float32, True, True))
    succ_f, acc_f = fractions(sol_f)
    if not (torch.isfinite(sol_f.y).all() and torch.isfinite(sol_f.sens).all()):
        _fail("f32 headline: non-finite y or sens")
    if succ_f < 0.99:
        _fail(f"f32 headline success_fraction {succ_f} < 0.99")
    print(f"[headline f32 compensated] success_fraction {succ_f} "
          f"accept_fraction {acc_f:.4f} host_syncs {solve_radau.host_syncs} "
          f"| s/solve {sec_f:.4f}", flush=True)

    # ---- 7. K3 against its twin ---------------------------------------------
    err["K3"] = {}
    for dtype, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        for m in (M, 700):
            for d in (2, 4, 3, 6):
                a = rng.standard_normal((m, d, d)) + 5.0 * np.eye(d)
                b = rng.standard_normal((m, d))
                a_t = torch.from_numpy(
                    np.ascontiguousarray(a.transpose(1, 2, 0).reshape(d * d, m))
                ).to(dev, dtype)
                b_t = torch.from_numpy(np.ascontiguousarray(b.T)).to(dev, dtype)
                x_ref = smalllu.linsolve_fused_ref(a_t, b_t)
                x_k = smalllu.linsolve_fused(a_t, b_t)
                torch.cuda.synchronize()
                e = float((x_k - x_ref).abs().max())
                scale = float(x_ref.abs().max())
                if not e <= rtol * scale:
                    _fail(f"K3 D={d} M={m} {dtype}: max|err| {e:.3e} > "
                          f"{rtol:g} * {scale:.3e}")
                key = str(dtype).replace("torch.", "")
                err["K3"][key] = max(err["K3"].get(key, 0.0), e)
                if m == M and d == 4 and dtype == torch.float64:
                    k3_in = (a_t, b_t)
                    k3 = bench.events_ms(lambda: smalllu.linsolve_fused(a_t, b_t),
                                    50)
                    k3p = bench.events_ms(
                        lambda: smalllu.linsolve_fused_ref(a_t, b_t), 50)
                    k3_bound = bench.bound_ms(
                        *bench.lu_work("linsolve_fused", d, m, dtype), dtype)
                    k3_lib = bench.events_ms(bench.library_call(
                        "linsolve_fused", a_t, b_t, None), 50)
    t_tile = time.perf_counter()
    for dtype in (torch.float64, torch.float32):
        for d in (17, 28, 56):
            a_t, b_t = tile_inputs(d, dtype)
            beyond_16(d, dtype, (("linsolve_fused", smalllu.linsolve_fused,
                                  smalllu.linsolve_fused_ref, (a_t, b_t)),))
            del a_t, b_t
    print("[K3 D > 16] M=65536, the tile kernel, equal to its twin to the "
          "bit: " + tile_line(("linsolve_fused",))
          + f" | {time.perf_counter() - t_tile:.1f} s", flush=True)
    # the K3 path: the public op ops.linsolve_fused at D=4, M=65,536
    smalllu.reset_launch_counts()
    janus_ops.linsolve_fused(*k3_in)
    torch.cuda.synchronize()
    launches["K3"] = smalllu.linsolve_fused.launches
    if launches["K3"] <= 0:
        _fail("ops.linsolve_fused did not launch K3")
    print(f"[K3] agree with twin: max|err| {err['K3']} | D=4 M={M} float64: "
          f"{k3:.4f} ms (twin {k3p:.4f}, bound {k3_bound[0]:.4f} by "
          f"{k3_bound[1]}, pivoted torch.linalg.solve {k3_lib:.4f}) | "
          f"launches on the op's path {launches['K3']}", flush=True)

    # ---- 8. K4, one attempt against _step_ref -----------------------------
    def vdp_lanes(dtype, mu=1e3):
        y0 = torch.tensor([[2.0, 0.0]], dtype=dtype, device=dev).repeat(M, 1)
        return y0, torch.full((M,), mu, dtype=dtype, device=dev)

    def one_attempt(dtype, n_before):
        """(agreeing-lane share, {row: rel err}, max abs err, state, tf_row,
        mus, consts) for one K4 attempt after n_before twin attempts."""
        y0, mus = vdp_lanes(dtype)
        opts = Options(rtol=1e-6, atol=1e-9)
        st, tf_row = rf.initial_state(vdp_rhs, 0.0, 1.0, y0, mus, opts)
        consts = rf.step_consts(opts, dtype)
        rows, treedef = rf.arg_rows(mus, st[0])
        for _ in range(n_before):
            st = rf._step_ref(st, tf_row, rows, vdp_rhs, treedef, consts)
        ref = rf._step_ref(st, tf_row, rows, vdp_rhs, treedef, consts)
        got = k4.radau5_step(st.clone(), tf_row, vdp_rhs, mus, consts)
        torch.cuda.synchronize()
        share, errs, abs_err = rf.state_agreement(got, ref, 2)
        return share, errs, abs_err, st, tf_row, mus, consts

    ptxas = bench.k4_ptxas(_build.ptxas_log())
    for f in (vdp_rhs, robertson_rhs):
        for dtype in (torch.float64, torch.float32):
            a = k4.kernel_attributes(f, dtype)
            name = f"{DEVICE_PROBLEMS[f].functor} {str(dtype)[6:]}"
            _, stack, spill_st, spill_ld = ptxas[name]
            print(f"[K4 build] {name}: {a['registers']} registers, spill "
                  f"stores/loads {spill_st}/{spill_ld} B and stack frame "
                  f"{stack} B (ptxas), {a['local_bytes']} B local per "
                  f"thread with the functions it calls, "
                  f"{a['smem_values_per_lane']} values "
                  f"per lane in shared memory ({a['smem_bytes']} B per "
                  f"block), {a['warps_per_sm']} resident warps per SM x "
                  f"{a['sms']} SMs = {a['resident_lanes']} lanes: {M} lanes "
                  f"take {M / a['resident_lanes']:.3f} waves", flush=True)
    k4_err = {}
    for dtype in (torch.float64, torch.float32):
        for n_before in (0, 5):
            share, errs, abs_err, st, tf_row, mus, consts = one_attempt(
                dtype, n_before)
            worst = max(errs, key=errs.get)
            print(f"[K4 one attempt] {dtype} after {n_before} attempts: "
                  f"flags/counters equal on {share:.6f} of lanes "
                  f"({round((1 - share) * M)} differ); worst row {worst} "
                  f"{errs[worst]:.3e}, max|err| {abs_err:.3e} (bound 0: to "
                  f"the bit)", flush=True)
            if share != 1.0 or abs_err != 0.0:
                _fail(f"K4 one attempt {dtype}: not equal to _step_ref to "
                      f"the bit (flags equal on {share}, max|err| "
                      f"{abs_err:.3e})")
            key = str(dtype).replace("torch.", "")
            k4_err[key] = max(k4_err.get(key, 0.0), abs_err)
            if dtype == torch.float64 and n_before == 0:
                k4_in = (st, tf_row, mus, consts)
    st0, tf_row, mus, consts = k4_in
    rows0, treedef0 = rf.arg_rows(mus, st0[0])
    k4_ms = statistics.median(
        bench.events_ms(lambda st=st0.clone(): k4.radau5_step(
            st, tf_row, vdp_rhs, mus, consts), 1) for _ in range(20))
    k4p_ms = bench.events_ms(lambda: rf._step_ref(st0, tf_row, rows0, vdp_rhs,
                                             treedef0, consts), 5)
    print(f"[K4 one attempt] M={M} float64 initial state: {k4_ms:.4f} ms per "
          f"launch (twin {k4p_ms:.4f} ms)", flush=True)

    # ---- 9. radau_fused headline, f64 ------------------------------------------
    def same_solution(a, b):
        """t, y, status and every counter equal to the bit."""
        return (torch.equal(a.t, b.t) and torch.equal(a.y, b.y)
                and torch.equal(a.status, b.status)
                and all(torch.equal(a.stats[k], b.stats[k]) for k in a.stats))

    def k4_device(cell, f, tf, y0, args, opts, sol):
        """K4's time in three more solves of sol's inputs, CUDA events
        around each call of the K4 wrapper: ({ms, bound_ms, bound_by},
        the line to print). Each solve must equal sol to the bit."""
        runs = [bench.timed_fused_solve(f, 0.0, tf, y0, args, opts)
                for _ in range(3)]
        if not all(same_solution(r[0], sol) for r in runs):
            _fail(f"K4 device {cell}: a timed solve differs from solve_ivp's")
        ms = statistics.median(r[2] for r in runs)
        n_launch = runs[0][1]
        prob = DEVICE_PROBLEMS[f]
        m, dim = y0.shape
        steps, trips = sol.stats["nsteps"], sol.stats["nnewton"]
        nbytes, ops = bench.k4_work(prob.functor, dim, y0.dtype, m, n_launch,
                                    int(steps.sum()), int(trips.sum()),
                                    len(prob.params))
        bms, by = bench.bound_ms(nbytes, ops, y0.dtype)
        rounds = int(steps.max())
        line = (f"[K4 device {cell}] M={m} {y0.dtype}: {ms:.5f} ms per solve"
                f" ({n_launch} launches; CUDA events around the K4 wrapper "
                f"calls, median of 3), {ms / rounds * 1e3:.3f} us per attempt"
                f" round ({rounds} rounds) | bound {bms:.5f} ms by {by} "
                f"({ops:.6g} operations), {bms / ms:.3f} of it | warp "
                f"efficiency: attempts {bench.warp_efficiency(steps):.4f}, "
                f"Newton trips {bench.warp_efficiency(trips):.4f}")
        return {"ms": ms, "bound_ms": bms, "bound_by": by}, line

    def fused(dtype, rtol=1e-6, atol=1e-9, kernel=True):
        """The headline lanes through solve_ivp('radau_fused') (K4), or
        with kernel=False through the twin loop on the card."""
        y0, mus = vdp_lanes(dtype)
        if kernel:
            return solve_ivp(vdp_rhs, (0.0, 1.0), y0, method="radau_fused",
                             args=mus, rtol=rtol, atol=atol)
        return rf.solve_radau_fused_ref(vdp_rhs, 0.0, 1.0, y0, mus,
                                        Options(rtol=rtol, atol=atol))

    torch.cuda.synchronize()
    k4.reset_launch_counts()
    sol_k = fused(torch.float64)
    torch.cuda.synchronize()
    launches["K4"] = k4.radau5_step.launches
    syncs = rf.solve_radau_fused.host_syncs
    succ, acc = fractions(sol_k)
    if succ != 1.0:
        _fail(f"radau_fused f64 success_fraction {succ} != 1.0")
    if launches["K4"] <= 0:
        _fail("radau_fused did not launch K4")
    if not torch.isfinite(sol_k.y).all():
        _fail("radau_fused f64: non-finite y")
    sec_k = _solve_seconds(lambda: fused(torch.float64))
    t_p = time.perf_counter()
    sol_p = fused(torch.float64, kernel=False)
    torch.cuda.synchronize()
    sec_p = time.perf_counter() - t_p
    e_twin = float(((sol_k.y - sol_p.y).abs()
                    / sol_p.y.abs().clamp(min=1e-300)).max())
    if not same_solution(sol_k, sol_p):
        _fail(f"radau_fused f64: kernel vs twin loop not equal to the bit "
              f"(y max rel {e_twin:.3e})")
    k4_rec, k4_line = k4_device("headline", vdp_rhs, 1.0, *vdp_lanes(
        torch.float64), Options(rtol=1e-6, atol=1e-9), sol_k)
    y0, mus = vdp_lanes(torch.float64)

    def eager_radau5():
        return solve_ivp(vdp_rhs, (0.0, 1.0), y0, method="radau5", args=mus,
                         rtol=1e-6, atol=1e-9, kernel_lu=True, pivoting=False)

    sol_e = eager_radau5()
    sec_e = _solve_seconds(eager_radau5)
    if not torch.allclose(sol_k.y, sol_e.y, rtol=1e-6, atol=1e-9):
        e = float(((sol_k.y - sol_e.y).abs() / (1e-6 * sol_e.y.abs() + 1e-9))
                  .max())
        _fail(f"radau_fused vs eager radau5: error / bound {e:.3e} > 1")
    print(f"[radau_fused f64] M={M} VdP mu=1e3 rtol 1e-6: success_fraction "
          f"{succ} accept_fraction {acc:.4f} K4 launches {launches['K4']} "
          f"host_syncs {syncs} nsteps max {int(sol_k.stats['nsteps'].max())}"
          f" | s/solve K4 {sec_k:.6f}, twin loop {sec_p:.4f} (one solve, "
          f"host clock), eager radau5 + K1/K2 {sec_e:.4f} | vs twin max rel "
          f"{e_twin:.3e} | y(1) lane0 {sol_k.y[0].tolist()}", flush=True)
    print(k4_line, flush=True)

    # 4 x 65,536 copies of the headline lanes: more than the card holds
    y4, mus4 = (x.repeat(4, *[1] * (x.ndim - 1))
                for x in vdp_lanes(torch.float64))
    sol_4 = solve_ivp(vdp_rhs, (0.0, 1.0), y4, method="radau_fused",
                      args=mus4, rtol=1e-6, atol=1e-9)
    if fractions(sol_4)[0] != 1.0:
        _fail(f"radau_fused 4x{M}: success_fraction {fractions(sol_4)[0]}")
    if not torch.equal(sol_4.y.reshape(4, M, 2),
                       sol_k.y.expand(4, M, 2)):
        _fail(f"radau_fused 4x{M}: a copy's y differs from the headline's")
    print(k4_device("4x65536", vdp_rhs, 1.0, y4, mus4,
                    Options(rtol=1e-6, atol=1e-9), sol_4)[1]
          + " | every copy's y equal to the headline's", flush=True)

    # ---- 10. radau_fused, heterogeneous mu, f64, against scipy -------------
    mus_h = torch.logspace(1, 3, M, dtype=torch.float64, device=dev)
    t_h = time.perf_counter()
    sol_fh = solve_ivp(vdp_rhs, (0.0, 1.0), y0, method="radau_fused",
                       args=mus_h, rtol=1e-6, atol=1e-9)
    torch.cuda.synchronize()
    sec_fh = time.perf_counter() - t_h
    succ_fh, acc_fh = fractions(sol_fh)
    if succ_fh != 1.0:
        _fail(f"radau_fused heterogeneous mu: success_fraction {succ_fh}")
    worst = scipy_worst(sol_fh.y.cpu().numpy(), mus_h,
                        "radau_fused heterogeneous mu")
    print(f"[radau_fused hetero mu f64] success_fraction {succ_fh} "
          f"accept_fraction {acc_fh:.4f} host_syncs "
          f"{rf.solve_radau_fused.host_syncs} | {sec_fh:.6f} s (one solve, "
          f"host clock) | 8 lanes vs scipy Radau: worst error / bound "
          f"{worst:.3e}", flush=True)
    print(k4_device("hetero mu", vdp_rhs, 1.0, y0, mus_h,
                    Options(rtol=1e-6, atol=1e-9), sol_fh)[1], flush=True)

    # ---- 11. radau_fused, Robertson (D=3) -----------------------------------
    m_r = 4096
    y0_r = torch.tensor([[1.0, 0.0, 0.0]], dtype=torch.float64,
                        device=dev).repeat(m_r, 1)
    tf_r = torch.logspace(-2, 2, m_r, dtype=torch.float64, device=dev)
    sol_r = solve_ivp(robertson_rhs, (0.0, tf_r), y0_r, method="radau_fused",
                      rtol=1e-6, atol=1e-10)
    sol_rp = rf.solve_radau_fused_ref(robertson_rhs, 0.0, tf_r, y0_r, None,
                                      Options(rtol=1e-6, atol=1e-10))
    succ_r, acc_r = fractions(sol_r)
    if succ_r != 1.0:
        _fail(f"radau_fused Robertson: success_fraction {succ_r}")
    if not same_solution(sol_r, sol_rp):
        _fail("radau_fused Robertson: kernel vs twin loop not equal to the "
              "bit")
    print(f"[radau_fused Robertson f64] M={m_r} tf=logspace(-2,2): "
          f"success_fraction {succ_r} accept_fraction {acc_r:.4f} nsteps max "
          f"{int(sol_r.stats['nsteps'].max())} | equal to the twin loop to "
          f"the bit", flush=True)
    print(k4_device("Robertson", robertson_rhs, tf_r, y0_r, None,
                    Options(rtol=1e-6, atol=1e-10), sol_r)[1], flush=True)

    # ---- 12. radau_fused, f32 ------------------------------------------------
    sol_f = fused(torch.float32, rtol=1e-4, atol=1e-7)
    succ_f, acc_f = fractions(sol_f)
    if not torch.isfinite(sol_f.y).all():
        _fail("radau_fused f32: non-finite y")
    if succ_f < 0.99:
        _fail(f"radau_fused f32 success_fraction {succ_f} < 0.99")
    print(f"[radau_fused f32] rtol 1e-4: success_fraction {succ_f} "
          f"accept_fraction {acc_f:.4f}", flush=True)
    print(k4_device("f32", vdp_rhs, 1.0, *vdp_lanes(torch.float32),
                    Options(rtol=1e-4, atol=1e-7), sol_f)[1], flush=True)

    # ---- 13. the matrix-free Radau path ---------------------------------------
    # ---- 14. the continuous adjoint (the last two phases of mol.PHASES) ------
    t13 = time.perf_counter()
    print(f"[phases 1-12] {t13 - t_start:.1f} s, the build included",
          flush=True)
    report = mol.run(dev, smoke=True)  # raises mol.MolCheckFailed
    print(f"[phase 13-14] {time.perf_counter() - t13:.1f} s", flush=True)
    adj_launches = report["vdp_adjoint"]["launches"]

    # ---- 15. RODAS4, its discrete adjoint, events ------------------------------
    t15 = time.perf_counter()
    rodas_report = rodas_probe.run(dev, smoke=True)   # raises RodasCheckFailed
    rodas_launches = rodas_report["forward"]["launches"]
    print(f"[phase 15] {time.perf_counter() - t15:.1f} s", flush=True)

    # ---- 16. dopri, its adjoint, step_args and radau_hvp -----------------------
    t16 = time.perf_counter()
    dopri_report = dopri_probe.run(dev, smoke=True)  # raises DopriCheckFailed
    route = {"launches_step_args": dopri_report["step_args"]["launches"],
             "launches_hvp": dopri_report["hvp"]["launches"]}
    print(f"[phase 16] {time.perf_counter() - t16:.1f} s", flush=True)

    # ---- 17. NDF/BDF and its discrete adjoint -----------------------------------
    t17 = time.perf_counter()
    ndf_report = ndf_probe.run(dev, smoke=True)     # raises NdfCheckFailed
    route.update(launches_ndf=ndf_report["forward"]["launches"],
                 launches_ndf_adjoint=ndf_report["adjoint_f64"]["launches"])
    print(f"[phase 17] {time.perf_counter() - t17:.1f} s", flush=True)

    # ---- 18. SEULEX and its discrete adjoint ------------------------------------
    t18 = time.perf_counter()
    seulex_report = seulex_probe.run(dev, smoke=True)  # SeulexCheckFailed
    route.update(
        launches_seulex=seulex_report["forward"]["launches"],
        launches_seulex_adjoint=seulex_report["adjoint_f64"]["launches"])
    print(f"[phase 18] {time.perf_counter() - t18:.1f} s", flush=True)

    # ---- 19. radaup, its adjoint, bdf2, grk4t, odeint_fixed ----------------------
    t19 = time.perf_counter()
    radaup_report = radaup_probe.run(dev, smoke=True)  # RadaupCheckFailed
    route.update(
        launches_radaup=radaup_report["forward"]["launches"],
        launches_radaup_adjoint=radaup_report["adjoint_f64"]["launches"],
        launches_bdf2=radaup_report["bdf2_f64"]["launches"],
        launches_grk4t=radaup_report["grk4t_f64"]["launches"])
    print(f"[phase 19] {time.perf_counter() - t19:.1f} s", flush=True)

    # ---- 20. ham, jet: Hamiltonian VdP sensitivities, the transform, F1 ------
    t20 = time.perf_counter()
    ham_report = ham_probe.run(dev, smoke=True)   # raises HamCheckFailed
    route.update(launches_ham=ham_report["ham"]["launches"])
    print(f"[phase 20] {time.perf_counter() - t20:.1f} s", flush=True)

    # ---- 21. control: multiple-shooting PMP VdP through K1/K2 -----------------
    t21 = time.perf_counter()
    control_report = control_probe.run(dev, smoke=True)  # ControlCheckFailed
    route.update(launches_control=control_report["ind"]["launches"])
    print(f"[phase 21] {time.perf_counter() - t21:.1f} s", flush=True)

    # ---- 22. infrastructure and examples: the sharded headline, traces ---------
    t22 = time.perf_counter()
    infra_report = infra_probe.run(dev, smoke=True)  # InfraCheckFailed
    route.update(launches_examples=infra_report["examples"]["launches"])
    sharded = infra_report["sharded"]["launches"]
    print(f"[phase 22] {time.perf_counter() - t22:.1f} s", flush=True)

    # ---- 23. the last eleven examples: the Poincare sweep, the fit ------------
    t23 = time.perf_counter()
    ex_report = examples_probe.run(dev, smoke=True)  # ExamplesCheckFailed
    route.update(launches_poincare=ex_report["poincare"]["launches"],
                 launches_fit_mu=ex_report["fit_mu"]["launches"],
                 launches_newton_cg=ex_report["newton_cg"]["launches"])
    print(f"[phase 23] {time.perf_counter() - t23:.1f} s", flush=True)

    # ---- 24. lockstep: every family split over two ranks -----------------------
    t24 = time.perf_counter()
    lock_report = lockstep_probe.run(dev, smoke=True)  # LockstepCheckFailed
    lockstep = {k: lockstep_probe.launches_by_family(lock_report, k)
                for k in ("K1", "K2", "K4")}
    print(f"[phase 24] {time.perf_counter() - t24:.1f} s", flush=True)

    # ---- 25. K4 for any right-hand side up to D = 8 -----------------------
    t25 = time.perf_counter()
    fused = fused_any_probe.run(dev, smoke=True, started=fused_started)
    print("[K4 group layout] K4 ms a solve, f64, 65,536 lanes: " + ", ".join(
        f"{name} {fused[name]['k4']['ms']:.3f} ms ("
        f"{fused[name]['build']['threads_per_lane']} threads a lane, "
        f"{fused[name]['build']['registers']} registers, "
        f"{fused[name]['build']['local_bytes']} B local)"
        for name in ("dubins_pmp", "hires")) + f" | {smi}", flush=True)
    print(f"[phase 25] {time.perf_counter() - t25:.1f} s", flush=True)

    # ---- 26. Radau5 on Pleiades: K1's tile kernel at D = 28 and 56 ---------
    t26 = time.perf_counter()
    pleiades = lu_tile_probe.run(dev, smoke=True)  # raises LuTileCheckFailed
    print(f"[phase 26] {time.perf_counter() - t26:.1f} s", flush=True)
    print(f"[total] {time.perf_counter() - t_start:.1f} s, the build "
          "included", flush=True)

    k1, k1p, k2, k2p, extra = times[(torch.float64, 4)]
    (b1, by1, lib1), (b2, by2, lib2) = (extra["lu_factor_t"],
                                        extra["lu_solve_t"])
    print(json.dumps({"kernels": [
        {"name": "lu_factor_t", "route": "cuda",
         "source": "janus_tpu_torch/csrc/smalllu.cu + smalllu_tile.cu",
         "replaces": "janus_tpu/ops/smalllu_pallas.py:84",
         "launches": launches["K1"], "max_abs_err": err["K1"]["float64"],
         "ms": k1, "plain_ms": k1p, "bound_ms": b1, "bound_by": by1,
         "library_ms": lib1, "shape": f"D=4 M={M} float64",
         "launches_vdp_adjoint": adj_launches["K1"],
         "launches_rodas": rodas_launches["K1"],
         **{k: v["K1"] for k, v in route.items()},
         "launches_sharded": [r["K1"] for r in sharded],
         "launches_lockstep": lockstep["K1"],
         "launches_pleiades": pleiades["launches_by_d"]["K1"],
         "tile": tile["lu_factor_t"]},
        {"name": "lu_solve_t", "route": "cuda",
         "source": "janus_tpu_torch/csrc/smalllu.cu",
         "replaces": "janus_tpu/ops/smalllu_pallas.py:115",
         "launches": launches["K2"], "max_abs_err": err["K2"]["float64"],
         "ms": k2, "plain_ms": k2p, "bound_ms": b2, "bound_by": by2,
         "library_ms": lib2, "shape": f"D=4 M={M} float64",
         "launches_vdp_adjoint": adj_launches["K2"],
         "launches_rodas": rodas_launches["K2"],
         **{k: v["K2"] for k, v in route.items()},
         "launches_sharded": [r["K2"] for r in sharded],
         "launches_lockstep": lockstep["K2"],
         "launches_pleiades": pleiades["launches_by_d"]["K2"],
         "above_16": tile["lu_solve_t"]},
        {"name": "linsolve_fused", "route": "cuda",
         "source": "janus_tpu_torch/csrc/smalllu.cu + smalllu_tile.cu",
         "replaces": "janus_tpu/ops/smalllu_pallas.py:55",
         "launches": launches["K3"], "max_abs_err": err["K3"]["float64"],
         "ms": k3, "plain_ms": k3p, "bound_ms": k3_bound[0],
         "bound_by": k3_bound[1], "library_ms": k3_lib,
         "shape": f"D=4 M={M} float64 (library: pivoted solve)",
         "tile": tile["linsolve_fused"]},
        {"name": "radau5_step", "route": "cuda",
         "source": "janus_tpu_torch/csrc/radau_fused.cu + radau5_step.cuh",
         "replaces": "janus_tpu/solve/radau_fused.py:170",
         "launches": launches["K4"], "max_abs_err": k4_err["float64"],
         "ms": k4_rec["ms"], "plain_ms": sec_p * 1e3,
         "bound_ms": k4_rec["bound_ms"], "bound_by": k4_rec["bound_by"],
         "library_ms": None,
         "launches_sharded": lockstep["K4"]["radau_fused"],
         "shape": f"every K4 launch of one radau_fused solve, VdP D=2 "
                  f"M={M} float64 (plain: the twin loop's solve)"},
        *[fused_any_probe.kernel_record(name, rec)
          for name, rec in fused.items() if isinstance(rec, dict)],
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
