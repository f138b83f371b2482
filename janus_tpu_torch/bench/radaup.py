"""Drive, check and measure the variable-order Radau ladder, its adjoint and
the legacy steppers on a card.

Phase 19 of ``chip_smoke.py`` (``run(dev, smoke=True)``), and a probe of its
own, run from the root of a checkout on a machine with a CUDA card:

    python3 -m janus_tpu_torch.bench.radaup [--only PHASE ...] [--json PATH]

Phases (``PHASES``), each raising ``RadaupCheckFailed`` when its check fails:
- ``forward``: solve_radau_vo (stages 1..7) on the 65,536 headline lanes of
  the Radau9 bench (Van der Pol, mu = 1e3, y0 = (2, 0), t in [0, 1], rtol
  1e-6, atol 1e-9, f64, the analytic Jacobian, pivoting=False) with K=2
  IND tangents (unit seeds in y0), through K1/K2 (kernel_lu=True: K1
  factors each order's real and split-complex blocks, K2 does every
  Newton, error-estimate and tangent solve) and through the plain
  pivot-free LU, in alternating turns (kernel, plain, plain, kernel,
  kernel, plain): s per solve (median of 3 per route, CUDA events) with
  the spread, K1/K2 launches, host syncs, sum(nlu)/sum(naccept) (a lane at
  a higher order factors more blocks a step); checks: every lane SUCCESS,
  the seven counters, y and sens equal to the bit between the routes, 8
  lanes within ``SCIPY_BOUND`` of scipy's Radau at rtol 1e-10; the same
  beside it on mu = logspace(1, 3) through the kernels, where the ladder
  mixes orders; without ``smoke`` also each route's launches and device
  busy time in one solve under torch.profiler.
- ``adjoint``: solve_adjoint(method='radaup') on the configuration of
  ``experiments/radaup_adjoint_chip.py`` (Van der Pol, y0 = (2, 0), mu =
  logspace(1, 3), t in [0, 1], rtol 1e-4, atol 1e-7, pivoting=False,
  adjoint_steps=128, the analytic Jacobian, loss sum(y(T)^2), gradient in
  y0 and mu), the forward through K1/K2 and the backward on the plain LU;
  8,192 lanes in f64 and in f32 (the ladder capped at s=5), 65,536 lanes
  in f64: ms per gradient (median of 3 after a warm-up, CUDA events),
  K1/K2 launches and host syncs of one gradient, max(naccept) of 128, the
  mesh's bytes, peak memory; at 8,192 lanes f64 the checks: finite; d/dmu
  of lanes 0, M/2, M-1 against central differences of the full solve (eps
  = 1e-6 mu) within ``FD_BOUND`` relative; 4 lanes on the card against the
  CPU within 1e-7. Without ``smoke`` also the device's busy share of one
  f64 gradient under torch.profiler.
- ``legacy``: solve_bdf2 and solve_ros4 (GRK4T) on the 65,536-lane batch
  of ``experiments/chip_matrix.py`` (y0 = (2, 0), mu = 10^U(1, 3) from
  numpy's RandomState(0), t in [0, 1], rtol 1e-4, atol 1e-7, pivoting=False,
  the analytic Jacobian), in f64 and f32, through K1/K2 (K1 factors the
  iteration matrix, K2 does every Newton, error and stage solve) and the
  plain pivot-free LU in alternating turns: s per solve, K1/K2 launches,
  host syncs; checks: the counters and y equal to the bit between the
  routes, the success fraction (1 in f64, >= 0.99 in f32) and, in f64, 8
  lanes within ``LEGACY_BOUND`` of scipy's Radau at rtol 1e-10.
- ``fixed``: odeint_fixed rk4 (200 steps, remat) on 65,536 harmonic lanes
  (y0 and omega from a numpy seed, t in [0, 10]), loss sum(y(T)^2) and its
  gradient in y0 and omega by autograd through the checkpointed loop: ms
  per gradient; y and the gradients of the first 4,096 lanes within 1e-10
  of the same computation on the CPU (relative to the largest entry; the
  lanes are independent).

- ``gates``: the A/B of the ladder's gates: ``solve_radau_vo`` as it is
  (one host read an attempt gates the Jacobian and each order's factor and
  Newton, one read after the error estimate gates each order's tangent
  sweep) against the same solve with the gates forced open (every order's
  factor, Newton and tangent sweep on every attempt, selected per lane, as
  the reference's ladder would run without its conds), made at run time
  from the source of ``solve/radaup.py`` by replacing the two reads, on
  the forward phase's headline lanes and on mu = logspace(1, 3) through
  K1/K2, in alternating turns (gated, open, open, gated, gated, open):
  s per solve, host syncs, K1/K2 launches; check: results equal to the
  bit. Not part of ``run(smoke=True)``.

``run(dev, smoke=True)`` is chip_smoke's phase 19: one turn of each route
of the headline forward and the heterogeneous forward with their checks,
the f64 gradient at 8,192 lanes with its checks, one turn of each route of
bdf2 and grk4t in f64, and the fixed-grid phase; no medians, f32, 65,536-
lane gradient or profiler.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from janus_tpu_torch.bench import mol
from janus_tpu_torch.bench.kernels import events_ms
from janus_tpu_torch.bench.ndf import scipy_worst
from janus_tpu_torch.bench.rodas import _mus
from janus_tpu_torch.models.problems import vdp_jac, vdp_rhs
from janus_tpu_torch.solve import Options, solve_adjoint
from janus_tpu_torch.solve.adjoint import radau_adjoint
from janus_tpu_torch.solve.bdf import solve_bdf2
from janus_tpu_torch.solve.fixed import odeint_fixed
from janus_tpu_torch.solve import radaup as gated
from janus_tpu_torch.solve.radaup import solve_radau_vo
from janus_tpu_torch.solve.rosenbrock import solve_ros4

M_ADJ = 8192
M_FWD = 65_536
LADDER = dict(min_stages=1, max_stages=7)
FWD_OPTS = dict(rtol=1e-6, atol=1e-9, pivoting=False, **LADDER)
ADJ_OPTS = dict(rtol=1e-4, atol=1e-7, pivoting=False, adjoint_steps=128,
                kernel_lu=True, **LADDER)
LEGACY_OPTS = dict(rtol=1e-4, atol=1e-7, pivoting=False)
STATS = ("nfev", "njev", "nlu", "nsteps", "naccept", "nreject", "nnewton")
LEGACY = {"bdf2": solve_bdf2, "grk4t": solve_ros4}
# tests/test_radaup.py's bound against scipy's Radau (relative, absolute)
SCIPY_BOUND = (1e-5, 1e-7)
# tests/test_stiff_methods.py's bound for the heterogeneous batch
LEGACY_BOUND = (5e-4, 5e-5)
# the frozen-mesh gradient against central differences of the full solve:
# the controller's mesh sensitivity at rtol 1e-4, measured on the CPU for
# lanes 0, M/2, M-1 of 8,192: 4.1e-6, 5.8e-7, 8.0e-8 (over 200 lanes of the
# same mu range: median 4.5e-7, 90th percentile 2.0e-6, max 3.4e-5; the
# same at eps = 1e-4 mu but for the max)
FD_BOUND = 1e-4
FIXED_STEPS = 200


class RadaupCheckFailed(RuntimeError):
    """A phase's check did not hold."""


def _seeds(m, dtype, dev):
    seeds = torch.zeros((2, m, 2), dtype=dtype, device=dev)
    seeds[0, :, 0] = 1.0
    seeds[1, :, 1] = 1.0
    return seeds


def _eight(m):
    return np.linspace(0, m - 1, 8).round().astype(int)


def forward_solve(dev, kernel_lu, mus=None, m=M_FWD, solver=solve_radau_vo):
    """The headline lanes (m of them, or as many as mus) through the ladder
    with K=2 IND tangents, unit seeds in y0."""
    dtype = torch.float64
    m = m if mus is None else mus.shape[0]
    y0 = torch.tensor([[2.0, 0.0]], dtype=dtype, device=dev).repeat(m, 1)
    if mus is None:
        mus = torch.full((m,), 1e3, dtype=dtype, device=dev)
    return solver(vdp_rhs, 0.0, 1.0, y0, mus,
                  Options(kernel_lu=kernel_lu, **FWD_OPTS), jac=vdp_jac,
                  tangents=_seeds(m, dtype, dev))


def _nlu_per_accept(sol):
    return float(sol.stats["nlu"].sum()) / float(sol.stats["naccept"].sum())


def forward_phase(dev, smoke=False):
    """K1/K2 on the ladder: the kernel_lu solve against the plain
    pivot-free LU on the headline lanes, and the mixed-order lanes."""
    name = f"radaup forward M={M_FWD} f64 mu=1e3 rtol 1e-6 K=2 IND"
    forward_solve(dev, True, m=64)        # builds K1/K2 if nothing has yet
    turns = {True: [], False: []}
    sols, launches, syncs = {}, None, {}
    order = (True, False) if smoke else (True, False, False, True, True,
                                         False)
    for k in order:
        torch.cuda.synchronize()
        mol._reset_kernel_launches()
        out = []
        turns[k].append(events_ms(lambda: out.append(forward_solve(dev, k)),
                                  1) / 1e3)
        syncs[k] = solve_radau_vo.host_syncs
        if k and launches is None:
            launches = mol._kernel_launches()
        elif not k and any(mol._kernel_launches().values()):
            raise RadaupCheckFailed(f"{name}: the plain route launched a "
                                    f"kernel: {mol._kernel_launches()}")
        sols[k] = out[0]
    sol_k, sol_p = sols[True], sols[False]
    if launches["K1"] <= 0 or launches["K2"] <= 0:
        raise RadaupCheckFailed(f"{name}: kernel_lu=True did not launch K1 "
                                f"and K2: {launches}")
    for what, sol in (("kernel", sol_k), ("plain", sol_p)):
        if not bool((sol.status == 1).all()):
            raise RadaupCheckFailed(f"{name}: {what} route not SUCCESS on "
                                    "every lane")
    for k in STATS:
        if not torch.equal(sol_k.stats[k], sol_p.stats[k]):
            raise RadaupCheckFailed(f"{name}: counter {k} differs between "
                                    "the routes")
    for what in ("t", "y", "sens"):
        if not torch.equal(getattr(sol_k, what), getattr(sol_p, what)):
            err = float((getattr(sol_k, what) - getattr(sol_p, what)).abs()
                        .max())
            raise RadaupCheckFailed(f"{name}: {what} differs between the "
                                    f"routes (max {err:.3e}), not equal to "
                                    "the bit")
    mus = _mus(1.0, 3.0, M_FWD, torch.float64, dev)
    mol._reset_kernel_launches()
    t_h = time.perf_counter()
    sol_h = forward_solve(dev, True, mus=mus)
    torch.cuda.synchronize()
    sec_h = time.perf_counter() - t_h
    launches_h = mol._kernel_launches()
    if not bool((sol_h.status == 1).all()):
        raise RadaupCheckFailed("radaup heterogeneous mu: not SUCCESS")
    rec = {"launches": launches, "host_syncs": syncs[True],
           "host_syncs_plain": syncs[False],
           "stats_max": {k: int(sol_k.stats[k].max()) for k in STATS},
           "nlu_per_accept": _nlu_per_accept(sol_k),
           "scipy_worst": scipy_worst(
               sol_k.y.cpu().numpy(), np.full(M_FWD, 1e3), _eight(M_FWD),
               SCIPY_BOUND, "radaup", RadaupCheckFailed),
           "heterogeneous": {
               "s_one_solve_host_clock": sec_h, "launches": launches_h,
               "host_syncs": solve_radau_vo.host_syncs,
               "stats_max": {k: int(sol_h.stats[k].max()) for k in STATS},
               "nlu_per_accept": _nlu_per_accept(sol_h),
               "scipy_worst": scipy_worst(
                   sol_h.y.cpu().numpy(), mus.cpu().numpy(), _eight(M_FWD),
                   SCIPY_BOUND, "radaup", RadaupCheckFailed)},
           "turns": {"kernel": turns[True], "plain": turns[False]}}
    rec["s_per_solve_kernel"] = statistics.median(turns[True])
    rec["s_per_solve_plain"] = statistics.median(turns[False])
    extra = ""
    if not smoke:
        for k in (True, False):
            prof = mol.profile_solve(lambda wrap, _k=k: forward_solve(dev, _k))
            rec[f"profile_{'kernel' if k else 'plain'}"] = prof
        busy = {k: rec[f"profile_{k}"]["busy_ms"] for k in ("kernel", "plain")}
        extra += (f" | one solve under torch.profiler: launches kernel_lu "
                  f"{rec['profile_kernel']['launches']}, plain "
                  f"{rec['profile_plain']['launches']}; device busy "
                  f"{busy['kernel']:.2f} / {busy['plain']:.2f} ms")
    st, het = rec["stats_max"], rec["heterogeneous"]
    print(f"[{name}] every lane SUCCESS, the seven counters, y and sens "
          f"equal to the bit between the routes (max nsteps {st['nsteps']}, "
          f"naccept {st['naccept']}, nlu {st['nlu']}, nfev {st['nfev']}; "
          f"nlu/naccept {rec['nlu_per_accept']:.3f}) | kernel_lu launches "
          f"K1 {launches['K1']}, K2 {launches['K2']} (K3 {launches['K3']}, "
          f"K4 {launches['K4']}) | host syncs {syncs[True]} | s/solve "
          f"kernel_lu {turns[True]}, plain LU {turns[False]} (turns "
          f"{'K P' if smoke else 'K P P K K P'}; CUDA events) | 8 lanes vs "
          f"scipy Radau worst error / bound {rec['scipy_worst']:.3e} | "
          f"mu=logspace(1,3) through K1/K2: {sec_h:.3f} s (one solve, host "
          f"clock), K1 {launches_h['K1']}, K2 {launches_h['K2']}, host "
          f"syncs {het['host_syncs']}, max nsteps "
          f"{het['stats_max']['nsteps']}, nlu/naccept "
          f"{het['nlu_per_accept']:.3f}, vs scipy {het['scipy_worst']:.3e}"
          + extra, flush=True)
    return rec


def adj_inputs(m, dtype, dev):
    """y0 [m, 2] = (2, 0) and mu = logspace(1, 3, m)."""
    y0 = torch.tensor([[2.0, 0.0]], dtype=dtype, device=dev).repeat(m, 1)
    return y0, _mus(1.0, 3.0, m, dtype, dev)


def gradient(m, dtype, dev, wrap=None):
    """The loss sum(y(T)^2) on m lanes and its gradient through
    solve_adjoint(method='radaup'): (loss, dL/dy0 [m, 2], dL/dmu [m])."""
    y0, mus = adj_inputs(m, dtype, dev)
    y0.requires_grad_()
    mus.requires_grad_()
    y_end = solve_adjoint(vdp_rhs if wrap is None else wrap(vdp_rhs),
                          (0.0, 1.0), y0, method="radaup", args=mus,
                          options=Options(**ADJ_OPTS), jac=vdp_jac)
    loss = torch.sum(y_end ** 2)
    loss.backward()
    return loss.detach(), y0.grad, mus.grad


def fd_check(g_mu, mus, y0, lanes):
    """d/dmu of the given lanes against central differences of the full
    solve (eps = 1e-6 mu): the largest relative difference."""
    eps = 1e-6 * mus[lanes]
    opts = Options(**ADJ_OPTS)
    n = len(lanes)
    y6 = solve_radau_vo(vdp_rhs, 0.0, 1.0, y0[lanes].repeat(2, 1),
                        torch.cat([mus[lanes] + eps, mus[lanes] - eps]),
                        opts, jac=vdp_jac).y
    l6 = torch.sum(y6 ** 2, dim=-1)
    fd = (l6[:n] - l6[n:]) / (2.0 * eps)
    return float(((g_mu[lanes] - fd).abs() / fd.abs()).max())


def mesh_bytes(m, dim, dtype, smax):
    """The adjoint's rings: per lane and slot t, h, y [D] and the padded
    polynomial [smax, D]."""
    esize = torch.finfo(dtype).bits // 8
    return m * ADJ_OPTS["adjoint_steps"] * (2 + dim + smax * dim) * esize


def adjoint_phase(dev, m=M_ADJ, dtype=torch.float64, reps=3, checks=True,
                  profile=False):
    """One cell of the ladder's adjoint: the gradient at m lanes."""
    name = f"radaup adjoint M={m} {str(dtype)[6:]}"
    gradient(m, dtype, dev)                             # the warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    mol._reset_kernel_launches()
    g = gradient(m, dtype, dev)
    torch.cuda.synchronize()
    launches = mol._kernel_launches()
    peak = torch.cuda.max_memory_allocated(dev)
    syncs = (solve_radau_vo.host_syncs, radau_adjoint.host_syncs)
    if not all(bool(torch.isfinite(x).all()) for x in g[1:]):
        raise RadaupCheckFailed(f"{name}: non-finite gradient")
    if launches["K1"] <= 0 or launches["K2"] <= 0:
        raise RadaupCheckFailed(f"{name}: K1/K2 not launched: {launches}")
    y0, mus = adj_inputs(m, dtype, dev)
    with torch.no_grad():
        sol = solve_radau_vo(vdp_rhs, 0.0, 1.0, y0, mus, Options(**ADJ_OPTS),
                             jac=vdp_jac)
    nacc = int(sol.stats["naccept"].max())
    if not bool((sol.status == 1).all()) or nacc > ADJ_OPTS["adjoint_steps"]:
        raise RadaupCheckFailed(f"{name}: forward not SUCCESS on every "
                                f"lane, or max(naccept) {nacc} > 128")
    errs = None
    if checks:
        errs = {"fd_mu": fd_check(g[2], mus, y0, [0, m // 2, m - 1])}
        on_card = gradient(4, dtype, dev)
        on_cpu = gradient(4, dtype, torch.device("cpu"))
        errs["cpu"] = max(float((a.cpu() - b).abs().max() / b.abs().max())
                          for a, b in zip(on_card[1:], on_cpu[1:]))
        for key, bound in (("fd_mu", FD_BOUND), ("cpu", 1e-7)):
            if not errs[key] <= bound:
                raise RadaupCheckFailed(f"{name}: {key} check "
                                        f"{errs[key]:.3e} > {bound:g}")
    times = [events_ms(lambda: gradient(m, dtype, dev), 1)
             for _ in range(reps)]
    ms = statistics.median(times)
    smax = 5 if dtype == torch.float32 else 7
    rec = {"ms_per_gradient": ms, "ms_turns": times,
           "launches": launches, "host_syncs_forward": syncs[0],
           "host_syncs_backward": syncs[1], "naccept_max": nacc,
           "nlu_per_accept": _nlu_per_accept(sol),
           "adjoint_steps": ADJ_OPTS["adjoint_steps"],
           "mesh_bytes": mesh_bytes(m, 2, dtype, smax), "peak_bytes": peak,
           "checks": errs}
    if profile:
        prof = mol.profile_solve(lambda wrap: gradient(m, dtype, dev, wrap))
        rec.update(launches_all=prof["launches"], busy_ms=prof["busy_ms"],
                   busy_share=prof["busy_ms"] / ms)
    print(f"[{name}] VdP mu=logspace(1,3) rtol 1e-4 ladder 1..{smax}, the "
          f"forward through K1/K2: gradients finite | {ms:.2f} ms per "
          f"gradient (median of {reps}, CUDA events; "
          f"{[round(x, 2) for x in times]}) | K1 {launches['K1']}, K2 "
          f"{launches['K2']} launches a gradient | host syncs {syncs[0]} "
          f"forward + {syncs[1]} backward | max(naccept) {nacc} of "
          f"{ADJ_OPTS['adjoint_steps']}, nlu/naccept "
          f"{rec['nlu_per_accept']:.3f}, mesh "
          f"{rec['mesh_bytes'] / 1e6:.1f} MB, peak {peak / 1e6:.1f} MB"
          + ("" if not profile else
             f" | {rec['launches_all']} launches, device busy "
             f"{rec['busy_ms']:.2f} ms = {rec['busy_share']:.3f} of the "
             f"gradient (torch.profiler)")
          + ("" if errs is None else
             f" | d/dmu of lanes 0, M/2, M-1 vs central difference: "
             f"{errs['fd_mu']:.3e} (bound {FD_BOUND:g}); 4 lanes vs the "
             f"CPU: {errs['cpu']:.3e} (bound 1e-7)"), flush=True)
    return rec


def legacy_inputs(m, dtype, dev):
    """experiments/chip_matrix.py's stiff batch: y0 = (2, 0), mu =
    10^U(1, 3) from numpy's RandomState(0)."""
    mus = 10.0 ** np.random.RandomState(0).uniform(1.0, 3.0, m)
    y0 = torch.tensor([[2.0, 0.0]], dtype=dtype, device=dev).repeat(m, 1)
    return y0, torch.from_numpy(mus).to(dev, dtype)


def legacy_solve(method, dev, kernel_lu, m=M_FWD, dtype=torch.float64):
    y0, mus = legacy_inputs(m, dtype, dev)
    return LEGACY[method](vdp_rhs, 0.0, 1.0, y0, mus,
                          Options(kernel_lu=kernel_lu, **LEGACY_OPTS),
                          jac=vdp_jac)


def legacy_phase(dev, method, dtype=torch.float64, smoke=False):
    """K1/K2 in bdf2 or grk4t: the kernel_lu solve against the plain
    pivot-free LU on the chip-matrix batch."""
    name = f"{method} M={M_FWD} {str(dtype)[6:]} mu=10^U(1,3) rtol 1e-4"
    solver = LEGACY[method]
    legacy_solve(method, dev, True, m=64, dtype=dtype)
    turns = {True: [], False: []}
    sols, launches, syncs = {}, None, {}
    for k in ((True, False) if smoke else (True, False, False, True, True,
                                           False)):
        torch.cuda.synchronize()
        mol._reset_kernel_launches()
        out = []
        turns[k].append(events_ms(lambda: out.append(
            legacy_solve(method, dev, k, dtype=dtype)), 1) / 1e3)
        syncs[k] = solver.host_syncs
        if k and launches is None:
            launches = mol._kernel_launches()
        elif not k and any(mol._kernel_launches().values()):
            raise RadaupCheckFailed(f"{name}: the plain route launched a "
                                    f"kernel: {mol._kernel_launches()}")
        sols[k] = out[0]
    sol_k, sol_p = sols[True], sols[False]
    if launches["K1"] <= 0 or launches["K2"] <= 0:
        raise RadaupCheckFailed(f"{name}: K1/K2 not launched: {launches}")
    for k in sol_k.stats:
        if not torch.equal(sol_k.stats[k], sol_p.stats[k]):
            raise RadaupCheckFailed(f"{name}: counter {k} differs between "
                                    "the routes")
    for what in ("t", "y", "status"):
        if not torch.equal(getattr(sol_k, what), getattr(sol_p, what)):
            raise RadaupCheckFailed(f"{name}: {what} differs between the "
                                    "routes (not equal to the bit)")
    success = float((sol_k.status == 1).double().mean())
    need = 1.0 if dtype == torch.float64 else 0.99
    if success < need:
        raise RadaupCheckFailed(f"{name}: success fraction {success} < "
                                f"{need}")
    worst = None
    if dtype == torch.float64:
        _, mus = legacy_inputs(M_FWD, torch.float64, torch.device("cpu"))
        worst = scipy_worst(sol_k.y.cpu().numpy(), mus.numpy(),
                            _eight(M_FWD), LEGACY_BOUND, method,
                            RadaupCheckFailed)
    rec = {"launches": launches, "host_syncs": syncs[True],
           "stats_max": {k: int(v.max()) for k, v in sol_k.stats.items()},
           "success_fraction": success, "scipy_worst": worst,
           "turns": {"kernel": turns[True], "plain": turns[False]},
           "s_per_solve_kernel": statistics.median(turns[True]),
           "s_per_solve_plain": statistics.median(turns[False])}
    print(f"[{name}] success fraction {success}, counters and y equal to "
          f"the bit between the routes (max nsteps "
          f"{rec['stats_max']['nsteps']}, nlu {rec['stats_max']['nlu']}) | "
          f"kernel_lu launches K1 {launches['K1']}, K2 {launches['K2']} | "
          f"host syncs {syncs[True]} | s/solve kernel_lu {turns[True]}, "
          f"plain LU {turns[False]} (CUDA events)"
          + ("" if worst is None else
             f" | 8 lanes vs scipy Radau worst error / bound {worst:.3e}"),
          flush=True)
    return rec


def fixed_inputs(m):
    """y0 [m, 2] and omega [m] of the harmonic lanes, from a numpy seed."""
    rng = np.random.default_rng(19)
    return (torch.from_numpy(rng.standard_normal((m, 2))),
            torch.from_numpy(rng.uniform(0.5, 2.0, m)))


def fixed_gradient(y0, om):
    """odeint_fixed rk4 on the harmonic lanes (y0, omega), loss
    sum(y(T)^2): (y(T), dL/dy0, dL/domega)."""
    y0 = y0.clone().requires_grad_()
    om = om.clone().requires_grad_()
    y = odeint_fixed(lambda t, y, w: torch.stack(
        [y[:, 1], -(w * w) * y[:, 0]], -1), 0.0, 10.0, y0, FIXED_STEPS, om,
        method="rk4", remat=True)
    torch.sum(y ** 2).backward()
    return y.detach(), y0.grad, om.grad


def fixed_phase(dev, m=M_FWD, m_cpu=4096):
    """The fixed grid: the gradient through the checkpointed loop on the
    card, its first m_cpu lanes against the CPU (the lanes are
    independent)."""
    name = f"odeint_fixed rk4 M={m} f64 {FIXED_STEPS} steps remat"
    y0, om = fixed_inputs(m)
    y0_d, om_d = y0.to(dev), om.to(dev)
    fixed_gradient(y0_d, om_d)
    torch.cuda.synchronize()
    out = []
    ms = events_ms(lambda: out.append(fixed_gradient(y0_d, om_d)), 1)
    cpu = fixed_gradient(y0[:m_cpu], om[:m_cpu])
    err = max(float((a[:m_cpu].cpu() - b).abs().max() / b.abs().max())
              for a, b in zip(out[0], cpu))
    if not err <= 1e-10:
        raise RadaupCheckFailed(f"{name}: card vs CPU {err:.3e} > 1e-10")
    print(f"[{name}] harmonic lanes, loss sum(y(T)^2): {ms:.2f} ms per "
          f"gradient (one, CUDA events) | y and the gradients of the first "
          f"{m_cpu} lanes vs the CPU {err:.3e} (bound 1e-10)", flush=True)
    return {"ms_per_gradient": ms, "cpu": err}


GATE_READS = (
    ("        flags = syncs.any_each(active, needj, *sels, *needfs)",
     "        flags = [syncs.any(active)] + [True] * (1 + 2 * len(orders))"),
    ("syncs.any_each(*masks)", "[True] * len(masks)"))


def ungated_module():
    """solve/radaup.py with its gates forced open, as a module of its own."""
    src = Path(gated.__file__).read_text()
    for read, open_ in GATE_READS:
        if src.count(read) != 1:
            raise RuntimeError("solve/radaup.py no longer reads its gates "
                               f"in the expected statement {read!r}")
        src = src.replace(read, open_)
    spec = importlib.util.spec_from_loader("radaup_ungated", loader=None)
    mod = importlib.util.module_from_spec(spec)
    exec(compile(src, "radaup_ungated", "exec"), mod.__dict__)
    return mod


def gates_phase(dev):
    """The gated ladder against the same ladder with its gates open."""
    open_mod = ungated_module()
    mus_h = _mus(1.0, 3.0, M_FWD, torch.float64, dev)
    forward_solve(dev, True, m=64)        # builds K1/K2 if nothing has yet
    rec = {}
    for label, mus in (("headline", None), ("logspace(1,3)", mus_h)):
        turns = {"gated": [], "open": []}
        sols, syncs, launches = {}, {}, {}
        for which in ("gated", "open", "open", "gated", "gated", "open"):
            mod = gated if which == "gated" else open_mod
            torch.cuda.synchronize()
            mol._reset_kernel_launches()
            out = []
            turns[which].append(events_ms(lambda: out.append(forward_solve(
                dev, True, mus=mus, solver=mod.solve_radau_vo)), 1) / 1e3)
            sols[which] = out[0]
            syncs[which] = mod.solve_radau_vo.host_syncs
            launches[which] = mol._kernel_launches()
        a, b = sols["gated"], sols["open"]
        if not all(torch.equal(getattr(a, k), getattr(b, k))
                   for k in ("t", "y", "sens", "status")) or not all(
                torch.equal(a.stats[k], b.stats[k]) for k in STATS):
            raise RadaupCheckFailed(f"gates {label}: the open ladder's "
                                    "results differ from the gated one's")
        med = {k: statistics.median(v) for k, v in turns.items()}
        rec[label] = {"turns": turns, "median_s": med, "host_syncs": syncs,
                      "launches": launches,
                      "open_over_gated": med["open"] / med["gated"]}
        print(f"[radaup gates {label} M={M_FWD} K=2 IND kernel_lu] s/solve "
              f"gated {turns['gated']}, open {turns['open']} (turns G O O G "
              f"G O; CUDA events): open / gated "
              f"{rec[label]['open_over_gated']:.3f} | host syncs gated "
              f"{syncs['gated']}, open {syncs['open']} | K1/K2 gated "
              f"{launches['gated']['K1']}/{launches['gated']['K2']}, open "
              f"{launches['open']['K1']}/{launches['open']['K2']} | results "
              f"equal to the bit", flush=True)
    return rec


PHASES = ("forward", "adjoint", "legacy", "fixed", "gates")


def run(dev, only=PHASES, smoke=False):
    """Run the named phases; returns their records with the seconds each
    phase took under ``"seconds"``."""
    report, seconds = {}, {}

    def timed(phase, key, fn, *a, **kw):
        t0 = time.perf_counter()
        report[key] = fn(dev, *a, **kw)
        torch.cuda.synchronize()
        seconds[phase] = seconds.get(phase, 0.0) + time.perf_counter() - t0

    if "forward" in only:
        timed("forward", "forward", forward_phase, smoke=smoke)
    if "adjoint" in only:
        timed("adjoint", "adjoint_f64", adjoint_phase,
              reps=1 if smoke else 3, profile=not smoke)
        if not smoke:
            timed("adjoint", "adjoint_f32", adjoint_phase,
                  dtype=torch.float32, checks=False)
            timed("adjoint", "adjoint_f64_65536", adjoint_phase, m=M_FWD,
                  checks=False)
    if "legacy" in only:
        for method in LEGACY:
            timed("legacy", f"{method}_f64", legacy_phase, method,
                  smoke=smoke)
            if not smoke:
                timed("legacy", f"{method}_f32", legacy_phase, method,
                      dtype=torch.float32)
    if "fixed" in only:
        timed("fixed", "fixed", fixed_phase)
    if "gates" in only and not smoke:
        timed("gates", "gates", gates_phase)
    report["seconds"] = seconds
    print("[radaup phase seconds] " + ", ".join(f"{k} {v:.1f}"
                                                for k, v in seconds.items()),
          flush=True)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="+", choices=PHASES, default=PHASES)
    ap.add_argument("--json", type=Path, default=None,
                    help="also write the JSON line to this file")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("radaup: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    report = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              **run(torch.device("cuda:0"), a.only)}
    line = json.dumps(report)
    if a.json is not None:
        a.json.parent.mkdir(parents=True, exist_ok=True)
        a.json.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
