"""Drive, check and measure the Hamiltonian-first API and the dual numbers
(``ham``, ``jet``) on a card.

Phase 20 of ``chip_smoke.py`` (``run(dev, smoke=True)``), and a probe of its
own, run from the root of a checkout on a machine with a CUDA card:

    python3 -m janus_tpu_torch.bench.ham [--only PHASE ...] [--json PATH]

Phases (``PHASES``), each raising ``HamCheckFailed`` when its check fails;
everything in f64:
- ``ham``: Hamiltonian Van der Pol sensitivities, the layout of
  ``examples/hamiltonian_vdp.py`` at full width: f =
  ``ham.hamiltonian_dynamics(vdp_hamiltonian)``, its Jacobian
  ``ham.hamiltonian_jacobian(vdp_hamiltonian)``, 65,536 lanes y = [p, x]
  with x0 = (2, 0), p0 = (linspace(0.1, 1, M), 0), mu = 1e3, t in [0, 1],
  Radau9, rtol 1e-6, atol 1e-9, pivoting=False, through
  ``solve_with_sensitivities(..., wrt_tf=True)``: the IND fast path with
  N = D + 1 = 5 directions (no warning may be raised). Routes: K1/K2
  (kernel_lu=True: K1 factors the real 4x4 and the split-complex 8x8 stage
  blocks, K2 does every Newton, error-estimate and tangent solve) and the
  plain pivot-free LU, in alternating turns (kernel, plain, plain, kernel,
  kernel, plain): s per solve (median of 3 per route, CUDA events) with the
  spread, K1/K2 launches, host syncs. Checks: status, the seven counters,
  y and Jet.d equal to the bit between the routes; the success fraction of
  8 lanes equal to the CPU port's on the same 8 lanes; the tf column within
  1e-6 relative of f(T, y(T)); dy(T)/dy0 of lanes 0, M/2, M-1 against
  central differences of the full solve within ``FD_BOUND``; 8 lanes
  against scipy's Radau at rtol 1e-10 on the explicit costate system within
  ``SCIPY_BOUND``. Also K1/K2 alone at this path's shapes (D=4 and the
  split-complex 2D=8, M lanes): device time (torch.profiler) beside the
  bound. Without ``smoke`` also each route's launches and device busy time
  in one solve under torch.profiler.
- ``transform``: the transform path, ``dual_solve_ivp(method='dopri5')``
  (no IND sweep: ``torch.func.vmap`` over ``torch.func.jvp`` of the whole
  solve) on 65,536 harmonic lanes (q0, v0, omega from a numpy seed, t in
  [0, 2], rtol 1e-10, atol 1e-12) with a Jet omega and a Jet y0 (N = 3:
  dq0, dv0, domega): s per call (CUDA events; without ``smoke`` the median
  of 3 after the checked call, and the launches and device busy time of one
  call under torch.profiler), K1-K4 launches (none), and the ratio per
  direction to the ``ham`` phase's kernel route. Checks:
  every lane SUCCESS; y and the three sensitivities within
  ``CLOSED_FORM_BOUND`` of the closed form; 4 lanes within 1e-10 of the CPU
  port.
- ``f1``: forward mode through every method on the card:
  ``torch.func.jvp`` of y(T) in a for y' = (a, 2a), y0 = (0.1, 0.2), T = 2,
  rtol 1e-7, atol 1e-10, a = 0.3, CUDA tensors, for the nine methods of
  ``tests/test_sens_degenerate.py``; each tangent must be (2, 4) within
  rtol 1e-6, atol 1e-8. Seconds per method.
- ``headline``: the host cost of ``safe_sqrt`` as an autograd.Function
  (the forward-mode fault's repair) on the Radau9 headline (65,536 VdP
  lanes, mu = 1e3, rtol 1e-6, K=2 IND, kernel_lu=True): the solve as it is
  against the same solve with ``torch.sqrt`` in its place, in alternating
  turns (F S S F, five times: ten a route): s per solve (median), K1/K2
  launches and host syncs; check: t, y, sens, status and counters equal to
  the bit, and the same launches. Not part of ``run(smoke=True)`` (phase 4
  of chip_smoke times the headline).

``run(dev, smoke=True)`` is chip_smoke's phase 20: one turn of each route of
``ham`` with its checks, ``transform`` and ``f1``; no medians, profiler or
``headline``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

from janus_tpu_torch import ham
from janus_tpu_torch.bench import kernels as kb
from janus_tpu_torch.bench import mol
from janus_tpu_torch.jet import Jet
from janus_tpu_torch.jet.solve import dual_solve_ivp, solve_with_sensitivities
from janus_tpu_torch.models.problems import (harmonic_rhs, vdp_hamiltonian,
                                             vdp_jac, vdp_rhs)
from janus_tpu_torch.ops import smalllu
from janus_tpu_torch.solve import Options, solve_ivp
from janus_tpu_torch.solve import common as cm
from janus_tpu_torch.solve.radau import solve_radau

M = 65_536
MU = 1e3
HAM_OPTS = dict(rtol=1e-6, atol=1e-9, pivoting=False)
STATS = ("nfev", "njev", "nlu", "nsteps", "naccept", "nreject", "nnewton")
# tests/test_radaup.py's bound against scipy's Radau (relative, absolute)
SCIPY_BOUND = (1e-5, 1e-7)
# IND dy(T)/dy0 against central differences of the full solve, relative to
# the largest entry of the lane's difference matrix: the controller's
# O(rtol) dependence on y0, which IND leaves out. Measured on the CPU for
# lanes 0, M/2, M-1: 3.9e-7, 9.9e-7, 1.9e-6 (over 40 lanes spread over the
# batch: median 9.9e-7, max 1.95e-6), the same at eps = 1e-5, 1e-6, 1e-7
FD_BOUND = 1e-5
FD_EPS = 1e-6
CLOSED_FORM_BOUND = 1e-8
T_HARMONIC = 2.0
FALLBACK = "dual_solve_ivp: falling back"
HEADLINE_TURNS = ("function", "sqrt", "sqrt", "function") * 5
METHODS = ("dopri5", "dopri853", "radau", "radaup", "bdf", "bdf2", "rodas",
           "grk4t", "seulex")


class HamCheckFailed(RuntimeError):
    """A phase's check did not hold."""


def _eight(m):
    return np.linspace(0, m - 1, 8).round().astype(int)


# ---- (a) Hamiltonian VdP sensitivities -------------------------------------

def ham_system():
    """(f, jac) of the Hamiltonian Van der Pol system, y = [p, x]."""
    return (ham.hamiltonian_dynamics(vdp_hamiltonian),
            ham.hamiltonian_jacobian(vdp_hamiltonian))


def ham_y0(m, dev, lanes=None):
    """y0 [m, 4] = [p0, x0]: x0 = (2, 0), p0 = (linspace(0.1, 1, M), 0)
    (made on the CPU in f64; ``lanes`` picks rows of the M-lane batch)."""
    p = torch.linspace(0.1, 1.0, m, dtype=torch.float64)
    if lanes is not None:
        p = p[torch.as_tensor(lanes)]
    y0 = torch.zeros((p.shape[0], 4), dtype=torch.float64)
    y0[:, 0] = p
    y0[:, 2] = 2.0
    return y0.to(dev)


def ham_solve(y0, kernel_lu, tf=1.0):
    """solve_with_sensitivities of the Hamiltonian VdP lanes y0 with the
    tf column; the transform's fallback warning raises."""
    f, jac = ham_system()
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=FALLBACK)
        return solve_with_sensitivities(
            f, (0.0, tf), y0, method="radau9", args={"mu": MU},
            options=Options(kernel_lu=kernel_lu, **HAM_OPTS), jac=jac,
            wrt_tf=True)


def costate_rhs(mu):
    """The explicit numpy rhs of the system hamiltonian_dynamics derives
    from vdp_hamiltonian (y = [p0, p1, x0, x1], p' = +dH/dx)."""
    def rhs(t, y):
        p0, p1, x0, x1 = y
        return [p1 * (-2.0 * mu * x0 * x1 - 1.0),
                p0 + p1 * mu * (1.0 - x0 * x0),
                x1, mu * (1.0 - x0 * x0) * x1 - x0]
    return rhs


def scipy_worst(y_got, y0, lanes, bound=SCIPY_BOUND):
    """Worst error / bound of the given lanes against scipy's Radau at rtol
    1e-10 on the explicit costate system."""
    from scipy.integrate import solve_ivp as scipy_ivp
    worst = 0.0
    for i in lanes:
        ref = scipy_ivp(costate_rhs(MU), (0.0, 1.0), y0[i], method="Radau",
                        rtol=1e-10, atol=1e-12).y[:, -1]
        e = np.abs(y_got[i] - ref) / (bound[0] * np.abs(ref) + bound[1])
        if not np.all(e <= 1.0):
            raise HamCheckFailed(f"ham lane {i}: y {y_got[i]} vs scipy {ref}")
        worst = max(worst, float(e.max()))
    return worst


def fd_worst(yj, dev, lanes):
    """dy(T)/dy0 of the given lanes (yj.d[:4] of the M-lane solve) against
    central differences of the full solve: the largest difference relative
    to the largest entry of the lane's difference matrix."""
    f, jac = ham_system()
    y0 = ham_y0(M, dev, lanes)
    n = len(lanes)
    batch = []
    for j in range(4):
        for sign in (1.0, -1.0):
            yy = y0.clone()
            yy[:, j] += sign * FD_EPS
            batch.append(yy)
    sol = solve_ivp(f, (0.0, 1.0), torch.cat(batch), method="radau9",
                    args={"mu": MU}, options=Options(**HAM_OPTS), jac=jac)
    y_end = sol.y.reshape(4, 2, n, 4)
    fd = (y_end[:, 0] - y_end[:, 1]) / (2.0 * FD_EPS)        # [j, lane, D]
    ind = yj.d[:4, torch.as_tensor(lanes, device=yj.d.device)]
    return max(float((ind[:, i] - fd[:, i]).abs().max()
                     / fd[:, i].abs().max()) for i in range(n))


def kernel_device(dev, reps=20):
    """K1/K2 alone at the ham path's shapes (M lanes, D=4 real and the
    split-complex 2D=8): device µs (torch.profiler; None where it recorded
    no kernel), wall µs a launch (CUDA events) and the bound in µs."""
    rng = np.random.default_rng(12)
    out = {}
    for d in (4, 8):
        a_t, b_t = kb.lu_inputs(rng, d, M, torch.float64, dev)
        lu = smalllu.lu_factor_t(a_t)
        for name, fn in (("lu_factor_t", lambda: smalllu.lu_factor_t(a_t)),
                         ("lu_solve_t", lambda: smalllu.lu_solve_t(lu,
                                                                   b_t))):
            bound, by = kb.bound_ms(*kb.lu_work(name, d, M, torch.float64),
                                    torch.float64)
            dms = kb.device_ms(fn, reps)
            out[f"{name} D={d}"] = {
                "device_us": None if dms is None else dms * 1e3,
                "events_us": kb.events_ms(fn, reps) * 1e3,
                "bound_us": bound * 1e3, "bound_by": by}
    return out


def ham_phase(dev, smoke=False):
    """The Hamiltonian VdP sensitivities through K1/K2 against the plain
    pivot-free LU."""
    name = f"ham VdP sensitivities M={M} f64 mu=1e3 Radau9 N=5 IND"
    parts, clock = {}, [time.perf_counter()]

    def lap(part):
        torch.cuda.synchronize()
        now = time.perf_counter()
        parts[part] = now - clock[0]
        clock[0] = now

    # builds K1/K2 if nothing has yet, and pays torch.func's first use
    ham_solve(ham_y0(64, dev), True, tf=1e-3)
    lap("warm_up")
    turns = {True: [], False: []}
    outs, launches, syncs = {}, None, {}
    order = (True, False) if smoke else (True, False, False, True, True,
                                         False)
    y0 = ham_y0(M, dev)
    for k in order:
        torch.cuda.synchronize()
        mol._reset_kernel_launches()
        out = []
        turns[k].append(kb.events_ms(lambda: out.append(ham_solve(y0, k)), 1)
                        / 1e3)
        syncs[k] = solve_radau.host_syncs
        if k and launches is None:
            launches = mol._kernel_launches()
        elif not k and any(mol._kernel_launches().values()):
            raise HamCheckFailed(f"{name}: the plain route launched a "
                                 f"kernel: {mol._kernel_launches()}")
        outs[k] = out[0]
    lap("turns")
    (yj_k, sol_k), (yj_p, sol_p) = outs[True], outs[False]
    if launches["K1"] <= 0 or launches["K2"] <= 0:
        raise HamCheckFailed(f"{name}: kernel_lu=True did not launch K1 and "
                             f"K2: {launches}")
    if not torch.equal(sol_k.status, sol_p.status):
        raise HamCheckFailed(f"{name}: status differs between the routes")
    for k in STATS:
        if not torch.equal(sol_k.stats[k], sol_p.stats[k]):
            raise HamCheckFailed(f"{name}: counter {k} differs between the "
                                 "routes")
    for what, a, b in (("y", yj_k.r, yj_p.r), ("Jet.d", yj_k.d, yj_p.d)):
        if not torch.equal(a, b):
            raise HamCheckFailed(f"{name}: {what} differs between the routes"
                                 f" (max {float((a - b).abs().max()):.3e}), "
                                 "not equal to the bit")
    lanes = _eight(M)
    success = float((sol_k.status == 1).double().mean())
    y0_cpu = ham_y0(M, torch.device("cpu"), lanes)
    _, sol_cpu = ham_solve(y0_cpu, True)
    succ8 = float((sol_k.status[torch.as_tensor(lanes, device=dev)] == 1)
                  .double().mean())
    succ8_cpu = float((sol_cpu.status == 1).double().mean())
    if succ8 != succ8_cpu:
        raise HamCheckFailed(f"{name}: success of 8 lanes {succ8} on the "
                             f"card, {succ8_cpu} on the CPU")
    lap("cpu_8_lanes")
    f, _ = ham_system()
    f_end = f(sol_k.t, yj_k.r, {"mu": MU})
    tf_err = float((yj_k.d[-1] - f_end).abs().max() / f_end.abs().max())
    if not tf_err <= 1e-6:
        raise HamCheckFailed(f"{name}: tf column vs f(T, y(T)) {tf_err:.3e} "
                             "> 1e-6")
    fd = fd_worst(yj_k, dev, [0, M // 2, M - 1])
    lap("central_differences")
    if not fd <= FD_BOUND:
        raise HamCheckFailed(f"{name}: dy(T)/dy0 vs central differences "
                             f"{fd:.3e} > {FD_BOUND:g}")
    worst = scipy_worst(yj_k.r.cpu().numpy(), ham_y0(M, "cpu").numpy(),
                        lanes)
    lap("scipy")
    kdev = kernel_device(dev)
    lap("kernels_alone")
    rec = {"launches": launches, "host_syncs": syncs[True],
           "host_syncs_plain": syncs[False], "success_fraction": success,
           "success_8_lanes": succ8, "success_8_lanes_cpu": succ8_cpu,
           "stats_max": {k: int(sol_k.stats[k].max()) for k in STATS},
           "tf_column": tf_err, "fd": fd, "scipy_worst": worst,
           "kernels_alone": kdev,
           "turns": {"kernel": turns[True], "plain": turns[False]},
           "s_per_solve_kernel": statistics.median(turns[True]),
           "s_per_solve_plain": statistics.median(turns[False]),
           "seconds": parts}
    extra = ""
    if not smoke:
        for k in (True, False):
            prof = mol.profile_solve(lambda wrap, _k=k: ham_solve(y0, _k))
            rec[f"profile_{'kernel' if k else 'plain'}"] = prof
        pk, pp = rec["profile_kernel"], rec["profile_plain"]
        rec["busy_share_kernel"] = pk["busy_ms"] / pk["profiled_wall_ms"]
        extra = (f" | one solve under torch.profiler: launches kernel_lu "
                 f"{pk['launches']}, plain {pp['launches']}; device busy "
                 f"{pk['busy_ms']:.2f} / {pp['busy_ms']:.2f} ms, busy share "
                 f"{rec['busy_share_kernel']:.3f} (kernel route)")
        lap("profile")
    st = rec["stats_max"]
    kd = ", ".join(
        f"{k} device "
        + ("not recorded" if v["device_us"] is None
           else f"{v['device_us']:.3f} us")
        + f", events {v['events_us']:.3f} us (bound {v['bound_us']:.3f} by "
        f"{v['bound_by']})" for k, v in kdev.items())
    print(f"[{name}] success fraction {success}, 8 lanes {succ8} (CPU "
          f"{succ8_cpu}); status, the seven counters, y and Jet.d equal to "
          f"the bit between the routes (max nsteps {st['nsteps']}, naccept "
          f"{st['naccept']}, nlu {st['nlu']}, nfev {st['nfev']}) | "
          f"kernel_lu launches K1 {launches['K1']}, K2 {launches['K2']} (K3 "
          f"{launches['K3']}, K4 {launches['K4']}) | host syncs "
          f"{syncs[True]} | s/solve kernel_lu {turns[True]}, plain LU "
          f"{turns[False]} (turns {'K P' if smoke else 'K P P K K P'}; CUDA "
          f"events) | tf column vs f(T, y(T)) {tf_err:.3e} (bound 1e-6) | "
          f"dy(T)/dy0 of lanes 0, M/2, M-1 vs central differences {fd:.3e} "
          f"(bound {FD_BOUND:g}) | 8 lanes vs scipy Radau worst error / "
          f"bound {worst:.3e} | alone at M={M}: {kd}" + extra
          + " | seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in
                                      parts.items()), flush=True)
    return rec


# ---- (b) the transform path ------------------------------------------------

def harmonic_inputs(m, dev):
    """(y0 Jet [m, 2], omega Jet [m]) with N = 3 seeds (dq0, dv0, domega);
    q0, v0 ~ N(0, 1), omega ~ U(0.5, 2) from numpy's default_rng(20)."""
    rng = np.random.default_rng(20)
    y0 = torch.from_numpy(rng.standard_normal((M, 2)))[:m].to(dev)
    om = torch.from_numpy(rng.uniform(0.5, 2.0, M))[:m].to(dev)
    seeds = torch.zeros((3, m, 2), dtype=torch.float64, device=dev)
    seeds[0, :, 0] = 1.0
    seeds[1, :, 1] = 1.0
    om_d = torch.zeros((3, m), dtype=torch.float64, device=dev)
    om_d[2] = 1.0
    return Jet(y0, seeds), Jet(om, om_d)


def transform_solve(y0, om):
    return dual_solve_ivp(harmonic_rhs, (0.0, T_HARMONIC), y0,
                          method="dopri5", args=om, rtol=1e-10, atol=1e-12)


def harmonic_closed_form(y0, om, t):
    """(y(t) [m, 2], d [3, m, 2]) of q' = v, v' = -omega^2 q."""
    q0, v0, w = y0[:, 0], y0[:, 1], om
    c, s = torch.cos(w * t), torch.sin(w * t)
    y = torch.stack([q0 * c + v0 * s / w, -q0 * w * s + v0 * c], -1)
    dq0 = torch.stack([c, -w * s], -1)
    dv0 = torch.stack([s / w, c], -1)
    dw = torch.stack([-q0 * t * s + v0 * (t * c / w - s / (w * w)),
                      -q0 * (s + w * t * c) - v0 * t * s], -1)
    return y, torch.stack([dq0, dv0, dw])


def transform_phase(dev, ham_rec=None, smoke=False):
    """dual_solve_ivp's transform path on the harmonic lanes."""
    name = f"transform dopri5 M={M} f64 harmonic N=3 Jet omega + Jet y0"
    y0, om = harmonic_inputs(M, dev)
    mol._reset_kernel_launches()
    out = []
    sec = kb.events_ms(lambda: out.append(transform_solve(y0, om)), 1) / 1e3
    launches = mol._kernel_launches()
    yj, tj, sol = out[0]
    if not bool((sol.status == 1).all()):
        raise HamCheckFailed(f"{name}: not SUCCESS on every lane")
    y_ref, d_ref = harmonic_closed_form(y0.r, om.r, T_HARMONIC)
    err_y = float((yj.r - y_ref).abs().max())
    err_d = float((yj.d - d_ref).abs().max())
    if not max(err_y, err_d) <= CLOSED_FORM_BOUND:
        raise HamCheckFailed(f"{name}: vs the closed form y {err_y:.3e}, d "
                             f"{err_d:.3e} > {CLOSED_FORM_BOUND:g}")
    y0_c, om_c = harmonic_inputs(4, torch.device("cpu"))
    yj_c, _, _ = transform_solve(y0_c, om_c)
    err_cpu = max(float((a[:4].cpu() - b).abs().max())
                  for a, b in ((yj.r, yj_c.r), (yj.d[:, :4], yj_c.d)))
    if not err_cpu <= 1e-10:
        raise HamCheckFailed(f"{name}: 4 lanes vs the CPU {err_cpu:.3e} > "
                             "1e-10")
    turns = [sec]
    extra = ""
    if not smoke:
        # the checked call was the warm-up: the median of three more
        turns = [kb.events_ms(lambda: transform_solve(y0, om), 1) / 1e3
                 for _ in range(3)]
        sec = statistics.median(turns)
        prof = mol.profile_solve(lambda wrap: transform_solve(y0, om))
        extra = (f" | one call under torch.profiler: {prof['launches']} "
                 f"launches, device busy {prof['busy_ms']:.2f} ms")
    rec = {"s_per_call": sec, "turns": turns, "launches": launches,
           "naccept_max": int(sol.stats["naccept"].max()),
           "closed_form": {"y": err_y, "d": err_d}, "cpu": err_cpu}
    if not smoke:
        rec["profile"] = prof
    ratio = ""
    if ham_rec is not None:
        per_dir = (sec / 3) / (ham_rec["s_per_solve_kernel"] / 5)
        rec["per_direction_over_ham"] = per_dir
        ratio = (f" | per direction {per_dir:.3f}x the ham phase's kernel "
                 "route")
    print(f"[{name}] every lane SUCCESS (max naccept {rec['naccept_max']}) "
          f"| s per call {turns} (CUDA events) | K1-K4 launches "
          f"{launches} | vs the closed form: y {err_y:.3e}, d {err_d:.3e} "
          f"(bound {CLOSED_FORM_BOUND:g}) | 4 lanes vs the CPU "
          f"{err_cpu:.3e} (bound 1e-10)" + ratio + extra, flush=True)
    return rec


# ---- (c) forward mode through every method ---------------------------------

def _constant_rhs(t, y, a):
    return torch.stack([a, 2.0 * a], dim=-1).broadcast_to(y.shape)


def f1_tangent(method, dev):
    """The tangent of y(T) in a for y' = (a, 2a): (2, 4) exactly."""
    y0 = torch.tensor([[0.1, 0.2]], dtype=torch.float64, device=dev)

    def final(a):
        return solve_ivp(_constant_rhs, (0.0, 2.0), y0, method=method,
                         args=a, options=Options(rtol=1e-7, atol=1e-10)).y

    a = torch.tensor(0.3, dtype=torch.float64, device=dev)
    return torch.func.jvp(final, (a,), (torch.ones_like(a),))[1]


def f1_phase(dev):
    want = torch.tensor([[2.0, 4.0]], dtype=torch.float64)
    rec = {}
    for method in METHODS:
        t0 = time.perf_counter()
        tan = f1_tangent(method, dev).cpu()
        rec[method] = {"tangent": tan.ravel().tolist(),
                       "seconds": time.perf_counter() - t0}
        if not torch.allclose(tan, want, rtol=1e-6, atol=1e-8):
            raise HamCheckFailed(f"f1 {method}: tangent {tan.tolist()} != "
                                 "(2, 4)")
    print("[f1 forward mode on the card] torch.func.jvp of y(T) for "
          "y' = (a, 2a), CUDA tensors: (2, 4) within rtol 1e-6, atol 1e-8 "
          "for " + ", ".join(f"{k} ({v['seconds']:.2f} s)"
                             for k, v in rec.items()), flush=True)
    return rec


# ---- (d) the host cost of safe_sqrt on the headline -------------------------

def headline_solve(dev):
    y0 = torch.tensor([[2.0, 0.0]], dtype=torch.float64,
                      device=dev).repeat(M, 1)
    mus = torch.full((M,), MU, dtype=torch.float64, device=dev)
    seeds = torch.zeros((2, M, 2), dtype=torch.float64, device=dev)
    seeds[0, :, 0] = 1.0
    seeds[1, :, 1] = 1.0
    return solve_radau(vdp_rhs, 0.0, 1.0, y0, args=mus,
                       options=Options(rtol=1e-6, atol=1e-9, pivoting=False,
                                       min_stages=5, max_stages=5,
                                       kernel_lu=True),
                       jac=vdp_jac, tangents=seeds)


def headline_phase(dev):
    """safe_sqrt (the autograd.Function) against torch.sqrt in its place."""
    name = f"headline M={M} Radau9 K=2 IND kernel_lu: safe_sqrt vs sqrt"
    function = cm.safe_sqrt
    headline_solve(dev)
    turns = {"function": [], "sqrt": []}
    sols, launches, syncs = {}, {}, {}
    try:
        for which in HEADLINE_TURNS:
            cm.safe_sqrt = function if which == "function" else torch.sqrt
            torch.cuda.synchronize()
            mol._reset_kernel_launches()
            out = []
            turns[which].append(kb.events_ms(
                lambda: out.append(headline_solve(dev)), 1) / 1e3)
            sols[which], syncs[which] = out[0], solve_radau.host_syncs
            launches[which] = mol._kernel_launches()
    finally:
        cm.safe_sqrt = function
    a, b = sols["function"], sols["sqrt"]
    if not (all(torch.equal(getattr(a, k), getattr(b, k))
                for k in ("t", "y", "sens", "status"))
            and all(torch.equal(a.stats[k], b.stats[k]) for k in STATS)):
        raise HamCheckFailed(f"{name}: the two solves differ")
    if launches["function"] != launches["sqrt"]:
        raise HamCheckFailed(f"{name}: launches differ {launches}")
    med = {k: statistics.median(v) for k, v in turns.items()}
    rec = {"turns": turns, "median_s": med, "launches": launches["function"],
           "host_syncs": syncs,
           "function_over_sqrt": med["function"] / med["sqrt"]}
    print(f"[{name}] s/solve function {turns['function']}, sqrt "
          f"{turns['sqrt']} (turns F S S F x5; CUDA events): medians "
          f"function / sqrt {rec['function_over_sqrt']:.4f} | K1/K2 "
          f"{launches['function']['K1']}/{launches['function']['K2']} both, "
          f"host syncs {syncs['function']} | results equal to the bit",
          flush=True)
    return rec


PHASES = ("ham", "transform", "f1", "headline")


def run(dev, only=PHASES, smoke=False):
    """Run the named phases; returns their records with the seconds each
    phase took under ``"seconds"``."""
    report, seconds = {}, {}

    def timed(phase, fn, *a, **kw):
        t0 = time.perf_counter()
        report[phase] = fn(dev, *a, **kw)
        torch.cuda.synchronize()
        seconds[phase] = time.perf_counter() - t0

    if "ham" in only:
        timed("ham", ham_phase, smoke=smoke)
    if "transform" in only:
        timed("transform", transform_phase, ham_rec=report.get("ham"),
              smoke=smoke)
    if "f1" in only:
        timed("f1", f1_phase)
    if "headline" in only and not smoke:
        timed("headline", headline_phase)
    report["seconds"] = seconds
    print("[ham phase seconds] " + ", ".join(f"{k} {v:.1f}"
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
        print("ham: no CUDA device", file=sys.stderr)
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
