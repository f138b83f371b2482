"""Drive, check and measure the eleven examples that ``bench.infra`` does not
run (``janus_tpu_torch/examples/``) on a card.

Phase 23 of ``chip_smoke.py`` (``run(dev, smoke=True)``), and a probe of its
own, run from the root of a checkout on a machine with a CUDA card:

    python3 -m janus_tpu_torch.bench.examples [--only PART ...] [--smoke]
        [--json PATH]

Everything in float64, each example through the entry point a user calls
(its ``main``, or the functions ``main`` calls), with its own asserts.
Parts (``PARTS``), each raising ``ExamplesCheckFailed`` when its check
fails; ``smoke`` (chip_smoke's phase 23) takes the cut after the arrow,
each measured on the card (PERF.md §5), where the whole example takes
tens of seconds to hours:
- ``poincare``: ``events_poincare.solve`` at 65,536 lanes (bench.py's lane
  count; μ = 10^linspace(0, 1.5), the terminal falling x1 = 0 crossing,
  horizon 50, Radau5, rtol 1e-8, atol 1e-10) through K1/K2
  (``kernel_lu=True``) and through the plain pivot-free LU in alternating
  turns (K P P K; smoke → K P; the options built here, the example's
  tolerances with ``pivoting=False``): every lane crosses, crossing times grow
  with μ, y, t, status, event_t and event_y equal to the bit between the
  routes; the K1/K2 launches of a kernel-route solve
  (``launches_poincare``), s per solve, the busy share of one kernel-route
  solve (torch.profiler), and ``events_poincare.main`` at the reference's
  4,096 lanes (its options off the TPU: the pivoted stage LU) for the
  readings it prints (smoke → neither).
- ``fit_mu``: ``fit_mu_gauss_newton.fit`` at 65,536 lanes (μ_true =
  10^U(0.8, 2.2) and the 1e-4 noise from np.random.RandomState(0), three
  horizons, Radau5 at rtol 1e-7, atol 1e-10, one IND sweep of
  ``args_tangents`` a horizon and step; the probe runs ``fit``'s loop over
  ``gn_step`` itself, to check each sweep) through K1/K2 and the plain
  pivot-free LU (K P): μ̂ and the residual equal to the bit between the
  routes, every IND sweep's y and sens finite
  (``launches_fit_mu``); the reference's 30 Gauss–Newton steps and its
  bounds (median relative error < 5e-3, 90th percentile < 5e-2), the busy
  share of one step's three sweeps, then ``fit_mu_gauss_newton.main`` at
  the reference's 256 lanes (smoke → 1 step, ``SMOKE_GN``, all 65,536
  lanes, no bounds: they need the 30 steps).
- ``reverse_time``: ``reverse_time.main`` (round trip below 1e-7; smoke →
  the span [0, 0.5] where the reference's is [0, 6]).
- ``hamiltonian``: ``hamiltonian_vdp.main`` (every lane SUCCESS, d of
  shape (5, 8, 4), the final-time column equals f(T, y(T)); y(T) and d
  within 1e-9 of the CPU's; smoke → the reference's TPU tolerances rtol
  1e-5, atol 1e-8, in float64).
- ``bratu``: ``bratu_psitc.main`` whole (Ψtc converges on all five λ,
  peaks grow, Newton–Krylov agrees within 1e-6).
- ``dubins``: ``dubins_pmp.main`` (the ε ladder by single shooting with the
  AD Jacobian, the plain route: the kernels have no derivative rule; the
  final position on the target within 1e-6; smoke → the first rung's
  residual at the reference's start p0 = (0.1, 0.1, 0.1), one Radau
  solve, within 1e-9 of the CPU's).
- ``dubins_jac`` (not part of the smoke): where ``dubins``'s time goes:
  one residual and one AD Jacobian on the card, each timed, with the ops
  it dispatches (counted on the CPU, the same code) and so the host time
  per op; the Jacobian within 1e-7 of the CPU's.
- ``pmp_energy``: ``vdp_pmp_energy.main`` (μ = 0 and 1 converged, the
  homotopy reaches λ = 1 at μ = 10, the multiple-shooting residual there
  below 1e-6; smoke → the single-shooting residual at μ = 0 from p0 = 0
  and the multiple-shooting residual at μ = 1, no Newton, each within
  1e-9 of the CPU's).
- ``event_time``: ``event_time_training.main`` (60 gradient steps, which
  do not converge, as the reference's: θ stays more than 1 from the
  truth; smoke → 3 steps), the loss and θ within 1e-8 (relative) of the
  CPU's.
- ``neural_ode``: ``neural_ode_dopri.main`` at the reference test's 200
  Adam steps (loss falls 20×, held-out MSE < 0.5; smoke → 5 steps, the
  loss falls).
- ``newton_cg``: ``newton_cg_hvp.main`` at the reference test's
  newton_iters=4 through K1/K2 (``launches_newton_cg``: the forward solves
  inside ``radau_adjoint`` and ``radau_hvp``) and through the plain
  pivot-free LU (K P): both losses equal to the bit, Newton-CG below
  gradient descent at the same solve budget (smoke → one value-and-gradient
  and one H·v through each route, equal to the bit, and within 1e-8
  (relative) of the CPU's, at the reference's TPU tolerances rtol 1e-5,
  atol 1e-8: one H·v at rtol 1e-9 takes ~50 s).
- ``min_time``: ``vdp_min_time.main`` (8 umax lanes, the six-rung ε
  ladder; tF falls with umax, max |H| along the trajectories; smoke →
  ``newton_free_tf``'s first evaluation on four umax lanes from tF = 0.3,
  the residual F(z0) and its exact Jacobian from the IND tangents (one
  solve; a whole Levenberg–Marquardt iteration takes four): finite, F, the
  Jacobian and the tangents within 1e-9 of the CPU's).

Each CPU result named above is the port's own, on the same inputs, at the
CPU tests' tolerances (those tests hold it to the reference's); it is
computed in a worker process of its own while the card works
(``cpu_side.Later``).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from janus_tpu_torch.bench import mol
from janus_tpu_torch.bench.cpu_side import Later

M = 65_536
SMOKE_GN = 1
PARTS = ("poincare", "fit_mu", "reverse_time", "hamiltonian", "bratu",
         "dubins", "dubins_jac", "pmp_energy", "event_time", "neural_ode",
         "newton_cg", "min_time")
NOT_IN_SMOKE = ("dubins_jac",)


class ExamplesCheckFailed(RuntimeError):
    """A part's check did not hold."""


def _sync():
    torch.cuda.synchronize()


def _timed(fn):
    """(fn(), seconds by the host clock after a synchronize)."""
    _sync()
    t0 = time.perf_counter()
    out = fn()
    _sync()
    return out, time.perf_counter() - t0


def _routes(smoke, run, name):
    """Run ``run(kernel_lu)`` in alternating turns (K P, or K P P K);
    returns ({route: the first output}, {route: [seconds]}, the kernel
    route's K1/K2 launches in its first turn). The plain route must launch
    no kernel."""
    order = (True, False) if smoke else (True, False, False, True)
    outs, secs, launches = {}, {True: [], False: []}, None
    for k in order:
        mol._reset_kernel_launches()
        out, sec = _timed(lambda: run(k))
        secs[k].append(sec)
        outs.setdefault(k, out)
        got = mol._kernel_launches()
        if k and launches is None:
            launches = got
        elif not k and any(got.values()):
            raise ExamplesCheckFailed(f"{name}: the plain route launched a "
                                      f"kernel: {got}")
    if launches["K1"] <= 0 or launches["K2"] <= 0:
        raise ExamplesCheckFailed(f"{name}: kernel_lu=True did not launch "
                                  f"K1 and K2: {launches}")
    return outs, secs, launches


def _equal(name, pairs):
    for what, a, b in pairs:
        if not torch.equal(a, b):
            raise ExamplesCheckFailed(f"{name}: {what} differs between the "
                                      "routes, not equal to the bit")


def _busy(fn):
    prof = mol.profile_solve(lambda wrap: fn())
    return {"launches_profiled": prof["launches"], "busy_ms": prof["busy_ms"],
            "profiled_wall_ms": prof["profiled_wall_ms"],
            "busy_share": prof["busy_ms"] / prof["profiled_wall_ms"]}


def _fmt_busy(b):
    if b is None:
        return "busy share not profiled (smoke)"
    return (f"busy {b['busy_ms']:.1f} of {b['profiled_wall_ms']:.1f} ms = "
            f"{b['busy_share']:.4f} ({b['launches_profiled']} launches, "
            "torch.profiler)")


# ---- (a) the two sweeps at full width ---------------------------------------

def poincare_part(dev, smoke=False, cpu=None):
    from janus_tpu_torch.examples import events_poincare as ep
    from janus_tpu_torch.solve import EVENT_TERMINATED, Options

    def pivot_free(kernel_lu):
        """The example's tolerances on the pivot-free stage LU: through
        K1/K2, or on the plain route."""
        return Options(rtol=ep.RTOL, atol=ep.ATOL, pivoting=False,
                       kernel_lu=kernel_lu)

    name = (f"events_poincare M={M} f64 mu=10^linspace(0,1.5) Radau5 rtol "
            "1e-8")
    outs, secs, launches = _routes(
        smoke, lambda k: ep.solve(M, dev, pivot_free(k))[1], name)
    sk, sp = outs[True], outs[False]
    if not bool((sk.status == EVENT_TERMINATED).all()):
        raise ExamplesCheckFailed(
            f"{name}: {int((sk.status != EVENT_TERMINATED).sum())} lanes did "
            "not cross")
    if not float(sk.event_t[-1]) > float(sk.event_t[0]):
        raise ExamplesCheckFailed(f"{name}: crossing times do not grow with "
                                  "mu")
    _equal(name, [(w, getattr(sk, w), getattr(sp, w))
                  for w in ("y", "t", "status", "event_t", "event_y")])
    busy = None if smoke else _busy(lambda: ep.solve(M, dev,
                                                     pivot_free(True)))
    steps = sk.stats["nsteps"]
    print(f"[{name}] every lane crossed x1=0 falling (t* {float(sk.event_t[0]):.6f}"
          f" .. {float(sk.event_t[-1]):.6f}), y, t, status, event_t, event_y "
          f"equal to the bit between the routes (steps {int(steps.min())}.."
          f"{int(steps.max())}) | kernel_lu launches K1 {launches['K1']}, K2 "
          f"{launches['K2']} | s per solve kernel_lu {secs[True]}, plain LU "
          f"{secs[False]} (host clock, synchronized) | {_fmt_busy(busy)}",
          flush=True)
    rec = {"launches": launches, "seconds_kernel": secs[True],
           "seconds_plain": secs[False], "nsteps_max": int(steps.max()),
           "busy": busy}
    if not smoke:
        _, rec["seconds_reference_width"] = _timed(lambda: ep.main(4096,
                                                                   dev))
        print(f"[events_poincare.main M=4096 (the reference's width and "
              f"options)] {rec['seconds_reference_width']:.2f} s",
              flush=True)
    return rec


def fit_mu_part(dev, smoke=False, cpu=None):
    from janus_tpu_torch.examples import fit_mu_gauss_newton as fm

    iters = SMOKE_GN if smoke else 30
    name = (f"fit_mu_gauss_newton M={M} f64 Radau5 rtol 1e-7, {iters} "
            "Gauss-Newton steps")
    sweeps = {"n": 0}

    def fit(kernel_lu):
        """fm.fit, with every IND sweep checked finite."""
        mu_true, data = fm.problem(M, dev, kernel_lu)
        mu_hat, rn, opts = fm.mu_start(M, dev), None, fm.options(kernel_lu)
        for _ in range(iters):
            mu_hat, rn, sols = fm.gn_step(mu_hat, data, opts)
            for s in sols:
                if not (bool(torch.isfinite(s.y).all())
                        and bool(torch.isfinite(s.sens).all())):
                    raise ExamplesCheckFailed(f"{name}: an IND sweep is not "
                                              "finite")
            sweeps["n"] += len(sols)
        return mu_true, mu_hat, rn

    outs, secs, launches = _routes(smoke, fit, name)
    (mu_true, mk, rk), (_, mp, rp) = outs[True], outs[False]
    _equal(name, [("mu_hat", mk, mp), ("residual", rk, rp)])
    rel = ((mk - mu_true).abs() / mu_true).cpu().numpy()
    med, p90 = float(np.median(rel)), float(np.percentile(rel, 90))
    if not smoke and not (med < 5e-3 and p90 < 5e-2):
        raise ExamplesCheckFailed(f"{name}: median rel error {med:.3e}, 90th "
                                  f"pct {p90:.3e} (bounds 5e-3, 5e-2)")
    busy = None
    if not smoke:
        data = fm.problem(M, dev, True)[1]
        busy = _busy(lambda: fm.gn_step(fm.mu_start(M, dev), data,
                                        fm.options(True)))
    print(f"[{name}] mu_hat and the residual equal to the bit between the "
          f"routes, every IND sweep finite ({sweeps['n']} sweeps) | median "
          f"rel error {med:.3e}, 90th pct {p90:.3e}"
          f"{' (the bounds need the 30 steps)' if smoke else ''} | kernel_lu "
          f"launches K1 {launches['K1']}, K2 {launches['K2']} | s per fit "
          f"(the data's three solves and the steps) kernel_lu {secs[True]}, "
          f"plain LU {secs[False]} | one step's sweeps: {_fmt_busy(busy)}",
          flush=True)
    rec = {"launches": launches, "seconds_kernel": secs[True],
           "seconds_plain": secs[False], "iters": iters,
           "median_rel_err": med, "p90_rel_err": p90, "busy": busy}
    if not smoke:
        _, rec["seconds_reference_width"] = _timed(lambda: fm.main(256, dev))
        print(f"[fit_mu_gauss_newton.main M=256 (the reference's width)] "
              f"{rec['seconds_reference_width']:.2f} s", flush=True)
    return rec


# ---- (b) every other example ------------------------------------------------
# Where a part's cut holds only a residual, a gradient or a few iterates, the
# card's numbers are held to the port's own CPU result on the same inputs, at
# the CPU tests' tolerances (tests/test_torch_examples_*.py hold the CPU
# result to the reference's): the CPU side runs in a worker process while
# the card works (``cpu_side.Later``). The functions that the worker calls
# take the device, so that both sides run the same code.

def _close(name, got, want, atol=0.0, rtol=0.0):
    """max |got - want| over arrays or tensors; raises past atol + rtol·|want|."""
    got = np.asarray(torch.as_tensor(got).detach().cpu())
    want = np.asarray(torch.as_tensor(want).detach().cpu())
    err = float(np.max(np.abs(got - want)))
    if not np.allclose(got, want, rtol=rtol, atol=atol):
        raise ExamplesCheckFailed(f"{name}: the card vs the CPU {err:.3e} "
                                  f"(atol {atol:g}, rtol {rtol:g})")
    return err


def reverse_time_part(dev, smoke=False, cpu=None):
    from janus_tpu_torch.examples import reverse_time

    t_final = 0.5 if smoke else 6.0
    (err, err8), sec = _timed(lambda: reverse_time.main(dev, t_final))
    print(f"[reverse_time on the card, T={t_final}] round trip {err:.3e} "
          f"(< 1e-7), dopri853 backward {err8:.3e} | {sec:.2f} s", flush=True)
    return {"t_final": t_final, "roundtrip": err, "dopri853": err8,
            "seconds": sec}


def _ham_tol(smoke):
    from janus_tpu_torch.examples import hamiltonian_vdp as hv
    return (1e-5, 1e-8) if smoke else (hv.RTOL, hv.ATOL)


def _ham_cpu(smoke):
    from janus_tpu_torch.examples import hamiltonian_vdp as hv
    yj, _ = hv.sensitivities(hv.inputs(8, "cpu"), 100.0, *_ham_tol(smoke))
    return yj.r, yj.d


def hamiltonian_part(dev, smoke=False, cpu=None):
    from janus_tpu_torch.examples import hamiltonian_vdp as hv

    tol = _ham_tol(smoke)
    (sol, yj, ok), sec = _timed(lambda: hv.main(dev, *tol))
    if not ok or not bool(sol.success.all()) \
            or tuple(yj.d.shape) != (5, 8, 4):
        raise ExamplesCheckFailed(
            f"hamiltonian_vdp: check {ok}, status {sol.status.tolist()}, d "
            f"{tuple(yj.d.shape)}")
    r_cpu, d_cpu = cpu.result()
    name = "hamiltonian_vdp y(T) and d"
    err = max(_close(name, yj.r, r_cpu, atol=1e-9),
              _close(name, yj.d, d_cpu, atol=1e-9))
    print(f"[hamiltonian_vdp on the card, rtol {tol[0]}, atol {tol[1]}] every"
          f" lane SUCCESS, d (5, 8, 4), d y(T)/dT == f(T, y) | y(T) and d vs "
          f"the CPU {err:.3e} (bound 1e-9) | {sec:.2f} s", flush=True)
    return {"rtol": tol[0], "vs_cpu": err, "seconds": sec}


def bratu_part(dev, smoke=False, cpu=None):
    from janus_tpu_torch.examples import bratu_psitc

    (x, it, nk_it, agree), sec = _timed(lambda: bratu_psitc.main(dev))
    print(f"[bratu_psitc on the card] Ψtc iterations {it.tolist()}, "
          f"Newton-Krylov {nk_it.tolist()}, agree {agree:.2e} | {sec:.2f} s",
          flush=True)
    return {"psitc_iters": it.tolist(), "nk_iters": nk_it.tolist(),
            "agree": agree, "seconds": sec}


def _dubins_p0(dev):
    """The reference's start p0 = (0.1, 0.1, 0.1)."""
    return torch.tensor([[0.1, 0.1, 0.1]], dtype=torch.float64, device=dev)


def _dubins_residual(dev):
    """The first ε rung's shooting residual at the reference's start."""
    from janus_tpu_torch.examples import dubins_pmp
    return dubins_pmp.residual(_dubins_p0(dev), dubins_pmp.EPS_LADDER[0])


def _dubins_jacobian(dev):
    """The single-shooting Newton's AD Jacobian there (torch.func.vmap over
    jvp of the whole Radau solve, three directions)."""
    from janus_tpu_torch.control.newton import fd_or_ad_jacobian
    from janus_tpu_torch.examples import dubins_pmp
    return fd_or_ad_jacobian(
        lambda p: dubins_pmp.residual(p, dubins_pmp.EPS_LADDER[0]),
        _dubins_p0(dev))


def _ops(fn):
    """(fn(), the aten ops it dispatched, views included)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        out = fn()
    return out, Count.n


def _dubins_counted():
    """The residual and the AD Jacobian on the CPU, each with its op count
    and the Radau solve's host syncs."""
    from janus_tpu_torch.solve.radau import solve_radau
    out = {}
    for what, fn in (("residual", _dubins_residual),
                     ("jacobian", _dubins_jacobian)):
        val, n = _ops(lambda: fn("cpu"))
        out[what] = (val, n, solve_radau.host_syncs)
    return out


def dubins_part(dev, smoke=False, cpu=None):
    from janus_tpu_torch.examples import dubins_pmp

    if smoke:
        res, sec = _timed(lambda: _dubins_residual(dev))
        err = _close("dubins_pmp residual", res, cpu.result(), atol=1e-9)
        print(f"[dubins_pmp on the card, the first rung's residual at p0 = "
              f"(0.1, 0.1, 0.1)] {res[0].tolist()} | vs the CPU {err:.3e} "
              f"(bound 1e-9) | {sec:.2f} s", flush=True)
        return {"residual": res[0].tolist(), "vs_cpu": err, "seconds": sec}
    (p0, final), sec = _timed(lambda: dubins_pmp.main(dev))
    miss = float((final - torch.tensor(dubins_pmp.TARGET, dtype=final.dtype,
                                       device=final.device)).abs().max())
    if not miss < 1e-6:
        raise ExamplesCheckFailed(f"dubins_pmp: final position misses the "
                                  f"target by {miss:.3e}")
    print(f"[dubins_pmp on the card] p0 {p0[0].tolist()}, the final position "
          f"within {miss:.2e} of the target | {sec:.2f} s", flush=True)
    return {"p0": p0[0].tolist(), "miss": miss, "seconds": sec}


def dubins_jac_part(dev, smoke=False, cpu=None):
    """Where dubins_pmp's time goes: one residual and one AD Jacobian on the
    card (host clock, synchronized; the solve's host syncs), the ops each
    dispatches (counted on the CPU, the same code), so the host time per op
    on the card; the Jacobian against the CPU's."""
    from janus_tpu_torch.solve.radau import solve_radau

    rec = {}
    for what, fn in (("residual", _dubins_residual),
                     ("jacobian", _dubins_jacobian)):
        val, sec = _timed(lambda: fn(dev))
        rec[what] = {"seconds": sec, "host_syncs": solve_radau.host_syncs,
                     "value": val}
    ref = cpu.result()
    for what in rec:
        want, n_ops, syncs_cpu = ref[what]
        r = rec[what]
        r.update(ops=n_ops, host_syncs_cpu=syncs_cpu,
                 us_per_op=r["seconds"] / n_ops * 1e6,
                 vs_cpu=float((r.pop("value").cpu() - want).abs().max()))
    print("[dubins_pmp cost on the card, the first rung at p0 = (0.1, 0.1, "
          "0.1)] " + " | ".join(
              f"one {w}: {r['seconds']:.2f} s, {r['ops']} ops dispatched "
              f"(counted on the CPU), {r['us_per_op']:.2f} us of host per op,"
              f" host syncs {r['host_syncs']} (CPU {r['host_syncs_cpu']}), "
              f"vs the CPU {r['vs_cpu']:.3e}" for w, r in rec.items()),
          flush=True)
    if not rec["jacobian"]["vs_cpu"] <= 1e-7:
        raise ExamplesCheckFailed("dubins_pmp: the AD Jacobian on the card vs "
                                  f"the CPU {rec['jacobian']['vs_cpu']:.3e}")
    return rec


def _pmp_residuals(dev):
    """The single-shooting residual at μ = 0 from p0 = 0 and the
    multiple-shooting residual at μ = 1 on a z of segment starts."""
    from janus_tpu_torch.examples import vdp_pmp_energy as pe
    p0 = torch.zeros((1, 2), dtype=torch.float64, device=dev)
    z = torch.tensor([[1.0, 0.5, 0.1, -0.2] * pe.N_SEG],
                     dtype=torch.float64, device=dev)
    return pe.shooting_residual(p0, 0.0), pe.multishoot_residual(1.0)(z)


def pmp_energy_part(dev, smoke=False, cpu=None):
    from janus_tpu_torch.examples import vdp_pmp_energy as pe

    if smoke:
        (r1, r2), sec = _timed(lambda: _pmp_residuals(dev))
        w1, w2 = cpu.result()
        name = "vdp_pmp_energy residuals"
        err = max(_close(name, r1, w1, atol=1e-9),
                  _close(name, r2, w2, atol=1e-9))
        print(f"[vdp_pmp_energy on the card, the single-shooting residual at "
              f"mu=0 from p0=0 and the multiple-shooting residual at mu=1] "
              f"{r1[0].tolist()}, |{float(torch.linalg.vector_norm(r2)):.4e}|"
              f" | vs the CPU {err:.3e} (bound 1e-9) | {sec:.2f} s",
              flush=True)
        return {"residual": r1[0].tolist(), "vs_cpu": err, "seconds": sec}
    out, sec = _timed(lambda: pe.main(dev))
    direct = [bool(out[f"direct_mu{m}"].converged.all()) for m in ("0", "1")]
    lam = float(out["homotopy"].lam[0])
    if not (all(direct) and lam >= 1.0 and out["final_norm"] < 1e-6):
        raise ExamplesCheckFailed(
            f"vdp_pmp_energy: direct {direct}, lambda {lam}, residual "
            f"{out['final_norm']:.3e}")
    print(f"[vdp_pmp_energy on the card] mu=0, 1 converged, homotopy to "
          f"mu=10 reached lambda 1, multishoot residual "
          f"{out['final_norm']:.2e}, J {out['cost']:.4f} | {sec:.2f} s",
          flush=True)
    return {"final_norm": out["final_norm"], "cost": out["cost"],
            "seconds": sec}


def _event_steps(smoke):
    return 3 if smoke else 60


def _event_time(dev, n):
    from janus_tpu_torch.examples import event_time_training
    return event_time_training.main(n_iter=n, verbose=False, device=dev)


def event_time_part(dev, smoke=False, cpu=None):
    from janus_tpu_torch.examples import event_time_training as et

    n = _event_steps(smoke)
    (loss, theta), sec = _timed(lambda: _event_time(dev, n))
    want_loss, want_theta = cpu.result()
    name = "event_time_training loss and theta"
    err = max(_close(name, theta, want_theta, rtol=1e-8),
              _close(name, loss, want_loss, rtol=1e-8))
    # the reference's quirk: lr 0.3 throws theta far from the truth
    if not smoke and not abs(theta[0] - et.A_TRUE) > 1.0:
        raise ExamplesCheckFailed(f"event_time_training: theta {theta} "
                                  "converged, where the reference does not")
    print(f"[event_time_training on the card] {n} steps: loss {loss:.4f}, "
          f"theta {theta.tolist()} | vs the CPU {err:.3e} (rtol 1e-8) | "
          f"{sec:.2f} s", flush=True)
    return {"steps": n, "loss": loss, "theta": theta.tolist(),
            "vs_cpu": err, "seconds": sec}


def neural_ode_part(dev, smoke=False, cpu=None):
    from janus_tpu_torch.examples import neural_ode_dopri

    steps = 5 if smoke else 200
    (loss0, loss_n, holdout), sec = _timed(lambda: neural_ode_dopri.main(
        steps=steps, verbose=False, device=dev))
    ok = (loss_n < loss0) if smoke else (loss_n < loss0 / 20.0
                                         and holdout < 0.5)
    if not ok:
        raise ExamplesCheckFailed(f"neural_ode_dopri: loss {loss0:.3e} -> "
                                  f"{loss_n:.3e}, holdout {holdout:.3e}")
    print(f"[neural_ode_dopri on the card] {steps} Adam steps: loss "
          f"{loss0:.3e} -> {loss_n:.3e}, holdout MSE {holdout:.3e} | "
          f"{sec:.2f} s ({sec / steps * 1e3:.1f} ms a step with the rollout)",
          flush=True)
    return {"steps": steps, "loss0": loss0, "loss": loss_n,
            "holdout": holdout, "seconds": sec}


def _newton_cg_one(dev, kernel_lu):
    """One value-and-gradient and one H·v at θ0, v = (1, 0.5), at the
    reference's float32 tolerances rtol 1e-5, atol 1e-8 (in float64)."""
    from janus_tpu_torch.examples import newton_cg_hvp as nc
    _, vg, hvp = nc.make_problem(dev, kernel_lu, rtol=1e-5, atol=1e-8)
    v = {"c": torch.tensor(1.0, dtype=torch.float64, device=dev),
         "k": torch.tensor(0.5, dtype=torch.float64, device=dev)}
    val, g = vg(nc.theta0(dev))
    h = {c: x.detach() for c, x in hvp(nc.theta0(dev), v).items()}
    return val, g, h


def _newton_cg_smoke(dev, cpu):
    """``_newton_cg_one`` through K1/K2 (the launches) and on the plain
    route, equal to the bit, and against the CPU."""
    name = "newton_cg_hvp one value-and-gradient and one H.v, rtol 1e-5"
    secs, out = {}, {}
    for k in (True, False):
        mol._reset_kernel_launches()
        out[k], secs[k] = _timed(lambda: _newton_cg_one(dev, k))
        if k:
            launches = mol._kernel_launches()
        elif any(mol._kernel_launches().values()):
            raise ExamplesCheckFailed(f"{name}: the plain route launched a "
                                      "kernel")
    if launches["K1"] <= 0 or launches["K2"] <= 0:
        raise ExamplesCheckFailed(f"{name}: no K1/K2 launches {launches}")
    (vk, gk, hk), (vp, gp, hp) = out[True], out[False]
    if not (torch.equal(vk, vp) and all(torch.equal(gk[c], gp[c])
                                        and torch.equal(hk[c], hp[c])
                                        for c in gk)):
        raise ExamplesCheckFailed(f"{name}: the value, gradient or H.v "
                                  "differs between the routes")
    vc, gc, hc = cpu.result()
    err = max(_close(name, vk, vc, rtol=1e-8),
              *(_close(name, a[c], b[c], rtol=1e-8)
                for a, b in ((gk, gc), (hk, hc)) for c in gk))
    print(f"[{name}] L {float(vk):.8f}, grad (c, k) ({float(gk['c']):.6f}, "
          f"{float(gk['k']):.6f}), H.v ({float(hk['c']):.6f}, "
          f"{float(hk['k']):.6f}) equal to the bit between the routes, vs "
          f"the CPU {err:.3e} (rtol 1e-8) | kernel_lu launches K1 "
          f"{launches['K1']}, K2 {launches['K2']} | s value-and-gradient and "
          f"H.v kernel_lu {secs[True]:.2f}, plain {secs[False]:.2f}",
          flush=True)
    return {"launches": launches, "value": float(vk), "vs_cpu": err,
            "seconds_kernel": [secs[True]], "seconds_plain": [secs[False]]}


def newton_cg_part(dev, smoke=False, cpu=None):
    from janus_tpu_torch.examples import newton_cg_hvp

    if smoke:
        return _newton_cg_smoke(dev, cpu)
    name = "newton_cg_hvp newton_iters=4 f64 rtol 1e-9"
    outs, secs, launches = _routes(
        True, lambda k: newton_cg_hvp.main(4, dev, k), name)
    if outs[True] != outs[False]:
        raise ExamplesCheckFailed(f"{name}: losses differ between the "
                                  f"routes: {outs}")
    l_newton, l_gd = outs[True]
    if not l_newton < l_gd:
        raise ExamplesCheckFailed(f"{name}: Newton-CG {l_newton} does not "
                                  f"beat gradient descent {l_gd}")
    print(f"[{name}] Newton-CG {l_newton:.8f}, gradient descent {l_gd:.8f}, "
          f"equal to the bit between the routes | kernel_lu launches K1 "
          f"{launches['K1']}, K2 {launches['K2']} | s kernel_lu {secs[True]},"
          f" plain LU {secs[False]}", flush=True)
    return {"launches": launches, "newton": l_newton, "gd": l_gd,
            "seconds_kernel": secs[True], "seconds_plain": secs[False]}


def _min_time_first(dev):
    """``newton_free_tf``'s first evaluation on four umax lanes from tF = 0.3
    (ε = 0.5, rtol 1e-8, atol 1e-11): (F(z0), its exact Jacobian, the IND
    tangents)."""
    from janus_tpu_torch.examples import vdp_min_time as mt
    from janus_tpu_torch.solve import Options

    opts = Options(rtol=1e-8, atol=1e-11)
    umax = torch.linspace(0.8, 2.0, 4, dtype=torch.float64, device=dev)
    z0 = torch.tensor([[0.6, 0.6, 0.3], [0.4, 0.7, 0.3], [0.8, 0.3, 0.3],
                       [0.5, 0.5, 0.3]], dtype=torch.float64, device=dev)
    args = (mt.MU, umax, torch.tensor(0.5, dtype=torch.float64, device=dev))
    fvec, jac, sol = mt.residual_and_jac(z0, args, opts)
    return fvec, jac, sol.sens


def min_time_part(dev, smoke=False, cpu=None):
    from janus_tpu_torch.examples import vdp_min_time as mt

    if smoke:
        (fvec, jac, sens), sec = _timed(lambda: _min_time_first(dev))
        if not all(bool(torch.isfinite(x).all()) for x in (fvec, jac, sens)):
            raise ExamplesCheckFailed(f"vdp_min_time: F {fvec.tolist()}, "
                                      "its Jacobian or the tangents not "
                                      "finite")
        fc, jc, sc = cpu.result()
        name = "vdp_min_time F(z0), its Jacobian and the IND tangents"
        err = max(_close(name, fvec, fc, atol=1e-9),
                  _close(name, jac, jc, atol=1e-9),
                  _close(name, sens, sc, atol=1e-9))
        print(f"[vdp_min_time on the card, the first evaluation on 4 umax "
              f"lanes] |F(z0)| {mt._norm(fvec).tolist()} | F, its Jacobian "
              f"and the IND tangents vs the CPU {err:.3e} (bound 1e-9) | "
              f"{sec:.2f} s", flush=True)
        return {"fn0": mt._norm(fvec).tolist(), "vs_cpu": err,
                "seconds": sec}
    (umax, tf_t, fn, h_max), sec = _timed(lambda: mt.main(dev))
    print(f"[vdp_min_time on the card] umax {umax.tolist()}: tF "
          f"{tf_t.tolist()}, |F| max {float(fn.max()):.2e}, max |H| "
          f"{h_max:.2e} | {sec:.2f} s", flush=True)
    return {"tf": tf_t.tolist(), "fn_max": float(fn.max()), "h_max": h_max,
            "seconds": sec}


def _cpu_side(part, smoke):
    """(the function, its arguments) whose CPU result ``part`` holds the
    card's to, or None where the part has no such check."""
    cpu = "cpu"
    return {
        "hamiltonian": (_ham_cpu, smoke),
        "dubins": (_dubins_residual, cpu) if smoke else None,
        "dubins_jac": (_dubins_counted,),
        "pmp_energy": (_pmp_residuals, cpu) if smoke else None,
        "event_time": (_event_time, cpu, _event_steps(smoke)),
        "newton_cg": (_newton_cg_one, cpu, True) if smoke else None,
        "min_time": (_min_time_first, cpu) if smoke else None,
    }.get(part)


_PART_FNS = {"poincare": poincare_part, "fit_mu": fit_mu_part,
             "reverse_time": reverse_time_part,
             "hamiltonian": hamiltonian_part, "bratu": bratu_part,
             "dubins": dubins_part, "dubins_jac": dubins_jac_part,
             "pmp_energy": pmp_energy_part, "event_time": event_time_part,
             "neural_ode": neural_ode_part, "newton_cg": newton_cg_part,
             "min_time": min_time_part}


def run(dev, only=PARTS, smoke=False):
    """Run the named parts in order; returns their records with the seconds
    each took under ``"seconds"``. Every CPU side starts first, each in a
    worker process of its own."""
    if smoke:
        only = [p for p in only if p not in NOT_IN_SMOKE]
    later = {}
    for part in PARTS:
        job = _cpu_side(part, smoke) if part in only else None
        if job is not None:
            later[part] = Later(*job)
    report, seconds = {}, {}
    for part in PARTS:
        if part in only:
            t0 = time.perf_counter()
            report[part] = _PART_FNS[part](dev, smoke=smoke,
                                           cpu=later.get(part))
            _sync()
            seconds[part] = time.perf_counter() - t0
    report["seconds"] = seconds
    print("[examples part seconds] " + ", ".join(
        f"{k} {v:.1f}" for k, v in seconds.items()), flush=True)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="+", choices=PARTS, default=PARTS)
    ap.add_argument("--json", type=Path, default=None,
                    help="also write the JSON line to this file")
    ap.add_argument("--smoke", action="store_true",
                    help="chip_smoke's phase 23: its cuts (module docstring)")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("examples: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    report = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              **run(torch.device("cuda:0"), a.only, smoke=a.smoke)}
    line = json.dumps(report)
    if a.json is not None:
        a.json.parent.mkdir(parents=True, exist_ok=True)
        a.json.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
