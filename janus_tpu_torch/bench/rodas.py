"""Drive, check and measure RODAS4, its discrete adjoint and events on a
card.

Phase 15 of ``chip_smoke.py`` (``run(dev, smoke=True)``), and a probe of its
own, run from the root of a checkout on a machine with a CUDA card:

    python3 -m janus_tpu_torch.bench.rodas [--only PHASE ...] [--json PATH]

Phases (``PHASES``), each raising ``RodasCheckFailed`` when its check fails:
- ``adjoint``: ``bench.py``'s rodas-adjoint gradient
  (``_rodas_adjoint_metric``) at full width -- 8,192 Van der Pol lanes, y0 =
  (2, 0), mu = logspace(1.5, 3), t in [0, 1], Options(rtol=1e-4, atol=1e-7,
  pivoting=False, adjoint_steps=128), the analytic Jacobian, loss
  sum(y(T)^2), gradient in y0 and mu by ``rodas_adjoint`` and
  ``loss.backward()`` -- in f64 and f32: ms per gradient (median of 3 after
  a warm-up, CUDA events), host syncs of the forward and the backward,
  max(naccept) of 128, the mesh's bytes; in f64 the launches and busy share
  of one gradient under torch.profiler, and the checks: every gradient
  finite; <dL/dy0, d> against ybar . solve_rodas(tangents=[d]).sens to
  1e-10 relative (the two are transposes of one linear map); d/dmu of lanes
  0, M/2, M-1 against central differences of the full solve (eps = 1e-6 mu)
  within 1e-4 relative (rtol: the frozen-mesh gradient differs from the
  solver's derivative by the controller's mesh sensitivity; rehearsed on the
  CPU at 9.6e-8); 4 lanes on the card against the CPU to 1e-7. The
  f32 gradient must be finite.
- ``forward``: 65,536 Van der Pol lanes, mu = 1e3, t in [0, 1], rtol 1e-6,
  atol 1e-9, pivoting=False, analytic Jacobian, K=2 IND tangents, through
  solve_rodas with kernel_lu=True (K1 factors E, K2 does every stage and
  tangent solve) and with the plain LU, in turns (kernel, plain, plain,
  kernel): K1/K2 launches, host syncs, s per solve (CUDA events); y and sens
  of the two within 1e-5 relative; then mu = logspace(1, 3) with the
  kernels: 8 lanes within 1e-4 relative + 1e-6 absolute of scipy's Radau at
  rtol 1e-10.
- ``events``: solve_radau (Radau5, rtol 1e-6, analytic Jacobian) on 65,536
  lanes, mu = logspace(1, 3), t in [0, 1], with the terminal event x =
  1.999 falling (lanes with mu below ~670 trigger): triggered lanes
  EVENT_TERMINATED with x(t*) = 1.999 to 1e-9, the others SUCCESS; event_t,
  event_idx and status of 4 lanes against the same lanes solved on the CPU
  (event_t to 1e-8 relative); then ms per solve of the same solve at 1,024
  lanes (median of 3 after a warm-up, CUDA events) and its host syncs, and
  ``handle_events`` alone on one accepted step of 1,024 lanes with Radau5's
  interpolant, where every lane crossed (the 60-trip bisection runs) and
  where none did (the gate: one host any()): ms per call.

``run(dev, smoke=True)`` is chip_smoke's phase 15: the f64 gradient once
with its checks, one kernel_lu forward (the launches) and one plain, the
65,536-lane event solve against the CPU; no medians, f32, profiler, scipy
or 1,024-lane timing.
"""

from __future__ import annotations

import argparse
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
from janus_tpu_torch.models.problems import vdp_jac, vdp_rhs
from janus_tpu_torch.solve import Event, Options
from janus_tpu_torch.solve.adjoint_rodas import rodas_adjoint
from janus_tpu_torch.solve.events import handle_events, init_event_state
from janus_tpu_torch.solve.radau import solve_radau
from janus_tpu_torch.solve.rodas import solve_rodas

M_ADJ = 8192
ADJ_OPTS = dict(rtol=1e-4, atol=1e-7, pivoting=False, adjoint_steps=128)
M_FWD = 65_536
EVENT_X = 1.999


class RodasCheckFailed(RuntimeError):
    """A phase's check did not hold."""


def _mus(lo, hi, m, dtype, dev):
    """logspace(lo, hi, m) made on the CPU in f64, so that every device and
    dtype sees the same values (rounded once)."""
    return torch.logspace(lo, hi, m, dtype=torch.float64).to(dev, dtype)


def bench_inputs(m, dtype, dev):
    """y0 [m, 2] = (2, 0) and mu = logspace(1.5, 3, m): bench.py's lanes."""
    y0 = torch.tensor([[2.0, 0.0]], dtype=dtype, device=dev).repeat(m, 1)
    return y0, _mus(1.5, 3.0, m, dtype, dev)


def gradient(m, dtype, dev, wrap=None):
    """bench.py's loss sum(y(T)^2) on m lanes and its gradient: (loss,
    dL/dy0 [m, 2], dL/dmu [m])."""
    y0, mus = bench_inputs(m, dtype, dev)
    y0.requires_grad_()
    mus.requires_grad_()
    y_end = rodas_adjoint(vdp_rhs if wrap is None else wrap(vdp_rhs),
                          (0.0, 1.0), y0, args=mus,
                          options=Options(**ADJ_OPTS), jac=vdp_jac)
    loss = torch.sum(y_end ** 2)
    loss.backward()
    return loss.detach(), y0.grad, mus.grad


def check_gradient(g, dtype, dev):
    """The transpose oracle and d/dmu of 3 lanes against central
    differences for the m-lane gradient g = (loss, g_y0, g_mu); returns
    their relative errors."""
    _, g_y0, g_mu = g
    m = g_y0.shape[0]
    y0, mus = bench_inputs(m, dtype, dev)
    opts = Options(**ADJ_OPTS)
    d = torch.as_tensor(np.random.default_rng(15).standard_normal((1, m, 2)),
                        dtype=dtype, device=dev)
    sol = solve_rodas(vdp_rhs, 0.0, 1.0, y0, mus, opts, jac=vdp_jac,
                      tangents=d)
    ind = float(torch.sum(2.0 * sol.y * sol.sens[0]))
    transpose = abs(float(torch.sum(g_y0 * d[0])) - ind) / abs(ind)
    lanes = [0, m // 2, m - 1]
    eps = 1e-6 * mus[lanes]
    y6 = solve_rodas(vdp_rhs, 0.0, 1.0, y0[lanes].repeat(2, 1),
                     torch.cat([mus[lanes] + eps, mus[lanes] - eps]), opts,
                     jac=vdp_jac).y
    l6 = torch.sum(y6 ** 2, dim=-1)
    fd = (l6[:3] - l6[3:]) / (2.0 * eps)
    fd_mu = float(((g_mu[lanes] - fd).abs() / fd.abs()).max())
    return {"transpose": transpose, "fd_mu": fd_mu}


def adjoint_phase(dev, dtype=torch.float64, reps=3, checks=True,
                  profile=True):
    """The rodas-adjoint cell at 8,192 lanes."""
    name = f"rodas adjoint M={M_ADJ} {str(dtype)[6:]}"
    g = gradient(M_ADJ, dtype, dev)                     # also the warm-up
    torch.cuda.synchronize()
    syncs = (solve_rodas.host_syncs, rodas_adjoint.host_syncs)
    if not all(bool(torch.isfinite(x).all()) for x in g[1:]):
        raise RodasCheckFailed(f"{name}: non-finite gradient")
    y0, mus = bench_inputs(M_ADJ, dtype, dev)
    with torch.no_grad():
        sol = solve_rodas(vdp_rhs, 0.0, 1.0, y0, mus, Options(**ADJ_OPTS),
                          jac=vdp_jac)
    nacc = int(sol.stats["naccept"].max())
    if not bool((sol.status == 1).all()) or nacc > ADJ_OPTS["adjoint_steps"]:
        raise RodasCheckFailed(f"{name}: forward not SUCCESS on every lane, "
                               f"or max(naccept) {nacc} > 128")
    mesh_bytes = M_ADJ * ADJ_OPTS["adjoint_steps"] * (2 + 2) \
        * y0.element_size()
    errs = None
    if checks:
        errs = check_gradient(g, dtype, dev)
        on_card = gradient(4, dtype, dev)
        on_cpu = gradient(4, dtype, torch.device("cpu"))
        errs["cpu"] = max(float((a.cpu() - b).abs().max() / b.abs().max())
                          for a, b in zip(on_card[1:], on_cpu[1:]))
        for key, bound in (("transpose", 1e-10), ("fd_mu", 1e-4),
                           ("cpu", 1e-7)):
            if not errs[key] <= bound:
                raise RodasCheckFailed(f"{name}: {key} check {errs[key]:.3e}"
                                       f" > {bound:g}")
    ms = statistics.median(events_ms(lambda: gradient(M_ADJ, dtype, dev), 1)
                           for _ in range(reps))
    prof = mol.profile_solve(lambda wrap: gradient(M_ADJ, dtype, dev, wrap)) \
        if profile else None
    rec = {"ms_per_gradient": ms, "host_syncs_forward": syncs[0],
           "host_syncs_backward": syncs[1], "naccept_max": nacc,
           "adjoint_steps": ADJ_OPTS["adjoint_steps"],
           "mesh_bytes": mesh_bytes, "checks": errs}
    if prof is not None:
        rec.update(launches=prof["launches"], busy_ms=prof["busy_ms"],
                   busy_share=prof["busy_ms"] / ms)
    print(f"[{name}] bench.py's rodas-adjoint gradient, rtol 1e-4: gradients "
          f"finite | {ms:.2f} ms per gradient (median of {reps}, CUDA events)"
          f" | host syncs {syncs[0]} forward + {syncs[1]} backward | "
          f"max(naccept) {nacc} of {ADJ_OPTS['adjoint_steps']}, mesh "
          f"{mesh_bytes / 1e6:.1f} MB"
          + ("" if prof is None else
             f" | launches {prof['launches']}, device busy "
             f"{prof['busy_ms']:.2f} ms = {rec['busy_share']:.3f} of the "
             f"gradient (one gradient under torch.profiler)")
          + ("" if errs is None else
             f" | <dL/dy0, d> vs ybar.sens(d): {errs['transpose']:.3e} (bound"
             f" 1e-10); d/dmu of lanes 0, M/2, M-1 vs central difference: "
             f"{errs['fd_mu']:.3e} (bound 1e-4); 4 lanes vs the CPU: "
             f"{errs['cpu']:.3e} (bound 1e-7)"), flush=True)
    return rec


def forward_solve(dev, kernel_lu, mus=None, m=None):
    """The headline lanes (m of them, by default M_FWD, or as many as mus)
    through solve_rodas with K=2 IND tangents."""
    dtype = torch.float64
    m = (M_FWD if mus is None else mus.shape[0]) if m is None else m
    y0 = torch.tensor([[2.0, 0.0]], dtype=dtype, device=dev).repeat(m, 1)
    if mus is None:
        mus = torch.full((m,), 1e3, dtype=dtype, device=dev)
    seeds = torch.zeros((2, m, 2), dtype=dtype, device=dev)
    seeds[0, :, 0] = 1.0
    seeds[1, :, 1] = 1.0
    opts = Options(rtol=1e-6, atol=1e-9, pivoting=False, kernel_lu=kernel_lu)
    return solve_rodas(vdp_rhs, 0.0, 1.0, y0, mus, opts, jac=vdp_jac,
                       tangents=seeds)


def _scipy_worst(y_got, mus):
    """Worst error / bound of 8 lanes against scipy's Radau at rtol 1e-10."""
    from scipy.integrate import solve_ivp as scipy_ivp
    worst = 0.0
    for i in np.linspace(0, len(mus) - 1, 8).round().astype(int):
        mu = float(mus[i])
        ref = scipy_ivp(
            lambda t, y: [y[1], mu * (1 - y[0] ** 2) * y[1] - y[0]],
            (0.0, 1.0), [2.0, 0.0], method="Radau", rtol=1e-10, atol=1e-12,
            jac=lambda t, y: [[0.0, 1.0], [-2 * mu * y[0] * y[1] - 1,
                                           mu * (1 - y[0] ** 2)]]).y[:, -1]
        e = np.abs(y_got[i] - ref) / (1e-4 * np.abs(ref) + 1e-6)
        if not np.all(e <= 1.0):
            raise RodasCheckFailed(f"rodas lane {i} (mu={mu:.4g}): y "
                                   f"{y_got[i]} vs scipy {ref}")
        worst = max(worst, float(e.max()))
    return worst


def forward_phase(dev, smoke=False):
    """K1/K2 on rodas: the kernel_lu solve against the plain LU."""
    torch.cuda.synchronize()
    mol._reset_kernel_launches()
    sol_k = forward_solve(dev, True)
    torch.cuda.synchronize()
    launches = mol._kernel_launches()
    syncs = solve_rodas.host_syncs
    if launches["K1"] <= 0 or launches["K2"] <= 0:
        raise RodasCheckFailed(f"rodas forward: kernel_lu=True did not "
                               f"launch K1 and K2: {launches}")
    if not bool((sol_k.status == 1).all()):
        raise RodasCheckFailed("rodas forward: not SUCCESS on every lane")
    sol_p = forward_solve(dev, False)
    for what in ("y", "sens"):
        got, ref = getattr(sol_k, what), getattr(sol_p, what)
        if not torch.allclose(got, ref, rtol=1e-5,
                              atol=1e-5 * float(ref.abs().max())):
            raise RodasCheckFailed(f"rodas forward {what}: kernel vs plain "
                                   "LU differ beyond 1e-5")
    rec = {"launches": launches, "host_syncs": syncs,
           "nsteps_max": int(sol_k.stats["nsteps"].max()),
           "naccept_max": int(sol_k.stats["naccept"].max())}
    if smoke:
        times = ""
    else:
        turns = {True: [], False: []}
        for k in (True, False, False, True):
            turns[k].append(events_ms(lambda: forward_solve(dev, k), 1) / 1e3)
        rec["s_per_solve_kernel"] = statistics.median(turns[True])
        rec["s_per_solve_plain"] = statistics.median(turns[False])
        rec["turns"] = {"kernel": turns[True], "plain": turns[False]}
        mus = _mus(1.0, 3.0, M_FWD, torch.float64, dev)
        sol_h = forward_solve(dev, True, mus=mus)
        if not bool((sol_h.status == 1).all()):
            raise RodasCheckFailed("rodas heterogeneous mu: not SUCCESS")
        rec["scipy_worst"] = _scipy_worst(sol_h.y.cpu().numpy(),
                                          mus.cpu().numpy())
        times = (f" | s/solve kernel_lu {rec['turns']['kernel']}, plain LU "
                 f"{rec['turns']['plain']} (turns kernel, plain, plain, "
                 f"kernel; CUDA events) | mu=logspace(1,3): 8 lanes vs scipy"
                 f" Radau worst error / bound {rec['scipy_worst']:.3e}")
    print(f"[rodas forward M={M_FWD} f64 mu=1e3 rtol 1e-6 K=2 IND] success "
          f"1.0 | kernel_lu launches K1 {launches['K1']}, K2 "
          f"{launches['K2']} (K3 {launches['K3']}, K4 {launches['K4']}) | "
          f"host syncs {syncs}, nsteps max "
          f"{rec['nsteps_max']} | y, sens within 1e-5 of the plain LU"
          + times, flush=True)
    return rec


def event_solve(m, dev, mus=None):
    """Radau5 on m stiff VdP lanes with the terminal event x = 1.999."""
    dtype = torch.float64
    y0 = torch.tensor([[2.0, 0.0]], dtype=dtype, device=dev).repeat(m, 1)
    mus = _mus(1.0, 3.0, m, dtype, dev) if mus is None else mus
    ev = Event(lambda t, y, a: y[:, 0] - EVENT_X, terminal=True,
               direction=-1.0)
    return solve_radau(vdp_rhs, 0.0, 1.0, y0, args=mus,
                       options=Options(rtol=1e-6, atol=1e-9), jac=vdp_jac,
                       events=ev)


def bisection_step_ms(dev, m=1024, reps=20):
    """``handle_events`` on one accepted step (t 0 -> 1e-3, x 2 -> x_new) of
    m lanes with the event x = 1.999 falling and a cubic interpolant shaped
    as Radau5's: ms per call (CUDA events, mean of reps after one) where
    every lane crossed and where none did."""
    dtype = torch.float64
    specs = (Event(lambda t, y, a: y[:, 0] - EVENT_X, direction=-1.0),)
    t_old = torch.zeros((m,), dtype=dtype, device=dev)
    h = torch.full((m,), 1e-3, dtype=dtype, device=dev)
    accept = torch.ones((m,), dtype=torch.bool, device=dev)
    y_old = torch.tensor([[2.0, 0.0]], dtype=dtype, device=dev).repeat(m, 1)
    state = init_event_state(specs, m, 2, t_old, y_old, None)

    def call(x_new):
        y_new = y_old.clone()
        y_new[:, 0] = x_new
        q = torch.zeros((m, 3, 2), dtype=dtype, device=dev)
        q[:, 0] = y_new - y_old

        def interp(theta):
            tp = torch.stack([theta ** (j + 1) for j in range(3)], dim=-1)
            return y_old[:, None, :] + torch.einsum("mtq,mqd->mtd", tp, q)

        return lambda: handle_events(specs, state, t_old, h, t_old + h,
                                     y_new, interp, accept, None)

    out = {}
    for name, x_new in (("crossed", EVENT_X - 1e-3), ("none", EVENT_X + 5e-4)):
        fn = call(x_new)
        fn()
        out[name] = events_ms(fn, reps)
    return out


def events_phase(dev, smoke=False):
    """The event solve at 65,536 lanes against the CPU; 1,024 lanes timed."""
    sol = event_solve(M_FWD, dev)
    syncs = solve_radau.host_syncs
    hit = sol.event_idx >= 0
    if not bool(((sol.status == 5) == hit).all()
                & (sol.status[~hit] == 1).all()):
        raise RodasCheckFailed("events: status does not follow event_idx")
    x_err = float((sol.event_y[hit, 0] - EVENT_X).abs().max())
    if not x_err <= 1e-9:
        raise RodasCheckFailed(f"events: x(t*) off 1.999 by {x_err:.3e}")
    lanes = [0, M_FWD // 3, 2 * M_FWD // 3, M_FWD - 1]
    mus = _mus(1.0, 3.0, M_FWD, torch.float64, dev)[lanes]
    cpu = event_solve(4, torch.device("cpu"), mus=mus.cpu())
    got_t = sol.event_t[lanes].cpu()
    both = torch.isfinite(cpu.event_t)
    if not (torch.equal(sol.event_idx[lanes].cpu(), cpu.event_idx)
            and torch.equal(sol.status[lanes].cpu(), cpu.status)
            and torch.equal(torch.isfinite(got_t), both)):
        raise RodasCheckFailed(f"events: lanes {lanes} on the card "
                               f"{sol.event_idx[lanes].tolist()} vs the CPU "
                               f"{cpu.event_idx.tolist()}")
    t_err = float(((got_t[both] - cpu.event_t[both]).abs()
                   / cpu.event_t[both].abs()).max())
    if not t_err <= 1e-8:
        raise RodasCheckFailed(f"events: event_t vs the CPU {t_err:.3e}")
    rec = {"triggered": int(hit.sum()), "host_syncs": syncs,
           "nsteps_max": int(sol.stats["nsteps"].max()),
           "event_t_lanes": got_t.tolist(), "event_t_vs_cpu": t_err}
    small = ""
    if not smoke:
        event_solve(1024, dev)                          # warm-up
        rec["ms_1024"] = statistics.median(
            events_ms(lambda: event_solve(1024, dev), 1) for _ in range(3))
        rec["host_syncs_1024"] = solve_radau.host_syncs
        rec["handle_events_ms"] = bisection_step_ms(dev)
        small = (f" | M=1,024: {rec['ms_1024']:.2f} ms per solve (median of "
                 f"3, CUDA events), {rec['host_syncs_1024']} host syncs; "
                 f"handle_events on one step: "
                 f"{rec['handle_events_ms']['crossed']:.3f} ms where every "
                 f"lane crossed (bisection), "
                 f"{rec['handle_events_ms']['none']:.3f} ms where none did "
                 f"(gate only)")
    print(f"[events radau5 M={M_FWD} mu=logspace(1,3) x=1.999 falling] "
          f"{rec['triggered']} lanes triggered, the rest SUCCESS, x(t*) "
          f"within {x_err:.1e} of 1.999 | host syncs {syncs}, nsteps max "
          f"{rec['nsteps_max']} | lanes {lanes}: event_t "
          f"{[round(x, 12) for x in rec['event_t_lanes']]}, event_idx and "
          f"status equal to the CPU's, event_t within {t_err:.1e}" + small,
          flush=True)
    return rec


PHASES = ("adjoint", "forward", "events")


def run(dev, only=PHASES, smoke=False):
    """Run the named phases; returns their records with the seconds each
    phase took under ``"seconds"``."""
    report, seconds = {}, {}

    def timed(phase, key, fn, *a, **kw):
        t0 = time.perf_counter()
        report[key] = fn(dev, *a, **kw)
        torch.cuda.synchronize()
        seconds[phase] = seconds.get(phase, 0.0) + time.perf_counter() - t0

    if "adjoint" in only:
        timed("adjoint", "adjoint_f64", adjoint_phase, reps=1 if smoke else 3,
              profile=not smoke)
        if not smoke:
            timed("adjoint", "adjoint_f32", adjoint_phase, torch.float32,
                  checks=False, profile=False)
    if "forward" in only:
        timed("forward", "forward", forward_phase, smoke=smoke)
    if "events" in only:
        timed("events", "events", events_phase, smoke=smoke)
    report["seconds"] = seconds
    print("[rodas phase seconds] " + ", ".join(f"{k} {v:.1f}"
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
        print("rodas: no CUDA device", file=sys.stderr)
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
