"""Drive, check and measure SEULEX and its discrete adjoint on a card.

Phase 18 of ``chip_smoke.py`` (``run(dev, smoke=True)``), and a probe of its
own, run from the root of a checkout on a machine with a CUDA card:

    python3 -m janus_tpu_torch.bench.seulex [--only PHASE ...] [--json PATH]

Phases (``PHASES``), each raising ``SeulexCheckFailed`` when its check fails:
- ``forward``: solve_seulex on the 65,536 headline lanes of the Radau9
  bench (Van der Pol, mu = 1e3, y0 = (2, 0), t in [0, 1], rtol 1e-6, atol
  1e-9, f64, the analytic Jacobian, pivoting=False) with K=2 IND tangents
  (unit seeds in y0), through K1/K2 (kernel_lu=True: K1 factors every
  ladder level's M/h' - J, K2 does every substep, stability-check and
  tangent solve) and through the plain pivot-free LU, in alternating turns
  (kernel, plain, plain, kernel, kernel, plain): s per solve (median of 3
  per route, CUDA events) with the spread, K1/K2 launches, host syncs;
  checks: every lane SUCCESS, all seven counters equal between the routes,
  y within 1e-10 and sens within 1e-8 of the plain route (relative to the
  largest entry; whether they are equal to the bit is reported), 8 lanes
  within ``SCIPY_BOUND`` of scipy's Radau at rtol 1e-10, and so are 8 lanes
  of a solve of mu = logspace(1, 3) on 65,536 lanes through the kernels;
  without ``smoke`` also each route's launches and device busy time in one
  solve under torch.profiler.
- ``adjoint``: seulex_adjoint on the reference's own stiff adjoint
  configuration (``experiments/adjoint_families_chip.py``): Van der Pol
  lanes, y0 = (2, 0), mu = logspace(1.5, 3), t in [0, 1], rtol 1e-4, atol
  1e-7, pivoting=False, adjoint_steps=128, seulex_kmax=5, the analytic
  Jacobian, loss sum(y(T)^2), gradient in y0 and mu, the recording forward
  through K1/K2; 8,192 lanes in f64 and f32, and 65,536 lanes in f64: ms
  per gradient (median of 3 after a warm-up, CUDA events), K1/K2 launches
  and host syncs of one gradient, max(naccept) of 128, the mesh's bytes,
  peak memory; at 8,192 lanes f64 the checks: finite; the replay of every
  recorded slot against the next recorded state (``REPLAY_BOUND``); the
  gradient against torch autograd of the frozen replay chain (1e-10, the
  reference's own oracle); d/dmu of lanes 0, M/2, M-1 against central
  differences of the full solve (eps = 1e-6 mu) within ``FD_BOUND``
  relative; 4 lanes on the card against the CPU within 1e-7. No transpose
  oracle: the IND tangents drop dA/dy, the gradient does not. Without
  ``smoke`` also the device's busy share of one f64 gradient under
  torch.profiler.

``run(dev, smoke=True)`` is chip_smoke's phase 18: one turn of each route of
the forward with its checks, and the f64 gradient at 8,192 lanes with its
checks; no medians, f32, 65,536-lane gradient or profiler.
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
from janus_tpu_torch.bench.ndf import scipy_worst
from janus_tpu_torch.bench.rodas import _mus, bench_inputs
from janus_tpu_torch.models.problems import vdp_jac, vdp_rhs
from janus_tpu_torch.solve import Options
from janus_tpu_torch.solve.adjoint_seulex import _one_step, seulex_adjoint
from janus_tpu_torch.solve.seulex import solve_seulex

M_ADJ = 8192
M_FWD = 65_536
ADJ_OPTS = dict(rtol=1e-4, atol=1e-7, pivoting=False, adjoint_steps=128,
                seulex_kmax=5, kernel_lu=True)
FWD_OPTS = dict(rtol=1e-6, atol=1e-9, pivoting=False)
STATS = ("nfev", "njev", "nlu", "nsteps", "naccept", "nreject", "order")
# tests/test_seulex.py's bound against scipy's Radau (relative, absolute)
SCIPY_BOUND = (1e-5, 1e-7)
# the replay of a recorded slot against the next recorded state (the
# recording forward through K1/K2, the replay on the plain pivot-free LU,
# which has the kernels' arithmetic: 0 on the CPU)
REPLAY_BOUND = 1e-12
# the frozen-mesh gradient against central differences of the full solve:
# the controller's mesh sensitivity at rtol 1e-4, measured on the CPU for
# lanes 0, M/2, M-1 of 8,192: 1.2e-5, 6.5e-7, 8.1e-6 (over 200 lanes of the
# same mu range: median 2.0e-6, 90th percentile 8.6e-6, max 6.8e-5; the
# same within 2x at eps = 1e-4 mu)
FD_BOUND = 1e-4


class SeulexCheckFailed(RuntimeError):
    """A phase's check did not hold."""


def gradient(m, dtype, dev, wrap=None):
    """The loss sum(y(T)^2) on m lanes and its gradient by seulex_adjoint:
    (loss, dL/dy0 [m, 2], dL/dmu [m])."""
    y0, mus = bench_inputs(m, dtype, dev)
    y0.requires_grad_()
    mus.requires_grad_()
    y_end = seulex_adjoint(vdp_rhs if wrap is None else wrap(vdp_rhs),
                           (0.0, 1.0), y0, args=mus,
                           options=Options(**ADJ_OPTS), jac=vdp_jac)
    loss = torch.sum(y_end ** 2)
    loss.backward()
    return loss.detach(), y0.grad, mus.grad


def frozen_chain(m, dtype, dev):
    """The recording forward's mesh replayed slot by slot: (the largest
    relative difference between a replay and the next recorded state, and
    the gradient of sum(y(T)^2) by torch autograd through the chain of
    replays: dL/dy0, dL/dmu)."""
    y0, mus = bench_inputs(m, dtype, dev)
    opts = Options(**ADJ_OPTS)
    sol = solve_seulex(vdp_rhs, 0.0, 1.0, y0, mus, opts, jac=vdp_jac,
                       _mesh_size=opts.adjoint_steps, _force_jac=True)
    mesh, nacc = sol.mesh, sol.stats["naccept"]
    y0.requires_grad_()
    mus.requires_grad_()
    y, worst = y0, 0.0
    for i in range(int(nacc.max())):
        live = i < nacc
        k_rec = torch.where(live, mesh["k"][:, i].to(torch.int64), 1)
        top = int(torch.where(live, mesh["k"][:, i], -1).max())
        t_i = torch.where(live, mesh["t"][:, i], 0.0)
        h_i = torch.where(live, mesh["h"][:, i], 1.0)
        with torch.no_grad():
            rep = _one_step(vdp_rhs, vdp_jac, None, opts, t_i, h_i,
                            mesh["y"][:, i], k_rec, top, mus, live)
            nxt = torch.where((i + 1 < nacc)[:, None], mesh["y"][:, i + 1],
                              sol.y)
            worst = max(worst, float(((rep - nxt).abs()[live]).max()
                                     / nxt.abs().max()))
        step = _one_step(vdp_rhs, vdp_jac, None, opts, t_i, h_i, y, k_rec,
                         top, mus, live)
        y = torch.where(live[:, None], step, y)
    torch.sum(y ** 2).backward()
    return worst, y0.grad, mus.grad


def check_gradient(g, dtype, dev):
    """The replay and autograd-chain oracles and d/dmu of 3 lanes against
    central differences for the m-lane gradient g = (loss, g_y0, g_mu);
    returns their relative errors."""
    _, g_y0, g_mu = g
    m = g_y0.shape[0]
    replay, c_y0, c_mu = frozen_chain(m, dtype, dev)
    chain = max(float((a - b).abs().max() / b.abs().max())
                for a, b in ((g_y0, c_y0), (g_mu, c_mu)))
    y0, mus = bench_inputs(m, dtype, dev)
    lanes = [0, m // 2, m - 1]
    eps = 1e-6 * mus[lanes]
    y6 = solve_seulex(vdp_rhs, 0.0, 1.0, y0[lanes].repeat(2, 1),
                      torch.cat([mus[lanes] + eps, mus[lanes] - eps]),
                      Options(**ADJ_OPTS), jac=vdp_jac, _force_jac=True).y
    l6 = torch.sum(y6 ** 2, dim=-1)
    fd = (l6[:3] - l6[3:]) / (2.0 * eps)
    fd_mu = float(((g_mu[lanes] - fd).abs() / fd.abs()).max())
    return {"replay": replay, "chain": chain, "fd_mu": fd_mu}


def mesh_bytes(m, dim, dtype):
    """The adjoint's rings: per lane and slot t, h, y [D] and the accepted
    level (int32)."""
    esize = torch.finfo(dtype).bits // 8
    return m * ADJ_OPTS["adjoint_steps"] * ((2 + dim) * esize + 4)


def adjoint_phase(dev, m=M_ADJ, dtype=torch.float64, reps=3, checks=True,
                  profile=False):
    """One cell of the SEULEX adjoint: the gradient at m lanes."""
    name = f"seulex adjoint M={m} {str(dtype)[6:]}"
    gradient(m, dtype, dev)                             # the warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    mol._reset_kernel_launches()
    g = gradient(m, dtype, dev)
    torch.cuda.synchronize()
    launches = mol._kernel_launches()
    peak = torch.cuda.max_memory_allocated(dev)
    syncs = (solve_seulex.host_syncs, seulex_adjoint.host_syncs)
    if not all(bool(torch.isfinite(x).all()) for x in g[1:]):
        raise SeulexCheckFailed(f"{name}: non-finite gradient")
    if launches["K1"] <= 0 or launches["K2"] <= 0:
        raise SeulexCheckFailed(f"{name}: K1/K2 not launched: {launches}")
    y0, mus = bench_inputs(m, dtype, dev)
    with torch.no_grad():
        sol = solve_seulex(vdp_rhs, 0.0, 1.0, y0, mus, Options(**ADJ_OPTS),
                           jac=vdp_jac, _force_jac=True)
    nacc = int(sol.stats["naccept"].max())
    if not bool((sol.status == 1).all()) or nacc > ADJ_OPTS["adjoint_steps"]:
        raise SeulexCheckFailed(f"{name}: forward not SUCCESS on every lane,"
                                f" or max(naccept) {nacc} > 128")
    errs = None
    if checks:
        errs = check_gradient(g, dtype, dev)
        on_card = gradient(4, dtype, dev)
        on_cpu = gradient(4, dtype, torch.device("cpu"))
        errs["cpu"] = max(float((a.cpu() - b).abs().max() / b.abs().max())
                          for a, b in zip(on_card[1:], on_cpu[1:]))
        for key, bound in (("replay", REPLAY_BOUND), ("chain", 1e-10),
                           ("fd_mu", FD_BOUND), ("cpu", 1e-7)):
            if not errs[key] <= bound:
                raise SeulexCheckFailed(f"{name}: {key} check "
                                        f"{errs[key]:.3e} > {bound:g}")
    times = [events_ms(lambda: gradient(m, dtype, dev), 1)
             for _ in range(reps)]
    ms = statistics.median(times)
    rec = {"ms_per_gradient": ms, "ms_turns": times,
           "launches": launches, "host_syncs_forward": syncs[0],
           "host_syncs_backward": syncs[1], "naccept_max": nacc,
           "adjoint_steps": ADJ_OPTS["adjoint_steps"],
           "mesh_bytes": mesh_bytes(m, 2, dtype), "peak_bytes": peak,
           "checks": errs}
    if profile:
        prof = mol.profile_solve(lambda wrap: gradient(m, dtype, dev, wrap))
        rec.update(launches_all=prof["launches"], busy_ms=prof["busy_ms"],
                   busy_share=prof["busy_ms"] / ms)
    print(f"[{name}] stiff VdP mu=logspace(1.5,3) rtol 1e-4 kmax 5, the "
          f"forward through K1/K2: gradients finite | {ms:.2f} ms per "
          f"gradient (median of {reps}, CUDA events; "
          f"{[round(x, 2) for x in times]}) | K1 {launches['K1']}, K2 "
          f"{launches['K2']} launches a gradient | host syncs {syncs[0]} "
          f"forward + {syncs[1]} backward | max(naccept) {nacc} of "
          f"{ADJ_OPTS['adjoint_steps']}, mesh {rec['mesh_bytes'] / 1e6:.1f} "
          f"MB, peak {peak / 1e6:.1f} MB"
          + ("" if not profile else
             f" | {rec['launches_all']} launches, device busy "
             f"{rec['busy_ms']:.2f} ms = {rec['busy_share']:.3f} of the "
             f"gradient (torch.profiler)")
          + ("" if errs is None else
             f" | replay vs the recorded mesh {errs['replay']:.3e} (bound "
             f"{REPLAY_BOUND:g}); vs autograd of the frozen replay chain "
             f"{errs['chain']:.3e} (bound 1e-10); d/dmu of lanes 0, M/2, "
             f"M-1 vs central difference: {errs['fd_mu']:.3e} (bound "
             f"{FD_BOUND:g}); 4 lanes vs the CPU: {errs['cpu']:.3e} (bound "
             f"1e-7)"), flush=True)
    return rec


def forward_solve(dev, kernel_lu, mus=None, m=M_FWD):
    """The headline lanes (m of them, or as many as mus) through
    solve_seulex with K=2 IND tangents, unit seeds in y0."""
    dtype = torch.float64
    m = m if mus is None else mus.shape[0]
    y0 = torch.tensor([[2.0, 0.0]], dtype=dtype, device=dev).repeat(m, 1)
    if mus is None:
        mus = torch.full((m,), 1e3, dtype=dtype, device=dev)
    seeds = torch.zeros((2, m, 2), dtype=dtype, device=dev)
    seeds[0, :, 0] = 1.0
    seeds[1, :, 1] = 1.0
    return solve_seulex(vdp_rhs, 0.0, 1.0, y0, mus,
                        Options(kernel_lu=kernel_lu, **FWD_OPTS),
                        jac=vdp_jac, tangents=seeds)


def _eight(m):
    return np.linspace(0, m - 1, 8).round().astype(int)


def forward_phase(dev, smoke=False):
    """K1/K2 on the extrapolation ladder: the kernel_lu solve against the
    plain pivot-free LU on the headline lanes."""
    name = f"seulex forward M={M_FWD} f64 mu=1e3 rtol 1e-6 K=2 IND"
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
        syncs[k] = solve_seulex.host_syncs
        if k and launches is None:
            launches = mol._kernel_launches()
        elif not k and any(mol._kernel_launches().values()):
            raise SeulexCheckFailed(f"{name}: the plain route launched a "
                                    f"kernel: {mol._kernel_launches()}")
        sols[k] = out[0]
    sol_k, sol_p = sols[True], sols[False]
    if launches["K1"] <= 0 or launches["K2"] <= 0:
        raise SeulexCheckFailed(f"{name}: kernel_lu=True did not launch K1 "
                                f"and K2: {launches}")
    for what, sol in (("kernel", sol_k), ("plain", sol_p)):
        if not bool((sol.status == 1).all()):
            raise SeulexCheckFailed(f"{name}: {what} route not SUCCESS on "
                                    "every lane")
    for k in STATS:
        if not torch.equal(sol_k.stats[k], sol_p.stats[k]):
            raise SeulexCheckFailed(f"{name}: counter {k} differs between "
                                    "the routes")
    errs = {}
    for what, bound in (("y", 1e-10), ("sens", 1e-8)):
        got, ref = getattr(sol_k, what), getattr(sol_p, what)
        errs[what] = float((got - ref).abs().max() / ref.abs().max())
        if not errs[what] <= bound:
            raise SeulexCheckFailed(f"{name}: {what} kernel vs plain LU "
                                    f"{errs[what]:.3e} > {bound:g}")
    bitwise = all(torch.equal(getattr(sol_k, w), getattr(sol_p, w))
                  for w in ("t", "y", "sens"))
    mus = _mus(1.0, 3.0, M_FWD, torch.float64, dev)
    sol_h = forward_solve(dev, True, mus=mus)
    if not bool((sol_h.status == 1).all()):
        raise SeulexCheckFailed("seulex heterogeneous mu: not SUCCESS")
    rec = {"launches": launches, "host_syncs": syncs[True],
           "host_syncs_plain": syncs[False],
           "stats_max": {k: int(sol_k.stats[k].max()) for k in STATS},
           "kernel_vs_plain": errs, "bitwise": bitwise,
           "scipy_worst": scipy_worst(
               sol_k.y.cpu().numpy(), np.full(M_FWD, 1e3), _eight(M_FWD),
               SCIPY_BOUND, "seulex", SeulexCheckFailed),
           "scipy_worst_heterogeneous": scipy_worst(
               sol_h.y.cpu().numpy(), mus.cpu().numpy(), _eight(M_FWD),
               SCIPY_BOUND, "seulex", SeulexCheckFailed),
           "stats_max_heterogeneous": {k: int(sol_h.stats[k].max())
                                       for k in STATS},
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
    st = rec["stats_max"]
    print(f"[{name}] every lane SUCCESS, the seven counters equal between "
          f"the routes (max nsteps {st['nsteps']}, naccept {st['naccept']}, "
          f"nlu {st['nlu']}, nfev {st['nfev']}, order {st['order']}) | "
          f"kernel_lu launches K1 {launches['K1']}, K2 {launches['K2']} (K3 "
          f"{launches['K3']}, K4 {launches['K4']}) | host syncs "
          f"{syncs[True]} | s/solve kernel_lu {turns[True]}, plain LU "
          f"{turns[False]} (turns {'K P' if smoke else 'K P P K K P'}; CUDA "
          f"events) | kernel vs plain: y {errs['y']:.1e} (bound 1e-10), sens "
          f"{errs['sens']:.1e} (bound 1e-8), equal to the bit: {bitwise} | "
          f"8 lanes vs scipy Radau worst error / bound "
          f"{rec['scipy_worst']:.3e}; mu=logspace(1,3) "
          f"{rec['scipy_worst_heterogeneous']:.3e}" + extra, flush=True)
    return rec


PHASES = ("forward", "adjoint")


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
    report["seconds"] = seconds
    print("[seulex phase seconds] " + ", ".join(f"{k} {v:.1f}"
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
        print("seulex: no CUDA device", file=sys.stderr)
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
