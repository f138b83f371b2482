"""Drive, check and measure the infrastructure (``parallel``, ``diag``'s
profiler, ``utils``, ``native``, ``config``) and the four examples that use
it on a card.

Phase 22 of ``chip_smoke.py`` (``run(dev, smoke=True)``), and a probe of its
own, run from the root of a checkout on a machine with a CUDA card:

    python3 -m janus_tpu_torch.bench.infra [--only PHASE ...] [--json PATH]

Everything in float64 at full width. Phases (``PHASES``), each raising
``InfraCheckFailed`` when its check fails:
- ``examples``: ``examples.stiff_vdp_batch.main`` at 65,536 lanes (mu =
  logspace(1, 3), Radau5, rtol 1e-8, atol 1e-11, the analytic Jacobian;
  each ``main`` a warm-up and a timed solve) through K1/K2
  (``kernel_lu=True``) and through the plain pivot-free LU, one turn each
  (K P, or K P P K without ``smoke``): every lane SUCCESS, y, status and
  nsteps equal to the bit between the routes, the K1/K2 launches of the
  kernel route's ``main`` (``launches_examples``), trajectories per second.
- ``sharded``: the headline (``bench.py``'s configuration: 65,536 Van der
  Pol lanes, mu = 1e3, Radau9, rtol 1e-6, atol 1e-9, K=2 IND,
  pivoting=False, kernel_lu=True) solved by one process, then split over
  two processes on the one card: each rank joins a gloo process group
  (``parallel.initialize``; NCCL refuses two ranks on one card) with its
  mesh on the host, copies its 32,768 lanes to the card, solves them through
  K1/K2 in ``parallel.lockstep`` and gathers y, sens, status and naccept
  through the group (``parallel.gather``, copies through the host). They
  must equal the one-process solve to the bit. Each rank's K1/K2 launches
  (``launches_sharded``), each rank's solve time (host clock after a
  synchronize, the ranks solving at once) and the two-process wall time
  (start to exit) against the one-process solve. Then
  ``examples.sharded_sweep.main`` on the same group (8,192 lanes a rank,
  its global means by ``all_reduce``).
- ``trace``: ``diag.trace`` around one headline solve through K1/K2 and
  around one on the plain LU with ``qr_fallback=True`` (kernel_lu refuses
  the QR fallback, so only that route runs the fourth span): each trace
  file written; the ``radau.*`` spans' counts per solve, device and host
  time, read from the trace file (``trace_spans``); ``diag.device_memory_stats``'s ``peak_bytes_in_use`` > 0; the host
  cost of one ``record_function`` enter and exit outside a profiler, times
  the spans a solve takes.
- ``train``: ``examples.train_nn_hamiltonian.main`` on the card: the loss
  drop, the held-out error below 0.05, the restored parameters equal to the
  saved ones to the bit (asserted in ``main``), the native library built;
  the example's 400 Adam steps, or ``TRAIN_SMOKE_STEPS`` with ``smoke``
  (held-out error 3.45e-2 on the CPU after 150 steps, 4.95e-2 after 200,
  2.57e-2 after 400).
- ``continuation``: ``examples.learned_continuation.main`` on the card:
  every held-out instance converges and the learned policy takes fewer
  mean steps than the fixed schedule (asserted in ``main``).

``--worker RANK WORLD PORT OUTDIR`` is one rank of the ``sharded`` phase
(started by it).
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from janus_tpu_torch.bench import kernels as kb
from janus_tpu_torch.bench import mol
from janus_tpu_torch.models.problems import vdp_jac, vdp_rhs
from janus_tpu_torch.solve import Options
from janus_tpu_torch.solve.radau import solve_radau

M = 65_536
RANKS = 2
TRAIN_SMOKE_STEPS = 150
SPANS = ("radau.jacobian", "radau.factorize", "radau.qr_fallback",
         "radau.newton")
PHASES = ("examples", "sharded", "trace", "train", "continuation")
_REPO = Path(__file__).resolve().parents[2]


class InfraCheckFailed(RuntimeError):
    """A phase's check did not hold."""


# ---- the headline ----------------------------------------------------------

def headline_inputs(m, dev, mus=None):
    """y0 = (2, 0), mu (default 1e3) and the two unit seeds, [K, M, D]."""
    f64 = torch.float64
    y0 = torch.tensor([[2.0, 0.0]], dtype=f64, device=dev).repeat(m, 1)
    if mus is None:
        mus = torch.full((m,), 1e3, dtype=f64, device=dev)
    seeds = torch.eye(2, dtype=f64, device=dev)[:, None, :].repeat(1, m, 1)
    return y0, mus, seeds


def headline_solve(y0, mus, seeds, kernel_lu, **opt_kw):
    """bench.py's Radau9 + K=2 IND solve."""
    opts = Options(rtol=1e-6, atol=1e-9, pivoting=False, min_stages=5,
                   max_stages=5, kernel_lu=kernel_lu, **opt_kw)
    return solve_radau(vdp_rhs, 0.0, 1.0, y0, args=mus, options=opts,
                       jac=vdp_jac, tangents=seeds)


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def sharded_headline(mesh, m, dev, kernel_lu, mus=None):
    """The m-lane headline split over the mesh's ranks: each rank solves its
    own lanes on ``dev`` in ``parallel.lockstep``, and the results come
    back whole on every rank through the group. Returns ({y, sens, status,
    naccept}, this rank's solve seconds, this rank's K1/K2 launches)."""
    import torch.distributed as dist

    from janus_tpu_torch.parallel import (gather, local_shards, lockstep,
                                          shard_batch)

    y0, mus, seeds = headline_inputs(m, "cpu", mus)
    y0, mus, seeds = local_shards(
        shard_batch((y0, mus, seeds.movedim(1, 0)), mesh), device=dev)
    seeds = seeds.movedim(0, 1).contiguous()
    dist.barrier(group=mesh.get_group())
    _sync(dev)
    mol._reset_kernel_launches()
    t0 = time.perf_counter()
    with lockstep(mesh):
        sol = headline_solve(y0, mus, seeds, kernel_lu)
    _sync(dev)
    seconds = time.perf_counter() - t0
    launches = mol._kernel_launches()
    whole = gather({"y": sol.y, "status": sol.status,
                    "naccept": sol.stats["naccept"]}, mesh)
    whole["sens"] = gather(sol.sens, mesh, dim=1)
    return whole, seconds, launches


def worker(rank, world, port, outdir):
    """One rank of the ``sharded`` phase: the sharded headline through
    K1/K2, then the sharded sweep, on one gloo group; rank 0 writes the
    gathered results, every rank its record."""
    import torch.distributed as dist

    from janus_tpu_torch.examples import sharded_sweep
    from janus_tpu_torch.parallel import initialize, make_mesh

    t_start = time.perf_counter()
    initialize(coordinator_address=f"localhost:{port}", num_processes=world,
               process_id=rank, backend="gloo")
    # gloo on the host: NCCL refuses two ranks on one card, and gloo's own
    # CUDA paths are not used (the ranks copy through the host)
    mesh = make_mesh(device="cpu")
    whole, seconds, launches = sharded_headline(mesh, M, "cuda", True)
    rec = {"rank": rank, "solve_s": seconds, "launches": launches,
           "backend": dist.get_backend()}
    if rank == 0:
        np.savez(Path(outdir) / "gathered.npz",
                 **{k: v.numpy() for k, v in whole.items()})
    t0 = time.perf_counter()
    _, mean_steps, ok = sharded_sweep.main(device="cuda", mesh=mesh)
    rec.update(sweep_s=time.perf_counter() - t0, sweep_mean_steps=mean_steps,
               sweep_ok=ok, worker_s=time.perf_counter() - t_start)
    (Path(outdir) / f"rank{rank}.json").write_text(json.dumps(rec))
    dist.barrier()
    dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_workers(world, outdir, cmd=None, env=None):
    """``world`` rank processes of ``cmd`` (default: this module's
    ``--worker``), each given its rank, ``world``, a free port and
    ``outdir``, its output going to ``outdir/rank<r>.log``; the repository
    is on their path."""
    port = _free_port()
    if cmd is None:
        cmd = [sys.executable, "-X", "faulthandler", "-m",
               "janus_tpu_torch.bench.infra", "--worker"]
    if env is None:
        env = dict(os.environ)
        env["PYTHONPATH"] = str(_REPO) + os.pathsep + env.get("PYTHONPATH",
                                                              "")
    procs = []
    for r in range(world):
        with open(Path(outdir) / f"rank{r}.log", "w") as log:
            procs.append(subprocess.Popen(
                [*cmd, str(r), str(world), str(port), str(outdir)], env=env,
                stdout=log, stderr=subprocess.STDOUT))
    return procs


def wait_workers(procs, outdir, timeout):
    """(return codes, the workers' outputs); kills every worker if they run
    past the timeout."""
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return ([p.returncode for p in procs],
            [(Path(outdir) / f"rank{r}.log").read_text()
             for r in range(len(procs))])


# ---- phases ----------------------------------------------------------------

def examples_phase(dev, smoke=False):
    from janus_tpu_torch.examples import stiff_vdp_batch

    name = f"stiff_vdp_batch M={M} f64 mu=logspace(1,3) Radau5 rtol 1e-8"
    order = (True, False) if smoke else (True, False, False, True)
    outs, secs, launches = {}, {True: [], False: []}, None
    for k in order:
        mol._reset_kernel_launches()
        rep = {}
        outs[k] = stiff_vdp_batch.main(M, device=dev, kernel_lu=k,
                                       report=rep)
        torch.cuda.synchronize()
        secs[k].append(rep["seconds"])
        if k and launches is None:
            launches = mol._kernel_launches()
        elif not k and any(mol._kernel_launches().values()):
            raise InfraCheckFailed(f"{name}: the plain route launched a "
                                   f"kernel: {mol._kernel_launches()}")
    if launches["K1"] <= 0 or launches["K2"] <= 0:
        raise InfraCheckFailed(f"{name}: kernel_lu=True did not launch K1 "
                               f"and K2: {launches}")
    (yk, sk, nk), (yp, sp, np_) = outs[True], outs[False]
    if not bool((sk == 1).all()):
        raise InfraCheckFailed(f"{name}: {int((sk != 1).sum())} lanes not "
                               "SUCCESS")
    for what, a, b in (("y", yk, yp), ("status", sk, sp),
                       ("nsteps", nk, np_)):
        if not torch.equal(a, b):
            raise InfraCheckFailed(f"{name}: {what} differs between the "
                                   "routes, not equal to the bit")
    rate = {k: M / statistics.median(v) for k, v in secs.items()}
    print(f"[{name}] every lane SUCCESS, y, status and nsteps equal to the "
          f"bit between the routes (steps {int(nk.min())}..{int(nk.max())}) "
          f"| kernel_lu launches in main (warm-up + timed solve) K1 "
          f"{launches['K1']}, K2 {launches['K2']} (K3 {launches['K3']}, K4 "
          f"{launches['K4']}) | timed solve s kernel_lu {secs[True]}, plain "
          f"LU {secs[False]} (host clock, synchronized; turns "
          f"{'K P' if smoke else 'K P P K'}) | traj/s kernel_lu "
          f"{rate[True]:,.0f}, plain {rate[False]:,.0f}", flush=True)
    return {"launches": launches, "seconds_kernel": secs[True],
            "seconds_plain": secs[False], "traj_per_s_kernel": rate[True],
            "traj_per_s_plain": rate[False],
            "nsteps_max": int(nk.max())}


def sharded_phase(dev, smoke=False):
    name = (f"sharded headline M={M} f64 mu=1e3 Radau9 K=2 IND through K1/K2,"
            f" {RANKS} processes on one card")
    y0, mus, seeds = headline_inputs(M, dev)
    headline_solve(y0, mus, seeds, True)                  # warm-up
    one_s = []
    for _ in range(1 if smoke else 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = headline_solve(y0, mus, seeds, True)
        torch.cuda.synchronize()
        one_s.append(time.perf_counter() - t0)
    with tempfile.TemporaryDirectory(prefix="janus_infra_") as out:
        t0 = time.perf_counter()
        rcs, logs = wait_workers(start_workers(RANKS, out), out,
                                 timeout=600)
        wall = time.perf_counter() - t0
        if any(rcs):
            raise InfraCheckFailed(f"{name}: a worker failed {rcs}:\n"
                                   + "\n---\n".join(o[-3000:] for o in logs))
        got = dict(np.load(Path(out) / "gathered.npz"))
        recs = [json.loads((Path(out) / f"rank{r}.json").read_text())
                for r in range(RANKS)]
    want = {"y": ref.y, "sens": ref.sens, "status": ref.status,
            "naccept": ref.stats["naccept"]}
    for k, v in want.items():
        if not np.array_equal(got[k], v.cpu().numpy()):
            raise InfraCheckFailed(f"{name}: gathered {k} differs from the "
                                   "one-process solve, not equal to the bit")
    if not bool((ref.status == 1).all()):
        raise InfraCheckFailed(f"{name}: not every lane SUCCESS")
    launches = [r["launches"] for r in recs]
    if any(ln["K1"] <= 0 or ln["K2"] <= 0 for ln in launches):
        raise InfraCheckFailed(f"{name}: a rank did not launch K1 and K2: "
                               f"{launches}")
    if not all(r["sweep_ok"] == 1.0 for r in recs):
        raise InfraCheckFailed(f"{name}: sharded_sweep success "
                               f"{[r['sweep_ok'] for r in recs]}")
    solve_s = [r["solve_s"] for r in recs]
    print(f"[{name}] backend {recs[0]['backend']} (NCCL refuses two ranks on "
          f"one card); y, sens, status, naccept gathered through the group "
          f"equal the one-process solve to the bit | launches per rank K1 "
          f"{[ln['K1'] for ln in launches]}, K2 "
          f"{[ln['K2'] for ln in launches]} | each rank's solve of "
          f"{M // RANKS} lanes {solve_s} s (solving at once), one-process "
          f"solve of {M} lanes {one_s} s (host clock, synchronized) | "
          f"two-process run {wall:.1f} s from start to exit (each worker "
          f"{[round(r['worker_s'], 1) for r in recs]} s inside) | "
          f"sharded_sweep on the same group: {RANKS} x 8192 lanes, success "
          f"{recs[0]['sweep_ok']}, mean steps {recs[0]['sweep_mean_steps']:.3f}"
          f" (every rank {[r['sweep_mean_steps'] for r in recs]}), "
          f"{max(r['sweep_s'] for r in recs):.2f} s", flush=True)
    return {"backend": recs[0]["backend"], "launches": launches,
            "rank_solve_s": solve_s, "one_process_s": one_s,
            "two_process_wall_s": wall,
            "worker_s": [r["worker_s"] for r in recs],
            "sweep_mean_steps": recs[0]["sweep_mean_steps"],
            "sweep_s": [r["sweep_s"] for r in recs]}


def scope_host_us(n=20_000):
    """Host µs of one ``diag.scope`` enter and exit outside a profiler."""
    from janus_tpu_torch import diag
    t0 = time.perf_counter()
    for _ in range(n):
        with diag.scope("radau.newton"):
            pass
    return (time.perf_counter() - t0) / n * 1e6


def trace_spans(path):
    """Per ``radau.*`` span of a Chrome trace written by ``diag.trace``:
    calls, host ms, and the device ms of the kernels, copies and sets
    launched inside it (matched by the trace's correlation ids). Reads the
    file, which is faster than the profiler's own event tree."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    out = {s: {"calls": 0, "device_ms": 0.0, "host_ms": 0.0} for s in SPANS}
    launches, on_card = [], {}
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") == "cuda_runtime" and corr is not None:
            launches.append((e["ts"], corr))
        elif e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            on_card[corr] = on_card.get(corr, 0.0) + e.get("dur", 0.0)
    launches.sort()
    stamps = [ts for ts, _ in launches]
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name") in out:
            rec = out[e["name"]]
            lo = bisect.bisect_left(stamps, e["ts"])
            hi = bisect.bisect_right(stamps, e["ts"] + e["dur"])
            rec["calls"] += 1
            rec["host_ms"] += e["dur"] / 1e3
            rec["device_ms"] += sum(on_card.get(c, 0.0)
                                    for _, c in launches[lo:hi]) / 1e3
    return out


def trace_phase(dev, smoke=False):
    from janus_tpu_torch import diag

    name = f"diag.trace headline M={M} f64 Radau9 K=2 IND"
    y0, mus, seeds = headline_inputs(M, dev)
    headline_solve(y0, mus, seeds, False, qr_fallback=True)   # warm-up
    torch.cuda.reset_peak_memory_stats(dev)
    routes = {"kernel_lu": dict(kernel_lu=True),
              "plain_qr_fallback": dict(kernel_lu=False, qr_fallback=True)}
    rec, files = {}, {}
    with tempfile.TemporaryDirectory(prefix="janus_trace_") as logdir:
        for route, kw in routes.items():
            sub = Path(logdir) / route
            t0 = time.perf_counter()
            with diag.trace(str(sub)):
                sol = headline_solve(y0, mus, seeds, **kw)
            wall = time.perf_counter() - t0
            hits = list(sub.glob("*.pt.trace.json"))
            if not hits:
                raise InfraCheckFailed(f"{name} {route}: no trace file under "
                                       f"{sub}")
            files[route] = hits[0].stat().st_size
            spans = trace_spans(hits[0])
            rec[route] = {"spans": spans, "traced_wall_s": wall,
                          "trace_bytes": files[route],
                          "nsteps_max": int(sol.stats["nsteps"].max())}
    mem = diag.device_memory_stats(dev)
    if not mem.get("peak_bytes_in_use", 0) > 0:
        raise InfraCheckFailed(f"{name}: device_memory_stats has no peak "
                               f"bytes: {sorted(mem)[:8]}")
    k_spans = rec["kernel_lu"]["spans"]
    q_spans = rec["plain_qr_fallback"]["spans"]
    missing = [s for s in SPANS if s != "radau.qr_fallback"
               and k_spans[s]["calls"] == 0] + [
        s for s in SPANS if q_spans[s]["calls"] == 0]
    if missing:
        raise InfraCheckFailed(f"{name}: spans missing from the traces: "
                               f"{missing}")
    us = scope_host_us()
    per_solve = sum(v["calls"] for v in k_spans.values())
    solve_ms = statistics.median(
        kb.events_ms(lambda: headline_solve(y0, mus, seeds, True), 1)
        for _ in range(1 if smoke else 3))
    rec.update(scope_host_us=us, spans_per_solve=per_solve,
               scope_ms_per_solve=us * per_solve / 1e3,
               solve_ms_kernel_lu=solve_ms,
               peak_bytes_in_use=mem["peak_bytes_in_use"])

    def fmt(spans):
        return ", ".join(f"{s[6:]} {v['calls']} calls device "
                         f"{v['device_ms']:.2f} ms host {v['host_ms']:.1f} ms"
                         for s, v in spans.items())

    print(f"[{name}] trace files written ({files['kernel_lu']:,} and "
          f"{files['plain_qr_fallback']:,} bytes) | through K1/K2: "
          f"{fmt(k_spans)} | plain LU with qr_fallback: {fmt(q_spans)} | "
          f"device_memory_stats peak_bytes_in_use {mem['peak_bytes_in_use']:,}"
          f" | record_function enter+exit outside a profiler {us:.2f} us x "
          f"{per_solve} spans a solve = {us * per_solve / 1e3:.3f} ms of a "
          f"{solve_ms:.1f} ms solve (CUDA events) | traced solves "
          f"{rec['kernel_lu']['traced_wall_s']:.1f} / "
          f"{rec['plain_qr_fallback']['traced_wall_s']:.1f} s with the "
          f"trace's export", flush=True)
    return rec


def train_phase(dev, smoke=False):
    from janus_tpu_torch import native
    from janus_tpu_torch.examples import train_nn_hamiltonian

    rep = {}
    with tempfile.TemporaryDirectory(prefix="janus_train_") as work:
        t0 = time.perf_counter()
        train_nn_hamiltonian.main(steps=TRAIN_SMOKE_STEPS if smoke else 400,
                                  workdir=work, device=dev, report=rep)
        torch.cuda.synchronize()
        rep["seconds"] = time.perf_counter() - t0
    rep["native_library"] = native.library_path().name
    print(f"[train_nn_hamiltonian f64 on the card] loss {rep['loss0']:.3e} -> "
          f"{rep['loss']:.3e} ({rep['loss0'] / rep['loss']:.0f}x), held-out "
          f"error {rep['err']:.3e} (bound 0.05), restored parameters equal "
          f"to the saved ones to the bit | native library "
          f"{rep['native_library']} built with g++ | {rep['seconds']:.1f} s",
          flush=True)
    return rep


def continuation_phase(dev, smoke=False):
    from janus_tpu_torch.examples import learned_continuation

    t0 = time.perf_counter()
    r_fixed, r_react, r_ml = learned_continuation.main(device=dev)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    steps = {k: float(r.iters.double().mean()) for k, r in
             (("fixed", r_fixed), ("reactive", r_react), ("learned", r_ml))}
    conv = {k: int(r.converged.sum()) for k, r in
            (("fixed", r_fixed), ("reactive", r_react), ("learned", r_ml))}
    print(f"[learned_continuation on the card] converged {conv} of 16, mean "
          f"steps {steps}: the learned policy beats the fixed schedule | "
          f"{sec:.1f} s", flush=True)
    return {"mean_steps": steps, "converged": conv, "seconds": sec}


_PHASE_FNS = {"examples": examples_phase, "sharded": sharded_phase,
              "trace": trace_phase, "train": train_phase,
              "continuation": continuation_phase}


def run(dev, only=PHASES, smoke=False):
    """Run the named phases in order; returns their records with the seconds
    each took under ``"seconds"``."""
    report, seconds = {}, {}
    for phase in PHASES:
        if phase in only:
            t0 = time.perf_counter()
            report[phase] = _PHASE_FNS[phase](dev, smoke=smoke)
            torch.cuda.synchronize()
            seconds[phase] = time.perf_counter() - t0
    report["seconds"] = seconds
    print("[infra phase seconds] " + ", ".join(
        f"{k} {v:.1f}" for k, v in seconds.items()), flush=True)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="+", choices=PHASES, default=PHASES)
    ap.add_argument("--json", type=Path, default=None,
                    help="also write the JSON line to this file")
    ap.add_argument("--smoke", action="store_true",
                    help="chip_smoke's phase 22: one turn a route")
    ap.add_argument("--worker", nargs=4, default=None,
                    metavar=("RANK", "WORLD", "PORT", "OUTDIR"),
                    help="run one rank of the sharded phase")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("infra: no CUDA device", file=sys.stderr)
        return 2
    if a.worker is not None:
        rank, world, port, outdir = a.worker
        worker(int(rank), int(world), int(port), outdir)
        return 0
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
