"""Drive and check ``parallel.lockstep`` on a card: every solver family,
the discrete adjoints and a multiple-shooting Newton, each split over two
processes and held to the one-process solve.

Phase 24 of ``chip_smoke.py`` (``run(dev, smoke=True)``), and a probe of its
own, run from the root of a checkout on a machine with a CUDA card:

    python3 -m janus_tpu_torch.bench.lockstep [--only PHASE ...] [--smoke]
        [--json PATH]

Everything in float64 at full width. Two ranks share the one card: each
joins a gloo process group (``parallel.initialize``; NCCL refuses two ranks
on one card) with its mesh on the host, copies its shard of every input to
the card (``local_shards(..., device=)``), solves it in
``parallel.lockstep`` and gathers the results through the group. The ranks
are spawned once for the whole probe (``infra.start_workers``); they warm
up on the forwards' short spans while this process runs the one-process
solves, then wait for it (a rank's first gradient and Newton iteration
keep their first-call costs). Phases (``PHASES``), each raising ``LockstepCheckFailed`` when
its check fails:
- ``forward``: the family headlines of the probes (``FORWARD``) at 65,536
  lanes, 32,768 a rank: ``bench.rodas``, ``bench.ndf`` (NDF and classic
  BDF), ``bench.seulex`` and ``bench.radaup`` (Van der Pol, t in [0, 1],
  rtol 1e-6, atol 1e-9, K=2 IND tangents, K1/K2 through
  ``kernel_lu=True``), ``bench.dopri`` (dopri5 and dopri853, mu =
  logspace(-1, 0.5), t in [0, 10], rtol 1e-7), ``bench.radaup``'s legacy
  steppers (bdf2 and grk4t on the chip-matrix lanes mu = 10^U(1, 3),
  rtol 1e-4, through K1/K2) and ``radau_fused`` (chip_smoke's phase 9
  options, through K4); where a headline has the one mu = 1e3, the lanes
  take mu = logspace(1, 3), so that their step counts differ (checked:
  naccept is not the same on every lane) and each rank's own gates would
  part. The gathered y, sens, status, naccept and nreject must equal the
  one-process solve to the bit, and each rank's K1/K2 (K4) launches and
  host reads (``common._HostSyncs.reads``) must equal the one-process
  solve's: every rank runs the same loop trips. Each rank's solve seconds
  (host clock after a synchronize, the two ranks solving at once) beside
  the one-process solve's.
- ``adjoint``: the four discrete adjoints' gradients of the probes at
  8,192 lanes, 4,096 a rank (``bench.rodas``, ``.ndf``, ``.seulex``:
  sum(y(T)^2) over mu = logspace(1.5, 3); ``bench.dopri``'s neural ODE,
  its loss summed over the lanes and divided by the whole count) and the
  radaup gradient (``radau_adjoint`` over the orders, mu = logspace(1,
  3)): lambda(t0) = dL/dy0 and each lane's dL/dmu equal to the
  one-process gradient to the bit; the shared parameters' gradients (a
  scale of mu, the network's weights), all-reduced over the ranks, within
  ``SHARED_RTOL`` of the one-process gradient (relative to each leaf's
  largest entry: the sum over the lanes is added in another order); each
  rank's launches and host reads as for the forwards.
- ``newton``: one iteration of ``bench.control``'s multiple-shooting PMP
  Van der Pol Newton (the IND Jacobian through K1/K2) on 2,048 instances,
  1,024 a rank: x, fnorm and iters equal to the one-process iteration to
  the bit, each rank's K1/K2 launches and host reads equal to its.
- ``f5``: in this process, for every ``FORWARD`` family, the first 32,768
  lanes solved alone against those lanes of the 65,536-lane solve, equal
  to the bit (a lane's rounding does not depend on the batch size).

``smoke`` (chip_smoke's phase 24) times each solve once; without it the
one-process solves and the F5 halves run three times and the ranks solve
each case twice (every run's seconds reported).

``--worker RANK WORLD PORT OUTDIR`` is one rank (started by ``run``; the
CPU tests start it with a configuration of their own).
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

M = 65_536
M_ADJ = 8192
M_NEWTON = 2048
RANKS = 2
SHARED_RTOL = 1e-12
PHASES = ("forward", "adjoint", "newton", "f5")
FORWARD = ("rodas", "grk4t", "bdf2", "dopri5", "dopri853", "ndf",
           "bdf_classic", "seulex", "radaup", "radau_fused")
ADJOINT = ("rodas_adjoint", "dopri_adjoint", "ndf_adjoint",
           "seulex_adjoint", "radaup_adjoint")
NEWTON = ("newton",)
# the cases that factor through K1/K2 (kernel_lu=True)
KERNEL_LU = ("rodas", "grk4t", "bdf2", "ndf", "bdf_classic", "seulex",
             "radaup", "ndf_adjoint", "seulex_adjoint", "radaup_adjoint",
             "newton")
F64 = torch.float64


class LockstepCheckFailed(RuntimeError):
    """A phase's check did not hold."""


# ---- the cases -------------------------------------------------------------
#
# A case's inputs are a dict of whole CPU tensors, each with the dimension
# that holds its lanes (sharded over the ranks); ``run(inputs, span)`` solves
# them on the inputs' device and returns (per-lane results, each with its lane
# dimension; the shared leaves' gradients, a list). ``span`` < 1 shortens the
# time span (the ranks' warm-up).

def _logspace(lo, hi, m):
    return torch.logspace(lo, hi, m, dtype=F64)


def _vdp_inputs(m, mus, seeds=True):
    y0 = torch.tensor([[2.0, 0.0]], dtype=F64).repeat(m, 1)
    inp = {"y0": (y0, 0), "mus": (mus, 0)}
    if seeds:
        s = torch.zeros((2, m, 2), dtype=F64)
        s[0, :, 0] = 1.0
        s[1, :, 1] = 1.0
        inp["seeds"] = (s, 1)
    return inp


def _sol_out(sol):
    out = {"y": (sol.y, 0), "status": (sol.status, 0),
           "naccept": (sol.stats["naccept"], 0),
           "nreject": (sol.stats["nreject"], 0)}
    if sol.sens is not None:
        out["sens"] = (sol.sens, 1)
    return out, []


def forward_inputs(name, m):
    """The inputs of a ``FORWARD`` family's headline on m lanes, each lane
    stiff in its own measure: mu = logspace(1, 3) where the headline has
    the one mu = 1e3, so that the lanes take different step counts and
    each rank's own gates would part from the others'."""
    if name in ("dopri5", "dopri853"):
        return _vdp_inputs(m, _logspace(-1.0, 0.5, m), seeds=False)
    if name in ("bdf2", "grk4t"):
        from janus_tpu_torch.bench import radaup as rp
        y0, mus = rp.legacy_inputs(m, F64, "cpu")
        return _vdp_inputs(m, mus, seeds=False)
    return _vdp_inputs(m, _logspace(1.0, 3.0, m),
                       seeds=name != "radau_fused")


def forward_run(name, inp, span=1.0):
    """The family's solve of its headline inputs (on their device)."""
    from janus_tpu_torch.bench import dopri as dp
    from janus_tpu_torch.bench import ndf as nd
    from janus_tpu_torch.bench import radaup as rp
    from janus_tpu_torch.models.problems import vdp_jac, vdp_rhs
    from janus_tpu_torch.solve import Options
    from janus_tpu_torch.solve.dopri import TABLEAUS, solve_erk
    from janus_tpu_torch.solve.ndf import solve_bdf
    from janus_tpu_torch.solve.radau_fused import solve_radau_fused
    from janus_tpu_torch.solve.radaup import solve_radau_vo
    from janus_tpu_torch.solve.rodas import solve_rodas
    from janus_tpu_torch.solve.seulex import solve_seulex

    y0, mus = inp["y0"], inp["mus"]
    seeds = inp.get("seeds")
    kw = dict(jac=vdp_jac, tangents=seeds)
    if name == "rodas":
        sol = solve_rodas(vdp_rhs, 0.0, span, y0, mus, Options(
            rtol=1e-6, atol=1e-9, pivoting=False, kernel_lu=True), **kw)
    elif name in ("dopri5", "dopri853"):
        sol = solve_erk(TABLEAUS[name], vdp_rhs, 0.0, 10.0 * span, y0, mus,
                        Options(**dp.FWD_OPTS))
    elif name in ("bdf2", "grk4t"):
        sol = rp.LEGACY[name](vdp_rhs, 0.0, span, y0, mus, Options(
            kernel_lu=True, **rp.LEGACY_OPTS), jac=vdp_jac)
    elif name in ("ndf", "bdf_classic"):
        sol = solve_bdf(vdp_rhs, 0.0, span, y0, mus, Options(
            kernel_lu=True, **nd.FWD_OPTS), ndf=name == "ndf", **kw)
    elif name == "seulex":
        from janus_tpu_torch.bench import seulex as sx
        sol = solve_seulex(vdp_rhs, 0.0, span, y0, mus, Options(
            kernel_lu=True, **sx.FWD_OPTS), **kw)
    elif name == "radaup":
        sol = solve_radau_vo(vdp_rhs, 0.0, span, y0, mus, Options(
            kernel_lu=True, **rp.FWD_OPTS), **kw)
    elif name == "radau_fused":
        sol = solve_radau_fused(vdp_rhs, 0.0, span, y0, mus,
                                Options(rtol=1e-6, atol=1e-9))
    else:
        raise ValueError(f"no forward case {name!r}")
    return _sol_out(sol)


def adjoint_inputs(name, m, total=None):
    """The inputs of an ``ADJOINT`` gradient on m lanes (``total``: the
    lanes of the whole batch, for the neural ODE's loss scale)."""
    if name == "dopri_adjoint":
        y0 = torch.from_numpy(np.random.default_rng(0).uniform(
            -1.5, 1.5, (m, 2)))
        return {"y0": (y0, 0), "total": (torch.tensor(
            float(m if total is None else total), dtype=F64), None)}
    lo = 1.0 if name == "radaup_adjoint" else 1.5
    return _vdp_inputs(m, _logspace(lo, 3.0, m), seeds=False)


def adjoint_run(name, inp, span=1.0):
    """(dL/dy0, dL/dmu per lane; the shared leaves' gradients)."""
    from janus_tpu_torch.bench import ndf as nd
    from janus_tpu_torch.bench import radaup as rp
    from janus_tpu_torch.bench import rodas as ro
    from janus_tpu_torch.bench import seulex as sx
    from janus_tpu_torch.models.problems import vdp_jac, vdp_rhs
    from janus_tpu_torch.solve import Options, solve_adjoint

    y0 = inp["y0"].detach().clone().requires_grad_()
    if name == "dopri_adjoint":
        return _node_gradient(y0, inp["total"], span)
    mus = inp["mus"].detach().clone().requires_grad_()
    scale = torch.ones((), dtype=F64, device=y0.device, requires_grad=True)
    method, opts = {"rodas_adjoint": ("rodas", ro.ADJ_OPTS),
                    "ndf_adjoint": ("bdf", nd.ADJ_OPTS),
                    "seulex_adjoint": ("seulex", sx.ADJ_OPTS),
                    "radaup_adjoint": ("radaup", rp.ADJ_OPTS)}[name]
    y_end = solve_adjoint(vdp_rhs, (0.0, span), y0, method=method,
                          args=mus * scale, options=Options(**opts),
                          jac=vdp_jac)
    torch.sum(y_end ** 2).backward()
    return {"lam0": (y0.grad, 0), "gmu": (mus.grad, 0)}, [scale.grad]


def _node_gradient(y0, total, span):
    """bench.dopri's neural-ODE gradient: the samples of the true flow
    (dopri5 at rtol 1e-9, each lane's own), the loss summed over the lanes
    and divided by the whole batch's entries."""
    from janus_tpu_torch.bench import dopri as dp
    from janus_tpu_torch.solve import Options
    from janus_tpu_torch.solve.adjoint_dopri import dopri_adjoint
    from janus_tpu_torch.solve.dopri import TABLEAUS, solve_erk

    tf = dp.T_FINAL * span
    ts = torch.linspace(tf / dp.N_SAMPLE, tf, dp.N_SAMPLE, dtype=F64,
                        device=y0.device)
    with torch.no_grad():
        truth = solve_erk(TABLEAUS["dopri5"], dp.true_rhs, 0.0, tf, y0, None,
                          Options(rtol=1e-9, atol=1e-12), t_eval=ts).ys
    params = dp.node_params(F64, y0.device)
    ys = dopri_adjoint(dp.nn_rhs, (0.0, tf), y0, args=params,
                       options=Options(**dp.NODE_OPTS), t_eval=ts)
    loss = torch.sum((ys - truth) ** 2) / (total.to(y0.device)
                                           * dp.N_SAMPLE * 2)
    leaves = params["w"] + params["b"]
    grads = torch.autograd.grad(loss, [y0] + leaves)
    return {"lam0": (grads[0], 0)}, list(grads[1:])


def newton_inputs(name, m):
    from janus_tpu_torch.bench import control as cb
    return {"mu": (cb.mus(m, "cpu"), 0), "z0": (cb.z0(m, "cpu"), 0)}


def newton_run(name, inp, span=1.0):
    """One iteration of the multiple-shooting PMP Newton, the IND Jacobian
    through K1/K2 (``span`` is not used: one iteration is the short run)."""
    from janus_tpu_torch.bench import control as cb
    from janus_tpu_torch.control import newton_solve

    mu = inp["mu"]
    res = newton_solve(cb.ms_residual(mu, True), inp["z0"],
                       tol=cb.NEWTON_TOL, jac=cb.ind_jacobian(mu, True),
                       max_iter=1)
    return {"x": (res.x, 0), "fnorm": (res.fnorm, 0),
            "iters": (res.iters, 0)}, []


def case_kind(name):
    return ("forward" if name in FORWARD else
            "adjoint" if name in ADJOINT else "newton")


def case_inputs(name, m, total=None):
    kind = case_kind(name)
    if kind == "forward":
        return forward_inputs(name, m)
    if kind == "adjoint":
        return adjoint_inputs(name, m, total)
    return newton_inputs(name, m)


def case_run(name, inp, span=1.0):
    return {"forward": forward_run, "adjoint": adjoint_run,
            "newton": newton_run}[case_kind(name)](name, inp, span)


def on(inputs, dev):
    """The whole inputs on dev."""
    return {k: v.to(dev) for k, (v, _) in inputs.items()}


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _launches():
    from janus_tpu_torch.bench.mol import _kernel_launches
    return _kernel_launches()


def _reset():
    from janus_tpu_torch.bench.mol import _reset_kernel_launches
    _reset_kernel_launches()


def timed_run(name, inp, dev):
    """(per-lane results, shared gradients, seconds, counts) of one run on
    dev; the counts are the kernel launches and the host reads of the
    solves (``reads``: equal on every rank in lockstep)."""
    from janus_tpu_torch.solve.common import _HostSyncs

    _sync(dev)
    _reset()
    reads = _HostSyncs.reads
    t0 = time.perf_counter()
    out, shared = case_run(name, inp)
    _sync(dev)
    seconds = time.perf_counter() - t0
    return out, shared, seconds, dict(_launches(),
                                      reads=_HostSyncs.reads - reads)


# ---- the ranks -------------------------------------------------------------

def _shard(inputs, mesh, dev):
    """This rank's rows of each input, on dev (the lane axis split over the
    mesh; scalars as they are)."""
    from janus_tpu_torch.parallel import local_shards, shard_batch

    own = {}
    for k, (v, dim) in inputs.items():
        if dim is None:
            own[k] = v.to(dev)
            continue
        x = local_shards(shard_batch(v.movedim(dim, 0), mesh), device=dev)
        own[k] = x.movedim(0, dim).contiguous()
    return own


def _gather(out, mesh):
    from janus_tpu_torch.parallel import gather
    return {k: gather(v, mesh, dim=dim).numpy() for k, (v, dim) in
            out.items()}


def worker(rank, world, port, outdir):
    """One rank: the cases of ``outdir/config.json`` (``cases``, ``lanes``
    a case, ``device``, ``reps``, ``warmup``) in
    ``parallel.lockstep``, after a warm-up on short spans and the parent's
    ``go`` file; rank 0 writes each case's gathered results and all-reduced
    shared gradients (``<case>.npz``), every rank its record
    (``rank<r>.json``: seconds and kernel launches a case)."""
    import torch.distributed as dist

    from janus_tpu_torch.parallel import initialize, lockstep, make_mesh

    out = Path(outdir)
    cfg = json.loads((out / "config.json").read_text())
    dev = torch.device(cfg["device"])
    initialize(coordinator_address=f"localhost:{port}", num_processes=world,
               process_id=rank, backend="gloo")
    # gloo on the host: NCCL refuses two ranks on one card; the ranks copy
    # their shards to the card and their results back through the host
    mesh = make_mesh(device="cpu")
    t_start = time.perf_counter()
    if cfg["warmup"]:
        # the forwards on short spans: the machinery the gradients and the
        # Newton run too (a Newton iteration is no shorter at a small span)
        for name in [c for c in cfg["cases"] if c in FORWARD]:
            inp = _shard(case_inputs(name, 64 * world), mesh, dev)
            with lockstep(mesh):
                case_run(name, inp, span=cfg["warmup"])
        _sync(dev)
    warm_s = time.perf_counter() - t_start
    deadline = time.monotonic() + 1800
    while not (out / "go").exists():
        if time.monotonic() > deadline:
            raise TimeoutError("the parent never wrote its go file")
        time.sleep(0.05)
    rec = {"rank": rank, "warmup_s": warm_s, "seconds": {}, "launches": {}}
    for name in cfg["cases"]:
        m = cfg["lanes"][name]
        whole = case_inputs(name, m, total=m)
        secs = []
        for _ in range(cfg["reps"]):
            inp = _shard(whole, mesh, dev)
            dist.barrier()
            with lockstep(mesh):
                res, shared, s, launches = timed_run(name, inp, dev)
            secs.append(s)
        rec["seconds"][name] = secs
        rec["launches"][name] = launches
        got = _gather(res, mesh)
        for i, g in enumerate(shared):
            g = g.detach().to("cpu").clone()
            dist.all_reduce(g)
            got[f"shared{i}"] = g.numpy()
        if rank == 0:
            np.savez(out / f"{name}.npz", **got)
    rec["worker_s"] = time.perf_counter() - t_start
    (out / f"rank{rank}.json").write_text(json.dumps(rec))
    dist.barrier()
    dist.destroy_process_group()


def start(outdir, cases, lanes, device, reps=1, warmup=0.0, cmd=None,
          env=None):
    """Write the ranks' configuration and start them (``infra``'s
    start_workers: one process a rank, their output in
    ``outdir/rank<r>.log``); they run once ``outdir/go`` exists."""
    from janus_tpu_torch.bench import infra

    out = Path(outdir)
    (out / "config.json").write_text(json.dumps({
        "cases": list(cases), "lanes": lanes, "device": str(device),
        "reps": reps, "warmup": warmup}))
    if cmd is None:
        cmd = [sys.executable, "-X", "faulthandler", "-m",
               "janus_tpu_torch.bench.lockstep", "--worker"]
    return infra.start_workers(RANKS, out, cmd=cmd, env=env)


def collect(procs, outdir, cases, timeout):
    """Wait for the ranks (after writing ``go``): (each case's gathered
    arrays, each rank's record)."""
    from janus_tpu_torch.bench import infra

    out = Path(outdir)
    (out / "go").write_text("")
    rcs, logs = infra.wait_workers(procs, out, timeout=timeout)
    if any(rcs):
        raise LockstepCheckFailed(f"a rank failed {rcs}:\n" + "\n---\n".join(
            o[-3000:] for o in logs))
    return ({name: dict(np.load(out / f"{name}.npz")) for name in cases},
            [json.loads((out / f"rank{r}.json").read_text())
             for r in range(RANKS)])


def compare(name, got, want, shared_want=()):
    """Raise unless every per-lane array equals the one-process one to the
    bit and each all-reduced shared gradient is within SHARED_RTOL of its
    (relative to the leaf's largest entry); returns the worst such
    relative difference (0 with none)."""
    for k, (v, _) in want.items():
        if not np.array_equal(got[k], v.detach().cpu().numpy()):
            raise LockstepCheckFailed(
                f"{name}: gathered {k} differs from the one-process result, "
                "not equal to the bit")
    worst = 0.0
    for i, w in enumerate(shared_want):
        w = w.detach().cpu().numpy()
        rel = float(np.max(np.abs(got[f"shared{i}"] - w))
                    / max(float(np.max(np.abs(w))), 1e-300))
        if not rel <= SHARED_RTOL:
            raise LockstepCheckFailed(
                f"{name}: shared gradient {i} all-reduced over the ranks "
                f"differs from the one-process gradient by {rel:.3e} > "
                f"{SHARED_RTOL:g} of its largest entry")
        worst = max(worst, rel)
    return worst


def lanes_of(name):
    return {"forward": M, "adjoint": M_ADJ, "newton": M_NEWTON}[
        case_kind(name)]


# ---- the phases --------------------------------------------------------------

def _f5(name, dev, whole_inp, whole_out, reps):
    """The first half of the lanes solved alone against those lanes of the
    whole solve: (equal to the bit, the half's seconds)."""
    half = {k: (v.narrow(dim, 0, v.shape[dim] // RANKS) if dim is not None
                else v, dim) for k, (v, dim) in whole_inp.items()}
    secs = []
    for _ in range(reps):
        out, _, s, _ = timed_run(name, on(half, dev), dev)
        secs.append(s)
    for k, (v, dim) in whole_out.items():
        part = v.narrow(dim, 0, v.shape[dim] // RANKS)
        if not torch.equal(out[k][0], part):
            raise LockstepCheckFailed(
                f"{name} F5: {k} of the first {M // RANKS} lanes solved "
                f"alone differs from those lanes of the {M}-lane solve, not "
                "equal to the bit")
    return secs


def run(dev, only=PHASES, smoke=False):
    """The chosen phases; the ranks run every case of ``forward``,
    ``adjoint`` and ``newton`` in one spawn."""
    import tempfile

    t_phase = time.perf_counter()
    cases = [c for kind, names in (("forward", FORWARD), ("adjoint", ADJOINT),
                                   ("newton", NEWTON))
             if kind in only for c in names]
    if "f5" in only and "forward" not in only:
        f5_only = list(FORWARD)
    else:
        f5_only = []
    reps = 1 if smoke else 3
    report = {"cases": {}}
    # the kernels are built (or loaded) here, before the ranks start
    case_run("rodas", on(case_inputs("rodas", 8), dev), span=1e-3)
    case_run("radau_fused", on(case_inputs("radau_fused", 8), dev),
             span=1e-3)
    with tempfile.TemporaryDirectory(prefix="janus_lockstep_") as out:
        t_ranks = time.perf_counter()
        procs = start(out, cases, {c: lanes_of(c) for c in cases}, dev.type,
                      reps=1 if smoke else 2, warmup=0.01) if cases else []
        try:
            one = {}
            for name in cases + f5_only:
                inp = case_inputs(name, lanes_of(name))
                runs = [timed_run(name, on(inp, dev), dev)
                        for _ in range(reps)]
                res, shared, _, launches = runs[-1]
                one[name] = (inp, res, shared, [r[2] for r in runs],
                             launches)
            f5 = {name: _f5(name, dev, one[name][0], one[name][1], reps)
                  for name in FORWARD if "f5" in only}
            got, recs = collect(procs, out, cases, timeout=900) if cases \
                else ({}, [])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        ranks_wall = time.perf_counter() - t_ranks
    failed = []
    for name in cases:
        inp, res, shared, secs, launches = one[name]
        per_rank = [r["launches"][name] for r in recs]
        problems = []
        try:
            worst = compare(name, got[name], res, shared)
        except LockstepCheckFailed as e:
            worst = None
            problems.append(str(e))
        if name in FORWARD and len(torch.unique(res["naccept"][0])) < 2:
            problems.append(f"{name}: every lane took the same naccept, so "
                            "the ranks' own gates could not part")
        for r, ln in enumerate(per_rank):
            if any(ln[k] != launches[k] for k in ("K1", "K2", "K4",
                                                   "reads")):
                problems.append(
                    f"{name}: rank {r}'s kernel launches and host reads "
                    f"{ln} differ from the one-process solve's {launches}")
        # (the kernels' twins on CPU tensors count no launch)
        on_card = dev.type == "cuda"
        if on_card and name in KERNEL_LU and launches["K1"] * launches[
                "K2"] <= 0:
            problems.append(f"{name}: K1/K2 not launched: {launches}")
        if on_card and name == "radau_fused" and launches["K4"] <= 0:
            problems.append(f"{name}: K4 not launched")
        rec = {"lanes": lanes_of(name), "one_process_s": secs,
               "rank_s": [r["seconds"][name] for r in recs],
               "launches": launches, "rank_launches": per_rank,
               "shared_rel": worst, "failed": problems}
        if name in f5:
            rec["f5_half_s"] = f5[name]
        report["cases"][name] = rec
        failed += problems
        kl = {k: launches[k] for k in ("K1", "K2", "K4") if launches[k]}
        print(f"[lockstep {name} M={lanes_of(name)} f64, {RANKS} ranks] "
              + ("; ".join(problems) if problems else
                 "gathered results equal the one-process solve to the bit"
                 + (f", shared gradient all-reduced within {worst:.2e}"
                    if shared else "")
                 + f" | launches one-process {kl}, host reads "
                 f"{launches['reads']}, every rank equal")
              + f" | rank s {rec['rank_s']} vs one-process {secs} (host "
              "clock, synchronized)"
              + (f" | F5: the first {M // RANKS} lanes alone equal to the "
                 f"bit ({f5[name]} s)" if name in f5 else ""), flush=True)
    for name in f5_only:
        report["cases"][name] = {"f5_half_s": f5[name],
                                 "one_process_s": one[name][3]}
        print(f"[lockstep F5 {name}] the first {M // RANKS} lanes alone "
              "equal to the bit", flush=True)
    report["ranks_wall_s"] = ranks_wall if cases else None
    report["worker_s"] = [r["worker_s"] for r in recs]
    report["warmup_s"] = [r["warmup_s"] for r in recs]
    report["seconds"] = time.perf_counter() - t_phase
    print(f"[lockstep] ranks from start to exit {ranks_wall:.1f} s (each "
          f"warm-up {[round(s, 1) for s in report['warmup_s']]} s, each "
          f"worker {[round(s, 1) for s in report['worker_s']]} s) | phase "
          f"{report['seconds']:.1f} s", flush=True)
    if failed:
        raise LockstepCheckFailed("; ".join(failed))
    return report


def launches_by_family(report, kernel):
    """{case: [each rank's launches of kernel]} for the cases that launched
    it (the kernels line's ``launches_lockstep`` and
    ``launches_sharded``)."""
    return {name: [ln[kernel] for ln in rec["rank_launches"]]
            for name, rec in report["cases"].items()
            if "rank_launches" in rec and rec["launches"][kernel] > 0}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="+", choices=PHASES, default=PHASES)
    ap.add_argument("--smoke", action="store_true",
                    help="chip_smoke's phase 24: each solve timed once")
    ap.add_argument("--json", type=Path, default=None,
                    help="also write the JSON line to this file")
    ap.add_argument("--worker", nargs=4, default=None,
                    metavar=("RANK", "WORLD", "PORT", "OUTDIR"),
                    help="run one rank (started by the probe)")
    a = ap.parse_args(argv)
    if a.worker is not None:
        rank, world, port, outdir = a.worker
        worker(int(rank), int(world), int(port), outdir)
        return 0
    if not torch.cuda.is_available():
        print("lockstep: no CUDA device", file=sys.stderr)
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
