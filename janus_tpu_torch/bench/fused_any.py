"""Drive and check K4 on right-hand sides it has no hand-written functor
for: each f traced into a generated functor (``ops.rhs_codegen``) and run
by ``solve_ivp(..., method='radau_fused')`` on a card.

Phase 25 of ``chip_smoke.py`` (``start`` then ``run(dev, smoke=True,
started=...)``), and a probe of its own, run from the root of a checkout on
a machine with a CUDA card:

    python3 -m janus_tpu_torch.bench.fused_any [--only CASE ...] [--smoke]
        [--json PATH]

Cases (``CASES``; y0 per lane from numpy seeds, stated in ``case_inputs``):
- ``dubins_pmp``: ``models.problems.dubins_pmp_rhs`` (D = 6: sin, cos,
  tanh, a division by an args row), args {'v': 1, 'umax': 1, 'eps': 0.1}
  as scalars, 65,536 lanes, t in [0, 3], rtol 1e-6, atol 1e-9, f64;
- ``hires``: ``hires_rhs`` (D = 8, the Hairer II benchmark), y0 =
  HIRES_Y0 x (1 + 1e-3 u), t in [0, HIRES_TF], rtol 1e-6, atol 1e-10,
  65,536 lanes, f64 (its packed state 55 x 65,536 x 8 B = 28.8 MB);
- at 4,096 lanes, f64: ``ham_vdp`` (``ham.hamiltonian_dynamics`` of
  ``vdp_hamiltonian`` with mu = 10 in a closure, D = 4, t in [0, 1]),
  ``orego`` (D = 3, t in [0, 30], rtol 1e-6, atol 1e-10), ``e5`` (D = 4,
  t in [0, E5_TF], rtol 1e-6, atol 1e-20), ``brusselator`` (D = 2, t in
  [0, 20], rtol 1e-6, atol 1e-9), ``vdp_lambda`` and ``robertson_lambda``
  (lambdas around ``vdp_rhs`` on mu = logspace(1, 3), t in [0, 1], and
  around ``robertson_rhs`` on tf = logspace(-2, 2), which take the
  generated route where the bare functions take the hand-written one);
- ``orego_f32``: orego in float32 at rtol 1e-4, atol 1e-7, 4,096 lanes.

For each case:
- the seconds of one trace of f (``rhs_codegen.lower`` on the card, as
  every solve of a generated f pays it), and that it gives the unit
  ``start`` built;
- K4 one round at max_attempts 1 and 32 from the initial state of all the
  solve's lanes, equal to as many ``_step_ref`` attempts on the card to
  the bit (every flag, counter and value row), each launch's device ms
  beside the twin's ms for the same attempts and the bound of the round's
  work;
- the fused solve at full width: every lane SUCCESS (f32: at least 0.99),
  K4 launched, and (not with ``smoke``) equal to the twin loop
  (``solve_radau_fused_ref``) on the first 4,096 lanes to the bit;
- 8 lanes against scipy's Radau (rtol 1e-10, the lanes' own y0), computed
  in a worker process beside the card's work: |y - ref| <= 1e-4 |ref| +
  ``floor`` (f64; f32 1e-2 |ref| + ``floor``);
- the lambda cases: the solve and the K4 rounds equal to the hand-written
  functor's to the bit, and both K4 times;
- K4's device ms a solve (CUDA events around each K4 call, median of 3;
  one with ``smoke``) and the attempts, beside its bound (``bench.kernels.k4_work`` with the
  generated program's op counts for f and a Jacobian column); the unit's
  registers and spills (ptxas), threads a block, blocks a SM, and the cold
  build seconds (``start`` builds every unit in threads of its own, one
  nvcc each, so that the builds overlap whatever runs meanwhile).

``smoke`` skips the twin loops of whole solves (minutes of host at D = 8:
~0.2 s of host an attempt on the card, 221 attempts for HIRES) and times
one solve a case, not three.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path
import numpy as np
import torch

SUBSET = 4096
SCIPY_LANES = 8


class FusedAnyCheckFailed(RuntimeError):
    pass


def _fail(msg):
    raise FusedAnyCheckFailed(msg)


def _ham_vdp(mu):
    from janus_tpu_torch.ham import core as ham
    from janus_tpu_torch.models.problems import vdp_hamiltonian
    return ham.hamiltonian_dynamics(lambda x, p, a: vdp_hamiltonian(x, p, mu))


@dataclasses.dataclass
class Case:
    m: int
    dim: int
    tf: object              # a number, or "logspace" (per lane)
    rtol: float
    atol: float
    floor: float            # absolute part of the scipy bound
    dtype: torch.dtype = torch.float64


CASES = {
    "dubins_pmp": Case(65536, 6, 3.0, 1e-6, 1e-9, 1e-6),
    "hires": Case(65536, 8, None, 1e-6, 1e-10, 1e-8),
    "ham_vdp": Case(4096, 4, 1.0, 1e-6, 1e-9, 1e-6),
    "orego": Case(4096, 3, 30.0, 1e-6, 1e-10, 1e-6),
    "e5": Case(4096, 4, None, 1e-6, 1e-20, 1e-18),
    "brusselator": Case(4096, 2, 20.0, 1e-6, 1e-9, 1e-6),
    "vdp_lambda": Case(4096, 2, 1.0, 1e-6, 1e-9, 1e-6),
    "robertson_lambda": Case(4096, 3, "logspace", 1e-6, 1e-10, 1e-8),
    "orego_f32": Case(4096, 3, 30.0, 1e-4, 1e-7, 1e-3, torch.float32),
}


def case_f(name):
    """(f, args) of a case; the lambdas are made anew, as a user's are."""
    from janus_tpu_torch.models import problems as P
    if name == "dubins_pmp":
        return P.dubins_pmp_rhs, {"v": 1.0, "umax": 1.0, "eps": 0.1}
    if name == "hires":
        return P.hires_rhs, None
    if name == "ham_vdp":
        return _ham_vdp(10.0), None
    if name in ("orego", "orego_f32"):
        return P.orego_rhs, None
    if name == "e5":
        return P.e5_rhs, None
    if name == "brusselator":
        return P.brusselator_rhs, {"a": 1.0, "b": 3.0}
    if name == "vdp_lambda":
        return (lambda t, y, a: P.vdp_rhs(t, y, a)), "logspace"
    if name == "robertson_lambda":
        return (lambda t, y, a: P.robertson_rhs(t, y, a)), None
    raise KeyError(name)


def case_numpy(name, m):
    """(y0 [m, D], tf: a number or [m], args with numpy leaves) from the
    case's seed."""
    from janus_tpu_torch.models import problems as P
    c = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name) + 17)
    u = rng.random((m, 1))
    if name == "dubins_pmp":
        y0 = np.concatenate([rng.uniform(-1, 1, (m, 2)),
                             rng.uniform(-np.pi, np.pi, (m, 1)),
                             rng.uniform(-1, 1, (m, 3))], 1)
    elif name == "hires":
        y0 = np.asarray(P.HIRES_Y0)[None] * (1 + 1e-3 * u)
    elif name == "ham_vdp":            # y = [p, x]
        y0 = np.concatenate([rng.uniform(0.1, 1.0, (m, 1)), np.zeros((m, 1)),
                             2.0 + 0.1 * rng.standard_normal((m, 1)),
                             np.zeros((m, 1))], 1)
    elif name in ("orego", "orego_f32"):
        y0 = np.asarray(P.OREGO_Y0)[None] * (1 + 1e-3 * u)
    elif name == "e5":
        y0 = np.asarray(P.E5_Y0)[None] * (1 + 1e-3 * u)
    elif name == "brusselator":
        y0 = np.array([[1.5, 3.0]]) * (1 + 0.1 * u)
    elif name == "vdp_lambda":
        y0 = np.tile([2.0, 0.0], (m, 1)) + 0.1 * rng.standard_normal((m, 2))
    else:
        y0 = np.tile([1.0, 0.0, 0.0], (m, 1))
    tf = c.tf
    if name == "hires":
        tf = P.HIRES_TF
    elif name == "e5":
        tf = P.E5_TF
    elif tf == "logspace":
        tf = np.logspace(-2, 2, m)
    args = case_f(name)[1]
    if args == "logspace":
        args = np.logspace(1, 3, m)
    return y0, tf, args


def _to(x, dev, dtype):
    if isinstance(x, dict):
        return {k: _to(v, dev, dtype) for k, v in x.items()}
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x).to(dev, dtype)
    return x


def case_inputs(name, dev, m=None, width=None, dtype=None):
    """(f, args, tf, y0, Options) on dev for the first m lanes of the case
    at width lanes (default: the case's), in dtype (default: the
    case's)."""
    from janus_tpu_torch.solve import Options
    c = CASES[name]
    dtype = c.dtype if dtype is None else dtype
    width = c.m if width is None else width
    y0, tf, args = case_numpy(name, width)
    m = width if m is None else m
    sub = (lambda x: x[:m] if isinstance(x, np.ndarray) else x)
    f = case_f(name)[0]
    args = sub(args) if not isinstance(args, dict) else args
    return (f, _to(args, dev, dtype), _to(sub(tf), dev, dtype),
            _to(y0[:m], dev, dtype), Options(rtol=c.rtol, atol=c.atol))


def f32_twin(name):
    """Whether the case also runs its K4 rounds in float32: the f64 cases
    of the group layout, whose f32 unit is another layout (D = 6: the
    lane layout) or another register budget (D = 8)."""
    from janus_tpu_torch.ops.radau_fused import GROUP_MIN_DIM
    c = CASES[name]
    return c.dtype is torch.float64 and c.dim >= GROUP_MIN_DIM[c.dtype]


# ---- scipy, in a worker -----------------------------------------------------

def scipy_lanes(name, width):
    """y(T) of SCIPY_LANES lanes of width by scipy's Radau at rtol 1e-10 on
    the CPU, f the port's own torch f on [1, D] rows (module-level, for a
    worker)."""
    from scipy.integrate import solve_ivp as scipy_ivp
    y0, tf, args = case_numpy(name, width)
    f = case_f(name)[0]
    lanes = np.linspace(0, width - 1, SCIPY_LANES).round().astype(int)
    out = []
    for i in lanes:
        a = args
        if isinstance(a, np.ndarray):
            a = torch.tensor([a[i]], dtype=torch.float64)
        elif isinstance(a, dict):
            a = {k: v for k, v in a.items()}
        t_end = float(tf[i]) if isinstance(tf, np.ndarray) else float(tf)

        def rhs(t, y, a=a):
            yt = torch.from_numpy(np.asarray(y, np.float64))[None]
            return f(torch.tensor([t], dtype=torch.float64), yt, a)[0].numpy()

        sol = scipy_ivp(rhs, (0.0, t_end), y0[i], method="Radau", rtol=1e-10,
                        atol=min(1e-12, CASES[name].atol * 1e-2))
        out.append((int(i), sol.y[:, -1]))
    return out


# ---- building ---------------------------------------------------------------

def lower_units(names, dev):
    """{name: the case's generated unit} (traced on dev, not built), and
    {name + " float32": its f32 unit} where ``f32_twin``."""
    from janus_tpu_torch.ops import rhs_codegen
    units = {}
    for name in names:
        for key, dtype in ((name, None), (f"{name} float32", torch.float32)):
            if dtype is not None and not f32_twin(name):
                continue
            f, args, _, y0, _ = case_inputs(name, dev, 8, dtype=dtype)
            units[key] = rhs_codegen.lower(f, args, y0.shape[1], y0.dtype,
                                           dev)
    return units


def start(dev, names=None, smoke=True, width=None, launch=True):
    """Trace every case, then (``launch``) start one build thread a unit
    (on a card) and the scipy workers: the state ``run`` takes
    (``started=``). width caps the lanes (a CPU rehearsal)."""
    names = list(CASES) if names is None else list(names)
    widths = {n: min(CASES[n].m, width or CASES[n].m) for n in names}
    t0 = time.perf_counter()
    units = lower_units(names, dev)
    started = {"names": names, "units": units, "threads": [], "errors": {},
               "scipy": {}, "trace_s": time.perf_counter() - t0,
               "widths": widths, "dev": dev}
    if launch:
        launch_builds(started)
    return started


def launch_builds(started):
    """Start the unit builds (one thread and one nvcc each, on a card) and
    the scipy workers of ``start``'s cases."""
    from janus_tpu_torch.bench.cpu_side import Later
    errors = started["errors"]

    def build(name, unit):
        try:
            unit.build()
        except Exception as e:          # reported by run
            errors[name] = e

    if torch.device(started["dev"]).type == "cuda":
        started["threads"] = [
            threading.Thread(target=build, args=(n, u), daemon=True)
            for n, u in started["units"].items()]
    for th in started["threads"]:
        th.start()
    started["scipy"] = {n: Later(scipy_lanes, n, started["widths"][n])
                        for n in started["names"]}


# ---- the checks -------------------------------------------------------------

def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def same_solution(a, b):
    return (torch.equal(a.t, b.t) and torch.equal(a.y, b.y)
            and torch.equal(a.status, b.status)
            and all(torch.equal(a.stats[k], b.stats[k]) for k in a.stats))


def rounds(name, dev, width, f=None, twin=True, dtype=None):
    """K4 at max_attempts 1 and 32 from the initial state of all width
    lanes against the twin on the same card (twin=False: K4 alone), in
    dtype (default: the case's): a record per launch, {attempts,
    max_abs_err, state, ms (K4), plain_ms (the twin's as many attempts),
    work: attempts and Newton trips summed over lanes, bound_ms, bound_by
    (on a card)}."""
    from janus_tpu_torch.bench import kernels as kb
    from janus_tpu_torch.ops import radau_fused as k4
    from janus_tpu_torch.solve import radau_fused as rf
    f0, args, tf, y0, opts = case_inputs(name, dev, width=width,
                                         dtype=dtype)
    f = f0 if f is None else f
    st0, tf_row = rf.initial_state(f, 0.0, tf, y0, args, opts)
    consts = rf.step_consts(opts, y0.dtype)
    rows, treedef = rf.arg_rows(args, st0[0])
    route = k4.kernel_route(f, args, st0) \
        if st0.device.type != "cpu" else None
    m, dim = y0.shape
    at, _ = rf._row_layout(dim)
    out, ref, done, plain_ms = [], st0, 0, 0.0
    for n in (1, 32):
        with _Clock(dev) as plain:
            while twin and done < n:
                ref = rf._step_ref(ref, tf_row, rows, f, treedef, consts)
                done += 1
        plain_ms += plain.ms
        got = st0.clone()
        with _Clock(dev) as kern:
            got = k4.radau5_step(got, tf_row, f, args, consts,
                                 max_attempts=n, route=route)
        rec = {"attempts": n, "max_abs_err": 0.0, "state": got,
               "ms": kern.ms, "plain_ms": plain_ms if twin else None}
        if twin:
            share, _, rec["max_abs_err"] = rf.state_agreement(got, ref, dim)
            if share != 1.0 or not torch.equal(got, ref):
                _fail(f"{name}: K4 at max_attempts {n} differs from "
                      f"_step_ref (flags equal on {share}, max|err| "
                      f"{rec['max_abs_err']:.3e})")
        work = {k: int((got[at[k]] - st0[at[k]]).sum())
                for k in ("nsteps", "nnewton")}
        rec["work"] = work
        if route is not None:
            unit, prob = route.unit, route.problem
            nbytes, ops = kb.k4_work(
                "generated" if unit else prob.functor, dim, y0.dtype, m, 1,
                work["nsteps"], work["nnewton"],
                unit.n_params if unit else len(prob.params),
                unit.f_ops() if unit else None)
            rec["bound_ms"], rec["bound_by"] = kb.bound_ms(nbytes, ops,
                                                           y0.dtype)
        out.append(rec)
    return out


class _Clock:
    """Milliseconds of the block: CUDA events on a card, else the host's
    clock."""

    def __init__(self, dev):
        self.card = torch.device(dev).type == "cuda"

    def __enter__(self):
        if self.card:
            self.a = torch.cuda.Event(enable_timing=True)
            self.b = torch.cuda.Event(enable_timing=True)
            self.a.record()
        else:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.card:
            self.b.record()
            self.b.synchronize()
            self.ms = self.a.elapsed_time(self.b)
        else:
            self.ms = (time.perf_counter() - self.t0) * 1e3


def k4_device(name, dev, f, args, tf, y0, opts, sol, unit, reps=3):
    """K4's ms a solve (CUDA events around each call, median of reps
    solves, each tracing f anew), its launches, and its bound by unit's op
    counts (unit: f's generated unit; None for a hand-written functor)."""
    from janus_tpu_torch.bench import kernels as kb
    runs = [kb.timed_fused_solve(f, 0.0, tf, y0, args, opts)
            for _ in range(reps)]
    if not all(same_solution(r[0], sol) for r in runs):
        _fail(f"{name}: a timed solve differs from solve_ivp's")
    ms = statistics.median(r[2] for r in runs)
    m, dim = y0.shape
    steps, trips = sol.stats["nsteps"], sol.stats["nnewton"]
    f_ops = unit.f_ops() if unit is not None else None
    functor = "generated" if unit is not None else \
        ("vdp" if dim == 2 else "robertson")
    n_params = unit.n_params if unit is not None else (1 if dim == 2 else 3)
    nbytes, ops = kb.k4_work(functor, dim, y0.dtype, m, runs[0][1],
                             int(steps.sum()), int(trips.sum()), n_params,
                             f_ops)
    bms, by = kb.bound_ms(nbytes, ops, y0.dtype)
    return {"ms": ms, "launches": runs[0][1], "bound_ms": bms,
            "bound_by": by, "ops": ops, "rounds": int(steps.max()),
            "attempts": int(steps.sum()), "trips": int(trips.sum())}


def build_facts(unit, dtype):
    """The layout of the unit's K4 instantiation on the current card:
    registers and spills (ptxas), local bytes, threads a lane, lanes a
    block, threads a block, blocks a SM, shared bytes a block, lanes
    resident at once; and its cold build seconds."""
    from janus_tpu_torch.bench.kernels import k4_ptxas
    from janus_tpu_torch.ops import radau_fused as k4
    a = k4.kernel_attributes(None, dtype, unit=unit)
    regs, stack, spill_st, spill_ld = k4_ptxas(unit.ptxas_log())[
        f"generated {str(dtype)[6:]}"]
    return {"registers": regs, "stack_bytes": stack, "spill_stores": spill_st,
            "spill_loads": spill_ld, "local_bytes": a["local_bytes"],
            **{key: a[key] for key in (
                "threads_per_lane", "lanes_per_block", "threads_per_block",
                "blocks_per_sm", "smem_bytes", "resident_lanes")},
            "build_s": unit.build_seconds}


def check_scipy(name, sol, ref):
    c = CASES[name]
    rel = 1e-4 if c.dtype is torch.float64 else 1e-2
    y = sol.y.double().cpu().numpy()
    worst = 0.0
    for i, want in ref:
        bound = rel * np.abs(want) + c.floor
        e = np.abs(y[i] - want)
        if not np.all(e <= bound):
            _fail(f"{name} lane {i}: y {y[i]} vs scipy {want}")
        worst = max(worst, float(np.max(e / bound)))
    return worst


def run_case(name, dev, started, smoke):
    from janus_tpu_torch.ops import radau_fused as k4
    from janus_tpu_torch.ops import rhs_codegen
    from janus_tpu_torch.solve import radau_fused as rf
    from janus_tpu_torch.solve import solve_ivp
    c = CASES[name]
    unit = started["units"].get(name)
    on_card = torch.device(dev).type == "cuda"
    width = started["widths"][name]
    f, args, tf, y0, opts = case_inputs(name, dev, width=width)
    traced = rhs_codegen.lower(f, args, c.dim, c.dtype, y0.device)
    if traced.name != unit.name:
        _fail(f"{name}: a second trace gave unit {traced.name}, the first "
              f"{unit.name}")
    t0 = time.perf_counter()
    k4.reset_launch_counts()
    sol = solve_ivp(f, (0.0, tf), y0, method="radau_fused", args=args,
                    options=opts)
    _sync(dev)
    sec = time.perf_counter() - t0
    launches = k4.radau5_step.launches
    succ = float((sol.status == 1).double().mean())
    if succ < (1.0 if c.dtype is torch.float64 else 0.99):
        _fail(f"{name}: success_fraction {succ}")
    if not torch.isfinite(sol.y).all():
        _fail(f"{name}: non-finite y")
    if on_card and launches <= 0:
        _fail(f"{name}: K4 was not launched")
    rec = {"m": width, "dim": c.dim, "dtype": str(c.dtype)[6:],
           "success": succ, "launches": launches, "solve_s": sec,
           "trace_s": traced.trace_seconds,
           "nsteps_max": int(sol.stats["nsteps"].max()),
           "f_ops": list(unit.f_ops())}
    rd = rounds(name, dev, width)
    rec["rounds_equal"] = [r["attempts"] for r in rd]
    rec["max_abs_err"] = max(r["max_abs_err"] for r in rd)
    rec["round32"] = {k: v for k, v in rd[1].items() if k != "state"}
    if not smoke:
        f_, args_, tf_, y0_, opts_ = case_inputs(name, dev,
                                                 min(SUBSET, width), width)
        a = solve_ivp(f_, (0.0, tf_), y0_, method="radau_fused", args=args_,
                      options=opts_)
        b = rf.solve_radau_fused_ref(f_, 0.0, tf_, y0_, args_, opts_)
        if not same_solution(a, b):
            _fail(f"{name}: the fused solve differs from the twin loop")
        rec["twin_loop_equal"] = True
    if name.endswith("_lambda"):
        from janus_tpu_torch.models import problems as P
        hand = P.vdp_rhs if name == "vdp_lambda" else P.robertson_rhs
        sol_h = solve_ivp(hand, (0.0, tf), y0, method="radau_fused",
                          args=args, options=opts)
        if not same_solution(sol, sol_h):
            _fail(f"{name}: the generated route differs from the "
                  "hand-written functor")
        for got, want in zip(rd, rounds(name, dev, width, hand,
                                        twin=False)):
            if not torch.equal(got["state"], want["state"]):
                _fail(f"{name}: K4 rounds of {got['attempts']} differ "
                      "between the routes")
        rec["hand_written_equal"] = True
        if on_card:
            rec["k4_hand_written"] = k4_device(name, dev, hand, args, tf, y0,
                                               opts, sol_h, None,
                                               1 if smoke else 3)
    if f32_twin(name):
        rd32 = rounds(name, dev, width, dtype=torch.float32)
        rec["f32"] = {"rounds_equal": [r["attempts"] for r in rd32],
                      "max_abs_err": max(r["max_abs_err"] for r in rd32),
                      "round32": {k: v for k, v in rd32[1].items()
                                  if k != "state"}}
        if on_card:
            rec["f32"]["build"] = build_facts(
                started["units"][f"{name} float32"], torch.float32)
    if on_card:
        rec["k4"] = k4_device(name, dev, f, args, tf, y0, opts, sol, unit,
                              1 if smoke else 3)
        rec["build"] = build_facts(unit, c.dtype)
    later = started["scipy"].get(name)
    if later is not None:
        rec["scipy_worst"] = check_scipy(name, sol, later.result())
    return rec


def _line(name, rec):
    r = rec["round32"]
    bound = (f", bound {r['bound_ms']:.5f} ms by {r['bound_by']}"
             if "bound_ms" in r else "")
    parts = [f"[fused_any {name}] M={rec['m']} D={rec['dim']} {rec['dtype']}"
             f": success {rec['success']} launches {rec['launches']} nsteps "
             f"max {rec['nsteps_max']} solve {rec['solve_s']:.3f} s (host; "
             "on a card a trace of f included) | trace of f "
             f"{rec['trace_s']:.3f} s (host, paid by every solve)",
             f"K4 = _step_ref to the bit at max_attempts "
             f"{rec['rounds_equal']} on all {rec['m']} lanes (max|err| "
             f"{rec['max_abs_err']:.3e}; 32 attempts, {r['work']['nsteps']} "
             f"attempt-lanes: K4 {r['ms']:.3f} ms, twin "
             f"{r['plain_ms']:.1f} ms{bound})"]
    if rec.get("twin_loop_equal"):
        parts.append("solve = twin loop to the bit")
    if rec.get("hand_written_equal"):
        parts.append("= hand-written functor to the bit")
    if "k4" in rec:
        k = rec["k4"]
        parts.append(f"K4 {k['ms']:.5f} ms a solve ({k['launches']} "
                     f"launches, {k['attempts']} attempts, {k['rounds']} "
                     f"rounds) bound {k['bound_ms']:.5f} ms by "
                     f"{k['bound_by']} ({k['ops']:.6g} ops; f "
                     f"{rec['f_ops'][0]}, a Jacobian column "
                     f"{rec['f_ops'][1]}), {k['bound_ms'] / k['ms']:.3f} of "
                     "it")
    if "k4_hand_written" in rec:
        parts.append(f"hand-written K4 {rec['k4_hand_written']['ms']:.5f} ms")
    if "build" in rec:
        b = rec["build"]
        parts.append(f"{b['threads_per_lane']} thread(s) a lane, "
                     f"{b['lanes_per_block']} lanes a block "
                     f"({b['threads_per_block']} threads), "
                     f"{b['blocks_per_sm']} blocks a SM, "
                     f"{b['resident_lanes']} lanes resident, "
                     f"{b['registers']} registers, spill stores/loads "
                     f"{b['spill_stores']}/{b['spill_loads']} B, "
                     f"{b['local_bytes']} B local, {b['smem_bytes']} B "
                     f"shared a block, cold build {b['build_s']:.1f} s")
    if "scipy_worst" in rec:
        parts.append(f"{SCIPY_LANES} lanes vs scipy Radau: worst error / "
                     f"bound {rec['scipy_worst']:.3e}")
    if "f32" in rec:
        r32 = rec["f32"]["round32"]
        parts.append(f"float32: K4 = _step_ref to the bit at max_attempts "
                     f"{rec['f32']['rounds_equal']} on all {rec['m']} lanes "
                     f"(32 attempts: K4 {r32['ms']:.3f} ms, twin "
                     f"{r32['plain_ms']:.1f} ms)")
        b = rec["f32"].get("build")
        if b is not None:
            parts.append(f"float32 unit: {b['threads_per_lane']} threads a "
                         f"lane, {b['lanes_per_block']} lanes a block, "
                         f"{b['blocks_per_sm']} blocks a SM, "
                         f"{b['registers']} registers, spill stores/loads "
                         f"{b['spill_stores']}/{b['spill_loads']} B, "
                         f"{b['local_bytes']} B local")
    return " | ".join(parts)


def kernel_record(name, rec):
    """The case's entry of chip_smoke's ``kernels`` line: ms, plain_ms and
    bound_ms of one launch of 32 attempts and the twin's same 32; the
    solve's K4 time and bound beside them."""
    k, r = rec["k4"], rec["round32"]
    return {"name": f"radau5_step (generated: {name})", "route": "cuda",
            "source": "janus_tpu_torch/csrc/radau5_step.cuh + "
                      "ops/rhs_codegen.py",
            "replaces": "janus_tpu/solve/radau_fused.py:170",
            "launches": rec["launches"], "max_abs_err": rec["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "solve_ms": k["ms"],
            "solve_bound_ms": k["bound_ms"], "solve_bound_by": k["bound_by"],
            "trace_s": rec["trace_s"],
            **{key: rec["build"][key] for key in (
                "registers", "spill_stores", "local_bytes",
                "threads_per_lane", "lanes_per_block", "threads_per_block",
                "blocks_per_sm", "smem_bytes", "build_s")},
            **({"float32": {
                "ms": rec["f32"]["round32"]["ms"],
                "plain_ms": rec["f32"]["round32"]["plain_ms"],
                "max_abs_err": rec["f32"]["max_abs_err"],
                **{key: rec["f32"]["build"][key] for key in (
                    "registers", "spill_stores", "local_bytes",
                    "threads_per_lane", "lanes_per_block", "blocks_per_sm",
                    "smem_bytes")}}} if "f32" in rec else {}),
            "shape": f"D={rec['dim']} M={rec['m']} {rec['dtype']}; ms, "
                     "plain_ms, bound_ms: one K4 launch of 32 attempts from "
                     "the initial state of all M lanes and the 32 _step_ref "
                     "attempts it equals to the bit; solve_ms: every K4 "
                     "launch of one solve, launches: that solve's; float32: "
                     "the same 32 attempts by the f32 unit"}


def run(dev, names=None, smoke=False, started=None, width=None):
    """Every case (see the module docstring); returns {case: record}.
    width caps the lanes (a CPU rehearsal)."""
    if started is None:
        started = start(dev, names, smoke, width)
    for th in started["threads"]:
        th.join()
    if started["errors"]:
        _fail("; ".join(f"{n}: build failed: {e}"
                        for n, e in started["errors"].items()))
    report = {"trace_s": started["trace_s"]}
    for name in started["names"]:
        t0 = time.perf_counter()
        rec = report[name] = run_case(name, dev, started, smoke)
        rec["phase_s"] = time.perf_counter() - t0
        print(_line(name, rec), flush=True)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="+", choices=list(CASES),
                    default=list(CASES))
    ap.add_argument("--smoke", action="store_true",
                    help="chip_smoke's phase 25: no twin loops of whole "
                         "solves")
    ap.add_argument("--json", type=Path, default=None,
                    help="also write the JSON line to this file")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fused_any: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    dev = torch.device("cuda:0")
    report = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              **run(dev, a.only, smoke=a.smoke)}
    line = json.dumps(report, default=str)
    if a.json is not None:
        a.json.parent.mkdir(parents=True, exist_ok=True)
        a.json.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
