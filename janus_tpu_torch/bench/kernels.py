"""Time, bound and compare the port's CUDA kernels on a card.

Helpers shared with ``chip_smoke.py`` (timing by CUDA events and by
torch.profiler, each kernel's least time on the card, the K4 operation count,
warp efficiency of per-lane counters, a fused solve with events around each
call of the K4 wrapper) and a probe, run from the root of a checkout on a
machine with a CUDA card and nvcc:

    python3 -m janus_tpu_torch.bench.kernels [--parent DIR] [--reps N]
        [--skip-lu] [--skip-k4] [--k4-only] [--tile-only] [--radau-lu
        [--pairs N] [--no-launches]] [--json PATH]

It prints, one line each:
- K1-K3 against the PyTorch call that computes the same function
  (``torch.linalg.lu_factor(pivot=False)``, ``lu_solve``, and the pivoted
  ``torch.linalg.solve``), D in ``LU_DIMS`` = {2, 4, 8, 12, 16, 17, 24, 28,
  32, 56} (8: the split-complex blocks of a D = 4 system; 28 and 56: the
  Pleiades blocks; K1/K3 above ``MAX_UNROLLED_D`` the tile kernels), M =
  65,536, f64 and f32: wall time by CUDA events and device time by
  torch.profiler of each, and the bound; K1 and K3 also in both forms
  (tile and unrolled) at ``SWITCH_DIMS`` = 9-16, either side of the
  switch, by device time. With ``--parent DIR``, K1 and K3 at the sweep's
  D above 8 in the checkout at DIR and in this one, each side a process of
  its own running ``--tile-only``, in turns (parent, this, this, parent);
- pow(x, e) built with and without FMA contraction against PyTorch's, on
  2^25 inputs at K4's exponents (csrc/pow_fmad.cu);
- K4 in whole fused solves (VdP mu = 1e3 headline, 65,536 and 4 x 65,536
  lanes, heterogeneous mu, Robertson, f32; and through generated functors
  ``bench.fused_any``'s dubins_pmp, D = 6, and HIRES, D = 8, at 65,536
  lanes in f64, f traced anew every solve): the run's counters, the warp
  efficiency, the bound, and K4's time per solve, kernels alone by
  torch.profiler and by CUDA events around the wrapper calls. With
  ``--parent DIR`` the K4 of the checkout at DIR is timed the same way,
  through its own ``solve_ivp``, in a process of its own started there, in
  turns with this one (parent, this, this, parent);
then one JSON line with all of it, also written to ``--json PATH`` if
given. ``--radau-lu`` measures instead the Radau9 headline on the plain
batched LU (``linalg.smalllu``; ``radau_lu_times``), with ``--parent`` in
``--pairs N`` pairs of turns, the first side alternating, each turn a
process of its own.

Peaks (NVIDIA H100 SXM data sheet, 700 W): 3.35 TB/s of HBM3, 34 TFLOP/s
f64 and 67 TFLOP/s f32 outside the tensor cores.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float64: 34e12, torch.float32: 67e12}
M = 65_536


def events_ms(fn, reps):
    """Mean milliseconds of fn over reps calls, by CUDA events (the host's
    share included where the device waits for it)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps, kernel=""):
    """Mean device milliseconds of fn over reps calls after one more: the
    kernels (whose name holds ``kernel``), copies and sets torch.profiler
    records on the card. None if it records none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and kernel in e.name)
    return us / 1e3 / reps if us > 0 else None


def bound_ms(nbytes, ops, dtype):
    """(least milliseconds the card could take, "bytes" or "operations")."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---- K1-K3 -----------------------------------------------------------------

def lu_work(name, d, m, dtype):
    """(bytes, operations) of K1 / K2 / K3 on m matrices of size d: each
    input read once and each output written once; every +, -, *, / one
    operation (the code of csrc/smalllu.cu)."""
    size = torch.finfo(dtype).bits // 8
    factor = sum(r + 2 * r * r for r in range(d))     # divide, then updates
    solve = 2 * d * (d - 1) + d
    if name == "lu_factor_t":
        return 2 * d * d * m * size, factor * m
    if name == "lu_solve_t":
        return (d * d + 2 * d) * m * size, solve * m
    # K3: a reciprocal per pivot, b eliminated with the rows, then the back
    # substitution
    return (d * d + 2 * d) * m * size, (factor + 2 * d * d) * m


def library_call(name, a_t, b_t, lu_t):
    """The PyTorch call computing what kernel `name` computes, on the AoS
    [M, D, D] / [M, D, 1] copies of its SoA inputs (made here, untimed)."""
    d = b_t.shape[0]
    a = a_t.T.reshape(-1, d, d).contiguous()
    b = b_t.T.reshape(-1, d, 1).contiguous()
    if name == "lu_factor_t":
        return lambda: torch.linalg.lu_factor(a, pivot=False)
    if name == "lu_solve_t":
        lu = lu_t.T.reshape(-1, d, d).contiguous()
        piv = torch.arange(1, d + 1, dtype=torch.int32,
                           device=a.device).expand(a.shape[0], d).contiguous()
        return lambda: torch.linalg.lu_solve(lu, piv, b)
    return lambda: torch.linalg.solve(a, b)       # pivoted


def lu_inputs(rng, d, m, dtype, dev):
    """SoA a_t [D*D, M] (diagonally dominant) and b_t [D, M] on dev."""
    import numpy as np
    a = rng.standard_normal((m, d, d)) + 5.0 * np.eye(d)
    b = rng.standard_normal((m, d))
    a_t = torch.from_numpy(np.ascontiguousarray(
        a.transpose(1, 2, 0).reshape(d * d, m))).to(dev, dtype)
    b_t = torch.from_numpy(np.ascontiguousarray(b.T)).to(dev, dtype)
    return a_t, b_t


LU_DIMS = (2, 4, 8, 12, 16, 17, 24, 28, 32, 56)
# D either side of the K1/K3 switch (ops.smalllu.MAX_UNROLLED_D), where
# both forms are timed
SWITCH_DIMS = (9, 10, 11, 12, 13, 14, 15, 16)
DTYPES = (torch.float64, torch.float32)


def lu_table(dev, reps=50):
    """K1-K3 and their library calls at D in LU_DIMS, M = 65,536, f64/f32
    (D = 8: the split-complex blocks of a D = 4 system; 28 and 56 the
    Pleiades blocks of bench.lu_tile; K1/K3 above MAX_UNROLLED_D the tile
    kernels)."""
    import numpy as np
    from janus_tpu_torch.ops import smalllu
    rng = np.random.default_rng(0)
    rows = []
    for dtype in DTYPES:
        for d in LU_DIMS:
            a_t, b_t = lu_inputs(rng, d, M, dtype, dev)
            lu_t = smalllu.lu_factor_t(a_t)
            kern = {"lu_factor_t": lambda: smalllu.lu_factor_t(a_t),
                    "lu_solve_t": lambda: smalllu.lu_solve_t(lu_t, b_t),
                    "linsolve_fused": lambda: smalllu.linsolve_fused(a_t,
                                                                     b_t)}
            for name, fn in kern.items():
                lib = library_call(name, a_t, b_t, lu_t)
                nbytes, ops = lu_work(name, d, M, dtype)
                bms, by = bound_ms(nbytes, ops, dtype)
                try:
                    lib_ms = events_ms(lib, reps)
                    lib_dev = device_ms(lib, reps)
                except RuntimeError as e:     # the library refuses the case
                    print(f"[lu] {name} D={d}: library call failed: {e}")
                    lib_ms = lib_dev = None
                del lib
                row = {"kernel": name, "d": d, "m": M,
                       "dtype": str(dtype).replace("torch.", ""),
                       "ms": events_ms(fn, reps),
                       "device_ms": device_ms(fn, reps),
                       "library_ms": lib_ms, "library_device_ms": lib_dev,
                       "bound_ms": bms, "bound_by": by}
                rows.append(row)
                print(f"[lu] {name} D={d} M={M} {row['dtype']}: kernel "
                      f"{row['ms']:.5f} ms (device {_ms(row['device_ms'])})"
                      f" | library {_ms(lib_ms)} (device "
                      f"{_ms(lib_dev)}) | bound "
                      f"{bms:.5f} ms by {by}", flush=True)
            del a_t, b_t, lu_t
    return rows


def switch_table(dev, reps=20):
    """K1 and K3 in both forms (the tile kernel and the one instantiated
    for D, ``ops.smalllu._tile`` / ``_unrolled``) at SWITCH_DIMS, M =
    65,536, f64/f32: device ms of each, where MAX_UNROLLED_D is chosen."""
    import numpy as np
    from janus_tpu_torch.ops import smalllu
    rng = np.random.default_rng(0)
    rows = []
    for dtype in DTYPES:
        for d in SWITCH_DIMS:
            a_t, b_t = lu_inputs(rng, d, M, dtype, dev)
            for name, args in (("lu_factor_t", (a_t,)),
                               ("linsolve_fused", (a_t, b_t))):
                ms = {form.__name__.strip("_"): device_ms(
                    lambda: form(*args), reps)
                    for form in (smalllu._tile, smalllu._unrolled)}
                rows.append({"kernel": name, "d": d,
                             "dtype": str(dtype).replace("torch.", ""),
                             "device_ms": ms})
                print(f"[lu switch] {name} D={d} M={M} {rows[-1]['dtype']}:"
                      f" device tile {_ms(ms['tile'])}, unrolled "
                      f"{_ms(ms['unrolled'])}", flush=True)
    return rows


def tile_rows(dev, reps=20):
    """K1 and K3 through their wrappers at LU_DIMS above 8, M = 65,536,
    f64/f32: device ms each (``--tile-only``, the child of ``lu_against``,
    which runs this file in another checkout)."""
    import numpy as np
    from janus_tpu_torch.ops import smalllu
    rng = np.random.default_rng(0)
    rows = []
    for dtype in DTYPES:
        for d in (d for d in LU_DIMS if d > 8):
            a_t, b_t = lu_inputs(rng, d, M, dtype, dev)
            for name, fn in (("lu_factor_t", lambda: smalllu.lu_factor_t(a_t)),
                             ("linsolve_fused",
                              lambda: smalllu.linsolve_fused(a_t, b_t))):
                rows.append({"kernel": name, "d": d,
                             "dtype": str(dtype).replace("torch.", ""),
                             "device_ms": device_ms(fn, reps)})
    return rows


def lu_against(parent: Path, reps):
    """K1 and K3 of this checkout against the one at parent at LU_DIMS above
    8, f64 and f32, each side a process of its own in turns (parent, this,
    this, parent): {"this": [rows, rows], "parent": [...]}, and one line a
    (kernel, D, dtype) with each side's device ms."""
    here = Path(__file__).resolve().parents[2]
    runs = {"parent": [], "this": []}
    for side in ("parent", "this", "this", "parent"):
        runs[side].append(in_checkout(parent if side == "parent" else here,
                                      ["--tile-only"], reps))
    for row in runs["this"][0]:
        key = (row["kernel"], row["d"], row["dtype"])
        dev_ms = {side: [r["device_ms"] for rs in runs[side] for r in rs
                         if (r["kernel"], r["d"], r["dtype"]) == key]
                  for side in runs}
        print(f"[lu vs parent] {key[0]} D={key[1]} {key[2]}: device ms this "
              + ", ".join(_ms(x) for x in dev_ms["this"]) + "; parent "
              + ", ".join(_ms(x) for x in dev_ms["parent"]), flush=True)
    return runs


def _ms(x):
    return "not measured" if x is None else f"{x:.5f} ms"


# ---- K4 ----------------------------------------------------------------------

# operations of one f evaluation and of one forward-mode Jacobian column
# (csrc/problems.cuh on T and on Dual<T>, dual.cuh)
F_OPS = {"vdp": (5, 13), "robertson": (7, 18)}


def _lu_factor_ops(n):
    """factor_rows of csrc/radau5_step.cuh: a reciprocal per pivot, then a
    multiply per multiplier and two operations per update."""
    return n + sum(r + 2 * r * r for r in range(n))


def _lu_solve_ops(n):
    return 2 * n * (n - 1) + n


def k4_ops(functor, dim, f_ops=None):
    """Operations of K4 (csrc/radau5_step.cuh, read line by line) as
    (per attempt, per Newton trip): an attempt with n trips does
    ``attempt + n * trip``. Convention: +, -, *, /, sqrt and pow are one
    operation each; negation, fabs, comparisons, min/max and selects none;
    the warm start, the Newton update and the write-back are counted as if
    taken. The first trip of an attempt skips the 8 operations of the
    convergence-rate tests, which ``attempt`` already subtracts. Also the
    divides, square roots and pows among them, (per attempt, per trip).
    f_ops: (one f, one Jacobian column) of a generated functor
    (``rhs_codegen.Unit.f_ops``, the IR's count) in place of F_OPS."""
    f, fj = f_ops if f_ops is not None else F_OPS[functor]
    d = dim
    attempt = (1 + 3 + d * fj + 2 * d * d                  # h, mu/h, J, fill
               + _lu_factor_ops(d) + _lu_factor_ops(2 * d)  # factors
               + 9 + 33 * d + 15 * d + 2 * d                # warm start, scale
               + 10 * d + 2 * _lu_solve_ops(d) + 2 * (3 * d + 2)
               + 2 * d + f                                  # error estimates
               + 10                                         # controller
               + 1 + f                                      # f at t + h
               + 5 + 15 * d + 7                             # bookkeeping
               - 8)                                         # first trip
    trip = (6 + 3 * d + 3 * f + 15 * d + 2 * d + 10 * d
            + _lu_solve_ops(d) + _lu_solve_ops(2 * d)
            + 9 * d + 2 + 8 + 18 * d + 1)
    return {"attempt": attempt, "trip": trip, "divides": (8 + 8 * d, 8 * d + 4),
            "sqrts": (2, 1), "pows": (1, 1)}


def k4_work(functor, dim, dtype, m, launches, attempts, trips, n_params,
            f_ops=None):
    """(bytes, operations) of K4 over a run: every launch reads and writes
    each lane's packed state once and reads its tf and parameters; the
    operations of ``k4_ops`` for the attempts and Newton trips the run's
    counters record (sums over lanes)."""
    size = torch.finfo(dtype).bits // 8
    rows = 5 * dim + 15
    nbytes = launches * m * (2 * rows + 1 + n_params) * size
    k = k4_ops(functor, dim, f_ops)
    return nbytes, attempts * k["attempt"] + trips * k["trip"]


def warp_efficiency(counts):
    """sum(counts) / (32 * sum over warps of the warp's largest count), the
    warps being 32 consecutive lanes: 1.0 when every lane of a warp does as
    much as its slowest."""
    c = counts.double()
    pad = (-c.numel()) % 32
    w = torch.cat([c, c.new_zeros(pad)]).reshape(-1, 32)
    return float(c.sum() / (32 * w.max(dim=1).values.sum()))


def timed_fused_solve(f, t0, tf, y0, args, options):
    """solve_radau_fused's host loop with CUDA events around each call of
    the K4 wrapper ``ops.radau_fused.radau5_step`` (f routed, and traced if
    need be, before the first event): (Solution, K4 launches, K4
    milliseconds summed over them)."""
    from janus_tpu_torch.ops.radau_fused import kernel_route, radau5_step
    from janus_tpu_torch.solve import radau_fused as rf

    marks, route = [], []

    def step(st, tf_row, consts):
        if not route:
            route.append(kernel_route(f, args, st))
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        st = radau5_step(st, tf_row, f, args, consts,
                         max_attempts=rf.MAX_ATTEMPTS, route=route[0])
        b.record()
        marks.append((a, b))
        return st

    sol, _ = rf._solve(f, t0, tf, y0, args, options, step)
    torch.cuda.synchronize()
    return sol, len(marks), sum(a.elapsed_time(b) for a, b in marks)


def k4_cells(dev):
    """name -> (f, t0, tf, y0, args, Options) of the K4 probe's solves."""
    from janus_tpu_torch.models.problems import robertson_rhs, vdp_rhs
    from janus_tpu_torch.solve import Options

    def vdp(m, dtype, mus=None):
        y0 = torch.tensor([[2.0, 0.0]], dtype=dtype, device=dev).repeat(m, 1)
        mus = mus if mus is not None else torch.full((m,), 1e3, dtype=dtype,
                                                     device=dev)
        return y0, mus

    f64 = torch.float64
    opts = Options(rtol=1e-6, atol=1e-9)
    cells = {}
    y0, mus = vdp(M, f64)
    cells["headline"] = (vdp_rhs, 0.0, 1.0, y0, mus, opts)
    y0, mus = vdp(4 * M, f64)
    cells["4x65536"] = (vdp_rhs, 0.0, 1.0, y0, mus, opts)
    y0, mus = vdp(M, f64, torch.logspace(1, 3, M, dtype=f64, device=dev))
    cells["hetero_mu"] = (vdp_rhs, 0.0, 1.0, y0, mus, opts)
    y0 = torch.tensor([[1.0, 0.0, 0.0]], dtype=f64, device=dev).repeat(M, 1)
    tf = torch.logspace(-2, 2, M, dtype=f64, device=dev)
    cells["robertson"] = (robertson_rhs, 0.0, tf, y0, None,
                          Options(rtol=1e-6, atol=1e-10))
    y0, mus = vdp(M, torch.float32)
    cells["f32"] = (vdp_rhs, 0.0, 1.0, y0, mus,
                    Options(rtol=1e-4, atol=1e-7))
    from janus_tpu_torch.bench import fused_any
    for name in ("dubins_pmp", "hires"):
        f, args, tf, y0, o = fused_any.case_inputs(name, dev)
        cells[name] = (f, 0.0, tf, y0, args, o)
    return cells


_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_PROPS = re.compile(r"Function properties for (\S+)")
_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def k4_ptxas(log):
    """{instantiation: (registers, stack frame bytes, spill store bytes,
    spill load bytes)} of radau5_step_kernel (or, at D = 5..8 of a
    generated unit, radau5_group_kernel) in a ptxas -v report (the lines of
    the kernel's own entry; a called function has its own)."""
    out, entry, props = {}, None, None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            sym, entry = m.group(1), None
            kern = next((k for k in ("radau5_step_kernel",
                                     "radau5_group_kernel") if k in sym),
                        None)
            if kern is not None:
                dt = "float64" if f"{kern}Id" in sym else "float32"
                prob = ("robertson" if "Robertson" in sym else
                        "generated" if "GeneratedRhs" in sym else "vdp")
                entry = (sym, f"{prob} {dt}")
                out[entry[1]] = [None, 0, 0, 0]
            continue
        m = _PROPS.search(line)
        if m:
            props = m.group(1)
            continue
        if entry is None:
            continue
        m = _SPILL.search(line)
        if m and props == entry[0]:
            out[entry[1]][1:] = [int(g) for g in m.groups()]
        m = _REGS.search(line)
        if m:
            out[entry[1]][0] = int(m.group(1))
            entry = None
    return {k: tuple(v) for k, v in out.items()}


def k4_times(dev, reps=3):
    """K4 in whole fused solves of each ``k4_cells`` cell, through the
    public entry point of the package on sys.path (so an earlier checkout's
    is measured the same way): {cell: counts, bound, K4 kernel ms per solve
    (torch.profiler, the kernels alone, mean of reps) and K4 ms per solve by
    CUDA events around the wrapper calls (median of reps)}."""
    from janus_tpu_torch.models.problems import DEVICE_PROBLEMS
    from janus_tpu_torch.ops import rhs_codegen
    from janus_tpu_torch.solve import solve_ivp

    report = {}
    for cell, (f, t0, tf, y0, args, opts) in k4_cells(dev).items():
        ref, launches, _ = timed_fused_solve(f, t0, tf, y0, args, opts)
        events = statistics.median(
            timed_fused_solve(f, t0, tf, y0, args, opts)[2]
            for _ in range(reps))
        kernel = device_ms(lambda: solve_ivp(
            f, (t0, tf), y0, method="radau_fused", args=args,
            options=opts), reps, "radau5_")
        m, dim = y0.shape
        problem = DEVICE_PROBLEMS.get(f)
        attempts = int(ref.stats["nsteps"].sum())
        trips = int(ref.stats["nnewton"].sum())
        if problem is not None:
            nbytes, ops = k4_work(problem.functor, dim, y0.dtype, m,
                                  launches, attempts, trips,
                                  len(problem.params))
        else:                       # a generated functor: its op counts
            unit = rhs_codegen.lower(f, args, dim, y0.dtype, dev)
            nbytes, ops = k4_work("generated", dim, y0.dtype, m, launches,
                                  attempts, trips, unit.n_params,
                                  unit.f_ops())
        bms, by = bound_ms(nbytes, ops, y0.dtype)
        c = report[cell] = {
            "m": m, "launches": launches, "attempts": attempts,
            "trips": trips, "rounds": int(ref.stats["nsteps"].max()),
            "success": float((ref.status == 1).double().mean()),
            "warp_efficiency_attempts": warp_efficiency(ref.stats["nsteps"]),
            "warp_efficiency_trips": warp_efficiency(ref.stats["nnewton"]),
            "bound_ms": bms, "bound_by": by, "kernel_ms": kernel,
            "events_ms": events}
        print(f"[k4 {cell}] M={m} launches {launches} rounds {c['rounds']} "
              f"success {c['success']} warp efficiency attempts "
              f"{c['warp_efficiency_attempts']:.4f} trips "
              f"{c['warp_efficiency_trips']:.4f} | bound {bms:.5f} ms by "
              f"{by} | K4 per solve: kernels alone {_ms(kernel)} "
              f"(profiler), {events:.5f} ms by events around the wrapper",
              flush=True)
    return report


def k4_against(dev, parent: Path, reps):
    """This checkout's K4 against the one at parent, on one card, in turns
    (parent, this, this, parent): {"this": [report, report], "parent":
    [...]}, and one line per cell with each side's mean of its runs."""
    runs = {"parent": [in_checkout(parent, ["--k4-only"], reps)],
            "this": []}
    runs["this"] += [k4_times(dev, reps), k4_times(dev, reps)]
    runs["parent"].append(in_checkout(parent, ["--k4-only"], reps))
    for cell in runs["this"][0]:
        mean = {side: {key: statistics.fmean(r[cell][key] for r in rs)
                       for key in ("kernel_ms", "events_ms")}
                for side, rs in runs.items()}
        print(f"[k4 vs parent {cell}] K4 ms per solve, kernels alone "
              f"(profiler): this {mean['this']['kernel_ms']:.5f} (runs "
              + ", ".join(f"{r[cell]['kernel_ms']:.5f}" for r in runs["this"])
              + f"), parent {mean['parent']['kernel_ms']:.5f} (runs "
              + ", ".join(f"{r[cell]['kernel_ms']:.5f}"
                          for r in runs["parent"])
              + f"), ratio {mean['this']['kernel_ms'] / mean['parent']['kernel_ms']:.4f}"
              f" | by events: this {mean['this']['events_ms']:.5f}, parent "
              f"{mean['parent']['events_ms']:.5f}", flush=True)
    return runs


def radau_lu_times(dev, reps=3, launches=True):
    """The Radau9 headline on the plain LU (chip_smoke's phase 4 without
    kernel_lu: 65,536 VdP lanes, mu = 1e3, t in [0, 1], rtol 1e-6, atol
    1e-9, pivoting=False, analytic Jacobian, K=2 IND) through the package on
    sys.path: s per solve (CUDA events, median of reps after a warm-up), its
    host syncs and, if launches, the launches of one more solve (kernels,
    copies and sets under torch.profiler; None otherwise)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from janus_tpu_torch.models.problems import vdp_jac, vdp_rhs
    from janus_tpu_torch.solve import Options
    from janus_tpu_torch.solve.radau import solve_radau

    f64 = torch.float64
    y0 = torch.tensor([[2.0, 0.0]], dtype=f64, device=dev).repeat(M, 1)
    mus = torch.full((M,), 1e3, dtype=f64, device=dev)
    seeds = torch.zeros((2, M, 2), dtype=f64, device=dev)
    seeds[0, :, 0] = 1.0
    seeds[1, :, 1] = 1.0
    opts = Options(rtol=1e-6, atol=1e-9, pivoting=False, min_stages=5,
                   max_stages=5)

    def solve():
        return solve_radau(vdp_rhs, 0.0, 1.0, y0, args=mus, options=opts,
                           jac=vdp_jac, tangents=seeds)

    sol = solve()
    torch.cuda.synchronize()
    syncs = solve_radau.host_syncs
    runs = [events_ms(solve, 1) / 1e3 for _ in range(reps)]
    if launches:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            solve()
            torch.cuda.synchronize()
        launches = sum(1 for e in prof.events()
                       if e.device_type == DeviceType.CUDA
                       and not e.name.startswith("radau."))
    return {"s_per_solve": statistics.median(runs), "runs": runs,
            "launches": launches or None, "host_syncs": syncs,
            "success": float((sol.status == 1).double().mean())}


def in_checkout(checkout: Path, flags, reps):
    """The ``--k4-only``, ``--tile-only`` or ``--radau-lu`` report of the
    package in another checkout (an earlier commit), in a process of its
    own started there, with this file. flags: the probe's flags, a list."""
    code = ("import runpy, sys; sys.path.insert(0, '.'); sys.argv = "
            f"['kernels', *{flags!r}, '--reps', '{reps}']; "
            f"runpy.run_path({str(Path(__file__).resolve())!r}, "
            "run_name='__main__')")
    res = subprocess.run([sys.executable, "-c", code], cwd=checkout,
                         capture_output=True, text=True, timeout=1500)
    if res.returncode != 0:
        raise RuntimeError(f"{flags} probe in {checkout} failed:\n"
                           f"{res.stdout}\n{res.stderr}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def radau_lu_against(parent: Path, reps, pairs):
    """The plain-LU headline of this checkout against the one at parent:
    pairs of turns, the first side alternating (parent, this), (this,
    parent), ..., each turn a process of its own, the launches counted in
    the first pair only; one line per turn as it ends: {"this": [report,
    ...], "parent": [...], "wins": pairs this won}."""
    here = Path(__file__).resolve().parents[2]
    runs = {"parent": [], "this": []}
    wins = 0
    for i in range(pairs):
        for side in (("parent", "this") if i % 2 == 0 else ("this", "parent")):
            flags = ["--radau-lu"] + ([] if i == 0 else ["--no-launches"])
            r = in_checkout(parent if side == "parent" else here, flags, reps)
            runs[side].append(r)
            print(f"[radau9 plain LU turn] pair {i} {side}: s per solve "
                  f"{r['s_per_solve']:.4f} (runs {r['runs']}), launches "
                  f"{r['launches']}", flush=True)
        wins += runs["this"][-1]["s_per_solve"] < \
            runs["parent"][-1]["s_per_solve"]
    s_this, s_par = ([r["s_per_solve"] for r in runs[k]]
                     for k in ("this", "parent"))
    q = statistics.quantiles(s_par, n=4) if len(s_par) > 1 else [0, 0, 0]
    print(f"[radau9 plain LU vs parent] M=65536, {pairs} pairs, s per solve "
          f"(median of {reps} each turn, CUDA events): this "
          + ", ".join(f"{x:.4f}" for x in s_this) + "; parent "
          + ", ".join(f"{x:.4f}" for x in s_par)
          + f" | medians this {statistics.median(s_this):.4f}, parent "
          f"{statistics.median(s_par):.4f}, parent's interquartile "
          f"{q[2] - q[0]:.4f}; this faster in {wins} of {pairs} pairs | "
          f"launches this {runs['this'][0]['launches']}, parent "
          f"{runs['parent'][0]['launches']} | host syncs this "
          f"{runs['this'][0]['host_syncs']}, parent "
          f"{runs['parent'][0]['host_syncs']}", flush=True)
    return {**runs, "wins": wins}


_POW_SRC = r"""
template <typename T>
__global__ void pow_kernel(const T* x, T e, T* y, long n) {
  long i = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (i < n) y[i] = pow(x[i], e);
}
extern "C" int pow_f64(const double* x, double e, double* y, long n) {
  pow_kernel<double><<<(n + 255) / 256, 256>>>(x, e, y, n);
  return cudaDeviceSynchronize();
}
extern "C" int pow_f32(const float* x, float e, float* y, long n) {
  pow_kernel<float><<<(n + 255) / 256, 256>>>(x, e, y, n);
  return cudaDeviceSynchronize();
}
"""


def pow_agreement(dev, n=1 << 25):
    """How often pow(x, e) built with -fmad=false and with -fmad=true
    differs from PyTorch's ``x ** e`` and ``torch.pow(x, tensor e)`` on the
    card, for x = exp(U(-20, 20)) (seeded) and K4's exponents: {dtype: {e:
    {build: (differ from x ** e, differ from pow(x, tensor))}}}."""
    import ctypes
    from janus_tpu_torch.ops import _build

    src = _build.BUILD_DIR / "pow_check.cu"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(_POW_SRC)
    libs = {}
    for fmad in ("false", "true"):
        out = _build.BUILD_DIR / f"pow_check_fmad_{fmad}.so"
        subprocess.run([_build.find_nvcc(), *_build.ARCH_FLAGS, "-O3",
                        f"-fmad={fmad}", "-Xcompiler", "-fPIC", "-shared",
                        "-o", str(out), str(src)], check=True)
        lib = ctypes.CDLL(str(out))
        vp = ctypes.c_void_p
        lib.pow_f64.argtypes = [vp, ctypes.c_double, vp, ctypes.c_long]
        lib.pow_f32.argtypes = [vp, ctypes.c_float, vp, ctypes.c_long]
        libs[f"fmad={fmad}"] = lib
    gen = torch.Generator(device=dev).manual_seed(0)
    report = {}
    for dtype in (torch.float64, torch.float32):
        x = torch.exp(torch.empty(n, device=dev, dtype=dtype).uniform_(
            -20, 20, generator=gen))
        rows = report[str(dtype).replace("torch.", "")] = {}
        for e in (0.25, -0.25, 5.0, 4.0, 3.0, 2.0):
            by_scalar, by_tensor = x ** e, torch.pow(x, torch.full_like(x, e))
            rows[e] = {}
            for name, lib in libs.items():
                y = torch.empty_like(x)
                fn = lib.pow_f64 if dtype == torch.float64 else lib.pow_f32
                fn(x.data_ptr(), e, y.data_ptr(), n)
                rows[e][name] = (int((y != by_scalar).sum()),
                                 int((y != by_tensor).sum()))
            print(f"[pow] {dtype} e={e}: of {n} inputs, differing from x ** e"
                  f" / from pow(x, tensor e): " + ", ".join(
                      f"{k} {a} / {b}" for k, (a, b) in rows[e].items()),
                  flush=True)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of an earlier commit; its K4 is timed "
                         "through its own entry point, in turns with this")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--pairs", type=int, default=2,
                    help="--radau-lu --parent: pairs of turns")
    ap.add_argument("--no-launches", action="store_true",
                    help="--radau-lu: skip the profiled solve")
    ap.add_argument("--skip-lu", action="store_true")
    ap.add_argument("--skip-k4", action="store_true",
                    help="no pow check and no K4 solves")
    ap.add_argument("--k4-only", action="store_true",
                    help="only the K4 solves; the last line is their report")
    ap.add_argument("--tile-only", action="store_true",
                    help="only K1 and K3 at LU_DIMS above 8, no library "
                         "call (--parent's child); the last line is their "
                         "rows")
    ap.add_argument("--radau-lu", action="store_true",
                    help="only the plain-LU Radau9 headline (in turns with "
                         "--parent, if given); the last line is its report")
    ap.add_argument("--json", type=Path, default=None,
                    help="also write the JSON line to this file")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernels: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    if a.k4_only:
        print(json.dumps(k4_times(dev, a.reps)))
        return 0
    if a.tile_only:
        print(json.dumps(tile_rows(dev)))
        return 0
    if a.radau_lu and a.parent is None:
        print(json.dumps(radau_lu_times(dev, a.reps, not a.no_launches)))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    report = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    if a.radau_lu:
        report["radau_lu"] = radau_lu_against(a.parent, a.reps, a.pairs)
        return _emit(report, a.json)
    if not a.skip_lu:
        report["lu"] = lu_table(dev)
        report["lu_switch"] = switch_table(dev)
        if a.parent:
            report["lu_vs_parent"] = lu_against(a.parent, a.reps)
    if not a.skip_k4:
        report["pow"] = pow_agreement(dev)
        report["k4"] = (k4_against(dev, a.parent, a.reps) if a.parent
                        else k4_times(dev, a.reps))
    return _emit(report, a.json)


def _emit(report, path):
    """Print the report as the last line, and write it to path if given."""
    line = json.dumps(report)
    if path is not None:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
