"""K4's group layout (D = 5..8) on a card: how its speed depends on the
blocks a SM it asks registers for, and where an attempt spends its cycles.

For each case, in each dtype where the case's D takes the group layout
(``ops.radau_fused.geometry``), from the initial state of all the case's
lanes:
- blocks: variants of the case's generated unit that differ only in the
  blocks a SM of ``__launch_bounds__`` (2 up to what the block's shared
  memory allows, at most 6), all built in parallel; on each, one launch of
  32 attempts, CUDA events, the median of ``REPS`` (a fresh copy of the
  state each), beside the variant's registers, spills and local bytes
  (ptxas) and the blocks the card keeps resident; every variant's state
  equal to the geometry's own unit's to the bit;
- phases: a variant built with ``JANUS_K4_CLOCKS`` defined, which compiles
  in the header's clock marks (``K4_TICK`` in ``group_attempts``); one
  32-attempt launch on it, and the cycles an attempt of each phase (thread
  0 of every group, summed over groups, divided by the attempts): the
  Jacobian (the dual evaluations and the scratch), the two
  factorizations, the warm start, the stages and right-hand sides of the
  Newton trips, their solves, the rest of each trip (norm, divergence
  test with its pow, update), the error estimate (with f at the new
  point), the controller and the bookkeeping, and the attempt loop
  itself. A mark serializes a little of what ptxas would overlap, so the
  total is a reading of the marked kernel; the shares are the result. The
  unmarked unit's time of the same launch is printed beside it.

Where a case's D keeps the lane layout (D = 5, 6 in float: ``ring5`` and
``dubins_pmp``), the same 32-attempt launch by its unit and by a unit of
the group layout (generated and launched with ``GROUP_MIN_DIM`` lowered to
that D for the probe), the two states equal to the bit: the measurement
behind ``GROUP_MIN_DIM``.

Cases (``CASES``): ``bench.fused_any``'s ``hires`` (D = 8) and
``dubins_pmp`` (D = 6) at 65,536 lanes, and ``ring5``, ``ring7``: the ring
f below at D = 5 and 7, 65,536 lanes, y0 = 0.5 + U(0, 1) from
``np.random.default_rng(D)``, t in [0, 1], rtol 1e-6, atol 1e-9 (f32: 1e-4,
1e-7). Run from the root of a checkout on a machine with a CUDA card:

    python3 -m janus_tpu_torch.bench.k4_layout [--only CASE ...]
        [--json PATH]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import dataclasses
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import torch

PHASES = ("jacobian", "factor", "warm start", "stages", "solves",
          "trip rest", "error estimate", "controller", "loop")
CASES = {"hires": 8, "dubins_pmp": 6, "ring5": 5, "ring7": 7}
M = 65_536
REPS = 5
MAX_BLOCKS = 6
SMEM_PER_SM = 228 * 1024        # csrc/radau5_step.cuh kSmemPerSm
SMEM_RESERVED = 1024            # kSmemPerBlockReserved


def ring(t, y, a):
    """A stiff ring of D components: rates 1 .. 1 + 50 (D - 1), each
    coupled to its two neighbours, forced by sin t."""
    d = y.shape[-1]
    return torch.stack([-(1.0 + 50.0 * i) * y[..., i]
                        + 0.5 * y[..., (i + 1) % d] * y[..., (i - 1) % d]
                        + 0.1 * torch.sin(t) for i in range(d)], dim=-1)


def case_inputs(name, dev, dtype):
    """(f, args, tf, y0, Options) of a case on dev in dtype."""
    from janus_tpu_torch.bench import fused_any
    from janus_tpu_torch.solve import Options
    if name in fused_any.CASES:
        return fused_any.case_inputs(name, dev, dtype=dtype)
    d = CASES[name]
    rng = np.random.default_rng(d)
    y0 = torch.from_numpy(0.5 + rng.random((M, d))).to(dev, dtype)
    f32 = dtype == torch.float32
    return (ring, None, 1.0, y0,
            Options(rtol=1e-4 if f32 else 1e-6, atol=1e-7 if f32 else 1e-9))


def variant(unit, blocks_per_sm=None, clocks=False):
    """The unit with another blocks a SM (its geometry's line rewritten)
    and, with clocks, the header's clock marks compiled in: the same text
    otherwise, under the name of its own hash."""
    from janus_tpu_torch.ops import _build, rhs_codegen
    from janus_tpu_torch.ops.radau_fused import geometry
    src = unit.source.replace(unit.name, rhs_codegen._NAME)
    if blocks_per_sm is not None:
        geo = geometry(unit.dim, unit.dtype)
        old = rhs_codegen.geometry_decl(geo)
        if src.count(old) != 1:
            raise ValueError("k4_layout: not a unit of the group layout")
        src = src.replace(old, rhs_codegen.geometry_decl(
            dataclasses.replace(geo, blocks_per_sm=blocks_per_sm)))
    if clocks:
        src = "#define JANUS_K4_CLOCKS\n" + src
    name = _build.unit_hash(src)
    return dataclasses.replace(unit, name=name,
                               source=src.replace(rhs_codegen._NAME, name),
                               build_seconds=None)


def blocks_range(dim, dtype):
    """The blocks a SM swept: 2 up to what the shared memory allows."""
    from janus_tpu_torch.ops.radau_fused import geometry
    smem = geometry(dim, dtype).smem_bytes + SMEM_RESERVED
    return [b for b in range(2, MAX_BLOCKS + 1) if b * smem <= SMEM_PER_SM]


def _events(fn):
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def group_layout_from(dim, dtype):
    """Where geometry gives the group layout from D = dim in dtype (a
    context for the probe's own units and launches)."""
    from janus_tpu_torch.ops import radau_fused as k4
    return mock.patch.dict(k4.GROUP_MIN_DIM, {dtype: dim})


def prepare(name, dtype, dev):
    """The case's units, unbuilt, and its initial state: in the group
    layout {"unit", "blocks": {b: unit}, "clocks": unit}; in the lane
    layout {"unit", "group": a unit of the group layout}."""
    from janus_tpu_torch.ops import rhs_codegen
    from janus_tpu_torch.ops.radau_fused import geometry
    from janus_tpu_torch.solve import radau_fused as rf
    f, args, tf, y0, opts = case_inputs(name, dev, dtype)
    dim = y0.shape[1]
    unit = rhs_codegen.lower(f, args, dim, dtype, dev)
    st0, tf_row = rf.initial_state(f, 0.0, tf, y0, args, opts)
    c = {"f": f, "args": args, "st0": st0, "tf_row": tf_row,
         "consts": rf.step_consts(opts, dtype),
         "rows": rf.arg_rows(args, st0[0])[0].contiguous(), "unit": unit}
    if geometry(dim, dtype).threads_per_lane == 1:
        with group_layout_from(dim, dtype):
            c["group"] = rhs_codegen.lower(f, args, dim, dtype, dev)
        return c
    own = c["own"] = geometry(dim, dtype).blocks_per_sm
    c["blocks"] = {b: unit if b == own else variant(unit, b)
                   for b in blocks_range(dim, dtype)}
    c["clocks"] = variant(unit, clocks=True)
    return c


def measure(c):
    """The blocks sweep and the phases of one prepared case."""
    from janus_tpu_torch.bench.kernels import k4_ptxas
    from janus_tpu_torch.ops import radau_fused as k4

    def launch(unit, st):
        route = k4.Route(unit=unit, rows=c["rows"])
        return k4.radau5_step(st, c["tf_row"], c["f"], c["args"],
                              c["consts"], 32, route=route)

    def timed(unit):
        launch(unit, c["st0"].clone())
        return statistics.median(
            _events(lambda: launch(unit, c["st0"].clone()))
            for _ in range(REPS))

    ref = launch(c["unit"], c["st0"].clone())
    if "group" in c:                # the lane layout against the group's
        with group_layout_from(c["unit"].dim, c["unit"].dtype):
            if not torch.equal(launch(c["group"], c["st0"].clone()), ref):
                raise RuntimeError("k4_layout: the group layout differs "
                                   "from the lane layout")
            group_ms = timed(c["group"])
        return {"lane_ms": timed(c["unit"]), "group_ms": group_ms}
    dt = str(c["unit"].dtype)[6:]
    sweep = {}
    for b, unit in c["blocks"].items():
        if not torch.equal(launch(unit, c["st0"].clone()), ref):
            raise RuntimeError(f"k4_layout: the variant at {b} blocks a SM "
                               "differs from the geometry's unit")
        a = k4.kernel_attributes(None, c["unit"].dtype, unit=unit)
        regs, _, spill_st, spill_ld = k4_ptxas(unit.ptxas_log())[
            f"generated {dt}"]
        sweep[b] = {"ms": timed(unit), "registers": regs,
                    "spill_stores": spill_st, "spill_loads": spill_ld,
                    "local_bytes": a["local_bytes"],
                    "resident_blocks": a["blocks_per_sm"]}
    read = c["clocks"].library().janus_k4_clocks_read
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    out = (ctypes.c_ulonglong * 16)()
    launch(c["clocks"], c["st0"].clone())   # its first call's setup
    if read(out, 1) != 0:
        raise RuntimeError("k4_layout: reading the clocks failed")
    marked = _events(lambda: launch(c["clocks"], c["st0"].clone()))
    if read(out, 0) != 0:
        raise RuntimeError("k4_layout: reading the clocks failed")
    attempts = int(out[9])
    cyc = {PHASES[i]: out[i] / attempts for i in range(len(PHASES))}
    return {"blocks": sweep, "own_blocks": c["own"],
            "phases": {"cycles": cyc, "attempts": attempts,
                       "ms_marked": marked,
                       "ms_unmarked": sweep[c["own"]]["ms"]}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="+", default=list(CASES),
                    choices=list(CASES))
    ap.add_argument("--json", type=Path, default=None)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k4_layout: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi}",
          flush=True)
    from janus_tpu_torch.ops.radau_fused import geometry
    dev = torch.device("cuda:0")
    cases = {f"{n} {str(dt)[6:]}": prepare(n, dt, dev) for n in a.only
             for dt in (torch.float64, torch.float32)}
    units = {u.name: u for c in cases.values()
             for u in [c["unit"], c.get("group"), c.get("clocks"),
                       *c.get("blocks", {}).values()] if u is not None}
    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        list(pool.map(lambda u: u.build(), units.values()))
    report = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    for key, c in cases.items():
        r = report[key] = measure(c)
        if "group" in c:
            print(f"[k4 lane layout {key}] one 32-attempt launch on {M} "
                  f"lanes (median of {REPS}): the lane layout "
                  f"{r['lane_ms']:.3f} ms, the group layout "
                  f"{r['group_ms']:.3f} ms, equal to the bit", flush=True)
            continue
        print(f"[k4 blocks {key}] one 32-attempt launch on {M} lanes "
              f"(median of {REPS}), by the blocks a SM asked: " + "; ".join(
                  f"{b}: {s['ms']:.3f} ms ({s['registers']} registers, "
                  f"spill stores/loads {s['spill_stores']}/"
                  f"{s['spill_loads']} B, {s['local_bytes']} B local, "
                  f"{s['resident_blocks']} resident)"
                  for b, s in r["blocks"].items())
              + f" | the geometry's {r['own_blocks']}; every state equal "
              "to its unit's to the bit", flush=True)
        p = r["phases"]
        total = sum(p["cycles"].values())
        print(f"[k4 phases {key}] {p['attempts']} attempts: "
              f"{p['ms_unmarked']:.3f} ms unmarked, {p['ms_marked']:.3f} "
              f"ms marked; cycles an attempt {total:.0f}: " + ", ".join(
                  f"{ph} {cy:.0f} ({cy / total:.1%})"
                  for ph, cy in p["cycles"].items()), flush=True)
    line = json.dumps(report)
    if a.json is not None:
        a.json.parent.mkdir(parents=True, exist_ok=True)
        a.json.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
