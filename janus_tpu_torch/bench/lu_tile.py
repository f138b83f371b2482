"""Drive, check and measure K1 and K2 above D = 16 on a card: Radau5 on the
Pleiades problem, whose stage blocks (28 and 56) go through the tile kernel
of K1 (``csrc/smalllu_tile.cu``) and K2's run-time-D kernel.

Chip_smoke's Pleiades check (``run(dev, smoke=True)``), and a probe of its
own, run from the root of a checkout on a machine with a CUDA card:

    python3 -m janus_tpu_torch.bench.lu_tile [--tf T] [--sweep] [--json PATH]

The workload: Pleiades, the 7-body problem of Hairer's non-stiff test set
(Hairer, Norsett & Wanner, Solving ODEs I, II.10; ``pleiades_rhs``, D = 28),
65,536 lanes in float64 from Hairer's initial value, each lane's velocities
scaled by a factor in [0.99, 1.01] (numpy, seed 19), through
``solve_ivp(pleiades_rhs, (0, tf), y0, method="radau5", options=
Options(rtol=1e-6, atol=1e-8, kernel_lu=True, pivoting=False))``. Radau5
factors the real 28 x 28 block and the split-complex 56 x 56 block through
K1 and solves both through K2 (``solve.radau._kernel_lu_factor`` /
``_kernel_lu_solve``). It prints, for tf = 3 (the probe) or 0.5 (the
smoke): seconds a solve (CUDA events around the checked solve, after a
warm-up solve to t = 0.01 on each route; none in the smoke), K1
and K2 launches by D, host syncs, the milliseconds inside K1 and K2 (CUDA
events around every call of either wrapper; the kernels alone, as each
call is one launch on the stream), the same solve with kernel_lu=False (the
plain pivot-free LU) beside it, and the checks: every lane SUCCESS on both
routes; y within rtol 1e-5 of the plain route's (as chip_smoke's phase 4:
one ulp may flip a step decision); 8 lanes within ``scipy_tol(tf)`` of
scipy's DOP853 at rtol 1e-10, atol 1e-12: (1e-7 relative, 1e-8 absolute)
to tf = 0.5, (1e-4, 1e-5) beyond, where the same 8 lanes solved by the
port on the CPU (the twins, the same arithmetic) came within 5.2e-10 and
4.2e-6 absolute (worst error / bound 0.0092 and 0.062; 15 and ~610 steps a
lane). Each failed check raises ``LuTileCheckFailed``.

``--sweep`` times K1 and K3 at ``SWEEP_CASES`` in every geometry the
card takes (``tile_geometries``: threads a lane 8, 16, 32; blocks a SM
1-4; the most lanes a block, and the most in whole 32-byte sectors), each
held to its twin to the bit, beside ``ops.smalllu.tile_geometry``'s pick
(``geometry_sweep``), launching the kernel library directly with the
geometry given.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import torch

M = 65_536
SEED = 19
# Hairer's initial value (Solving ODEs I, II.10): positions x, y, then
# velocities
Q0 = (3.0, 3.0, -1.0, -3.0, 2.0, -2.0, 2.0, 3.0, -3.0, 2.0, 0.0, 0.0, -4.0,
      4.0)
V0 = (0.0, 0.0, 0.0, 0.0, 0.0, 1.75, -1.5, 0.0, 0.0, 0.0, -1.25, 1.0, 0.0,
      0.0)
RTOL, ATOL = 1e-6, 1e-8


def scipy_tol(tf):
    """(relative, absolute) bound of a lane against scipy's DOP853 at tf."""
    return (1e-7, 1e-8) if tf <= 0.5 else (1e-4, 1e-5)


class LuTileCheckFailed(RuntimeError):
    """A check of the Pleiades solve failed."""


def pleiades_y0(m, dev, dtype=torch.float64, seed=SEED):
    """[m, 28]: Hairer's initial value, each lane's velocities scaled by a
    factor drawn uniformly from [0.99, 1.01] with numpy's seed."""
    scale = np.random.default_rng(seed).uniform(0.99, 1.01, m)
    y0 = np.concatenate([np.tile(Q0, (m, 1)),
                         np.asarray(V0)[None] * scale[:, None]], axis=1)
    return torch.from_numpy(y0).to(dev, dtype)


def solve(y0, tf, kernel_lu):
    from janus_tpu_torch.models.problems import pleiades_rhs
    from janus_tpu_torch.solve import Options, solve_ivp
    return solve_ivp(pleiades_rhs, (0.0, tf), y0, method="radau5",
                     options=Options(rtol=RTOL, atol=ATOL, kernel_lu=kernel_lu,
                                     pivoting=False))


@contextlib.contextmanager
def lu_calls():
    """Within: every K1 and K2 call a Radau solve makes (through the names
    ``lu_factor_t`` and ``lu_solve_t`` of ``solve.radau``) counted by D and
    bracketed by CUDA events. Yields {"K1": Counter(D: calls), "K2": ...,
    "marks": [(name, start, end)]}."""
    from janus_tpu_torch.solve import radau
    real = {"K1": radau.lu_factor_t, "K2": radau.lu_solve_t}
    rec = {"K1": Counter(), "K2": Counter(), "marks": []}

    def counted(name):
        def call(first, *rest):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = real[name](first, *rest)
            b.record()
            rec[name][math.isqrt(first.shape[0])] += 1
            rec["marks"].append((name, a, b))
            return out
        return call

    radau.lu_factor_t, radau.lu_solve_t = counted("K1"), counted("K2")
    try:
        yield rec
    finally:
        radau.lu_factor_t, radau.lu_solve_t = real["K1"], real["K2"]


def _rhs_np(t, y):
    """Pleiades in numpy (Hairer's formulas), for scipy."""
    x, z, v = y[:7], y[7:14], y[14:]
    mass = np.arange(1.0, 8.0)
    dx = x[None, :] - x[:, None]
    dz = z[None, :] - z[:, None]
    r3 = (dx * dx + dz * dz + np.eye(7)) ** 1.5
    return np.concatenate([v, (mass * dx / r3).sum(1),
                           (mass * dz / r3).sum(1)])


def scipy_worst(y_got, y0, tf, lanes):
    """Worst |error| / (rtol |ref| + atol) of the given lanes of y_got
    against scipy's DOP853 at rtol 1e-10, atol 1e-12, scipy_tol's bound."""
    from scipy.integrate import solve_ivp as scipy_ivp
    rtol, atol = scipy_tol(tf)
    worst = 0.0
    for i in lanes:
        ref = scipy_ivp(_rhs_np, (0.0, tf), y0[i], method="DOP853",
                        rtol=1e-10, atol=1e-12).y[:, -1]
        worst = max(worst, float(np.max(np.abs(y_got[i] - ref)
                                        / (rtol * np.abs(ref) + atol))))
    return worst


def _timed(fn):
    """(seconds of fn() by CUDA events, its result)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / 1e3, out


def pleiades(dev, tf=3.0, warm_up=True):
    """The Pleiades solve through K1/K2 and through the plain LU, checked;
    returns its record. warm_up: first a solve to t = 0.01 on each route
    (the allocator's and the Jacobian's first uses)."""
    from janus_tpu_torch.ops import _build, smalllu
    from janus_tpu_torch.solve.radau import solve_radau

    _build.load_library()           # the build stays out of the timings
    y0 = pleiades_y0(M, dev)
    for k in (True, False) if warm_up else ():
        solve(y0, 0.01, k)
    torch.cuda.synchronize()
    smalllu.reset_launch_counts()
    with lu_calls() as calls:
        s_kernel, sol = _timed(lambda: solve(y0, tf, True))
    launches = {"K1": smalllu.lu_factor_t.launches,
                "K2": smalllu.lu_solve_t.launches}
    syncs = solve_radau.host_syncs
    inside = {k: sum(a.elapsed_time(b) for n, a, b in calls["marks"]
                     if n == k) for k in ("K1", "K2")}
    s_plain, plain = _timed(lambda: solve(y0, tf, False))
    rec = {"m": M, "tf": tf, "launches": launches,
           "launches_by_d": {k: dict(calls[k]) for k in ("K1", "K2")},
           "host_syncs": syncs, "s_per_solve": s_kernel,
           "s_per_solve_plain": s_plain, "k1_ms": inside["K1"],
           "k2_ms": inside["K2"],
           "naccept_max": int(sol.stats["naccept"].max()),
           "nlu_max": int(sol.stats["nlu"].max())}
    for name, s in (("kernel_lu", sol), ("plain", plain)):
        if not bool((s.status == 1).all()):
            raise LuTileCheckFailed(
                f"Pleiades {name}: {int((s.status != 1).sum())} of {M} lanes "
                "did not reach SUCCESS")
    if set(calls["K1"]) != {28, 56}:
        raise LuTileCheckFailed(f"Pleiades: K1 ran at D = {dict(calls['K1'])}"
                                ", not at 28 and 56")
    ok = torch.allclose(sol.y, plain.y, rtol=1e-5,
                        atol=1e-5 * float(plain.y.abs().max()))
    rec["rel_to_plain"] = float(((sol.y - plain.y).abs()
                                 / plain.y.abs().clamp(min=1e-300)).max())
    if not ok:
        raise LuTileCheckFailed(f"Pleiades: y through K1/K2 and the plain LU "
                                f"differ, max rel {rec['rel_to_plain']:.3e}")
    lanes = np.linspace(0, M - 1, 8).round().astype(int)
    rec["scipy_worst"] = scipy_worst(sol.y.cpu().numpy(), y0.cpu().numpy(),
                                     tf, lanes)
    if not rec["scipy_worst"] <= 1.0:
        raise LuTileCheckFailed(f"Pleiades: 8 lanes against DOP853, worst "
                                f"error / bound {rec['scipy_worst']:.3e}")
    total_ms = s_kernel * 1e3
    print(f"[pleiades radau5] M={M} D=28 (blocks 28, 56) float64 t in [0, "
          f"{tf}] rtol {RTOL} atol {ATOL}: every lane SUCCESS, naccept max "
          f"{rec['naccept_max']}, nlu max {rec['nlu_max']} | K1 launches "
          f"{launches['K1']} (by D {rec['launches_by_d']['K1']}), K2 "
          f"{launches['K2']} (by D {rec['launches_by_d']['K2']}), host syncs "
          f"{syncs} | s/solve kernel_lu {s_kernel:.4f}, plain LU "
          f"{s_plain:.4f} | inside K1 {inside['K1']:.3f} ms, K2 "
          f"{inside['K2']:.3f} ms ({(inside['K1'] + inside['K2']) / total_ms:.4f}"
          f" of the solve) | y vs plain max rel {rec['rel_to_plain']:.3e} | 8"
          f" lanes vs DOP853: worst error / bound {rec['scipy_worst']:.3e}",
          flush=True)
    return rec


def run(dev, smoke=False, tf=None):
    """The Pleiades solve to tf (0.5 with smoke, 3 otherwise); its record.
    The smoke, whose earlier phases paid the first uses, has no warm-up."""
    return pleiades(dev, tf if tf is not None else 0.5 if smoke else 3.0,
                    warm_up=not smoke)


SWEEP_CASES = ((17, torch.float64, False), (24, torch.float64, False),
               (24, torch.float64, True), (28, torch.float64, False),
               (32, torch.float64, False), (56, torch.float64, False),
               (56, torch.float64, True), (24, torch.float32, False),
               (28, torch.float32, False), (56, torch.float32, False))


def _tile_inputs(d, dtype, dev):
    rng = np.random.default_rng(d)
    a = rng.standard_normal((M, d, d)) + max(5.0, 2 * d ** 0.5) * np.eye(d)
    b = rng.standard_normal((M, d))
    return (torch.from_numpy(np.ascontiguousarray(
        a.transpose(1, 2, 0).reshape(d * d, M))).to(dev, dtype),
        torch.from_numpy(np.ascontiguousarray(b.T)).to(dev, dtype))


def _launcher(lib, a_t, b_t, out, fused, geo):
    """A launch of the tile kernel of lib with geometry geo."""
    from janus_tpu_torch.ops.smalllu import _DTYPE_CODE
    d = math.isqrt(a_t.shape[0])

    def launch():
        rc = lib.janus_lu_tile(
            a_t.data_ptr(), b_t.data_ptr() if fused else None,
            out.data_ptr(), d, M, _DTYPE_CODE[a_t.dtype], int(fused),
            geo.threads_per_lane, geo.lanes_per_block, geo.row_stride,
            geo.smem_bytes, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise LuTileCheckFailed(f"tile launch refused {geo}: {rc}")
    return launch


def tile_geometries(d, dtype, fused=False):
    """Every geometry the tile kernel takes at D = d (``ops.smalllu.
    tile_fits``): 8, 16 and 32 threads a lane, 1-4 blocks a SM, the most
    lanes a block, and the most in whole 32-byte sectors."""
    from janus_tpu_torch.ops.smalllu import TileGeometry, tile_fits
    sector = 32 // (torch.finfo(dtype).bits // 8)
    geos = set()
    for g in (8, 16, 32):
        fits = tile_fits(d, dtype, fused, g)
        for nb in {f[0] for f in fits}:
            at = [f for f in fits if f[0] == nb]
            picks = at[-1:] + [f for f in at if f[1] % sector == 0][-1:]
            geos.update(TileGeometry(g, -(-d // g), lanes, nb, rs, smem)
                        for nb, lanes, rs, smem in picks)
    return sorted(geos, key=dataclasses.astuple)


def geometry_sweep(dev, cases=SWEEP_CASES):
    """K1/K3 ms a launch (CUDA events, mean of 10) in every geometry the
    card takes, each equal to its twin to the bit: {case: [(ms, g, lanes,
    blocks a SM)], fastest first}."""
    from janus_tpu_torch.bench.kernels import events_ms
    from janus_tpu_torch.ops import _build, smalllu
    lib = _build.load_library()
    report = {}
    for d, dtype, fused in cases:
        a_t, b_t = _tile_inputs(d, dtype, dev)
        ref = (smalllu.linsolve_fused_ref(a_t, b_t) if fused
               else smalllu.lu_factor_t_ref(a_t))
        rule = smalllu.tile_geometry(d, dtype, fused)
        rows = []
        for geo in tile_geometries(d, dtype, fused):
            out = torch.empty_like(ref)
            launch = _launcher(lib, a_t, b_t, out, fused, geo)
            launch()
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                raise LuTileCheckFailed(f"{geo}: not the twin's bits")
            rows.append((events_ms(launch, 10), geo.threads_per_lane,
                         geo.lanes_per_block, geo.blocks_per_sm))
        rows.sort()
        key = f"{'K3' if fused else 'K1'} D={d} {str(dtype)[6:]}"
        report[key] = {"rule": dataclasses.asdict(rule), "runs": rows}
        print(f"[tile sweep {key}] tile_geometry: {rule.threads_per_lane} "
              f"threads a lane, {rule.lanes_per_block} lanes a block, "
              f"{rule.blocks_per_sm} blocks a SM | ms (threads a lane, lanes"
              " a block, blocks a SM), fastest first: " + ", ".join(
                  f"{ms:.4f} ({g}, {n}, {b})" for ms, g, n, b in rows),
              flush=True)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tf", type=float, default=3.0)
    ap.add_argument("--sweep", action="store_true",
                    help="only the geometry sweep")
    ap.add_argument("--json", type=Path, default=None,
                    help="also write the JSON line to this file")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("lu_tile: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    dev = torch.device("cuda:0")
    report = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    if a.sweep:
        report["sweep"] = geometry_sweep(dev)
    else:
        report["pleiades"] = run(dev, tf=a.tf)
    line = json.dumps(report)
    if a.json is not None:
        a.json.parent.mkdir(parents=True, exist_ok=True)
        a.json.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
