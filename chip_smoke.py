#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (janus_tpu_torch) on one NVIDIA GPU.

Usage, from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases, one line each (everything is made from fixed seeds):
1. device: torch's name for the card and nvidia-smi's name and power limit;
2. build: compiles the CUDA kernels from janus_tpu_torch/csrc (first use);
3. kernels: K1 (lu_factor_t) and K2 (lu_solve_t) against their plain torch
   twins on the card, M = 65,536 and a ragged 700, D in {2, 4, 3, 6}; f64 at
   rtol 1e-12 and f32 at rtol 1e-5, each relative to the largest entry of
   the twin's result (FMA contraction and one reordering per elimination
   step); each kernel's time next to its twin's (CUDA events);
4. headline f64: bench.py's configuration through the port -- 65,536 stiff
   Van der Pol lanes (mu = 1e3, t in [0, 1]), Radau IIA s=5, rtol 1e-6,
   atol 1e-9, pivot-free stage LU through K1/K2, analytic Jacobian, K = 2
   IND sensitivities; the kernels' launch counts and host syncs of that run,
   seconds per solve (median of 3 after a warm-up); the same with
   kernel_lu=False (plain torch LU), whose y and sens must agree within
   rtol 1e-5 (10x the solve's rtol: an ulp of FMA difference may flip one
   step decision);
5. heterogeneous mu = logspace(1, 3, 65536) through solve_ivp('radau9'):
   8 lanes against scipy's Radau at rtol 1e-10 (within 1e-4 relative plus
   1e-6 absolute);
6. headline f32 with compensated accumulation: finite, success >= 0.99.

Then one JSON line with the kernels' records, nvidia-smi's line, and last
{"ok": true, "device": {...}}. Any failed check raises; no phase's failure
is caught. Without a CUDA device, or without the package beside this
script, it exits non-zero before printing any result.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

M = 65_536


def _fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _events_ms(fn, reps):
    """Mean device milliseconds of fn over reps calls, by CUDA events."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _solve_seconds(fn):
    """Median seconds of 3 calls of fn (CUDA events), after fn ran once."""
    return statistics.median(_events_ms(fn, 1) / 1e3 for _ in range(3))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "janus_tpu_torch")):
        print("chip_smoke: janus_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, here)

    from janus_tpu_torch.models.problems import vdp_jac, vdp_rhs
    from janus_tpu_torch.ops import _build, smalllu
    from janus_tpu_torch.solve import Options, solve_ivp
    from janus_tpu_torch.solve.radau import solve_radau

    dev = torch.device("cuda:0")

    # ---- 1. device ---------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"[device] {kind} | nvidia-smi: {smi} | torch {torch.__version__}"
          f" cuda {torch.version.cuda} | count {torch.cuda.device_count()}",
          flush=True)

    # ---- 2. build ----------------------------------------------------------
    t_b = time.perf_counter()
    _build.load_library()
    print(f"[build] K1/K2 from janus_tpu_torch/csrc/smalllu.cu with "
          f"{' '.join(_build.ARCH_FLAGS)}: {time.perf_counter() - t_b:.2f} s",
          flush=True)

    # ---- 3. kernels against their twins ------------------------------------
    rng = np.random.default_rng(0)
    err = {"K1": {}, "K2": {}}
    times = {}
    for dtype, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        for m in (M, 700):
            for d in (2, 4, 3, 6):
                a = rng.standard_normal((m, d, d)) + 5.0 * np.eye(d)
                b = rng.standard_normal((m, d))
                a_t = torch.from_numpy(
                    np.ascontiguousarray(a.transpose(1, 2, 0).reshape(d * d, m))
                ).to(dev, dtype)
                b_t = torch.from_numpy(np.ascontiguousarray(b.T)).to(dev, dtype)
                lu_ref = smalllu.lu_factor_t_ref(a_t)
                x_ref = smalllu.lu_solve_t_ref(lu_ref, b_t)
                lu_k = smalllu.lu_factor_t(a_t)
                x_k = smalllu.lu_solve_t(lu_ref, b_t)
                torch.cuda.synchronize()
                for name, got, ref in (("K1", lu_k, lu_ref), ("K2", x_k, x_ref)):
                    e = float((got - ref).abs().max())
                    scale = float(ref.abs().max())
                    if not e <= rtol * scale:
                        _fail(f"{name} D={d} M={m} {dtype}: max|err| {e:.3e} "
                              f"> {rtol:g} * {scale:.3e}")
                    key = str(dtype).replace("torch.", "")
                    err[name][key] = max(err[name].get(key, 0.0), e)
                if m == M and d in (2, 4):
                    k1 = _events_ms(lambda: smalllu.lu_factor_t(a_t), 50)
                    k1p = _events_ms(lambda: smalllu.lu_factor_t_ref(a_t), 50)
                    k2 = _events_ms(lambda: smalllu.lu_solve_t(lu_ref, b_t), 50)
                    k2p = _events_ms(
                        lambda: smalllu.lu_solve_t_ref(lu_ref, b_t), 50)
                    times[(dtype, d)] = (k1, k1p, k2, k2p)
                    print(f"[kernels] D={d} M={m} {dtype}: K1 {k1:.4f} ms "
                          f"(twin {k1p:.4f}), K2 {k2:.4f} ms (twin {k2p:.4f})",
                          flush=True)
    print(f"[kernels] agree with twins: max|err| K1 {err['K1']}, "
          f"K2 {err['K2']}", flush=True)

    # ---- 4. headline, f64 --------------------------------------------------
    def headline(dtype, kernel_lu, compensated=False):
        y0 = torch.tensor([[2.0, 0.0]], dtype=dtype, device=dev).repeat(M, 1)
        mus = torch.full((M,), 1e3, dtype=dtype, device=dev)
        seeds = torch.zeros((2, M, 2), dtype=dtype, device=dev)
        seeds[0, :, 0] = 1.0
        seeds[1, :, 1] = 1.0
        opts = Options(rtol=1e-6, atol=1e-9, pivoting=False,
                       compensated=compensated, min_stages=5, max_stages=5,
                       kernel_lu=kernel_lu)
        return solve_radau(vdp_rhs, 0.0, 1.0, y0, args=mus, options=opts,
                           jac=vdp_jac, tangents=seeds)

    def fractions(sol):
        st = sol.stats
        success = float((sol.status == 1).double().mean())
        accept = float((st["naccept"].double()
                        / st["nsteps"].clamp(min=1).double()).mean())
        return success, accept

    torch.cuda.synchronize()
    smalllu.reset_launch_counts()
    sol_k = headline(torch.float64, True)
    torch.cuda.synchronize()
    launches = {"K1": smalllu.lu_factor_t.launches,
                "K2": smalllu.lu_solve_t.launches}
    syncs = solve_radau.host_syncs
    succ, acc = fractions(sol_k)
    if succ != 1.0:
        _fail(f"f64 headline success_fraction {succ} != 1.0")
    if min(launches.values()) <= 0:
        _fail(f"a kernel was not launched on the main path: {launches}")
    if not (torch.isfinite(sol_k.y).all() and torch.isfinite(sol_k.sens).all()):
        _fail("f64 headline: non-finite y or sens")
    sec_k = _solve_seconds(lambda: headline(torch.float64, True))

    sol_p = headline(torch.float64, False)
    sec_p = _solve_seconds(lambda: headline(torch.float64, False))
    for name, got, ref in (("y", sol_k.y, sol_p.y),
                           ("sens", sol_k.sens, sol_p.sens)):
        if not torch.allclose(got, ref, rtol=1e-5,
                              atol=1e-5 * float(ref.abs().max())):
            e = float(((got - ref).abs() / ref.abs().clamp(min=1e-300)).max())
            _fail(f"f64 headline {name}: kernel vs plain LU differ, max rel "
                  f"{e:.3e} > 1e-5")
    print(f"[headline f64] M={M} Radau9 rtol 1e-6 K=2 IND: success_fraction "
          f"{succ} accept_fraction {acc:.4f} launches {launches} host_syncs "
          f"{syncs} | s/solve kernel_lu {sec_k:.4f}, plain LU {sec_p:.4f} | "
          f"y(1) lane0 {sol_k.y[0].tolist()}", flush=True)

    # ---- 5. heterogeneous mu, f64, against scipy --------------------------
    from scipy.integrate import solve_ivp as scipy_ivp
    mus = torch.logspace(1, 3, M, dtype=torch.float64, device=dev)
    y0 = torch.tensor([[2.0, 0.0]], dtype=torch.float64, device=dev).repeat(M, 1)
    seeds = torch.zeros((2, M, 2), dtype=torch.float64, device=dev)
    seeds[0, :, 0] = 1.0
    seeds[1, :, 1] = 1.0
    t_h = time.perf_counter()
    sol_h = solve_ivp(vdp_rhs, (0.0, 1.0), y0, method="radau9", args=mus,
                      jac=vdp_jac, tangents=seeds, rtol=1e-6, atol=1e-9,
                      pivoting=False, kernel_lu=True)
    torch.cuda.synchronize()
    sec_h = time.perf_counter() - t_h
    succ_h, acc_h = fractions(sol_h)
    if succ_h != 1.0:
        _fail(f"heterogeneous mu: success_fraction {succ_h} != 1.0")
    lanes = np.linspace(0, M - 1, 8).round().astype(int)
    y_h = sol_h.y.cpu().numpy()
    worst = 0.0
    for i in lanes:
        mu = float(mus[i])
        ref = scipy_ivp(
            lambda t, y: [y[1], mu * (1 - y[0] ** 2) * y[1] - y[0]],
            (0.0, 1.0), [2.0, 0.0], method="Radau", rtol=1e-10, atol=1e-12,
            jac=lambda t, y: [[0.0, 1.0],
                              [-2 * mu * y[0] * y[1] - 1, mu * (1 - y[0] ** 2)]]
        ).y[:, -1]
        e = np.abs(y_h[i] - ref)
        if not np.all(e <= 1e-4 * np.abs(ref) + 1e-6):
            _fail(f"heterogeneous mu lane {i} (mu={mu:.4g}): y {y_h[i]} vs "
                  f"scipy {ref}")
        worst = max(worst, float(np.max(e / (1e-4 * np.abs(ref) + 1e-6))))
    print(f"[hetero mu f64] M={M} mu=logspace(1,3): success_fraction {succ_h}"
          f" accept_fraction {acc_h:.4f} host_syncs {solve_radau.host_syncs}"
          f" | {sec_h:.4f} s (one solve, host clock) | 8 lanes vs scipy "
          f"Radau: worst error / bound {worst:.3e}", flush=True)

    # ---- 6. headline, f32 compensated -------------------------------------
    sol_f = headline(torch.float32, True, compensated=True)
    sec_f = _solve_seconds(lambda: headline(torch.float32, True, True))
    succ_f, acc_f = fractions(sol_f)
    if not (torch.isfinite(sol_f.y).all() and torch.isfinite(sol_f.sens).all()):
        _fail("f32 headline: non-finite y or sens")
    if succ_f < 0.99:
        _fail(f"f32 headline success_fraction {succ_f} < 0.99")
    print(f"[headline f32 compensated] success_fraction {succ_f} "
          f"accept_fraction {acc_f:.4f} host_syncs {solve_radau.host_syncs} "
          f"| s/solve {sec_f:.4f}", flush=True)

    k1, k1p, k2, k2p = times[(torch.float64, 4)]
    print(json.dumps({"kernels": [
        {"name": "lu_factor_t", "route": "cuda",
         "source": "janus_tpu_torch/csrc/smalllu.cu",
         "replaces": "janus_tpu/ops/smalllu_pallas.py:84",
         "launches": launches["K1"], "max_abs_err": err["K1"]["float64"],
         "ms": k1, "plain_ms": k1p,
         "shape": f"D=4 M={M} float64"},
        {"name": "lu_solve_t", "route": "cuda",
         "source": "janus_tpu_torch/csrc/smalllu.cu",
         "replaces": "janus_tpu/ops/smalllu_pallas.py:115",
         "launches": launches["K2"], "max_abs_err": err["K2"]["float64"],
         "ms": k2, "plain_ms": k2p,
         "shape": f"D=4 M={M} float64"},
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
