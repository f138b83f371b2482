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
   the twin's result (the kernels are built without FMA contraction and
   agree to the bit; the bound leaves room for another operation order);
   each kernel's time next to its twin's (CUDA events);
4. headline f64: bench.py's configuration through the port -- 65,536 stiff
   Van der Pol lanes (mu = 1e3, t in [0, 1]), Radau IIA s=5, rtol 1e-6,
   atol 1e-9, pivot-free stage LU through K1/K2, analytic Jacobian, K = 2
   IND sensitivities; the kernels' launch counts and host syncs of that run,
   seconds per solve (median of 3 after a warm-up); the same with
   kernel_lu=False (plain torch LU), whose y and sens must agree within
   rtol 1e-5 (10x the solve's rtol: an ulp of difference may flip one step
   decision);
5. heterogeneous mu = logspace(1, 3, 65536) through solve_ivp('radau9'):
   8 lanes against scipy's Radau at rtol 1e-10 (within 1e-4 relative plus
   1e-6 absolute);
6. headline f32 with compensated accumulation: finite, success >= 0.99;
7. K3 (linsolve_fused) against its twin, shapes and tolerances as phase 3,
   its time at D=4, M=65,536 f64 next to the twin's; then the public op
   janus_tpu_torch.ops.linsolve_fused once, counting its launches;
8. K4 (radau5_step), one attempt (max_attempts=1) on the packed state of
   the 65,536 headline lanes, initial and after five attempts, against
   _step_ref on the card: flags and counters equal on >= 99.9% of lanes,
   value rows within f64 1e-12 / f32 1e-5 of each row's largest entry; the
   time of one launch next to one twin attempt;
9. radau_fused headline f64: the same lanes as phase 4 through
   solve_ivp(..., method='radau_fused'), Radau5, rtol 1e-6, atol 1e-9:
   success 1.0, K4 launches and host syncs of that solve, seconds per solve
   (median of 3 after a warm-up); the twin loop on the card (y within rtol
   1e-5) and the eager solve_ivp('radau5', kernel_lu=True) (y within 1e-6
   relative plus 1e-9 absolute), each with its time;
10. radau_fused with mu = logspace(1, 3, 65536): success 1.0, 8 lanes
    against scipy as phase 5;
11. radau_fused on Robertson (D=3), 4,096 lanes, tf = logspace(-2, 2):
    success 1.0, y within rtol 1e-5 of the twin loop;
12. radau_fused f32 at rtol 1e-4, atol 1e-7: finite, success >= 0.99.

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

    from janus_tpu_torch import ops as janus_ops
    from janus_tpu_torch.models.problems import (robertson_rhs, vdp_jac,
                                                 vdp_rhs)
    from janus_tpu_torch.ops import _build, smalllu
    from janus_tpu_torch.ops import radau_fused as k4
    from janus_tpu_torch.solve import Options, solve_ivp
    from janus_tpu_torch.solve import radau_fused as rf
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
    print(f"[build] K1-K4 from janus_tpu_torch/csrc/*.cu with "
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

    def scipy_worst(y_got, mus, what):
        """Worst error / bound of 8 lanes against scipy's Radau."""
        worst = 0.0
        for i in np.linspace(0, M - 1, 8).round().astype(int):
            mu = float(mus[i])
            ref = scipy_ivp(
                lambda t, y: [y[1], mu * (1 - y[0] ** 2) * y[1] - y[0]],
                (0.0, 1.0), [2.0, 0.0], method="Radau", rtol=1e-10,
                atol=1e-12,
                jac=lambda t, y: [[0.0, 1.0], [-2 * mu * y[0] * y[1] - 1,
                                               mu * (1 - y[0] ** 2)]]
            ).y[:, -1]
            e = np.abs(y_got[i] - ref)
            if not np.all(e <= 1e-4 * np.abs(ref) + 1e-6):
                _fail(f"{what} lane {i} (mu={mu:.4g}): y {y_got[i]} vs "
                      f"scipy {ref}")
            worst = max(worst, float(np.max(e / (1e-4 * np.abs(ref) + 1e-6))))
        return worst

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
    worst = scipy_worst(sol_h.y.cpu().numpy(), mus, "heterogeneous mu")
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

    # ---- 7. K3 against its twin ---------------------------------------------
    err["K3"] = {}
    for dtype, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        for m in (M, 700):
            for d in (2, 4, 3, 6):
                a = rng.standard_normal((m, d, d)) + 5.0 * np.eye(d)
                b = rng.standard_normal((m, d))
                a_t = torch.from_numpy(
                    np.ascontiguousarray(a.transpose(1, 2, 0).reshape(d * d, m))
                ).to(dev, dtype)
                b_t = torch.from_numpy(np.ascontiguousarray(b.T)).to(dev, dtype)
                x_ref = smalllu.linsolve_fused_ref(a_t, b_t)
                x_k = smalllu.linsolve_fused(a_t, b_t)
                torch.cuda.synchronize()
                e = float((x_k - x_ref).abs().max())
                scale = float(x_ref.abs().max())
                if not e <= rtol * scale:
                    _fail(f"K3 D={d} M={m} {dtype}: max|err| {e:.3e} > "
                          f"{rtol:g} * {scale:.3e}")
                key = str(dtype).replace("torch.", "")
                err["K3"][key] = max(err["K3"].get(key, 0.0), e)
                if m == M and d == 4 and dtype == torch.float64:
                    k3_in = (a_t, b_t)
                    k3 = _events_ms(lambda: smalllu.linsolve_fused(a_t, b_t),
                                    50)
                    k3p = _events_ms(
                        lambda: smalllu.linsolve_fused_ref(a_t, b_t), 50)
    # the K3 path: the public op ops.linsolve_fused at D=4, M=65,536
    smalllu.reset_launch_counts()
    janus_ops.linsolve_fused(*k3_in)
    torch.cuda.synchronize()
    launches["K3"] = smalllu.linsolve_fused.launches
    if launches["K3"] <= 0:
        _fail("ops.linsolve_fused did not launch K3")
    print(f"[K3] agree with twin: max|err| {err['K3']} | D=4 M={M} float64: "
          f"{k3:.4f} ms (twin {k3p:.4f}) | launches on the op's path "
          f"{launches['K3']}", flush=True)

    # ---- 8. K4, one attempt against _step_ref -----------------------------
    def vdp_lanes(dtype, mu=1e3):
        y0 = torch.tensor([[2.0, 0.0]], dtype=dtype, device=dev).repeat(M, 1)
        return y0, torch.full((M,), mu, dtype=dtype, device=dev)

    def one_attempt(dtype, n_before):
        """(agreeing-lane share, {row: rel err}, max abs err, state, tf_row,
        mus, consts) for one K4 attempt after n_before twin attempts."""
        y0, mus = vdp_lanes(dtype)
        opts = Options(rtol=1e-6, atol=1e-9)
        st, tf_row = rf.initial_state(vdp_rhs, 0.0, 1.0, y0, mus, opts)
        consts = rf.step_consts(opts, dtype)
        rows, treedef = rf.arg_rows(mus, st[0])
        for _ in range(n_before):
            st = rf._step_ref(st, tf_row, rows, vdp_rhs, treedef, consts)
        ref = rf._step_ref(st, tf_row, rows, vdp_rhs, treedef, consts)
        got = k4.radau5_step(st.clone(), tf_row, vdp_rhs, mus, consts)
        torch.cuda.synchronize()
        share, errs, abs_err = rf.state_agreement(got, ref, 2)
        return share, errs, abs_err, st, tf_row, mus, consts

    k4_err = {}
    for dtype, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        for n_before in (0, 5):
            share, errs, abs_err, st, tf_row, mus, consts = one_attempt(
                dtype, n_before)
            worst = max(errs, key=errs.get)
            print(f"[K4 one attempt] {dtype} after {n_before} attempts: "
                  f"flags/counters equal on {share:.6f} of lanes "
                  f"({round((1 - share) * M)} differ); worst row {worst} "
                  f"{errs[worst]:.3e} (bound {rtol:g})", flush=True)
            if share < 0.999:
                _fail(f"K4 one attempt {dtype}: flags equal on {share}")
            if errs[worst] > rtol:
                _fail(f"K4 one attempt {dtype}: row {worst} {errs[worst]:.3e}"
                      f" > {rtol:g}")
            key = str(dtype).replace("torch.", "")
            k4_err[key] = max(k4_err.get(key, 0.0), abs_err)
            if dtype == torch.float64 and n_before == 0:
                k4_in = (st, tf_row, mus, consts)
    st0, tf_row, mus, consts = k4_in
    rows0, treedef0 = rf.arg_rows(mus, st0[0])
    k4_ms = statistics.median(
        _events_ms(lambda st=st0.clone(): k4.radau5_step(
            st, tf_row, vdp_rhs, mus, consts), 1) for _ in range(20))
    k4p_ms = _events_ms(lambda: rf._step_ref(st0, tf_row, rows0, vdp_rhs,
                                             treedef0, consts), 5)
    print(f"[K4 one attempt] M={M} float64 initial state: {k4_ms:.4f} ms per "
          f"launch (twin {k4p_ms:.4f} ms)", flush=True)

    # ---- 9. radau_fused headline, f64 ------------------------------------------
    def fused(dtype, rtol=1e-6, atol=1e-9, kernel=True):
        """The headline lanes through solve_ivp('radau_fused') (K4), or
        with kernel=False through the twin loop on the card."""
        y0, mus = vdp_lanes(dtype)
        if kernel:
            return solve_ivp(vdp_rhs, (0.0, 1.0), y0, method="radau_fused",
                             args=mus, rtol=rtol, atol=atol)
        return rf.solve_radau_fused_ref(vdp_rhs, 0.0, 1.0, y0, mus,
                                        Options(rtol=rtol, atol=atol))

    torch.cuda.synchronize()
    k4.reset_launch_counts()
    sol_k = fused(torch.float64)
    torch.cuda.synchronize()
    launches["K4"] = k4.radau5_step.launches
    syncs = rf.solve_radau_fused.host_syncs
    succ, acc = fractions(sol_k)
    if succ != 1.0:
        _fail(f"radau_fused f64 success_fraction {succ} != 1.0")
    if launches["K4"] <= 0:
        _fail("radau_fused did not launch K4")
    if not torch.isfinite(sol_k.y).all():
        _fail("radau_fused f64: non-finite y")
    sec_k = _solve_seconds(lambda: fused(torch.float64))
    t_p = time.perf_counter()
    sol_p = fused(torch.float64, kernel=False)
    torch.cuda.synchronize()
    sec_p = time.perf_counter() - t_p
    if not torch.allclose(sol_k.y, sol_p.y, rtol=1e-5,
                          atol=1e-5 * float(sol_p.y.abs().max())):
        _fail("radau_fused f64: kernel vs twin loop differ beyond rtol 1e-5")
    e_twin = float(((sol_k.y - sol_p.y).abs()
                    / sol_p.y.abs().clamp(min=1e-300)).max())
    y0, mus = vdp_lanes(torch.float64)

    def eager_radau5():
        return solve_ivp(vdp_rhs, (0.0, 1.0), y0, method="radau5", args=mus,
                         rtol=1e-6, atol=1e-9, kernel_lu=True, pivoting=False)

    sol_e = eager_radau5()
    sec_e = _solve_seconds(eager_radau5)
    if not torch.allclose(sol_k.y, sol_e.y, rtol=1e-6, atol=1e-9):
        e = float(((sol_k.y - sol_e.y).abs() / (1e-6 * sol_e.y.abs() + 1e-9))
                  .max())
        _fail(f"radau_fused vs eager radau5: error / bound {e:.3e} > 1")
    print(f"[radau_fused f64] M={M} VdP mu=1e3 rtol 1e-6: success_fraction "
          f"{succ} accept_fraction {acc:.4f} K4 launches {launches['K4']} "
          f"host_syncs {syncs} nsteps max {int(sol_k.stats['nsteps'].max())}"
          f" | s/solve K4 {sec_k:.6f}, twin loop {sec_p:.4f} (one solve, "
          f"host clock), eager radau5 + K1/K2 {sec_e:.4f} | vs twin max rel "
          f"{e_twin:.3e} | y(1) lane0 {sol_k.y[0].tolist()}", flush=True)

    # ---- 10. radau_fused, heterogeneous mu, f64, against scipy -------------
    mus_h = torch.logspace(1, 3, M, dtype=torch.float64, device=dev)
    t_h = time.perf_counter()
    sol_fh = solve_ivp(vdp_rhs, (0.0, 1.0), y0, method="radau_fused",
                       args=mus_h, rtol=1e-6, atol=1e-9)
    torch.cuda.synchronize()
    sec_fh = time.perf_counter() - t_h
    succ_fh, acc_fh = fractions(sol_fh)
    if succ_fh != 1.0:
        _fail(f"radau_fused heterogeneous mu: success_fraction {succ_fh}")
    worst = scipy_worst(sol_fh.y.cpu().numpy(), mus_h,
                        "radau_fused heterogeneous mu")
    print(f"[radau_fused hetero mu f64] success_fraction {succ_fh} "
          f"accept_fraction {acc_fh:.4f} host_syncs "
          f"{rf.solve_radau_fused.host_syncs} | {sec_fh:.6f} s (one solve, "
          f"host clock) | 8 lanes vs scipy Radau: worst error / bound "
          f"{worst:.3e}", flush=True)

    # ---- 11. radau_fused, Robertson (D=3) -----------------------------------
    m_r = 4096
    y0_r = torch.tensor([[1.0, 0.0, 0.0]], dtype=torch.float64,
                        device=dev).repeat(m_r, 1)
    tf_r = torch.logspace(-2, 2, m_r, dtype=torch.float64, device=dev)
    sol_r = solve_ivp(robertson_rhs, (0.0, tf_r), y0_r, method="radau_fused",
                      rtol=1e-6, atol=1e-10)
    sol_rp = rf.solve_radau_fused_ref(robertson_rhs, 0.0, tf_r, y0_r, None,
                                      Options(rtol=1e-6, atol=1e-10))
    succ_r, acc_r = fractions(sol_r)
    if succ_r != 1.0:
        _fail(f"radau_fused Robertson: success_fraction {succ_r}")
    if not torch.allclose(sol_r.y, sol_rp.y, rtol=1e-5,
                          atol=1e-5 * float(sol_rp.y.abs().max())):
        _fail("radau_fused Robertson: kernel vs twin loop differ")
    print(f"[radau_fused Robertson f64] M={m_r} tf=logspace(-2,2): "
          f"success_fraction {succ_r} accept_fraction {acc_r:.4f} nsteps max "
          f"{int(sol_r.stats['nsteps'].max())} | agrees with the twin loop "
          f"within rtol 1e-5", flush=True)

    # ---- 12. radau_fused, f32 ------------------------------------------------
    sol_f = fused(torch.float32, rtol=1e-4, atol=1e-7)
    succ_f, acc_f = fractions(sol_f)
    if not torch.isfinite(sol_f.y).all():
        _fail("radau_fused f32: non-finite y")
    if succ_f < 0.99:
        _fail(f"radau_fused f32 success_fraction {succ_f} < 0.99")
    print(f"[radau_fused f32] rtol 1e-4: success_fraction {succ_f} "
          f"accept_fraction {acc_f:.4f}", flush=True)

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
        {"name": "linsolve_fused", "route": "cuda",
         "source": "janus_tpu_torch/csrc/smalllu.cu",
         "replaces": "janus_tpu/ops/smalllu_pallas.py:55",
         "launches": launches["K3"], "max_abs_err": err["K3"]["float64"],
         "ms": k3, "plain_ms": k3p,
         "shape": f"D=4 M={M} float64"},
        {"name": "radau5_step", "route": "cuda",
         "source": "janus_tpu_torch/csrc/radau_fused.cu",
         "replaces": "janus_tpu/solve/radau_fused.py:170",
         "launches": launches["K4"], "max_abs_err": k4_err["float64"],
         "ms": k4_ms, "plain_ms": k4p_ms,
         "shape": f"one attempt, VdP D=2 M={M} float64"},
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
