"""Drive, check and measure the outer control layer (``control``) on a card:
batched multiple-shooting PMP Van der Pol through K1/K2.

Phase 21 of ``chip_smoke.py`` (``run(dev, smoke=True)``), and a probe of its
own, run from the root of a checkout on a machine with a CUDA card:

    python3 -m janus_tpu_torch.bench.control [--only PHASE ...] [--json PATH]

The problem (``tests/test_pmp_vdp.py`` and ``examples/vdp_pmp_energy.py`` of
the reference): the PMP Van der Pol system ``pmp_rhs`` (D=4, the state and
its costate), multiple shooting with S=4 segments on [0, 2]
(``control.multiple_shooting_residual``), x(0) = (1, 0.5) and x(2) = 0, a
per-instance mu = linspace(0, 1, M) passed as args of shape [M] (repeated
over each instance's segments), Radau5 at rtol 1e-8, atol 1e-11,
pivoting=False, started from z0 = tile((1, 0.5, 0, 0), S); everything in
f64. Phases (``PHASES``), each raising ``ControlCheckFailed`` when its check
fails:
- ``ind``: 16,384 instances × 4 segments = 65,536 lanes a residual solve.
  ``control.newton_solve`` with ``jac=`` built from ONE IND solve of the
  65,536 segment lanes (identity tangents, K = D = 4 directions a lane):
  ∂end_s/∂start_s assembles into the [M, 16, 16] block Jacobian, whose
  continuity rows hold −I and whose boundary rows come from the first
  segment's start and the last segment's end. Routes: K1/K2 (kernel_lu=True:
  K1 factors the real 4×4 and split-complex 8×8 stage blocks, K2 does every
  Newton, error-estimate and tangent solve) and the plain pivot-free LU, in
  alternating turns (K P, or K P P K K P without ``smoke``); the Newton's own
  16×16 pivoted LU is plain torch on both. s per Newton solve (CUDA events),
  Newton iterations, residual and IND solves, K1/K2 launches, host syncs.
  Checks: every instance converged with fnorm < 1e-8; x, iters and fnorm
  equal to the bit between the routes; 8 instances against the port's CPU
  run (the plain LU, the same arithmetic) within 1e-9; the solution integrated forward (rtol 1e-10, atol 1e-13;
  1e-8 and 1e-11 with ``smoke``) reaches x(2) = 0 within 1e-5 (the
  reference test's check). Without
  ``smoke`` also the launches and busy share of one IND Jacobian solve and
  of one residual solve through K1/K2 under torch.profiler (the profiler
  takes ~90 s to read one solve's events, too long for the smoke run).
- ``ad``: the default AD Jacobian (``fd_or_ad_jacobian('ad')``: one
  ``torch.func.vmap`` over ``torch.func.jvp`` of the residual, 16 directions)
  on the plain route at 1,024 instances (every 16th of ``ind``'s): x within
  1e-7 of ``ind``'s on the same instances (the bound of the reference's
  ``tests/test_radau_tangents.py:297-300``); from z0, or with ``smoke``
  from ``ind``'s solution moved by 1e-5 (one iteration, so fewer
  solves). The same call with
  kernel_lu=True must raise the kernels' ValueError (they have no derivative
  rule).
- ``homotopy`` (not part of ``run(smoke=True)``): ``control.homotopy`` from
  mu=0 to mu=5 on 1,024 instances, as ``tests/test_pmp_vdp.py:57-77``: every
  instance reaches lam = 1, the final residual below 1e-6 and x(2) = 0
  within 1e-5.

``--count-ops M`` runs on the CPU instead: the ops that one ``ind`` Newton
(each route) and one ``ad`` Newton dispatch at M instances, counted with a
TorchDispatchMode (views apart; a K1/K2 call counted as one launch, not as
the twin's ops), with the solves and host syncs of the run: the basis of a
prediction of the card's launches before it runs.
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

from janus_tpu_torch.bench import kernels as kb
from janus_tpu_torch.bench import mol
from janus_tpu_torch.bench.cpu_side import Later
from janus_tpu_torch.control import (homotopy, multiple_shooting_residual,
                                     newton_solve)
from janus_tpu_torch.examples.vdp_pmp_energy import pmp_rhs
from janus_tpu_torch.solve import Options, solve_ivp
from janus_tpu_torch.solve.radau import solve_radau

M_INST = 16_384
M_AD = 1_024
M_HOMOTOPY = 1_024
NSEG = 4
D = 4
TF = 2.0
X0 = (1.0, 0.5)
MS_OPTS = dict(rtol=1e-8, atol=1e-11, pivoting=False)
NEWTON_TOL = 1e-8
CPU_BOUND = 1e-9
AD_BOUND = 1e-7
FORWARD_BOUND = 1e-5
F2_ERROR = "have no derivative rule"
PHASES = ("ind", "ad", "homotopy")


class ControlCheckFailed(RuntimeError):
    """A phase's check did not hold."""


def boundary(y_start, y_end):
    """x(0) = X0, x(TF) = 0."""
    x0 = torch.tensor(X0, dtype=y_start.dtype, device=y_start.device)
    return torch.cat([y_start[:, :2] - x0, y_end[:, :2]], dim=-1)


def t_nodes():
    return np.linspace(0.0, TF, NSEG + 1)


def mus(m, dev, mu_max=1.0):
    """The per-instance mu = linspace(0, mu_max, m) (made on the CPU)."""
    return torch.linspace(0.0, mu_max, m, dtype=torch.float64).to(dev)


def z0(m, dev):
    """tile((x0, 0, 0), S) for every instance: [m, S·D]."""
    row = torch.tensor(X0 + (0.0, 0.0), dtype=torch.float64)
    return row.repeat(NSEG).expand(m, NSEG * D).clone().to(dev)


def options(kernel_lu):
    return Options(kernel_lu=kernel_lu, **MS_OPTS)


def ms_residual(mu, kernel_lu):
    return multiple_shooting_residual(pmp_rhs, t_nodes(), boundary,
                                      method="radau", args=mu,
                                      options=options(kernel_lu))


def segments(z, mu):
    """(t0s, tfs, starts, seg_mu) of the M·S segment lanes of z [M, S·D]."""
    m = z.shape[0]
    nodes = torch.as_tensor(t_nodes(), dtype=z.dtype, device=z.device)
    return (nodes[:-1].repeat(m), nodes[1:].repeat(m),
            z.reshape(m * NSEG, D), torch.repeat_interleave(mu, NSEG))


def ind_jacobian(mu, kernel_lu):
    """jac(z) -> [M, S·D, S·D] of the multiple-shooting residual from ONE
    IND solve of the M·S segment lanes with identity tangents."""
    def jac(z):
        m = z.shape[0]
        t0s, tfs, starts, seg_mu = segments(z, mu)
        eye = torch.eye(D, dtype=z.dtype, device=z.device)
        seeds = eye[:, None, :].expand(D, m * NSEG, D).contiguous()
        sol = solve_ivp(pmp_rhs, (t0s, tfs), starts, method="radau",
                        args=seg_mu, options=options(kernel_lu),
                        tangents=seeds)
        # phi[m, s, i, j] = ∂end_s[i]/∂start_s[j]
        phi = sol.sens.permute(1, 2, 0).reshape(m, NSEG, D, D)
        jmat = z.new_zeros((m, NSEG * D, NSEG * D))
        for s in range(NSEG - 1):
            r = slice(s * D, (s + 1) * D)
            jmat[:, r, r] = phi[:, s]
            jmat[:, r, (s + 1) * D:(s + 2) * D] = -eye
        # boundary rows: ∂bc/∂y_start (first segment's start) and
        # ∂bc/∂y_end · phi (last segment's end)
        ya = starts.reshape(m, NSEG, D)[:, 0]
        yb = sol.y.reshape(m, NSEG, D)[:, -1]
        basis = eye[:, None, :].expand(D, m, D)
        ja = torch.func.vmap(lambda v: torch.func.jvp(
            lambda a: boundary(a, yb), (ya,), (v,))[1])(basis)
        jb = torch.func.vmap(lambda v: torch.func.jvp(
            lambda b: boundary(ya, b), (yb,), (v,))[1])(basis)
        rows = slice((NSEG - 1) * D, NSEG * D)
        jmat[:, rows, :D] += torch.movedim(ja, 0, -1)
        jmat[:, rows, (NSEG - 1) * D:] += torch.movedim(jb, 0, -1) @ phi[:, -1]
        return jmat

    return jac


class _Counted:
    """Count the calls of a residual or Jacobian and the host syncs of the
    solves inside them."""

    def __init__(self):
        self.calls = {"residual": 0, "jacobian": 0}
        self.solve_syncs = 0

    def wrap(self, fn, key):
        def counted(z):
            out = fn(z)
            self.calls[key] += 1
            self.solve_syncs += solve_radau.host_syncs
            return out
        return counted


def ind_newton(mu, kernel_lu, counter=None):
    """newton_solve of the multiple-shooting PMP VdP with the IND Jacobian,
    from z0."""
    res_fn, jac_fn = ms_residual(mu, kernel_lu), ind_jacobian(mu, kernel_lu)
    if counter is not None:
        res_fn = counter.wrap(res_fn, "residual")
        jac_fn = counter.wrap(jac_fn, "jacobian")
    return newton_solve(res_fn, z0(mu.shape[0], mu.device), tol=NEWTON_TOL,
                        jac=jac_fn)


def forward_worst(x, mu, mu_scale=1.0, rtol=1e-10):
    """max |x(TF)| of the solution integrated forward from z's first
    segment start (rtol 1e-10, atol 1e-13 unless asked)."""
    sol = solve_ivp(pmp_rhs, (0.0, TF), x[:, :D].contiguous(),
                    method="radau", args=mu * mu_scale,
                    options=Options(rtol=rtol, atol=rtol * 1e-3))
    if not bool((sol.status == 1).all()):
        raise ControlCheckFailed("forward integration: a lane failed")
    return float(sol.y[:, :2].abs().max())


def _eight(m):
    return np.linspace(0, m - 1, 8).round().astype(int)


def _cpu_newton(lanes):
    """The IND Newton of the instances ``lanes`` on the CPU (the plain LU,
    the same arithmetic as the card's)."""
    return ind_newton(mus(M_INST, "cpu")[torch.as_tensor(lanes)], False)


def _busy(solve):
    prof = mol.profile_solve(lambda wrap: solve())
    return {"launches": prof["launches"], "busy_ms": prof["busy_ms"],
            "wall_ms": prof["profiled_wall_ms"],
            "busy_share": prof["busy_ms"] / prof["profiled_wall_ms"]}


def ind_phase(dev, smoke=False, keep=None):
    """The multiple-shooting Newton with the IND Jacobian through K1/K2
    against the plain pivot-free LU."""
    name = (f"control ms-PMP VdP M={M_INST}x{NSEG}={M_INST * NSEG} lanes f64 "
            "Radau5 IND Newton")
    parts, clock = {}, [time.perf_counter()]

    def lap(part):
        torch.cuda.synchronize()
        now = time.perf_counter()
        parts[part] = now - clock[0]
        clock[0] = now

    mu = mus(M_INST, dev)
    lanes = _eight(M_INST)
    cpu_run = Later(_cpu_newton, lanes)         # beside the card's turns
    if not smoke:
        # builds K1/K2 if nothing has yet, and pays torch.func's first use
        z_warm = z0(8, dev)
        ind_jacobian(mu[:8], True)(z_warm)
        ms_residual(mu[:8], True)(z_warm)
        lap("warm_up")
    turns = {True: [], False: []}
    outs, launches, counts = {}, None, {}
    order = (True, False) if smoke else (True, False, False, True, True,
                                         False)
    for k in order:
        torch.cuda.synchronize()
        mol._reset_kernel_launches()
        counter = _Counted()
        out = []
        turns[k].append(kb.events_ms(
            lambda: out.append(ind_newton(mu, k, counter)), 1) / 1e3)
        counts[k] = {**counter.calls, "solve_syncs": counter.solve_syncs,
                     "newton_syncs": newton_solve.host_syncs}
        if k and launches is None:
            launches = mol._kernel_launches()
        elif not k and any(mol._kernel_launches().values()):
            raise ControlCheckFailed(f"{name}: the plain route launched a "
                                     f"kernel: {mol._kernel_launches()}")
        outs[k] = out[0]
    lap("turns")
    rk, rp = outs[True], outs[False]
    if keep is not None:
        keep["x"] = rk.x
    if launches["K1"] <= 0 or launches["K2"] <= 0:
        raise ControlCheckFailed(f"{name}: kernel_lu=True did not launch K1 "
                                 f"and K2: {launches}")
    if not bool(rk.converged.all()):
        raise ControlCheckFailed(f"{name}: {int((~rk.converged).sum())} "
                                 "instances did not converge")
    fmax = float(rk.fnorm.max())
    if not fmax < NEWTON_TOL:
        raise ControlCheckFailed(f"{name}: fnorm {fmax:.3e} >= {NEWTON_TOL}")
    for what in ("x", "iters", "fnorm", "converged"):
        a, b = getattr(rk, what), getattr(rp, what)
        if not torch.equal(a, b):
            raise ControlCheckFailed(f"{name}: {what} differs between the "
                                     "routes, not equal to the bit")
    r_cpu = cpu_run.result()
    cpu_err = float((rk.x[torch.as_tensor(lanes, device=dev)].cpu()
                     - r_cpu.x).abs().max())
    if not cpu_err <= CPU_BOUND:
        raise ControlCheckFailed(f"{name}: 8 instances vs the CPU "
                                 f"{cpu_err:.3e} > {CPU_BOUND:g}")
    lap("cpu_8_instances")
    # the smoke run integrates at rtol 1e-8 (half the steps; its error,
    # ~1e-7, stays far inside the bound)
    fwd_rtol = 1e-8 if smoke else 1e-10
    fwd = forward_worst(rk.x, mu, rtol=fwd_rtol)
    if not fwd <= FORWARD_BOUND:
        raise ControlCheckFailed(f"{name}: forward integration reaches "
                                 f"|x(2)| = {fwd:.3e} > {FORWARD_BOUND:g}")
    lap("forward")
    rec = {"launches": launches, "counts": counts[True],
           "counts_plain": counts[False],
           "iters_max": int(rk.iters.max()), "iters_min": int(rk.iters.min()),
           "fnorm_max": fmax, "cpu_8_instances": cpu_err,
           "cpu_iters": r_cpu.iters.tolist(), "forward_x_end": fwd,
           "forward_rtol": fwd_rtol,
           "turns": {"kernel": turns[True], "plain": turns[False]},
           "s_per_newton_kernel": statistics.median(turns[True]),
           "s_per_newton_plain": statistics.median(turns[False]),
           "seconds": parts}
    extra = (" | busy share: not measured in the smoke run (the profiler "
             "takes ~90 s to read one IND solve's events)")
    if not smoke:
        jac_k = ind_jacobian(mu, True)
        extra = ""
        for what, fn in (("ind_jacobian", lambda: jac_k(rk.x)),
                         ("residual", lambda: ms_residual(mu, True)(rk.x))):
            rec[f"busy_{what}"] = b = _busy(fn)
            extra += (
                f" | one {what} solve through K1/K2 under torch.profiler: "
                f"launches {b['launches']}, busy {b['busy_ms']:.1f} of "
                f"{b['wall_ms']:.1f} ms, busy share {b['busy_share']:.4f}")
        lap("profile")
    c = counts[True]
    print(f"[{name}] every instance converged, iterations "
          f"{rec['iters_min']}-{rec['iters_max']}, max fnorm {fmax:.3e} "
          f"(tol {NEWTON_TOL:g}); x, iters, fnorm equal to the bit between "
          f"the routes | s/Newton kernel_lu {turns[True]}, plain LU "
          f"{turns[False]} (turns {'K P' if smoke else 'K P P K K P'}; CUDA "
          f"events) | residual solves {c['residual']}, IND solves "
          f"{c['jacobian']} | kernel_lu launches K1 {launches['K1']}, K2 "
          f"{launches['K2']} (K3 {launches['K3']}, K4 {launches['K4']}) | "
          f"host syncs: Newton {c['newton_syncs']}, solves {c['solve_syncs']}"
          f" | 8 instances vs CPU {cpu_err:.3e} (bound {CPU_BOUND:g}) | "
          f"forward |x(2)| {fwd:.3e} (rtol {fwd_rtol:g}, bound "
          f"{FORWARD_BOUND:g})" + extra
          + " | seconds: "
          + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()), flush=True)
    return rec


def ad_phase(dev, ind_x=None, smoke=False):
    """The default AD Jacobian on the plain route at M_AD instances, and
    the kernels' refusal of it. ``smoke`` starts the Newton from the IND
    Newton's solution moved by 1e-5 (given ``ind_x``), which takes one
    iteration, so fewer solves, than z0."""
    name = f"control ms-PMP VdP AD Jacobian M={M_AD}x{NSEG} plain LU"
    idx = torch.arange(0, M_INST, M_INST // M_AD, device=dev)
    mu = mus(M_INST, dev)[idx]
    if smoke and ind_x is not None:
        start, name = ind_x[idx] + 1e-5, name + " from x_IND + 1e-5"
    else:
        start = z0(M_AD, dev)
    t0 = time.perf_counter()
    res = newton_solve(ms_residual(mu, False), start, tol=NEWTON_TOL)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if not bool(res.converged.all()):
        raise ControlCheckFailed(f"{name}: {int((~res.converged).sum())} "
                                 "instances did not converge")
    if ind_x is None:
        ind_x = ind_newton(mu, True).x
    else:
        ind_x = ind_x[idx]
    err = float((res.x - ind_x).abs().max())
    if not err <= AD_BOUND:
        raise ControlCheckFailed(f"{name}: x vs the IND Newton {err:.3e} > "
                                 f"{AD_BOUND:g}")
    try:
        newton_solve(ms_residual(mu[:4], True), z0(4, dev), tol=NEWTON_TOL)
    except ValueError as e:
        if F2_ERROR not in str(e):
            raise
        refusal = str(e).split(":")[0]
    else:
        raise ControlCheckFailed(f"{name}: the AD Jacobian through "
                                 "kernel_lu=True did not raise")
    rec = {"seconds": seconds, "iters_max": int(res.iters.max()),
           "x_vs_ind": err, "refused_by": refusal}
    print(f"[{name}] every instance converged, iterations "
          f"{int(res.iters.min())}-{rec['iters_max']}, {seconds:.2f} s | x "
          f"vs the IND Newton {err:.3e} (bound {AD_BOUND:g}) | kernel_lu=True "
          f"refused by {refusal!r}", flush=True)
    return rec


def homotopy_phase(dev, mu_target=5.0):
    """homotopy from mu=0 to mu_target on the multiple-shooting unknowns."""
    name = f"control ms-PMP VdP homotopy mu 0 -> {mu_target} M={M_HOMOTOPY}"
    scale = mus(M_HOMOTOPY, dev)          # instance i goes to mu_target·i/M
    t0 = time.perf_counter()
    start = newton_solve(ms_residual(0.0 * scale, False),
                         z0(M_HOMOTOPY, dev), tol=NEWTON_TOL)
    if not bool(start.converged.all()):
        raise ControlCheckFailed(f"{name}: the mu=0 Newton did not converge")

    def g(z, lam):
        return ms_residual(lam * mu_target * scale, False)(z)

    h = homotopy(g, start.x, dlam0=0.5, tol=1e-6, newton_iters=5)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if not bool(h.converged.all()):
        raise ControlCheckFailed(f"{name}: {int((~h.converged).sum())} "
                                 "instances did not reach lam = 1")
    final = float(torch.linalg.vector_norm(
        ms_residual(mu_target * scale, False)(h.x), dim=-1).max())
    if not final < 1e-6:
        raise ControlCheckFailed(f"{name}: final residual {final:.3e}")
    fwd = forward_worst(h.x, scale, mu_target)
    if not fwd <= FORWARD_BOUND:
        raise ControlCheckFailed(f"{name}: forward |x(2)| {fwd:.3e}")
    rec = {"seconds": seconds, "steps_max": int(h.iters.max()),
           "final_residual": final, "forward_x_end": fwd}
    print(f"[{name}] every instance reached lam = 1 in <= "
          f"{rec['steps_max']} steps, final residual {final:.3e}, forward "
          f"|x(2)| {fwd:.3e}, {seconds:.1f} s", flush=True)
    return rec


def count_ops(m):
    """Ops dispatched by one IND Newton through K1/K2 and through the plain
    LU, and by one AD Newton, at m instances on the CPU."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from janus_tpu_torch.ops import smalllu

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = self.views = self.kernel = 0
            self.inside = False

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not self.inside:
                if func.is_view:
                    self.views += 1
                else:
                    self.ops += 1
            return func(*args, **(kwargs or {}))

    def as_launch(mode, twin):
        def call(*a):
            mode.kernel += 1
            mode.inside = True
            try:
                return twin(*a)
            finally:
                mode.inside = False
        return call

    cpu = torch.device("cpu")
    mu = mus(m, cpu)
    out = {}
    for name, kernel_lu in (("ind_kernel", True), ("ind_plain", False),
                            ("ad_plain", None)):
        counter = _Counted()
        twins = smalllu.lu_factor_t_ref, smalllu.lu_solve_t_ref
        with Count() as mode:
            smalllu.lu_factor_t_ref = as_launch(mode, twins[0])
            smalllu.lu_solve_t_ref = as_launch(mode, twins[1])
            try:
                t0 = time.perf_counter()
                if kernel_lu is None:
                    res = newton_solve(counter.wrap(ms_residual(mu, False),
                                                    "residual"),
                                       z0(m, cpu), tol=NEWTON_TOL)
                else:
                    res = ind_newton(mu, kernel_lu, counter)
                seconds = time.perf_counter() - t0
            finally:
                smalllu.lu_factor_t_ref, smalllu.lu_solve_t_ref = twins
        out[name] = {"ops": mode.ops, "views": mode.views,
                     "k1_k2_calls": mode.kernel, "seconds": seconds,
                     "iters": res.iters.tolist(), **counter.calls,
                     "solve_syncs": counter.solve_syncs,
                     "newton_syncs": newton_solve.host_syncs}
        print(f"[count-ops {name} M={m}] {out[name]}", flush=True)
    return out


def run(dev, only=PHASES, smoke=False):
    """Run the named phases; returns their records with the seconds each
    phase took under ``"seconds"``."""
    report, seconds, keep = {}, {}, {}

    def timed(phase, fn, *a, **kw):
        t0 = time.perf_counter()
        report[phase] = fn(dev, *a, **kw)
        torch.cuda.synchronize()
        seconds[phase] = time.perf_counter() - t0

    if "ind" in only:
        timed("ind", ind_phase, smoke=smoke, keep=keep)
    if "ad" in only:
        timed("ad", ad_phase, ind_x=keep.get("x"), smoke=smoke)
    if "homotopy" in only and not smoke:
        timed("homotopy", homotopy_phase)
    report["seconds"] = seconds
    print("[control phase seconds] " + ", ".join(
        f"{k} {v:.1f}" for k, v in seconds.items()), flush=True)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="+", choices=PHASES, default=PHASES)
    ap.add_argument("--json", type=Path, default=None,
                    help="also write the JSON line to this file")
    ap.add_argument("--smoke", action="store_true",
                    help="chip_smoke's phase 21: one turn a route, no "
                         "whole-Newton profile, no homotopy")
    ap.add_argument("--count-ops", type=int, default=0, metavar="M",
                    help="count the ops of the Newtons at M instances on "
                         "the CPU instead")
    a = ap.parse_args(argv)
    if a.count_ops:
        print(json.dumps(count_ops(a.count_ops)))
        return 0
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
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
