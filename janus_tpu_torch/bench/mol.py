"""Drive, check and measure the matrix-free Radau path on a card.

The method-of-lines (MOL) phases of ``chip_smoke.py``, also a probe of their
own, run from the root of a checkout on a machine with a CUDA card:

    python3 -m janus_tpu_torch.bench.mol [--only PHASE ...] [--json PATH]

Phases (``PHASES``), each raising ``MolCheckFailed`` when its check fails:
- ``tridiag``: Thomas against PCR on the card, real and complex, D=128,
  M = 1,024 and 65,536, f64: agreement to 1e-10 relative and both times;
- ``mol``: ``bench.py``'s MOL configuration at full width -- the D=128
  Fisher-KPP line u' = nu u_xx + r u (1 - u), M = 1,024 lanes, u0 =
  exp(-100 (x - 0.3)^2), r = linspace(1, 8, M), nu = 0.01, t in [0, 0.4],
  Options(rtol=1e-4, atol=1e-7, stage_solver='tridiag', pivoting=False) --
  in f64 and f32, then f64 at M = 65,536: every lane SUCCESS; lanes 0, M/2,
  M-1 within rtol 1e-3 / atol 1e-6 of scipy's Radau at rtol 1e-8; ms per
  solve (median of 3 after a warm-up, CUDA events), steps, host syncs, and
  from one solve under torch.profiler the launches, the device's busy time
  and share, and the device and host time inside the tridiagonal sweeps,
  the jvp's and the right-hand side;
- ``gmres``: the same lines with stage_solver='gmres', gmres_iters 8 and 25;
  final state within 1e-4 relative of the tridiag solve's;
- ``heat``: 2-D Fisher-KPP on a 32x32 grid (D=1,024), M=256, precond='lines',
  GMRES(8); lane 0 against scipy;
- ``block``: the cell-interleaved stiff 2-species line (D=48), M=1,024,
  precond='block' with 2x2 blocks, GMRES(10); lane 0 against scipy;
- ``ind``: K=2 IND seed directions through the GMRES(8) stage solvers on the
  D=128 line, M=1,024; sens finite and within 1e-4 (relative to its largest
  entry) of a central finite difference of 8-lane solves.

None of this path launches a hand-written kernel (it runs no Pallas kernel in
the reference either); ``run`` resets the kernels' launch counts before the
MOL solve and checks that they are still 0 after it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from janus_tpu_torch.bench.kernels import events_ms
from janus_tpu_torch.control import precond
from janus_tpu_torch.linalg import gmres as gm
from janus_tpu_torch.models.problems import heat_2d_rhs
from janus_tpu_torch.solve import Options, radau
from janus_tpu_torch.solve.radau import solve_radau

D_LINE = 128
TF_LINE = 0.4
NU_LINE = 0.01
MOL_OPTS = dict(rtol=1e-4, atol=1e-7, pivoting=False)


class MolCheckFailed(RuntimeError):
    """A phase's check did not hold."""


def fisher_kpp_rhs(dx):
    """1-D Fisher-KPP line, Dirichlet 0, as ``bench.py`` defines it;
    args (nu, r [M, 1])."""
    def rhs(t, y, args):
        nu, r = args
        left = F.pad(y[:, :-1], (1, 0))
        right = F.pad(y[:, 1:], (0, 1))
        lap = (left - 2 * y + right) / dx ** 2
        return nu * lap + r * y * (1.0 - y)
    return rhs


def interleaved_rhs(dx):
    """Cell-interleaved stiff 2-species line y = [u0, v0, u1, v1, ...]: slow
    diffusion of both and a stiff exchange k (u - v) in each cell; args k."""
    def rhs(t, y, args):
        kk = args
        u, v = y[:, 0::2], y[:, 1::2]
        lap_u = (F.pad(u[:, :-1], (1, 0)) - 2 * u
                 + F.pad(u[:, 1:], (0, 1))) / dx ** 2
        lap_v = (F.pad(v[:, :-1], (1, 0)) - 2 * v
                 + F.pad(v[:, 1:], (0, 1))) / dx ** 2
        fu = 0.001 * lap_u - kk * (u - v)
        fv = 0.001 * lap_v + kk * (u - v) - v
        return torch.stack([fu, fv], dim=-1).reshape(y.shape)
    return rhs


def mol_line(m, dtype, dev, d=D_LINE):
    """(rhs, y0 [m, d], args) of the Fisher-KPP line on ``dev``."""
    dx = 1.0 / (d + 1)
    xg = np.linspace(dx, 1.0 - dx, d)
    y0 = torch.as_tensor(np.exp(-100 * (xg - 0.3) ** 2), dtype=dtype,
                         device=dev).repeat(m, 1)
    rates = torch.linspace(1.0, 8.0, m, dtype=dtype, device=dev)[:, None]
    return fisher_kpp_rhs(dx), y0, (NU_LINE, rates)


def _scipy_radau(f1, y0, tf, sparsity=None, rtol=1e-8, atol=1e-11):
    from scipy.integrate import solve_ivp as scipy_ivp
    ref = scipy_ivp(f1, (0.0, tf), y0, method="Radau", rtol=rtol, atol=atol,
                    jac_sparsity=sparsity)
    if not ref.success:
        raise MolCheckFailed(f"scipy Radau failed: {ref.message}")
    return ref.y[:, -1]


def _banded(n, offsets):
    from scipy.sparse import diags
    return diags([np.ones(n - abs(k)) for k in offsets], offsets, format="csc")


def scipy_line(y0, rate, d=D_LINE, tf=TF_LINE):
    """scipy's Radau on one lane of the Fisher-KPP line."""
    dx = 1.0 / (d + 1)

    def f1(t, y):
        lap = np.empty_like(y)
        lap[0] = (y[1] - 2 * y[0]) / dx ** 2
        lap[-1] = (y[-2] - 2 * y[-1]) / dx ** 2
        lap[1:-1] = (y[:-2] - 2 * y[1:-1] + y[2:]) / dx ** 2
        return NU_LINE * lap + rate * y * (1 - y)

    return _scipy_radau(f1, y0, tf, _banded(d, (-1, 0, 1)))


def worst_against(got, ref, rtol, atol, what):
    """max of |got - ref| / (rtol |ref| + atol); raises above 1."""
    worst = float(np.max(np.abs(got - ref) / (rtol * np.abs(ref) + atol)))
    if not worst <= 1.0:
        raise MolCheckFailed(f"{what}: error / bound {worst:.3e} > 1 (rtol "
                             f"{rtol:g}, atol {atol:g})")
    return worst


def check_line_lanes(sol, y0, rates, what):
    """All lanes SUCCESS and finite; lanes 0, M/2, M-1 against scipy."""
    m = sol.y.shape[0]
    if not bool((sol.status == 1).all()):
        bad = int((sol.status != 1).sum())
        raise MolCheckFailed(f"{what}: {bad} of {m} lanes not SUCCESS")
    if not bool(torch.isfinite(sol.y).all()):
        raise MolCheckFailed(f"{what}: non-finite y")
    worst = 0.0
    for i in (0, m // 2, m - 1):
        ref = scipy_line(y0[i].double().cpu().numpy(), float(rates[i, 0]),
                         d=y0.shape[1])
        worst = max(worst, worst_against(
            sol.y[i].double().cpu().numpy(), ref, 1e-3, 1e-6,
            f"{what} lane {i}"))
    return worst


@contextlib.contextmanager
def _labelled():
    """Name the tridiagonal sweeps, the jvp's and (through ``wrap_rhs``) the
    right-hand side for torch.profiler while a solve runs: the solver's
    module-level names are wrapped for the time of the block."""
    from torch.profiler import record_function

    def named(label, fn):
        def wrapped(*a, **kw):
            with record_function(label):
                return fn(*a, **kw)
        return wrapped

    saved = [(radau, "tridiag_solve_auto"),
             (radau, "tridiag_solve_complex_auto"),
             (radau, "jvp"), (precond, "jvp")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in saved]
    try:
        for mod, name, fn in saved:
            label = "mol.jvp" if name == "jvp" else "mol.tridiag"
            setattr(mod, name, named(label, fn))
        yield lambda f: named("mol.rhs", f)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def profile_solve(solve):
    """One ``solve(wrap_rhs)`` under torch.profiler: launches (kernels,
    copies and sets on the card), the card's busy ms, and per label
    (tridiag, jvp, rhs) the calls, the device ms of what they launched and
    the host ms inside them. The rhs label also counts the evaluations made
    inside a jvp."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with _labelled() as wrap_rhs:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            solve(wrap_rhs)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    # a labelled range also shows on the card's timeline, spanning what it
    # launched: it is no launch and no busy time
    on_card = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.name.startswith("mol.")]
    labels = {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name.startswith("mol."):
            rec = labels.setdefault(e.name[4:], [0, 0.0, 0.0])
            rec[0] += 1
            rec[1] += e.device_time_total / 1e3
            rec[2] += e.cpu_time_total / 1e3
    return {"launches": len(on_card),
            "busy_ms": sum(e.time_range.elapsed_us() for e in on_card) / 1e3,
            "profiled_wall_ms": wall_ms,
            "labels": {k: {"calls": v[0], "device_ms": v[1], "host_ms": v[2]}
                       for k, v in labels.items()}}


# ---- phases ----------------------------------------------------------------

def tridiag_phase(dev, reps=5):
    """Thomas against PCR on the card, real and complex, D=128."""
    out = {}
    for m in (1024, 65_536):
        rng = np.random.default_rng(m)

        def z(shift=0.0):
            return torch.as_tensor(rng.normal(size=(m, D_LINE)) + shift,
                                   device=dev)
        real = (z(), z(6.0), z(), z())
        cplx = ((z(), z()), (z(6.0), z()), (z(), z()), (z(), z()))
        rec = {}
        for kind, fn, sys_ in (("real", gm.tridiag_solve_auto, real),
                               ("complex", gm.tridiag_solve_complex_auto,
                                cplx)):
            xs = {meth: fn(*sys_, method=meth) for meth in ("thomas", "pcr")}
            a = torch.stack(list(xs["thomas"])) if kind == "complex" \
                else xs["thomas"]
            b = torch.stack(list(xs["pcr"])) if kind == "complex" \
                else xs["pcr"]
            err = float((a - b).abs().max() / a.abs().max())
            if not err <= 1e-10:
                raise MolCheckFailed(f"tridiag {kind} M={m}: Thomas and PCR "
                                     f"differ by {err:.3e} > 1e-10 relative")
            rec[kind] = {"rel_err": err}
            # in turns: thomas, pcr, pcr, thomas
            t = {"thomas": [], "pcr": []}
            for meth in ("thomas", "pcr", "pcr", "thomas"):
                t[meth].append(events_ms(
                    lambda: fn(*sys_, method=meth), reps))
            rec[kind].update({k + "_ms": statistics.mean(v)
                              for k, v in t.items()})
        out[m] = rec
        r_, c_ = rec["real"], rec["complex"]
        print(f"[tridiag on the card] D={D_LINE} M={m} f64: real Thomas "
              f"{r_['thomas_ms']:.3f} ms, PCR {r_['pcr_ms']:.3f} ms (differ "
              f"{r_['rel_err']:.2e}); complex Thomas {c_['thomas_ms']:.3f} "
              f"ms, PCR {c_['pcr_ms']:.3f} ms (differ {c_['rel_err']:.2e}) | "
              f"default on a CUDA tensor: {gm.CUDA_TRIDIAG}", flush=True)
    return out


def _line_solve(m, dtype, dev, opts, wrap=None):
    rhs, y0, args = mol_line(m, dtype, dev)
    return solve_radau(rhs if wrap is None else wrap(rhs), 0.0, TF_LINE, y0,
                       args=args, options=opts)


def mol_phase(dev, m, dtype, reps=3):
    """The MOL tridiag cell at M lanes: checks, times and one profile."""
    from janus_tpu_torch.ops import radau_fused as k4
    from janus_tpu_torch.ops import smalllu

    opts = Options(stage_solver="tridiag", **MOL_OPTS)
    name = f"MOL tridiag M={m} {str(dtype)[6:]}"
    _, y0, (_, rates) = mol_line(m, dtype, dev)
    smalllu.reset_launch_counts()
    k4.reset_launch_counts()
    sol = _line_solve(m, dtype, dev, opts)          # also the warm-up
    torch.cuda.synchronize()
    kernel_launches = (smalllu.lu_factor_t.launches
                       + smalllu.lu_solve_t.launches
                       + smalllu.linsolve_fused.launches
                       + k4.radau5_step.launches)
    if kernel_launches != 0:
        raise MolCheckFailed(f"{name}: the matrix-free path launched a "
                             f"kernel {kernel_launches} times")
    syncs = solve_radau.host_syncs
    worst = check_line_lanes(sol, y0, rates, name)
    ms = statistics.median(
        events_ms(lambda: _line_solve(m, dtype, dev, opts), 1)
        for _ in range(reps))
    prof = profile_solve(lambda wrap: _line_solve(m, dtype, dev, opts, wrap))
    st = sol.stats
    rec = {"ms_per_solve": ms, "host_syncs": syncs,
           "nsteps_max": int(st["nsteps"].max()),
           "naccept_mean": float(st["naccept"].double().mean()),
           "nnewton_max": int(st["nnewton"].max()),
           "worst_vs_scipy": worst, "busy_share": prof["busy_ms"] / ms,
           **prof}
    lab = prof["labels"]
    print(f"[{name}] all lanes SUCCESS; lanes 0, M/2, M-1 vs scipy Radau: "
          f"worst error / bound {worst:.3e} | {ms:.2f} ms per solve (median "
          f"of {reps}, CUDA events), steps max {rec['nsteps_max']}, Newton "
          f"trips max {rec['nnewton_max']}, host syncs {syncs}, launches "
          f"{prof['launches']}, device busy {prof['busy_ms']:.2f} ms = "
          f"{rec['busy_share']:.3f} of the solve | "
          + "; ".join(f"{k}: {v['calls']} calls, device {v['device_ms']:.2f} "
                      f"ms, host {v['host_ms']:.1f} ms"
                      for k, v in sorted(lab.items()))
          + f" (of {prof['profiled_wall_ms']:.1f} ms under the profiler) | "
          f"hand-written kernels launched: 0", flush=True)
    return rec, sol


def gmres_phase(dev, y_tridiag, m=1024):
    """The MOL lines through GMRES(8) and GMRES(25)."""
    out = {}
    for k in (8, 25):
        opts = Options(stage_solver="gmres", gmres_iters=k, **MOL_OPTS)
        t0 = time.perf_counter()
        sol = _line_solve(m, torch.float64, dev, opts)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        if not bool((sol.status == 1).all()):
            raise MolCheckFailed(f"MOL GMRES({k}): not every lane SUCCESS")
        err = float((sol.y - y_tridiag).abs().max() / y_tridiag.abs().max())
        if not err <= 1e-4:
            raise MolCheckFailed(f"MOL GMRES({k}): final state {err:.3e} > "
                                 "1e-4 relative from the tridiag solve's")
        out[k] = {"s_per_solve": sec, "rel_to_tridiag": err,
                  "host_syncs": solve_radau.host_syncs,
                  "nsteps_max": int(sol.stats["nsteps"].max())}
        print(f"[MOL GMRES({k}) M={m} f64] all lanes SUCCESS; final state "
              f"{err:.3e} relative from the tridiag solve's (bound 1e-4) | "
              f"{sec:.2f} s (one solve, host clock), steps max "
              f"{out[k]['nsteps_max']}, host syncs {out[k]['host_syncs']}",
              flush=True)
    return out


def heat_phase(dev, m=256, nx=32):
    """2-D Fisher-KPP, 32x32 grid, precond='lines', GMRES(8)."""
    dx = 1.0 / (nx + 1)
    xg = np.linspace(dx, 1.0 - dx, nx)
    xx, yy = np.meshgrid(xg, xg)
    u0 = np.exp(-40 * ((xx - 0.4) ** 2 + (yy - 0.55) ** 2)).ravel()
    y0 = torch.as_tensor(u0, device=dev).repeat(m, 1)
    rates = torch.linspace(1.0, 6.0, m, dtype=torch.float64,
                           device=dev)[:, None]
    nu, tf = 0.02, 0.3
    opts = Options(stage_solver="gmres", gmres_iters=8, precond="lines",
                   precond_block=nx, **MOL_OPTS)
    t0 = time.perf_counter()
    sol = solve_radau(heat_2d_rhs(nx, nx, dx), 0.0, tf, y0, args=(nu, rates),
                      options=opts)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    if not bool((sol.status == 1).all()):
        raise MolCheckFailed("heat 2-D: not every lane SUCCESS")

    def f1(t, y):
        g = y.reshape(nx, nx)
        lap = -4.0 * g
        lap[:, 1:] += g[:, :-1]
        lap[:, :-1] += g[:, 1:]
        lap[1:, :] += g[:-1, :]
        lap[:-1, :] += g[1:, :]
        return (nu * lap / dx ** 2).ravel() + 1.0 * y * (1 - y)

    ref = _scipy_radau(f1, u0, tf, _banded(nx * nx, (-nx, -1, 0, 1, nx)))
    worst = worst_against(sol.y[0].cpu().numpy(), ref, 1e-3, 1e-6,
                          "heat 2-D lane 0")
    print(f"[heat 2-D {nx}x{nx} D={nx * nx} M={m} f64, precond='lines', "
          f"GMRES(8)] all lanes SUCCESS; lane 0 vs scipy Radau: error / "
          f"bound {worst:.3e} | {sec:.2f} s (one solve, host clock), steps "
          f"max {int(sol.stats['nsteps'].max())}, host syncs "
          f"{solve_radau.host_syncs}", flush=True)
    return {"s_per_solve": sec, "worst_vs_scipy": worst}


def block_phase(dev, m=1024, ncell=24):
    """The interleaved stiff 2-species line, precond='block', GMRES(10)."""
    dx = 1.0 / (ncell + 1)
    k_stiff, tf = 200.0, 0.5
    y0_np = 1.0 + 0.2 * np.random.default_rng(3).normal(size=(m, 2 * ncell))
    rhs = interleaved_rhs(dx)
    opts = Options(rtol=1e-7, atol=1e-10, stage_solver="gmres",
                   gmres_iters=10, precond="block", precond_block=2)
    t0 = time.perf_counter()
    sol = solve_radau(rhs, 0.0, tf, torch.as_tensor(y0_np, device=dev),
                      args=k_stiff, options=opts)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    if not bool((sol.status == 1).all()):
        raise MolCheckFailed("block: not every lane SUCCESS")

    def f1(t, y):
        return rhs(None, torch.from_numpy(y)[None], k_stiff)[0].numpy()

    ref = _scipy_radau(f1, y0_np[0], tf, rtol=1e-9, atol=1e-12)
    worst = worst_against(sol.y[0].cpu().numpy(), ref, 1e-5, 1e-8,
                          "block lane 0")
    print(f"[interleaved 2-species D={2 * ncell} M={m} f64, precond='block' "
          f"(2x2), GMRES(10)] all lanes SUCCESS; lane 0 vs scipy Radau (rtol "
          f"1e-5 / atol 1e-8): error / bound {worst:.3e} | {sec:.2f} s (one "
          f"solve, host clock), steps max {int(sol.stats['nsteps'].max())}",
          flush=True)
    return {"s_per_solve": sec, "worst_vs_scipy": worst}


def ind_phase(dev, m=1024, lane=0):
    """K=2 IND directions (a bump in u0; the reaction rate) through the
    GMRES(8) stage solvers, against a central difference on one lane."""
    rhs, y0, (nu, rates) = mol_line(m, torch.float64, dev)
    d = y0.shape[1]
    xg = torch.linspace(0, 1, d + 2, dtype=torch.float64, device=dev)[1:-1]
    bump = torch.exp(-50 * (xg - 0.5) ** 2).repeat(m, 1)
    seeds = torch.stack([bump, torch.zeros_like(bump)])
    zeros = torch.zeros_like(rates)
    args_t = (torch.zeros(2, dtype=torch.float64, device=dev),
              torch.stack([zeros, torch.ones_like(rates)]))
    opts = Options(rtol=1e-6, atol=1e-9, stage_solver="gmres", gmres_iters=8)
    nu_t = torch.tensor(nu, dtype=torch.float64, device=dev)
    t0 = time.perf_counter()
    sol = solve_radau(rhs, 0.0, TF_LINE, y0, args=(nu_t, rates), options=opts,
                      tangents=seeds, args_tangents=args_t)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    if not bool((sol.status == 1).all()):
        raise MolCheckFailed("IND: not every lane SUCCESS")
    if not bool(torch.isfinite(sol.sens).all()):
        raise MolCheckFailed("IND: non-finite sens")

    # central differences on 8 copies of the lane: +-eps along each seed
    eps = 1e-4
    y8 = y0[lane].repeat(8, 1)
    r8 = rates[lane].repeat(8, 1)
    y8[0] += eps * bump[lane]
    y8[1] -= eps * bump[lane]
    r8[2] += eps
    r8[3] -= eps
    fd = solve_radau(rhs, 0.0, TF_LINE, y8, args=(nu_t, r8), options=opts).y
    fd_y = (fd[0] - fd[1]) / (2 * eps)
    fd_r = (fd[2] - fd[3]) / (2 * eps)
    errs = []
    for got, want, what in ((sol.sens[0, lane], fd_y, "y0 seed"),
                            (sol.sens[1, lane], fd_r, "rate seed")):
        err = float((got - want).abs().max() / want.abs().max())
        if not err <= 1e-4:
            raise MolCheckFailed(f"IND {what}: sens {err:.3e} > 1e-4 "
                                 "relative from the central difference")
        errs.append(err)
    print(f"[IND through GMRES(8) D={d} M={m} K=2 f64] all lanes SUCCESS, "
          f"sens finite; lane {lane} vs central difference (eps {eps:g}): "
          f"y0 seed {errs[0]:.3e}, rate seed {errs[1]:.3e} relative (bound "
          f"1e-4) | {sec:.2f} s (one solve, host clock), host syncs "
          f"{solve_radau.host_syncs}", flush=True)
    return {"s_per_solve": sec, "rel_err": errs}


PHASES = ("tridiag", "mol", "gmres", "heat", "block", "ind")


def run(dev, only=PHASES):
    """Run the named phases in order; returns their records."""
    report = {}
    if "tridiag" in only:
        report["tridiag"] = tridiag_phase(dev)
    y_tridiag = None
    if "mol" in only or "gmres" in only:
        rec, sol = mol_phase(dev, 1024, torch.float64)
        y_tridiag = sol.y
        report["mol_1024_f64"] = rec
    if "mol" in only:
        report["mol_1024_f32"] = mol_phase(dev, 1024, torch.float32)[0]
        report["mol_65536_f64"] = mol_phase(dev, 65_536, torch.float64)[0]
    if "gmres" in only:
        report["gmres"] = gmres_phase(dev, y_tridiag)
    if "heat" in only:
        report["heat"] = heat_phase(dev)
    if "block" in only:
        report["block"] = block_phase(dev)
    if "ind" in only:
        report["ind"] = ind_phase(dev)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="+", choices=PHASES, default=PHASES)
    ap.add_argument("--json", type=Path, default=None,
                    help="also write the JSON line to this file")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mol: no CUDA device", file=sys.stderr)
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
