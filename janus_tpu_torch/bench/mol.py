"""Drive, check and measure the matrix-free Radau path and the continuous
adjoint on a card.

The method-of-lines (MOL) and adjoint phases of ``chip_smoke.py``, also a
probe of their own, run from the root of a checkout on a machine with a CUDA
card:

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
- ``gmres``: the same lines with stage_solver='gmres', gmres_iters 8, and
  gmres_iters 25 over t in [0, 0.1]; final state within 1e-4 relative of the
  tridiag solve's;
- ``heat``: 2-D Fisher-KPP on a 32x32 grid (D=1,024), M=256, precond='lines',
  GMRES(8); lane 0 against scipy;
- ``block``: the cell-interleaved stiff 2-species line (D=48), M=1,024,
  precond='block' with 2x2 blocks, GMRES(10); lane 0 against scipy;
- ``ind``: K=2 IND seed directions through the GMRES(8) stage solvers on the
  D=128 line, M=1,024, t in [0, 0.1]; sens finite and within 1e-4 (relative to its largest
  entry) of a central finite difference of 8-lane solves;
- ``adjoint``: ``bench.py``'s MOL-adjoint gradient at full width -- the same
  line and options with adjoint_steps=48, loss sum(x y(T)^2), gradient with
  respect to y0 [M, 128] and the rates [M, 1] by ``radau_adjoint`` and
  ``loss.backward()`` -- at M = 1,024 in f64 and f32 and at M = 65,536 in
  f64: every gradient finite; ms per gradient and of the forward alone
  (median of 3 after a warm-up, CUDA events; f32 once), host syncs,
  max(naccept) against 48, the mesh's bytes, the peak allocated memory, and
  in f64 from one gradient under torch.profiler the launches and the busy
  share; at 1,024
  lanes in f64 also the rate gradient of lanes 0, M/2, M-1 within 2e-3
  relative of a central difference of forward solves at rtol 1e-8, the y0
  gradient along one random direction within 2e-3 of the IND directional
  derivative (``tangents=``, at rtol 1e-8), and a 4-lane gradient on the
  card within 1e-8
  (relative to its largest entry) of the same call on the CPU;
- ``vdp_adjoint``: the adjoint with its forward solve through the kernels K1
  and K2 -- 65,536 stiff Van der Pol lanes (y0 = (2, 0), mu = 1e3, t in
  [0, 1], Radau5, rtol 1e-6, pivoting=False, kernel_lu=True, analytic
  Jacobian), gradient of sum(y(T)^2) with respect to y0 and mu: K1 and K2
  launched, gradients finite, ms per gradient, and d/dmu of 3 lanes within
  2e-3 relative of a central difference at rtol 1e-9.

None of the MOL path launches a hand-written kernel (it runs no Pallas kernel
in the reference either); ``run`` resets the kernels' launch counts before the
MOL solve and the MOL gradient and checks that they are still 0 after them.
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

from janus_tpu_torch.bench.cpu_side import Later
from janus_tpu_torch.bench.kernels import events_ms
from janus_tpu_torch.control import precond
from janus_tpu_torch.linalg import gmres as gm
from janus_tpu_torch.models.problems import heat_2d_rhs
from janus_tpu_torch.models.problems import vdp_jac, vdp_rhs
from janus_tpu_torch.solve import Options, adjoint, radau
from janus_tpu_torch.solve.adjoint import radau_adjoint
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
    """Name the tridiagonal sweeps, the jvp's, the adjoint's vjp builds and
    (through ``wrap_rhs``) the right-hand side for torch.profiler while a
    solve runs: the solver's module-level names are wrapped for the time of
    the block."""
    from torch.profiler import record_function

    def named(label, fn):
        def wrapped(*a, **kw):
            with record_function(label):
                return fn(*a, **kw)
        return wrapped

    saved = [(radau, "tridiag_solve_auto"),
             (radau, "tridiag_solve_complex_auto"),
             (radau, "jvp"), (precond, "jvp"), (adjoint, "vjp")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in saved]
    try:
        for mod, name, fn in saved:
            label = "mol." + (name if name in ("jvp", "vjp") else "tridiag")
            setattr(mod, name, named(label, fn))
        yield lambda f: named("mol.rhs", f)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


RANGE_LABELS = ("mol.", "radau.")


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
    # a labelled range (these, and the solver's own radau.* scopes) also
    # shows on the card's timeline, spanning what it launched: it is no
    # launch and no busy time
    on_card = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.name.startswith(RANGE_LABELS)]
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


ADJ_STEPS = 48
_NOT_PROFILED = {"launches": None, "busy_ms": float("nan"),
                 "profiled_wall_ms": float("nan"), "labels": {}}


def _profiled(prof, busy_share, what):
    """The profile's part of a cell's line."""
    if prof["launches"] is None:
        return "not profiled"
    return (f"launches {prof['launches']}, device busy {prof['busy_ms']:.2f} "
            f"ms = {busy_share:.3f} of the {what} | "
            + "; ".join(f"{k}: {v['calls']} calls, device "
                        f"{v['device_ms']:.2f} ms, host {v['host_ms']:.1f} ms"
                        for k, v in sorted(prof["labels"].items()))
            + f" (of {prof['profiled_wall_ms']:.1f} ms under the profiler)")


def _kernel_launches():
    from janus_tpu_torch.ops import radau_fused as k4
    from janus_tpu_torch.ops import smalllu
    return {"K1": smalllu.lu_factor_t.launches,
            "K2": smalllu.lu_solve_t.launches,
            "K3": smalllu.linsolve_fused.launches,
            "K4": k4.radau5_step.launches}


def _reset_kernel_launches():
    from janus_tpu_torch.ops import radau_fused as k4
    from janus_tpu_torch.ops import smalllu
    smalllu.reset_launch_counts()
    k4.reset_launch_counts()


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


def _line_solve(m, dtype, dev, opts, wrap=None, tf=TF_LINE):
    rhs, y0, args = mol_line(m, dtype, dev)
    return solve_radau(rhs if wrap is None else wrap(rhs), 0.0, tf, y0,
                       args=args, options=opts)


def mol_phase(dev, m, dtype, reps=3, profile=True):
    """The MOL tridiag cell at M lanes: checks, times and, with
    ``profile``, one solve under torch.profiler."""
    opts = Options(stage_solver="tridiag", **MOL_OPTS)
    name = f"MOL tridiag M={m} {str(dtype)[6:]}"
    _, y0, (_, rates) = mol_line(m, dtype, dev)
    _reset_kernel_launches()
    sol = _line_solve(m, dtype, dev, opts)          # also the warm-up
    torch.cuda.synchronize()
    if any(_kernel_launches().values()):
        raise MolCheckFailed(f"{name}: the matrix-free path launched a "
                             f"kernel: {_kernel_launches()}")
    syncs = solve_radau.host_syncs
    worst = check_line_lanes(sol, y0, rates, name)
    ms = statistics.median(
        events_ms(lambda: _line_solve(m, dtype, dev, opts), 1)
        for _ in range(reps))
    prof = profile_solve(lambda wrap: _line_solve(m, dtype, dev, opts, wrap)
                         ) if profile else _NOT_PROFILED
    st = sol.stats
    rec = {"ms_per_solve": ms, "host_syncs": syncs,
           "nsteps_max": int(st["nsteps"].max()),
           "naccept_mean": float(st["naccept"].double().mean()),
           "nnewton_max": int(st["nnewton"].max()),
           "worst_vs_scipy": worst, "busy_share": prof["busy_ms"] / ms,
           **prof}
    print(f"[{name}] all lanes SUCCESS; lanes 0, M/2, M-1 vs scipy Radau: "
          f"worst error / bound {worst:.3e} | {ms:.2f} ms per solve (median "
          f"of {reps}, CUDA events), steps max {rec['nsteps_max']}, Newton "
          f"trips max {rec['nnewton_max']}, host syncs {syncs} | "
          f"{_profiled(prof, rec['busy_share'], 'solve')} | hand-written "
          f"kernels launched: 0", flush=True)
    return rec, sol


def gmres_phase(dev, y_tridiag, m=1024, span25=TF_LINE / 4):
    """The MOL lines through GMRES(8), and through GMRES(25) over the first
    ``span25`` of the span (the path is host bound, so its time follows the
    steps, not the lanes)."""
    out = {}
    for k, tf in ((8, TF_LINE), (25, span25)):
        opts = Options(stage_solver="gmres", gmres_iters=k, **MOL_OPTS)
        y_ref = y_tridiag if tf == TF_LINE else _line_solve(
            m, torch.float64, dev, opts.replace(stage_solver="tridiag"),
            tf=tf).y
        t0 = time.perf_counter()
        sol = _line_solve(m, torch.float64, dev, opts, tf=tf)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        if not bool((sol.status == 1).all()):
            raise MolCheckFailed(f"MOL GMRES({k}): not every lane SUCCESS")
        err = float((sol.y - y_ref).abs().max() / y_ref.abs().max())
        if not err <= 1e-4:
            raise MolCheckFailed(f"MOL GMRES({k}): final state {err:.3e} > "
                                 "1e-4 relative from the tridiag solve's")
        out[k] = {"s_per_solve": sec, "tf": tf, "rel_to_tridiag": err,
                  "host_syncs": solve_radau.host_syncs,
                  "nsteps_max": int(sol.stats["nsteps"].max())}
        print(f"[MOL GMRES({k}) M={m} f64, t in [0, {tf:g}]] all lanes "
              f"SUCCESS; final state "
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


def block_phase(dev, m=1024, ncell=24, tf=0.5):
    """The interleaved stiff 2-species line, precond='block', GMRES(10),
    over t in [0, tf]."""
    dx = 1.0 / (ncell + 1)
    k_stiff = 200.0
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
          f"(2x2), GMRES(10), t in [0, {tf:g}]] all lanes SUCCESS; lane 0 vs scipy Radau (rtol "
          f"1e-5 / atol 1e-8): error / bound {worst:.3e} | {sec:.2f} s (one "
          f"solve, host clock), steps max {int(sol.stats['nsteps'].max())}",
          flush=True)
    return {"s_per_solve": sec, "worst_vs_scipy": worst}


def ind_phase(dev, m=1024, lane=0, tf=TF_LINE / 4):
    """K=2 IND directions (a bump in u0; the reaction rate) through the
    GMRES(8) stage solvers over the first quarter of the span, against a
    central difference on one lane."""
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
    sol = solve_radau(rhs, 0.0, tf, y0, args=(nu_t, rates), options=opts,
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
    fd = solve_radau(rhs, 0.0, tf, y8, args=(nu_t, r8), options=opts).y
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
    print(f"[IND through GMRES(8) D={d} M={m} K=2 f64, t in [0, {tf:g}]] "
          f"all lanes SUCCESS, "
          f"sens finite; lane {lane} vs central difference (eps {eps:g}): "
          f"y0 seed {errs[0]:.3e}, rate seed {errs[1]:.3e} relative (bound "
          f"1e-4) | {sec:.2f} s (one solve, host clock), host syncs "
          f"{solve_radau.host_syncs}", flush=True)
    return {"s_per_solve": sec, "rel_err": errs}


def line_gradient(m, dtype, dev, opts, wrap=None, backward=True):
    """bench.py's MOL-adjoint loss sum(x y(T)^2) on the m-lane line and its
    gradient: (loss, dL/dy0 [m, D], dL/drates [m, 1])."""
    rhs, y0, (nu, rates) = mol_line(m, dtype, dev)
    y0.requires_grad_()
    rates.requires_grad_()
    d = y0.shape[1]
    xg = torch.linspace(0, 1, d + 2, dtype=dtype, device=dev)[1:-1]
    y_end = radau_adjoint(rhs if wrap is None else wrap(rhs), (0.0, TF_LINE),
                          y0, args=(nu, rates), options=opts)
    loss = torch.sum(xg * y_end ** 2)
    if not backward:
        return loss, None, None
    loss.backward()
    return loss.detach(), y0.grad, rates.grad


def _check_line_gradient(dev, opts, g_y0, g_rates, on_cpu):
    """The 1,024-lane f64 gradient against central differences, IND and the
    CPU (on_cpu: the ``Later`` of line_gradient's 4 CPU lanes); returns the
    three worst relative errors."""
    m, dtype = g_y0.shape[0], torch.float64
    rhs, y0, (nu, rates) = mol_line(m, dtype, dev)
    d = y0.shape[1]
    xg = torch.linspace(0, 1, d + 2, dtype=dtype, device=dev)[1:-1]
    lanes = [0, m // 2, m - 1]
    # central differences in each lane's own rate: 6 lanes, rtol 1e-8
    eps = 1e-4
    r6 = rates[lanes].repeat(2, 1)
    r6[:3] += eps
    r6[3:] -= eps
    tight = opts.replace(rtol=1e-8, atol=1e-11)
    y6 = solve_radau(rhs, 0.0, TF_LINE, y0[lanes].repeat(2, 1),
                     args=(nu, r6), options=tight).y
    l6 = torch.sum(xg * y6 ** 2, dim=-1)
    fd = (l6[:3] - l6[3:]) / (2 * eps)
    err_fd = float(((g_rates[lanes, 0] - fd).abs() / fd.abs()).max())
    if not err_fd <= 2e-3:
        raise MolCheckFailed(f"MOL adjoint: d/drate of lanes {lanes} "
                             f"{g_rates[lanes, 0].tolist()} vs central "
                             f"difference {fd.tolist()}: {err_fd:.3e} > 2e-3")
    # <dL/dy0, v> against the IND directional derivative, at rtol 1e-8 too
    # (IND's tangent iteration stops at the Newton tolerance, sqrt(rtol): at
    # the gradient's own rtol 1e-4 IND is the less accurate side)
    v = torch.as_tensor(np.random.default_rng(14).standard_normal((1, m, d)),
                        device=dev)
    sol = solve_radau(rhs, 0.0, TF_LINE, y0, args=(nu, rates), options=tight,
                      tangents=v)
    ind = float(torch.sum(2 * xg * sol.y * sol.sens[0]))
    got = float(torch.sum(g_y0 * v[0]))
    err_ind = abs(got - ind) / abs(ind)
    if not err_ind <= 2e-3:
        raise MolCheckFailed(f"MOL adjoint: <dL/dy0, v> {got:.9g} vs IND "
                             f"{ind:.9g}: {err_ind:.3e} > 2e-3")
    # 4 lanes on the card against the same call on the CPU
    on_card = line_gradient(4, dtype, dev, opts)
    on_cpu = on_cpu.result()
    err_cpu = max(float((a.cpu() - b).abs().max() / b.abs().max())
                  for a, b in zip(on_card[1:], on_cpu[1:]))
    if not err_cpu <= 1e-8:
        raise MolCheckFailed(f"MOL adjoint: 4-lane gradient on the card "
                             f"{err_cpu:.3e} > 1e-8 relative from the CPU's")
    return err_fd, err_ind, err_cpu


def adjoint_phase(dev, m, dtype, reps=3, checks=False, profile=True):
    """The MOL-adjoint cell at M lanes: checks, times and, with ``profile``,
    one gradient under torch.profiler (launches, busy share, labels).
    ``reps=0`` times the checked calls themselves: the first gradient (its
    warm-up included) and the check's forward."""
    opts = Options(stage_solver="tridiag", adjoint_steps=ADJ_STEPS,
                   **MOL_OPTS)
    name = f"MOL adjoint M={m} {str(dtype)[6:]}"
    rhs, y0, (nu, rates) = mol_line(m, dtype, dev)
    d = y0.shape[1]
    mesh_bytes = m * ADJ_STEPS * (2 + (opts.min_stages + 1) * d) \
        * y0.element_size()
    free, total = torch.cuda.mem_get_info(dev)
    if free < 1.5 * mesh_bytes:
        raise MolCheckFailed(
            f"{name}: the mesh takes {mesh_bytes / 1e9:.2f} GB and the card "
            f"has {free / 1e9:.2f} of {total / 1e9:.2f} GB free")

    def forward():
        with torch.no_grad():
            return solve_radau(rhs, 0.0, TF_LINE, y0, args=(nu, rates),
                               options=opts, _mesh_size=ADJ_STEPS)

    # the checks' CPU side, in a worker beside the card's work
    on_cpu = (Later(line_gradient, 4, torch.float64, torch.device("cpu"),
                    opts) if checks else None)
    _reset_kernel_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    first = []
    ms_first = events_ms(lambda: first.append(
        line_gradient(m, dtype, dev, opts)), 1)       # also the warm-up
    _, g_y0, g_rates = first[0]
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    syncs = (solve_radau.host_syncs, radau_adjoint.host_syncs)
    if any(_kernel_launches().values()):
        raise MolCheckFailed(f"{name}: the matrix-free gradient launched a "
                             f"kernel: {_kernel_launches()}")
    if not bool(torch.isfinite(g_y0).all() and torch.isfinite(g_rates).all()):
        raise MolCheckFailed(f"{name}: non-finite gradient")
    fwd = []
    ms_fwd_first = events_ms(lambda: fwd.append(forward()), 1)
    sol = fwd[0]
    nacc = int(sol.stats["naccept"].max())
    if not bool((sol.status == 1).all()) or nacc > ADJ_STEPS:
        raise MolCheckFailed(f"{name}: forward not SUCCESS on every lane, or "
                             f"max(naccept) {nacc} > {ADJ_STEPS}")
    del sol
    errs = (_check_line_gradient(dev, opts, g_y0, g_rates, on_cpu)
            if checks else None)
    if reps:
        ms = statistics.median(
            events_ms(lambda: line_gradient(m, dtype, dev, opts), 1)
            for _ in range(reps))
        ms_fwd = statistics.median(events_ms(forward, 1)
                                   for _ in range(reps))
    else:
        ms, ms_fwd = ms_first, ms_fwd_first
    prof = profile_solve(
        lambda wrap: line_gradient(m, dtype, dev, opts, wrap)) if profile \
        else _NOT_PROFILED
    rec = {"ms_per_gradient": ms, "ms_forward": ms_fwd,
           "host_syncs_forward": syncs[0], "host_syncs_backward": syncs[1],
           "naccept_max": nacc, "adjoint_steps": ADJ_STEPS,
           "mesh_bytes": mesh_bytes, "peak_allocated_bytes": peak,
           "busy_share": prof["busy_ms"] / ms, "checks": errs, **prof}
    profiled = _profiled(prof, rec["busy_share"], "gradient")
    print(f"[{name}] gradients finite | {ms:.2f} ms per gradient, forward "
          f"alone (with the mesh) {ms_fwd:.2f} ms ("
          + (f"medians of {reps}" if reps else "the checked calls, the "
             "gradient's warm-up included")
          + f", CUDA events) | host syncs {syncs[0]} forward + {syncs[1]} backward | "
          f"max(naccept) {nacc} of {ADJ_STEPS}, mesh {mesh_bytes / 1e6:.1f} "
          f"MB, peak allocated {peak / 1e6:.1f} MB | {profiled} | "
          "hand-written kernels launched: 0"
          + ("" if errs is None else
             f" | d/drate of lanes 0, M/2, M-1 vs central difference at rtol "
             f"1e-8: {errs[0]:.3e} (bound 2e-3); <dL/dy0, v> vs IND at rtol "
             f"1e-8: {errs[1]:.3e} (bound 2e-3); 4 lanes vs the CPU: "
             f"{errs[2]:.3e} (bound 1e-8)"), flush=True)
    return rec


def vdp_adjoint_phase(dev, m=65_536, reps=3):
    """The adjoint whose forward solve runs through K1/K2: Radau5 on stiff
    Van der Pol lanes, gradient of sum(y(T)^2) in y0 and mu."""
    dtype = torch.float64
    opts = Options(rtol=1e-6, atol=1e-9, pivoting=False, kernel_lu=True,
                   adjoint_steps=64)

    def gradient(n=m, mu0=1e3):
        y0 = torch.tensor([[2.0, 0.0]], dtype=dtype, device=dev).repeat(n, 1)
        mus = torch.full((n,), mu0, dtype=dtype, device=dev)
        y0.requires_grad_()
        mus.requires_grad_()
        y_end = radau_adjoint(vdp_rhs, (0.0, 1.0), y0, args=mus,
                              options=opts, jac=vdp_jac)
        torch.sum(y_end ** 2).backward()
        return y0.grad, mus.grad

    _reset_kernel_launches()
    g_y0, g_mu = gradient()
    torch.cuda.synchronize()
    launches = _kernel_launches()
    syncs = (solve_radau.host_syncs, radau_adjoint.host_syncs)
    if launches["K1"] <= 0 or launches["K2"] <= 0:
        raise MolCheckFailed(f"VdP adjoint: the forward solve did not go "
                             f"through K1/K2: {launches}")
    if not bool(torch.isfinite(g_y0).all() and torch.isfinite(g_mu).all()):
        raise MolCheckFailed("VdP adjoint: non-finite gradient (mesh "
                             "overflow or a singular backward factor)")
    # every lane is the same problem: lanes 0, M/2, M-1 against one central
    # difference in mu (plain LU, rtol 1e-9)
    eps = 1e-2
    y2 = torch.tensor([[2.0, 0.0]], dtype=dtype, device=dev).repeat(2, 1)
    mu2 = torch.tensor([1e3 + eps, 1e3 - eps], dtype=dtype, device=dev)
    yt = solve_radau(vdp_rhs, 0.0, 1.0, y2, args=mu2, jac=vdp_jac,
                     options=Options(rtol=1e-9, atol=1e-12)).y
    fd = float((yt[0] ** 2).sum() - (yt[1] ** 2).sum()) / (2 * eps)
    lanes = [0, m // 2, m - 1]
    err = float(((g_mu[lanes] - fd).abs() / abs(fd)).max())
    if not err <= 2e-3:
        raise MolCheckFailed(f"VdP adjoint: d/dmu {g_mu[lanes].tolist()} vs "
                             f"central difference {fd:.9g}: {err:.3e} > 2e-3")
    ms = statistics.median(events_ms(gradient, 1) for _ in range(reps))
    print(f"[VdP adjoint through K1/K2 M={m} f64, Radau5 rtol 1e-6] gradients "
          f"finite | forward launches K1 {launches['K1']}, K2 "
          f"{launches['K2']} (K3 {launches['K3']}, K4 {launches['K4']}) | "
          f"{ms:.2f} ms per gradient (median of {reps}, CUDA events), host "
          f"syncs {syncs[0]} forward + {syncs[1]} backward | d/dmu of lanes "
          f"0, M/2, M-1 vs central difference at rtol 1e-9: {err:.3e} (bound "
          f"2e-3)", flush=True)
    return {"ms_per_gradient": ms, "launches": launches, "rel_err_fd": err,
            "host_syncs_forward": syncs[0], "host_syncs_backward": syncs[1]}


PHASES = ("tridiag", "mol", "gmres", "heat", "block", "ind", "adjoint",
          "vdp_adjoint")


def run(dev, only=PHASES, smoke=False):
    """Run the named phases in order; returns their records, with the
    seconds each phase took under ``"seconds"``. ``smoke`` (chip_smoke's
    phases 13-14) times each cell once (each adjoint cell by its checked
    calls), profiles no cell (reading a
    ~60k-launch solve's profile takes tens of seconds), and runs GMRES(25),
    the block and the IND solves over shorter spans; every check stays."""
    report, seconds = {}, {}
    reps = 1 if smoke else 3
    small_profile = not smoke

    def timed(phase, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(dev, *a, **kw)
        torch.cuda.synchronize()
        seconds[phase] = seconds.get(phase, 0.0) + time.perf_counter() - t0
        return out

    f32, f64 = torch.float32, torch.float64
    if "tridiag" in only:
        report["tridiag"] = timed("tridiag", tridiag_phase)
    y_tridiag = None
    if "mol" in only or "gmres" in only:
        report["mol_1024_f64"], sol = timed("mol", mol_phase, 1024, f64,
                                            reps, small_profile)
        y_tridiag = sol.y
    if "mol" in only:
        report["mol_1024_f32"] = timed("mol", mol_phase, 1024, f32, reps,
                                       small_profile)[0]
        report["mol_65536_f64"] = timed("mol", mol_phase, 65_536, f64,
                                        reps, not smoke)[0]
    if "gmres" in only:
        report["gmres"] = timed("gmres", gmres_phase, y_tridiag,
                                span25=TF_LINE / (64 if smoke else 4))
    if "heat" in only:
        report["heat"] = timed("heat", heat_phase)
    if "block" in only:
        report["block"] = timed("block", block_phase,
                                tf=0.00390625 if smoke else 0.5)
    if "ind" in only:
        report["ind"] = timed("ind", ind_phase,
                              tf=TF_LINE / (128 if smoke else 4))
    if "adjoint" in only:
        adj_reps = 0 if smoke else reps
        report["adjoint_1024_f64"] = timed("adjoint", adjoint_phase, 1024,
                                           f64, reps=adj_reps, checks=True,
                                           profile=small_profile)
        report["adjoint_1024_f32"] = timed("adjoint", adjoint_phase, 1024,
                                           f32, reps=min(adj_reps, 1),
                                           profile=False)
        report["adjoint_65536_f64"] = timed("adjoint", adjoint_phase, 65_536,
                                            f64, reps=adj_reps,
                                            profile=small_profile)
    if "vdp_adjoint" in only:
        report["vdp_adjoint"] = timed("vdp_adjoint", vdp_adjoint_phase,
                                      reps=reps)
    report["seconds"] = seconds
    print("[phase seconds] " + ", ".join(f"{k} {v:.1f}"
                                         for k, v in seconds.items()),
          flush=True)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="+", choices=PHASES, default=PHASES)
    ap.add_argument("--json", type=Path, default=None,
                    help="also write the JSON line to this file")
    ap.add_argument("--smoke", action="store_true",
                    help="chip_smoke's phases 13-14: one timed run a cell, "
                         "one profile (the 65,536-lane MOL solve), shorter "
                         "spans")
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
              **run(torch.device("cuda:0"), a.only, smoke=a.smoke)}
    line = json.dumps(report)
    if a.json is not None:
        a.json.parent.mkdir(parents=True, exist_ok=True)
        a.json.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
