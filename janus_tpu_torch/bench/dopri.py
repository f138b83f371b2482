"""Drive, check and measure the explicit family, its discrete adjoint (the
neural-ODE training path) and the rest of the Radau surface on a card.

Phase 16 of ``chip_smoke.py`` (``run(dev, smoke=True)``), and a probe of its
own, run from the root of a checkout on a machine with a CUDA card:

    python3 -m janus_tpu_torch.bench.dopri [--only PHASE ...] [--json PATH]

Phases (``PHASES``), each raising ``DopriCheckFailed`` when its check fails:
- ``forward`` (a): the configuration of the reference's dopri tests (Van der
  Pol, y0 = (2, 0), t in [0, 10], rtol 1e-7, atol 1e-9) widened to 65,536
  lanes with mu = logspace(-1, 0.5), f64, through dopri5 and dopri853: s per
  solve (median of 3 after a warm-up, CUDA events), attempts, host syncs,
  launches and the device's busy share (one solve under torch.profiler),
  K1-K4 launched 0 times; 8 lanes against scipy's RK45 / DOP853 at the same
  tolerances (within 1e-5 relative + 1e-6 absolute, the tests' bound); and,
  from one solve with ``record_steps``, the share of attempts in which no
  lane accepted (what a gate on dop853's three extra interpolation stages
  could skip).
- ``node`` (b): the neural-ODE gradient of ``examples/neural_ode_dopri.py``
  -- MLP [2, 64, 64, 2] (tanh), T = 3, 8 ``t_eval`` samples, rtol 1e-6,
  atol 1e-9, ``adjoint_steps=32``, the mean squared fit to a damped spiral
  -- at 65,536 lanes in f64 and f32, without and with the kinetic running
  cost (lambda = 1e-3, ``cost=``): ms per gradient (median of 3, CUDA
  events), host syncs, launches and busy share (one gradient under the
  profiler); 20 ``torch.optim.Adam(lr=3e-3)`` steps whose loss must fall;
  in f64, dL/dy0 of 4 lanes of the measured batch against the CPU's
  gradient of those 4 lanes alone (scaled by M / 4: the loss is a mean over
  lanes), and the weight gradient of a 4-lane batch on the card against
  the CPU (each within 1e-7 relative to the largest entry).
- ``step_args`` (c): the Radau9 headline lanes (65,536 stiff VdP, mu = 1e3,
  rtol 1e-6, pivoting=False, kernel_lu=True, the analytic Jacobian; no
  tangents, which step_args refuses) with constant slab rows (mu x 1) and
  ``record_steps=64``, against the plain solve: t, y, status and every
  counter equal to the bit, the same K1/K2 launches, the step log's write
  index equal to nsteps; s per solve of each, in turns (plain, step_args,
  step_args, plain) after a first solve of each (which builds K1/K2).
- ``hvp`` (d): ``radau_hvp`` on 65,536 VdP lanes, mu = logspace(0, 1),
  rtol 1e-8, loss sum(y(T)^2), direction (v_y0, v_mu) = ((0.5, -0.3), 1),
  the augmented D=4 forward through K1/K2 (kernel_lu=True): ms per HVP
  (median of 3), K1/K2 launches, gdotv finite; 3 lanes against central
  differences (eps 1e-3) of ``radau_adjoint`` gradients (1e-3 relative
  + 1e-8 in y0, 5e-3 in mu: the bounds of the reference's test).
- ``qr`` (e): ``Options(qr_fallback=True)`` on the mixed batch of the
  reference's qr test widened to 65,536 lanes (even lanes an identity
  mass, odd lanes the permuted mass whose pivot-free LU breaks at every
  h): every lane SUCCESS, the exact solutions within 1e-8, 8 lanes against
  the same solve on the CPU (status and counters equal, y to 1e-10); s per
  solve and host syncs.

``run(dev, smoke=True)`` is chip_smoke's phase 16: (a) for dopri5 once with
its scipy check, one (b) gradient at 8,192 lanes f64 with its CPU checks,
(c) once, and (d) at 1,024 lanes with its checks; no medians, no profiler,
no Adam, no f32.
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

from janus_tpu_torch.bench import mol
from janus_tpu_torch.bench.kernels import events_ms
from janus_tpu_torch.models.neural import mlp_apply, mlp_init
from janus_tpu_torch.models.problems import vdp_jac, vdp_rhs
from janus_tpu_torch.solve import Options, radau_adjoint, radau_hvp
from janus_tpu_torch.solve.adjoint_dopri import dopri_adjoint
from janus_tpu_torch.solve.dopri import TABLEAUS, solve_erk
from janus_tpu_torch.solve.radau import solve_radau

M = 65_536
FWD_OPTS = dict(rtol=1e-7, atol=1e-9)
ORACLE = {"dopri5": "RK45", "dopri853": "DOP853"}
T_FINAL = 3.0
N_SAMPLE = 8
SIZES = (2, 64, 64, 2)
NODE_OPTS = dict(rtol=1e-6, atol=1e-9, adjoint_steps=32)
REG = 1e-3
M_NODE_SMOKE = 8192


class DopriCheckFailed(RuntimeError):
    """A phase's check did not hold."""


def _logspace(lo, hi, m, dtype, dev):
    """logspace(lo, hi, m) made on the CPU in f64, so that every device and
    dtype sees the same values (rounded once)."""
    return torch.logspace(lo, hi, m, dtype=torch.float64).to(dev, dtype)


def _lanes(m, n=8):
    return np.linspace(0, m - 1, n).round().astype(int).tolist()


# ---- (a) the forward solve -------------------------------------------------

def forward_solve(method, m, dev, record_steps=0, wrap=None):
    y0 = torch.tensor([[2.0, 0.0]], dtype=torch.float64, device=dev) \
        .repeat(m, 1)
    mus = _logspace(-1.0, 0.5, m, torch.float64, dev)
    return solve_erk(TABLEAUS[method], vdp_rhs if wrap is None
                     else wrap(vdp_rhs), 0.0, 10.0, y0, mus,
                     Options(**FWD_OPTS, record_steps=record_steps))


def scipy_worst(method, y_got, mus, lanes):
    """Worst error / bound (1e-5 relative + 1e-6) of lanes against scipy's
    explicit pair at the solve's tolerances."""
    from scipy.integrate import solve_ivp as scipy_ivp
    worst = 0.0
    for i in lanes:
        mu = float(mus[i])
        ref = scipy_ivp(
            lambda t, y: [y[1], mu * (1 - y[0] ** 2) * y[1] - y[0]],
            (0.0, 10.0), [2.0, 0.0], method=ORACLE[method],
            **FWD_OPTS).y[:, -1]
        e = np.abs(y_got[i] - ref) / (1e-5 * np.abs(ref) + 1e-6)
        if not np.all(e <= 1.0):
            raise DopriCheckFailed(f"{method} lane {i} (mu={mu:.4g}): y "
                                   f"{y_got[i]} vs scipy {ref}")
        worst = max(worst, float(e.max()))
    return worst


def no_accept_share(dyn):
    """The share of the loop's attempts in which no lane accepted, from the
    step log (attempt k of the loop is slot k of every lane still
    running)."""
    idx = dyn["idx"].to(torch.int64)
    k = torch.arange(dyn["accepted"].shape[1], device=idx.device)
    attempted = k[None, :] < idx[:, None]
    any_acc = (dyn["accepted"] & attempted).any(dim=0)
    trips = int(idx.max())
    return float((~any_acc[:trips]).double().mean()), trips


def forward_phase(dev, method, m=M, reps=3, smoke=False):
    name = f"{method} forward M={m} f64"
    mol._reset_kernel_launches()
    sol = forward_solve(method, m, dev)                 # also the warm-up
    torch.cuda.synchronize()
    launches = mol._kernel_launches()
    syncs = solve_erk.host_syncs
    if not bool((sol.status == 1).all()):
        raise DopriCheckFailed(f"{name}: not SUCCESS on every lane")
    if any(launches.values()):
        raise DopriCheckFailed(f"{name}: launched a kernel: {launches}")
    mus = _logspace(-1.0, 0.5, m, torch.float64, torch.device("cpu"))
    lanes = _lanes(m)
    worst = scipy_worst(method, sol.y.cpu().numpy(), mus.numpy(), lanes)
    trips = int(sol.stats["nsteps"].max())
    rec = {"attempts": trips, "host_syncs": syncs,
           "naccept_max": int(sol.stats["naccept"].max()),
           "scipy_worst": worst, "kernel_launches": launches}
    extra = ""
    if not smoke:
        rec["s_per_solve"] = statistics.median(
            events_ms(lambda: forward_solve(method, m, dev), 1) / 1e3
            for _ in range(reps))
        prof = mol.profile_solve(lambda wrap: forward_solve(method, m, dev,
                                                            wrap=wrap))
        rec.update(launches=prof["launches"], busy_ms=prof["busy_ms"],
                   busy_share=prof["busy_ms"] / (rec["s_per_solve"] * 1e3))
        share, _ = no_accept_share(forward_solve(method, m, dev,
                                                 record_steps=trips).dyn)
        rec["no_accept_share"] = share
        extra = (f" | {rec['s_per_solve']:.4f} s per solve (median of {reps},"
                 f" CUDA events) | launches {prof['launches']}, device busy "
                 f"{prof['busy_ms']:.2f} ms = {rec['busy_share']:.3f} of the "
                 f"solve (one solve under torch.profiler) | attempts in which"
                 f" no lane accepted: {share:.4f}")
    print(f"[{name} VdP mu=logspace(-1,0.5) t in [0,10] rtol 1e-7] SUCCESS "
          f"on every lane | attempts {trips}, max(naccept) "
          f"{rec['naccept_max']}, host syncs {syncs} | K1-K4 launches 0 | "
          f"lanes {lanes} vs scipy {ORACLE[method]}: worst error / bound "
          f"{worst:.3e}" + extra, flush=True)
    return rec


# ---- (b) the neural-ODE gradient -------------------------------------------

def true_rhs(t, y, args):
    """The flow the network learns: a damped spiral with a cubic twist."""
    return torch.stack([-0.1 * y[..., 0] + 2.0 * y[..., 1],
                        -2.0 * y[..., 0] - 0.1 * y[..., 1]
                        - 0.3 * y[..., 1] ** 3], dim=-1)


def nn_rhs(t, y, params):
    return mlp_apply(params, y)


def kinetic(t, y, params):
    return torch.sum(mlp_apply(params, y) ** 2, dim=-1)


def node_data(m, dtype, dev, seed=0):
    """(y0 [m, 2], the sample times [8], the true samples [m, 8, 2]): y0
    uniform in [-1.5, 1.5]² from a numpy seed, the samples by dopri5 at rtol
    1e-9 in f64, then cast to dtype."""
    y0 = torch.from_numpy(np.random.default_rng(seed).uniform(
        -1.5, 1.5, (m, 2))).to(dev)
    ts = torch.linspace(T_FINAL / N_SAMPLE, T_FINAL, N_SAMPLE,
                        dtype=torch.float64, device=dev)
    sol = solve_erk(TABLEAUS["dopri5"], true_rhs, 0.0, T_FINAL, y0, None,
                    Options(rtol=1e-9, atol=1e-12), t_eval=ts)
    if not bool((sol.status == 1).all()):
        raise DopriCheckFailed("neural ODE: the data solve failed a lane")
    return y0.to(dtype), ts.to(dtype), sol.ys.to(dtype)


def node_params(dtype, dev, seed=0):
    """MLP [2, 64, 64, 2] weights from a seeded torch.Generator, as leaf
    tensors that require grad."""
    params = mlp_init(SIZES, torch.Generator().manual_seed(seed), dtype,
                      dev)
    for leaf in params["w"] + params["b"]:
        leaf.requires_grad_()
    return params


def node_loss(params, data, reg=0.0, wrap=None):
    """The example's loss: mean squared fit of the samples (+ reg · mean of
    the kinetic running cost)."""
    y0, ts, ys_true = data
    f = nn_rhs if wrap is None else wrap(nn_rhs)
    opts = Options(**NODE_OPTS)
    if reg > 0.0:
        ys, q = dopri_adjoint(f, (0.0, T_FINAL), y0, args=params,
                              options=opts, t_eval=ts, cost=kinetic)
        return torch.mean((ys - ys_true) ** 2) + reg * torch.mean(q)
    ys = dopri_adjoint(f, (0.0, T_FINAL), y0, args=params, options=opts,
                       t_eval=ts)
    return torch.mean((ys - ys_true) ** 2)


def node_gradient(params, data, reg=0.0, wrap=None):
    """The loss and its gradient in every weight, and last in y0 where y0
    requires grad."""
    wrt = params["w"] + params["b"]
    if data[0].requires_grad:
        wrt = wrt + [data[0]]
    loss = node_loss(params, data, reg, wrap)
    return loss.detach(), torch.autograd.grad(loss, wrt)


def node_cpu_check(dev, dtype, reg):
    """The gradient of 4 lanes on the card against the CPU: max error
    relative to each leaf's largest entry."""
    cpu = torch.device("cpu")
    grads = []
    for d in (dev, cpu):
        params = node_params(dtype, d)
        grads.append(node_gradient(params, node_data(4, dtype, d), reg)[1])
    return max(float((a.cpu() - b).abs().max() / b.abs().max())
               for a, b in zip(*grads))


def node_lane_check(params, data, reg, g_y0, lanes):
    """dL/dy0 of ``lanes`` of a batch's gradient against the CPU's gradient
    of those lanes alone, on the same y0, samples and weights: each lane
    steps on its own and L is a mean over the lanes, so the batch's rows
    times M / len(lanes) are the CPU's. The max error relative to the
    largest entry."""
    y0, ts, ys_true = data
    sub = (y0.detach()[lanes].cpu().requires_grad_(), ts.cpu(),
           ys_true[lanes].cpu())
    cpu_params = {k: [p.detach().cpu().requires_grad_() for p in v]
                  for k, v in params.items()}
    ref = node_gradient(cpu_params, sub, reg)[1][-1]
    got = g_y0[lanes].cpu() * (y0.shape[0] / len(lanes))
    return float((got - ref).abs().max() / ref.abs().max())


def node_phase(dev, m, dtype, reg, reps=3, smoke=False):
    name = (f"neural ODE gradient M={m} {str(dtype)[6:]}"
            + (f" kinetic cost {reg:g}" if reg else ""))
    data = node_data(m, dtype, dev)
    data[0].requires_grad_()                            # dL/dy0 too
    params = node_params(dtype, dev)
    loss, grads = node_gradient(params, data, reg)      # also the warm-up
    torch.cuda.synchronize()
    syncs = (solve_erk.host_syncs, dopri_adjoint.host_syncs)
    if not all(bool(torch.isfinite(g).all()) for g in grads):
        raise DopriCheckFailed(f"{name}: non-finite gradient (a segment "
                               "overflowed adjoint_steps=32?)")
    rec = {"loss": float(loss), "host_syncs_forward_last_segment": syncs[0],
           "host_syncs_backward_last_segment": syncs[1]}
    parts = []
    if dtype == torch.float64:
        lanes = _lanes(m, 4)
        rec["lanes_vs_cpu"] = node_lane_check(params, data, reg, grads[-1],
                                              lanes)
        if not rec["lanes_vs_cpu"] <= 1e-7:
            raise DopriCheckFailed(f"{name}: dL/dy0 of lanes {lanes} vs the "
                                   f"CPU {rec['lanes_vs_cpu']:.3e} > 1e-7")
        rec["cpu"] = node_cpu_check(dev, dtype, reg)
        if not rec["cpu"] <= 1e-7:
            raise DopriCheckFailed(f"{name}: 4 lanes vs the CPU "
                                   f"{rec['cpu']:.3e} > 1e-7")
        parts.append(f"dL/dy0 of lanes {lanes} of this batch vs the CPU: "
                     f"{rec['lanes_vs_cpu']:.3e} (bound 1e-7) | weight "
                     f"gradient of a 4-lane batch vs the CPU: "
                     f"{rec['cpu']:.3e} (bound 1e-7)")
    if not smoke:
        rec["ms_per_gradient"] = statistics.median(
            events_ms(lambda: node_gradient(params, data, reg), 1)
            for _ in range(reps))
        prof = mol.profile_solve(
            lambda wrap: node_gradient(params, data, reg, wrap))
        rec.update(launches=prof["launches"], busy_ms=prof["busy_ms"],
                   busy_share=prof["busy_ms"] / rec["ms_per_gradient"])
        opt = torch.optim.Adam(params["w"] + params["b"], lr=3e-3)
        losses = []
        for _ in range(20):
            opt.zero_grad()
            lv = node_loss(params, data, reg)
            lv.backward()
            opt.step()
            losses.append(float(lv.detach()))
        rec["adam_losses"] = losses
        if not losses[-1] < losses[0]:
            raise DopriCheckFailed(f"{name}: the loss did not fall in 20 "
                                   f"Adam steps: {losses[0]} -> {losses[-1]}")
        parts = [f"{rec['ms_per_gradient']:.2f} ms per gradient (median of "
                 f"{reps}, CUDA events) | launches {prof['launches']}, device"
                 f" busy {prof['busy_ms']:.2f} ms = {rec['busy_share']:.3f} "
                 f"of the gradient | 20 Adam(lr=3e-3) steps: loss "
                 f"{losses[0]:.6g} -> {losses[-1]:.6g}"] + parts
    print(f"[{name}] MLP {list(SIZES)}, T={T_FINAL:g}, {N_SAMPLE} samples, "
          f"rtol 1e-6, adjoint_steps=32: gradient finite, loss "
          f"{float(loss):.6g}"
          f" | host syncs of the last segment {syncs[0]} forward + "
          f"{syncs[1]} backward | " + " | ".join(parts), flush=True)
    return rec


# ---- (c) step_args and record_steps on the Radau9 headline -----------------

def _vdp_slab(t, y, a):
    return vdp_rhs(t, y, a[0] * a[1])


def _vdp_jac_slab(t, y, a):
    return vdp_jac(t, y, a[0] * a[1])


def headline_solve(dev, slabs, m=M):
    """The Radau9 headline lanes through K1/K2 (no tangents), with constant
    slab rows and record_steps=64 when ``slabs``."""
    y0 = torch.tensor([[2.0, 0.0]], dtype=torch.float64, device=dev) \
        .repeat(m, 1)
    mus = torch.full((m,), 1e3, dtype=torch.float64, device=dev)
    opts = Options(rtol=1e-6, atol=1e-9, pivoting=False, min_stages=5,
                   max_stages=5, kernel_lu=True,
                   record_steps=64 if slabs else 0)
    if not slabs:
        return solve_radau(vdp_rhs, 0.0, 1.0, y0, args=mus, options=opts,
                           jac=vdp_jac)
    rows = torch.ones((4096,), dtype=torch.float64, device=dev)
    return solve_radau(_vdp_slab, 0.0, 1.0, y0, args=mus, options=opts,
                       jac=_vdp_jac_slab, step_args=rows)


def step_args_phase(dev, m=M, smoke=False):
    name = f"step_args headline M={m} f64 Radau9 kernel_lu"
    runs = {}
    for slabs in (False, True):
        torch.cuda.synchronize()
        mol._reset_kernel_launches()
        sol = headline_solve(dev, slabs, m)             # K1/K2 build lazily
        torch.cuda.synchronize()
        runs[slabs] = (sol, mol._kernel_launches())
    (plain, l_plain), (slab, l_slab) = runs[False], runs[True]
    same = (torch.equal(plain.t, slab.t) and torch.equal(plain.y, slab.y)
            and torch.equal(plain.status, slab.status)
            and all(torch.equal(plain.stats[k], slab.stats[k])
                    for k in plain.stats))
    if not same:
        raise DopriCheckFailed(f"{name}: constant slab rows do not reproduce "
                               "the plain solve to the bit")
    if l_plain != l_slab or l_slab["K1"] <= 0 or l_slab["K2"] <= 0:
        raise DopriCheckFailed(f"{name}: K1/K2 launches {l_slab} vs the "
                               f"plain solve's {l_plain}")
    if not torch.equal(slab.dyn["idx"], slab.stats["nsteps"]):
        raise DopriCheckFailed(f"{name}: the step log's index is not nsteps")
    rec = {"launches": l_slab, "nsteps_max": int(slab.stats["nsteps"].max())}
    extra = ""
    if not smoke:
        turns = {False: [], True: []}
        for slabs in (False, True, True, False):
            turns[slabs].append(events_ms(
                lambda: headline_solve(dev, slabs, m), 1) / 1e3)
        rec["turns"] = {"plain": turns[False], "step_args": turns[True]}
        extra = (f" | s per solve in turns (plain, step_args, step_args, "
                 f"plain; CUDA events): plain {turns[False]}, step_args "
                 f"{turns[True]}")
    print(f"[{name}] constant slab rows + record_steps=64 equal the plain "
          f"solve to the bit (t, y, status, all counters) | K1 "
          f"{l_slab['K1']}, K2 {l_slab['K2']} launches, as the plain solve's"
          + extra, flush=True)
    return rec


# ---- (d) radau_hvp ---------------------------------------------------------

HVP_OPTS = dict(rtol=1e-8, atol=1e-10, pivoting=False, kernel_lu=True,
                adjoint_steps=512)


def hvp_inputs(m, dev, lanes=None):
    mus = _logspace(0.0, 1.0, m, torch.float64, dev)
    if lanes is not None:
        mus = mus[lanes]
    n = mus.shape[0]
    y0 = torch.tensor([[2.0, 0.0]], dtype=torch.float64, device=dev) \
        .repeat(n, 1)
    v_y0 = torch.tensor([[0.5, -0.3]], dtype=torch.float64, device=dev) \
        .repeat(n, 1)
    return y0, mus, v_y0, torch.ones_like(mus)


def _sq_loss(yT, mus):
    return torch.sum(yT ** 2)


def hvp_once(m, dev):
    y0, mus, v_y0, v_mu = hvp_inputs(m, dev)
    return radau_hvp(vdp_rhs, (0.0, 1.0), y0, mus, loss=_sq_loss, v_y0=v_y0,
                     v_args=v_mu, options=Options(**HVP_OPTS))


def hvp_fd_check(dev, m, h_y0, h_mu, eps=1e-3):
    """3 lanes of H·v against central differences of radau_adjoint
    gradients: the worst error over the bound (1e-3 relative + 1e-8 in y0,
    5e-3 relative + 1e-8 in mu)."""
    lanes = [0, m // 2, m - 1]
    y0, mus, v_y0, v_mu = hvp_inputs(m, dev, lanes)
    opts = Options(**HVP_OPTS)

    def grad(sign):
        z = (y0 + sign * eps * v_y0).requires_grad_()
        mm = (mus + sign * eps * v_mu).requires_grad_()
        _sq_loss(radau_adjoint(vdp_rhs, (0.0, 1.0), z, args=mm,
                               options=opts), mm).backward()
        return z.grad, mm.grad

    (gp_y, gp_m), (gm_y, gm_m) = grad(1.0), grad(-1.0)
    worst = 0.0
    for got, fd, rtol in ((h_y0[lanes], (gp_y - gm_y) / (2 * eps), 1e-3),
                          (h_mu[lanes], (gp_m - gm_m) / (2 * eps), 5e-3)):
        worst = max(worst, float(((got - fd).abs()
                                  / (rtol * fd.abs() + 1e-8)).max()))
    return worst


def hvp_phase(dev, m=M, reps=3, smoke=False):
    name = f"radau_hvp M={m} f64 VdP mu=logspace(0,1) rtol 1e-8"
    torch.cuda.synchronize()
    mol._reset_kernel_launches()
    (h_y0, h_args), gdotv = hvp_once(m, dev)            # also the warm-up
    torch.cuda.synchronize()
    launches = mol._kernel_launches()
    if launches["K1"] <= 0 or launches["K2"] <= 0:
        raise DopriCheckFailed(f"{name}: the augmented forward did not go "
                               f"through K1/K2: {launches}")
    if not (bool(torch.isfinite(h_y0).all() & torch.isfinite(h_args).all())
            and bool(torch.isfinite(gdotv))):
        raise DopriCheckFailed(f"{name}: non-finite H·v")
    worst = hvp_fd_check(dev, m, h_y0, h_args)
    if not worst <= 1.0:
        raise DopriCheckFailed(f"{name}: 3 lanes vs central differences of "
                               f"the adjoint gradient: error / bound "
                               f"{worst:.3e} > 1")
    rec = {"launches": launches, "fd_worst": worst, "gdotv": float(gdotv)}
    extra = ""
    if not smoke:
        rec["ms_per_hvp"] = statistics.median(
            events_ms(lambda: hvp_once(m, dev), 1) for _ in range(reps))
        extra = (f" | {rec['ms_per_hvp']:.1f} ms per H·v (median of {reps},"
                 " CUDA events)")
    print(f"[{name}] H·v finite, gdotv {float(gdotv):.9g} | augmented D=4 "
          f"forward launches K1 {launches['K1']}, K2 {launches['K2']} | 3 "
          f"lanes vs central differences of radau_adjoint gradients: worst "
          f"error / bound {worst:.3e}" + extra, flush=True)
    return rec


# ---- (e) qr_fallback -------------------------------------------------------

QR_MASS = ((0.0, 1.0), (1.0, 0.0))
QR_OPTS = dict(rtol=1e-9, atol=1e-12, pivoting=False, qr_fallback=True)


def _qr_rhs(t, y, args):
    """Even lanes y' = [-y0, -2 y1] (identity mass); odd lanes the permuted
    system M y' = [-y1, y1 - y0]."""
    plain = torch.stack([-y[:, 0], -2.0 * y[:, 1]], dim=-1)
    perm = torch.stack([-y[:, 1], y[:, 1] - y[:, 0]], dim=-1)
    odd = (torch.arange(y.shape[0], device=y.device) % 2 == 1)[:, None]
    return torch.where(odd, perm, plain)


def qr_inputs(m, dev):
    y0 = torch.tensor([[1.0, 0.5], [0.3, -0.7]], dtype=torch.float64,
                      device=dev).repeat(m // 2, 1)
    eye = torch.eye(2, dtype=torch.float64, device=dev)
    perm = torch.tensor(QR_MASS, dtype=torch.float64, device=dev)
    odd = (torch.arange(m, device=dev) % 2 == 1)[:, None, None]
    return y0, torch.where(odd, perm, eye)


def qr_solve_lanes(m, dev):
    y0, mass = qr_inputs(m, dev)
    return solve_radau(_qr_rhs, 0.0, 2.0, y0, mass=mass,
                       options=Options(**QR_OPTS))


def qr_exact(y0, t=2.0):
    """The exact solutions at t: even lanes y0·(e^{-t}, e^{-2t}); odd lanes
    ((a + b t) e^{-t}, b e^{-t})."""
    a, b = y0[:, 0], y0[:, 1]
    e = np.exp(-t)
    plain = np.stack([a * e, b * e * e], -1)
    perm = np.stack([(a + b * t) * e, b * e], -1)
    odd = (np.arange(len(y0)) % 2 == 1)[:, None]
    return np.where(odd, perm, plain)


def qr_phase(dev, m=M):
    name = f"qr_fallback M={m} f64 mixed batch"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol = qr_solve_lanes(m, dev)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    syncs = solve_radau.host_syncs
    if not bool((sol.status == 1).all()):
        raise DopriCheckFailed(f"{name}: not SUCCESS on every lane")
    y = sol.y.cpu().numpy()
    y0 = qr_inputs(m, torch.device("cpu"))[0].numpy()
    exact_err = float(np.max(np.abs(y - qr_exact(y0))
                             / (1e-8 * np.abs(qr_exact(y0)) + 1e-11)))
    if not exact_err <= 1.0:
        raise DopriCheckFailed(f"{name}: exact solution error / bound "
                               f"{exact_err:.3e} > 1")
    cpu = qr_solve_lanes(8, torch.device("cpu"))
    same = torch.equal(sol.status[:8].cpu(), cpu.status) and all(
        torch.equal(sol.stats[k][:8].cpu(), cpu.stats[k]) for k in cpu.stats)
    cpu_err = float((sol.y[:8].cpu() - cpu.y).abs().max() / cpu.y.abs().max())
    if not same or not cpu_err <= 1e-10:
        raise DopriCheckFailed(f"{name}: 8 lanes vs the CPU: counters equal "
                               f"{same}, y {cpu_err:.3e}")
    print(f"[{name}] every lane SUCCESS (odd lanes through QR) | exact "
          f"solutions: worst error / bound {exact_err:.3e} | 8 lanes vs the "
          f"CPU: status and counters equal, y {cpu_err:.3e} (bound 1e-10) | "
          f"{sec:.3f} s (one solve, host clock), host syncs {syncs}, nsteps "
          f"max {int(sol.stats['nsteps'].max())}", flush=True)
    return {"s_per_solve": sec, "host_syncs": syncs, "exact_worst": exact_err,
            "cpu": cpu_err}


PHASES = ("forward", "node", "step_args", "hvp", "qr")


def run(dev, only=PHASES, smoke=False):
    """Run the named phases; returns their records with the seconds each
    phase took under ``"seconds"``."""
    report, seconds = {}, {}

    def timed(phase, key, fn, *a, **kw):
        t0 = time.perf_counter()
        report[key] = fn(dev, *a, **kw)
        torch.cuda.synchronize()
        seconds[phase] = seconds.get(phase, 0.0) + time.perf_counter() - t0

    if "forward" in only:
        for method in (("dopri5",) if smoke else ("dopri5", "dopri853")):
            timed("forward", f"forward_{method}", forward_phase, method,
                  smoke=smoke)
    if "node" in only:
        if smoke:
            timed("node", "node_f64", node_phase, M_NODE_SMOKE,
                  torch.float64, 0.0, smoke=True)
        else:
            for dtype in (torch.float64, torch.float32):
                for reg in (0.0, REG):
                    key = f"node_{str(dtype)[6:]}" + ("_cost" if reg else "")
                    timed("node", key, node_phase, M, dtype, reg)
    if "step_args" in only:
        timed("step_args", "step_args", step_args_phase, smoke=smoke)
    if "hvp" in only:
        timed("hvp", "hvp", hvp_phase, m=1024 if smoke else M, smoke=smoke)
    if "qr" in only and not smoke:
        timed("qr", "qr", qr_phase)
    report["seconds"] = seconds
    print("[dopri phase seconds] " + ", ".join(f"{k} {v:.1f}"
                                               for k, v in seconds.items()),
          flush=True)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="+", choices=PHASES, default=PHASES)
    ap.add_argument("--json", type=Path, default=None,
                    help="also write the JSON line to this file")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dopri: no CUDA device", file=sys.stderr)
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
