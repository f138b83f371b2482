"""Batched adaptive BDF2: the A-stable two-step method behind the lockstep
driver (a legacy stepper; ``'bdf'`` is the variable-order NDF family).

The port of ``janus_tpu/solve/bdf.py``:
- variable-step BDF2: α(r)·y₊ − ψ(r; yₙ, yₙ₋₁) = h·f(t₊, y₊), r = hₙ/hₙ₋₁,
  with a BDF1 first step;
- simplified Newton with the (α/h·I − J) LU reused across iterations;
- the LTE estimate from third divided differences of the history (h²y″ on
  the BDF1 step), smoothed by the stage LU;
- the controller, masking and underflow test of the Radau family.

One step attempt of every active lane per trip of a Python loop. The
reference gates the Jacobian and the factorization with ``lax.cond``; here
they are read with the loop's condition in ONE host read at the top of an
attempt, and each Newton trip is one host sync (the reference's inner
``while_loop``). ``solve_bdf2.host_syncs`` holds the last solve's count.
With ``Options(kernel_lu=True)`` (pivot-free) the CUDA kernel K1 factors
α/h·I − J and K2 does every Newton and error-estimate solve
(``ops.smalllu``; their plain twins on CPU tensors), where the reference
runs its plain LU whatever ``pallas_lu`` says.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from janus_tpu_torch.linalg.smalllu import lu_factor, lu_ok, lu_solve
from janus_tpu_torch.solve import common as cm
from janus_tpu_torch.solve.ndf import _rms
from janus_tpu_torch.solve.options import Options
from janus_tpu_torch.solve.radau import (_i32, _ipow,
                                         _kernel_lu_factor, _kernel_lu_solve,
                                         default_jacobian,
                                         refuse_kernel_derivatives)
from janus_tpu_torch.solve.radau_fused import _rdiv
from janus_tpu_torch.solve.radaup import _pow

NEWTON_MAXITER = 6


def check_kernel_lu(opts: Options):
    """Options(kernel_lu=True) needs the pivot-free LU."""
    if opts.kernel_lu and opts.pivoting:
        raise ValueError("Options(kernel_lu=True) needs pivoting=False "
                         "(the SoA kernels are pivot-free)")


def stage_lu(opts: Options):
    """(factor(a) -> (lu, piv), solve(lu, piv, b)) for one D×D system per
    lane: K1/K2 under ``Options(kernel_lu=True)``, else the plain LU."""
    if opts.kernel_lu:
        return (_kernel_lu_factor,
                lambda lu, piv, b: _kernel_lu_solve(lu, b))
    return (lambda a: lu_factor(a, pivot=opts.pivoting),
            lambda lu, piv, b: lu_solve(lu, piv, b, pivot=opts.pivoting))


def _div0(x, d):
    """x / d[:, None] with a zero d taken as 1 (the history's empty slots)."""
    return x / torch.where(d == 0, 1.0, d)[:, None]


def solve_bdf2(f: Callable, t0, tf, y0, args=None,
               options: Optional[Options] = None, t_eval=None,
               jac: Optional[Callable] = None, device=None) -> cm.Solution:
    """Batched adaptive variable-step BDF2. f(t [M], y [M, D], args) ->
    [M, D]; y0 [M, D] (a torch y0 solves on its own device, anything else
    goes to ``device``, by default the CUDA card). jac: optional analytic
    ``jac(t, y, args) -> [M, D, D]`` (default: forward-mode AD). t_eval:
    optional shared output grid [T]; ``Solution.ys`` holds the quadratic
    through the last three points (linear on the first step)."""
    opts = options if options is not None else Options()
    check_kernel_lu(opts)
    t0, tf, y0 = cm.broadcast_batch(t0, tf, y0, device)
    refuse_kernel_derivatives(opts.kernel_lu, "solve_bdf2", y0, t0, tf, args)
    m, dim = y0.shape
    dtype, dev = y0.dtype, y0.device
    syncs = cm._HostSyncs()
    factor, solve = stage_lu(opts)
    jac_fn = jac if jac is not None else default_jacobian(f)
    newton_tol = (opts.newton_tol if opts.newton_tol > 0
                  else cm.derived_newton_tol(dtype, opts.rtol))
    eye = torch.eye(dim, dtype=dtype, device=dev)

    f0 = f(t0, y0, args)
    if opts.h0 == 0.0:
        h_st = cm.initial_step(f, t0, y0, f0, tf, 2, opts.rtol, opts.atol,
                               args, opts.max_step)
    else:
        h_st = torch.full((m,), opts.h0, dtype=dtype, device=dev) \
            * torch.where(tf >= t0, 1.0, -1.0).to(dtype)

    use_dense = t_eval is not None
    if use_dense:
        t_eval = cm.like(t_eval, y0)
        at_t0 = t_eval[None, :] == t0[:, None]
        out_ys = torch.where(at_t0[..., None], y0[:, None, :], torch.nan)

    stats = cm.zero_stats(m, ("nfev", "njev", "nlu", "nsteps", "naccept",
                              "nreject", "nnewton"), dev)
    stats["nfev"] = stats["nfev"] + 2
    t, y = t0, y0
    t1, y1, t2, y2 = t0, y0, t0, y0          # t_{n-1}, t_{n-2} and their y
    nhist = torch.zeros((m,), dtype=torch.int32, device=dev)
    jac_m = y0.new_zeros((m, dim, dim))
    lu_m = y0.new_zeros((m, dim, dim))
    piv_m = torch.zeros((m, dim), dtype=torch.int32, device=dev)
    alpha_fact = y0.new_zeros((m,))          # α/h of the factors (0: none)
    current_jac = torch.zeros((m,), dtype=torch.bool, device=dev)
    need_jac = torch.ones((m,), dtype=torch.bool, device=dev)
    nsing = torch.zeros((m,), dtype=torch.int32, device=dev)
    already_done = t0 == tf
    active = ~already_done
    status = torch.where(already_done, cm.SUCCESS, cm.RUNNING).to(torch.int8)
    eps = torch.finfo(dtype).eps

    while True:
        remaining = tf - t
        last = torch.abs(h_st) >= torch.abs(remaining)
        h = torch.where(last, remaining, h_st)
        h = torch.where(h == 0.0, eps, h)

        startup = nhist == 0                       # the BDF1 first step
        hprev = torch.where(startup, h, t - t1)
        hprev = torch.where(hprev == 0.0, h, hprev)
        r = h / hprev
        alpha = torch.where(startup, 1.0, (1.0 + 2.0 * r) / (1.0 + r))
        psi = torch.where(startup[:, None], y,
                          (1.0 + r)[:, None] * y
                          - (r * r / (1.0 + r))[:, None] * y1)
        a_over_h = alpha / h
        needj = need_jac & active
        needf = active & (needj | (a_over_h != alpha_fact))
        go, any_j, any_f = syncs.any_each(active, needj, needf)
        if not go:
            break

        # ---- Jacobian and the factorization of α/h·I − J (gated) ---------
        if any_j:
            jmat = torch.where(needj[:, None, None], jac_fn(t, y, args), jac_m)
        else:
            jmat = jac_m
        current_jac = current_jac | needj
        fact_ok = torch.ones((m,), dtype=torch.bool, device=dev)
        if any_f:
            lu_n, piv_n = factor(a_over_h[:, None, None] * eye - jmat)
            lu_m = torch.where(needf[:, None, None], lu_n, lu_m)
            piv_m = torch.where(needf[:, None], piv_n, piv_m)
            fact_ok = torch.where(needf, lu_ok(lu_n), fact_ok)
            alpha_fact = torch.where(needf, a_over_h, alpha_fact)
        singular = active & ~fact_ok

        # ---- simplified Newton on α·y − ψ − h·f(t₊, y) = 0 ----------------
        t_new = t + h
        scale_n = opts.atol + opts.rtol * torch.abs(y)
        y_new = torch.where(startup[:, None], y, y + r[:, None] * (y - y1))
        run_newton = active & fact_ok
        running = run_newton
        dn_old, nrate = y0.new_zeros((m,)), y0.new_zeros((m,))
        convd = torch.zeros((m,), dtype=torch.bool, device=dev)
        niter = torch.zeros((m,), dtype=torch.int32, device=dev)
        nfev_n = torch.zeros((m,), dtype=torch.int32, device=dev)
        for k in range(NEWTON_MAXITER):
            if not syncs.any(running):
                break
            res = f(t_new, y_new, args) \
                + (psi - alpha[:, None] * y_new) / h[:, None]
            dy = solve(lu_m, piv_m, res)
            finite = torch.isfinite(dy).all(dim=-1)
            dn = _rms(dy / scale_n)
            rt = torch.where((k > 0) & (dn_old > 0),
                             dn / torch.where(dn_old == 0, 1.0, dn_old), 0.0)
            srt = torch.clamp(rt, 1e-16, 1.0 - 1e-16)
            if k > 0:
                left = torch.full_like(srt, float(NEWTON_MAXITER - k))
                div = (rt >= 1.0) | (_pow(srt, left) / (1 - srt) * dn
                                     > newton_tol)
                slow_ok = (rt < 1.0) & (srt / (1 - srt) * dn < newton_tol)
            else:
                div = slow_ok = torch.zeros_like(running)
            failn = running & (~finite | div)
            app = running & ~failn
            y_new = torch.where(app[:, None], y_new + dy, y_new)
            convd = convd | (app & ((dn == 0.0) | slow_ok))
            niter = torch.where(running, k + 1, niter)
            dn_old = torch.where(app, dn, dn_old)
            nrate = torch.where(running, rt, nrate)
            nfev_n = nfev_n + _i32(running)
            running = running & ~failn & ~convd & (k + 1 < NEWTON_MAXITER)

        conv = run_newton & convd
        newton_fail = run_newton & ~convd
        nf_stale = newton_fail & ~current_jac
        nf_fresh = (newton_fail & current_jac) | singular

        # ---- error estimate ---------------------------------------------
        f_new = f(t_new, y_new, args)
        dd1a = (y_new - y) / (t_new - t)[:, None]
        dd1b = _div0(y - y1, t - t1)
        dd1c = _div0(y1 - y2, t1 - t2)
        dd2a = _div0(dd1a - dd1b, t_new - t1)
        dd2b = _div0(dd1b - dd1c, t - t2)
        dd3 = _div0(dd2a - dd2b, t_new - t2)
        # LTE(y=τ³) = −h³(1+r)/r ⇒ err ≈ (1+r)/r · h³ · dd3 / α
        err_bdf2 = ((1.0 + r) / r * _ipow(h, 3) / alpha)[:, None] * dd3
        err_bdf1 = 0.5 * h[:, None] * (f_new - f0)
        err_raw = torch.where((nhist >= 2)[:, None], err_bdf2, err_bdf1)
        # stiff smoothing with the stage LU: e = (α/h)(α/h·I − J)⁻¹ err
        err_s = solve(lu_m, piv_m, err_raw) * a_over_h[:, None]
        scale_e = opts.atol + opts.rtol * torch.maximum(torch.abs(y),
                                                        torch.abs(y_new))
        enorm = _rms(err_s / scale_e)
        enorm = torch.where(torch.isfinite(enorm), enorm, 1e10)
        enorm = torch.clamp(enorm, min=1e-16)
        accept = conv & (enorm <= 1.0)
        reject_err = conv & (enorm > 1.0)

        # ---- controller (order 2: exponent 1/3) ---------------------------
        niter_f = torch.clamp(niter, min=1).to(dtype)
        safety = _rdiv(opts.safety * (2 * NEWTON_MAXITER + 1),
                       2 * NEWTON_MAXITER + niter_f)
        fac = safety * _pow(enorm, torch.full_like(enorm, -1.0 / 3.0))
        fac_acc = torch.clamp(fac, opts.min_factor, opts.max_factor)
        recompute_jac = accept & (niter > 2) & (nrate > opts.jac_recompute)
        deadzone = accept & ~recompute_jac & (fac_acc >= opts.quot1) & \
            (fac_acc < opts.quot2)
        fac_acc = torch.where(deadzone, 1.0, fac_acc)
        fac_rej = torch.clamp(fac, opts.min_factor, 0.9)

        if use_dense:
            # the quadratic through (t_{n-1}, t_n, t_{n+1}); linear on the
            # first step
            def interp(theta):
                tq = t[:, None] + theta * h[:, None]
                l0 = ((tq - t[:, None]) * (tq - t1[:, None])
                      / ((t_new - t) * (t_new - t1))[:, None])
                l1 = ((tq - t_new[:, None]) * (tq - t1[:, None])
                      / ((t - t_new) * (t - t1))[:, None])
                l2 = ((tq - t_new[:, None]) * (tq - t[:, None])
                      / ((t1 - t_new) * (t1 - t))[:, None])
                lin0 = (tq - t[:, None]) / (t_new - t)[:, None]
                quad = (l0[..., None] * y_new[:, None]
                        + l1[..., None] * y[:, None]
                        + l2[..., None] * y1[:, None])
                lin = (lin0[..., None] * y_new[:, None]
                       + (1 - lin0)[..., None] * y[:, None])
                return torch.where((nhist >= 1)[:, None, None], quad, lin)

            out_ys = cm.collect_dense(out_ys, t_eval, t, h, accept, interp)

        done = accept & last
        stats["nfev"] = stats["nfev"] + nfev_n + _i32(conv)
        stats["njev"] = stats["njev"] + _i32(needj)
        stats["nlu"] = stats["nlu"] + _i32(needf)
        stats["nsteps"] = stats["nsteps"] + _i32(run_newton | singular)
        stats["naccept"] = stats["naccept"] + _i32(accept)
        stats["nreject"] = stats["nreject"] + _i32(reject_err | newton_fail
                                                   | singular)
        stats["nnewton"] = stats["nnewton"] + niter

        nsing = torch.where(singular | newton_fail, nsing + 1,
                            torch.where(accept, 0, nsing))
        stall = active & (nsing >= 7)
        exceeded = active & (stats["nsteps"] >= opts.max_steps) & ~done
        h_abs = torch.abs(h)
        h_next_abs = torch.where(
            accept, h_abs * fac_acc,
            torch.where(reject_err, h_abs * fac_rej,
                        torch.where(nf_fresh, h_abs * 0.5, h_abs)))
        h_next_abs = torch.clamp(h_next_abs, max=opts.max_step)
        h_st = torch.where(active, h_next_abs * torch.sign(h), h_st)
        # Hairer's t-relative underflow test
        underflow = active & (0.1 * h_next_abs <= eps * torch.abs(t_new)) \
            & ~done

        status = torch.where(done, cm.SUCCESS, status)
        status = torch.where(exceeded, cm.MAX_STEPS, status)
        status = torch.where(underflow, cm.STEP_UNDERFLOW, status)
        status = torch.where(stall, cm.NEWTON_STALL, status)
        active = active & ~done & ~exceeded & ~underflow & ~stall

        acc = accept[:, None]
        t2, y2 = torch.where(accept, t1, t2), torch.where(acc, y1, y2)
        t1, y1 = torch.where(accept, t, t1), torch.where(acc, y, y1)
        t, y = torch.where(accept, t_new, t), torch.where(acc, y_new, y)
        f0 = torch.where(acc, f_new, f0)
        nhist = torch.where(accept, torch.clamp(nhist + 1, max=2), nhist)
        jac_m = jmat
        alpha_fact = torch.where((accept & ~deadzone) | reject_err
                                 | nf_fresh, 0.0, alpha_fact)
        current_jac = torch.where(accept, False, current_jac)
        need_jac = torch.where(accept, recompute_jac,
                               torch.where(nf_stale, True,
                                           torch.where(needj, False,
                                                       need_jac)))

    solve_bdf2.host_syncs = syncs.count
    return cm.Solution(t=t, y=y, status=status, stats=stats,
                       ts=t_eval if use_dense else None,
                       ys=out_ys if use_dense else None)


solve_bdf2.host_syncs = 0
