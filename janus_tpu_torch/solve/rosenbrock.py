"""Batched adaptive Kaps–Rentrop GRK4T (4th-order Rosenbrock, embedded 3rd;
a legacy stepper: ``'rodas'`` is RODAS4).

The port of ``janus_tpu/solve/rosenbrock.py``. Linearly implicit, no Newton
loop: one Jacobian, one factorization of I/(γh) − J and four solves an
attempt. One attempt of every active lane per trip of a Python loop, one
host sync a trip (``solve_ros4.host_syncs``). With
``Options(kernel_lu=True)`` (pivot-free) the factor goes through the CUDA
kernel K1 and the four stage solves through K2 (``ops.smalllu``; their
plain twins on CPU tensors), where the reference runs its plain LU
whatever ``pallas_lu`` says.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.func import jvp

from janus_tpu_torch.linalg.smalllu import lu_ok
from janus_tpu_torch.solve import common as cm
from janus_tpu_torch.solve.bdf import check_kernel_lu, stage_lu
from janus_tpu_torch.solve.ndf import _rms
from janus_tpu_torch.solve.options import Options
from janus_tpu_torch.solve.radau import (_i32, default_jacobian,
                                         refuse_kernel_derivatives)
from janus_tpu_torch.solve.radau_fused import _rdiv
from janus_tpu_torch.solve.radaup import _pow

# Kaps–Rentrop GRK4T coefficients (Hairer-Wanner IV.7 / Numerical Recipes)
GAM = 0.231
A21 = 2.0
A31, A32 = 4.52470820736, 4.16352878860
C21 = -5.07167533877
C31, C32 = 6.02015272865, 0.159750684673
C41, C42, C43 = -1.856343618677, -8.50538085819, -2.08407513602
B1, B2, B3, B4 = 3.95750374663, 4.62489238836, 0.617477263873, 1.282612945268
E1, E2, E3, E4 = -2.30215540292, -3.07363448539, 0.873280801802, 1.282612945268
C1X, C2X, C3X, C4X = GAM, -0.0396296677520, 0.550778939579, -0.0553509845700
A2X, A3X = 0.462, 0.880208333333


def solve_ros4(f: Callable, t0, tf, y0, args=None,
               options: Optional[Options] = None, t_eval=None,
               jac: Optional[Callable] = None, device=None) -> cm.Solution:
    """Batched adaptive GRK4T. f(t [M], y [M, D], args) -> [M, D]; y0 [M, D]
    (a torch y0 solves on its own device, anything else goes to
    ``device``, by default the CUDA card). jac: optional analytic
    ``jac(t, y, args) -> [M, D, D]`` (default: forward-mode AD); ∂f/∂t is a
    ``torch.func.jvp`` in t. t_eval: optional shared output grid [T];
    ``Solution.ys`` holds the cubic Hermite on (y, f) at the step ends."""
    opts = options if options is not None else Options()
    check_kernel_lu(opts)
    t0, tf, y0 = cm.broadcast_batch(t0, tf, y0, device)
    refuse_kernel_derivatives(opts.kernel_lu, "solve_ros4", y0, t0, tf, args)
    m, dim = y0.shape
    dtype, dev = y0.dtype, y0.device
    syncs = cm._HostSyncs()
    factor, solve = stage_lu(opts)
    jac_fn = jac if jac is not None else default_jacobian(f)
    eye = torch.eye(dim, dtype=dtype, device=dev)

    f0 = f(t0, y0, args)
    if opts.h0 == 0.0:
        h_st = cm.initial_step(f, t0, y0, f0, tf, 4, opts.rtol, opts.atol,
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
                              "nreject"), dev)
    stats["nfev"] = stats["nfev"] + 2
    t, y = t0, y0
    already_done = t0 == tf
    active = ~already_done
    status = torch.where(already_done, cm.SUCCESS, cm.RUNNING).to(torch.int8)
    eps = torch.finfo(dtype).eps
    quarter = torch.full((m,), -0.25, dtype=dtype, device=dev)

    while syncs.any(active):
        remaining = tf - t
        last = torch.abs(h_st) >= torch.abs(remaining)
        h = torch.where(last, remaining, h_st)
        h = torch.where(h == 0.0, eps, h)
        hcol = h[:, None]

        lu, piv = factor(_rdiv(1.0, GAM * h)[:, None, None] * eye
                         - jac_fn(t, y, args))
        ok = lu_ok(lu)
        fy = f(t, y, args)
        tc = t.contiguous()          # forward mode refuses a broadcast primal
        ft = jvp(lambda tt: f(tt, y, args), (tc,), (torch.ones_like(tc),))[1]

        g1 = solve(lu, piv, fy + hcol * C1X * ft)
        f2 = f(t + A2X * h, y + A21 * g1, args)
        g2 = solve(lu, piv, f2 + hcol * C2X * ft + _rdiv(C21, hcol) * g1)
        f3 = f(t + A3X * h, y + A31 * g1 + A32 * g2, args)
        g3 = solve(lu, piv,
                   f3 + hcol * C3X * ft + (C31 * g1 + C32 * g2) / hcol)
        g4 = solve(lu, piv, f3 + hcol * C4X * ft
                   + (C41 * g1 + C42 * g2 + C43 * g3) / hcol)
        y_new = y + B1 * g1 + B2 * g2 + B3 * g3 + B4 * g4
        err = E1 * g1 + E2 * g2 + E3 * g3 + E4 * g4

        sc = opts.atol + opts.rtol * torch.maximum(torch.abs(y),
                                                   torch.abs(y_new))
        enorm = _rms(err / sc)
        enorm = torch.where(torch.isfinite(enorm) & ok, enorm, 1e10)
        enorm = torch.clamp(enorm, min=1e-16)
        accept = active & (enorm <= 1.0)
        fac = opts.safety * _pow(enorm, quarter)
        fac = torch.where(accept, torch.clamp(fac, opts.min_factor,
                                              opts.max_factor),
                          torch.clamp(fac, opts.min_factor, 0.9))

        if use_dense:
            # the cubic Hermite on (y, f(y)) and (y_new, f(y_new))
            fn = f(t + h, y_new, args)

            def interp(theta):
                th = theta[..., None]
                h00 = (1 + 2 * th) * (1 - th) ** 2
                h10 = th * (1 - th) ** 2
                h01 = th * th * (3 - 2 * th)
                h11 = th * th * (th - 1)
                return (h00 * y[:, None] + h10 * hcol[:, None] * fy[:, None]
                        + h01 * y_new[:, None]
                        + h11 * hcol[:, None] * fn[:, None])
            out_ys = cm.collect_dense(out_ys, t_eval, t, h, accept, interp)

        t_new = t + h
        done = accept & last
        stats["nfev"] = stats["nfev"] + _i32(active) * 3 \
            + _i32(accept) * int(use_dense)
        stats["njev"] = stats["njev"] + _i32(active)
        stats["nlu"] = stats["nlu"] + _i32(active)
        stats["nsteps"] = stats["nsteps"] + _i32(active)
        stats["naccept"] = stats["naccept"] + _i32(accept)
        stats["nreject"] = stats["nreject"] + _i32(active & ~accept)

        h_next_abs = torch.clamp(torch.abs(h) * fac, max=opts.max_step)
        h_st = torch.where(active, h_next_abs * torch.sign(h), h_st)
        exceeded = active & (stats["nsteps"] >= opts.max_steps) & ~done
        # Hairer's t-relative underflow test
        underflow = active & (0.1 * h_next_abs <= eps * torch.abs(t_new)) \
            & ~done

        status = torch.where(done, cm.SUCCESS, status)
        status = torch.where(exceeded, cm.MAX_STEPS, status)
        status = torch.where(underflow, cm.STEP_UNDERFLOW, status)
        active = active & ~done & ~exceeded & ~underflow
        t = torch.where(accept, t_new, t)
        y = torch.where(accept[:, None], y_new, y)

    solve_ros4.host_syncs = syncs.count
    return cm.Solution(t=t, y=y, status=status, stats=stats,
                       ts=t_eval if use_dense else None,
                       ys=out_ys if use_dense else None)


solve_ros4.host_syncs = 0
