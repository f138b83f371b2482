"""Variable-order Radau IIA (stages {1, 3, 5, 7}: orders {1, 5, 9, 13}).

The port of ``janus_tpu/solve/radaup.py``. Each lane adapts its stage count
from the Newton contraction Θ (Hairer's RADAUP rules, knobs VITU/VITD/HHOU/
HHOD): on an accepted step a fast contraction (Θ < VITU, at most two
iterations) raises the order, a slow one (Θ > VITD, or Newton near its trip
limit) lowers it, and an order change forces a new factorization. One step
attempt of every active lane per trip of a Python loop; within it the body
runs each order of the ladder on the lanes that hold it (stage-shaped
buffers padded to the ladder's largest stage count), so the ladder costs
one Newton bucket per order present.

Control flow against the reference's ``lax.while_loop``/``lax.cond``:
- ONE host read at the top of an attempt holds the loop's condition, the
  Jacobian's gate and, per order of the ladder, whether any lane holds it
  and whether any of those lanes needs a new factorization: an order no
  lane holds costs no work, and a factorization no lane needs is skipped
  (the reference's conds on the Jacobian, each order's factor and each
  order's Newton);
- each Newton trip is one host sync, as in ``radau._newton``;
- with tangents, one host read after the error estimate says which orders
  have accepting lanes, and only those run their tangent sweep (one sync a
  sweep trip, as in radau);
- the refined error estimate of a rejected lane is computed and selected
  on the LU path and gated by one host sync on the matrix-free path, as in
  ``solve_radau``; the new f is computed and selected;
- the events' bisection runs only on a step where some lane crossed.
The host syncs of the last solve are in ``solve_radau_vo.host_syncs``.

Stage solves: per order one real D×D and (s−1)/2 split-complex 2D×2D
factors, in per-lane buffers: each lane's error estimate solves with its
own order's real factor. With ``Options(kernel_lu=True)`` (pivot-free)
every factor goes through the CUDA kernel K1 and every Newton, error and
tangent solve through K2 (``ops.smalllu``; their plain twins on CPU
tensors), where the reference's ladder uses its plain LU whatever
``pallas_lu`` says. ``Options(stage_solver='gmres'|'tridiag')`` runs
per-order matrix-free stage solvers from one probed preconditioner, and the
error solve uses each lane's own order's γ0 as its shift.

Rounding as the reference's: the controller's (err_old/err)^(1/(s+1)) has
a per-lane exponent, which XLA computes with libm's pow; torch's vectorized
pow on the CPU differs from it on ~2% of inputs, so ``_pow`` feeds torch's
strided (libm) loop there. The error norms and the warm start's
polynomial at θ = 1 add in sequence (``ndf._rms``, ``ndf._sum_seq``), and a
number divided by a tensor is a true division (``radau_fused._rdiv``).
The sequential sum also keeps the card's result independent of the memory
layout ``torch.where`` hands the polynomial buffer: a reduction kernel
sums in an order that follows the layout.
"""

from __future__ import annotations

import warnings
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from janus_tpu_torch.diag.record import init_dyn, record_step
from janus_tpu_torch.linalg.smalllu import lu_solve
from janus_tpu_torch.solve import common as cm
from janus_tpu_torch.solve.events import (handle_events, init_event_state,
                                          normalize_events)
from janus_tpu_torch.solve.ndf import _rms, _sum_seq
from janus_tpu_torch.solve.options import Options
from janus_tpu_torch.solve.radau import (_event_tangent_jump, _factorize,
                                         _gmres_stage_solver,
                                         _i32, _ipow, _kernel_lu_factor,
                                         _kernel_lu_solve, _mass_dot,
                                         _newton, _tangent_stages,
                                         default_jacobian,
                                         gmres_shifted_solver,
                                         precond_probe_fn,
                                         refuse_kernel_derivatives,
                                         solve_radau)
from janus_tpu_torch.solve.radau_fused import _rdiv
from janus_tpu_torch.solve.radau_tables import radau_tableau

VITU = 0.002      # raise the order when Newton contracts faster than this
VITD = 0.8        # lower it when slower than this
HHOU = 1.2        # step-size nudge on an order raise
HHOD = 0.8        # step-size nudge on an order drop


def ladder_orders(opts: Options, dtype, warn: bool = False):
    """The distinct stage counts the variable-order ladder may visit.

    float32 caps the ladder at s=5 (order 9): the s=7 transformed stage
    systems lose the simplified Newton at eps = 1.2e-7, unless the caller
    pinned min_stages == max_stages == 7. Shared with ``radau_adjoint``, so
    that the recorded mesh is as wide as the forward ladder."""
    max_stages = opts.max_stages
    if dtype == torch.float32 and max_stages > 5 \
            and opts.min_stages < max_stages:
        if warn:
            warnings.warn(
                "radaup: capping the variable-order ladder at s=5 (order 9) "
                "in float32 -- the s=7 transformed stage systems lose the "
                "simplified Newton at eps=1.2e-7; pin min_stages=max_stages=7"
                " to override", stacklevel=3)
        max_stages = 5
    return tuple(s for s in (1, 3, 5, 7)
                 if opts.min_stages <= s <= max_stages)


def _pow(x, e):
    """x ** e for a tensor exponent, rounded as libm's pow (the reference's,
    through XLA). On the CPU torch's vectorized pow differs from libm's on
    ~2% of inputs and its strided loop calls libm, so the operands go in as
    strided views; on the card torch's pow is the one there is."""
    if x.device.type != "cpu":
        return torch.pow(x, e)
    return torch.pow(torch.stack([x, x], -1)[..., 0],
                     torch.stack([e, e], -1)[..., 0])


def _pad_stages(a, n, dim):
    """a with axis ``dim`` zero-padded at its end to length n."""
    pad = [0, 0] * (a.ndim - 1 - (dim % a.ndim)) + [0, n - a.shape[dim]]
    return F.pad(a, pad)


def _lu_solvers(lu_r, piv_r, lu_c, piv_c, use_kernel, pivot):
    """(solve_real, solve_cplx) on per-lane factor buffers: each lane solves
    with its own rows, so one pair serves every order."""
    if use_kernel:
        return (lambda b: _kernel_lu_solve(lu_r, b),
                lambda p, b: _kernel_lu_solve(lu_c[:, p], b))
    return (lambda b: lu_solve(lu_r, piv_r, b, pivot=pivot),
            lambda p, b: lu_solve(lu_c[:, p], piv_c[:, p], b, pivot=pivot))


def solve_radau_vo(f: Callable, t0, tf, y0, args=None,
                   options: Optional[Options] = None, t_eval=None,
                   jac: Optional[Callable] = None, mass=None,
                   events=None, tangents=None, args_tangents=None,
                   quad: Optional[Callable] = None, dense: int = 0,
                   _mesh_size: int = 0, _h0=None,
                   device=None) -> cm.Solution:
    """Variable-order Radau IIA over the ladder of ``ladder_orders``
    (``Options(min_stages, max_stages)``; a ladder of one order is
    ``solve_radau``). Each lane starts at s=3 (or the nearest order of the
    ladder).

    f(t [M], y [M, D], args) -> [M, D]; y0 [M, D] (device as
    ``solve_radau``). Takes what ``solve_radau`` takes but ``step_args``:
    jac=, mass= (index-1/2/3 weights by Options(nind1/2/3)), t_eval=,
    events=, the matrix-free stage solvers, record_steps.

    tangents / args_tangents: IND forward sensitivities; each accepted step
    runs ONE linear tangent sweep at the lane's CURRENT order on that
    order's factors, so the tangents ride the order ladder the primal
    walked. ``Solution.sens``, with t_eval ``sens_ys`` (off the tangent
    collocation polynomial in the ladder's padded power basis) and with
    events ``sens_t``.

    dense: step-mesh capacity N > 0: each accepted step's collocation
    polynomial, zero-padded to the ladder's top stage count, for
    ``Solution.interpolate``. quad: running-cost integrand
    ``l(t [M], y [M, D], args) -> [M]`` or ``[M, Q]``, accumulated per
    accepted step by 3-point Gauss-Legendre on the lane's interpolant
    (not with tangents: the fixed-stage 'radau' has ``sens_quad``).
    ``_mesh_size`` / ``_h0``: the continuous adjoint's seats.
    """
    opts = options if options is not None else Options()
    if opts.stage_solver not in ("lu", "gmres", "tridiag"):
        raise ValueError(f"unknown stage_solver {opts.stage_solver!r}")
    if opts.kernel_lu:
        if opts.pivoting:
            raise ValueError("Options(kernel_lu=True) needs pivoting=False "
                             "(the SoA kernels are pivot-free)")
        if opts.qr_fallback:
            raise ValueError("kernel_lu and qr_fallback are mutually "
                             "exclusive (pick one stage-solve override)")
    specs = normalize_events(events)
    use_sens = tangents is not None or args_tangents is not None
    mesh_cap = max(int(dense), int(_mesh_size))
    use_quad = quad is not None
    if use_quad and use_sens:
        raise ValueError("radaup quad= has no IND quadrature tangents; "
                         "use the fixed-stage 'radau' method for "
                         "sens_quad")
    y0 = cm.on_device(y0, device)
    orders = ladder_orders(opts, y0.dtype, warn=True)
    if len(orders) < 2:
        return solve_radau(f, t0, tf, y0, args, options, t_eval, jac=jac,
                           mass=mass, events=events, tangents=tangents,
                           args_tangents=args_tangents, quad=quad,
                           dense=dense, _mesh_size=_mesh_size, _h0=_h0)
    smax = orders[-1]
    pmax = (smax - 1) // 2
    tabs = {s: radau_tableau(s) for s in orders}

    t0, tf, y0 = cm.broadcast_batch(t0, tf, y0)
    m, dim = y0.shape
    dtype, dev = y0.dtype, y0.device
    syncs = cm._HostSyncs()

    def as_t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    consts = {s: (as_t(tabs[s].c), as_t(tabs[s].e), as_t(tabs[s].p))
              for s in orders}
    if mass is not None:
        mass = cm.like(mass, y0)
        if tuple(mass.shape) not in ((dim, dim), (m, dim, dim)):
            raise ValueError(f"mass must be [{dim}, {dim}] or [{m}, {dim}, "
                             f"{dim}], got {tuple(mass.shape)}")
    mdot = _mass_dot(mass)
    if use_quad:
        qshape = tuple(quad(t0, y0, args).shape)
        if qshape != (m,) and (len(qshape) != 2 or qshape[0] != m):
            raise ValueError(f"quad must return [M] or [M, Q] with M={m}, "
                             f"got {qshape}")
        quad_scalar = len(qshape) == 1
        q_acc = zeros(m, 1 if quad_scalar else qshape[1])

        def ql(t, y):
            return cm.canon_cost(quad(t, y, args))

    use_gmres = opts.stage_solver != "lu"
    use_kernel = opts.kernel_lu and not use_gmres
    refuse_kernel_derivatives(use_kernel, "solve_radau_vo", y0, t0, tf, args,
                              tangents, args_tangents, mass)
    factor = _kernel_lu_factor if use_kernel else None
    if use_gmres:
        # the matrix-free ladder: J·v by jvp at the frozen linearization
        # point in each order's stage solvers; the carried "Jacobian" is
        # the probed preconditioner data, shared by the orders
        if jac is not None:
            raise ValueError("stage_solver='gmres' is matrix-free (J·v by "
                             "jvp, probed structure preconditioner); "
                             "drop jac=")
        jac_fn = precond_probe_fn(f, opts.precond, opts.precond_block, dim)
        g_iters = 0 if opts.stage_solver == "tridiag" else opts.gmres_iters
    else:
        jac_fn = jac if jac is not None else default_jacobian(f)
    ind_exp, use_index = cm.index_weights(opts, dim, dtype, dev)
    newton_tol = (opts.newton_tol if opts.newton_tol > 0
                  else cm.derived_newton_tol(dtype, opts.rtol))
    max_iter = opts.newton_max_iter

    args_d = None
    if args_tangents is not None:
        # the joint jvp in (y, args) needs tensor leaves
        args_d = cm.tree_map(lambda a: cm.like(a, y0), args_tangents)
        args = cm.tree_map(lambda a: cm.like(a, y0), args)
        k_args = cm.tree_leaves(args_d)[0].shape[0]
    if tangents is not None:
        yd = cm.like(tangents, y0)
        if yd.ndim != 3 or tuple(yd.shape[1:]) != (m, dim):
            raise ValueError(f"tangents must be [K, {m}, {dim}], got "
                             f"{tuple(yd.shape)}")
        if args_d is not None and k_args != yd.shape[0]:
            raise ValueError(f"tangents K={yd.shape[0]} != "
                             f"args_tangents K={k_args}")
    else:
        yd = y0.new_zeros((k_args if args_d is not None else 0, m, dim))
    k_dirs = yd.shape[0]
    args_rows = [None] * k_dirs if args_d is None else \
        [cm.tree_map(lambda a, _k=k: a[_k], args_d) for k in range(k_dirs)]

    f0 = f(t0, y0, args)
    direction = torch.where(tf >= t0, 1.0, -1.0).to(dtype)
    if _h0 is not None:
        # signed per-lane warm start (segment chaining in solve.adjoint);
        # lanes with _h0 == 0 take the automatic initial step
        if mass is None:
            h_auto = cm.initial_step(f, t0, y0, f0, tf, 3, opts.rtol,
                                     opts.atol, args, opts.max_step)
        else:
            h_auto = torch.clamp(torch.abs(tf - t0) * 1e-2, max=1e-3) \
                * direction
        h_mag = torch.abs(cm.like(_h0, y0).broadcast_to((m,)))
        h_st = torch.where(h_mag > 0, h_mag * direction, h_auto)
    elif opts.h0 == 0.0:
        h_st = cm.initial_step(f, t0, y0, f0, tf, 3, opts.rtol, opts.atol,
                               args, opts.max_step)
    else:
        h_st = torch.full((m,), opts.h0, dtype=dtype, device=dev) * direction

    use_dense = t_eval is not None
    if use_dense:
        t_eval = cm.like(t_eval, y0)
        at_t0 = t_eval[None, :] == t0[:, None]
        out_ys = torch.where(at_t0[..., None], y0[:, None, :], torch.nan)
        if use_sens:
            out_sd = torch.where(at_t0[None, :, :, None], yd[:, :, None, :],
                                 torch.nan)
    need_qd = use_sens and (use_dense or bool(specs))

    mesh = None
    if mesh_cap:
        # accepted-step rings: step start t, signed h, start state and the
        # collocation polynomial in the ladder's padded power basis
        mesh = {"t": zeros(m, mesh_cap), "h": zeros(m, mesh_cap),
                "y": zeros(m, mesh_cap, dim),
                "q": zeros(m, mesh_cap, smax, dim)}

    stats = cm.zero_stats(m, ("nfev", "njev", "nlu", "nsteps", "naccept",
                              "nreject", "nnewton"), dev)
    stats["nfev"] = stats["nfev"] + 2
    already_done = t0 == tf
    order = torch.full((m,), min(max(3, orders[0]), orders[-1]),
                       dtype=torch.int32, device=dev)
    if use_gmres:
        pb = opts.precond_block
        jac_m = zeros(m, dim // pb, pb, pb) if opts.precond == "block" \
            else zeros(m, 3, dim)
    else:
        jac_m = zeros(m, dim, dim)
        lu_real, piv_real = zeros(m, dim, dim), zeros(m, dim, dt=torch.int32)
        lu_cplx = zeros(m, pmax, 2 * dim, 2 * dim)
        piv_cplx = zeros(m, pmax, 2 * dim, dt=torch.int32)
    t, y = t0, y0
    t_lin, y_lin = t0, y0
    h_fact = zeros(m)
    current_jac = zeros(m, dt=torch.bool)
    need_jac = torch.ones((m,), dtype=torch.bool, device=dev)
    h_old, err_old = zeros(m), zeros(m)
    rejected = zeros(m, dt=torch.bool)
    nsing = zeros(m, dt=torch.int32)
    q_poly = zeros(m, smax, dim)
    h_prev = torch.ones((m,), dtype=dtype, device=dev)
    have_sol = zeros(m, dt=torch.bool)
    active = ~already_done
    status = torch.where(already_done, cm.SUCCESS, cm.RUNNING).to(torch.int8)
    td = zeros(k_dirs, m)                   # dt*_k of the IND event jump
    ev = init_event_state(specs, m, dim, t0, y0, args)
    dyn = init_dyn(m, opts.record_steps, y0)
    eps = torch.finfo(dtype).eps

    while True:
        remaining = tf - t
        last = torch.abs(h_st) >= torch.abs(remaining)
        h = torch.where(last, remaining, h_st)
        h = torch.where(h == 0.0, eps, h)

        # ---- the attempt's one read: the loop, the Jacobian, the orders --
        needj = need_jac & active
        sels = [active & (order == s) for s in orders]
        needfs = [sel & (needj | (h != h_fact)) for sel in sels]
        flags = syncs.any_each(active, needj, *sels, *needfs)
        if not flags[0]:
            break
        held = dict(zip(orders, flags[2:2 + len(orders)]))
        any_f = dict(zip(orders, flags[2 + len(orders):]))

        if flags[1]:
            jnew = jac_fn(t, y, args)
            jmat = torch.where(needj.reshape((m,) + (1,) * (jnew.ndim - 1)),
                               jnew, jac_m)
        else:
            jmat = jac_m
        current_jac = current_jac | needj
        t_lin = torch.where(needj, t, t_lin)
        y_lin = torch.where(needj[:, None], y, y_lin)

        # ---- per-order factorization and Newton -------------------------
        fact_ok = torch.ones((m,), dtype=torch.bool, device=dev)
        h_fact_now = h_fact
        conv = zeros(m, dt=torch.bool)
        attempted = zeros(m, dt=torch.bool)
        y_new = y
        ze = zeros(m, dim)
        q_new = q_poly
        z_buf = zeros(m, smax, dim) if use_sens else None
        niter = zeros(m, dt=torch.int32)
        rate = zeros(m)
        nfev_add = zeros(m, dt=torch.int32)
        nlu_add = zeros(m, dt=torch.int32)
        scale_n = opts.atol + opts.rtol * torch.abs(y)
        if use_index:
            scale_n = scale_n / torch.abs(h)[:, None] ** ind_exp[None, :]
        poly_1 = _sum_seq(q_poly, 1)           # the warm start's poly at θ=1
        solvers = {}
        for s, sel, needf in zip(orders, sels, needfs):
            if not held[s]:
                continue
            tab = tabs[s]
            npair = (s - 1) // 2
            if use_gmres:
                # nothing to factor: this order's matrix-free solvers at
                # this attempt's h and the frozen linearization point
                solvers[s] = _gmres_stage_solver(
                    tab, f, t_lin, y_lin, args, jmat, h, mass, g_iters,
                    precond=opts.precond, block=opts.precond_block)
                ok_g = torch.isfinite(jmat).flatten(1).all(dim=1)
                fact_ok = torch.where(needf, ok_g, fact_ok)
                h_fact_now = torch.where(needf, h, h_fact_now)
            else:
                if any_f[s]:
                    lr, pr, lc, pc, ok = _factorize(tab, h, jmat, mass,
                                                    opts.pivoting,
                                                    factor=factor)
                    lu_real = torch.where(needf[:, None, None], lr, lu_real)
                    piv_real = torch.where(needf[:, None], pr, piv_real)
                    lu_cplx = torch.where(needf[:, None, None, None],
                                          _pad_stages(lc, pmax, 1), lu_cplx)
                    piv_cplx = torch.where(needf[:, None, None],
                                           _pad_stages(pc, pmax, 1), piv_cplx)
                    fact_ok = torch.where(needf, ok, fact_ok)
                    h_fact_now = torch.where(needf, h, h_fact_now)
                    nlu_add = nlu_add + _i32(needf) * (1 + npair)
                solvers[s] = _lu_solvers(lu_real, piv_real, lu_cplx,
                                         piv_cplx, use_kernel, opts.pivoting)
            run_s = sel & fact_ok
            c_nodes, e_vec, p_mat = consts[s]
            # warm start from the previous collocation polynomial (padded)
            theta = 1.0 + c_nodes[None, :] * (h / h_prev)[:, None]
            powers = torch.stack([_ipow(theta, q + 1) for q in range(smax)],
                                 dim=-1)                         # [M, s, Q]
            poly_at = cm.lane_einsum("msq,mqd->msd", powers, q_poly)
            z0 = torch.where(have_sol[:, None, None],
                             poly_at - poly_1[:, None, :], 0.0)
            z, cv, ni, nf, rt = _newton(tab, f, t, y, h, z0, scale_n,
                                        newton_tol, *solvers[s], run_s,
                                        max_iter, args, syncs, mass=mass)
            ze_s = cm.lane_einsum("s,msd->md", e_vec, z) / h[:, None]
            q_s = _pad_stages(cm.lane_einsum("msd,sq->mqd", z, p_mat), smax, 1)
            conv = torch.where(run_s, cv, conv)
            y_new = torch.where(run_s[:, None], y + z[:, -1, :], y_new)
            ze = torch.where(run_s[:, None], ze_s, ze)
            q_new = torch.where(run_s[:, None, None], q_s, q_new)
            if use_sens:
                z_buf = torch.where(run_s[:, None, None],
                                    _pad_stages(z, smax, 1), z_buf)
            niter = torch.where(run_s, ni, niter)
            rate = torch.where(run_s, rt, rate)
            nfev_add = nfev_add + torch.where(run_s, nf, 0)
            attempted = attempted | run_s

        singular = active & ~fact_ok
        conv = attempted & conv
        newton_fail = attempted & ~conv
        nf_stale = newton_fail & ~current_jac
        nf_fresh = (newton_fail & current_jac) | singular

        # ---- error estimate (each lane's own order's real factor) --------
        ze = mdot(ze)
        if use_gmres:
            # per-lane real shift γ0_s/h with the lane's OWN order's γ0
            gam0 = zeros(m)
            for s in orders:
                gam0 = torch.where(order == s, float(tabs[s].mu_real), gam0)
            solve_err, _ = gmres_shifted_solver(
                f, t_lin, y_lin, args, jmat, gam0 / h, torch.ones_like(h),
                mass, g_iters, precond=opts.precond,
                block=opts.precond_block)
        else:
            solve_err = _lu_solvers(lu_real, piv_real, lu_cplx, piv_cplx,
                                    use_kernel, opts.pivoting)[0]
        err1 = solve_err(f0 + ze)
        scale_e = opts.atol + opts.rtol * torch.maximum(torch.abs(y),
                                                        torch.abs(y_new))
        if use_index:
            scale_e = scale_e / torch.abs(h)[:, None] ** ind_exp[None, :]
        enorm1 = _rms(err1 / scale_e)
        enorm1 = torch.where(torch.isfinite(enorm1), enorm1, 1e10)
        refine = conv & rejected & (enorm1 > 1.0)
        if use_gmres and not syncs.any(refine):
            enorm = enorm1
        else:
            err2 = solve_err(f(t, y + err1, args) + ze)
            en2 = _rms(err2 / scale_e)
            enorm = torch.where(refine, torch.where(torch.isfinite(en2), en2,
                                                    1e10), enorm1)
        accept = conv & (enorm <= 1.0)
        reject_err = conv & (enorm > 1.0)

        # ---- IND tangent sweep at each lane's own order -------------------
        yd_old = yd
        if use_sens:
            yd_delta = torch.zeros_like(yd)
            qd_all = zeros(k_dirs, m, smax, dim) if need_qd else None
            occupied = [s for s in orders if held[s]]
            masks = [accept & (order == s) for s in occupied]
            for s, msk, on in zip(occupied, masks, syncs.any_each(*masks)):
                if not on:
                    continue
                zd = _tangent_stages(tabs[s], f, t, y, h, z_buf[:, :s, :],
                                     yd, newton_tol, *solvers[s], msk, args,
                                     syncs, max_iter=max_iter, args_d=args_d,
                                     mass=mass)
                yd_delta = torch.where(msk[None, :, None], zd[:, :, -1, :],
                                       yd_delta)
                if need_qd:
                    qd = cm.lane_einsum("kmsd,sq->kmqd", zd, consts[s][2])
                    qd_all = torch.where(msk[None, :, None, None],
                                         _pad_stages(qd, smax, 2), qd_all)
            yd = torch.where(accept[None, :, None], yd + yd_delta, yd)

        # ---- controller with the per-lane order exponent ------------------
        h_abs = torch.abs(h)
        niter_f = torch.clamp(niter, min=1).to(dtype)
        safety = _rdiv(opts.safety * (2 * max_iter + 1),
                       2 * max_iter + niter_f)
        have_old = (h_old > 0) & (err_old > 0) & (enorm > 0)
        expo = _rdiv(1.0, order.to(dtype) + 1.0)
        enorm_safe = torch.clamp(enorm, min=1e-16)
        mult = torch.where(
            have_old, h_abs / torch.where(h_old == 0, 1.0, h_old)
            * _pow(err_old / enorm_safe, expo), 1.0)
        base_factor = torch.clamp(mult, max=1.0) * _pow(enorm_safe, -expo)
        fac_rej = torch.clamp(safety * base_factor, min=opts.min_factor)
        fac_acc = torch.clamp(safety * base_factor, opts.min_factor,
                              opts.max_factor)
        recompute_jac = accept & (niter > 2) & (rate > opts.jac_recompute)
        deadzone = accept & ~recompute_jac & (fac_acc >= opts.quot1) & \
            (fac_acc < opts.quot2)
        fac_acc = torch.where(deadzone, 1.0, fac_acc)

        # ---- order adaptation (Hairer's Θ rules) ----------------------------
        order_up = accept & (rate < VITU) & (niter <= 2) & \
            (order < orders[-1])
        order_down = accept & ((rate > VITD) | (niter >= max_iter - 1)) & \
            (order > orders[0])
        order_next = torch.where(order_up, order + 2,
                                 torch.where(order_down, order - 2, order))
        fac_acc = torch.where(order_up, fac_acc * HHOU,
                              torch.where(order_down, fac_acc * HHOD,
                                          fac_acc))
        order_changed = order_next != order

        t_new = t + h
        f_new = torch.where(accept[:, None], f(t_new, y_new, args), f0)

        def interp(theta):                          # [M, T] -> [M, T, D]
            tp = torch.stack([_ipow(theta, q + 1) for q in range(smax)],
                             dim=-1)
            return y[:, None, :] + cm.lane_einsum("mtq,mqd->mtd", tp, q_new)

        if use_dense:
            inside, tpow = cm.dense_window(t_eval, t, h, accept, smax)
            out_ys = torch.where(
                inside[..., None],
                y[:, None, :] + cm.lane_einsum("mtq,mqd->mtd", tpow, q_new),
                out_ys)
            if use_sens:
                out_sd = torch.where(
                    inside[None, :, :, None],
                    yd_old[:, :, None, :]
                    + cm.lane_einsum("mtq,kmqd->kmtd", tpow, qd_all), out_sd)

        ev, terminate, t_ev, y_ev, ev_idx = handle_events(
            specs, ev, t, h, t_new, y_new, interp, accept, args, syncs)
        if specs and use_dense:
            out_ys = cm.mask_dense_after_event(out_ys, t_eval, terminate,
                                               t_ev, h)
            if use_sens:
                out_sd = cm.mask_dense_after_event(out_sd, t_eval, terminate,
                                                   t_ev, h)
        if use_sens and specs:
            # the total derivative at the event off the tangent polynomial
            # at the lane's own order (the fixed-stage path's jump)
            th_e = torch.where(terminate, torch.clamp(
                (t_ev - t) / torch.where(h == 0.0, 1.0, h), 0.0, 1.0), 1.0)
            yd, dts = _event_tangent_jump(
                specs, f, t_ev, y_ev, args, args_rows, mass, False,
                opts.gmres_iters, yd_old, qd_all, th_e, ev_idx, terminate, yd)
            td = torch.where(terminate[None, :], dts, td)

        if use_quad:
            q_acc = cm.quad_gl3_step(ql, t, h, interp, accept, terminate,
                                     t_ev, q_acc)
        if mesh is not None:
            cm.ring_write(mesh, stats["naccept"], accept,
                          {"t": t, "h": h, "y": y, "q": q_new})
        dyn = record_step(dyn, attempted | singular, t, h, enorm, niter,
                          accept)

        # ---- state update ---------------------------------------------------
        h_next_abs = torch.where(
            accept, h_abs * fac_acc,
            torch.where(reject_err, h_abs * fac_rej,
                        torch.where(nf_fresh, h_abs * 0.5, h_abs)))
        h_next_abs = torch.clamp(h_next_abs, max=opts.max_step)
        h_st = torch.where(active, h_next_abs * torch.sign(h), h_st)
        done = accept & last

        stats["nfev"] = stats["nfev"] + nfev_add + _i32(accept) \
            + _i32(refine)
        stats["njev"] = stats["njev"] + _i32(needj)
        stats["nlu"] = stats["nlu"] + nlu_add
        stats["nsteps"] = stats["nsteps"] + _i32(attempted | singular)
        stats["naccept"] = stats["naccept"] + _i32(accept)
        stats["nreject"] = stats["nreject"] + _i32(reject_err | newton_fail
                                                   | singular)
        stats["nnewton"] = stats["nnewton"] + niter

        nsing = torch.where(singular | newton_fail, nsing + 1,
                            torch.where(accept, 0, nsing))
        stall = active & (nsing >= 7)
        exceeded = active & (stats["nsteps"] >= opts.max_steps) & ~done
        # Hairer's t-relative underflow test
        underflow = active & (0.1 * h_next_abs <= eps * torch.abs(t_new)) \
            & ~done

        status = torch.where(done, cm.SUCCESS, status)
        status = torch.where(exceeded, cm.MAX_STEPS, status)
        status = torch.where(underflow, cm.STEP_UNDERFLOW, status)
        status = torch.where(stall, cm.NEWTON_STALL, status)
        status = torch.where(terminate, cm.EVENT_TERMINATED, status)
        order = torch.where(active, order_next, order)
        active = active & ~done & ~exceeded & ~underflow & ~stall & \
            ~terminate

        t = torch.where(accept, torch.where(terminate, t_ev, t_new), t)
        y = torch.where(accept[:, None],
                        torch.where(terminate[:, None], y_ev, y_new), y)
        f0 = f_new
        jac_m = jmat
        h_fact = torch.where((accept & ~deadzone) | reject_err | nf_fresh
                             | order_changed, 0.0, h_fact_now)
        current_jac = torch.where(accept, False, current_jac)
        need_jac = torch.where(accept, recompute_jac,
                               torch.where(nf_stale, True,
                                           torch.where(needj, False,
                                                       need_jac)))
        h_old = torch.where(accept, h_abs, h_old)
        err_old = torch.where(accept, enorm_safe, err_old)
        rejected = torch.where(accept, False,
                               rejected | reject_err | newton_fail | singular)
        q_poly = torch.where(accept[:, None, None], q_new, q_poly)
        h_prev = torch.where(accept, h, h_prev)
        have_sol = have_sol | accept

    solve_radau_vo.host_syncs = syncs.count
    return cm.Solution(
        t=t, y=y, status=status, stats=stats,
        ts=t_eval if use_dense else None,
        ys=out_ys if use_dense else None,
        event_t=ev["event_t"] if specs else None,
        event_y=ev["event_y"] if specs else None,
        event_idx=ev["event_idx"] if specs else None, dyn=dyn,
        sens=yd if use_sens else None, mesh=mesh,
        sens_ys=out_sd if (use_sens and use_dense) else None,
        h_next=h_st,
        quad=(q_acc[:, 0] if quad_scalar else q_acc) if use_quad else None,
        sens_t=td if (use_sens and specs) else None)


solve_radau_vo.host_syncs = 0
