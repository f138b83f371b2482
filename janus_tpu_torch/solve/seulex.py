"""Batched SEULEX: semi-implicit Euler with polynomial extrapolation.

The port of ``janus_tpu/solve/seulex.py`` (the Numerical Recipes StepperSie
algorithm, batched over lanes): the subdivision ladder nseq = 2, 3, 4, 6,
8, 12, ... (nseq[i] = 2·nseq[i−2]) up to ``Options.seulex_kmax``, the work
model (a Jacobian costs 5, an LU, an f and a solve 1 each), θ-gated
Jacobian reuse (refresh only when the last stability check's contraction
exceeds min(1e-4, rtol)), the stability check on the first substep of
levels 0 and 1, and the STEPFAC/KFAC order-window controller.

One step attempt of every active lane per trip of a Python loop. Level k of
the ladder factors M/h' − J once (h' = h/nseq[k]), runs its nseq[k]
linearly implicit Euler substeps and adds a row to the Aitken–Neville
table; a lane stops climbing once it converged, diverged or failed the
stability check. The reference gates each level on ``any(lane still needs
it)``; here that is one host read a level from level 1 on, which also
reads whether any lane has accepted so far (the gate of the two f
evaluations the interpolant needs), and the ladder stops at the first level
no lane needs (no lane needs a higher one either). The Jacobian's gate is
read with the loop's condition at the top of an attempt. So a solve costs
one host sync an attempt plus one a level climbed past level 0
(``solve_seulex.host_syncs``).

Dense output, events, ``quad=`` and ``dense=`` use the step's
extrapolation-consistent interpolant: the quartic through (y0, f0, ymid,
y1, f1) where ymid is the extrapolated step midpoint of a parallel Neville
table over the even-nseq levels; the quadratic through (y0, ymid, y1) under
a mass matrix; the cubic Hermite (linear under a mass) on lanes accepting
below level 2. Each is held in the power basis y0 + Σ_p θ^{p+1}·q_p, the
form ``Solution.interpolate`` evaluates.

Rounding as the reference's: XLA on the CPU divides by a constant as a
multiplication by its rounded reciprocal (and so does torch on the card),
so ``x / c`` is written ``x * (1/c)`` here; a number divided by a tensor is
a true division (``radau_fused._rdiv``); the RMS norms add in sequence
(``ndf._rms``); pow(x, 1/2) is a square root, as XLA folds it.

With ``Options(kernel_lu=True)`` (pivot-free) the CUDA kernel K1 factors
every level's matrix and K2 does every substep, stability-check and tangent
solve (``ops.smalllu``; their plain twins on CPU tensors).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch.func import jvp

from janus_tpu_torch.linalg.smalllu import lu_factor, lu_ok, lu_solve
from janus_tpu_torch.solve import common as cm
from janus_tpu_torch.solve.dopri import power_interp
from janus_tpu_torch.solve.events import (handle_events, init_event_state,
                                          normalize_events)
from janus_tpu_torch.solve.ndf import _rms
from janus_tpu_torch.solve.options import Options
from janus_tpu_torch.solve.radau import (_i32, _kernel_lu_factor,
                                         _kernel_lu_solve, default_jacobian,
                                         refuse_kernel_derivatives)
from janus_tpu_torch.solve.radau_fused import _rdiv
from janus_tpu_torch.solve.rodas import mass_dot

# NR StepperSie controller constants
STEPFAC1 = 0.65
STEPFAC2 = 0.94
STEPFAC3 = 0.02
STEPFAC4 = 4.0
STEPFAC5 = 0.5
KFAC1 = 0.7
KFAC2 = 0.9
# the work model
COST_FUNC = 1.0
COST_JAC = 5.0
COST_LU = 1.0
COST_SOLVE = 1.0

# quartic dense output: given a0 = y0, a1 = h·f0, the remaining coefficients
# satisfy [[1,1,1],[2,3,4],[1/4,1/8,1/16]]·[a2,a3,a4] =
# [y1−y0−a1, h·f1−a1, ymid−y0−a1/2]
_QI = np.linalg.inv(np.array([[1.0, 1.0, 1.0],
                              [2.0, 3.0, 4.0],
                              [0.25, 0.125, 0.0625]]))


def _nseq(kmax: int):
    """Subdivision ladder: 2, 3, 4, 6, 8, 12, ... (nseq[i] = 2*nseq[i-2])."""
    ns = [2, 3]
    for i in range(2, kmax + 1):
        ns.append(2 * ns[i - 2])
    return ns


def _cost(kmax: int):
    """The cumulative work of levels 0..kmax."""
    nseq = _nseq(kmax)
    cost = np.zeros(kmax + 1)
    cost[0] = COST_JAC + COST_LU + nseq[0] * (COST_FUNC + COST_SOLVE)
    for k in range(kmax):
        cost[k + 1] = (cost[k] + (nseq[k + 1] - 1) * (COST_FUNC + COST_SOLVE)
                       + COST_LU)
    return cost


def _over(x, c: float):
    """x / c for a number c, rounded as the reference's: x times the rounded
    reciprocal of c (XLA's rewrite of a division by a constant)."""
    return x * (1.0 / c)


def _pick(arr, idx):
    """arr[:, idx] with per-lane idx: arr [M, K], idx [M] int64."""
    return arr.gather(1, idx[:, None])[:, 0]


def neville_row(row_prev, yk, nseq, k):
    """Level k's row of the Aitken–Neville table from level k−1's row."""
    row = [yk]
    for j in range(k):
        row.append(row[j] + _over(row[j] - row_prev[j],
                                  nseq[k] / nseq[k - j - 1] - 1.0))
    return row


def midpoint_row(rows_mid, even_nseq, ymid_k, nj):
    """An even-nseq level's row of the parallel table of step midpoints."""
    rowm = [ymid_k]
    for j in range(len(rows_mid)):
        rowm.append(rowm[j] + _over(rowm[j] - rows_mid[-1][j],
                                    nj / even_nseq[-1 - j] - 1.0))
    return rowm


def step_poly(y, y_new, ymid, mid_ok, h, fy, fn, massive):
    """The accepted step's interpolant in the power basis y + Σ_p
    θ^{p+1}·q[:, p]: q [M, 4, D]. The quartic through (y0, f0, ymid, y1,
    f1) on mid_ok lanes, else the cubic Hermite; under a mass matrix
    (``massive``; f is no derivative on algebraic rows) the quadratic
    through (y0, ymid, y1), else the line."""
    zero = torch.zeros_like(y)
    dy = y_new - y
    if massive:
        q_hi = torch.stack([4.0 * ymid - y_new - 3.0 * y,
                            2.0 * y_new + 2.0 * y - 4.0 * ymid, zero, zero],
                           dim=1)
        q_lo = torch.stack([dy, zero, zero, zero], dim=1)
    else:
        b1 = h[:, None] * fy
        hf1 = h[:, None] * fn
        r1 = dy - b1
        r2 = hf1 - b1
        r3 = ymid - y - 0.5 * b1
        a2, a3, a4 = (float(_QI[i, 0]) * r1 + float(_QI[i, 1]) * r2
                      + float(_QI[i, 2]) * r3 for i in range(3))
        q_hi = torch.stack([b1, a2, a3, a4], dim=1)
        q_lo = torch.stack([b1, 3.0 * dy - 2.0 * b1 - hf1,
                            -2.0 * dy + b1 + hf1, zero], dim=1)
    return torch.where(mid_ok[:, None, None], q_hi, q_lo)


def solve_seulex(f: Callable, t0, tf, y0, args=None,
                 options: Optional[Options] = None, t_eval=None,
                 jac: Optional[Callable] = None, mass=None, events=None,
                 tangents=None, args_tangents=None,
                 quad: Optional[Callable] = None, dense: int = 0,
                 step_args=None, _mesh_size: int = 0, _h0=None,
                 _force_jac: bool = False, device=None) -> cm.Solution:
    """Batched adaptive SEULEX solve (extrapolated linearly implicit Euler).

    f(t [M], y [M, D], args) -> [M, D]; y0 [M, D]. A torch y0 solves on its
    own device; any other y0 goes to ``device``, by default the CUDA card.
    mass: [D, D] or [M, D, D], singular index-1 allowed: the substeps solve
    (M/h' − J)·d = f.

    t_eval: shared output grid [T]; ``Solution.ys`` [M, T, D] from the
    step's interpolant (module docstring). events: ``solve.events.Event``
    spec(s) located on it. quad: running-cost integrand ``l(t [M], y [M,
    D], args) -> [M]`` or [M, Q]; ``Solution.quad`` by 3-point
    Gauss-Legendre on each accepted step's interpolant, truncated at t* on
    event-terminated lanes. dense: step-mesh capacity N > 0 storing each
    accepted step's interpolant for ``Solution.interpolate(ts)`` (lanes
    that overflow it interpolate to NaN).

    tangents [K, M, D] / args_tangents (args' tree with a leading K axis):
    forward sensitivities by internal differentiation, terminal mode only.
    The tangents run the same ladder: each substep applies the level's
    factors to the variational rhs J·δ + f_θ·dθ (a ``torch.func.jvp`` of f
    per direction) and the tangent rows extrapolate through the same
    Neville table. The semi-implicit Euler is a W-method, so the ladder
    extrapolates to the variational flow although ∂A/∂y is dropped.
    ``Solution.sens`` [K, M, D].

    step_args: per-accepted-step parameter slabs; every f and J evaluation
    of a lane's k-th accepted-step attempt runs on slab row k as
    f(t, y, (args, slab_k)); a lane that runs out fails with
    PARAMS_EXHAUSTED.

    ``_mesh_size`` records (t, h, y, accepted level k) per accepted step,
    ``_h0`` is a per-lane warm-start step (0 = automatic) and
    ``_force_jac`` refreshes the Jacobian at every new step point, so that
    the discrete adjoint's replay (``solve.adjoint_seulex``) reproduces
    every iteration matrix. The host syncs of the last solve are in
    ``solve_seulex.host_syncs``.
    """
    opts = options if options is not None else Options()
    if opts.kernel_lu and opts.pivoting:
        raise ValueError("Options(kernel_lu=True) needs pivoting=False "
                         "(the SoA kernels are pivot-free)")
    if opts.nind2 or opts.nind3:
        raise ValueError("Options.nind2/nind3 (higher-index DAE error "
                         "weighting) is honored by 'radau'/'radaup' only; "
                         "seulex would silently integrate with wrong weights")
    specs = normalize_events(events)
    store_q = bool(dense)
    mesh_size = max(int(_mesh_size), int(dense))
    t0, tf, y0 = cm.broadcast_batch(t0, tf, y0, device)
    refuse_kernel_derivatives(opts.kernel_lu, "solve_seulex", y0, t0, tf,
                              args, tangents, args_tangents, mass, step_args)
    m, dim = y0.shape
    dtype, dev = y0.dtype, y0.device
    syncs = cm._HostSyncs()
    jac_fn = jac if jac is not None else default_jacobian(f)
    if mass is not None:
        mass = cm.like(mass, y0)
        if tuple(mass.shape) not in ((dim, dim), (m, dim, dim)):
            raise ValueError(f"mass must be [{dim}, {dim}] or [{m}, {dim}, "
                             f"{dim}], got {tuple(mass.shape)}")
    mdot = mass_dot(mass)
    mm = torch.eye(dim, dtype=dtype, device=dev)[None] if mass is None \
        else (mass[None] if mass.ndim == 2 else mass)

    use_slabs = step_args is not None
    use_sens = tangents is not None or args_tangents is not None
    if use_slabs:
        if use_sens:
            raise ValueError("step_args= does not compose with tangents= "
                             "(slab rows are step-indexed; seed the slab "
                             "table directly via torch.func.jvp instead)")
        if _mesh_size:
            raise ValueError("step_args= does not compose with the discrete "
                             "adjoint (the replay has no slab index); use "
                             "time-indexed controls for reverse mode")
        n_slabs, slab_at = cm.make_slab_selector(step_args, y0)
    if use_sens and (t_eval is not None or events is not None):
        raise ValueError("solve_seulex(tangents=) is terminal-mode only "
                         "(no tangent dense output/event correction); use "
                         "torch.func.jvp through the solve for those")

    k_dirs = 0
    if use_sens:
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
            yd = y0.new_zeros((k_args, m, dim))
        k_dirs = yd.shape[0]
        args_rows = [None] * k_dirs if args_d is None else \
            [cm.tree_map(lambda a, _k=k: a[_k], args_d) for k in range(k_dirs)]

        def var_rhs(ti, yi, dys):
            """[K, M, D]: J(ti, yi)·δ_k (+ f_θ·dθ_k) for every direction."""
            return torch.stack([
                jvp(lambda yy: f(ti, yy, args), (yi,), (dys[k],))[1]
                if args_rows[k] is None else
                jvp(lambda yy, aa: f(ti, yy, aa), (yi, args),
                    (dys[k], args_rows[k]))[1]
                for k in range(k_dirs)])

    if opts.kernel_lu:
        factor = _kernel_lu_factor

        def solver(lu, piv):
            return lambda b: _kernel_lu_solve(lu, b)
    else:
        def factor(a):
            return lu_factor(a, pivot=opts.pivoting)

        def solver(lu, piv):
            return lambda b: lu_solve(lu, piv, b, pivot=opts.pivoting)

    def solve_k(slv, rhs):                   # [K, M, D] -> [K, M, D]
        if opts.kernel_lu:                   # K2 once per direction
            return torch.stack([slv(rhs[q]) for q in range(k_dirs)])
        # the plain LU solves the K right-hand sides as columns
        return slv(rhs.permute(1, 2, 0)).permute(2, 0, 1)

    kmax = opts.seulex_kmax                  # levels 0..kmax run
    n_lv = kmax + 1
    nseq = _nseq(kmax)
    cost_np = _cost(kmax)
    cost = torch.as_tensor(cost_np, dtype=dtype, device=dev)
    jac_redo = min(1.0e-4, opts.rtol)

    if use_slabs:
        args0 = (args, slab_at(torch.zeros((m,), dtype=torch.int32,
                                           device=dev)))
    else:
        args0 = args
    f0 = f(t0, y0, args0)
    direction = torch.where(tf >= t0, 1.0, -1.0).to(dtype)
    # singular-mass systems: f0 is no derivative on the algebraic rows
    h_small = torch.clamp(torch.abs(tf - t0) * 1e-2, max=1e-3)
    if _h0 is not None:
        # per-lane warm start (segment chaining, solve.adjoint_seulex):
        # lanes with _h0 == 0 take the automatic initial step
        h_mag = torch.abs(cm.like(_h0, y0).broadcast_to((m,)))
        h_auto = torch.abs(cm.initial_step(
            f, t0, y0, f0, tf, 4, opts.rtol, opts.atol, args0,
            opts.max_step)) if mass is None else h_small
        h_mag = torch.where(h_mag > 0, h_mag, h_auto)
        h_st = torch.minimum(h_mag, torch.abs(tf - t0)) * direction
    elif opts.h0 == 0.0:
        h_st = cm.initial_step(f, t0, y0, f0, tf, 4, opts.rtol, opts.atol,
                               args0, opts.max_step) if mass is None \
            else h_small * direction
    else:
        h_st = torch.full((m,), opts.h0, dtype=dtype, device=dev) * direction

    use_dense = t_eval is not None
    if use_dense:
        t_eval = cm.like(t_eval, y0)
        at_t0 = t_eval[None, :] == t0[:, None]
        out_ys = torch.where(at_t0[..., None], y0[:, None, :], torch.nan)

    use_quad = quad is not None
    if use_quad:
        qshape = tuple(quad(t0, y0, args).shape)
        if qshape != (m,) and (len(qshape) != 2 or qshape[0] != m):
            raise ValueError(f"quad must return [M] or [M, Q] with M={m}, "
                             f"got {qshape}")
        quad_scalar = len(qshape) == 1

        def ql(tt, yy):                          # canon [M, Q]
            return cm.canon_cost(quad(tt, yy, args))

        q_acc = y0.new_zeros((m, 1 if quad_scalar else qshape[1]))

    # the tolerance-derived initial target level (NR StepperSie)
    logfact = -np.log10(opts.rtol + opts.atol) * 0.6 + 0.5
    kt0 = int(np.clip(round(logfact), 1, kmax - 1))

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    stats = cm.zero_stats(m, ("nfev", "njev", "nlu", "nsteps", "naccept",
                              "nreject", "order"), dev)
    stats["nfev"] = stats["nfev"] + 2
    rings = None
    if mesh_size:
        # accepted-step rings: (t, h, y, accepted level) at the START of each
        # accepted step, and with dense= the step's interpolant
        rings = {"t": zeros(m, mesh_size), "h": zeros(m, mesh_size),
                 "y": zeros(m, mesh_size, dim),
                 "k": zeros(m, mesh_size, dt=torch.int32)}
        if store_q:
            rings["q"] = zeros(m, mesh_size, 4, dim)

    t, y = t0, y0
    k_targ = torch.full((m,), kt0, dtype=torch.int64, device=dev)
    theta = torch.full((m,), 2.0 * jac_redo, dtype=dtype, device=dev)
    jmat = zeros(m, dim, dim)
    calcjac = zeros(m, dt=torch.bool)
    first = torch.ones((m,), dtype=torch.bool, device=dev)
    rejected = zeros(m, dt=torch.bool)
    nbad = zeros(m, dt=torch.int32)
    already_done = t0 == tf
    active = ~already_done
    status = torch.where(already_done, cm.SUCCESS, cm.RUNNING).to(torch.int8)
    ev = init_event_state(specs, m, dim, t0, y0, args)
    eps = torch.finfo(dtype).eps
    no_lanes = zeros(m, dt=torch.bool)
    want_interp = use_dense or bool(specs) or use_quad or store_q

    while True:
        # ---- the loop's condition and the θ-gated Jacobian, one read ------
        # _force_jac (adjoint recording): every NEW step point refreshes, so
        # the replay's fresh jac_fn(t_n, y_n) is the forward matrix exactly
        needj = active & ~calcjac
        if not _force_jac:
            needj = needj & (theta > jac_redo)
        go, any_j = syncs.any_each(active, needj)
        if not go:
            break
        remaining = tf - t
        last = torch.abs(h_st) >= torch.abs(remaining)
        h = torch.where(last, remaining, h_st)
        h = torch.where(h == 0.0, eps, h)
        h_abs = torch.abs(h)
        scale = opts.atol + opts.rtol * torch.abs(y)
        if use_slabs:
            exhausted = active & (stats["naccept"] >= n_slabs)
            fa = (args, slab_at(stats["naccept"]))
        else:
            exhausted = no_lanes
            fa = args
        if any_j:
            jmat = torch.where(needj[:, None, None], jac_fn(t, y, fa), jmat)
        calcjac = calcjac | needj

        # ---- the extrapolation ladder, one host read a level past 0 ------
        decided = ~active
        accept = reject_h = abort = abort_p1 = no_lanes
        y_acc, yd_acc, ymid_acc = y, (yd if use_sens else None), y
        mid_ok = no_lanes
        k_dec = zeros(m, dt=torch.int64)
        errold = zeros(m)
        theta_new = theta
        nfev_add = nlu_add = zeros(m, dt=torch.int32)
        hopt_cols = [h_abs]                  # level 0 placeholder
        work_cols = [torch.full_like(h_abs, torch.inf)]
        rows, rows_d, rows_mid, even_nseq = [], [], [], []
        any_acc = True
        for k in range(n_lv):
            nj = nseq[k]
            need = active & ~decided & (k <= k_targ + 1)
            if k > 0:
                # no lane needs this level, so none needs a higher one
                go_k, any_acc = syncs.any_each(need, accept & ~exhausted)
                if not go_k:
                    break
            hsub = _over(h, nj)
            lu, piv = factor(mm / hsub[:, None, None] - jmat)
            slv = solver(lu, piv)
            ok = lu_ok(lu)
            x1 = t + hsub
            d = slv(f(x1, y, fa))
            if use_sens:
                # the tangent substeps mirror the primal's on its factors
                dd_s = solve_k(slv, var_rhs(x1, y, yd))
                yd_t = yd + dd_s
            # the first substep explicitly (the stability check, k <= 1)
            ytemp = y + d
            fy1 = f(t + 2.0 * hsub, ytemp, fa)
            theta_k = None
            if k <= 1:
                del1 = _rms(d / scale)
                dd = f(x1, ytemp, fa) - mdot(d) / hsub[:, None]
                del2 = _rms(slv(dd) / scale)
                theta_k = del2 / torch.clamp(del1, min=1.0)
                theta_k = torch.where(torch.isfinite(theta_k), theta_k, 2.0)
                ok = ok & (theta_k <= 1.0)
            d = slv(fy1)
            if use_sens:
                dd_s = solve_k(slv, var_rhs(t + 2.0 * hsub, ytemp, yd_t))
            ymid_k = ytemp              # after 1 substep: the nj=2 midpoint
            for nn in range(2, nj):
                ytemp = ytemp + d
                if nn == nj // 2:       # the step midpoint (even nj)
                    ymid_k = ytemp
                t_sub = t + (nn + 1.0) * hsub
                rhs = f(t_sub, ytemp, fa)
                if use_sens:
                    yd_t = yd_t + dd_s
                    dd_s = solve_k(slv, var_rhs(t_sub, ytemp, yd_t))
                d = slv(rhs)
            yk = ytemp + d
            ok = ok & torch.isfinite(yk).all(dim=-1)

            if theta_k is not None:
                theta_new = torch.where(need & (theta_k >= 0.0), theta_k,
                                        theta_new)
            nfev_add = nfev_add + _i32(need) * (
                nj + (1 if k <= 1 else 0) + (nj if use_sens else 0))
            nlu_add = nlu_add + _i32(need)

            stab_fail = need & ~ok
            reject_h = reject_h | stab_fail
            decided = decided | stab_fail
            k_dec = torch.where(stab_fail, k, k_dec)

            row = neville_row(rows[-1] if k else [], yk, nseq, k)
            rows.append(row)
            if use_sens:
                row_d = neville_row(rows_d[-1] if k else [], yd_t + dd_s,
                                    nseq, k)
                rows_d.append(row_d)
            if nj % 2 == 0:
                rows_mid.append(midpoint_row(rows_mid, even_nseq, ymid_k, nj))
                even_nseq.append(nj)
            if k == 0:
                continue

            # ---- the level's error, divergence test and step proposal ----
            live = need & ~stab_fail
            err_k = _rms((row[k] - row[k - 1]) / scale)
            err_k = torch.where(torch.isfinite(err_k), err_k, 1e10)
            err_k = torch.clamp(err_k, min=1e-18)
            div = err_k > 1.0 / eps
            if k > 1:
                div = div | (err_k >= errold)
            div = live & div
            reject_h = reject_h | div
            decided = decided | div
            k_dec = torch.where(div, k, k_dec)
            errold = torch.where(live, torch.clamp(4.0 * err_k, min=1.0),
                                 errold)
            live = live & ~div

            # NR's STEPFAC controller: pow(x, 1/2) is a square root, as XLA
            # folds it
            expo = 1.0 / (k + 1.0)
            facmin = STEPFAC3 ** expo
            ratio = _over(err_k, STEPFAC1)
            powed = torch.sqrt(ratio) if k == 1 else ratio ** expo
            fac = torch.clamp(_rdiv(STEPFAC2, powed), facmin / STEPFAC4,
                              1.0 / facmin)
            hopt_k = h_abs * fac
            hopt_cols.append(torch.where(live, hopt_k, h_abs))
            work_cols.append(torch.where(live, _rdiv(float(cost_np[k]),
                                                     hopt_k), torch.inf))

            # convergence and abort windows around k_targ
            is_m1 = k_targ == k + 1
            is_t = k_targ == k
            is_p1 = k_targ == k - 1
            fl = first | last
            conv = live & (err_k <= 1.0) & (
                fl | (is_m1 & ~rejected & ~fl) | is_t | is_p1)
            accept = accept | conv
            decided = decided | conv
            y_acc = torch.where(conv[:, None], row[k], y_acc)
            if use_sens:
                yd_acc = torch.where(conv[None, :, None], row_d[k], yd_acc)
            if nj % 2 == 0:
                ymid_acc = torch.where(conv[:, None], rows_mid[-1][-1],
                                       ymid_acc)
                if k >= 2:              # levels 0/1 midpoints are too raw
                    mid_ok = mid_ok | conv
            k_dec = torch.where(conv, k, k_dec)
            live = live & ~conv

            ab_m1 = (live & is_m1 & ~rejected & ~fl
                     & (err_k > 4.0 * nseq[min(k + 1, kmax)]
                        * nseq[min(k + 2, kmax)]))
            ab_t = live & is_t & (err_k > 2.0 * nseq[min(k + 1, kmax)])
            ab_p1 = live & is_p1 & (err_k > 1.0)
            abort = abort | ab_m1 | ab_t
            abort_p1 = abort_p1 | ab_p1
            stop = ab_m1 | ab_t | ab_p1
            decided = decided | stop
            k_dec = torch.where(stop, k, k_dec)
        else:
            any_acc = True          # the top level ran: no read since

        # levels no lane ran propose nothing
        while len(hopt_cols) < n_lv:
            hopt_cols.append(h_abs)
            work_cols.append(work_cols[0])

        # exhausted step_args lanes may not advance (PARAMS_EXHAUSTED)
        accept = accept & ~exhausted
        # lanes that ran out of ladder without deciding: a reject
        leftover = active & ~decided
        reject_h = reject_h | leftover
        k_dec = torch.where(leftover, torch.clamp(k_targ + 1, max=kmax),
                            k_dec)
        H = torch.stack(hopt_cols, dim=1)      # [M, K]
        W = torch.stack(work_cols, dim=1)
        reject = reject_h | abort | abort_p1

        # ---- NR retarget on aborts ---------------------------------------
        w_k = _pick(W, k_dec)
        w_km1 = _pick(W, torch.clamp(k_dec - 1, min=0))
        kt_ab = torch.where((k_dec > 1) & (w_km1 < KFAC1 * w_k), k_dec - 1,
                            k_dec)
        w_t = _pick(W, k_targ)
        w_tm1 = _pick(W, torch.clamp(k_targ - 1, min=0))
        kt_p1 = torch.where((k_targ > 1) & (w_tm1 < KFAC1 * w_t), k_targ - 1,
                            k_targ)
        kt_rej = torch.where(abort, kt_ab, torch.where(abort_p1, kt_p1,
                                                       k_targ))
        kt_rej = torch.clamp(kt_rej, 1, kmax - 1)
        h_rej = torch.where(abort | abort_p1, _pick(H, kt_rej),
                            h_abs * STEPFAC5)

        # ---- NR kopt selection on accepts --------------------------------
        kk = k_dec
        w_kk = w_k
        w_kkm1 = w_km1
        w_kkm2 = _pick(W, torch.clamp(kk - 2, min=0))
        kopt_a = torch.where(w_kkm1 < KFAC1 * w_kk, kk - 1,
                             torch.where(w_kk < KFAC2 * w_kkm1,
                                         torch.clamp(kk + 1, max=kmax - 1),
                                         kk))
        kopt_b0 = torch.where((kk > 2) & (w_kkm2 < KFAC1 * w_kkm1), kk - 2,
                              kk - 1)
        w_koptb0 = _pick(W, torch.clamp(kopt_b0, 0, kmax))
        kopt_b = torch.where(w_kk < KFAC2 * w_koptb0,
                             torch.clamp(kk, max=kmax - 1), kopt_b0)
        kopt = torch.where(kk == 1, torch.where(rejected, 1, 2),
                           torch.where(kk <= k_targ, kopt_a, kopt_b))
        kopt = torch.clamp(kopt, 1, kmax - 1)
        h_kk = _pick(H, kk)
        # NR ms521 growth: when converging below target with cheap work,
        # hnew = hopt[k]·cost[k+2]/cost[k]
        cost_kk = cost[kk]
        h_grow = torch.where((kk < k_targ) & (w_kk < KFAC2 * w_kkm1),
                             h_kk * cost[torch.clamp(kk + 2, max=kmax)]
                             / cost_kk,
                             h_kk * cost[kopt] / cost_kk)
        kt_acc = torch.where(rejected, torch.minimum(kopt, kk), kopt)
        h_acc = torch.where(rejected,
                            torch.minimum(h_abs, _pick(H, torch.clamp(
                                kt_acc, 0, kmax))),
                            torch.where(kopt <= kk, _pick(H, kopt), h_grow))
        k_targ_new = torch.where(accept, torch.clamp(kt_acc, 1, kmax - 1),
                                 torch.where(reject, kt_rej, k_targ))
        h_next_abs = torch.where(accept, h_acc,
                                 torch.where(reject, h_rej, h_abs))
        h_next_abs = torch.clamp(torch.clamp(h_next_abs, min=1e-30),
                                 max=opts.max_step)
        h_next = torch.where(active, h_next_abs * torch.sign(h), h_st)

        # ---- the interpolant (its two f evaluations gated on any accept),
        # dense output, events, quadrature and the rings -----------------
        t_new = t + h
        y_new = y_acc
        interp = None
        nfev_interp = 0
        if want_interp:
            if any_acc:
                fn, fy = f(t_new, y_new, fa), f(t, y, fa)
            else:
                fn = fy = torch.zeros_like(y)
            nfev_interp = _i32(accept) * 2
            q_step = step_poly(y, y_new, ymid_acc, mid_ok, h, fy, fn,
                               mass is not None)
            interp = power_interp(y, q_step)
        if rings is not None:
            values = {"t": t, "h": h, "y": y, "k": k_dec.to(torch.int32)}
            if store_q:
                values["q"] = q_step
            cm.ring_write(rings, stats["naccept"], accept, values)
        if use_dense:
            out_ys = cm.collect_dense(out_ys, t_eval, t, h, accept, interp)
        ev, terminate, t_ev, y_ev, _ = handle_events(
            specs, ev, t, h, t_new, y_new, interp, accept, args, syncs)
        if use_dense and specs:
            out_ys = cm.mask_dense_after_event(out_ys, t_eval, terminate,
                                               t_ev, h)
        if use_quad:
            q_acc = cm.quad_gl3_step(ql, t, h, interp, accept, terminate,
                                     t_ev, q_acc)

        # ---- bookkeeping --------------------------------------------------
        done = accept & last
        stats["nfev"] = stats["nfev"] + nfev_add + nfev_interp
        stats["njev"] = stats["njev"] + _i32(needj)
        stats["nlu"] = stats["nlu"] + nlu_add
        stats["nsteps"] = stats["nsteps"] + _i32(active)
        stats["naccept"] = stats["naccept"] + _i32(accept)
        stats["nreject"] = stats["nreject"] + _i32(reject)
        stats["order"] = torch.where(active, (k_targ_new + 1).to(torch.int32),
                                     stats["order"])

        nbad = torch.where(reject, nbad + 1, torch.where(accept, 0, nbad))
        stall = active & (nbad >= 20)
        exceeded = active & (stats["nsteps"] >= opts.max_steps) & ~done
        # Hairer's t-relative underflow test
        underflow = active & (0.1 * h_next_abs <= eps * torch.abs(t_new)) \
            & ~done

        status = torch.where(done, cm.SUCCESS, status)
        status = torch.where(exceeded, cm.MAX_STEPS, status)
        status = torch.where(underflow, cm.STEP_UNDERFLOW, status)
        status = torch.where(stall, cm.NEWTON_STALL, status)
        status = torch.where(exhausted, cm.PARAMS_EXHAUSTED, status)
        status = torch.where(terminate, cm.EVENT_TERMINATED, status)
        active = (active & ~done & ~exceeded & ~underflow & ~stall
                  & ~terminate & ~exhausted)

        t = torch.where(accept, torch.where(terminate, t_ev, t_new), t)
        y = torch.where(accept[:, None],
                        torch.where(terminate[:, None], y_ev, y_new), y)
        h_st = h_next
        k_targ = k_targ_new
        theta = theta_new
        # a fresh step point invalidates the Jacobian; rejects keep it
        calcjac = torch.where(accept, False, calcjac)
        first = torch.where(accept, False, first)
        rejected = torch.where(accept, False, rejected | reject)
        if use_sens:
            yd = torch.where(accept[None, :, None], yd_acc, yd)

    solve_seulex.host_syncs = syncs.count
    return cm.Solution(
        t=t, y=y, status=status, stats=stats,
        ts=t_eval if use_dense else None,
        ys=out_ys if use_dense else None,
        event_t=ev["event_t"] if specs else None,
        event_y=ev["event_y"] if specs else None,
        event_idx=ev["event_idx"] if specs else None,
        sens=yd if use_sens else None,
        quad=(q_acc[:, 0] if quad_scalar else q_acc) if use_quad else None,
        mesh=rings, h_next=h_st)


solve_seulex.host_syncs = 0
