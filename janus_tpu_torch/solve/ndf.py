"""Batched variable-order BDF/NDF (orders 1-5) behind the lockstep loop.

The port of ``janus_tpu/solve/ndf.py``. Quasi-constant-step BDF in
backward-difference form: the history is a difference array D[0..order+2]
per lane; a step-size change h -> factor*h rescales D with the transform
U = R(order, factor) @ R(order, 1) (``_change_D``), applied batched with
per-lane order and factor (lanes outside their order block see the
identity). The NDF modification (Shampine & Reichelt, "The MATLAB ODE
Suite", SIAM J. Sci. Comput. 18(1), 1997; the published kappa constants)
gives larger steps than plain BDF at equal accuracy; ``ndf=False`` is
classical BDF (kappa = 0). After order+1 equal steps each lane picks the
order among k-1, k, k+1 with the largest permissible step factor. The
corrector d = c·f(t+h, y_pred + d) − psi (mass-weighted: M(d + psi)) runs
simplified Newton on factors of (M − c·J), reused across attempts until c
drifts or J is refreshed; a stale-J failure retries with a fresh J.

Control flow against the reference's ``lax.while_loop``/``lax.cond``: one
Python loop whose body is a step attempt for every active lane. Its five
``lax.cond`` gates (the boundary clamp, the Jacobian, the factorization, the
tangent sweep and the end-of-attempt rescale) are kept: the end rescale of
one attempt is applied at the top of the next, where one host read serves
the loop condition and the clamp, rescale, Jacobian and factor gates
together. So a solve factors only where a lane needs it (K1 launches = the
attempts that factor), at one host sync an attempt; the Newton and tangent
loops add one a trip. The syncs of the last solve are in
``solve_bdf.host_syncs``.

Sums over the slots, the transforms' products and the RMS norms add in
sequence (``_sum_seq``), as the reference's small reductions do on the CPU,
so that the two packages round alike.

With ``Options(kernel_lu=True)`` (pivot-free) the corrector matrix is
factored by the CUDA kernel K1 and every Newton and tangent solve goes
through K2 (``ops.smalllu``; their plain twins on CPU tensors).
``Options(stage_solver='gmres'|'tridiag')`` runs the corrector matrix-free
through ``radau.gmres_shifted_solver``.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch.func import jvp

from janus_tpu_torch.linalg.smalllu import lu_factor, lu_ok, lu_solve
from janus_tpu_torch.solve import common as cm
from janus_tpu_torch.solve.events import (handle_events, init_event_state,
                                          normalize_events)
from janus_tpu_torch.solve.options import Options
from janus_tpu_torch.solve.radau import (_gmres_mass_ops, _i32,
                                         _kernel_lu_factor, _kernel_lu_solve,
                                         default_jacobian,
                                         gmres_shifted_solver,
                                         precond_probe_fn,
                                         refuse_kernel_derivatives)
from janus_tpu_torch.solve.radau_fused import _rdiv
from janus_tpu_torch.solve.rodas import mass_dot

MAX_ORDER = 5
_K = MAX_ORDER + 1          # R-matrix size (orders 0..5)
_SLOTS = MAX_ORDER + 3      # difference-array slots D[0..order+2]
NEWTON_MAXITER = 4

# Shampine-Reichelt NDF constants (published; kappa[0]/kappa[5] are 0)
_KAPPA_NDF = np.array([0.0, -0.1850, -1.0 / 9.0, -0.0823, -0.0415, 0.0])


def _bdf_interp_power():
    """Exact power-basis coefficients of the backward-difference
    interpolant's weight polynomials W_j(θ) = Π_{i=0..j} (θ−1+i)/(i+1):
    p(θ) = D[0] + Σ_j W_j(θ)·D[j+1] (j < order) = y_base + Σ_p θ^{p+1}·q_p
    with q_p = Σ_j C[j, p]·D[j+1] and y_base = D[0] + Σ_j W_j(0)·D[j+1]."""
    c = np.zeros((MAX_ORDER, MAX_ORDER))      # [j, power-1]
    base = np.zeros(MAX_ORDER)                # W_j(0)
    poly = np.array([1.0])                    # lowest power first
    for j in range(MAX_ORDER):
        new = np.zeros(poly.size + 1)
        new[1:] += poly
        new[:-1] += (j - 1.0) * poly
        poly = new / (j + 1.0)
        base[j] = poly[0]
        c[j, : poly.size - 1] = poly[1:]
    return c, base


_C_BDF_POW, _W_BDF_AT0 = _bdf_interp_power()


def method_constants(ndf, dtype, device):
    """(alpha [K], error_const [K], gamma_slots [SLOTS]) of the NDF
    (kappa of Shampine & Reichelt) or, with ndf=False, classical BDF."""
    kappa = _KAPPA_NDF if ndf else np.zeros(_K)
    gamma = np.hstack([0.0, np.cumsum(1.0 / np.arange(1, _K))])

    def as_t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return (as_t((1.0 - kappa) * gamma),
            as_t(kappa * gamma + 1.0 / np.arange(1, _K + 1)),
            as_t(np.hstack([gamma, np.zeros(_SLOTS - _K)])))


def _sum_seq(x, dim):
    """Sum over a small static axis, adding in index order (the order the
    reference's reductions round in on the CPU; torch's own sum does not
    add in sequence)."""
    parts = x.unbind(dim)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def _rms(v):
    """sqrt(mean(v², -1)) with the mean as the reference rounds it: the
    sequential sum times 1/D."""
    return cm.safe_sqrt(_sum_seq(torch.square(v), -1) * (1.0 / v.shape[-1]))


def _pick(vec, idx):
    """vec[idx] for a small constant vector and per-lane idx."""
    return vec[idx.to(torch.int64)]


def _pick_slot(D, k):
    """D[:, k, :] with per-lane slot index k."""
    index = k.to(torch.int64)[:, None, None].expand(-1, 1, D.shape[-1])
    return D.gather(1, index)[:, 0]


def _r_matrix(order, factor):
    """Batched identity-extended R(order, factor): [M, K, K].

    R[i, j] = prod_{m=1..i} (m-1-factor*j)/m for 1<=i,j<=order, R[0,:]=1,
    R[i>=1, 0]=0; entries outside the (order+1)-block are the identity."""
    dtype, dev = factor.dtype, factor.device
    ii = torch.arange(_K, device=dev)[:, None]
    jj = torch.arange(_K, device=dev)[None, :]
    fi, fj = ii.to(dtype), jj.to(dtype)
    body = (fi - 1.0 - factor[:, None, None] * fj) \
        / torch.where(ii == 0, 1, ii).to(dtype)
    mfull = torch.where((ii >= 1) & (jj >= 1), body,
                        torch.where(ii == 0, 1.0, 0.0).to(dtype))
    r = torch.cumprod(mfull, dim=-2)
    valid = (ii[None] <= order[:, None, None]) \
        & (jj[None] <= order[:, None, None])
    return torch.where(valid, r, torch.eye(_K, dtype=dtype, device=dev))


def _matmul_seq(a, b):
    """a @ b for batched small squares [M, K, K], each entry summed in
    index order."""
    return _sum_seq(a[:, :, :, None] * b[:, None, :, :], 2)


def _ru_matrix(order, factor):
    """The combined rescale transform U = R(order, factor) @ R(order, 1):
    D slots 0.._K-1 map as D <- U.T @ D. Exposed so that the adjoint's
    recording can compose the transforms it applies."""
    return _matmul_seq(_r_matrix(order, factor),
                       _r_matrix(order, torch.ones_like(factor)))


def _apply_ru(ru, D):
    """D <- U.T @ D on the first _K slots (slots _K.. untouched)."""
    d6 = _sum_seq(ru[:, :, :, None] * D[:, :_K, None, :], 1)
    return torch.cat([d6, D[:, _K:]], dim=1)


def _change_D(D, order, factor):
    """Rescale the difference array for a per-lane change h -> factor*h;
    factor=1 lanes are exact no-ops (R(order,1) is an involution)."""
    return _apply_ru(_ru_matrix(order, factor), D)


def _compose_ru(pmat, ru):
    """pmat <- pmat @ ru: appends a transform in APPLY order (after V1 then
    V2 the total is (V1 @ V2).T @ D, the newest factor on the right)."""
    return _matmul_seq(pmat, ru)


def _hist_update(Dp, d_fin, order):
    """The accepted-step difference update: d into slot order+1, d −
    D'[order+1] into slot order+2, then the suffix sums of slots <=
    order+1. Linear in (Dp, d_fin); the forward solve and the adjoint's
    replay share it. Each suffix sum adds from its own slot upwards, in the
    reference's order."""
    slot = torch.arange(_SLOTS, device=Dp.device)[None, :]
    oh1 = (slot == (order[:, None] + 1))[..., None]
    oh2 = (slot == (order[:, None] + 2))[..., None]
    d_old = _pick_slot(Dp, order + 1)
    Dw = torch.where(oh1, d_fin[:, None, :], Dp)
    Dw = torch.where(oh2, (d_fin - d_old)[:, None, :], Dw)
    le1 = (slot <= (order[:, None] + 1))[..., None]
    x = torch.where(le1, Dw, 0.0)
    suff = x
    for r in range(1, _SLOTS):
        suff = torch.cat([suff[:, :_SLOTS - r] + x[:, r:],
                          suff[:, _SLOTS - r:]], dim=1)
    return torch.where(le1, suff, Dw)


def _predict(Dp, order, gamma_slots, alpha):
    """(y_pred, psi, alpha(order)) from the prediction basis D'."""
    slot = torch.arange(_SLOTS, device=Dp.device)[None, :]
    le = slot <= order[:, None]
    y_pred = _sum_seq(torch.where(le[..., None], Dp, 0.0), 1)
    gamma_w = torch.where((slot >= 1) & le, gamma_slots[None, :], 0.0)
    alpha_ord = _pick(alpha, order)
    psi = _sum_seq(gamma_w[:, :, None] * Dp, 1) / alpha_ord[:, None]
    return y_pred, psi, alpha_ord


def _bdf_interp(Dh, t, h, order):
    """The step's backward-difference interpolant from the post-accept
    history Dh [M, SLOTS, D]: θ [M, T] -> y [M, T, D] on (t, t + h], linear
    in Dh (the forward's dense output, events and quadrature, and the
    adjoint's replay of them)."""
    dtype = t.dtype
    t_new = t + h
    iidx = torch.arange(MAX_ORDER, dtype=dtype, device=t.device)
    kmask = torch.arange(MAX_ORDER, device=t.device)[None, :] \
        < order[:, None]

    def interp(theta):
        tq = t[:, None] + theta * h[:, None]
        x = ((tq[..., None] - (t_new[:, None, None]
                               - iidx * h[:, None, None]))
             / ((iidx + 1.0) * h[:, None, None]))
        w = torch.where(kmask[:, None, :], torch.cumprod(x, dim=-1), 0.0)
        return Dh[:, 0][:, None, :] + _sum_seq(
            w[:, :, :, None] * Dh[:, None, 1:_K], 2)

    return interp


def solve_bdf(f: Callable, t0, tf, y0, args=None,
              options: Optional[Options] = None, t_eval=None,
              jac: Optional[Callable] = None, events=None, mass=None,
              ndf: bool = True, tangents=None, args_tangents=None,
              quad: Optional[Callable] = None, dense: int = 0,
              _mesh_size: int = 0, _h0=None, device=None) -> cm.Solution:
    """Batched adaptive variable-order BDF/NDF solve (orders 1-5).

    f(t [M], y [M, D], args) -> [M, D]; y0 [M, D]. A torch y0 solves on its
    own device; any other y0 goes to ``device``, by default the CUDA card.

    t_eval: shared output grid [T]; ``Solution.ys`` [M, T, D] from the
    backward-difference interpolant. events: ``solve.events.Event`` spec(s)
    located on the same interpolant. quad: running-cost integrand
    ``l(t [M], y [M, D], args) -> [M]`` or [M, Q]; ``Solution.quad`` by
    3-point Gauss-Legendre on each accepted step's interpolant, truncated at
    t* on event-terminated lanes. dense: step-mesh capacity N > 0 storing
    each accepted step's polynomial in the power basis (its θ = 0 value plus
    five powers) for ``Solution.interpolate(ts)``.

    tangents [K, M, D] / args_tangents (args' tree with a leading K axis):
    forward sensitivities by internal differentiation, terminal mode only.
    The K tangent difference arrays ride as extra columns of D (every
    history operation is linear in D); per accepted step the corrector
    tangent (M − c·J(t_new, y_new))·δd = c·(J·δy_pred + f_θ·dθ) − M·δψ is
    solved by a Richardson iteration on the step's own factors (at most 8
    trips, converging relative to 1 + |δy|). ``Solution.sens`` [K, M, D].

    mass: [D, D] or [M, D, D], singular index-1 included: the startup is
    one linearized backward-Euler increment (M − h·J0)⁻¹·h·f0, factored
    with partial pivoting whatever ``Options.pivoting`` says.

    ``_mesh_size`` records per accepted step (t, h, order, the converged
    corrector increment d, the post-clamp difference array D' and the
    composed inter-step transform T) for ``solve.adjoint_ndf``; ``_h0`` is
    a per-lane warm-start step (0 = automatic).
    """
    opts = options if options is not None else Options()
    specs = normalize_events(events)
    t0, tf, y0 = cm.broadcast_batch(t0, tf, y0, device)
    m, dim = y0.shape
    dtype, dev = y0.dtype, y0.device
    syncs = cm._HostSyncs()

    use_quad = quad is not None
    if use_quad:
        qshape = tuple(quad(t0, y0, args).shape)
        if len(qshape) not in (1, 2) or qshape[0] != m:
            raise ValueError(f"quad must return [M] or [M, Q] with M={m}, "
                             f"got {qshape}")
        quad_scalar = len(qshape) == 1

        def ql(tt, yy):                          # canon [M, Q]
            return cm.canon_cost(quad(tt, yy, args))

        q_acc = y0.new_zeros((m, 1 if quad_scalar else qshape[1]))

    store_q = bool(dense)
    if store_q and _mesh_size:
        raise ValueError("dense= does not combine with the adjoint's "
                         "internal mesh recording (_mesh_size)")
    use_sens = tangents is not None or args_tangents is not None
    if use_sens and (use_quad or store_q):
        raise ValueError("solve_bdf(tangents=) is terminal-mode only; "
                         "quad=/dense= with tangents raise")
    if use_sens and (t_eval is not None or events is not None):
        raise ValueError("solve_bdf(tangents=) is terminal-mode only "
                         "(no tangent dense output/event correction); "
                         "use torch.func.jvp through the solve for those")
    if opts.stage_solver not in ("lu", "gmres", "tridiag"):
        raise ValueError(f"unknown stage_solver {opts.stage_solver!r}")
    use_gmres = opts.stage_solver != "lu"
    if opts.kernel_lu and opts.pivoting:
        raise ValueError("Options(kernel_lu=True) needs pivoting=False "
                         "(the SoA kernels are pivot-free)")
    if use_gmres and jac is not None:
        raise ValueError("stage_solver='gmres' is matrix-free (J·v by jvp, "
                         "probed structure preconditioner); drop jac=")
    use_kernel = opts.kernel_lu and not use_gmres
    refuse_kernel_derivatives(use_kernel, "solve_bdf", y0, t0, tf, args,
                              tangents, args_tangents, mass)
    gmres_iters = 0 if opts.stage_solver == "tridiag" else opts.gmres_iters

    k_dirs = 0
    if use_sens:
        args_d = None
        if args_tangents is not None:
            # the joint jvp in (y, args) needs tensor leaves
            args_d = cm.tree_map(lambda a: cm.like(a, y0), args_tangents)
            args = cm.tree_map(lambda a: cm.like(a, y0), args)
            k_args = cm.tree_leaves(args_d)[0].shape[0]
        if tangents is not None:
            yd0 = cm.like(tangents, y0)
            if yd0.ndim != 3 or tuple(yd0.shape[1:]) != (m, dim):
                raise ValueError(f"tangents must be [K, {m}, {dim}], got "
                                 f"{tuple(yd0.shape)}")
            if args_d is not None and k_args != yd0.shape[0]:
                raise ValueError(f"tangents K={yd0.shape[0]} != "
                                 f"args_tangents K={k_args}")
        else:
            yd0 = y0.new_zeros((k_args, m, dim))
        k_dirs = yd0.shape[0]
        args_rows = [None] * k_dirs if args_d is None else \
            [cm.tree_map(lambda a, _k=k: a[_k], args_d) for k in range(k_dirs)]

        def pack(rows):              # [K, M, D] -> [M, K·D]
            return rows.movedim(0, 1).reshape(m, k_dirs * dim)

        def unpack(cols):            # [M, K·D] -> [K, M, D]
            return cols.reshape(m, k_dirs, dim).movedim(1, 0)

        def jvp_rows(t_at, y_at, dys):
            """[K, M, D]: J·δy_k (+ f_θ·dθ_k) at (t_at, y_at)."""
            return torch.stack([
                jvp(lambda yy: f(t_at, yy, args), (y_at,), (dys[k],))[1]
                if args_rows[k] is None else
                jvp(lambda yy, aa: f(t_at, yy, aa), (y_at, args),
                    (dys[k], args_rows[k]))[1]
                for k in range(k_dirs)])

    if use_gmres:
        jac_fn = precond_probe_fn(f, opts.precond, opts.precond_block, dim)
    else:
        jac_fn = jac if jac is not None else default_jacobian(f)
    if mass is not None:
        mass = cm.like(mass, y0)
        if tuple(mass.shape) not in ((dim, dim), (m, dim, dim)):
            raise ValueError(f"mass must be [{dim}, {dim}] or [{m}, {dim}, "
                             f"{dim}], got {tuple(mass.shape)}")
        mdotv = _gmres_mass_ops(mass, m, dim, y0)[0] if use_gmres \
            else mass_dot(mass)
        mass_b = mass.expand(m, dim, dim)
    else:
        def mdotv(v):
            return v

    def mdot_k(v):                   # [K, M, D]
        return torch.stack([mdotv(v[k]) for k in range(v.shape[0])])

    alpha, error_const, gamma_slots = method_constants(ndf, dtype, dev)
    newton_tol = (opts.newton_tol if opts.newton_tol > 0
                  else cm.derived_newton_tol(dtype, opts.rtol))

    f0 = f(t0, y0, args)
    direction = torch.where(tf >= t0, 1.0, -1.0).to(dtype)
    h_small = torch.clamp(torch.abs(tf - t0) * 1e-2, max=1e-3)
    if _h0 is not None:
        # per-lane warm start (segment chaining, solve.adjoint_ndf): lanes
        # with _h0 == 0 take the automatic initial step
        h_mag = torch.abs(cm.like(_h0, y0).broadcast_to((m,)))
        h_auto = torch.abs(cm.initial_step(
            f, t0, y0, f0, tf, 1, opts.rtol, opts.atol, args,
            opts.max_step)) if mass is None else h_small
        h_mag = torch.where(h_mag > 0, h_mag, h_auto)
        h_st = torch.minimum(h_mag, torch.abs(tf - t0)) * direction
    elif opts.h0 == 0.0:
        # hinit's Euler probe treats f as the derivative, which is wrong
        # under a mass matrix: start small there and let the controller grow
        h_st = cm.initial_step(f, t0, y0, f0, tf, 1, opts.rtol, opts.atol,
                               args, opts.max_step) if mass is None \
            else h_small * direction
    else:
        h_st = torch.full((m,), opts.h0, dtype=dtype, device=dev) * direction

    if mass is not None:
        # difference-array startup: one LINEARIZED backward-Euler increment
        # D[1] = (M − h·J0)⁻¹·(h·f0), finite and consistent for singular
        # index-1 masses too; pivoted whatever Options says
        j0 = jac_fn(t0, y0, args)
        if use_gmres:
            solve1 = gmres_shifted_solver(
                f, t0, y0, args, j0, torch.ones_like(h_st), h_st, mass,
                gmres_iters, precond=opts.precond,
                block=opts.precond_block)[0]
        else:
            lu0, piv0 = lu_factor(mass_b - h_st[:, None, None] * j0,
                                  pivot=True)

            def solve1(b):
                return lu_solve(lu0, piv0, b)
        d1 = solve1(h_st[:, None] * f0)
    else:
        d1 = h_st[:, None] * f0

        def solve1(b):
            return b

    # the K tangent histories ride as extra columns of D
    dimw = dim * (1 + k_dirs)
    D = y0.new_zeros((m, _SLOTS, dimw))
    if use_sens:
        # startup tangent δD[1] = (M − h·J0)⁻¹·h·(J0·δy0 + f_θ·dθ) (the
        # ∂J0/∂y0 term dropped, as the startup's own O(h²) order)
        d1t = torch.stack([solve1(x) for x in
                           h_st[None, :, None] * jvp_rows(t0, y0, yd0)])
        D[:, 0] = torch.cat([y0, pack(yd0)], dim=-1)
        D[:, 1] = torch.cat([d1, pack(d1t)], dim=-1)
    else:
        D[:, 0] = y0
        D[:, 1] = d1

    use_dense = t_eval is not None
    if use_dense:
        t_eval = cm.like(t_eval, y0)
        at_t0 = t_eval[None, :] == t0[:, None]
        out_ys = torch.where(at_t0[..., None], y0[:, None, :], torch.nan)

    stats = cm.zero_stats(m, ("nfev", "njev", "nlu", "nsteps", "naccept",
                              "nreject", "nnewton", "order"), dev)
    stats["nfev"] = stats["nfev"] + 2
    stats["order"] = stats["order"] + 1

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    eye_k = torch.eye(_K, dtype=dtype, device=dev)
    rings = None
    if _mesh_size:
        rings = {"t": zeros(m, _mesh_size), "h": zeros(m, _mesh_size),
                 "k": zeros(m, _mesh_size, dt=torch.int32),
                 "d": zeros(m, _mesh_size, dim),
                 "D": zeros(m, _mesh_size, _SLOTS, dim),
                 "T": zeros(m, _mesh_size, _K, _K)}
        pmat = eye_k.expand(m, _K, _K)
        h_start = h_st
    elif store_q:
        rings = {"t": zeros(m, dense), "h": zeros(m, dense),
                 "y": zeros(m, dense, dim),
                 "q": zeros(m, dense, MAX_ORDER, dim)}
        c_pow = torch.as_tensor(_C_BDF_POW, dtype=dtype, device=dev)
        w_at0 = torch.as_tensor(_W_BDF_AT0, dtype=dtype, device=dev)

    t, y = t0, y0
    order = torch.ones((m,), dtype=torch.int64, device=dev)
    neq = zeros(m, dt=torch.int64)
    if use_gmres:
        pb = opts.precond_block
        jmat = zeros(m, dim // pb, pb, pb) if opts.precond == "block" \
            else zeros(m, 3, dim)
    else:
        jmat = zeros(m, dim, dim)
        lu_m, piv_m = zeros(m, dim, dim), zeros(m, dim, dt=torch.int32)
    c_fact = zeros(m)
    current_jac = zeros(m, dt=torch.bool)
    need_jac = torch.ones((m,), dtype=torch.bool, device=dev)
    nsing = zeros(m, dt=torch.int32)
    already_done = t0 == tf
    active = ~already_done
    status = torch.where(already_done, cm.SUCCESS, cm.RUNNING).to(torch.int8)
    ev = init_event_state(specs, m, dim, t0, y0, args)
    eps = torch.finfo(dtype).eps
    # the Newton divergence test's exponents NEWTON_MAXITER − k, as tensors
    # (torch.pow by a number rounds otherwise for 2 and 3)
    lefts = torch.arange(NEWTON_MAXITER, 0, -1, dtype=dtype, device=dev)
    # the end-of-attempt rescale, applied at the top of the next attempt
    rescale = zeros(m, dt=torch.bool)
    factor_all = torch.ones((m,), dtype=dtype, device=dev)

    while True:
        # ---- the masks of this attempt's gates, read in one host sync ----
        remaining = tf - t
        last = torch.abs(h_st) >= torch.abs(remaining)
        h = torch.where(last, remaining, h_st)
        h = torch.where(h == 0.0, eps, h)
        # compare h values: the clamp changed this lane's step
        clamped = active & (h != h_st)
        alpha_ord = _pick(alpha, order)
        c = h / alpha_ord
        needj = need_jac & active
        needf = active & (needj | (c != c_fact))
        go, any_resc, any_clamp, any_j, any_f = syncs.any_each(
            active, rescale, clamped, needj, needf)
        if not go:
            break

        # ---- the last attempt's rescale, then the boundary clamp ---------
        if any_resc:
            ru = _ru_matrix(order, factor_all)
            D = torch.where(rescale[:, None, None], _apply_ru(ru, D), D)
            if _mesh_size:
                pmat = torch.where(rescale[:, None, None],
                                   _compose_ru(pmat, ru), pmat)
        if any_clamp:
            fac0 = torch.where(clamped, h / h_st, 1.0)
            ru = _ru_matrix(order, fac0)
            D = torch.where(clamped[:, None, None], _apply_ru(ru, D), D)
            if _mesh_size:
                pmat = torch.where(clamped[:, None, None],
                                   _compose_ru(pmat, ru), pmat)
        neq = torch.where(clamped, 0, neq)

        # ---- prediction from the difference array ------------------------
        y_pred_full, psi_full, _ = _predict(D, order, gamma_slots, alpha)
        y_pred, psi = y_pred_full[:, :dim], psi_full[:, :dim]
        if use_sens:
            ypd = unpack(y_pred_full[:, dim:])     # [K, M, D] δy_pred
            psid = unpack(psi_full[:, dim:])       # [K, M, D] δψ
        t_new = t + h
        scale_n = opts.atol + opts.rtol * torch.abs(y_pred)

        # ---- Jacobian refresh (gated) ------------------------------------
        if any_j:
            jn = jac_fn(t_new, y_pred, args)
            jmat = torch.where(needj.reshape((m,) + (1,) * (jn.ndim - 1)),
                               jn, jmat)
        current_jac = current_jac | needj

        # ---- the corrector's solver: factors of (M − c·J) (gated), or the
        # matrix-free closures rebuilt at the predictor -------------------
        if use_gmres:
            fact_ok = torch.isfinite(jmat).flatten(1).all(dim=1)
            c_fact = torch.where(needf, c, c_fact)
            solve_corr = gmres_shifted_solver(
                f, t_new, y_pred, args, jmat, torch.ones_like(c), c, mass,
                gmres_iters, precond=opts.precond,
                block=opts.precond_block)[0]
        else:
            fact_ok = torch.ones((m,), dtype=torch.bool, device=dev)
            if any_f:
                mb = mass_b if mass is not None else \
                    torch.eye(dim, dtype=dtype, device=dev)[None]
                amat = mb - c[:, None, None] * jmat
                if use_kernel:
                    lu_n, piv_n = _kernel_lu_factor(amat)
                else:
                    lu_n, piv_n = lu_factor(amat, pivot=opts.pivoting)
                lu_m = torch.where(needf[:, None, None], lu_n, lu_m)
                piv_m = torch.where(needf[:, None], piv_n, piv_m)
                fact_ok = torch.where(needf, lu_ok(lu_n), True)
                c_fact = torch.where(needf, c, c_fact)
            if use_kernel:
                def solve_corr(r, _lu=lu_m):
                    return _kernel_lu_solve(_lu, r)
            else:
                def solve_corr(r, _lu=lu_m, _piv=piv_m):
                    return lu_solve(_lu, _piv, r, pivot=opts.pivoting)
        singular = active & ~fact_ok

        # ---- simplified Newton on M(d + psi) = c f(t+h, y_pred + d) ------
        run_newton = active & fact_ok
        d_fin, y_new = zeros(m, dim), y_pred
        dn_old, nrate = zeros(m), zeros(m)
        running = run_newton
        convd = zeros(m, dt=torch.bool)
        niter = zeros(m, dt=torch.int32)
        nfev_n = zeros(m, dt=torch.int32)
        k = 0
        while syncs.any(running):
            fk = f(t_new, y_new, args)
            res = c[:, None] * fk - mdotv(psi + d_fin)
            dy = solve_corr(res)
            finite = torch.isfinite(dy).all(dim=-1)
            dn = _rms(dy / scale_n)
            have = k > 0
            rt = torch.where((dn_old > 0) & have,
                             dn / torch.where(dn_old == 0, 1.0, dn_old), 0.0)
            srt = torch.clamp(rt, 1e-16, 1.0 - 1e-16)
            div = have & ((rt >= 1.0) | (torch.pow(srt, lefts[k]) / (1 - srt)
                                         * dn > newton_tol))
            failn = running & (~finite | div)
            app = running & ~failn
            d_fin = torch.where(app[:, None], d_fin + dy, d_fin)
            y_new = torch.where(app[:, None], y_new + dy, y_new)
            cnow = app & ((dn == 0.0)
                          | (have & (rt < 1.0)
                             & (srt / (1 - srt) * dn < newton_tol)))
            dn_old = torch.where(app, dn, dn_old)
            nrate = torch.where(running, rt, nrate)
            convd = convd | cnow
            niter = torch.where(running, k + 1, niter)
            nfev_n = nfev_n + _i32(running)
            running = running & ~failn & ~cnow & (k + 1 < NEWTON_MAXITER)
            k += 1

        conv = run_newton & convd
        newton_fail = run_newton & ~convd
        nf_stale = newton_fail & ~current_jac
        nf_fresh = (newton_fail & current_jac) | singular

        # ---- error estimate at the current order -------------------------
        ordf = order.to(dtype)
        scale_e = opts.atol + opts.rtol * torch.abs(y_new)
        enorm = _rms(_pick(error_const, order)[:, None] * d_fin / scale_e)
        enorm = torch.where(torch.isfinite(enorm), enorm, 1e10)
        enorm = torch.clamp(enorm, min=1e-16)
        accept = conv & (enorm <= 1.0)
        reject_err = conv & (enorm > 1.0)

        niter_f = torch.clamp(niter, min=1).to(dtype)
        safety = _rdiv(opts.safety * (2 * NEWTON_MAXITER + 1),
                       2 * NEWTON_MAXITER + niter_f)
        fac_rej = torch.clamp(
            safety * torch.pow(enorm, _rdiv(-1.0, ordf + 1.0)),
            min=opts.min_factor)

        # ---- corrector tangents (IND): Richardson on the step's factors;
        # the first any() of the loop is the reference's gate on accept ---
        nfev_t = 0
        if use_sens:
            dd = zeros(k_dirs, m, dim)
            go_t = accept[None, :].expand(k_dirs, m)
            it = 0
            while syncs.any(go_t):
                # b − A·δd = c·[J·(δy_pred+δd) + f_θ·dθ] − M·(δψ+δd)
                resid = (c[None, :, None] * jvp_rows(t_new, y_new, ypd + dd)
                         - mdot_k(psid + dd))
                inc = torch.stack([solve_corr(x) for x in resid]) \
                    if use_kernel or use_gmres else \
                    solve_corr(resid.permute(1, 2, 0)).permute(2, 0, 1)
                upd = go_t & torch.isfinite(inc).all(dim=-1)
                dd = torch.where(upd[..., None], dd + inc, dd)
                # converge RELATIVE to the tangent's magnitude
                dn_t = _rms(inc / (1.0 + torch.abs(ypd + dd)))
                go_t = upd & (dn_t > newton_tol) & (it + 1 < 2 * NEWTON_MAXITER)
                it += 1
                nfev_t += k_dirs
            d_cat = torch.cat([d_fin, pack(dd)], dim=-1)
        else:
            d_cat = d_fin

        # ---- history update on accept (suffix sums over D slots) ---------
        D_hist = _hist_update(D, d_cat, order)
        D_acc = torch.where(accept[:, None, None], D_hist, D)
        neq_acc = torch.where(accept, neq + 1, neq)

        if _mesh_size:
            # the accepted step: its prediction basis D' (post-clamp), the
            # converged increment, the controls and the transform composed
            # since the last accept (the end rescale below is the first
            # factor of the next one); by select, never a multiplication by
            # the mask: a failed lane's NaN d must not reach a slot
            cm.ring_write(rings, stats["naccept"], accept,
                          {"t": t, "h": h, "k": order.to(torch.int32),
                           "d": d_fin, "D": D[..., :dim], "T": pmat})
            pmat = torch.where(accept[:, None, None], eye_k, pmat)

        # ---- order adaptation after order+1 equal steps ------------------
        adapt = accept & (neq_acc >= order + 1)
        en_m = _rms(_pick(error_const, order - 1)[:, None]
                    * _pick_slot(D_acc, order)[..., :dim] / scale_e)
        en_p = _rms(_pick(error_const, torch.clamp(order + 1,
                                                   max=MAX_ORDER))[:, None]
                    * _pick_slot(D_acc, order + 2)[..., :dim] / scale_e)
        en_m = torch.clamp(torch.where(torch.isfinite(en_m), en_m, 1e10),
                           min=1e-16)
        en_p = torch.clamp(torch.where(torch.isfinite(en_p), en_p, 1e10),
                           min=1e-16)
        fac_same = torch.pow(enorm, _rdiv(-1.0, ordf + 1.0))
        fac_m = torch.where(order > 1, torch.pow(en_m, _rdiv(-1.0, ordf)),
                            0.0)
        fac_p = torch.where(order < MAX_ORDER,
                            torch.pow(en_p, _rdiv(-1.0, ordf + 2.0)), 0.0)
        # argmax over orders k−1, k, k+1, the first of a tie winning
        facs = torch.stack([fac_m, fac_same, fac_p], dim=-1)
        best = torch.argmax(facs, dim=-1)
        order_new = torch.where(adapt, torch.clamp(order + best - 1, 1,
                                                   MAX_ORDER), order)
        fac_best = facs.gather(-1, best[:, None])[:, 0]
        fac_adapt = torch.clamp(safety * fac_best, max=opts.max_factor)

        # ---- one combined rescale for adapt/reject/newton-fail lanes -----
        factor_all = torch.where(adapt, fac_adapt,
                                 torch.where(reject_err, fac_rej,
                                             torch.where(nf_fresh, 0.5, 1.0)))
        factor_all = torch.where(active, factor_all, 1.0)
        # max_step before rescaling D, as a finite cap (inf/|h| would give
        # an inf tangent under forward mode through the solve)
        cap = _rdiv(opts.max_step, torch.abs(h))
        cap = torch.where(torch.isfinite(cap), cap, torch.finfo(dtype).max)
        factor_all = torch.minimum(factor_all, cap)
        rescale = factor_all != 1.0
        neq_final = torch.where(rescale, 0, neq_acc)
        h_next = torch.where(active, h * factor_all, h_st)

        # ---- dense output, events, quadrature (the BDF interpolant) ------
        interp = None
        if use_dense or specs or use_quad or store_q:
            interp = _bdf_interp(D_hist[..., :dim], t, h, order)
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
        if store_q:
            # the polynomial in the shared power basis: its own θ = 0 value
            # plus five powers, by the exact constant map _C_BDF_POW
            kmask = (torch.arange(MAX_ORDER, device=dev)[None, :]
                     < order[:, None])[..., None]
            dmat = torch.where(kmask, D_hist[:, 1:_K, :dim], 0.0)
            qrows = _sum_seq(dmat[:, :, None, :] * c_pow[None, :, :, None],
                             1)
            y_base = D_hist[:, 0, :dim] + _sum_seq(
                dmat * w_at0[None, :, None], 1)
            cm.ring_write(rings, stats["naccept"], accept,
                          {"t": t, "h": h, "y": y_base, "q": qrows})

        # ---- bookkeeping --------------------------------------------------
        done = accept & last
        recompute_jac = accept & (niter > 2) & (nrate > opts.jac_recompute)

        stats["nfev"] = stats["nfev"] + nfev_n + nfev_t
        stats["njev"] = stats["njev"] + _i32(needj)
        stats["nlu"] = stats["nlu"] + _i32(needf)
        stats["nsteps"] = stats["nsteps"] + _i32(run_newton | singular)
        stats["naccept"] = stats["naccept"] + _i32(accept)
        stats["nreject"] = stats["nreject"] + _i32(reject_err | newton_fail
                                                   | singular)
        stats["nnewton"] = stats["nnewton"] + niter
        stats["order"] = torch.where(active, order_new.to(torch.int32),
                                     stats["order"])

        nsing = torch.where(singular | newton_fail, nsing + 1,
                            torch.where(accept, 0, nsing))
        stall = active & (nsing >= 7)
        exceeded = active & (stats["nsteps"] >= opts.max_steps) & ~done
        # Hairer's t-relative underflow test (0.1|h| <= eps|t|)
        underflow = active & (0.1 * torch.abs(h_next)
                              <= eps * torch.abs(t_new)) & ~done

        status = torch.where(done, cm.SUCCESS, status)
        status = torch.where(exceeded, cm.MAX_STEPS, status)
        status = torch.where(underflow, cm.STEP_UNDERFLOW, status)
        status = torch.where(stall, cm.NEWTON_STALL, status)
        status = torch.where(terminate, cm.EVENT_TERMINATED, status)
        active = active & ~done & ~exceeded & ~underflow & ~stall & ~terminate

        t = torch.where(accept, torch.where(terminate, t_ev, t_new), t)
        y = torch.where(accept[:, None],
                        torch.where(terminate[:, None], y_ev, y_new), y)
        h_st = h_next
        order = order_new
        neq = neq_final
        D = D_acc
        current_jac = torch.where(accept, False, current_jac)
        need_jac = torch.where(accept, recompute_jac,
                               torch.where(nf_stale, True,
                                           torch.where(needj, False,
                                                       need_jac)))

    solve_bdf.host_syncs = syncs.count
    mesh = rings
    if _mesh_size:
        mesh = dict(rings, h0=h_start)
    return cm.Solution(
        t=t, y=y, status=status, stats=stats,
        ts=t_eval if use_dense else None,
        ys=out_ys if use_dense else None,
        event_t=ev["event_t"] if specs else None,
        event_y=ev["event_y"] if specs else None,
        event_idx=ev["event_idx"] if specs else None,
        # slot 0 of the difference array IS the state (every R transform
        # and the suffix-sum update leave it equal to y), so its tangent
        # columns are the sensitivities
        sens=unpack(D[:, 0, dim:]) if use_sens else None,
        mesh=mesh,
        quad=(q_acc[:, 0] if quad_scalar else q_acc) if use_quad else None,
        h_next=h_st)


solve_bdf.host_syncs = 0
