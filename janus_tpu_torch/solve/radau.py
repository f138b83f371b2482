"""Batched lockstep Radau IIA with simplified Newton — the flagship stiff path.

The port of ``janus_tpu/solve/radau.py``, fixed-stage dense-LU path: one
Python loop whose body is a single step ATTEMPT for every active trajectory.
Per-trajectory h, Newton convergence, accept/reject, Jacobian reuse and
factorization reuse are [M] boolean lanes combined with ``torch.where``.

Control flow against the reference's ``lax.while_loop``/``lax.cond``:
- the outer loop and the Newton loop stop when no lane is running; each such
  check is one host sync (counted per solve in ``solve_radau.host_syncs``);
- the reference's ``lax.cond`` gates (Jacobian, factorization, refined error
  estimate, new f, tangent sweep) only skip work whose results are selected
  per lane with ``where``; the port always does the work and selects, which
  changes no number and costs no sync;
- the IND tangent loop keeps its data-dependent stop: one flag over all lanes
  per trip, as in the reference.

Stage solves: one real D×D and (s−1)/2 split-real complex 2D×2D systems per
iteration with factors REUSED across iterations. With
``Options(kernel_lu=True)`` the factor and every solve go through the CUDA
kernels K1/K2 of ``janus_tpu_torch.ops.smalllu`` (their twins on CPU
tensors); otherwise through the plain torch LU of ``linalg.smalllu``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.func import jvp

from janus_tpu_torch.linalg.smalllu import lu_factor, lu_ok, lu_solve
from janus_tpu_torch.ops.smalllu import lu_factor_t, lu_solve_t
from janus_tpu_torch.solve import common as cm
from janus_tpu_torch.solve.options import Options
from janus_tpu_torch.solve.radau_tables import radau_tableau


class _HostSyncs:
    """Counts the host syncs of one solve (each ``bool(t.any())`` is one)."""

    def __init__(self):
        self.count = 0

    def any(self, mask) -> bool:
        self.count += 1
        return bool(mask.any())


def _ipow(x, n: int):
    """x**n for a static int n > 0 by the same square-and-multiply sequence
    as the reference's integer powers (so both round alike)."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def _i32(mask):
    return mask.to(torch.int32)


def _consts(tab, dtype, device):
    def as_t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)
    return as_t(tab.t_mat), as_t(tab.ti_mat), as_t(tab.c)


def default_jacobian(f: Callable) -> Callable:
    """Batched ∂f/∂y via D forward-mode JVP columns of the BATCHED rhs."""

    def jac(t, y, args):
        cols = []
        for j in range(y.shape[-1]):
            tang = torch.zeros_like(y)
            tang[..., j] = 1.0
            cols.append(jvp(lambda yy: f(t, yy, args), (y,), (tang,))[1])
        return torch.stack(cols, dim=-1)  # [M, D, D]

    return jac


def _build_iter_matrices(tab, h, jac):
    """(a_real [M,D,D], blocks list of [M,2D,2D]): the real and split-real
    complex stage iteration matrices γ_q/h·I − J."""
    eye = torch.eye(jac.shape[-1], dtype=jac.dtype, device=jac.device)
    a_real = (float(tab.mu_real) / h)[..., None, None] * eye - jac
    blocks = []
    for p in range((tab.s - 1) // 2):
        mu = tab.mu_complex[p]
        mur, mui = float(mu.real), float(mu.imag)
        ar = (mur / h)[..., None, None] * eye - jac
        ai = (mui / h)[..., None, None] * eye            # Im(mu) < 0
        top = torch.cat([ar, -ai], dim=-1)
        bot = torch.cat([ai, ar], dim=-1)
        blocks.append(torch.cat([top, bot], dim=-2))
    return a_real, blocks


def _kernel_lu_factor(a, pivot=False):
    """K1 on [..., D, D] (Options.kernel_lu): the AoS↔SoA transposes at the
    call boundary, pivots the identity."""
    batch = a.shape[:-2]
    d = a.shape[-1]
    m = a[..., 0, 0].numel()
    lu = lu_factor_t(a.reshape(m, d * d).T.contiguous())
    lu = lu.T.reshape(*batch, d, d)
    piv = torch.arange(d, dtype=torch.int32, device=a.device).expand(*batch, d)
    return lu, piv


def _kernel_lu_solve(lu, b):
    """K2 with K1-packed factors; b [..., D] (vector rhs)."""
    batch = lu.shape[:-2]
    d = lu.shape[-1]
    m = b[..., 0].numel()
    x = lu_solve_t(lu.reshape(m, d * d).T.contiguous(),
                   b.reshape(m, d).T.contiguous())
    return x.T.reshape(*batch, d)


def _factorize(tab, h, jac, pivot=True, factor=None):
    """Build and factor the real and split-complex iteration matrices."""
    dim = jac.shape[-1]
    factor = lu_factor if factor is None else factor
    a_real, blocks = _build_iter_matrices(tab, h, jac)
    lu_r, piv_r = factor(a_real, pivot=pivot)
    ok = lu_ok(lu_r)
    lus, pivs = [], []
    for block in blocks:
        lu_c, piv_c = factor(block, pivot=pivot)
        ok = ok & lu_ok(lu_c)
        lus.append(lu_c)
        pivs.append(piv_c)
    if lus:
        lu_c = torch.stack(lus, dim=1)
        piv_c = torch.stack(pivs, dim=1)
    else:
        lu_c = jac.new_zeros(jac.shape[:-2] + (0, 2 * dim, 2 * dim))
        piv_c = torch.zeros(jac.shape[:-2] + (0, 2 * dim), dtype=torch.int32,
                            device=jac.device)
    return lu_r, piv_r, lu_c, piv_c, ok


def _newton(tab, f, t, y, h, z0, scale, tol, solve_real, solve_cplx,
            run_mask, max_iter, args, syncs):
    """Batched simplified Newton on the transformed collocation system.
    solve_real(b [M,D]) and solve_cplx(p, b [M,2D]) solve the real / p-th
    split-complex transformed stage system with the step's factors.
    Returns (z, converged, niter, nfev, rate)."""
    m, dim = y.shape
    dtype, dev = y.dtype, y.device
    s = tab.s
    t_mat, ti_mat, c_nodes = _consts(tab, dtype, dev)
    npair = (s - 1) // 2

    # attainable-correction floor: stage values ride on y's ulp grid, so the
    # scaled Newton norm cannot drop below ~eps·|y|/scale; at the floor the
    # iterate is the best this arithmetic can represent: converged.
    # Inactive in f64 (floor ≈ 1e-10·tol).
    eps_n = torch.finfo(dtype).eps
    floor_tol = 2.0 * eps_n * cm.safe_sqrt(torch.mean(
        torch.square(torch.abs(y) / scale), dim=-1))

    w = torch.einsum("ij,mjd->mid", ti_mat, z0)
    z = z0
    dw_norm_old = y.new_zeros((m,))
    rate = y.new_zeros((m,))
    running = run_mask
    converged = torch.zeros((m,), dtype=torch.bool, device=dev)
    niter = torch.zeros((m,), dtype=torch.int32, device=dev)
    nfev = torch.zeros((m,), dtype=torch.int32, device=dev)

    for k in range(max_iter):
        if not syncs.any(running):
            break
        fmat = torch.stack([f(t + c_nodes[i] * h, y + z[:, i, :], args)
                            for i in range(s)], dim=1)          # [M, s, D]
        finite = torch.isfinite(fmat).flatten(1).all(dim=1)
        fail_nan = running & ~finite

        # transformed residuals and solves
        tif = torch.einsum("ij,mjd->mid", ti_mat, fmat)         # [M, s, D]
        rhs_r = tif[:, 0, :] - (float(tab.mu_real) / h)[:, None] * w[:, 0, :]
        dws = [solve_real(rhs_r)]
        for p in range(npair):
            mu = tab.mu_complex[p]
            mur, mui = float(mu.real), float(mu.imag)
            w1 = w[:, 1 + 2 * p, :]
            w2 = w[:, 2 + 2 * p, :]
            # mu·(w1 + i·w2): real = Re·w1 − Im·w2, imag = Re·w2 + Im·w1
            fr = tif[:, 1 + 2 * p, :] - (mur * w1 - mui * w2) / h[:, None]
            fi = tif[:, 2 + 2 * p, :] - (mur * w2 + mui * w1) / h[:, None]
            sol = solve_cplx(p, torch.cat([fr, fi], dim=-1))
            dws.append(sol[:, :dim])
            dws.append(sol[:, dim:])
        dw = torch.stack(dws, dim=1)                            # [M, s, D]

        dw_norm = cm.safe_sqrt(torch.mean(
            torch.square(dw / scale[:, None, :]), dim=(1, 2)))
        have_rate = k > 0
        if have_rate:
            rate_now = torch.where(
                dw_norm_old > 0,
                dw_norm / torch.where(dw_norm_old == 0, 1.0, dw_norm_old),
                0.0)
        else:
            rate_now = torch.zeros_like(dw_norm)
        # divergence / hopeless-convergence tests (Hairer Θ logic)
        steps_left = float(max_iter - k)
        safe_rate = torch.clamp(rate_now, 1e-16, 1.0 - 1e-16)
        at_floor = dw_norm <= floor_tol
        if have_rate:
            diverged = ~at_floor & (
                (rate_now >= 1.0)
                | (safe_rate ** steps_left / (1.0 - safe_rate) * dw_norm > tol))
            slow_ok = (rate_now < 1.0) & (
                safe_rate / (1.0 - safe_rate) * dw_norm < tol)
        else:
            diverged = torch.zeros_like(running)
            slow_ok = torch.zeros_like(running)
        fail_now = running & (fail_nan | diverged)

        apply = running & ~fail_now
        w = torch.where(apply[:, None, None], w + dw, w)
        z_new = torch.einsum("ij,mjd->mid", t_mat, w)
        z = torch.where(apply[:, None, None], z_new, z)

        conv_now = apply & ((dw_norm == 0.0) | at_floor | slow_ok)

        niter = torch.where(running, k + 1, niter)
        dw_norm_old = torch.where(apply, dw_norm, dw_norm_old)
        rate = torch.where(running, rate_now, rate)
        converged = converged | conv_now
        nfev = nfev + _i32(running) * s
        running = running & ~fail_now & ~conv_now & (k + 1 < max_iter)
    return z, converged, niter, nfev, rate


def _tangent_stages(tab, f, t, y, h, z, yd, tol, solve_real, solve_cplx,
                    mask, args, syncs, max_iter=7, args_d=None):
    """Internal differentiation (Bock's IND): tangent collocation stages for
    K seed directions through ONE accepted primal step, reusing the step's
    LU factors.

    The tangent system Zd_i = h Σ_j a_ij·J_j·(yd + Zd_j) is LINEAR; it is
    solved by the same transformed simplified iteration as the primal
    Newton (matrices already factored). J_j·v is a ``torch.func.jvp`` of f
    at the converged stage point; with parameter tangents (args_d, leading
    axis K) the jvp is joint in (y, args) so ∂f/∂θ·dθ enters every stage.
    """
    k_dirs, m, dim = yd.shape
    s = tab.s
    t_mat, ti_mat, c_nodes = _consts(tab, y.dtype, y.device)
    npair = (s - 1) // 2
    t_st = [t + c_nodes[i] * h for i in range(s)]
    y_st = [y + z[:, i, :] for i in range(s)]
    args_rows = [None] * k_dirs if args_d is None else \
        [cm.tree_map(lambda a, _k=k: a[_k], args_d) for k in range(k_dirs)]

    def apply_lin(i, dys):                  # dys [K, M, D] -> [K, M, D]
        outs = []
        for k in range(k_dirs):
            if args_rows[k] is None:
                outs.append(jvp(lambda yy: f(t_st[i], yy, args),
                                (y_st[i],), (dys[k],))[1])
            else:
                outs.append(jvp(lambda yy, aa: f(t_st[i], yy, aa),
                                (y_st[i], args), (dys[k], args_rows[k]))[1])
        return torch.stack(outs)

    def solve_k(rhs):                       # [K, M, D] -> [K, M, D]
        return torch.stack([solve_real(rhs[k]) for k in range(k_dirs)])

    def solve_kc(p, rhs):                   # complex pair p
        return torch.stack([solve_cplx(p, rhs[k]) for k in range(k_dirs)])

    wd = yd.new_zeros((k_dirs, m, s, dim))
    zd = yd.new_zeros((k_dirs, m, s, dim))
    it, keep_going = 0, True
    while keep_going and it < max_iter:
        fd = torch.stack([apply_lin(i, yd + zd[:, :, i, :])
                          for i in range(s)], dim=2)           # [K, M, s, D]
        tif = torch.einsum("ij,kmjd->kmid", ti_mat, fd)
        rhs_r = tif[:, :, 0] - (float(tab.mu_real) / h)[None, :, None] \
            * wd[:, :, 0]
        dws = [solve_k(rhs_r)]
        for p in range(npair):
            mu = tab.mu_complex[p]
            mur, mui = float(mu.real), float(mu.imag)
            w1 = wd[:, :, 1 + 2 * p]
            w2 = wd[:, :, 2 + 2 * p]
            fr = tif[:, :, 1 + 2 * p] - (mur * w1 - mui * w2) / h[None, :, None]
            fi = tif[:, :, 2 + 2 * p] - (mur * w2 + mui * w1) / h[None, :, None]
            sol = solve_kc(p, torch.cat([fr, fi], dim=-1))
            dws.append(sol[..., :dim])
            dws.append(sol[..., dim:])
        dw = torch.stack(dws, dim=2)                           # [K, M, s, D]
        wd = wd + dw
        zd = torch.einsum("ij,kmjd->kmid", t_mat, wd)
        # converge RELATIVE to the tangent magnitude
        scale_d = 1.0 + torch.abs(yd)[:, :, None, :]           # [K, M, 1, D]
        dn = cm.safe_sqrt(torch.mean(torch.square(dw / scale_d),
                                     dim=(0, 2, 3)))
        keep_going = syncs.any(mask & (dn > tol) & torch.isfinite(dn))
        it += 1
    return zd


_LATER = {
    "t_eval": "slice 2 (dense output)", "events": "slice 2 (events)",
    "dense": "slice 2 (dense output)", "quad": "slice 2 (quadratures)",
    "mass": "slice 2 (mass matrices / DAEs)",
    "step_args": "slice 2 (step_args)",
    "record_steps": "slice 2 (step recording)",
    "qr_fallback": "slice 2 (QR fallback)",
    "_mesh_size": "slice 4 (continuous adjoint)",
    "_h0": "slice 4 (continuous adjoint)",
}


def _not_ported(name):
    raise NotImplementedError(
        f"solve_radau: {name}= is not ported to janus_tpu_torch yet; it "
        f"comes with {_LATER[name]} (ROADMAP.md Queue 1)")


def solve_radau(f: Callable, t0, tf, y0, args=None,
                options: Optional[Options] = None, t_eval=None,
                jac: Optional[Callable] = None, mass=None,
                events=None, tangents=None,
                args_tangents=None, quad: Optional[Callable] = None,
                dense: int = 0, step_args=None, _mesh_size: int = 0,
                _h0=None) -> cm.Solution:
    """Batched adaptive Radau IIA solve (fixed stage count = options.min_stages).

    f(t [M], y [M, D], args) -> [M, D]; y0 [M, D] on the device the solve runs
    on. tangents: optional [K, M, D] seed directions for forward
    sensitivities by internal differentiation (one primal solve + K linear
    tangent sweeps per accepted step reusing the step's LU factors); result
    in ``Solution.sens`` [K, M, D]. args_tangents: optional pytree matching
    ``args`` with a leading K axis (parameter seed directions).

    The host syncs of the last solve are in ``solve_radau.host_syncs``.
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
    if opts.stage_solver != "lu":
        raise NotImplementedError(
            f"stage_solver={opts.stage_solver!r} is not ported to "
            "janus_tpu_torch yet; it comes with slice 3 (matrix-free radau, "
            "ROADMAP.md Queue 1)")
    for name, val in (("t_eval", t_eval), ("events", events),
                      ("mass", mass), ("quad", quad),
                      ("step_args", step_args), ("_h0", _h0)):
        if val is not None:
            _not_ported(name)
    for name, flag in (("dense", dense), ("_mesh_size", _mesh_size),
                       ("record_steps", opts.record_steps),
                       ("qr_fallback", opts.qr_fallback)):
        if flag:
            _not_ported(name)

    s = opts.min_stages
    tab = radau_tableau(s)
    t0, tf, y0 = cm.broadcast_batch(t0, tf, y0)
    m, dim = y0.shape
    dtype, dev = y0.dtype, y0.device
    npair = (s - 1) // 2
    syncs = _HostSyncs()

    factor = _kernel_lu_factor if opts.kernel_lu else None
    jac_fn = jac if jac is not None else default_jacobian(f)
    newton_tol = (opts.newton_tol if opts.newton_tol > 0
                  else cm.derived_newton_tol(dtype, opts.rtol))
    max_iter = opts.newton_max_iter
    p_mat = torch.as_tensor(tab.p, dtype=dtype, device=dev)
    e_vec = torch.as_tensor(tab.e, dtype=dtype, device=dev)
    c_nodes = torch.as_tensor(tab.c, dtype=dtype, device=dev)
    ind_exp, use_index = cm.index_weights(opts, dim, dtype, dev)

    use_sens = tangents is not None or args_tangents is not None
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

    f0 = f(t0, y0, args)
    if opts.h0 == 0.0:
        h_st = cm.initial_step(f, t0, y0, f0, tf, s, opts.rtol, opts.atol,
                               args, opts.max_step)
    else:
        direction = torch.where(tf >= t0, 1.0, -1.0).to(dtype)
        h_st = torch.full((m,), opts.h0, dtype=dtype, device=dev) * direction

    stats = cm.zero_stats(m, ("nfev", "njev", "nlu", "nsteps", "naccept",
                              "nreject", "nnewton"), dev)
    stats["nfev"] = stats["nfev"] + 2

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    t, y = t0, y0
    t_lo, y_lo = zeros(m), zeros(m, dim)
    jac_m = zeros(m, dim, dim)
    lu_real, piv_real = zeros(m, dim, dim), zeros(m, dim, dt=torch.int32)
    lu_cplx = zeros(m, npair, 2 * dim, 2 * dim)
    piv_cplx = zeros(m, npair, 2 * dim, dt=torch.int32)
    h_fact = zeros(m)
    current_jac = zeros(m, dt=torch.bool)
    need_jac = torch.ones((m,), dtype=torch.bool, device=dev)
    h_old, err_old = zeros(m), zeros(m)
    rejected = zeros(m, dt=torch.bool)
    nsing = zeros(m, dt=torch.int32)
    q_poly = zeros(m, s, dim)
    h_prev = torch.ones((m,), dtype=dtype, device=dev)
    have_sol = zeros(m, dt=torch.bool)
    already_done = t0 == tf
    active = ~already_done
    status = torch.where(already_done, cm.SUCCESS, cm.RUNNING).to(torch.int8)
    eps = torch.finfo(dtype).eps

    while syncs.any(active):
        # ---- step-size clamp to the boundary -----------------------------
        dir0 = torch.sign(h_st)
        dir0 = torch.where(dir0 == 0, 1.0, dir0)
        remaining = (tf - t) - t_lo
        # compensated t can overshoot tf by O(eps^2): force a final
        # forward-direction sliver instead of a sign-flipped (backward) step
        overshoot = remaining * dir0 <= 0.0
        remaining = torch.where(
            overshoot, dir0 * eps * torch.clamp(torch.abs(tf), min=1.0),
            remaining)
        last = torch.abs(h_st) >= torch.abs(remaining)
        h = torch.where(last, remaining, h_st)
        h = torch.where(h == 0.0, eps * dir0, h)

        # ---- Jacobian refresh (lanes that need it) -----------------------
        needj = need_jac & active
        jmat = torch.where(needj[:, None, None], jac_fn(t, y, args), jac_m)
        current_jac = current_jac | needj

        # ---- factorization (lanes that need it) --------------------------
        needf = active & (needj | (h != h_fact))
        lr, pr, lc, pc, ok = _factorize(tab, h, jmat, opts.pivoting,
                                        factor=factor)
        lu_r = torch.where(needf[:, None, None], lr, lu_real)
        piv_r = torch.where(needf[:, None], pr, piv_real)
        lu_c = torch.where(needf[:, None, None, None], lc, lu_cplx)
        piv_c = torch.where(needf[:, None, None], pc, piv_cplx)
        fact_ok = torch.where(needf, ok, True)
        h_fact_now = torch.where(needf, h, h_fact)
        if opts.kernel_lu:
            def solve_real(b, _lu=lu_r):
                return _kernel_lu_solve(_lu, b)

            def solve_cplx(p, b, _lu=lu_c):
                return _kernel_lu_solve(_lu[:, p], b)
        else:
            def solve_real(b, _lu=lu_r, _piv=piv_r):
                return lu_solve(_lu, _piv, b)

            def solve_cplx(p, b, _lu=lu_c, _piv=piv_c):
                return lu_solve(_lu[:, p], _piv[:, p], b)

        singular = active & ~fact_ok

        # ---- Newton warm start from previous collocation polynomial ------
        theta_ws = 1.0 + c_nodes[None, :] * (h / h_prev)[:, None]   # [M,s]
        powers = torch.stack([_ipow(theta_ws, q + 1) for q in range(s)],
                             dim=-1)
        poly_at = torch.einsum("msq,mqd->msd", powers, q_poly)
        poly_at_1 = torch.sum(q_poly, dim=1)         # poly(1) = Σ_q Q_q
        z0 = torch.where(have_sol[:, None, None],
                         poly_at - poly_at_1[:, None, :], 0.0)

        # ---- simplified Newton -------------------------------------------
        scale_n = opts.atol + opts.rtol * torch.abs(y)
        if use_index:
            scale_n = scale_n / torch.abs(h)[:, None] ** ind_exp[None, :]
        run_newton = active & fact_ok
        z, nconv, niter, nfev, rate = _newton(
            tab, f, t, y, h, z0, scale_n, newton_tol, solve_real, solve_cplx,
            run_newton, max_iter, args, syncs)
        conv = run_newton & nconv
        newton_fail = run_newton & ~nconv

        # stale-Jacobian failures retry at the same h with a fresh Jacobian;
        # fresh-Jacobian failures halve h (reference/Hairer policy)
        nf_stale = newton_fail & ~current_jac
        nf_fresh = (newton_fail & current_jac) | singular

        # ---- error estimate ----------------------------------------------
        if opts.compensated:
            # double-word accumulation: fold the step increment (and any
            # carried remainder) into the state without per-step ulp loss
            y_new, y_lo_new = cm.comp_add(y, y_lo, z[:, -1, :])
            t_new, t_lo_new = cm.comp_add(t, t_lo, h)
        else:
            y_new, y_lo_new = y + z[:, -1, :], y_lo
            t_new, t_lo_new = t + h, t_lo
        ze = torch.einsum("s,msd->md", e_vec, z) / h[:, None]
        err1 = solve_real(f0 + ze)
        scale_e = opts.atol + opts.rtol * torch.maximum(torch.abs(y),
                                                        torch.abs(y_new))
        if use_index:
            scale_e = scale_e / torch.abs(h)[:, None] ** ind_exp[None, :]
        enorm1 = cm.rms_norm(err1, scale_e)
        enorm1 = torch.where(torch.isfinite(enorm1), enorm1, 1e10)

        refine = conv & rejected & (enorm1 > 1.0)
        err2 = solve_real(f(t, y + err1, args) + ze)
        en2 = cm.rms_norm(err2, scale_e)
        enorm = torch.where(refine, torch.where(torch.isfinite(en2), en2,
                                                1e10), enorm1)

        accept = conv & (enorm <= 1.0)
        reject_err = conv & (enorm > 1.0)

        # ---- controller ---------------------------------------------------
        h_abs = torch.abs(h)
        niter_f = torch.clamp(niter, min=1).to(dtype)
        safety = opts.safety * (2 * max_iter + 1) / (2 * max_iter + niter_f)
        # error-estimator order is s+1 ⇒ controller exponent 1/(s+1)
        expo = 1.0 / (s + 1)
        have_old = (h_old > 0) & (err_old > 0) & (enorm > 0)
        mult = torch.where(
            have_old,
            h_abs / torch.where(h_old == 0, 1.0, h_old)
            * (err_old / torch.where(enorm == 0, 1.0, enorm)) ** expo,
            1.0)
        enorm_safe = torch.clamp(enorm, min=1e-16)
        gmult = torch.clamp(mult, max=1.0) if opts.gustafsson else 1.0
        base_factor = gmult * enorm_safe ** -expo
        fac_rej = torch.clamp(safety * base_factor, min=opts.min_factor)
        # accept path: clamp BOTH ways
        fac_acc = torch.clamp(safety * base_factor, opts.min_factor,
                              opts.max_factor)
        recompute_jac = accept & (niter > 2) & (rate > opts.jac_recompute)
        deadzone = accept & ~recompute_jac & (fac_acc >= opts.quot1) & \
            (fac_acc < opts.quot2)
        fac_acc = torch.where(deadzone, 1.0, fac_acc)

        # ---- new f at accepted points -------------------------------------
        f_new = torch.where(accept[:, None], f(t_new, y_new, args), f0)

        # ---- internal-differentiation tangent sweep -----------------------
        if use_sens:
            zd = _tangent_stages(tab, f, t, y, h, z, yd, newton_tol,
                                 solve_real, solve_cplx, accept, args, syncs,
                                 args_d=args_d)
            yd = torch.where(accept[None, :, None], yd + zd[:, :, -1, :], yd)

        # ---- warm-start polynomial ----------------------------------------
        q_new = torch.einsum("msd,sq->mqd", z, p_mat)  # [M, θ-power q, D]
        q_poly = torch.where(accept[:, None, None], q_new, q_poly)

        # ---- state update -------------------------------------------------
        h_next_abs = torch.where(
            accept, h_abs * fac_acc,
            torch.where(reject_err, h_abs * fac_rej,
                        torch.where(nf_fresh, h_abs * 0.5, h_abs)))
        h_next_abs = torch.clamp(h_next_abs, max=opts.max_step)
        h_st = torch.where(active, h_next_abs * torch.sign(h), h_st)

        done = accept & last

        stats["nfev"] = stats["nfev"] + nfev + _i32(accept) + _i32(refine) \
            + (_i32(accept) * s if use_sens else 0)
        stats["njev"] = stats["njev"] + _i32(needj)
        stats["nlu"] = stats["nlu"] + _i32(needf) * (1 + npair)
        stats["nsteps"] = stats["nsteps"] + _i32(run_newton | singular)
        stats["naccept"] = stats["naccept"] + _i32(accept)
        stats["nreject"] = stats["nreject"] + _i32(reject_err | newton_fail
                                                   | singular)
        stats["nnewton"] = stats["nnewton"] + niter

        nsing = torch.where(singular | newton_fail, nsing + 1,
                            torch.where(accept, 0, nsing))
        stall = active & (nsing >= 7)

        exceeded = active & (stats["nsteps"] >= opts.max_steps) & ~done
        # double-word t resolves steps below ulp(t): scale the underflow
        # floor by eps^2 in compensated mode (true stalls hit nsing instead)
        ueps = eps * eps if opts.compensated else eps
        hmin = 16.0 * ueps * torch.clamp(torch.abs(t_new), min=1.0)
        underflow = active & (h_next_abs < hmin) & ~done

        status = torch.where(done, cm.SUCCESS, status)
        status = torch.where(exceeded, cm.MAX_STEPS, status)
        status = torch.where(underflow, cm.STEP_UNDERFLOW, status)
        status = torch.where(stall, cm.NEWTON_STALL, status)
        active = active & ~done & ~exceeded & ~underflow & ~stall

        t = torch.where(accept, t_new, t)
        y = torch.where(accept[:, None], y_new, y)
        t_lo = torch.where(accept, t_lo_new, t_lo)
        y_lo = torch.where(accept[:, None], y_lo_new, y_lo)
        f0 = f_new
        jac_m = jmat
        lu_real, piv_real, lu_cplx, piv_cplx = lu_r, piv_r, lu_c, piv_c
        # deadzone lanes keep factors; everyone else refactors next time
        h_fact = torch.where(accept & ~deadzone, 0.0,
                             torch.where(reject_err | nf_fresh, 0.0,
                                         h_fact_now))
        # the Jacobian refers to the pre-step point: stale after an accept
        current_jac = torch.where(accept, False, current_jac)
        need_jac = torch.where(accept, recompute_jac,
                               torch.where(nf_stale, True,
                                           torch.where(needj, False,
                                                       need_jac)))
        h_old = torch.where(accept, h_abs, h_old)
        err_old = torch.where(accept, enorm_safe, err_old)
        rejected = torch.where(accept, False,
                               rejected | reject_err | newton_fail | singular)
        h_prev = torch.where(accept, h, h_prev)
        have_sol = have_sol | accept

    solve_radau.host_syncs = syncs.count
    return cm.Solution(t=t, y=y, status=status, stats=stats,
                       sens=yd if use_sens else None, h_next=h_st)


solve_radau.host_syncs = 0
