"""Batched lockstep Radau IIA with simplified Newton — the flagship stiff path.

The port of ``janus_tpu/solve/radau.py``, fixed stage count, with the dense
stage LU or the matrix-free stage solvers, and a mass matrix: one
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
  per trip, as in the reference;
- the events' bisection runs only on a step where some lane crossed, one
  host sync a step (``solve/events.py``); with events and tangents the IND
  jump at t* is computed every step and selected on the lanes that stop;
- on the matrix-free path the refined error estimate is a whole GMRES solve,
  so there it is gated on one more host sync, as the reference gates it.

Stage solves: one real D×D and (s−1)/2 split-real complex 2D×2D systems per
iteration with factors REUSED across iterations. With
``Options(kernel_lu=True)`` the factor and every solve go through the CUDA
kernels K1/K2 of ``janus_tpu_torch.ops.smalllu`` (their twins on CPU
tensors); otherwise through the plain torch LU of ``linalg.smalllu``.

Matrix-free stage solves (``Options(stage_solver='gmres'|'tridiag')``): in
place of LU factors of γ/h·M − J each stage system is solved by batched
GMRES(k) whose operator applies J·v as a ``torch.func.jvp`` of f at a frozen
linearization point, preconditioned by a structure probed from J with a few
colored jvp's (``Options(precond='tridiag'|'lines'|'block')``);
``'tridiag'`` skips GMRES and solves the structure directly (a modified
Newton). This is the path for method-of-lines systems (D in the hundreds),
where the dense LU's D³ per lane (unrolled in the kernels up to D = 16, one
lane a thread in device memory above) does not pay. It runs no
hand-written kernel, as it runs no Pallas kernel in the reference.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.func import jvp, vjp

from janus_tpu_torch.control.precond import (blocks_of_jacobian,
                                             line_tridiag_bands,
                                             tridiag_bands)
from janus_tpu_torch.control.precond import \
    guarded_block_lu as _guarded_block_lu
from janus_tpu_torch.diag.profile import scope
from janus_tpu_torch.diag.record import init_dyn, record_step
from janus_tpu_torch.linalg.gmres import (gmres_batched, gmres_dense_solve,
                                          mass_matvec, tridiag_bands_of,
                                          tridiag_solve_auto,
                                          tridiag_solve_complex_auto)
from janus_tpu_torch.linalg.qr import qr_factor, qr_solve
from janus_tpu_torch.linalg.smalllu import lu_factor, lu_ok, lu_solve
from janus_tpu_torch.ops.smalllu import (lu_factor_t, lu_solve_t,
                                         refuse_derivatives)
from janus_tpu_torch.solve import common as cm
from janus_tpu_torch.solve.events import (handle_events, init_event_state,
                                          normalize_events)
from janus_tpu_torch.solve.options import Options
from janus_tpu_torch.solve.radau_tables import radau_tableau


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


def _build_iter_matrices(tab, h, jac, mass=None):
    """(a_real [M,D,D], blocks list of [M,2D,2D]): the real and split-real
    complex stage iteration matrices γ_q/h·M − J."""
    mm = torch.eye(jac.shape[-1], dtype=jac.dtype, device=jac.device) \
        if mass is None else mass
    a_real = (float(tab.mu_real) / h)[..., None, None] * mm - jac
    blocks = []
    for p in range((tab.s - 1) // 2):
        mu = tab.mu_complex[p]
        mur, mui = float(mu.real), float(mu.imag)
        ar = (mur / h)[..., None, None] * mm - jac
        ai = (mui / h)[..., None, None] * mm             # Im(mu) < 0
        top = torch.cat([ar, -ai], dim=-1)
        bot = torch.cat([ai, ar], dim=-1)
        blocks.append(torch.cat([top, bot], dim=-2))
    return a_real, blocks


def refuse_kernel_derivatives(use_kernel, name, y0, *trees):
    """At a solve's entry: under ``kernel_lu`` on a CUDA tensor no input
    may carry a derivative (``ops.smalllu.refuse_derivatives``: K1/K2 have
    no derivative rule), so that the error comes before any work."""
    if use_kernel and y0.device.type == "cuda":
        refuse_derivatives(f"{name}(kernel_lu=True)", y0, *trees)


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


def _factorize(tab, h, jac, mass=None, pivot=True, factor=None):
    """Build and factor the real and split-complex iteration matrices."""
    dim = jac.shape[-1]
    factor = lu_factor if factor is None else factor
    a_real, blocks = _build_iter_matrices(tab, h, jac, mass)
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


def _mass_dot(mass):
    """w -> M·w on the last axis of w [M, D] or [K, M, s, D], for a mass
    [D, D] or per lane [M, D, D] (None: the identity)."""
    if mass is None:
        return lambda w: w
    if mass.ndim == 2:
        return lambda w: cm.lane_einsum("ij,...j->...i", mass, w)
    return lambda w: cm.lane_einsum(
        "mij,mj->mi" if w.ndim == 2 else "mij,kmsj->kmsi", mass, w)


def _newton(tab, f, t, y, h, z0, scale, tol, solve_real, solve_cplx,
            run_mask, max_iter, args, syncs, mass=None):
    """Batched simplified Newton on the transformed collocation system.
    solve_real(b [M,D]) and solve_cplx(p, b [M,2D]) solve the real / p-th
    split-complex transformed stage system with the step's factors (or its
    matrix-free solvers). With a mass matrix M the collocation system is
    M·Z = h·A·F (DAE form): residuals use M·w.
    Returns (z, converged, niter, nfev, rate)."""
    mdot = _mass_dot(mass)
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

    w = cm.lane_einsum("ij,mjd->mid", ti_mat, z0)
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
        tif = cm.lane_einsum("ij,mjd->mid", ti_mat, fmat)      # [M, s, D]
        rhs_r = tif[:, 0, :] - (float(tab.mu_real) / h)[:, None] \
            * mdot(w[:, 0, :])
        dws = [solve_real(rhs_r)]
        for p in range(npair):
            mu = tab.mu_complex[p]
            mur, mui = float(mu.real), float(mu.imag)
            w1 = mdot(w[:, 1 + 2 * p, :])
            w2 = mdot(w[:, 2 + 2 * p, :])
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
        z_new = cm.lane_einsum("ij,mjd->mid", t_mat, w)
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
                    mask, args, syncs, max_iter=7, args_d=None, mass=None):
    """Internal differentiation (Bock's IND): tangent collocation stages for
    K seed directions through ONE accepted primal step, reusing the step's
    LU factors (or, on the matrix-free path, its frozen GMRES solvers).

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
    mdot = _mass_dot(mass)
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
        tif = cm.lane_einsum("ij,kmjd->kmid", ti_mat, fd)
        mw = mdot(wd)
        rhs_r = tif[:, :, 0] - (float(tab.mu_real) / h)[None, :, None] \
            * mw[:, :, 0]
        dws = [solve_k(rhs_r)]
        for p in range(npair):
            mu = tab.mu_complex[p]
            mur, mui = float(mu.real), float(mu.imag)
            w1 = mw[:, :, 1 + 2 * p]
            w2 = mw[:, :, 2 + 2 * p]
            fr = tif[:, :, 1 + 2 * p] - (mur * w1 - mui * w2) / h[None, :, None]
            fi = tif[:, :, 2 + 2 * p] - (mur * w2 + mui * w1) / h[None, :, None]
            sol = solve_kc(p, torch.cat([fr, fi], dim=-1))
            dws.append(sol[..., :dim])
            dws.append(sol[..., dim:])
        dw = torch.stack(dws, dim=2)                           # [K, M, s, D]
        wd = wd + dw
        zd = cm.lane_einsum("ij,kmjd->kmid", t_mat, wd)
        # converge RELATIVE to the tangent magnitude
        scale_d = 1.0 + torch.abs(yd)[:, :, None, :]           # [K, M, 1, D]
        dn = cm.safe_sqrt(torch.mean(torch.square(dw / scale_d),
                                     dim=(0, 2, 3)))
        keep_going = syncs.any(mask & (dn > tol) & torch.isfinite(dn))
        it += 1
    return zd


def _gmres_mass_ops(mass, m, dim, like):
    """(mdotv, dl, d, du) for the mass term of the GMRES stage operator."""
    if mass is None:
        return (lambda v: v, torch.zeros_like(like), torch.ones_like(like),
                torch.zeros_like(like))
    mm = mass if mass.ndim == 3 else mass.expand(m, dim, dim)
    return (mass_matvec(mm, m), *tridiag_bands_of(mm))


def _cplx_matvec(gr, gi, mdotv, jv, dim):
    """v [M, 2D] -> (γ·M − J)·v for the complex shift γ = gr + i·gi in the
    split layout ([:, :D] real, [:, D:] imaginary)."""
    def mv(v):
        vr, vi = v[:, :dim], v[:, dim:]
        mvr, mvi = mdotv(vr), mdotv(vi)
        outr = gr[:, None] * mvr - gi[:, None] * mvi - jv(vr)
        outi = gr[:, None] * mvi + gi[:, None] * mvr - jv(vi)
        return torch.cat([outr, outi], dim=-1)
    return mv


def _tridiag_pc(a_dl, a_d, a_du):
    """v -> T⁻¹·v for the tridiagonal T with bands (a_dl, a_d, a_du), each
    [M, D]; the identity on a lane whose diagonal has a zero or a
    non-finite entry."""
    ok = (torch.isfinite(a_d) & (a_d != 0.0)).all(dim=-1, keepdim=True)
    pc_d = torch.where(ok, a_d, 1.0)
    pc_dl = torch.where(ok, a_dl, 0.0)
    pc_du = torch.where(ok, a_du, 0.0)
    return lambda v: tridiag_solve_auto(pc_dl, pc_d, pc_du, v)


def _gmres_core(tab, jv, bands, h, mass_ops, iters):
    """Batched GMRES solvers for the transformed stage systems γ_q/h·M − J.

    jv applies J·v matrix-free; bands [M, 3, D] are J's tridiagonal
    (dl, d, du) for the tridiagonal preconditioner; mass_ops is
    ``_gmres_mass_ops`` output. Shared by the forward stage solves and the
    continuous-adjoint backward solves (there J := −Jᵀ, M := Mᵀ, h := h_b).

    iters == 0 (stage_solver='tridiag'): skip GMRES entirely and DIRECT-
    solve the tridiagonal part of the stage operator: a modified-Newton
    iteration matrix, exact for 3-point-stencil (1-D MOL) Jacobians and
    otherwise merely weaker: the surrounding simplified-Newton convergence
    monitor polices contraction exactly as it does for stale Jacobians, so
    a poor match slows or fails loudly, never silently corrupts.
    """
    dim = bands.shape[-1]
    j_bands = bands.unbind(1)                                  # dl, d, du
    mdotv, *m_bands = mass_ops
    gam = float(tab.mu_real) / h                               # [M]
    pc_real = _tridiag_pc(*(gam[:, None] * mb - jb
                            for mb, jb in zip(m_bands, j_bands)))

    def solve_real(b):
        if iters == 0:
            return pc_real(b)
        return gmres_batched(lambda v: gam[:, None] * mdotv(v) - jv(v), b,
                             pc_real, iters)[0]

    shifts, bands_c = [], []
    for mu in tab.mu_complex:
        gr = float(mu.real) / h                                # [M]
        gi = float(mu.imag) / h
        shifts.append((gr, gi))
        # (re, im) of each band of γ·M − J
        bands_c.append([(gr[:, None] * mb - jb, gi[:, None] * mb)
                        for mb, jb in zip(m_bands, j_bands)])

    def solve_cplx(p, b2):
        def pc(v):
            return torch.cat(tridiag_solve_complex_auto(
                *bands_c[p], (v[:, :dim], v[:, dim:])), dim=-1)

        if iters == 0:
            return pc(b2)
        return gmres_batched(_cplx_matvec(*shifts[p], mdotv, jv, dim), b2,
                             pc, iters)[0]

    return solve_real, solve_cplx


def _gmres_mass_blocks(mass, m, nb, b, dtype, device):
    """(mdotv, mblk [M, nb, b, b]) for the block-Jacobi stage preconditioner:
    the full-mass matvec for the GMRES operator plus the mass's DIAGONAL
    blocks for the preconditioner (off-block mass couplings are left to the
    Krylov iteration, like the off-band couplings of the tridiag path)."""
    if mass is None:
        eye = torch.eye(b, dtype=dtype, device=device).expand(m, nb, b, b)
        return (lambda v: v), eye
    dim = nb * b
    mm = mass if mass.ndim == 3 else mass.expand(m, dim, dim)
    mblk = torch.diagonal(mm.reshape(m, nb, b, nb, b), dim1=1,
                          dim2=3).movedim(-1, 1)
    return mass_matvec(mm, m), mblk


def _block_pc(a_blk):
    """v [M, D] -> blockdiag(a_blk)⁻¹·v for blocks a_blk [M, nb, b, b]."""
    m, nb, b, _ = a_blk.shape
    lu, piv = _guarded_block_lu(a_blk)
    return lambda v: lu_solve(lu, piv, v.reshape(m, nb, b)).reshape(m, nb * b)


def _gmres_block_core(tab, jv, blocks, h, mdotv, mblk, iters):
    """Block-Jacobi twin of ``_gmres_core``: the preconditioner is the
    DIAGONAL-BLOCK part of the stage operator γ_q/h·M − J, factored once per
    step with the batched unrolled LU ([M, nb, b, b]; complex pairs via the
    2b×2b real embedding [[Ar, −Ai], [Ai, Ar]]). Exact for block-diagonal
    Jacobians (cell-local reaction terms); the Krylov iteration carries the
    cross-block (spatial) couplings. iters == 0 direct-solves the blocks
    (block modified Newton)."""
    m, nb, b, _ = blocks.shape
    dim = nb * b
    gam = float(tab.mu_real) / h                               # [M]
    pc_real = _block_pc(gam[:, None, None, None] * mblk - blocks)

    def solve_real(rhs):
        if iters == 0:
            return pc_real(rhs)
        return gmres_batched(lambda v: gam[:, None] * mdotv(v) - jv(v), rhs,
                             pc_real, iters)[0]

    shifts, lus_c = [], []
    for mu in tab.mu_complex:
        gr = float(mu.real) / h
        gi = float(mu.imag) / h
        ar = gr[:, None, None, None] * mblk - blocks
        ai = gi[:, None, None, None] * mblk
        big = torch.cat([torch.cat([ar, -ai], dim=-1),
                         torch.cat([ai, ar], dim=-1)], dim=-2)  # [M,nb,2b,2b]
        shifts.append((gr, gi))
        lus_c.append(_guarded_block_lu(big))

    def solve_cplx(p, b2):
        def pc(v):
            vr = v[:, :dim].reshape(m, nb, b)
            vi = v[:, dim:].reshape(m, nb, b)
            out = lu_solve(*lus_c[p], torch.cat([vr, vi], dim=-1))
            return torch.cat([out[..., :b].reshape(m, dim),
                              out[..., b:].reshape(m, dim)], dim=-1)

        if iters == 0:
            return pc(b2)
        return gmres_batched(_cplx_matvec(*shifts[p], mdotv, jv, dim), b2,
                             pc, iters)[0]

    return solve_real, solve_cplx


def precond_probe_fn(f, precond, block, dim):
    """jac_fn(t, y, args) -> probed preconditioner data for the matrix-free
    stage path, dispatched on Options(precond=): [M, 3, D] bands for
    'tridiag'/'lines', [M, nb, b, b] diagonal blocks for 'block'. Shared by
    every solver family with matrix-free stage solves (radau, ndf)."""
    if precond not in ("tridiag", "lines", "block"):
        raise ValueError(f"unknown precond {precond!r}")
    if precond in ("lines", "block"):
        if block <= 0 or dim % block != 0:
            raise ValueError(
                f"precond={precond!r} needs precond_block > 0 "
                f"dividing D={dim}, got {block}")
    if precond == "block":
        def jac_fn(t, y, a):     # [M, nb, b, b] diagonal blocks
            return blocks_of_jacobian(lambda yy: f(t, yy, a), y, block)
        return jac_fn

    def jac_fn(t, y, a):         # [M, 3, D] preconditioner bands
        def fy(yy):
            return f(t, yy, a)
        bands = tridiag_bands(fy, y) if precond == "tridiag" \
            else line_tridiag_bands(fy, y, block)      # in-line (2-D rows)
        return torch.stack(bands, dim=1)
    return jac_fn


def _shifted_solver(apply_j, m, dim, pdata, a_coef, b_coef, mass, iters,
                    precond, block):
    """(solve, mdotv) for (a·M − b·J)·x = rhs where apply_j(v) is J·v and
    pdata the probed structure of that same J."""
    if precond == "block":
        mdotv, mblk = _gmres_mass_blocks(mass, m, dim // block, block,
                                         pdata.dtype, pdata.device)
        pc = _block_pc(a_coef[:, None, None, None] * mblk
                       - b_coef[:, None, None, None] * pdata)
    else:
        mdotv, *m_bands = _gmres_mass_ops(mass, m, dim, pdata[:, 1])
        pc = _tridiag_pc(*(a_coef[:, None] * mb - b_coef[:, None] * jb
                           for mb, jb in zip(m_bands, pdata.unbind(1))))

    def solve(rhs):
        if iters == 0:
            return pc(rhs)
        return gmres_batched(
            lambda v: a_coef[:, None] * mdotv(v) - b_coef[:, None]
            * apply_j(v), rhs, pc, iters)[0]

    return solve, mdotv


def gmres_shifted_solver(f, t_lin, y_lin, args, pdata, a_coef, b_coef, mass,
                         iters, precond="tridiag", block=0):
    """(solve, mdotv): solve(rhs) for the REAL shifted system
    (a·M − b·J)·x = rhs, matrix-free (J·v by jvp at the frozen linearization
    point), with the probed structure preconditioner selected by
    ``precond``. a_coef/b_coef are per-lane [M] scalars. The BDF/NDF
    corrector role; iters == 0 direct-solves the preconditioner structure
    (modified Newton)."""
    m, dim = y_lin.shape

    def jv(v):
        return jvp(lambda yy: f(t_lin, yy, args), (y_lin,), (v,))[1]

    return _shifted_solver(jv, m, dim, pdata, a_coef, b_coef, mass, iters,
                           precond, block)


def gmres_shifted_solver_T(f, t_lin, y_lin, args, pdata, a_coef, b_coef,
                           mass, iters, precond="tridiag", block=0):
    """solve(rhs) for the TRANSPOSED real shifted system
    (a·M − b·J)ᵀ x = rhs, matrix-free: Jᵀ·v is a ``torch.func.vjp`` PULL of
    the rhs at the frozen linearization point (J is never materialized),
    Mᵀ·v an explicit matvec, and the preconditioner is the TRANSPOSE of the
    probed forward structure. Bands: (Jᵀ)_dl[i] = J_du[i−1], (Jᵀ)_du[i] =
    J_dl[i+1] (line-boundary zeros map to line-boundary zeros, so 'lines'
    rides the same shift); blocks: per-block transpose. The discrete-adjoint
    twin of ``gmres_shifted_solver``; iters == 0 direct-solves the
    transposed preconditioner structure."""
    m, dim = y_lin.shape
    pull = vjp(lambda yy: f(t_lin, yy, args), y_lin)[1]
    mass_t = None if mass is None else mass.mT
    if precond == "block":
        pdata_t = pdata.mT
    else:
        pdata_t = torch.stack([F.pad(pdata[:, 2, :-1], (1, 0)), pdata[:, 1],
                               F.pad(pdata[:, 0, 1:], (0, 1))], dim=1)
    return _shifted_solver(lambda v: pull(v)[0], m, dim, pdata_t, a_coef,
                           b_coef, mass_t, iters, precond, block)[0]


def _gmres_stage_solver(tab, f, t_lin, y_lin, args, pdata, h, mass, iters,
                        precond="tridiag", block=0):
    """Matrix-free transformed-stage solvers for stage_solver='gmres'.

    In place of dense LU factors of (γ/h·M − J), each stage system is solved
    by batched GMRES(k) whose operator applies J·v as a jvp of the rhs at the
    FROZEN linearization point (t_lin, y_lin), so J is never materialized,
    preconditioned by the structure selected in Options(precond=):
    (complex) tridiagonal Thomas/PCR sweeps from probed bands
    (pdata [M, 3, D]; 'tridiag' = plain 1-D, 'lines' = line-blocked 2-D MOL)
    or block-Jacobi LU solves from probed diagonal blocks
    (pdata [M, nb, b, b]; 'block').
    """
    m, dim = y_lin.shape

    def jv(v):
        return jvp(lambda yy: f(t_lin, yy, args), (y_lin,), (v,))[1]

    if precond == "block":
        mdotv, mblk = _gmres_mass_blocks(mass, m, dim // block, block,
                                         y_lin.dtype, y_lin.device)
        return _gmres_block_core(tab, jv, pdata, h, mdotv, mblk, iters)
    mass_ops = _gmres_mass_ops(mass, m, dim, pdata[:, 1])
    return _gmres_core(tab, jv, pdata, h, mass_ops, iters)


def _event_tangent_jump(specs, f, t_ev, y_ev, args, args_rows, mass,
                        use_gmres, gmres_iters, yd_old, qd, th_e, ev_idx,
                        terminate, yd):
    """The IND tangents of a lane stopped by a terminal event: the event
    time moves with the seed direction, dt*_k = −(g_y·yd_k + g_θ·dθ_k) /
    (g_t + g_y·ẏ*) with ẏ* = M⁻¹f(t*, y*), and the lane's sensitivity is
    the total derivative yd(t*) + ẏ*·dt*_k (the implicit-function
    correction). yd(t*) comes off the step's tangent polynomial qd at θ*.
    Returns (yd with the terminated lanes replaced, dt* [K, M])."""
    m, dim = y_ev.shape
    k_dirs = yd.shape[0]
    tp_ev = torch.stack([th_e ** (q + 1) for q in range(qd.shape[2])],
                        dim=-1)                                  # [M, s]
    yd_ev = yd_old + cm.lane_einsum("kmqd,mq->kmd", qd, tp_ev)
    f_ev = f(t_ev, y_ev, args)
    if mass is None:
        ydot = f_ev
    elif use_gmres:
        ydot = gmres_dense_solve(mass, f_ev, gmres_iters)
    else:
        ydot = lu_solve(*lu_factor(mass.expand(m, dim, dim), pivot=True),
                        f_ev)
    sens_sel = yd_ev
    dts_sel = yd_ev.new_zeros((k_dirs, m))
    for j, spec in enumerate(specs):
        gdot = jvp(lambda tt, yy: spec.fn(tt, yy, args), (t_ev, y_ev),
                   (torch.ones_like(t_ev), ydot))[1]
        gy_yd = torch.stack([
            jvp(lambda yy: spec.fn(t_ev, yy, args), (y_ev,), (yd_ev[k],))[1]
            if args_rows[k] is None else
            # g_θ·dθ_k rides the same joint jvp (g may read the parameters)
            jvp(lambda yy, aa: spec.fn(t_ev, yy, aa), (y_ev, args),
                (yd_ev[k], args_rows[k]))[1]
            for k in range(k_dirs)])                             # [K, M]
        dts = -gy_yd / torch.where(gdot == 0.0, 1.0, gdot)[None]
        on = (ev_idx == j)[None, :]
        sens_sel = torch.where(on[..., None], yd_ev + dts[..., None] * ydot,
                               sens_sel)
        dts_sel = torch.where(on, dts, dts_sel)
    return torch.where(terminate[None, :, None], sens_sel, yd), dts_sel


def _qr_reg_ok(r):
    """Per-lane regularity of a Householder R factor (the lu_ok twin)."""
    diag = torch.abs(torch.diagonal(r, dim1=-2, dim2=-1))
    scale = torch.abs(r).amax(dim=(-2, -1))
    tol = torch.finfo(r.dtype).eps * r.shape[-1] * 32.0
    return torch.isfinite(r).all(dim=-1).all(dim=-1) & \
        (diag.amin(dim=-1) > tol * torch.clamp(scale, min=1e-30))


def _qr_factor_all(tab, h, jac, mass=None):
    """Householder QR of every stage iteration matrix, the per-lane rescue
    of a broken LU (Options.qr_fallback). Returns (vs_r, r_r [M, D, D],
    vs_c, r_c [M, P, 2D, 2D], ok [M])."""
    a_real, blocks = _build_iter_matrices(tab, h, jac, mass)
    vs_r, r_r = qr_factor(a_real)
    ok = _qr_reg_ok(r_r)
    vs_cs, r_cs = [], []
    for block in blocks:
        vs_c, r_c = qr_factor(block)
        ok = ok & _qr_reg_ok(r_c)
        vs_cs.append(vs_c)
        r_cs.append(r_c)
    dim = jac.shape[-1]
    if vs_cs:
        return (vs_r, r_r, torch.stack(vs_cs, dim=1),
                torch.stack(r_cs, dim=1), ok)
    vs_c = jac.new_zeros(jac.shape[:-2] + (0, 2 * dim, 2 * dim))
    return vs_r, r_r, vs_c, vs_c, ok


def _with_qr(solve_real, solve_cplx, use_qr, vs_r, r_r, vs_c, r_c):
    """The stage solvers with the lanes in use_qr [M] solved through their
    Householder factors instead of the LU."""
    def real(b):
        return torch.where(use_qr[:, None], qr_solve(vs_r, r_r, b),
                           solve_real(b))

    def cplx(p, b):
        return torch.where(use_qr[:, None], qr_solve(vs_c[:, p], r_c[:, p], b),
                           solve_cplx(p, b))

    return real, cplx


STEP_ARGS_GUARD = ("step_args= does not compose with tangents=, the "
                   "adjoint's mesh (_mesh_size) or dense= (slab rows are "
                   "step-indexed and a replay has no slab index); seed the "
                   "slab leaves through torch.func.jvp, or use time-indexed "
                   "controls")


def solve_radau(f: Callable, t0, tf, y0, args=None,
                options: Optional[Options] = None, t_eval=None,
                jac: Optional[Callable] = None, mass=None,
                events=None, tangents=None,
                args_tangents=None, quad: Optional[Callable] = None,
                dense: int = 0, step_args=None, _mesh_size: int = 0,
                _h0=None, device=None) -> cm.Solution:
    """Batched adaptive Radau IIA solve (fixed stage count = options.min_stages).

    f(t [M], y [M, D], args) -> [M, D]; y0 [M, D]. A torch y0 solves on its
    own device; any other y0 goes to ``device``, by default the CUDA card
    (with no card, pass a CPU tensor or device='cpu'). tangents: optional [K, M, D] seed directions for forward
    sensitivities by internal differentiation (one primal solve + K linear
    tangent sweeps per accepted step reusing the step's LU factors); result
    in ``Solution.sens`` [K, M, D]. args_tangents: optional pytree matching
    ``args`` with a leading K axis (parameter seed directions).

    mass: optional mass matrix [D, D] or per lane [M, D, D] of M·y' = f,
    singular allowed (index-1 DAEs; higher index with Options(nind1/2/3)).
    Options(stage_solver='gmres'|'tridiag') solves the stage systems
    matrix-free (module docstring); f must then be traceable by
    ``torch.func.jvp`` and jac= is refused.

    t_eval: optional shared output grid [T]; ``Solution.ys`` [M, T, D] holds
    the collocation interpolant at every grid point a lane stepped over (NaN
    elsewhere), and with tangents ``Solution.sens_ys`` [K, M, T, D] its
    tangent. quad: optional running-cost integrand
    ``l(t [M], y [M, D], args) -> [M]`` or ``[M, Q]``; ``Solution.quad``
    accumulates ∫ l dt at the step's own Radau quadrature (nodes c, weights
    b), and with tangents ``Solution.sens_quad`` [K, M(, Q)] carries
    dq_k = ∫ l_y·yd_k + l_θ·dθ_k dt. The quadrature never feeds back into
    step control or the state; for reverse-mode gradients of integral costs
    use ``radau_adjoint(cost=...)``. dense: step-mesh capacity N > 0 stores
    every accepted step's collocation polynomial so that
    ``Solution.interpolate(ts)`` evaluates the solution anywhere afterwards;
    size N ≥ the worst lane's accepted-step count (overflowing lanes
    interpolate to NaN). ``_mesh_size`` and ``_h0`` (a signed per-lane first
    step, 0 = automatic) are the adjoint's seats for the same mesh and for
    chained segments.

    events: ``solve.events.Event`` spec(s) (or plain callables, terminal),
    located on each accepted step's collocation polynomial.
    ``Solution.event_t`` / ``event_y`` / ``event_idx`` hold each lane's first
    event (a terminal one overrides), a terminal event stops the lane at t*
    with status EVENT_TERMINATED, ``ys`` / ``sens_ys`` samples past t* are
    NaN and ``quad`` ends at t*. With tangents a terminated lane returns the
    total derivative at the event, yd(t*) + ẏ*·dt*_k with dt*_k =
    −(g_y·yd_k + g_θ·dθ_k)/(g_t + g_y·ẏ*) and ẏ* = M⁻¹f(t*, y*) (mass
    invertible), and ``Solution.sens_t`` [K, M] holds dt*_k.

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
    use_gmres = opts.stage_solver != "lu"
    if use_gmres and jac is not None:
        raise ValueError("stage_solver='gmres' is matrix-free (J·v by jvp, "
                         "3-probe tridiagonal preconditioner); drop jac=")
    use_slabs = step_args is not None
    if use_slabs and (tangents is not None or args_tangents is not None
                      or _mesh_size or dense):
        raise ValueError(STEP_ARGS_GUARD)
    use_qr_fb = opts.qr_fallback and not use_gmres
    # dense= is the public face of the adjoint's step-mesh rings: store every
    # accepted step's collocation polynomial for Solution.interpolate()
    mesh_size = max(int(_mesh_size), int(dense))

    s = opts.min_stages
    tab = radau_tableau(s)
    t0, tf, y0 = cm.broadcast_batch(t0, tf, y0, device)
    m, dim = y0.shape
    dtype, dev = y0.dtype, y0.device
    npair = (s - 1) // 2
    syncs = cm._HostSyncs()

    use_kernel = opts.kernel_lu and not use_gmres
    refuse_kernel_derivatives(use_kernel, "solve_radau", y0, t0, tf, args,
                              tangents, args_tangents, mass, step_args)
    factor = _kernel_lu_factor if use_kernel else None
    if use_gmres:
        jac_fn = precond_probe_fn(f, opts.precond, opts.precond_block, dim)
        gmres_iters = 0 if opts.stage_solver == "tridiag" \
            else opts.gmres_iters
    else:
        jac_fn = jac if jac is not None else default_jacobian(f)
    if mass is not None:
        mass = cm.like(mass, y0)
        if tuple(mass.shape) not in ((dim, dim), (m, dim, dim)):
            raise ValueError(f"mass must be [{dim}, {dim}] or [{m}, {dim}, "
                             f"{dim}], got {tuple(mass.shape)}")
    newton_tol = (opts.newton_tol if opts.newton_tol > 0
                  else cm.derived_newton_tol(dtype, opts.rtol))
    max_iter = opts.newton_max_iter
    p_mat = torch.as_tensor(tab.p, dtype=dtype, device=dev)
    e_vec = torch.as_tensor(tab.e, dtype=dtype, device=dev)
    c_nodes = torch.as_tensor(tab.c, dtype=dtype, device=dev)
    ind_exp, use_index = cm.index_weights(opts, dim, dtype, dev)
    mdot = _mass_dot(mass)

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
    # per-direction parameter tangents for the joint jvp's
    args_rows = [None] * yd.shape[0] if args_d is None else \
        [cm.tree_map(lambda a, _k=k: a[_k], args_d) for k in range(yd.shape[0])]

    if use_slabs:
        # a lane's k-th accepted-step attempt evaluates every stage, the
        # Jacobian and the error estimate's f under slab row k, as f(t, y,
        # (args, slab_k)); events and quad see the plain args
        n_slabs, slab_at = cm.make_slab_selector(step_args, y0)
        args0 = (args, slab_at(torch.zeros((m,), dtype=torch.int32,
                                           device=dev)))
    else:
        args0 = args
    f0 = f(t0, y0, args0)
    specs = normalize_events(events)
    ev = init_event_state(specs, m, dim, t0, y0, args)
    td = y0.new_zeros((yd.shape[0], m))     # dt*_k of the IND event jump
    direction = torch.where(tf >= t0, 1.0, -1.0).to(dtype)
    if opts.h0 != 0.0 and _h0 is None:
        h_st = torch.full((m,), opts.h0, dtype=dtype, device=dev) * direction
    elif mass is None:
        h_st = cm.initial_step(f, t0, y0, f0, tf, s, opts.rtol, opts.atol,
                               args0, opts.max_step)
    else:
        # Hairer's hinit treats f0 as a derivative, which is wrong for the
        # algebraic rows of a singular-mass system: start small and let the
        # controller grow
        h_st = torch.clamp(torch.abs(tf - t0) * 1e-2, max=1e-3) * direction
    if _h0 is not None:
        # signed per-lane warm start (segment chaining in solve.adjoint);
        # lanes with _h0 == 0 keep the automatic step, and the in-loop
        # boundary clamp bounds the rest by |tf - t|
        h_mag = torch.abs(cm.like(_h0, y0).broadcast_to((m,)))
        h_st = torch.where(h_mag > 0, h_mag * direction, h_st)

    use_dense = t_eval is not None
    if use_dense:
        t_eval = cm.like(t_eval, y0)
        at_t0 = t_eval[None, :] == t0[:, None]
        out_ys = torch.where(at_t0[..., None], y0[:, None, :], torch.nan)
        if use_sens:
            out_sd = torch.where(at_t0[None, :, :, None], yd[:, :, None, :],
                                 torch.nan)

    use_quad = quad is not None
    use_quad_sens = use_quad and use_sens
    if use_quad:
        b_vec = torch.as_tensor(tab.b, dtype=dtype, device=dev)
        qshape = tuple(quad(t0, y0, args).shape)
        if qshape != (m,) and (len(qshape) != 2 or qshape[0] != m):
            raise ValueError(f"quad must return [M] or [M, Q] with M={m}, "
                             f"got {qshape}")
        quad_scalar = len(qshape) == 1

        def qla(tt, yy, aa):                  # args-open variant (jvp seat)
            return cm.canon_cost(quad(tt, yy, aa))

        q_acc = y0.new_zeros((m, 1 if quad_scalar else qshape[1]))
        if use_quad_sens:
            qd_acc = y0.new_zeros((yd.shape[0],) + tuple(q_acc.shape))

    mesh = None
    if mesh_size:
        # accepted-step rings for the continuous-adjoint backward pass
        # (solve.adjoint) and Solution.interpolate: step start t, signed h,
        # start state, and the dense-output polynomial of every accepted step
        mesh = {"t": y0.new_zeros((m, mesh_size)),
                "h": y0.new_zeros((m, mesh_size)),
                "y": y0.new_zeros((m, mesh_size, dim)),
                "q": y0.new_zeros((m, mesh_size, s, dim))}

    stats = cm.zero_stats(m, ("nfev", "njev", "nlu", "nsteps", "naccept",
                              "nreject", "nnewton"), dev)
    stats["nfev"] = stats["nfev"] + 2

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    t, y = t0, y0
    t_lo, y_lo = zeros(m), zeros(m, dim)
    if use_gmres:
        # the carried "Jacobian" is the probed preconditioner data, and the
        # frozen linearization point of J·v moves with it; nothing to factor
        pb = opts.precond_block
        jac_m = zeros(m, dim // pb, pb, pb) if opts.precond == "block" \
            else zeros(m, 3, dim)
        t_lin, y_lin = t0, y0
    else:
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
    dyn = init_dyn(m, opts.record_steps, y0,
                   dim if opts.record_states else 0)
    if use_qr_fb:
        qr_vs_r, qr_r_r = zeros(m, dim, dim), zeros(m, dim, dim)
        qr_vs_c = zeros(m, npair, 2 * dim, 2 * dim)
        qr_r_c = zeros(m, npair, 2 * dim, 2 * dim)
        use_qr = zeros(m, dt=torch.bool)
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

        if use_slabs:
            exhausted = active & (stats["naccept"] >= n_slabs)
            fa = (args, slab_at(stats["naccept"]))
        else:
            exhausted = None
            fa = args

        # ---- Jacobian refresh (lanes that need it) -----------------------
        needj = need_jac & active
        with scope("radau.jacobian"):
            jnew = jac_fn(t, y, fa)
            jmat = torch.where(needj.reshape((m,) + (1,) * (jnew.ndim - 1)),
                               jnew, jac_m)
        current_jac = current_jac | needj

        # ---- factorization (lanes that need it) --------------------------
        needf = active & (needj | (h != h_fact))
        h_fact_now = torch.where(needf, h, h_fact)
        if use_gmres:
            t_lin = torch.where(needj, t, t_lin)
            y_lin = torch.where(needj[:, None], y, y_lin)
            fact_ok = torch.isfinite(jmat).flatten(1).all(dim=1)
            # rebuilt every attempt from the CURRENT h (no factors to reuse)
            solve_real, solve_cplx = _gmres_stage_solver(
                tab, f, t_lin, y_lin, fa, jmat, h, mass, gmres_iters,
                precond=opts.precond, block=opts.precond_block)
        else:
            with scope("radau.factorize"):
                lr, pr, lc, pc, ok = _factorize(tab, h, jmat, mass,
                                                opts.pivoting, factor=factor)
                lu_r = torch.where(needf[:, None, None], lr, lu_real)
                piv_r = torch.where(needf[:, None], pr, piv_real)
                lu_c = torch.where(needf[:, None, None, None], lc, lu_cplx)
                piv_c = torch.where(needf[:, None, None], pc, piv_cplx)
            lu_real, piv_real, lu_cplx, piv_cplx = lu_r, piv_r, lu_c, piv_c
            fact_ok = torch.where(needf, ok, True)
            if use_kernel:
                def solve_real(b, _lu=lu_r):
                    return _kernel_lu_solve(_lu, b)

                def solve_cplx(p, b, _lu=lu_c):
                    return _kernel_lu_solve(_lu[:, p], b)
            else:
                def solve_real(b, _lu=lu_r, _piv=piv_r):
                    return lu_solve(_lu, _piv, b, pivot=opts.pivoting)

                def solve_cplx(p, b, _lu=lu_c, _piv=piv_c):
                    return lu_solve(_lu[:, p], _piv[:, p], b,
                                    pivot=opts.pivoting)

        if use_qr_fb:
            # per-lane QR rescue of a broken LU: one host read an attempt
            # (did a fresh factorization fail; does a lane still solve by
            # QR), where the reference gates with lax.cond
            with scope("radau.qr_fallback"):
                lu_fail = needf & ~fact_ok
                any_fail, any_kept = syncs.any_each(lu_fail, use_qr & ~needf)
                if any_fail:
                    vs_r, r_r, vs_c, r_c, qok = _qr_factor_all(tab, h, jmat,
                                                               mass)
                    qr_vs_r = torch.where(lu_fail[:, None, None], vs_r,
                                          qr_vs_r)
                    qr_r_r = torch.where(lu_fail[:, None, None], r_r, qr_r_r)
                    qr_vs_c = torch.where(lu_fail[:, None, None, None], vs_c,
                                          qr_vs_c)
                    qr_r_c = torch.where(lu_fail[:, None, None, None], r_c,
                                         qr_r_c)
                    qr_new = lu_fail & qok
                else:
                    qr_new = torch.zeros_like(lu_fail)
            # freshly factored lanes take this factorization's mode; the
            # others keep the mode of their live factors
            use_qr = torch.where(needf, qr_new, use_qr)
            fact_ok = fact_ok | qr_new
            if any_fail or any_kept:
                solve_real, solve_cplx = _with_qr(
                    solve_real, solve_cplx, use_qr, qr_vs_r, qr_r_r,
                    qr_vs_c, qr_r_c)

        singular = active & ~fact_ok

        # ---- Newton warm start from previous collocation polynomial ------
        theta_ws = 1.0 + c_nodes[None, :] * (h / h_prev)[:, None]   # [M,s]
        powers = torch.stack([_ipow(theta_ws, q + 1) for q in range(s)],
                             dim=-1)
        poly_at = cm.lane_einsum("msq,mqd->msd", powers, q_poly)
        poly_at_1 = torch.sum(q_poly, dim=1)         # poly(1) = Σ_q Q_q
        z0 = torch.where(have_sol[:, None, None],
                         poly_at - poly_at_1[:, None, :], 0.0)

        # ---- simplified Newton -------------------------------------------
        scale_n = opts.atol + opts.rtol * torch.abs(y)
        if use_index:
            scale_n = scale_n / torch.abs(h)[:, None] ** ind_exp[None, :]
        run_newton = active & fact_ok
        if use_slabs:
            run_newton = run_newton & ~exhausted
        with scope("radau.newton"):
            z, nconv, niter, nfev, rate = _newton(
                tab, f, t, y, h, z0, scale_n, newton_tol, solve_real,
                solve_cplx, run_newton, max_iter, fa, syncs, mass=mass)
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
        ze = mdot(cm.lane_einsum("s,msd->md", e_vec, z) / h[:, None])
        # f0 was evaluated under the previous step's slab row: again under
        # this attempt's row
        # in the plain LU's [M, D] row-major layout (K2's comes back
        # transposed): on the card a reduction's order follows the layout,
        # and the norm below must add alike on either route
        err1 = solve_real((f(t, y, fa) if use_slabs else f0) + ze
                          ).contiguous()
        scale_e = opts.atol + opts.rtol * torch.maximum(torch.abs(y),
                                                        torch.abs(y_new))
        if use_index:
            scale_e = scale_e / torch.abs(h)[:, None] ** ind_exp[None, :]
        enorm1 = cm.rms_norm(err1, scale_e)
        enorm1 = torch.where(torch.isfinite(enorm1), enorm1, 1e10)

        refine = conv & rejected & (enorm1 > 1.0)
        if use_gmres and not syncs.any(refine):
            enorm = enorm1
        else:
            err2 = solve_real(f(t, y + err1, fa) + ze).contiguous()
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
        # the ratio is 1 where it is not used: 0 ** expo would send an
        # infinite derivative into the unselected branch (NaN in reverse)
        mult = torch.where(
            have_old,
            h_abs / torch.where(h_old == 0, 1.0, h_old)
            * torch.where(have_old,
                          err_old / torch.where(enorm == 0, 1.0, enorm),
                          1.0) ** expo,
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
        f_new = torch.where(accept[:, None], f(t_new, y_new, fa), f0)

        # ---- internal-differentiation tangent sweep -----------------------
        if use_sens:
            zd = _tangent_stages(tab, f, t, y, h, z, yd, newton_tol,
                                 solve_real, solve_cplx, accept, args, syncs,
                                 args_d=args_d, mass=mass)
            yd_old = yd
            yd = torch.where(accept[None, :, None], yd + zd[:, :, -1, :], yd)
            # tangent of the collocation interpolant: the same θ-polynomial
            # in Zd
            qd = cm.lane_einsum("kmsd,sq->kmqd", zd, p_mat)

        # ---- dense output & warm-start polynomial -------------------------
        q_new = cm.lane_einsum("msd,sq->mqd", z, p_mat)  # [M, θ-power, D]
        q_poly = torch.where(accept[:, None, None], q_new, q_poly)

        def interp(theta):                   # [M, T] -> [M, T, D]
            tp = torch.stack([theta ** (q + 1) for q in range(s)], dim=-1)
            return y[:, None, :] + cm.lane_einsum("mtq,mqd->mtd", tp,
                                                  q_new)

        if use_dense:
            inside, tpow = cm.dense_window(t_eval, t, h, accept, s)
            out_ys = torch.where(
                inside[..., None],
                y[:, None, :] + cm.lane_einsum("mtq,mqd->mtd", tpow, q_new),
                out_ys)
            if use_sens:
                out_sd = torch.where(
                    inside[None, :, :, None],
                    yd_old[:, :, None, :]
                    + cm.lane_einsum("mtq,kmqd->kmtd", tpow, qd), out_sd)

        # ---- events --------------------------------------------------------
        ev, terminate, t_ev, y_ev, ev_idx = handle_events(
            specs, ev, t, h, t_new, y_new, interp, accept, args, syncs)
        if specs:
            if use_dense:
                out_ys = cm.mask_dense_after_event(out_ys, t_eval, terminate,
                                                   t_ev, h)
                if use_sens:
                    out_sd = cm.mask_dense_after_event(out_sd, t_eval,
                                                       terminate, t_ev, h)
        # the fraction of the step up to t* (1 on lanes that go on)
        th_e = torch.where(terminate, torch.clamp(
            (t_ev - t) / torch.where(h == 0.0, 1.0, h), 0.0, 1.0), 1.0) \
            if specs else torch.ones_like(h)
        if use_sens and specs:
            yd, dts = _event_tangent_jump(
                specs, f, t_ev, y_ev, args, args_rows, mass, use_gmres,
                opts.gmres_iters, yd_old, qd, th_e, ev_idx, terminate, yd)
            td = torch.where(terminate[None, :], dts, td)

        # ---- running-cost quadrature --------------------------------------
        if use_quad:
            # the step's own Radau quadrature on the collocation polynomial:
            # q += θ*·h·Σ_i b_i·l(t + θ*·c_i·h, y(θ*·c_i)); θ* = 1 off the
            # event lanes, where y(c_i) = y + Z_i are the converged stages
            th_i = th_e[:, None] * c_nodes[None, :]              # [M, s]
            y_i = interp(th_i)
            y_st = [torch.where(terminate[:, None], y_i[:, i], y + z[:, i, :])
                    for i in range(s)]
            t_st = [t + th_i[:, i] * h for i in range(s)]
            vals = torch.stack([qla(t_st[i], y_st[i], args)
                                for i in range(s)], dim=1)      # [M, s, Q]
            h_q = th_e * h
            inc = h_q[:, None] * cm.lane_einsum("s,msq->mq", b_vec, vals)
            q_acc = q_acc + torch.where(accept[:, None], inc, 0.0)
            if use_quad_sens:
                # stage tangents off the tangent polynomial at the nodes:
                # yd(θ) = yd + Σ_q θ^{q+1}·Qd_q
                tpow_s = torch.stack([th_i ** (q + 1) for q in range(s)],
                                     dim=1)                      # [M, q, s]
                yd_st = yd_old[:, :, None, :] + cm.lane_einsum(
                    "kmqd,mqs->kmsd", qd, tpow_s)

                def ldot(i, k):
                    # tangent of the integrand: l_y·yd (+ l_θ·dθ_k)
                    if args_rows[k] is None:
                        return jvp(lambda yy: qla(t_st[i], yy, args),
                                   (y_st[i],), (yd_st[k, :, i, :],))[1]
                    return jvp(lambda yy, aa: qla(t_st[i], yy, aa),
                               (y_st[i], args),
                               (yd_st[k, :, i, :], args_rows[k]))[1]

                ld = torch.stack([torch.stack([ldot(i, k) for i in range(s)],
                                              dim=1)
                                  for k in range(yd.shape[0])])  # [K,M,s,Q]
                inc_d = h_q[None, :, None] * cm.lane_einsum("s,kmsq->kmq",
                                                          b_vec, ld)
                if specs:
                    # the moving endpoint: + l(t*, y*)·dt*_k
                    inc_d = inc_d + torch.where(
                        terminate[None, :, None],
                        td[:, :, None] * qla(t_ev, y_ev, args)[None], 0.0)
                qd_acc = qd_acc + torch.where(accept[None, :, None], inc_d,
                                              0.0)

        dyn = record_step(dyn, run_newton | singular, t, h, enorm, niter,
                          accept, y=torch.where(accept[:, None], y_new, y)
                          if opts.record_states else None)

        if mesh is not None:
            # record the accepted step into slot naccept: each slot is
            # written once, by index (no host sync); steps past the capacity
            # are dropped, and naccept > capacity is what the adjoint pass
            # and interpolate() detect
            cm.ring_write(mesh, stats["naccept"], accept,
                          {"t": t, "h": h, "y": y, "q": q_new})

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
        if use_slabs:
            status = torch.where(exhausted, cm.PARAMS_EXHAUSTED, status)
            active = active & ~exhausted
        status = torch.where(terminate, cm.EVENT_TERMINATED, status)
        active = active & ~done & ~exceeded & ~underflow & ~stall & ~terminate

        # a lane stopped by an event rests at (t*, y*) with no remainder
        t = torch.where(accept, torch.where(terminate, t_ev, t_new), t)
        y = torch.where(accept[:, None],
                        torch.where(terminate[:, None], y_ev, y_new), y)
        t_lo = torch.where(accept & ~terminate, t_lo_new,
                           torch.where(terminate, 0.0, t_lo))
        y_lo = torch.where((accept & ~terminate)[:, None], y_lo_new,
                           torch.where(terminate[:, None], 0.0, y_lo))
        f0 = f_new
        jac_m = jmat
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
    def scalar_q(q):
        return q[..., 0] if quad_scalar else q

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
        quad=scalar_q(q_acc) if use_quad else None,
        sens_quad=scalar_q(qd_acc) if use_quad_sens else None,
        sens_t=td if (use_sens and specs) else None)


solve_radau.host_syncs = 0
