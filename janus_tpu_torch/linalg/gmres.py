"""Batched GMRES and tridiagonal solves for the implicit-stage systems.

The port of ``janus_tpu/linalg/gmres.py``: a fixed-depth right-preconditioned
GMRES(k) whose Arnoldi and Givens recurrences are unrolled in Python and whose
inner products are batched over the M lanes (every lane runs the same k
iterations in lockstep), and the tridiagonal solves that precondition it:
Thomas sweeps (sequential in N, two passes) and parallel cyclic reduction
(PCR: ceil(log2 N) full-width sweeps), real and split-real complex.

Breakdown-safe: zero residual or lucky breakdown produce zero rotations and a
finite solution rather than NaN. Exhaustion-safe: when the Arnoldi depth
exceeds a lane's Krylov dimension (k > N: the depth is shared by every lane)
the new direction's norm collapses to ~eps·‖A·P⁻¹v‖ rather than exactly 0, and
without a guard the back substitution divides two O(eps) numbers. A RELATIVE
breakdown test zeroes the basis vector and subdiagonal from that column on,
per lane, and a rank test pins the matching coefficient to 0.

The order of operations is the reference's (modified Gram–Schmidt, one column
at a time), so that the two packages can be compared step by step.

Which tridiagonal algorithm ``tridiag_solve_auto`` runs follows the tensor it
is given: Thomas on a CPU tensor, ``CUDA_TRIDIAG`` on a CUDA tensor (the one
measured faster on an H100, see PERF.md); ``method=`` overrides it.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

# The tridiagonal algorithm on a CUDA tensor. Measured on an NVIDIA H100
# 80GB HBM3 (700 W) at D=128 in f64 by ``janus_tpu_torch.bench.mol``: PCR's 7
# full-width sweeps against Thomas's 256 sequential [M]-wide steps, each a few
# launches: real 2.9 against 14.9 ms and complex 6.8 against 53.0 ms at
# M=1,024; 12.2 against 15.1 and 43.0 against 55.5 ms at M=65,536 (PERF.md).
CUDA_TRIDIAG = "pcr"


def _safe(x):
    return torch.where(x == 0.0, 1.0, x)


def gmres_batched(matvec: Callable, b, precond: Optional[Callable] = None,
                  iters: int = 20):
    """Solve A x = b per batch lane with right-preconditioned GMRES(k).

    matvec : v [M, N] -> A·v [M, N]   (each lane's independent operator)
    b      : [M, N]
    precond: optional v -> P⁻¹·v      (right preconditioning: A·P⁻¹ u = b)
    iters  : k, the (static) Arnoldi depth; there is no restart.

    Returns (x [M, N], resnorm [M]) where resnorm is the Givens residual
    estimate ‖b − A·x‖₂ per lane.
    """
    pc = precond if precond is not None else (lambda v: v)

    def nrm(v):
        return torch.sqrt(torch.sum(v * v, dim=-1))

    beta = nrm(b)                                    # [M]
    v_basis = [b / _safe(beta)[:, None]]
    r_cols = []                                      # R's upper columns
    cs, sn = [], []
    g = []                                           # rotated rhs entries
    colnorm = []                                     # [M] Hessenberg col scale
    gj = beta
    eps = torch.finfo(b.dtype).eps
    for j in range(iters):
        w = matvec(pc(v_basis[j]))
        wn0 = nrm(w)                                 # pre-MGS column scale
        # modified Gram–Schmidt
        hcol = []
        for i in range(j + 1):
            hij = torch.sum(w * v_basis[i], dim=-1)
            hcol.append(hij)
            w = w - hij[:, None] * v_basis[i]
        hnext = nrm(w)
        # relative breakdown/exhaustion test (module docstring): a direction
        # that survived MGS at ~eps of its own scale is rounding noise, not a
        # Krylov vector: kill it and every later column for that lane
        ok_j = hnext > (64.0 * eps) * wn0
        hnext = torch.where(ok_j, hnext, 0.0)
        v_basis.append(torch.where(ok_j[:, None], w / _safe(hnext)[:, None],
                                   0.0))
        # Hessenberg column scale for the rank test in back substitution
        colnorm.append(torch.sqrt(sum(h * h for h in hcol) + hnext * hnext))
        # previous Givens rotations on the new column
        hc = list(hcol)
        for i in range(j):
            t1 = cs[i] * hc[i] + sn[i] * hc[i + 1]
            t2 = -sn[i] * hc[i] + cs[i] * hc[i + 1]
            hc[i], hc[i + 1] = t1, t2
        # new rotation eliminating the subdiagonal
        denom = torch.sqrt(hc[j] * hc[j] + hnext * hnext)
        c = torch.where(denom == 0.0, 1.0, hc[j] / _safe(denom))
        s = torch.where(denom == 0.0, 0.0, hnext / _safe(denom))
        cs.append(c)
        sn.append(s)
        hc[j] = c * hc[j] + s * hnext
        r_cols.append(hc)
        g.append(c * gj)
        gj = -s * gj
    # back substitution R y = g. Rank test per column: a pivot at noise
    # level relative to its own Hessenberg column (breakdown or exhaustion)
    # gets y pinned to 0, the minimal-norm choice; a healthy pivot on a
    # breakdown column (e.g. A = I: h₀₀ = 1, hnext = 0) is kept
    y = [torch.zeros_like(beta)] * iters
    for j in reversed(range(iters)):
        acc = g[j]
        for i in range(j + 1, iters):
            acc = acc - r_cols[i][j] * y[i]
        rjj = r_cols[j][j]
        rank_ok = torch.abs(rjj) > (64.0 * eps) * colnorm[j]
        y[j] = torch.where(rank_ok, acc / _safe(rjj), 0.0)
    u = sum(y[j][:, None] * v_basis[j] for j in range(iters))
    x = pc(u)
    return x, torch.abs(gj)


def _cdiv(ar, ai, br, bi):
    den = _safe(br * br + bi * bi)
    return (ar * br + ai * bi) / den, (ai * br - ar * bi) / den


def _cmul(xr, xi, yr, yi):
    return xr * yr - xi * yi, xr * yi + xi * yr


def tridiag_solve(dl, d, du, b):
    """Batched Thomas algorithm: solve T x = b with T tridiagonal.

    dl/d/du/b: [..., N] (dl[..., 0] and du[..., -1] ignored). Sequential in
    N: two sweeps of N steps, each step [...]-wide. No pivoting
    (preconditioner use)."""
    n = d.shape[-1]
    dl_, d_, du_, b_ = (a.unbind(-1) for a in torch.broadcast_tensors(
        dl, d, du, b))
    cp = dp = torch.zeros_like(d_[0])
    cps, dps = [], []
    # forward sweep: cp[i] = du[i]/(d[i]-dl[i]*cp[i-1]), dp likewise
    for i in range(n):
        denom = _safe(d_[i] - dl_[i] * cp)
        cp, dp = du_[i] / denom, (b_[i] - dl_[i] * dp) / denom
        cps.append(cp)
        dps.append(dp)
    # back substitution: x[i] = dp[i] - cp[i] * x[i+1]
    x = torch.zeros_like(dp)
    xs = [None] * n
    for i in reversed(range(n)):
        x = dps[i] - cps[i] * x
        xs[i] = x
    return torch.stack(xs, dim=-1)


def tridiag_solve_complex(dl, d, du, b):
    """Batched complex Thomas sweep in split-real form.

    dl, d, du, b: pairs (re, im) of [..., N] tensors (dl[...,0], du[...,-1]
    ignored); returns the pair (x_re, x_im). No pivoting."""
    n = d[0].shape[-1]
    dlr, dli, dr, di, dur, dui, br, bi = (
        a.unbind(-1) for a in torch.broadcast_tensors(*dl, *d, *du, *b))
    cpr = cpi = dpr = dpi = torch.zeros_like(dr[0])
    fwd = []
    for i in range(n):
        # denom = d - dl*cp
        tr = dr[i] - (dlr[i] * cpr - dli[i] * cpi)
        ti = di[i] - (dlr[i] * cpi + dli[i] * cpr)
        # dp = (b - dl*dp_prev) / denom
        sr = br[i] - (dlr[i] * dpr - dli[i] * dpi)
        si = bi[i] - (dlr[i] * dpi + dli[i] * dpr)
        cpr, cpi = _cdiv(dur[i], dui[i], tr, ti)
        dpr, dpi = _cdiv(sr, si, tr, ti)
        fwd.append((cpr, cpi, dpr, dpi))
    xr = xi = torch.zeros_like(dpr)
    xrs, xis = [None] * n, [None] * n
    for i in reversed(range(n)):
        c_r, c_i, p_r, p_i = fwd[i]
        xr, xi = p_r - (c_r * xr - c_i * xi), p_i - (c_r * xi + c_i * xr)
        xrs[i], xis[i] = xr, xi
    return torch.stack(xrs, dim=-1), torch.stack(xis, dim=-1)


def _shift_right(x, s, fill):
    """x moved s places towards higher indices along the last axis."""
    return F.pad(x[..., :-s], (s, 0), value=fill)


def _shift_left(x, s, fill):
    return F.pad(x[..., s:], (0, s), value=fill)


def _zero_ends(dl, du):
    """dl with dl[..., 0] and du with du[..., -1] set to 0."""
    n = dl.shape[-1]
    idx = torch.arange(n, device=dl.device)
    return (torch.where(idx == 0, 0.0, dl),
            torch.where(idx == n - 1, 0.0, du))


def tridiag_solve_pcr(dl, d, du, b):
    """Batched tridiagonal solve by PARALLEL CYCLIC REDUCTION.

    Same contract as ``tridiag_solve``, but the elimination is ceil(log2 N)
    fully vectorized sweeps over the whole [..., N] tensor instead of two
    sequential length-N sweeps: each sweep eliminates the couplings at
    stride s (doubling s), leaving a diagonal system."""
    n = d.shape[-1]
    a, c = _zero_ends(dl, du)
    bb, dd = d, b
    s = 1
    while s < n:
        am, bm = _shift_right(a, s, 0.0), _shift_right(bb, s, 1.0)
        cm, dm = _shift_right(c, s, 0.0), _shift_right(dd, s, 0.0)
        ap, bp = _shift_left(a, s, 0.0), _shift_left(bb, s, 1.0)
        cp, dp = _shift_left(c, s, 0.0), _shift_left(dd, s, 0.0)
        alpha = -a / _safe(bm)                 # eliminate x_{i-s} via row i-s
        gamma = -c / _safe(bp)                 # eliminate x_{i+s} via row i+s
        bb = bb + alpha * cm + gamma * ap
        dd = dd + alpha * dm + gamma * dp
        a = alpha * am
        c = gamma * cp
        s *= 2
    return dd / _safe(bb)


def tridiag_solve_complex_pcr(dl, d, du, b):
    """Split-real complex twin of ``tridiag_solve_pcr``; same contract as
    ``tridiag_solve_complex``."""
    br_, bi_ = d
    fr, fi = b
    ar, cr = _zero_ends(dl[0], du[0])
    ai, ci = _zero_ends(dl[1], du[1])
    n = br_.shape[-1]
    s = 1
    while s < n:
        def sr(x, fill=0.0, _s=s):
            return _shift_right(x, _s, fill)

        def sl(x, fill=0.0, _s=s):
            return _shift_left(x, _s, fill)

        alr, ali = _cdiv(-ar, -ai, sr(br_, 1.0), sr(bi_))
        gar, gai = _cdiv(-cr, -ci, sl(br_, 1.0), sl(bi_))
        t1r, t1i = _cmul(alr, ali, sr(cr), sr(ci))
        t2r, t2i = _cmul(gar, gai, sl(ar), sl(ai))
        u1r, u1i = _cmul(alr, ali, sr(fr), sr(fi))
        u2r, u2i = _cmul(gar, gai, sl(fr), sl(fi))
        ar_n, ai_n = _cmul(alr, ali, sr(ar), sr(ai))
        cr_n, ci_n = _cmul(gar, gai, sl(cr), sl(ci))
        br_, bi_ = br_ + t1r + t2r, bi_ + t1i + t2i
        fr, fi = fr + u1r + u2r, fi + u1i + u2i
        ar, ai, cr, ci = ar_n, ai_n, cr_n, ci_n
        s *= 2
    return _cdiv(fr, fi, br_, bi_)


def _tridiag_method(ref, method):
    if method is None:
        return CUDA_TRIDIAG if ref.is_cuda else "thomas"
    if method not in ("thomas", "pcr"):
        raise ValueError(f"unknown tridiagonal method {method!r} "
                         "(use 'thomas' or 'pcr')")
    return method


def tridiag_solve_auto(dl, d, du, b, method: Optional[str] = None):
    """Tridiagonal solve by the algorithm that suits the tensor's device:
    Thomas on a CPU tensor (PCR does ~8× the operations), ``CUDA_TRIDIAG``
    on a CUDA tensor. method='thomas'|'pcr' overrides the choice."""
    if _tridiag_method(d, method) == "thomas":
        return tridiag_solve(dl, d, du, b)
    return tridiag_solve_pcr(dl, d, du, b)


def tridiag_solve_complex_auto(dl, d, du, b, method: Optional[str] = None):
    """Split-real complex twin of ``tridiag_solve_auto``."""
    if _tridiag_method(d[0], method) == "thomas":
        return tridiag_solve_complex(dl, d, du, b)
    return tridiag_solve_complex_pcr(dl, d, du, b)


def tridiag_bands_of(mat):
    """(dl, d, du) bands of an explicit batched matrix [M, N, N] (dl[...,0]
    and du[...,-1] zero-padded): the shared band-extraction convention for
    the tridiagonal preconditioners."""
    d_ = torch.diagonal(mat, dim1=-2, dim2=-1)
    dl_ = F.pad(torch.diagonal(mat, offset=-1, dim1=-2, dim2=-1), (1, 0))
    du_ = F.pad(torch.diagonal(mat, offset=1, dim1=-2, dim2=-1), (0, 1))
    return dl_, d_, du_


def mass_matvec(mass, m):
    """v [M, N] -> mass·v for a mass of shape [N, N] or [M, N, N]."""
    mm = mass if mass.ndim == 3 else mass.expand(m, *mass.shape)
    return lambda v: torch.einsum("mij,mj->mi", mm, v)


def gmres_dense_solve(mat, rhs, iters):
    """GMRES solve of an EXPLICIT batched matrix (mass / DAE blocks) with
    its own tridiagonal preconditioner: exact in one application for
    FEM-style tridiagonal blocks, and convergent for the diagonally
    dominant blocks MOL discretizations produce."""
    mb, n = rhs.shape
    mmb = mat if mat.ndim == 3 else mat.expand(mb, n, n)
    dl_, d_, du_ = tridiag_bands_of(mmb)
    return gmres_batched(mass_matvec(mmb, mb), rhs,
                         lambda v: tridiag_solve_auto(dl_, d_, du_, v),
                         iters)[0]
