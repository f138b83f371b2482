"""Fused SoA Radau5: the whole step attempt per lane as one CUDA kernel.

The port of ``janus_tpu/solve/radau_fused.py``. The state of every lane is
packed into the rows of one ``[n_rows, M]`` matrix (``_row_layout``: the
trajectory on the last axis, every state component a row), and one step
attempt -- Jacobian by forward mode of the inlined f, the pivot-free real
D×D and split-complex 2D×2D factors, the simplified Newton of at most
``NEWTON_MAXITER`` trips, the error estimate and the refined estimate, the
Gustafsson controller, status and counters -- updates those rows.

- On a CUDA tensor the attempt runs in the kernel K4 (``csrc/radau_fused.cu``
  through ``janus_tpu_torch.ops.radau_fused.radau5_step``), one thread per
  lane, for f registered in ``models.problems.DEVICE_PROBLEMS``; any other f
  raises. A launch runs up to ``MAX_ATTEMPTS`` attempts per lane (an
  inactive lane is a fixed point of the attempt), and the host loop repeats
  while any lane is active.
- ``_step_ref`` is the plain torch version of one attempt for any f; on a
  CPU tensor the op runs it, and the CPU tests hold it against the
  reference's kernel in interpret mode.

Scope as the reference: fixed s=3, identity mass, final state only, args
leaves of shape [M] or scalar. No padding of the batch is needed.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch
from torch.func import jvp

from janus_tpu_torch.solve import common as cm
from janus_tpu_torch.solve.options import Options
from janus_tpu_torch.solve.radau import _HostSyncs
from janus_tpu_torch.solve.radau_tables import radau_tableau

NEWTON_MAXITER = 6
MAX_ATTEMPTS = 32       # attempts per lane per K4 launch in the solve loop
STATS = ("nsteps", "naccept", "nreject", "nfev", "nnewton")


def _row_layout(dim: int):
    """Named row offsets into the packed state matrix."""
    rows = {}
    off = 0

    def add(name, n):
        nonlocal off
        rows[name] = off
        off += n

    add("t", 1)
    add("y", dim)
    add("f0", dim)
    add("h", 1)
    add("h_old", 1)
    add("err_old", 1)
    add("q", 3 * dim)          # collocation poly coeffs (warm start)
    add("h_prev", 1)
    # flags / counters kept as float rows (0/1 or small counts)
    add("active", 1)
    add("rejected", 1)
    add("have_sol", 1)
    add("nsing", 1)
    add("status", 1)
    add("nsteps", 1)
    add("naccept", 1)
    add("nreject", 1)
    add("nfev", 1)
    add("nnewton", 1)
    return rows, off


def _solve_lu_rows(lu, rhs, d):
    """Forward/back substitution on row-vector representation.
    lu: d×d list-of-lists of [M] vectors (packed L\\U); rhs: list of d [M]."""
    y = list(rhs)
    for i in range(1, d):
        for j in range(i):
            y[i] = y[i] - lu[i][j] * y[j]
    x = [None] * d
    for i in reversed(range(d)):
        acc = y[i]
        for j in range(i + 1, d):
            acc = acc - lu[i][j] * x[j]
        x[i] = acc / lu[i][i]
    return x


def _factor_rows(a, d):
    """In-place pivot-free elimination on row-vector matrix a (d×d of [M])."""
    for k in range(d):
        inv = _rdiv(1.0, a[k][k])
        for i in range(k + 1, d):
            m = a[i][k] * inv
            a[i][k] = m
            for j in range(k + 1, d):
                a[i][j] = a[i][j] - m * a[k][j]
    return a


def _rdiv(c: float, x):
    """c / x as a true division (torch's ``c / x`` multiplies c by x's
    reciprocal, which rounds twice)."""
    return x.new_tensor(c) / x


@dataclasses.dataclass(frozen=True)
class StepConsts:
    """The tableau (radau_tableau(3)) and controller constants of one solve,
    as Python floats; the kernel takes them by value."""

    mu_r: float
    mu_cr: float
    mu_ci: float
    c: Tuple[float, ...]                  # [3] nodes
    t_mat: Tuple[Tuple[float, ...], ...]  # [3][3]
    ti_mat: Tuple[Tuple[float, ...], ...]
    e: Tuple[float, ...]                  # [3] error weights
    p: Tuple[Tuple[float, ...], ...]      # [3][3] warm-start polynomial
    expo: float                           # controller exponent 1/(s+1)
    newton_tol: float
    eps: float
    rtol: float
    atol: float
    safety0: float
    facl: float
    facr: float
    quot1: float
    quot2: float
    max_steps: float
    newton_maxiter: int = NEWTON_MAXITER


def step_consts(opts: Options, dtype) -> StepConsts:
    tab = radau_tableau(3)

    def mat(a):
        return tuple(tuple(float(v) for v in row) for row in a)

    return StepConsts(
        mu_r=float(tab.mu_real), mu_cr=float(tab.mu_complex[0].real),
        mu_ci=float(tab.mu_complex[0].imag),
        c=tuple(float(c) for c in tab.c), t_mat=mat(tab.t_mat),
        ti_mat=mat(tab.ti_mat), e=tuple(float(e) for e in tab.e),
        p=mat(tab.p), expo=1.0 / (tab.s + 1),
        newton_tol=(opts.newton_tol if opts.newton_tol > 0
                    else cm.derived_newton_tol(dtype, opts.rtol)),
        eps=float(torch.finfo(dtype).eps), rtol=float(opts.rtol),
        atol=float(opts.atol), safety0=float(opts.safety),
        facl=float(opts.min_factor), facr=float(opts.max_factor),
        quot1=float(opts.quot1), quot2=float(opts.quot2),
        max_steps=float(opts.max_steps))


def arg_rows(args, like):
    """(rows [n_leaves, M] or [1, M] of zeros, treedef): args' leaves as rows
    of like's dtype, scalars broadcast to [M]; treedef(rows) rebuilds args."""
    m = like.shape[-1]
    leaves, treedef = cm.tree_flatten(args)
    out = []
    for leaf in leaves:
        leaf = cm.like(leaf, like)
        if leaf.ndim == 0:
            leaf = leaf.broadcast_to((m,))
        elif leaf.ndim != 1 or leaf.shape[0] != m:
            raise ValueError(
                "solve_radau_fused supports scalar or [M] args leaves only")
        out.append(leaf)
    rows = torch.stack(out) if out else like.new_zeros((1, m))
    return rows, (treedef if out else None)


def _step_ref(state, tf_row, arg_rows, f: Callable, treedef, consts):
    """Plain torch version of one step attempt of K4 on the packed state
    [n_rows, M]; returns the new state. treedef(list of rows) rebuilds the
    args pytree (None: f gets args=None)."""
    k = consts
    dim = (state.shape[0] - 15) // 5
    rows, _ = _row_layout(dim)

    def R(name, i=0):
        return state[rows[name] + i]

    def args_of(rs):
        return None if treedef is None else treedef(list(rs))

    a1 = args_of(arg_rows)

    def f_soa(t_vec, y_rows):
        out = f(t_vec, torch.stack(y_rows, dim=-1), a1)
        return [out[:, i] for i in range(dim)]

    tfv = tf_row[0]
    t = R("t")
    y = [R("y", i) for i in range(dim)]
    f0 = [R("f0", i) for i in range(dim)]
    h = R("h")
    active = R("active") > 0.5
    eps = k.eps

    remaining = tfv - t
    last = torch.abs(h) >= torch.abs(remaining)
    h = torch.where(last, remaining, h)
    h = torch.where(h == 0.0, eps, h)

    # ---- Jacobian by forward mode of f --------------------------------------
    y_std = torch.stack(y, dim=-1)
    jac = [[None] * dim for _ in range(dim)]
    for jcol in range(dim):
        tang = torch.zeros_like(y_std)
        tang[:, jcol] = 1.0
        _, col = jvp(lambda yy: f(t, yy, a1), (y_std,), (tang,))
        for irow in range(dim):
            jac[irow][jcol] = col[:, irow]

    # ---- factorizations (pivot-free) -------------------------------------------
    zero = torch.zeros_like(h)
    ar = [[(_rdiv(k.mu_r, h) if i == j else 0.0) - jac[i][j]
           for j in range(dim)] for i in range(dim)]
    lu_r = _factor_rows(ar, dim)
    d2 = 2 * dim
    ac = [[None] * d2 for _ in range(d2)]
    for i in range(dim):
        for j in range(dim):
            arij = (_rdiv(k.mu_cr, h) if i == j else 0.0) - jac[i][j]
            aiij = _rdiv(k.mu_ci, h) if i == j else None
            ac[i][j] = arij
            ac[i][j + dim] = -aiij if i == j else zero
            ac[i + dim][j] = aiij if i == j else zero
            ac[i + dim][j + dim] = arij
    lu_c = _factor_rows(ac, d2)

    # ---- Newton warm start ------------------------------------------------------
    have_sol = R("have_sol") > 0.5
    h_prev = R("h_prev")
    q = [[R("q", s * dim + i) for i in range(dim)] for s in range(3)]
    z = [[None] * dim for _ in range(3)]
    for s in range(3):
        th = 1.0 + k.c[s] * (h / h_prev)
        for i in range(dim):
            poly = (q[0][i] * th + q[1][i] * th * th
                    + q[2][i] * th * th * th)
            poly1 = q[0][i] + q[1][i] + q[2][i]
            z[s][i] = torch.where(have_sol, poly - poly1, zero)
    ti, tm = k.ti_mat, k.t_mat
    w = [[ti[s][0] * z[0][i] + ti[s][1] * z[1][i] + ti[s][2] * z[2][i]
          for i in range(dim)] for s in range(3)]

    scale = [k.atol + k.rtol * torch.abs(y[i]) for i in range(dim)]

    # ---- simplified Newton (masked fixed-trip loop) ---------------------------
    a3 = args_of(torch.cat([arg_rows] * 3, dim=-1))
    n = t.shape[0]
    t_st = torch.cat([t + k.c[s] * h for s in range(3)])
    dwn_old = zero
    running = active
    converged = torch.zeros_like(active)
    niter = zero
    nfev_n = zero
    for it in range(k.newton_maxiter):
        y_st = torch.cat([torch.stack([y[i] + z[s][i] for i in range(dim)],
                                      dim=-1) for s in range(3)])
        fs_std = f(t_st, y_st, a3)                        # [3M, D]
        fst = [[fs_std[s * n:(s + 1) * n, i] for i in range(dim)]
               for s in range(3)]
        finite = torch.ones_like(active)
        for s in range(3):
            for i in range(dim):
                finite = finite & torch.isfinite(fst[s][i])

        tif = [[ti[s][0] * fst[0][i] + ti[s][1] * fst[1][i]
                + ti[s][2] * fst[2][i] for i in range(dim)] for s in range(3)]
        rhs_r = [tif[0][i] - _rdiv(k.mu_r, h) * w[0][i] for i in range(dim)]
        dw0 = _solve_lu_rows(lu_r, rhs_r, dim)
        rhs_c = ([tif[1][i] - (k.mu_cr * w[1][i] - k.mu_ci * w[2][i]) / h
                  for i in range(dim)]
                 + [tif[2][i] - (k.mu_cr * w[2][i] + k.mu_ci * w[1][i]) / h
                    for i in range(dim)])
        dwc = _solve_lu_rows(lu_c, rhs_c, d2)
        dw = [dw0, dwc[:dim], dwc[dim:]]

        ssum = zero
        for s in range(3):
            for i in range(dim):
                r = dw[s][i] / scale[i]
                ssum = ssum + r * r
        dwn = torch.sqrt(ssum / (3 * dim))
        have = it > 0
        rt = torch.where(
            (dwn_old > 0) & have,
            dwn / torch.where(dwn_old == 0, 1.0, dwn_old), 0.0)
        srt = torch.clamp(rt, 1e-16, 1.0 - 1e-16)
        left = float(k.newton_maxiter - it)
        div = ((rt >= 1.0) | (torch.pow(srt, left) / (1 - srt) * dwn
                              > k.newton_tol)) & have
        failn = running & (~finite | div)
        app = running & ~failn
        w = [[torch.where(app, w[s][i] + dw[s][i], w[s][i])
              for i in range(dim)] for s in range(3)]
        z = [[torch.where(app, tm[s][0] * w[0][i] + tm[s][1] * w[1][i]
                          + tm[s][2] * w[2][i], z[s][i])
              for i in range(dim)] for s in range(3)]
        cnow = app & ((dwn == 0.0)
                      | ((rt < 1.0) & (srt / (1 - srt) * dwn < k.newton_tol)
                         & have))
        niter = torch.where(running, float(it + 1), niter)
        nfev_n = nfev_n + torch.where(running, 3.0, 0.0)
        dwn_old = torch.where(app, dwn, dwn_old)
        converged = converged | cnow
        running = running & ~failn & ~cnow
    conv = active & converged
    newton_fail = active & ~converged

    # ---- error estimate ------------------------------------------------------
    y_new = [y[i] + z[2][i] for i in range(dim)]
    ze = [(k.e[0] * z[0][i] + k.e[1] * z[1][i] + k.e[2] * z[2][i]) / h
          for i in range(dim)]
    sc = [k.atol + k.rtol * torch.maximum(torch.abs(y[i]), torch.abs(y_new[i]))
          for i in range(dim)]

    def enorm_of(err):
        esum = zero
        for i in range(dim):
            r = err[i] / sc[i]
            esum = esum + r * r
        en = torch.sqrt(esum / dim)
        return torch.where(torch.isfinite(en), en, 1e10)

    err = _solve_lu_rows(lu_r, [f0[i] + ze[i] for i in range(dim)], dim)
    enorm1 = enorm_of(err)
    rejected = R("rejected") > 0.5
    # refined estimate (always computed, as the reference kernel)
    fe = f_soa(t, [y[i] + err[i] for i in range(dim)])
    err2 = _solve_lu_rows(lu_r, [fe[i] + ze[i] for i in range(dim)], dim)
    enorm2 = enorm_of(err2)
    enorm = torch.where(rejected & (enorm1 > 1.0), enorm2, enorm1)
    enorm = torch.clamp(enorm, min=1e-16)

    accept = conv & (enorm <= 1.0)
    reject_err = conv & (enorm > 1.0)

    # ---- controller ---------------------------------------------------------------
    h_abs = torch.abs(h)
    h_old = R("h_old")
    err_old = R("err_old")
    niter_s = torch.clamp(niter, min=1.0)
    nm = k.newton_maxiter
    safety = _rdiv(k.safety0 * (2 * nm + 1), 2 * nm + niter_s)
    have_old = (h_old > 0) & (err_old > 0)
    mult = torch.where(have_old,
                       h_abs / torch.where(h_old == 0, 1.0, h_old)
                       * (err_old / enorm) ** k.expo, 1.0)
    base = torch.clamp(mult, max=1.0) * enorm ** -k.expo
    fac_rej = torch.clamp(safety * base, min=k.facl)
    fac_acc = torch.clamp(safety * base, k.facl, k.facr)
    deadzone = accept & (fac_acc >= k.quot1) & (fac_acc < k.quot2)
    fac_acc = torch.where(deadzone, 1.0, fac_acc)

    # ---- f at the accepted point ------------------------------------------------
    t_new = t + h
    f_new = f_soa(t_new, y_new)

    # ---- bookkeeping ------------------------------------------------------------
    nsing = R("nsing")
    nsing = torch.where(newton_fail, nsing + 1.0,
                        torch.where(accept, 0.0, nsing))
    stall = active & (nsing >= 7.0)
    nsteps = R("nsteps") + torch.where(active, 1.0, 0.0)
    done = accept & last
    exceeded = active & (nsteps >= k.max_steps) & ~done
    h_next = torch.where(accept, h_abs * fac_acc,
                         torch.where(reject_err, h_abs * fac_rej,
                                     torch.where(newton_fail, h_abs * 0.5,
                                                 h_abs)))
    underflow = active & (0.1 * h_next <= eps * torch.abs(t_new)) & ~done

    status = R("status")
    status = torch.where(done, float(cm.SUCCESS), status)
    status = torch.where(exceeded, float(cm.MAX_STEPS), status)
    status = torch.where(underflow, float(cm.STEP_UNDERFLOW), status)
    status = torch.where(stall, float(cm.NEWTON_STALL), status)
    active_n = active & ~done & ~exceeded & ~underflow & ~stall

    # ---- write back ---------------------------------------------------------------
    out = {
        "t": [torch.where(accept, t_new, t)],
        "y": [torch.where(accept, y_new[i], y[i]) for i in range(dim)],
        "f0": [torch.where(accept, f_new[i], f0[i]) for i in range(dim)],
        "h": [torch.where(active, h_next * torch.sign(h), R("h"))],
        "h_old": [torch.where(accept, h_abs, h_old)],
        "err_old": [torch.where(accept, enorm, err_old)],
        # dense/warm-start poly coeffs: Q_q[i] = sum_s z[s][i] * P[s][q]
        "q": [torch.where(accept, z[0][i] * k.p[0][qq] + z[1][i] * k.p[1][qq]
                          + z[2][i] * k.p[2][qq], q[qq][i])
              for qq in range(3) for i in range(dim)],
        "h_prev": [torch.where(accept, h, h_prev)],
        "active": [torch.where(active_n, 1.0, 0.0).to(state.dtype)],
        "rejected": [torch.where(accept, 0.0,
                                 torch.where(reject_err | newton_fail, 1.0,
                                             R("rejected")))],
        "have_sol": [torch.where(accept, 1.0, R("have_sol"))],
        "nsing": [nsing],
        "status": [status],
        "nsteps": [nsteps],
        "naccept": [R("naccept") + torch.where(accept, 1.0, 0.0)],
        "nreject": [R("nreject")
                    + torch.where(reject_err | newton_fail, 1.0, 0.0)],
        "nfev": [R("nfev") + torch.where(active, nfev_n + 2.0 + dim, 0.0)],
        "nnewton": [R("nnewton") + niter],
    }
    return torch.stack([r for name in rows for r in out[name]])


FLAG_ROWS = ("active", "rejected", "have_sol", "nsing", "status") + STATS


def state_agreement(got, ref, dim: int):
    """How far two packed states agree (K4 against ``_step_ref``): (share of
    lanes whose flags and counters are all equal, {row name: max error on
    those lanes relative to the row's largest entry}, max absolute error)."""
    rows, n_rows = _row_layout(dim)
    flag_idx = [rows[k] for k in FLAG_ROWS]
    same = (got[flag_idx] == ref[flag_idx]).all(dim=0)
    names = {}
    for name, off in rows.items():
        n = {"y": dim, "f0": dim, "q": 3 * dim}.get(name, 1)
        for i in range(n):
            names[off + i] = f"{name}{i}" if n > 1 else name
    errs, abs_err = {}, 0.0
    for r in range(n_rows):
        if r in flag_idx:
            continue
        e = float((got[r][same] - ref[r][same]).abs().max())
        scale = float(ref[r][same].abs().max())
        errs[names[r]] = e / (scale or 1.0)
        abs_err = max(abs_err, e)
    return float(same.double().mean()), errs, abs_err


def initial_state(f: Callable, t0, tf, y0, args, opts: Options):
    """(state [n_rows, M], tf_row [1, M]) before the first attempt."""
    t0, tf, y0 = cm.broadcast_batch(t0, tf, y0)
    m, dim = y0.shape
    dtype = y0.dtype
    rows, n_rows = _row_layout(dim)
    f0 = f(t0, y0, args)
    if opts.h0 == 0.0:
        h0 = cm.initial_step(f, t0, y0, f0, tf, 3, opts.rtol, opts.atol,
                             args, opts.max_step)
    else:
        direction = torch.where(tf >= t0, 1.0, -1.0).to(dtype)
        h0 = torch.full((m,), opts.h0, dtype=dtype,
                        device=y0.device) * direction

    st = y0.new_zeros((n_rows, m))
    st[rows["t"]] = t0
    st[rows["y"]:rows["y"] + dim] = y0.T
    st[rows["f0"]:rows["f0"] + dim] = f0.T
    st[rows["h"]] = h0
    st[rows["h_prev"]] = 1.0
    st[rows["active"]] = (t0 != tf).to(dtype)
    st[rows["status"]] = torch.where(t0 == tf, float(cm.SUCCESS),
                                     float(cm.RUNNING)).to(dtype)
    return st, tf[None, :].clone()


def solution_of(state, dim: int) -> cm.Solution:
    rows, _ = _row_layout(dim)
    return cm.Solution(
        t=state[rows["t"]],
        y=state[rows["y"]:rows["y"] + dim].T.contiguous(),
        status=state[rows["status"]].to(torch.int8),
        stats={k: state[rows[k]].to(torch.int32) for k in STATS})


def _solve(f, t0, tf, y0, args, options, step):
    """The host loop: step(state, tf_row, consts) while any lane is active."""
    opts = options if options is not None else Options()
    t0, tf, y0 = cm.broadcast_batch(t0, tf, y0)
    arg_rows(args, y0[:, 0])                # the reference's args check
    st, tf_row = initial_state(f, t0, tf, y0, args, opts)
    consts = step_consts(opts, st.dtype)
    dim = (st.shape[0] - 15) // 5
    active = _row_layout(dim)[0]["active"]
    syncs = _HostSyncs()
    while syncs.any(st[active] > 0.5):
        st = step(st, tf_row, consts)
    return solution_of(st, dim), syncs.count


def solve_radau_fused(f: Callable, t0, tf, y0, args=None,
                      options: Optional[Options] = None) -> cm.Solution:
    """Batched Radau5 (s=3) with the fused one-kernel step attempt (K4).

    f(t [M], y [M, D], args) -> [M, D]; y0 [M, D] on the device the solve
    runs on. On a CUDA tensor f must be in ``models.problems.
    DEVICE_PROBLEMS``. The host syncs of the last solve are in
    ``solve_radau_fused.host_syncs``.
    """
    from janus_tpu_torch.ops.radau_fused import radau5_step

    def step(st, tf_row, consts):
        return radau5_step(st, tf_row, f, args, consts,
                           max_attempts=MAX_ATTEMPTS)

    sol, solve_radau_fused.host_syncs = _solve(f, t0, tf, y0, args, options,
                                               step)
    return sol


solve_radau_fused.host_syncs = 0


def solve_radau_fused_ref(f: Callable, t0, tf, y0, args=None,
                          options: Optional[Options] = None) -> cm.Solution:
    """The same solve with every attempt in ``_step_ref``, on any device:
    the plain version the kernel path is held against on the card."""

    def step(st, tf_row, consts):
        rows, treedef = arg_rows(args, st)
        return _step_ref(st, tf_row, rows, f, treedef, consts)

    sol, _ = _solve(f, t0, tf, y0, args, options, step)
    return sol
