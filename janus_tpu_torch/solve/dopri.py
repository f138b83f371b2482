"""Explicit Dormand–Prince solvers (dopri5, dopri853), batched lockstep.

The port of ``janus_tpu/solve/dopri.py``. One Python loop advances the whole
batch, one step attempt of every active lane per trip; per-lane accept and
reject, Hairer's PI step control and termination are ``torch.where`` selects
on [M] masks. The loop stops when no lane is active: one host sync an attempt
(``solve_erk.host_syncs``), where the reference runs a ``lax.while_loop``.

The Butcher tableaus and dense-output matrices are scipy's published arrays
(``scipy.integrate._ivp.rk``, ``dop853_coefficients``), as in the reference.

dop853's continuous extension costs three more f evaluations a step. The
reference computes them under ``lax.cond(any lane accepts)``; here they are
computed on every attempt that needs the interpolant (dense output, events,
quadratures, ``dense=``), since a gate would cost one host sync on every
attempt to skip only the attempts where no lane accepts.

The explicit family has no linear algebra: no kernel runs here.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from janus_tpu_torch.diag.record import init_dyn, record_step
from janus_tpu_torch.solve import common as cm
from janus_tpu_torch.solve.events import (handle_events, init_event_state,
                                          normalize_events)
from janus_tpu_torch.solve.options import Options
from janus_tpu_torch.solve.radau import _i32


class ERKTableau:
    """Explicit Runge–Kutta tableau (numpy constants)."""

    def __init__(self, name, a, b, c, order, *, e=None, e3=None, e5=None,
                 dense="rk45P", p=None, a_extra=None, c_extra=None, d=None,
                 default_beta=0.0):
        self.name = name
        self.a = np.asarray(a)
        self.b = np.asarray(b)
        self.c = np.asarray(c)
        self.e = None if e is None else np.asarray(e)
        self.e3 = None if e3 is None else np.asarray(e3)
        self.e5 = None if e5 is None else np.asarray(e5)
        self.order = order
        self.n_stages = len(self.b)
        self.dense = dense          # 'rk45P' | 'dop853D'
        self.p = None if p is None else np.asarray(p)
        self.a_extra = None if a_extra is None else np.asarray(a_extra)
        self.c_extra = None if c_extra is None else np.asarray(c_extra)
        self.d = None if d is None else np.asarray(d)
        self.default_beta = default_beta


def _tableaus():
    from scipy.integrate._ivp import dop853_coefficients as dc
    from scipy.integrate._ivp import rk as srk

    dopri5 = ERKTableau(
        "dopri5", srk.RK45.A, srk.RK45.B, srk.RK45.C, order=5,
        e=srk.RK45.E, dense="rk45P", p=srk.RK45.P, default_beta=0.04)
    ns = dc.N_STAGES  # 12
    dopri853 = ERKTableau(
        "dopri853", dc.A[:ns, :ns], dc.B, dc.C[:ns], order=8,
        e3=srk.DOP853.E3, e5=srk.DOP853.E5, dense="dop853D",
        a_extra=dc.A[ns + 1:], c_extra=dc.C[ns + 1:], d=dc.D,
        default_beta=0.0)
    return {"dopri5": dopri5, "dopri853": dopri853}


TABLEAUS = _tableaus()


def _combine(ks, coefs):
    """Σ_j ks[j]·coefs[j] over the nonzero coefficients, in index order."""
    acc = None
    for kj, cj in zip(ks, coefs):
        if cj != 0.0:
            term = kj * float(cj)
            acc = term if acc is None else acc + term
    return acc


def stages(tab: ERKTableau, feval, t, y, h, k0):
    """The stage cascade of one step from (t, y) with step h and first stage
    k0 = f(t, y): (ks [n_stages tensors], y1). feval(t, y) evaluates the
    right-hand side. The forward solve and the discrete adjoint's replay
    both call this, so the replay repeats the forward's arithmetic."""
    ks = [k0]
    hc = h[:, None]
    for i in range(1, tab.n_stages):
        acc = ks[0] * float(tab.a[i, 0])
        for j in range(1, i):
            if tab.a[i, j] != 0.0:
                acc = acc + ks[j] * float(tab.a[i, j])
        ks.append(feval(t + float(tab.c[i]) * h, y + hc * acc))
    return ks, y + hc * _combine(ks, tab.b)


def _err_norm(tab: ERKTableau, ks, h, y, y1, rtol, atol):
    """The scaled error norm [M] of a step; ks holds the stages and f_new.
    dop853 combines its 5th- and 3rd-order estimates (Hairer)."""
    sc = atol + rtol * torch.maximum(torch.abs(y), torch.abs(y1))
    if tab.e is not None:
        return cm.rms_norm(h[:, None] * _combine(ks, tab.e), sc)
    e5 = _combine(ks, tab.e5) / sc
    e3 = _combine(ks, tab.e3) / sc
    e5sq = torch.sum(torch.square(e5), dim=-1)
    e3sq = torch.sum(torch.square(e3), dim=-1)
    denom = e5sq + 0.01 * e3sq
    denom = torch.where(denom <= 0.0, 1.0, denom)
    return torch.abs(h) * e5sq / torch.sqrt(denom * y.shape[-1])


def _dop853_power_matrix():
    """The constant map [7 fall rows, 7 powers θ¹..θ⁷] from dop853's mixed
    (θ, 1−θ) Horner cascade to the power basis: the interpolant is linear in
    its 7 coefficient rows, so expanding the products symbolically gives an
    exact matrix with binomial-scale entries (no node re-fit)."""
    a = np.zeros((7, 8))
    for i in range(7):
        a[6 - i, 0] += 1.0
        if i % 2 == 0:                       # acc *= θ  (shift powers up)
            a = np.roll(a, 1, axis=1)
            a[:, 0] = 0.0
        else:                                # acc *= (1 − θ)
            sh = np.roll(a, 1, axis=1)
            sh[:, 0] = 0.0
            a = a - sh
    assert np.allclose(a[:, 0], 0.0)         # p(0) = y: no constant term
    return a[:, 1:]


_DOP853_POW = _dop853_power_matrix()


def _const(arr, like):
    return torch.as_tensor(arr, dtype=like.dtype, device=like.device)


def power_interp(y, q):
    """θ [M, T] -> y(θ) [M, T, D] = y + Σ_p θ^{p+1}·q_p for power-basis rows
    q [M, P, D] (dopri5's quartic is in this basis already)."""
    def interp(theta):
        tp = torch.stack([theta ** (i + 1) for i in range(q.shape[1])],
                         dim=-1)
        return y[:, None, :] + cm.lane_einsum("mtq,mqd->mtd", tp, q)

    return interp


def dop853_fall(tab, feval, t, y, y1, f_new, h, ks):
    """dop853's order-7 interpolant coefficients [M, 7, D] (three more f
    evaluations); ks holds the 12 stages."""
    k_ext = list(ks[:tab.n_stages]) + [f_new]
    hc = h[:, None]
    for arow, c in zip(tab.a_extra, tab.c_extra):
        yi = y + hc * _combine(k_ext, arow)
        k_ext.append(feval(t + float(c) * h, yi))
    kmat = torch.stack(k_ext, dim=1)                  # [M, 16, D]
    delta = y1 - y
    f_old = ks[0]
    fpoly = [delta, hc * f_old - delta, 2.0 * delta - hc * (f_new + f_old)]
    rest = cm.lane_einsum("qs,msd->mqd", _const(tab.d, kmat), kmat)
    return torch.cat([torch.stack(fpoly, dim=1), h[:, None, None] * rest],
                     dim=1)


def dense_eval_dop853(fall, y):
    """θ [M, T] -> y(θ) [M, T, D] on dop853's degree-7 extension."""
    def interp(theta):
        x = theta[..., None]
        acc = y.new_zeros(x.shape[:-1] + (y.shape[-1],))
        npoly = fall.shape[1]
        for i in range(npoly):
            acc = acc + fall[:, npoly - 1 - i, :][:, None, :]
            acc = acc * (x if i % 2 == 0 else 1.0 - x)
        return acc + y[:, None, :]

    return interp


def step_interp(tab, feval, t, y, y1, f_new, h, ks):
    """(interp θ [M, T] -> [M, T, D], power-basis rows [M, P, D] as a thunk)
    of one step's dense output, from its stages ks (without f_new). dop853
    evaluates its three extra stages here."""
    if tab.dense == "rk45P":
        k = torch.stack(list(ks) + [f_new], dim=1)              # [M, 7, D]
        q = h[:, None, None] * cm.lane_einsum("msd,sq->mqd", k,
                                            _const(tab.p, k))
        return power_interp(y, q), lambda: q
    fall = dop853_fall(tab, feval, t, y, y1, f_new, h, ks)
    return (dense_eval_dop853(fall, y),
            lambda: cm.lane_einsum("jp,mjd->mpd", _const(_DOP853_POW, fall),
                                 fall))


def solve_erk(tab: ERKTableau, f: Callable, t0, tf, y0, args=None,
              options: Optional[Options] = None, t_eval=None,
              events=None, step_args=None,
              quad: Optional[Callable] = None, dense: int = 0,
              _mesh_size: int = 0, _h0=None, device=None) -> cm.Solution:
    """Integrate a batch with an explicit Runge–Kutta pair (``TABLEAUS``).

    f(t [M], y [M, D], args) -> [M, D]. A torch y0 solves on its own device;
    any other y0 goes to ``device``, by default the CUDA card.

    t_eval: shared output grid [T]; ``Solution.ys`` [M, T, D] from the
    method's continuous extension. events: ``solve.events.Event`` spec(s),
    located on it; a terminal event stops the lane at t*. quad: running-cost
    integrand ``l(t [M], y [M, D], args) -> [M]`` or [M, Q];
    ``Solution.quad`` by 3-point Gauss-Legendre on each accepted step's
    interpolant, truncated at t* on event lanes. dense: step-mesh capacity
    N > 0 storing every accepted step's interpolant in the power basis
    (dop853's cascade mapped exactly by ``_DOP853_POW``) for
    ``Solution.interpolate(ts)``; overflowing lanes interpolate to NaN.

    step_args: pytree of per-accepted-step parameter slabs, every leaf with
    leading axis S (a leaf whose second axis is M is a per-lane table): a
    lane's k-th accepted step evaluates all its stages with row k, passed
    to f as ``(args, slab_k)``; events see the plain args. Stage 0 is
    evaluated again every attempt (the FSAL value carries the previous
    row). A lane still running after its S-th accepted step ends with
    status PARAMS_EXHAUSTED. ``Options(record_steps=K)``: every attempt's
    t, h, error norm and accept flag in ``Solution.dyn``.

    ``_mesh_size`` (the (t, h, y) rings of the accepted steps for the
    discrete adjoint, ``solve.adjoint_dopri``) and ``_h0`` (a per-lane warm
    start, 0 = automatic) are the adjoint's seats. The FSAL value f0 always
    equals a fresh f(t, y) at the step start (f_new was evaluated at exactly
    that point when the previous step was accepted), so a replay that
    evaluates stage 0 afresh repeats the forward's stages to the bit.
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
        if qshape != (m,) and (len(qshape) != 2 or qshape[0] != m):
            raise ValueError(f"quad must return [M] or [M, Q] with M={m}, "
                             f"got {qshape}")
        quad_scalar = len(qshape) == 1

        def ql(tt, yy):                          # canon [M, Q]
            return cm.canon_cost(quad(tt, yy, args))

        q_acc = y0.new_zeros((m, 1 if quad_scalar else qshape[1]))

    store_q = bool(dense)
    mesh_size = max(int(_mesh_size), int(dense))
    use_slabs = step_args is not None
    if use_slabs:
        if _mesh_size:
            raise ValueError("step_args= does not compose with the discrete "
                             "adjoint (its replay has no slab index); use "
                             "time-indexed controls for reverse mode")
        n_slabs, slab_at = cm.make_slab_selector(step_args, y0)
    # beta < 0 (the Options default) takes the method's own (Hairer's):
    # 0.04 for dopri5, 0 for dop853
    beta = opts.beta if opts.beta >= 0 else tab.default_beta
    expo1 = 0.2 - beta * 0.75 if tab.name == "dopri5" \
        else 1.0 / 8.0 - beta * 0.2

    args0 = (args, slab_at(torch.zeros((m,), dtype=torch.int32,
                                       device=dev))) if use_slabs else args
    f0 = f(t0, y0, args0)
    direction = torch.where(tf >= t0, 1.0, -1.0).to(dtype)
    if _h0 is not None:
        # per-lane warm start (segment chaining in solve.adjoint_dopri):
        # lanes with _h0 == 0 take the automatic initial step
        h_mag = torch.abs(cm.like(_h0, y0).broadcast_to((m,)))
        h_auto = torch.abs(cm.initial_step(f, t0, y0, f0, tf, tab.order,
                                           opts.rtol, opts.atol, args0,
                                           opts.max_step))
        h_mag = torch.where(h_mag > 0, h_mag, h_auto)
        h_st = torch.minimum(h_mag, torch.abs(tf - t0)) * direction
    elif opts.h0 == 0.0:
        h_st = cm.initial_step(f, t0, y0, f0, tf, tab.order, opts.rtol,
                               opts.atol, args0, opts.max_step)
    else:
        h_st = torch.full((m,), opts.h0, dtype=dtype, device=dev) * direction

    use_dense = t_eval is not None
    if use_dense:
        t_eval = cm.like(t_eval, y0)
        at_t0 = t_eval[None, :] == t0[:, None]
        out_ys = torch.where(at_t0[..., None], y0[:, None, :], torch.nan)

    stats = cm.zero_stats(m, ("nfev", "nsteps", "naccept", "nreject"), dev)
    stats["nfev"] = stats["nfev"] + 2               # f0 + the hinit probe
    mesh = None
    if mesh_size:
        mesh = {"t": y0.new_zeros((m, mesh_size)),
                "h": y0.new_zeros((m, mesh_size)),
                "y": y0.new_zeros((m, mesh_size, dim))}
        if store_q:
            n_pow = 4 if tab.dense == "rk45P" else 7
            mesh["q"] = y0.new_zeros((m, mesh_size, n_pow, dim))
    need_interp = use_dense or bool(specs) or use_quad or store_q
    nf_extra = 3 if (need_interp and tab.dense == "dop853D") else 0

    t, y = t0, y0
    facold = y0.new_full((m,), 1e-4)
    already_done = t0 == tf
    active = ~already_done
    status = torch.where(already_done, cm.SUCCESS, cm.RUNNING).to(torch.int8)
    ev = init_event_state(specs, m, dim, t0, y0, args)
    dyn = init_dyn(m, opts.record_steps, y0)
    zero_niter = torch.zeros((m,), dtype=torch.int32, device=dev)
    eps = torch.finfo(dtype).eps
    facc1 = 1.0 / opts.min_factor
    facc2 = 1.0 / opts.max_factor

    while syncs.any(active):
        remaining = tf - t
        last = torch.abs(h_st) >= torch.abs(remaining)
        h = torch.where(last, remaining, h_st)
        h = torch.where(h == 0.0, eps, h)        # finished lanes: nonzero

        if use_slabs:
            # a lane's k-th accepted step runs on slab row k; stage 0 again,
            # so that the previous row does not leak in through the FSAL f0
            exhausted = active & (stats["naccept"] >= n_slabs)
            fa = (args, slab_at(stats["naccept"]))
            k0 = f(t, y, fa)
        else:
            fa = args
            k0 = f0

        def feval(tt, yy, _fa=fa):
            return f(tt, yy, _fa)

        ks, y1 = stages(tab, feval, t, y, h, k0)
        f_new = f(t + h, y1, fa)
        enorm = _err_norm(tab, ks + [f_new], h, y, y1, opts.rtol, opts.atol)
        enorm = torch.where(torch.isfinite(enorm), enorm, 1e10)
        enorm = torch.clamp(enorm, min=1e-16)
        accept = enorm <= 1.0

        # Hairer's PI controller
        fac11 = enorm ** expo1
        fac = fac11 / (facold ** beta)
        fac = torch.clamp(torch.clamp(fac / opts.safety, max=facc1),
                          min=facc2)
        hnew_acc = h / fac
        hnew_acc = torch.clamp(torch.abs(hnew_acc), 0.0, opts.max_step) \
            * torch.sign(hnew_acc)
        hnew_rej = h / torch.clamp(fac11 / opts.safety, max=facc1)
        hnew = torch.where(accept, hnew_acc, hnew_rej)

        upd = accept & active
        if use_slabs:
            upd = upd & ~exhausted
        done = upd & last

        if need_interp:
            interp, q_rows = step_interp(tab, feval, t, y, y1, f_new, h, ks)
        if use_dense:
            out_ys = cm.collect_dense(out_ys, t_eval, t, h, upd, interp)
        ev, terminate, t_ev, y_ev, _ = handle_events(
            specs, ev, t, h, t + h, y1, interp if specs else None, upd, args,
            syncs)
        if use_dense and specs:
            out_ys = cm.mask_dense_after_event(out_ys, t_eval, terminate,
                                               t_ev, h)
        if use_quad:
            q_acc = cm.quad_gl3_step(ql, t, h, interp, upd, terminate, t_ev,
                                     q_acc)
        dyn = record_step(dyn, active, t, h, enorm, zero_niter, accept)
        if mesh is not None:
            values = {"t": t, "h": h, "y": y}
            if store_q:
                values["q"] = q_rows()
            cm.ring_write(mesh, stats["naccept"], upd, values)

        t_new = torch.where(upd, torch.where(terminate, t_ev, t + h), t)
        y = torch.where(upd[:, None],
                        torch.where(terminate[:, None], y_ev, y1), y)
        f0 = torch.where(upd[:, None], f_new, f0)
        facold = torch.where(upd, torch.clamp(enorm, min=1e-4), facold)
        h_st = torch.where(active, hnew, h_st)

        stats["nfev"] = stats["nfev"] + _i32(active) * (tab.n_stages + 1) \
            + _i32(upd) * nf_extra + (_i32(active) if use_slabs else 0)
        stats["nsteps"] = stats["nsteps"] + _i32(active)
        stats["naccept"] = stats["naccept"] + _i32(upd)
        stats["nreject"] = stats["nreject"] + _i32(active & ~accept)

        exceeded = active & (stats["nsteps"] >= opts.max_steps) & ~done
        # Hairer's t-relative underflow test
        underflow = active & ~done & ~exceeded \
            & (0.1 * torch.abs(h_st) <= eps * torch.abs(t_new))
        status = torch.where(done, cm.SUCCESS, status)
        status = torch.where(exceeded, cm.MAX_STEPS, status)
        status = torch.where(underflow, cm.STEP_UNDERFLOW, status)
        if use_slabs:
            status = torch.where(exhausted, cm.PARAMS_EXHAUSTED, status)
            active = active & ~exhausted
        status = torch.where(terminate, cm.EVENT_TERMINATED, status)
        active = active & ~done & ~exceeded & ~underflow & ~terminate
        t = t_new

    solve_erk.host_syncs = syncs.count
    return cm.Solution(
        t=t, y=y, status=status, stats=stats,
        ts=t_eval if use_dense else None,
        ys=out_ys if use_dense else None,
        event_t=ev["event_t"] if specs else None,
        event_y=ev["event_y"] if specs else None,
        event_idx=ev["event_idx"] if specs else None,
        dyn=dyn, mesh=mesh,
        quad=(q_acc[:, 0] if quad_scalar else q_acc) if use_quad else None,
        h_next=h_st)


solve_erk.host_syncs = 0
