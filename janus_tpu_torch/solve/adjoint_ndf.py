"""Discrete-adjoint reverse mode on the batched variable-order NDF/BDF solver.

The port of ``janus_tpu/solve/adjoint_ndf.py``. ``ndf_adjoint`` returns the
final state of an adaptive ``solve_bdf`` run through
``solve.discrete.DiscreteAdjointFn``, whose backward pass differentiates the
solver's step map on the recorded accepted-step mesh. A multistep method's
state is its backward-difference array D, so, unlike the one-step adjoints,
the backward loop carries a cotangent for the WHOLE array, λ_D [M, SLOTS, D],
and the mesh holds per accepted step: the frozen controls (t, h, order), the
post-clamp prediction basis D', the converged corrector increment d, and
the composed inter-step rescale transform T (every ``_change_D`` between two
accepted predictions, rejected attempts' included, folded into one frozen
[K, K] matrix per lane). One accepted step factors as

    Dhist_k = HistUpdate(D'_k, d_k)          (linear, frozen order)
    D'_k    = T_k ⋆ Dhist_{k-1}              (linear, frozen T)
    d_k     : M (d + ψ(D'_k)) − c f(t+h, y_pred(D'_k) + d) = 0   (implicit)

and the backward loop pulls each factor, last slot first: the linear update
by a ``torch.func.vjp``, the corrector by the implicit-function theorem
(one transposed solve (M − c·J(t+h, y_new))ᵀ w = λ_d with a FRESH Jacobian
at the converged point, then −w pulled through the corrector residual at
fixed d), and the frozen T by its transpose. Newton is never replayed: the
gradient is that of the converged corrector, exact to O(newton_tol) for the
computed map (so against ``solve_bdf(tangents=)`` it agrees to O(newton_tol),
not to the bit).

The loop is this module's (``solve.discrete`` runs it as the Function's
``sweep``) on the pieces the one-step adjoints share: one host read before
the loop (``discrete.live_slots``), the per-lane live mask, dead slots
replayed at a benign step (order 1, h 1, D' = [y0, 0, …], d 0, T = I: an
empty slot has order 0, so α = 0 and c = h/0) under a zero cotangent, NaN on
overflow (``discrete.overflow_nan``) and the boundary-time cotangents
(``discrete.boundary_times``). y(T) is Dhist[0] of a lane's last accepted
step, so ȳ enters as e₀ ⊗ ȳ at slot naccept−1 per lane; a lane with no step
(t0 = tf, or a zero-length segment after its event) passes ȳ through.

Startup: D₀ = [y0, d₁] with d₁ = h₀·f(t0, y0), or under a mass matrix the
linearized backward-Euler increment (M − h₀J₀)⁻¹h₀f₀ (pivoted), with h₀
recorded and frozen; the pull through d₁ carries its y0/θ dependence.

Scope: terminal mode; ``t_eval=`` (chained warm-started segments, each
RESTARTING the difference array at order 1); terminal ``events=`` giving
(y*, t*), both differentiable through the vjp of the triggering step's
interpolant (linear in the replayed history) with θ* re-polished by two
Newton steps from the recorded root; ``cost=`` through each step's GL-3
increment (``common.gl3_increment``, the forward's ``quad=``); ``n_alg=``
with ``adjoint.constrained_ydot``; the matrix-free backward
(``Options(stage_solver='gmres'|'tridiag')``) through
``radau.gmres_shifted_solver_T``. Under ``Options(kernel_lu=True)`` the
forward solve factors and solves through K1/K2, and so do the backward's
transposed corrector solves (no kernel is differentiated: w is computed
outside every vjp).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.func import jvp, vjp

from janus_tpu_torch.linalg.smalllu import lu_factor, lu_solve
from janus_tpu_torch.solve import common as cm
from janus_tpu_torch.solve import ndf as nd
from janus_tpu_torch.solve.adjoint import (_split_diff, adjoint_outputs,
                                           chain_segments, constrained_ydot,
                                           sampled_outputs)
from janus_tpu_torch.solve.discrete import (DiscreteAdjointFn,
                                            boundary_times, live_slots,
                                            overflow_nan)
from janus_tpu_torch.solve.events import normalize_events
from janus_tpu_torch.solve.options import Options
from janus_tpu_torch.solve.radau import (_kernel_lu_factor, _kernel_lu_solve,
                                         default_jacobian,
                                         gmres_shifted_solver,
                                         gmres_shifted_solver_T,
                                         precond_probe_fn)
from janus_tpu_torch.solve.rodas import mass_dot


def ndf_adjoint(f: Callable, tspan, y0, args=None,
                options: Optional[Options] = None,
                jac: Optional[Callable] = None, mass=None, t_eval=None,
                ndf: bool = True, events=None,
                cost: Optional[Callable] = None, n_alg: int = 0,
                device=None):
    """Reverse-differentiable batched adaptive NDF/BDF (orders 1-5) solve.

    Returns the final state y(T) [M, D], or with ``t_eval`` the sampled
    trajectory ys [M, T, D]. ``backward()`` of any function of the result
    flows through the discrete adjoint to y0, every floating-point tensor
    leaf of ``args``, t0, tf and (t_eval mode) the sample times, where those
    are tensors that require grad. A y0 that is not a tensor goes to
    ``device``, by default the CUDA card. Memory: one (t, h, order, d, D',
    T) slot per accepted step, ``options.adjoint_steps`` slots per lane PER
    SEGMENT (the D' ring is 8× a one-step adjoint's y ring; the gradient is
    NaN on overflow).

    events: TERMINAL event spec(s); returns ``(y, t)``, the state and time
    each lane stopped at, both differentiable; with t_eval ``(ys, y*, t*)``,
    samples strictly past t* NaN. A lane that never triggers integrates the
    whole span: size ``adjoint_steps`` for it.

    cost: running-cost integrand ``l(t [M], y [M, D], args) -> [M]`` or
    [M, Q]; appends ``q = ∫ l dt`` to the outputs (``(y, q)``, ``(ys, q)``
    summed over the grid, ``(y, t, q)`` with events, q truncated at t*),
    and q's cotangent flows through the same backward loop.

    n_alg: the number of trailing algebraic variables of a semi-explicit
    index-1 DAE (mass = blockdiag(A, 0)): the t0/tf cotangents use the
    constrained velocity.

    The host syncs of the last backward loop are in
    ``ndf_adjoint.host_syncs`` (the forward's in ``solve_bdf.host_syncs``).
    """
    opts = options if options is not None else Options()
    if n_alg and mass is None:
        raise ValueError("n_alg > 0 (semi-explicit index-1 DAE boundary "
                         "velocity) needs mass=blockdiag(A, 0); without a "
                         "mass matrix the system is an ODE")
    use_gmres = opts.stage_solver != "lu"
    if use_gmres and jac is not None:
        raise ValueError("stage_solver='gmres' is matrix-free (Jᵀ·v by "
                         "vjp, transposed probed preconditioner); drop "
                         "jac=")
    specs = normalize_events(events)
    if specs and not all(e.terminal for e in specs):
        raise ValueError("ndf_adjoint(events=...) requires every event "
                         "terminal (non-terminal recordings have no "
                         "gradient contract)")
    y0 = cm.on_device(y0, device)
    if mass is not None:
        mass = cm.like(mass, y0)
    t0, tf = tspan

    def run(ta, tb, y, args_, h0):
        dleaves, rebuild, _, _ = _split_diff(args_)

        def fa(t, yy, dl):
            return f(t, yy, rebuild(dl))

        def solve(t0_, tf_, y0_, args0, h0_):
            return nd.solve_bdf(f, t0_, tf_, y0_, args0, opts, jac=jac,
                                mass=mass, ndf=ndf, events=specs or None,
                                quad=cost, _mesh_size=opts.adjoint_steps,
                                _h0=h0_)

        def ydot(t, yy, dl):
            # the TRUE velocity (M⁻¹f, or with n_alg the constrained one)
            return constrained_ydot(fa, t, yy, dl, mass, n_alg,
                                    use_gmres=use_gmres,
                                    gmres_iters=opts.gmres_iters,
                                    pivot=opts.pivoting)

        cfg = {"solve": solve, "sweep": _sweep, "ydot": ydot,
               "events": specs, "cost": cost, "rebuild": rebuild,
               "entry": ndf_adjoint, "f": fa, "opts": opts, "mass": mass,
               "ndf": ndf,
               "jac": (lambda t, yy, dl: jac(t, yy, rebuild(dl))) if jac
               else None}
        return DiscreteAdjointFn.apply(cfg, ta, tb, y, h0, *dleaves)

    if t_eval is None:
        return adjoint_outputs(run(t0, tf, y0, args, None), bool(specs))
    return sampled_outputs(*chain_segments(run, t0, tf, y0, args, t_eval,
                                           bool(specs), "ndf_adjoint"),
                           bool(specs))


ndf_adjoint.host_syncs = 0


def _sweep(cfg, mesh, nacc, t0b, y0b, t_end, y_end, ev_idx, dleaves, ybar,
           tbar, qbar):
    """The backward loop over the recorded NDF mesh (``discrete.sweep``'s
    signature): (λ(t0) [M, D], the leaves' gradients, t̄0 [M], t̄f [M])."""
    fa, opts, mass = cfg["f"], cfg["opts"], cfg["mass"]
    specs, cost, rebuild = cfg["events"], cfg["cost"], cfg["rebuild"]
    use_cost = cost is not None
    use_gmres = opts.stage_solver != "lu"
    g_iters = 0 if opts.stage_solver == "tridiag" else opts.gmres_iters
    m, dim = y_end.shape
    dtype, dev = y_end.dtype, y_end.device
    cap = mesh["t"].shape[1]
    alpha, _, gamma_slots = nd.method_constants(cfg["ndf"], dtype, dev)
    eye_k = torch.eye(nd._K, dtype=dtype, device=dev)
    mdot = mass_dot(mass)
    mmat = torch.eye(dim, dtype=dtype, device=dev)[None] if mass is None \
        else mass.expand(m, dim, dim)
    jac_fn = cfg["jac"] if cfg["jac"] is not None else default_jacobian(fa)

    ybar = torch.zeros_like(y_end) if ybar is None else ybar.to(dtype)
    tbar = torch.zeros_like(t_end) if tbar is None \
        else tbar.to(dtype).broadcast_to((m,))
    lfun = qb = None
    if use_cost:
        def lfun(t, y, dl):                        # canon [M, Q]
            return cm.canon_cost(cost(t, y, rebuild(dl)))

        l_end = lfun(t_end, y_end, dleaves)
        qb = torch.zeros_like(l_end) if qbar is None \
            else qbar.to(dtype).reshape(l_end.shape)      # [M, Q]

    triggered = ev_idx >= 0
    # e₀ ⊗ ȳ; a triggered lane's cotangent enters through its event
    # endpoint instead
    e0bar = y_end.new_zeros((m, nd._SLOTS, dim))
    e0bar[:, 0] = torch.where(triggered[:, None], 0.0, ybar)
    d_ben = y_end.new_zeros((m, nd._SLOTS, dim))
    d_ben[:, 0] = y0b

    def g_sel(t, y, dl):           # the lane's OWN terminating event
        one_hot = (torch.arange(len(specs), device=dev)[:, None]
                   == torch.clamp(ev_idx, min=0)[None, :]).to(dtype)
        vals = torch.stack([e.fn(t, y, rebuild(dl)).to(dtype)
                            for e in specs])
        return torch.sum(one_hot * vals, dim=0)

    grads = [torch.zeros_like(leaf) for leaf in dleaves]
    # a lane with no accepted step returns y0: ȳ passes straight through
    lam = torch.where((nacc == 0)[:, None, None], e0bar, 0.0)
    n_live, evt_slots = live_slots(nacc, triggered, cap)
    for k in range(n_live - 1, -1, -1):
        live = k < nacc
        is_last = k == nacc - 1
        lam_in = torch.where(is_last[:, None, None], e0bar, lam)
        tk = torch.where(live, mesh["t"][:, k], t0b)
        hk = torch.where(live, mesh["h"][:, k], 1.0)
        kk = torch.where(live, mesh["k"][:, k].to(torch.int64), 1)
        dk = torch.where(live[:, None], mesh["d"][:, k], 0.0)
        Dk = torch.where(live[:, None, None], mesh["D"][:, k], d_ben)
        Tk = torch.where(live[:, None, None], mesh["T"][:, k], eye_k)
        lam_h = torch.where(live[:, None, None], lam_in, 0.0)
        is_evt = live & triggered & is_last

        # 1) the linear accept-update (and each live step's GL-3 cost
        # increment on the replayed interpolant, which takes all of q̄)
        if use_cost:
            def upd(Dp, d, dl):
                Dh = nd._hist_update(Dp, d, kk)
                return Dh, cm.gl3_increment(
                    lambda tt, yy: torch.where(live[:, None],
                                               lfun(tt, yy, dl), 0.0),
                    tk, hk, nd._bdf_interp(Dh, tk, hk, kk),
                    torch.ones_like(tk))

            qb_k = torch.where((live & ~is_evt)[:, None], qb, 0.0)
            lam_Dp, lam_d, dgl = vjp(upd, Dk, dk, dleaves)[1]((lam_h, qb_k))
        else:
            lam_Dp, lam_d = vjp(lambda Dp, d: nd._hist_update(Dp, d, kk),
                                Dk, dk)[1](lam_h)
            dgl = None

        if k in evt_slots:
            th0 = torch.clamp((t_end - tk) / torch.where(hk == 0.0, 1.0, hk),
                              0.0, 1.0)
            th0 = torch.where(is_evt, th0, 0.5)

            def evt_endpoint(Dp, d, dl):
                # (y*, t*[, the truncated last increment]) of the triggering
                # step; θ* re-polished by two Newton steps from the recorded
                # root (starting converged, the polished iterate's
                # derivative is the implicit-function one to O(residual²))
                interp = nd._bdf_interp(nd._hist_update(Dp, d, kk), tk, hk,
                                        kk)

                def gfun(th):
                    return g_sel(tk + th * hk, interp(th[:, None])[:, 0], dl)

                th = th0
                for _ in range(2):
                    gv, dg = jvp(gfun, (th,), (torch.ones_like(th),))
                    th = th - gv / torch.where(dg == 0.0, 1.0, dg)
                outs = (interp(th[:, None])[:, 0], tk + th * hk)
                if use_cost:
                    outs = outs + (cm.gl3_increment(
                        lambda tt, yy: torch.where(is_evt[:, None],
                                                   lfun(tt, yy, dl), 0.0),
                        tk, hk, interp, th),)
                return outs

            ct = (torch.where(is_evt[:, None], ybar, 0.0),
                  torch.where(is_evt, tbar, 0.0))
            if use_cost:
                ct = ct + (torch.where(is_evt[:, None], qb, 0.0),)
            dDp_e, dd_e, dgl_e = vjp(evt_endpoint, Dk, dk, dleaves)[1](ct)
            lam_Dp = lam_Dp + torch.where(is_evt[:, None, None], dDp_e, 0.0)
            lam_d = lam_d + torch.where(is_evt[:, None], dd_e, 0.0)
            grads = [g + d for g, d in zip(grads, dgl_e)]

        # 2) the corrector by the implicit-function theorem: (M − c·J)ᵀ w =
        # λ_d with a fresh J at the converged point; dead lanes solve a
        # benign system (J masked to 0) with a zero rhs
        y_pred, _, alpha_ord = nd._predict(Dk, kk, gamma_slots, alpha)
        c = hk / alpha_ord
        t_new = tk + hk
        y_new = y_pred + dk
        if use_gmres:
            def f_live(t, y, dl):
                return torch.where(live[:, None], fa(t, y, dl), 0.0)

            pdata = precond_probe_fn(f_live, opts.precond,
                                     opts.precond_block, dim)(
                t_new, y_new, dleaves)
            w = gmres_shifted_solver_T(
                f_live, t_new, y_new, dleaves, pdata, torch.ones_like(c), c,
                mass, g_iters, precond=opts.precond,
                block=opts.precond_block)(lam_d)
        else:
            jm = torch.where(live[:, None, None],
                             jac_fn(t_new, y_new, dleaves), 0.0)
            amat_t = (mmat - c[:, None, None] * jm).mT
            if opts.kernel_lu:
                w = _kernel_lu_solve(_kernel_lu_factor(amat_t)[0], lam_d)
            else:
                lu_t, piv_t = lu_factor(amat_t, pivot=opts.pivoting)
                w = lu_solve(lu_t, piv_t, lam_d, pivot=opts.pivoting)

        # 3) −w through the corrector residual at fixed d
        def gres(Dp, dl):
            yp, ps, a_o = nd._predict(Dp, kk, gamma_slots, alpha)
            fv = torch.where(live[:, None], fa(t_new, yp + dk, dl), 0.0)
            return mdot(dk + ps) - (hk / a_o)[:, None] * fv

        gD, gdl = vjp(gres, Dk, dleaves)[1](-w)
        lam_Dp = lam_Dp + gD
        grads = [g + d for g, d in zip(grads, gdl)]
        if dgl is not None:
            grads = [g + d for g, d in zip(grads, dgl)]

        # 4) the frozen inter-step transform: D'[j] = Σ_i T[i, j]·Dhist[i]
        lam6 = nd._sum_seq(Tk[:, :, :, None] * lam_Dp[:, None, :nd._K, :], 2)
        lam_prev = torch.cat([lam6, lam_Dp[:, nd._K:]], dim=1)
        lam = torch.where(live[:, None, None], lam_prev, lam_in)

    # the startup D0 = [y0, d1(y0, θ), 0, ...] with the recorded h0 frozen;
    # a lane with no step never used it (and its h0 may be 0/0 at t0 = tf)
    h0r = torch.where(nacc > 0, mesh["h0"], 0.0)

    def d1_fn(y0v, dl):
        f0 = fa(t0b, y0v, dl)
        if mass is None:
            return h0r[:, None] * f0
        if use_gmres:
            pdata0 = precond_probe_fn(fa, opts.precond, opts.precond_block,
                                      dim)(t0b, y0v, dl)
            return gmres_shifted_solver(
                fa, t0b, y0v, dl, pdata0, torch.ones_like(h0r), h0r, mass,
                g_iters, precond=opts.precond,
                block=opts.precond_block)[0](h0r[:, None] * f0)
        j0 = jac_fn(t0b, y0v, dl)
        lu0, piv0 = lu_factor(mmat - h0r[:, None, None] * j0, pivot=True)
        return lu_solve(lu0, piv0, h0r[:, None] * f0)

    dy0, gdl0 = vjp(d1_fn, y0b, dleaves)[1](lam[:, 1])
    lam0 = lam[:, 0] + dy0
    grads = [g + d for g, d in zip(grads, gdl0)]
    lam0, grads = overflow_nan(nacc, cap, lam0, grads)
    t0bar, tfbar = boundary_times(cfg["ydot"], lfun, qb, ybar, tbar, lam0,
                                  t_end, y_end, t0b, y0b, dleaves, triggered)
    return lam0, grads, t0bar, tfbar
