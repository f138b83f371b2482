"""Batched RODAS4: stiffly accurate Rosenbrock 4(3) with its own dense output.

The port of ``janus_tpu/solve/rodas.py``. L-stable and stiffly accurate (the
last stage is evaluated at t+h and the update includes it, so the stage
order holds on index-1 DAEs), with an embedded 3rd-order error estimate that
costs nothing extra (the 6th stage increment IS the error vector) and the
method's own 3rd-order continuous extension.

Algorithm: Hairer & Wanner, Solving ODEs II (1996), Sec. IV.7, the RODAS
scheme in the (a_ij, c_ij, d_i, γ) form that avoids J⁻¹ products, with the
published coefficient set METH=1 of Hairer's rodas.f (ROCOE). Per step
(E = M/(h·γ) − J factored once, 6 solves, 5 f-evaluations):

  k_i = E⁻¹ [ f(t + c_i h, y + Σ_j a_ij k_j) + h d_i f_t + M Σ_j (c_ij/h) k_j ]
  y_emb = y + a_51 k1 + … + a_54 k4 + k5      (order 3, stiffly accurate)
  y_new = y_emb + k6                           (order 4)
  err   = ‖k6‖_sc                              (the embedded difference)

The Jacobian and f_t (a ``torch.func.jvp`` in t) are evaluated at every new
step point; a rejected step reuses both. One Python loop whose body is a step
attempt for every active lane, with per-lane h, accept/reject and
singular-retry lanes, Gustafsson's predictive controller and events, t_eval
and quadratures on the CONTRO cubic (rodas.f:861-888).

Control flow against the reference's ``lax.while_loop``/``lax.cond``: the
loop stops when no lane is active, one host sync per attempt (counted in
``solve_rodas.host_syncs``, with the events' bisection gate). The reference's
``lax.cond`` gates on the Jacobian, the factorization and the tangent sweep
skip work whose results it selects per lane; after an accept every lane needs
a new J, so the port always does that work and selects. The counters come
from the masks and equal the reference's.

With ``Options(kernel_lu=True)`` (pivot-free) E is factored by the CUDA
kernel K1 and every stage solve, and each tangent direction's stage solves,
go through K2 (``ops.smalllu``; their plain twins on CPU tensors).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.func import jvp

from janus_tpu_torch.linalg.smalllu import lu_factor, lu_ok, lu_solve
from janus_tpu_torch.solve import common as cm
from janus_tpu_torch.solve.events import (handle_events, init_event_state,
                                          normalize_events)
from janus_tpu_torch.solve.options import Options
from janus_tpu_torch.solve.radau import (STEP_ARGS_GUARD, _i32,
                                         _kernel_lu_factor, _kernel_lu_solve,
                                         default_jacobian,
                                         refuse_kernel_derivatives)

# Published RODAS4 coefficients (Hairer & Wanner 1996; rodas.f ROCOE METH=1)
GAMMA = 0.25
C2, C3, C4 = 0.386, 0.21, 0.63
D1, D2, D3, D4 = 0.25, -0.1043, 0.1035, -0.03620000000000023
A21 = 1.544
A31, A32 = 0.9466785280815826, 0.2557011698983284
A41, A42, A43 = 3.314825187068521, 2.896124015972201, 0.9986419139977817
A51, A52, A53, A54 = (1.221224509226641, 6.019134481288629,
                      12.53708332932087, -0.6878860361058950)
C21 = -5.6688
C31, C32 = -2.430093356833875, -0.2063599157091915
C41, C42, C43 = -0.1073529058151375, -9.594562251023355, -20.47028614809616
C51, C52, C53, C54 = (7.496443313967647, -10.24680431464352,
                      -33.99990352819905, 11.70890893206160)
C61, C62, C63, C64, C65 = (8.083246795921522, -7.981132988064893,
                           -31.52159432874371, 16.31930543123136,
                           -6.058818238834054)
# dense-output combinations (rodas.f D21..D35)
D21, D22, D23, D24, D25 = (10.12623508344586, -7.487995877610167,
                           -34.80091861555747, -7.992771707568823,
                           1.025137723295662)
D31, D32, D33, D34, D35 = (-0.6762803392801253, 6.087714651680015,
                           16.43084320892478, 24.76722511418386,
                           -6.594389125716872)


def ft_at(f, t, y, args):
    """∂f/∂t at (t, y): a ``torch.func.jvp`` in t (t may be a broadcast
    view, which forward mode refuses to take as a primal: made dense)."""
    t = t.contiguous()
    return jvp(lambda tt: f(tt, y, args), (t,), (torch.ones_like(t),))[1]


def mass_dot(mass):
    """v [..., M, D] -> M·v for a mass [D, D] or per lane [M, D, D]."""
    if mass is None:
        return lambda v: v
    if mass.ndim == 2:
        return lambda v: cm.lane_einsum("ij,...j->...i", mass, v)
    return lambda v: cm.lane_einsum("mij,...mj->...mi", mass, v)


def stage_increments(f, slv, mdot, t, h, y, f1, fx, args):
    """The six RODAS4 stage increments of one step from (t, y) with step h,
    f1 = f(t, y), fx = f_t(t, y) and slv(rhs) = E⁻¹·rhs. Returns (k1..k6,
    y5, y_emb, y_new): the arithmetic the solve and the adjoint's replay
    share."""
    hc = h[:, None]
    k1 = slv(f1 + (h * D1)[:, None] * fx)
    f2 = f(t + C2 * h, y + A21 * k1, args)
    k2 = slv(f2 + (h * D2)[:, None] * fx + mdot(C21 * k1) / hc)
    f3 = f(t + C3 * h, y + A31 * k1 + A32 * k2, args)
    k3 = slv(f3 + (h * D3)[:, None] * fx + mdot(C31 * k1 + C32 * k2) / hc)
    f4 = f(t + C4 * h, y + A41 * k1 + A42 * k2 + A43 * k3, args)
    k4 = slv(f4 + (h * D4)[:, None] * fx
             + mdot(C41 * k1 + C42 * k2 + C43 * k3) / hc)
    y5 = y + A51 * k1 + A52 * k2 + A53 * k3 + A54 * k4
    t_new = t + h
    f5 = f(t_new, y5, args)
    k5 = slv(f5 + mdot(C51 * k1 + C52 * k2 + C53 * k3 + C54 * k4) / hc)
    y_emb = y5 + k5                                   # order-3 embedded
    f6 = f(t_new, y_emb, args)
    k6 = slv(f6 + mdot(C61 * k1 + C62 * k2 + C63 * k3 + C64 * k4
                       + C65 * k5) / hc)
    return (k1, k2, k3, k4, k5, k6), y5, y_emb, y_emb + k6


def contro(ks):
    """The CONTRO cubic's coefficients (cont2, cont3) from k1..k5."""
    k1, k2, k3, k4, k5 = ks[:5]
    return (D21 * k1 + D22 * k2 + D23 * k3 + D24 * k4 + D25 * k5,
            D31 * k1 + D32 * k2 + D33 * k3 + D34 * k4 + D35 * k5)


def contro_interp(y, y_new, cont2, cont3):
    """θ [M, T] -> y(θ) [M, T, D] = y(1−θ) + θ[y_new + (1−θ)(c2 + θ·c3)]."""
    def interp(s):
        se = s[..., None]
        return (y[:, None, :] * (1.0 - se)
                + se * (y_new[:, None, :]
                        + (1.0 - se) * (cont2[:, None, :]
                                        + se * cont3[:, None, :])))
    return interp


def iteration_matrix(mass, h, jmat):
    """E = M/(h·γ) − J, [M, D, D]."""
    dim = jmat.shape[-1]
    mm = torch.eye(dim, dtype=jmat.dtype, device=jmat.device)[None] \
        if mass is None else (mass[None] if mass.ndim == 2 else mass)
    return mm / (h * GAMMA)[:, None, None] - jmat


def solve_rodas(f: Callable, t0, tf, y0, args=None,
                options: Optional[Options] = None, t_eval=None,
                jac: Optional[Callable] = None, mass=None,
                events=None, tangents=None, args_tangents=None,
                quad: Optional[Callable] = None, dense: int = 0,
                step_args=None, _mesh_size: int = 0, _h0=None,
                device=None) -> cm.Solution:
    """Batched adaptive RODAS4 solve (index-1 DAE capable via ``mass``).

    f(t [M], y [M, D], args) -> [M, D]; y0 [M, D]. A torch y0 solves on its
    own device; any other y0 goes to ``device``, by default the CUDA card.
    mass: [D, D] or [M, D, D], singular allowed (index 1).

    t_eval: shared output grid [T]; ``Solution.ys`` [M, T, D] from the CONTRO
    cubic. events: ``solve.events.Event`` spec(s), located on the cubic; a
    terminal event stops the lane at t* (samples past t* NaN, quad up to
    t*). dense: step-mesh capacity N > 0 storing every accepted step's cubic
    in the power basis y_k + Σ_p θ^{p+1}·q_k[p] for
    ``Solution.interpolate(ts)`` (overflowing lanes interpolate to NaN).
    quad: running-cost integrand ``l(t [M], y [M, D], args) -> [M]`` or
    [M, Q]; ``Solution.quad`` by 3-point Gauss-Legendre on each accepted
    step's cubic.

    tangents [K, M, D] / args_tangents (args' tree with a leading K axis):
    forward sensitivities by internal differentiation, terminal mode only.
    A Rosenbrock step is linearly implicit, so its tangent is direct: each
    tangent increment solves the step's factored E against the exact
    derivative of the stage right-hand side (a jvp of f at the stage point,
    plus dJ[δ]·k_i and the f_t cross term dfₜ[δ]); six back-substitutions a
    direction, no extra factorization. ``Solution.sens`` [K, M, D].

    ``_mesh_size`` (the accepted-step rings of the discrete adjoint) and
    ``_h0`` (a per-lane warm-start step, 0 = automatic) are the adjoint's
    seats. The host syncs of the last solve are in
    ``solve_rodas.host_syncs``.
    """
    opts = options if options is not None else Options()
    store_q = bool(dense)
    if dense:
        _mesh_size = max(_mesh_size, int(dense))
    if opts.nind2 or opts.nind3:
        raise ValueError("Options.nind2/nind3 (higher-index DAE error "
                         "weighting) is honored by 'radau'/'radaup' only; "
                         "rodas is index-1 capable via mass= alone")
    if opts.kernel_lu and opts.pivoting:
        raise ValueError("Options(kernel_lu=True) needs pivoting=False "
                         "(the SoA kernels are pivot-free)")
    use_sens = tangents is not None or args_tangents is not None
    use_slabs = step_args is not None
    if use_slabs and (use_sens or _mesh_size):
        # one contract with solve_radau (dense= set _mesh_size above)
        raise ValueError(STEP_ARGS_GUARD)
    if use_sens and (t_eval is not None or events is not None):
        raise ValueError("solve_rodas(tangents=) is terminal-mode only "
                         "(no tangent dense output/event correction); use "
                         "torch.func.jvp through the solve for those")
    specs = normalize_events(events)
    t0, tf, y0 = cm.broadcast_batch(t0, tf, y0, device)
    refuse_kernel_derivatives(opts.kernel_lu, "solve_rodas", y0, t0, tf,
                              args, tangents, args_tangents, mass, step_args)
    m, dim = y0.shape
    dtype, dev = y0.dtype, y0.device
    syncs = cm._HostSyncs()
    jac_fn = jac if jac is not None else default_jacobian(f)
    if mass is not None:
        mass = cm.like(mass, y0)
    mdot = mass_dot(mass)
    if opts.kernel_lu:
        factor = _kernel_lu_factor
    else:
        def factor(a):
            return lu_factor(a, pivot=opts.pivoting)

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
        args_rows = [None] * yd.shape[0] if args_d is None else \
            [cm.tree_map(lambda a, _k=k: a[_k], args_d)
             for k in range(yd.shape[0])]

    if use_slabs:
        # a lane's k-th accepted-step attempt (J, f, f_t and every stage)
        # runs on slab row k, as f(t, y, (args, slab_k))
        n_slabs, slab_at = cm.make_slab_selector(step_args, y0)
        args0 = (args, slab_at(torch.zeros((m,), dtype=torch.int32,
                                           device=dev)))
    else:
        args0 = args
    f0 = f(t0, y0, args0)
    direction = torch.where(tf >= t0, 1.0, -1.0).to(dtype)
    # singular-mass systems: f0 is no derivative on the algebraic rows, so
    # start small (the policy of solve_radau)
    h_small = torch.clamp(torch.abs(tf - t0) * 1e-2, max=1e-3)
    if _h0 is not None:
        # per-lane warm start (segment chaining, solve.adjoint_rodas): lanes
        # with _h0 == 0 take the automatic initial step
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

    stats = cm.zero_stats(m, ("nfev", "njev", "nlu", "nsteps", "naccept",
                              "nreject"), dev)
    stats["nfev"] = stats["nfev"] + 2
    mesh = None
    if _mesh_size:
        # accepted-step rings for the discrete adjoint (solve.adjoint_rodas):
        # (t, h, y) at the START of each accepted step, each slot written
        # once, by index; steps past the capacity are dropped, and the
        # adjoint poisons a lane whose naccept exceeds it
        mesh = {"t": y0.new_zeros((m, _mesh_size)),
                "h": y0.new_zeros((m, _mesh_size)),
                "y": y0.new_zeros((m, _mesh_size, dim))}
        if store_q:
            mesh["q"] = y0.new_zeros((m, _mesh_size, 3, dim))

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    t, y = t0, y0
    f1, fx = f0, zeros(m, dim)
    jmat, lu_m = zeros(m, dim, dim), zeros(m, dim, dim)
    piv_m = zeros(m, dim, dt=torch.int32)
    h_fact = zeros(m)
    need_jac = torch.ones((m,), dtype=torch.bool, device=dev)
    h_acc, err_acc = zeros(m), zeros(m)
    rejected = zeros(m, dt=torch.bool)
    nsing = zeros(m, dt=torch.int32)
    already_done = t0 == tf
    active = ~already_done
    status = torch.where(already_done, cm.SUCCESS, cm.RUNNING).to(torch.int8)
    ev = init_event_state(specs, m, dim, t0, y0, args)
    eps = torch.finfo(dtype).eps

    while syncs.any(active):
        remaining = tf - t
        last = torch.abs(h_st) >= torch.abs(remaining)
        h = torch.where(last, remaining, h_st)
        h = torch.where(h == 0.0, eps, h)
        if use_slabs:
            exhausted = active & (stats["naccept"] >= n_slabs)
            fa = (args, slab_at(stats["naccept"]))
        else:
            fa = args

        # ---- Jacobian, f and f_t at the step point (every new point) -----
        needj = need_jac & active
        jmat = torch.where(needj[:, None, None], jac_fn(t, y, fa), jmat)
        f1 = torch.where(needj[:, None], f(t, y, fa), f1)
        fx = torch.where(needj[:, None], ft_at(f, t, y, fa), fx)

        # ---- factor E = M/(h·γ) − J (lanes whose h or J changed) ---------
        needf = active & (needj | (h != h_fact))
        lu_n, piv_n = factor(iteration_matrix(mass, h, jmat))
        lu_m = torch.where(needf[:, None, None], lu_n, lu_m)
        piv_m = torch.where(needf[:, None], piv_n, piv_m)
        fact_ok = torch.where(needf, lu_ok(lu_n), True)
        h_fact = torch.where(needf, h, h_fact)
        singular = active & ~fact_ok

        # ---- the 6 stages -------------------------------------------------
        if opts.kernel_lu:
            def slv(rhs, _lu=lu_m):
                return _kernel_lu_solve(_lu, rhs)
        else:
            def slv(rhs, _lu=lu_m, _piv=piv_m):
                return lu_solve(_lu, _piv, rhs, pivot=opts.pivoting)

        ks, y5, y_emb, y_new = stage_increments(f, slv, mdot, t, h, y, f1,
                                                fx, fa)
        t_new = t + h

        # ---- error estimate: the 6th increment is the embedded diff ------
        scale = opts.atol + opts.rtol * torch.maximum(torch.abs(y),
                                                      torch.abs(y_new))
        enorm = cm.rms_norm(ks[5], scale)
        enorm = torch.where(torch.isfinite(enorm)
                            & torch.isfinite(y_new).all(dim=-1), enorm, 1e10)
        enorm = torch.clamp(enorm, min=1e-16)

        ok_step = active & fact_ok
        if use_slabs:
            ok_step = ok_step & ~exhausted
        accept = ok_step & (enorm <= 1.0)
        reject = ok_step & (enorm > 1.0)

        # ---- controller (order 4 => exponent 1/4) + Gustafsson ------------
        h_abs = torch.abs(h)
        fac = torch.clamp(opts.safety * enorm ** -0.25, opts.min_factor,
                          opts.max_factor)
        if opts.gustafsson:
            have = h_acc > 0
            gfac = (opts.safety * (h_abs / torch.where(have, h_acc, 1.0))
                    * (err_acc / torch.clamp(enorm * enorm, min=1e-32))
                    ** 0.25)
            gfac = torch.clamp(gfac, opts.min_factor, opts.max_factor)
            fac = torch.where(accept & have, torch.minimum(fac, gfac), fac)
        # after a rejection do not regrow immediately (rodas.f:848)
        fac = torch.where(accept & rejected, torch.clamp(fac, max=1.0), fac)

        # ---- dense output, events, quadrature (the CONTRO cubic) ---------
        if use_dense or specs or use_quad or store_q:
            cont2, cont3 = contro(ks)
            interp = contro_interp(y, y_new, cont2, cont3)
        if use_dense:
            out_ys = cm.collect_dense(out_ys, t_eval, t, h, accept, interp)
        ev, terminate, t_ev, y_ev, _ = handle_events(
            specs, ev, t, h, t_new, y_new, interp if specs else None,
            accept, args, syncs)
        if use_dense and specs:
            out_ys = cm.mask_dense_after_event(out_ys, t_eval, terminate,
                                               t_ev, h)
        if use_quad:
            q_acc = cm.quad_gl3_step(ql, t, h, interp, accept, terminate,
                                     t_ev, q_acc)

        # ---- IND tangent sweep (the exact derivative of the frozen-h step)
        if use_sens:
            yd = torch.where(accept[None, :, None], _tangent_step(
                f, jac_fn, mdot, slv, opts.kernel_lu, t, h, y,
                ks, y5, y_emb, yd, args, args_rows), yd)

        if mesh is not None:
            values = {"t": t, "h": h, "y": y}
            if store_q:
                # the cubic in the shared power basis y0 + Σ_p θ^{p+1} q[p]
                values["q"] = torch.stack([(y_new - y) + cont2,
                                           cont3 - cont2, -cont3], dim=1)
            cm.ring_write(mesh, stats["naccept"], accept, values)

        # ---- bookkeeping --------------------------------------------------
        done = accept & last
        h_next_abs = torch.where(accept | reject, h_abs * fac,
                                 torch.where(singular, h_abs * 0.5, h_abs))
        h_next_abs = torch.clamp(h_next_abs, max=opts.max_step)
        h_st = torch.where(active, h_next_abs * torch.sign(h), h_st)

        stats["nfev"] = stats["nfev"] + _i32(ok_step) * 5 + _i32(needj)
        stats["njev"] = stats["njev"] + _i32(needj)
        stats["nlu"] = stats["nlu"] + _i32(needf)
        stats["nsteps"] = stats["nsteps"] + _i32(ok_step | singular)
        stats["naccept"] = stats["naccept"] + _i32(accept)
        stats["nreject"] = stats["nreject"] + _i32(reject | singular)

        nsing = torch.where(singular, nsing + 1,
                            torch.where(accept, 0, nsing))
        stall = active & (nsing >= 5)
        exceeded = active & (stats["nsteps"] >= opts.max_steps) & ~done
        # Hairer's t-relative underflow test (rodas.f:607)
        underflow = active & (0.1 * h_next_abs <= eps * torch.abs(t_new)) \
            & ~done

        status = torch.where(done, cm.SUCCESS, status)
        status = torch.where(exceeded, cm.MAX_STEPS, status)
        status = torch.where(underflow, cm.STEP_UNDERFLOW, status)
        status = torch.where(stall, cm.NEWTON_STALL, status)
        if use_slabs:
            status = torch.where(exhausted, cm.PARAMS_EXHAUSTED, status)
            active = active & ~exhausted
        status = torch.where(terminate, cm.EVENT_TERMINATED, status)
        active = active & ~done & ~exceeded & ~underflow & ~stall & ~terminate

        t = torch.where(accept, torch.where(terminate, t_ev, t_new), t)
        y = torch.where(accept[:, None],
                        torch.where(terminate[:, None], y_ev, y_new), y)
        h_fact = torch.where(accept, 0.0, h_fact)
        need_jac = torch.where(accept, True,
                               torch.where(needj, False, need_jac))
        h_acc = torch.where(accept, h_abs, h_acc)
        err_acc = torch.where(accept, torch.clamp(enorm, min=1e-2), err_acc)
        rejected = torch.where(accept, False, rejected | reject)

    solve_rodas.host_syncs = syncs.count
    return cm.Solution(
        t=t, y=y, status=status, stats=stats,
        ts=t_eval if use_dense else None,
        ys=out_ys if use_dense else None,
        event_t=ev["event_t"] if specs else None,
        event_y=ev["event_y"] if specs else None,
        event_idx=ev["event_idx"] if specs else None,
        sens=yd if use_sens else None,
        quad=(q_acc[:, 0] if quad_scalar else q_acc) if use_quad else None,
        mesh=mesh, h_next=h_st)


solve_rodas.host_syncs = 0


def _tangent_step(f, jac_fn, mdot, slv, kernel_lu, t, h, y, ks, y5, y_emb,
                  yd, args, args_rows):
    """yd [K, M, D] through one step: the exact derivative of the frozen-h
    step map. Each stage's tangent solves the step's factored E against
    f_y·d_i (+ f_θ·dθ_k) + h·d_i·dfₜ[δ] + M·Σ_j (c_ij/h)·dk_j + dJ[δ]·k_i,
    a jvp of f at the stage point per direction; dJ[δ] and dfₜ[δ] are jvp's
    of the Jacobian and f_t maps at the step point."""
    k1, k2, k3, k4, k5, k6 = ks
    k_dirs = yd.shape[0]

    def app(fn, at, dys):
        """[K, ...]: the jvp of fn(y', args) at y' = at along each direction
        (joint with the direction's parameter tangent, where there is
        one)."""
        return torch.stack([
            jvp(lambda yy: fn(yy, args), (at,), (dys[k],))[1]
            if args_rows[k] is None else
            jvp(fn, (at, args), (dys[k], args_rows[k]))[1]
            for k in range(k_dirs)])

    def f_at(ti):
        return lambda yy, aa: f(ti, yy, aa)

    def slv_k(rhs):                          # [K, M, D]
        if kernel_lu:                        # K2 once per direction
            return torch.stack([slv(rhs[k]) for k in range(k_dirs)])
        # the plain LU solves the K right-hand sides as columns
        return slv(rhs.permute(1, 2, 0)).permute(2, 0, 1)

    djac = app(lambda yy, aa: jac_fn(t, yy, aa), y, yd)   # [K, M, D, D]
    dfx = app(lambda yy, aa: ft_at(f, t, yy, aa), y, yd)  # [K, M, D]

    def djk(ki):                             # −d(E)·k_i = dJ[δ]·k_i
        return cm.lane_einsum("kmij,mj->kmi", djac, ki)

    hck = h[None, :, None]
    dk1 = slv_k(app(f_at(t), y, yd) + (h * D1)[None, :, None] * dfx
                + djk(k1))
    d2 = yd + A21 * dk1
    dk2 = slv_k(app(f_at(t + C2 * h), y + A21 * k1, d2)
                + (h * D2)[None, :, None] * dfx + mdot(C21 * dk1) / hck
                + djk(k2))
    d3 = yd + A31 * dk1 + A32 * dk2
    dk3 = slv_k(app(f_at(t + C3 * h), y + A31 * k1 + A32 * k2, d3)
                + (h * D3)[None, :, None] * dfx
                + mdot(C31 * dk1 + C32 * dk2) / hck + djk(k3))
    d4 = yd + A41 * dk1 + A42 * dk2 + A43 * dk3
    dk4 = slv_k(app(f_at(t + C4 * h), y + A41 * k1 + A42 * k2 + A43 * k3, d4)
                + (h * D4)[None, :, None] * dfx
                + mdot(C41 * dk1 + C42 * dk2 + C43 * dk3) / hck + djk(k4))
    d5 = yd + A51 * dk1 + A52 * dk2 + A53 * dk3 + A54 * dk4
    dk5 = slv_k(app(f_at(t + h), y5, d5)
                + mdot(C51 * dk1 + C52 * dk2 + C53 * dk3 + C54 * dk4) / hck
                + djk(k5))
    d_emb = d5 + dk5
    dk6 = slv_k(app(f_at(t + h), y_emb, d_emb)
                + mdot(C61 * dk1 + C62 * dk2 + C63 * dk3 + C64 * dk4
                       + C65 * dk5) / hck + djk(k6))
    return d_emb + dk6
