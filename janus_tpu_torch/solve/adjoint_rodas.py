"""Discrete-adjoint reverse mode on the batched RODAS4 solver.

The port of ``janus_tpu/solve/adjoint_rodas.py``. ``rodas_adjoint`` returns
the final state of an adaptive ``solve_rodas`` run through a
``torch.autograd.Function`` whose backward pass is the EXACT TRANSPOSE of the
solver's step map on the recorded accepted-step mesh. A Rosenbrock step is
linearly implicit (one factorization, six solves, no Newton iteration), so
one accepted step is a closed-form differentiable function

    y_{n+1} = Φ(t_n, h_n, y_n, θ),

and its vjp, a ``torch.func.vjp`` of a replay of the step at the recorded
(t_n, h_n, y_n), is exact to rounding. The second-order terms (the pull
through the Jacobian's own evaluation and through f_t's jvp in t) come out of
the vjp, which composes over the ``torch.func.jvp``'s of ``default_jacobian``
and ``rodas.ft_at``.

How the sweep is built:
- a Python loop over the step index k = max(naccept)−1 … 0 (one host read
  before it: every slot above is dead for every lane, so nothing is lost
  against the reference's scan over all ``adjoint_steps`` slots, and the
  sweep costs one sync instead of one per slot), with a per-lane live mask;
- dead slots are replayed at a benign step (t0, h = 1, y0) under a zero
  cotangent: their mesh entries are zeros (h = 0 gives inf in the replay,
  and 0 × inf = NaN would reach the shared-leaf gradients);
- a lane whose accepted steps overflowed the mesh gets NaN, and then every
  shared leaf's gradient does: never a silently truncated gradient.

Frozen-mesh convention: (t_n, h_n) are data, exactly as in the forward IND
tangents (``solve_rodas(tangents=)``), so grad(rodas_adjoint)ᵀ·δ ==
ȳ·solve_rodas(tangents=[δ]).sens to rounding: the two are transposes of the
same linear map. Against central differences of the full solve the gradient
differs by the controller's O(rtol) mesh sensitivity.

Scope: terminal mode; ``t_eval=`` (chained segments); terminal ``events=``
returning (y*, t*), both differentiable through the vjp of the triggering
step's replayed CONTRO-cubic endpoint with θ* re-polished by two Newton
steps from the recorded root; ``cost=`` (q̄ pulled through each step's
replayed GL-3 increment, ``common.gl3_increment``, the function the forward
``quad=`` accumulates with); events with ``t_eval`` (``adjoint.
chain_segments``); ``mass=`` including singular index-1 masses, and with
``n_alg`` the constrained boundary velocity for the t0/tf cotangents
(``adjoint.constrained_ydot``, pivoting as ``Options.pivoting``). The
backward pass runs no kernel: ``Options(kernel_lu=True)`` raises, since K1
and K2 have no backward (the reference refuses ``pallas_lu`` alike).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.autograd.function import once_differentiable
from torch.func import jvp, vjp

from janus_tpu_torch.linalg.smalllu import lu_factor, lu_solve
from janus_tpu_torch.solve import common as cm
from janus_tpu_torch.solve import rodas as rd
from janus_tpu_torch.solve.adjoint import (_split_diff, adjoint_outputs,
                                           boundary_cotangents,
                                           chain_segments, constrained_ydot,
                                           event_index, sampled_outputs)
from janus_tpu_torch.solve.events import normalize_events
from janus_tpu_torch.solve.options import Options
from janus_tpu_torch.solve.radau import default_jacobian


def _one_step(f, jac_fn, mass, opts, t, h, y, args, want_interp=False):
    """Replay ONE accepted RODAS4 step at frozen (t, h): the differentiable
    step map Φ, with the accepted-step arithmetic of ``solve_rodas``. Every
    accepted step starts with a fresh J, f and f_t there, so the replay's
    evaluations reproduce the forward's. want_interp: also return the
    CONTRO cubic's (cont2, cont3)."""
    jmat = jac_fn(t, y, args)
    f1 = f(t, y, args)
    fx = rd.ft_at(f, t, y, args)
    lu_m, piv_m = lu_factor(rd.iteration_matrix(mass, h, jmat),
                            pivot=opts.pivoting)
    ks, _, _, y_new = rd.stage_increments(
        f, lambda rhs: lu_solve(lu_m, piv_m, rhs, pivot=opts.pivoting),
        rd.mass_dot(mass), t, h,
        y, f1, fx, args)
    if not want_interp:
        return y_new
    return (y_new, *rd.contro(ks))


def rodas_adjoint(f: Callable, tspan, y0, args=None,
                  options: Optional[Options] = None,
                  jac: Optional[Callable] = None, mass=None, t_eval=None,
                  events=None, cost: Optional[Callable] = None,
                  n_alg: int = 0, device=None):
    """Reverse-differentiable batched adaptive RODAS4 solve.

    Returns the final state y(T) [M, D], or with ``t_eval`` the sampled
    trajectory ys [M, T, D]. ``backward()`` of any function of the result
    flows through the discrete adjoint to y0, every floating-point tensor
    leaf of ``args``, t0, tf and (t_eval mode) the sample times, where those
    are tensors that require grad. A y0 that is not a tensor goes to
    ``device``, by default the CUDA card. Memory: one (t, h, y) slot per
    accepted step, ``options.adjoint_steps`` slots per lane PER SEGMENT (the
    gradient is NaN on overflow).

    t_eval: strictly monotonic 1-D grid inside (t0, tf], in the direction of
    integration; the solve is chained over t0 → t_eval[0] → … → t_eval[-1]
    (warm-started segments), so samples are exact solve endpoints.
    Integration stops at t_eval[-1].

    events: TERMINAL event spec(s) (every event terminal). Returns
    ``(y, t)``, the state and time a lane stopped at (t < tf on a triggered
    lane), both differentiable; with t_eval ``(ys, y*, t*)``, samples
    strictly past t* NaN.

    cost: running-cost integrand ``l(t [M], y [M, D], args) -> [M]`` or
    [M, Q]; appends ``q = ∫ l dt`` to the outputs (``(y, q)``, ``(ys, q)``
    summed over the grid, ``(y, t, q)`` with events, q truncated at t*),
    and q's cotangent flows through the same backward sweep.

    n_alg: the number of trailing algebraic variables of a semi-explicit
    index-1 DAE (mass = blockdiag(A, 0)): the t0/tf cotangents use the
    constrained velocity.

    The host syncs of the last backward sweep are in
    ``rodas_adjoint.host_syncs`` (the forward's in
    ``solve_rodas.host_syncs``).
    """
    opts = options if options is not None else Options()
    if n_alg and mass is None:
        raise ValueError("n_alg > 0 (semi-explicit index-1 DAE boundary "
                         "velocity) needs mass=blockdiag(A, 0); without a "
                         "mass matrix the system is an ODE")
    if opts.kernel_lu:
        raise ValueError("rodas_adjoint replays steps under torch.func.vjp; "
                         "the kernels K1/K2 have no backward: use "
                         "kernel_lu=False")
    specs = normalize_events(events)
    if specs and not all(e.terminal for e in specs):
        raise ValueError("rodas_adjoint(events=...) requires every event "
                         "terminal (non-terminal recordings have no "
                         "gradient contract)")
    y0 = cm.on_device(y0, device)
    if mass is not None:
        mass = cm.like(mass, y0)
    t0, tf = tspan

    def run(ta, tb, y, args_, h0):
        dleaves, rebuild, _, _ = _split_diff(args_)
        cfg = {"f": f, "opts": opts, "jac": jac, "mass": mass,
               "n_alg": n_alg, "cost": cost, "events": specs,
               "rebuild": rebuild}
        return _RodasAdjointFn.apply(cfg, ta, tb, y, h0, *dleaves)

    if t_eval is None:
        return adjoint_outputs(run(t0, tf, y0, args, None), bool(specs))
    return sampled_outputs(*chain_segments(run, t0, tf, y0, args, t_eval,
                                           bool(specs), "rodas_adjoint"),
                           bool(specs))


rodas_adjoint.host_syncs = 0


class _RodasAdjointFn(torch.autograd.Function):
    """One adaptive RODAS4 solve (a whole span or one chained segment) with
    the discrete adjoint as its backward. Inputs: the static set-up ``cfg``,
    then t0, tf, y0, h0 and the differentiable leaves of args. Outputs (y,
    t, h_next, event_idx[, q]); h_next and event_idx are not
    differentiable."""

    @staticmethod
    def forward(ctx, cfg, t0, tf, y0, h0, *dleaves):
        with torch.no_grad():
            sol = rd.solve_rodas(
                cfg["f"], t0, tf, y0, cfg["rebuild"](dleaves), cfg["opts"],
                jac=cfg["jac"], mass=cfg["mass"],
                events=cfg["events"] or None, quad=cfg["cost"],
                _mesh_size=cfg["opts"].adjoint_steps, _h0=h0)
        ctx.cfg = cfg
        ctx.y0_shape = y0.shape
        ctx.n_leaves = len(dleaves)
        ctx.t_in = tuple(x if not isinstance(x, torch.Tensor) else None
                         for x in (t0, tf))
        idx = event_index(sol)
        tensors = [x for x in (t0, tf) if isinstance(x, torch.Tensor)]
        tensors += [y0, *dleaves, sol.y, sol.t, idx, sol.stats["naccept"],
                    sol.mesh["t"], sol.mesh["h"], sol.mesh["y"]]
        ctx.save_for_backward(*tensors)
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(sol.h_next, idx)
        outs = (sol.y, sol.t, sol.h_next, idx)
        return outs + (sol.quad,) if cfg["cost"] is not None else outs

    @staticmethod
    @once_differentiable
    def backward(ctx, ybar, tbar, _hbar, _idxbar, qbar=None):
        cfg = ctx.cfg
        saved = list(ctx.saved_tensors)
        t0, tf = (saved.pop(0) if x is None else x for x in ctx.t_in)
        y0 = saved.pop(0)
        dleaves = [saved.pop(0) for _ in range(ctx.n_leaves)]
        y_end, t_end, ev_idx, nacc, *rings = saved
        mesh = dict(zip(("t", "h", "y"), rings))
        del saved, rings
        t0b, _, y0b = cm.broadcast_batch(t0, tf, y0)
        lam0, gleaves, t0bar, tfbar = _discrete_sweep(
            cfg, mesh, nacc, t0b, y0b, t_end, y_end, ev_idx, dleaves, ybar,
            tbar, qbar)
        return (None, *boundary_cotangents(t0, tf, t0bar, tfbar),
                lam0.reshape(ctx.y0_shape), None, *gleaves)


def _discrete_sweep(cfg, mesh, nacc, t0b, y0b, t_end, y_end, ev_idx, dleaves,
                    ybar, tbar, qbar):
    """The backward loop over the recorded mesh: (λ(t0) [M, D], the leaves'
    gradients, t̄0 [M], t̄f [M])."""
    opts, mass, rebuild = cfg["opts"], cfg["mass"], cfg["rebuild"]
    specs, cost = cfg["events"], cfg["cost"]
    use_cost = cost is not None
    m = y_end.shape[0]
    dtype = y_end.dtype
    cap = mesh["t"].shape[1]

    def fa(t, y, dl):
        return cfg["f"](t, y, rebuild(dl))

    jac_user = cfg["jac"]
    jac_fn = (lambda t, y, dl: jac_user(t, y, rebuild(dl))) if jac_user \
        else default_jacobian(fa)
    lam = torch.zeros_like(y_end) if ybar is None else ybar.to(dtype)
    ybar = lam
    tbar = torch.zeros_like(t_end) if tbar is None \
        else tbar.to(dtype).broadcast_to((m,))
    if use_cost:
        def lfun(t, y, dl):                        # canon [M, Q]
            return cm.canon_cost(cost(t, y, rebuild(dl)))

        l_end = lfun(t_end, y_end, dleaves)
        qb = torch.zeros_like(l_end) if qbar is None \
            else qbar.to(dtype).reshape(l_end.shape)      # [M, Q]

    def step(t, h, y, dl):
        if not use_cost:
            return _one_step(fa, jac_fn, mass, opts, t, h, y, dl)
        y_new, c2, c3 = _one_step(fa, jac_fn, mass, opts, t, h, y, dl,
                                  want_interp=True)
        q_inc = cm.gl3_increment(lambda tt, yy: lfun(tt, yy, dl), t, h,
                                 rd.contro_interp(y, y_new, c2, c3),
                                 torch.ones_like(t))
        return y_new, q_inc

    triggered = ev_idx >= 0

    def evt_endpoint(t, h, y, dl, th0):
        # (y*, t*[, the last quadrature increment]) of the triggering step
        # as a differentiable map: replay the step, rebuild the CONTRO cubic
        # and re-polish θ* by TWO Newton steps from the recorded root;
        # starting converged, the polished iterate's derivative is the
        # implicit-function derivative to O(residual²)
        y_new, c2, c3 = _one_step(fa, jac_fn, mass, opts, t, h, y, dl,
                                  want_interp=True)
        interp = rd.contro_interp(y, y_new, c2, c3)
        one_hot = (torch.arange(len(specs), device=y.device)[:, None]
                   == torch.clamp(ev_idx, min=0)[None, :]).to(dtype)

        def gfun(th):          # the lane's OWN terminating event function
            vals = torch.stack([e.fn(t + th * h, interp(th[:, None])[:, 0],
                                     rebuild(dl)).to(dtype) for e in specs])
            return torch.sum(one_hot * vals, dim=0)

        th = th0
        for _ in range(2):
            gv, dg = jvp(gfun, (th,), (torch.ones_like(th),))
            th = th - gv / torch.where(dg == 0.0, 1.0, dg)
        outs = (interp(th[:, None])[:, 0], t + th * h)
        if use_cost:
            outs = outs + (cm.gl3_increment(lambda tt, yy: lfun(tt, yy, dl),
                                            t, h, interp, th),)
        return outs

    grads = [torch.zeros_like(leaf) for leaf in dleaves]
    # one host read: the longest mesh, and the slot of each lane's event step
    # (every slot above max(naccept) is dead on every lane)
    host = torch.cat([nacc.max()[None],
                      torch.where(triggered, nacc - 1, -1)]).tolist()
    n_live, evt_slots = min(host[0], cap), set(host[1:]) - {-1}
    for k in range(n_live - 1, -1, -1):
        live = k < nacc                                   # [M]
        # dead slots hold zeros: substitute a benign step under a zero
        # cotangent
        tk = torch.where(live, mesh["t"][:, k], t0b)
        hk = torch.where(live, mesh["h"][:, k], 1.0)
        yk = torch.where(live[:, None], mesh["y"][:, k], y0b)
        lam_in = torch.where(live[:, None], lam, 0.0)
        is_evt = live & triggered & (k == nacc - 1)
        if k in evt_slots:
            # the triggering lane's last slot carries the whole (ȳ*, t̄*[,
            # q̄]) cotangent through the event endpoint instead
            lam_in = torch.where(is_evt[:, None], 0.0, lam_in)
        pull = vjp(lambda yy, dl: step(tk, hk, yy, dl), yk, dleaves)[1]
        if use_cost:
            # q is the sum of the increments: each live step takes all of q̄
            qb_k = torch.where((live & ~is_evt)[:, None], qb, 0.0)
            dy, dgl = pull((lam_in, qb_k))
        else:
            dy, dgl = pull(lam_in)
        if k in evt_slots:
            th0 = torch.clamp((t_end - tk) / torch.where(hk == 0.0, 1.0, hk),
                              0.0, 1.0)
            th0 = torch.where(is_evt, th0, 0.5)
            pull_e = vjp(lambda yy, dl: evt_endpoint(tk, hk, yy, dl, th0),
                         yk, dleaves)[1]
            ct = (torch.where(is_evt[:, None], lam, 0.0),
                  torch.where(is_evt, tbar, 0.0))
            if use_cost:
                ct = ct + (torch.where(is_evt[:, None], qb, 0.0),)
            dye, dgle = pull_e(ct)
            dy = dy + torch.where(is_evt[:, None], dye, 0.0)
            dgl = [g + ge for g, ge in zip(dgl, dgle)]
        lam = torch.where(live[:, None], dy, lam)
        grads = [g + d for g, d in zip(grads, dgl)]

    # overflow: a lane that accepted more steps than the ring holds has an
    # incomplete mesh; poison it, and the shared leaves' gradients
    over = nacc > cap
    lam0 = torch.where(over[:, None], torch.nan, lam)
    any_over = over.any()
    grads = [torch.where(any_over, torch.nan, g) for g in grads]

    # boundary times: t̄0 = −λ0·ẏ(t0), t̄f = ȳ·ẏ(T) with the TRUE velocity
    # (M⁻¹f, or with n_alg the constrained velocity of the index-1 DAE)
    def ydot(t, y):
        return constrained_ydot(fa, t, y, dleaves, mass, cfg["n_alg"],
                                pivot=opts.pivoting)

    tfbar = torch.sum(ybar * ydot(t_end, y_end), dim=-1)
    if use_cost:
        # the quadrature's endpoint moves with tf: dq/dT = l(T, y(T))
        tfbar = tfbar + torch.sum(qb * l_end, dim=-1)
    # a triggered lane stopped at t* < tf: tf moves nothing (frozen mesh);
    # an untriggered one returns t = tf exactly, so t̄ adds 1:1
    tfbar = torch.where(triggered, 0.0, tfbar + tbar)
    t0bar = -torch.sum(lam0 * ydot(t0b, y0b), dim=-1)
    if use_cost:
        t0bar = t0bar - torch.sum(qb * lfun(t0b, y0b, dleaves), dim=-1)
    rodas_adjoint.host_syncs = 1
    return lam0, grads, t0bar, tfbar
