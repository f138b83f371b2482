"""The discrete adjoints' shared Function and backward sweep (rodas, dopri,
seulex; the Function and the sweep's pieces also NDF's).

A discrete adjoint differentiates the solver's own step map: one accepted
step is a closed-form function y_{n+1} = Φ(t_n, h_n, y_n, θ) of the recorded
(t_n, h_n), and the backward pass pulls the cotangent through a
``torch.func.vjp`` of a replay of each recorded step, last to first. A
family supplies, in ``cfg``:

- ``solve(t0, tf, y0, args, h0)``: the forward solve with the (t, h, y)
  mesh of its accepted steps (``_mesh_size=options.adjoint_steps``) and,
  with ``cost``, its quadrature;
- ``replay(t, h, y, dleaves, live, want_interp)``: the step map Φ, and
  with want_interp also the step's dense interpolant θ [M, T] -> [M, T, D];
  ``live`` [M] flags the lanes replaying a live slot;
- optionally ``level_ring``, the name of an integer mesh ring (SEULEX's
  accepted level): the replay then also takes the slot's column of it and,
  as a Python int, its largest entry over the slot's live lanes (read with
  the sweep's one host read), so that it runs no level above that;
- ``ydot(t, y, dleaves)``: the true state velocity at a boundary;
- ``events`` (terminal), ``cost``, ``rebuild`` (the args tree from its
  differentiable leaves) and ``entry``, the public function whose
  ``host_syncs`` the sweep sets;
- optionally ``sweep``, a backward loop of its own with ``sweep``'s
  signature, for a family whose state is not y alone (NDF carries a whole
  difference array); it then needs no ``replay``, and its mesh may hold
  any rings.

How the sweep is built:
- a Python loop over the step index k = max(naccept)−1 … 0 (one host read
  before it: every slot above is dead for every lane, so the sweep costs one
  sync instead of one per slot), with a per-lane live mask;
- dead slots are replayed at a benign step (t0, h = 1, y0) under a zero
  cotangent (their mesh entries are zeros: h = 0 gives inf in an implicit
  replay, and 0 × inf = NaN would reach the shared leaves' gradients);
- a terminally triggered lane's last slot takes its whole (ȳ*, t̄*[, q̄])
  cotangent through the replayed interpolant with θ* re-polished by two
  Newton steps from the recorded root;
- a lane whose accepted steps overflowed the mesh gets NaN, and then every
  shared leaf's gradient does: never a silently truncated gradient.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable
from torch.func import jvp, vjp

from janus_tpu_torch.solve import common as cm
from janus_tpu_torch.solve.adjoint import boundary_cotangents, event_index


class DiscreteAdjointFn(torch.autograd.Function):
    """One adaptive solve (a whole span or one chained segment) with the
    discrete adjoint as its backward. Inputs: the static set-up ``cfg``
    (module docstring), then t0, tf, y0, h0 and the differentiable leaves of
    args. Outputs (y, t, h_next, event_idx[, q]); h_next and event_idx are
    not differentiable."""

    @staticmethod
    def forward(ctx, cfg, t0, tf, y0, h0, *dleaves):
        with torch.no_grad():
            sol = cfg["solve"](t0, tf, y0, cfg["rebuild"](dleaves), h0)
        ctx.cfg = cfg
        ctx.lockstep = cm.LOCKSTEP.get()
        ctx.y0_shape = y0.shape
        ctx.n_leaves = len(dleaves)
        ctx.t_in = tuple(x if not isinstance(x, torch.Tensor) else None
                         for x in (t0, tf))
        idx = event_index(sol)
        ctx.mesh_keys = tuple(sol.mesh)
        tensors = [x for x in (t0, tf) if isinstance(x, torch.Tensor)]
        tensors += [y0, *dleaves, sol.y, sol.t, idx, sol.stats["naccept"],
                    *sol.mesh.values()]
        ctx.save_for_backward(*tensors)
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(sol.h_next, idx)
        outs = (sol.y, sol.t, sol.h_next, idx)
        return outs + (sol.quad,) if cfg["cost"] is not None else outs

    @staticmethod
    @once_differentiable
    @cm.keeps_lockstep
    def backward(ctx, ybar, tbar, _hbar, _idxbar, qbar=None):
        cfg = ctx.cfg
        saved = list(ctx.saved_tensors)
        t0, tf = (saved.pop(0) if x is None else x for x in ctx.t_in)
        y0 = saved.pop(0)
        dleaves = [saved.pop(0) for _ in range(ctx.n_leaves)]
        y_end, t_end, ev_idx, nacc, *rings = saved
        mesh = dict(zip(ctx.mesh_keys, rings))
        del saved, rings
        t0b, _, y0b = cm.broadcast_batch(t0, tf, y0)
        lam0, gleaves, t0bar, tfbar = cfg.get("sweep", sweep)(
            cfg, mesh, nacc, t0b, y0b, t_end, y_end, ev_idx, dleaves, ybar,
            tbar, qbar)
        cfg["entry"].host_syncs = 1
        return (None, *boundary_cotangents(t0, tf, t0bar, tfbar),
                lam0.reshape(ctx.y0_shape), None, *gleaves)


def sweep(cfg, mesh, nacc, t0b, y0b, t_end, y_end, ev_idx, dleaves, ybar,
          tbar, qbar):
    """The backward loop over the recorded mesh: (λ(t0) [M, D], the leaves'
    gradients, t̄0 [M], t̄f [M])."""
    replay, rebuild = cfg["replay"], cfg["rebuild"]
    specs, cost = cfg["events"], cfg["cost"]
    use_cost = cost is not None
    m = y_end.shape[0]
    dtype = y_end.dtype
    cap = mesh["t"].shape[1]

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

    def step(t, h, y, dl, live, extra):
        if not use_cost:
            return replay(t, h, y, dl, live, False, *extra)
        y_new, interp = replay(t, h, y, dl, live, True, *extra)
        q_inc = cm.gl3_increment(lambda tt, yy: lfun(tt, yy, dl), t, h,
                                 interp, torch.ones_like(t))
        return y_new, q_inc

    triggered = ev_idx >= 0

    def evt_endpoint(t, h, y, dl, th0, live, extra):
        # (y*, t*[, the last quadrature increment]) of the triggering step
        # as a differentiable map: replay the step and its interpolant, and
        # re-polish θ* by TWO Newton steps from the recorded root; starting
        # converged, the polished iterate's derivative is the implicit-
        # function derivative to O(residual²)
        _, interp = replay(t, h, y, dl, live, True, *extra)
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
    ring = cfg.get("level_ring")
    if ring is None:
        n_live, evt_slots = live_slots(nacc, triggered, cap)
    else:
        slot = torch.arange(cap, device=nacc.device)[None, :]
        n_live, evt_slots, tops = live_slots(
            nacc, triggered, cap,
            torch.where(slot < nacc[:, None], mesh[ring], -1).amax(dim=0))
    for k in range(n_live - 1, -1, -1):
        live = k < nacc                                   # [M]
        extra = () if ring is None else (mesh[ring][:, k], tops[k])
        tk = torch.where(live, mesh["t"][:, k], t0b)
        hk = torch.where(live, mesh["h"][:, k], 1.0)
        yk = torch.where(live[:, None], mesh["y"][:, k], y0b)
        lam_in = torch.where(live[:, None], lam, 0.0)
        is_evt = live & triggered & (k == nacc - 1)
        if k in evt_slots:
            lam_in = torch.where(is_evt[:, None], 0.0, lam_in)
        pull = vjp(lambda yy, dl: step(tk, hk, yy, dl, live, extra), yk,
                   dleaves)[1]
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
            pull_e = vjp(lambda yy, dl: evt_endpoint(tk, hk, yy, dl, th0,
                                                     live, extra), yk,
                         dleaves)[1]
            ct = (torch.where(is_evt[:, None], lam, 0.0),
                  torch.where(is_evt, tbar, 0.0))
            if use_cost:
                ct = ct + (torch.where(is_evt[:, None], qb, 0.0),)
            dye, dgle = pull_e(ct)
            dy = dy + torch.where(is_evt[:, None], dye, 0.0)
            dgl = [g + ge for g, ge in zip(dgl, dgle)]
        lam = torch.where(live[:, None], dy, lam)
        grads = [g + d for g, d in zip(grads, dgl)]

    lam0, grads = overflow_nan(nacc, cap, lam, grads)
    t0bar, tfbar = boundary_times(
        cfg["ydot"], lfun if use_cost else None, qb if use_cost else None,
        ybar, tbar, lam0, t_end, y_end, t0b, y0b, dleaves, triggered)
    return lam0, grads, t0bar, tfbar


def live_slots(nacc, triggered, cap, per_slot=None):
    """One host read before a backward loop: (the number of slots any lane
    filled, capped at the ring's capacity; the set of slots where a lane's
    terminal event step lies). Every slot above the first is dead for
    every lane, so the loop runs from it down to 0. ``per_slot`` [cap]
    (integers) is read in the same sync and returned third, as a list.

    The read goes through ``common._HostSyncs``: inside
    ``parallel.lockstep`` each entry is the maximum over the ranks (the
    event slots as a [cap] mask, so that their OR is a maximum too), and
    every rank sweeps the same slots."""
    slot = torch.where(triggered & (nacc >= 1) & (nacc <= cap), nacc - 1,
                       cap).to(torch.int64)
    evt = torch.zeros(cap + 1, dtype=torch.int64, device=nacc.device)
    evt = evt.scatter(0, slot, torch.ones_like(slot))[:cap]
    parts = [nacc.max().to(torch.int64)[None], evt]
    if per_slot is not None:
        parts.append(per_slot.to(torch.int64))
    host = cm._HostSyncs().read_max(torch.cat(parts))
    out = (min(host[0], cap), {k for k in range(cap) if host[1 + k]})
    return out if per_slot is None else out + (host[1 + cap:],)


def overflow_nan(nacc, cap, lam0, grads):
    """A lane that accepted more steps than the ring holds has an incomplete
    mesh: NaN for its λ(t0) and, when any lane overflowed, for every shared
    leaf's gradient (never a silently truncated gradient)."""
    over = nacc > cap
    lam0 = torch.where(over.reshape((-1,) + (1,) * (lam0.ndim - 1)),
                       torch.nan, lam0)
    any_over = over.any()
    return lam0, [torch.where(any_over, torch.nan, g) for g in grads]


def boundary_times(ydot, lfun, qb, ybar, tbar, lam0, t_end, y_end, t0b, y0b,
                   dleaves, triggered):
    """(t̄0, t̄f) [M]: t̄0 = −λ0·ẏ(t0), t̄f = ȳ·ẏ(T) with the true velocity
    ydot(t, y, dleaves), plus the running cost's endpoint terms when lfun
    (canonical [M, Q]) and its cotangent qb are given."""
    tfbar = torch.sum(ybar * ydot(t_end, y_end, dleaves), dim=-1)
    if lfun is not None:
        # the quadrature's endpoint moves with tf: dq/dT = l(T, y(T))
        tfbar = tfbar + torch.sum(qb * lfun(t_end, y_end, dleaves), dim=-1)
    # a triggered lane stopped at t* < tf: tf moves nothing (frozen mesh);
    # an untriggered one returns t = tf exactly, so t̄ adds 1:1
    tfbar = torch.where(triggered, 0.0, tfbar + tbar)
    t0bar = -torch.sum(lam0 * ydot(t0b, y0b, dleaves), dim=-1)
    if lfun is not None:
        t0bar = t0bar - torch.sum(qb * lfun(t0b, y0b, dleaves), dim=-1)
    return t0bar, tfbar
