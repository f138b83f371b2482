"""Continuous-adjoint reverse-mode sensitivities on the adaptive Radau solver.

The port of ``janus_tpu/solve/adjoint.py``. ``radau_adjoint`` returns the
final state of a batched adaptive Radau solve through a
``torch.autograd.Function`` whose backward pass solves the adjoint ODE

    λ' = −J(t, y(t))ᵀ λ,        λ(T) = ∂L/∂y(T)

backward along the SAME accepted-step mesh the forward solve chose, with the
primal state rebuilt from each step's stored collocation (dense-output)
polynomial: the interpolated-primal continuous adjoint. Parameter gradients
accumulate by the step's own Radau quadrature

    ∂L/∂θ += h·Σ_i b_i · λ(τ_i)ᵀ ∂f/∂θ(τ_i, ŷ(τ_i)),

so a gradient with respect to many parameters costs ONE backward sweep
instead of K forward tangent directions. ``loss.backward()`` fills ``.grad``
of y0, of every floating-point tensor leaf of ``args``, and of t0/tf when
they are tensors that require grad.

How the sweep is built:
- the backward pass is a Python loop over the step index k = max(naccept)−1
  … 0 (one host read before the loop) with a per-lane live mask: lanes own
  different mesh lengths, the same lockstep philosophy as the forward loop;
- each backward step factors (γ/h_b·Mᵀ + Jᵀ) once (the plain batched LU; no
  hand-written kernel, as the reference's sweep runs no Pallas kernel) and
  runs the SAME transformed simplified iteration as the forward Newton: the
  adjoint stage system is linear in λ, so it converges at the primal's
  contraction rate. The iteration stops when no live lane moves more than
  the Newton tolerance, a flag over all lanes (one host sync per trip, at
  most 10 trips per step);
- ∂f/∂θᵀλ and Jᵀλ come from ONE ``torch.func.vjp`` pull of the batched rhs
  per stage, used by the iteration and by the quadrature; Jacobians are
  never materialized for the quadrature, and a leaf that f broadcasts gets a
  cotangent of its own shape;
- invertible mass matrices use the substitution ν = M⁻ᵀλ: Mᵀν' = −Jᵀν with
  ν(T) = M⁻ᵀ∂L/∂y(T) and ∂L/∂y0 = Mᵀν(t0);
- ``Options(stage_solver='gmres'|'tridiag')`` carries through to the
  backward pass: the adjoint stage systems are solved by the forward path's
  batched GMRES machinery (``radau._gmres_core`` / ``_gmres_block_core``)
  with Jᵀ·v as a vjp pull and the TRANSPOSED probed structure as
  preconditioner, so large-D (method-of-lines) models get reverse-mode
  gradients without any Jacobian. A non-singular mass stays matrix-free too
  (GMRES preconditioned by the mass's own tridiagonal part), and with
  ``n_alg`` only the small [n_alg × n_alg] g_z block is materialized;
- semi-explicit index-1 DAEs (``n_alg`` trailing algebraic variables,
  mass = blockdiag(A, 0) with A invertible) get the Cao-Li-Petzold adjoint:
  the backward stage systems already handle a singular M, and only the
  TERMINAL data is DAE-specific. With J = [[f_x, f_z], [g_x, g_z]]:
  ν_x(T) = A⁻ᵀ(ȳ_x − g_xᵀg_z⁻ᵀȳ_z), ν_z(T) = −g_z⁻ᵀf_zᵀν_x(T), and the
  terminal velocity in dL/dT is (ẋ, −g_z⁻¹(g_t + g_x ẋ)). ∂L/∂y0 = Mᵀν(t0)
  is zero on algebraic slots (z0 is fixed by consistency, not a free input);
- ``checkpoints=C`` bounds the memory: the span is chained over C segments
  whose Function keeps only the segment's inputs and runs the segment again,
  with its mesh, in the backward pass. A repeated solve reproduces the first
  to the bit on the same device (the mesh is written by unique index).

- terminal ``events=``: the solve returns (y*, t*), both differentiable,
  through the implicit-function jump at the event, λ(t*) = ȳ − w·g_yᵀ and
  ∂L/∂θ −= w·g_θ with w = (ȳ·ẏ* + t̄ + q̄·l*)/(g_t + g_y·ẏ*); the first
  backward step of an event lane is the partial step t* → t_n on the
  step's polynomial (θ_end = (t*−t_n)/h_n).

- a variable-order forward (``min_stages != max_stages``, the radaup
  ladder of ``solve.radaup``): the recorded mesh stores each lane's
  collocation polynomial zero-padded to the ladder's top stage count, so
  the padded power basis evaluates the lane's own interpolant, and the
  backward sweep integrates the linear adjoint ODE at the ladder's top
  order on that mesh: the order adaptivity lives in the forward mesh. A
  ladder of one order is the fixed-stage adjoint. Under
  ``Options(kernel_lu=True)`` the forward goes through K1/K2 and the
  backward runs the plain LU, as on the fixed-stage path.

Accuracy contract: gradients match jvp/FD through the solve to O(rtol)
(discretize-then-optimize and optimize-then-discretize differ by the local
error of the mesh, which the controller bounds by rtol).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable
from torch.func import jvp, vjp

from janus_tpu_torch.control.precond import (blocks_of_jacobian,
                                             line_tridiag_bands,
                                             tridiag_bands)
from janus_tpu_torch.linalg.gmres import gmres_dense_solve
from janus_tpu_torch.linalg.smalllu import lu_factor, lu_solve
from janus_tpu_torch.solve import common as cm
from janus_tpu_torch.solve.events import normalize_events
from janus_tpu_torch.solve.options import Options
from janus_tpu_torch.solve.radau import (_factorize, _gmres_block_core,
                                         _gmres_core, _gmres_mass_blocks,
                                         _gmres_mass_ops,
                                         default_jacobian, solve_radau)
from janus_tpu_torch.solve.radau_tables import radau_tableau
from janus_tpu_torch.solve.radaup import ladder_orders, solve_radau_vo


def radau_adjoint(f: Callable, tspan, y0, args=None,
                  options: Optional[Options] = None,
                  jac: Optional[Callable] = None, mass=None, t_eval=None,
                  events=None, n_alg: int = 0, cost: Optional[Callable] = None,
                  checkpoints: int = 0, device=None):
    """Reverse-differentiable batched adaptive Radau solve.

    Returns the final state y(T) [M, D], or with ``t_eval`` the sampled
    trajectory ys [M, T, D]. ``backward()`` of any function of the result
    flows through the continuous adjoint to y0, every floating-point tensor
    leaf of ``args`` (Python numbers and integer tensors pass through), t0
    and tf, and in t_eval mode the sample times, where those are tensors
    that require grad. A y0 that is not a tensor goes to ``device``, by
    default the CUDA card; a tensor keeps its device.

    t_eval: optional strictly monotonic 1-D grid of sample times inside
    (t0, tf], ordered in the direction of integration. The solve is CHAINED
    over the segments t0 → t_eval[0] → … → t_eval[-1] (each segment an
    adaptive solve warm-started with the previous segment's step proposal),
    so samples are exact solve endpoints and the reverse sweep injects each
    sample's cotangent at exactly its time. tspan's tf only fixes the
    direction; integration stops at t_eval[-1]. Memory: one accepted-step
    mesh of ``options.adjoint_steps`` slots PER SEGMENT.

    mass: optional mass matrix [D, D] or [M, D, D]; invertible unless
    ``n_alg > 0``. Works with ``stage_solver='gmres'``.

    n_alg: number of TRAILING algebraic variables of a semi-explicit index-1
    DAE: mass = blockdiag(A, 0) with A [D−n_alg square] invertible, the last
    n_alg rows of f the constraints g(t, x, z) = 0, y0 consistent. The y0
    cotangent lives on the differential slots only.

    cost: optional running-cost integrand ``l(t [M], y [M, D], args) -> [M]``
    (or ``[M, Q]``). Appends ``q = ∫ l dt`` to the outputs, ``(y, q)`` or
    ``(ys, q)``, and q's cotangent flows through the SAME backward sweep:
    λ' = −Jᵀλ − l_yᵀq̄, parameters q̄·∫ l_θ dt, the boundaries ±q̄·l.

    checkpoints: optional segment count C > 0 for memory-bounded reverse
    mode over a long span (terminal mode only). The span is chained over C
    uniform segments; the forward pass stores only the segment boundaries
    and each segment's mesh is recomputed during the backward sweep. Size
    ``options.adjoint_steps`` for the per-SEGMENT step budget.

    events: TERMINAL event spec(s) (``solve.events.Event``; every event must
    be terminal; not with ``checkpoints=``). Returns ``(y, t)``, the state
    and time each lane stopped at (t < tf on a triggered lane), both
    differentiable; with cost ``(y, t, q)``, q truncated at t*. With t_eval
    ``(ys, y, t[, q])``: the segments are chained per lane, a triggered
    lane's later segments are zero-length (t* → t*) and its samples
    strictly past t* are NaN.

    min_stages != max_stages: the forward solve is the variable-order
    ladder (``solve.radaup.solve_radau_vo``) and the backward sweep runs at
    the ladder's top order (module docstring).

    The host syncs of the last backward sweep are in
    ``radau_adjoint.host_syncs`` (the forward's in
    ``solve_radau.host_syncs``, or ``solve_radau_vo.host_syncs``).
    """
    opts = options if options is not None else Options()
    specs = normalize_events(events)
    if any(not e.terminal for e in specs):
        raise ValueError("radau_adjoint(events=...) requires every event "
                         "terminal (non-terminal crossings don't enter the "
                         "returned (y_term, t_term))")
    if specs and checkpoints:
        raise ValueError("checkpoints= is terminal-mode only (an event "
                         "crossing a segment boundary would be missed by "
                         "the warm-started chain)")
    if n_alg and mass is None:
        raise ValueError("n_alg > 0 (index-1 DAE adjoint) needs the "
                         "singular mass = blockdiag(A, 0)")
    if checkpoints and t_eval is not None:
        raise ValueError("checkpoints= is terminal-mode only; t_eval already "
                         "chains segments (size adjoint_steps per segment)")
    if opts.stage_solver != "lu" and jac is not None:
        raise ValueError("stage_solver='gmres' is matrix-free; drop jac=")
    t0, tf = tspan
    y0 = cm.on_device(y0, device)
    vo_orders = None
    if opts.min_stages != opts.max_stages:
        # the variable-order forward ladder (module docstring)
        orders = ladder_orders(opts, y0.dtype)
        if len(orders) < 2:
            opts = opts.replace(min_stages=orders[0], max_stages=orders[0])
        else:
            vo_orders = orders
    if mass is not None:
        mass = cm.like(mass, y0)
    use_cost = cost is not None
    run = _build_adjoint(f, opts, jac_user=jac, mass=mass, n_alg=n_alg,
                         cost=cost, remat=bool(checkpoints), events=specs,
                         vo_orders=vo_orders)
    if t_eval is None and not checkpoints:
        return adjoint_outputs(run(t0, tf, y0, args, None), bool(specs))
    if t_eval is None:
        if _ndim(t0) != 0 or _ndim(tf) != 0:
            raise ValueError("radau_adjoint(checkpoints=...) chains segments "
                             "over a shared grid; t0/tf must be scalars")
        # uniform segment boundaries; the rematerialized Function stores only
        # each segment's inputs, and its mesh is recomputed going backward
        t0b, _, y0b = cm.broadcast_batch(t0, tf, y0)
        ta, tb = cm.like(t0, y0b), cm.like(tf, y0b)
        t_eval = (ta + (tb - ta) * torch.linspace(
            0.0, 1.0, int(checkpoints) + 1, dtype=y0b.dtype,
            device=y0b.device))[1:]
    ys, y, t_end, q = chain_segments(run, t0, tf, y0, args, t_eval,
                                     bool(specs), "radau_adjoint")
    if checkpoints:
        return (y, q) if use_cost else y
    return sampled_outputs(ys, y, t_end, q, bool(specs))


radau_adjoint.host_syncs = 0


def _ndim(x):
    return x.ndim if isinstance(x, torch.Tensor) else np.ndim(x)


def adjoint_outputs(outs, events):
    """An adjoint Function's (y, t, h_next, event_idx[, q]) as the user sees
    it in terminal mode: y, (y, q), (y, t) or (y, t, q)."""
    y, t, _, _, *q = outs
    head = (y, t) if events else (y,)
    out = head + tuple(q)
    return out if len(out) > 1 else y


def sampled_outputs(ys, y, t_end, q, events):
    """t_eval mode's outputs as the user sees them: ys, (ys, q), (ys, y*,
    t*) or (ys, y*, t*, q)."""
    out = (ys, y, t_end) if events else (ys,)
    if q is not None:
        out += (q,)
    return out if len(out) > 1 else ys


def chain_segments(run, t0, tf, y0, args, t_eval, events, who):
    """The adjoints' segment chain: one ``run(ta, tb, y, args, h0) -> (y, t,
    h_next, event_idx[, q])`` per segment t0 → t_eval[0] → … →
    t_eval[-1], each warm-started with the previous segment's step proposal,
    so the samples are exact solve endpoints. Returns (ys [M, T, D], y_F,
    t_F [M], q summed over the segments, or None).

    With terminal events the segments are chained per lane: once a lane
    triggers, its later segments are ZERO-LENGTH solves t* → t* (the
    identity: their boundary cotangents cancel, so the event jump of the
    triggering segment's backward pass carries the whole gradient), and its
    samples strictly past t* are NaN (the forward solvers' truncation); the
    sample exactly at t* (a trigger on a segment boundary) stays."""
    if _ndim(t0) != 0 or _ndim(tf) != 0:
        raise ValueError(f"{who}(t_eval=...) chains segments over a shared "
                         "grid; t0/tf must be scalars")
    t0b, _, y0b = cm.broadcast_batch(t0, tf, y0)
    t_eval = cm.like(t_eval, y0b)
    if t_eval.ndim != 1 or t_eval.shape[0] < 1:
        raise ValueError("t_eval must be a non-empty 1-D grid")
    edges = [t0] + list(t_eval.unbind(0))
    m = y0b.shape[0]
    y, h, q_sum, ys = y0b, None, None, []
    done = torch.zeros((m,), dtype=torch.bool, device=y0b.device)
    t_star = t0b
    for ta, tb in zip(edges[:-1], edges[1:]):
        if events:
            ta = torch.where(done, t_star, cm.like(ta, y0b))
            tb = torch.where(done, t_star, cm.like(tb, y0b))
        y, t, h, idx, *q = run(ta, tb, y, args, h)
        if events:
            trig = (idx >= 0) & ~done
            t_star = torch.where(trig, t, t_star)
            # a trigger strictly inside the segment voids its endpoint
            # sample; a trigger exactly at tb keeps it
            dead = done | (trig & (t != tb))
            done = done | trig
            ys.append(torch.where(dead[:, None], torch.nan, y))
        else:
            ys.append(y)
        if q:
            q_sum = q[0] if q_sum is None else q_sum + q[0]
    t_end = torch.where(done, t_star, t_eval[-1])
    return torch.stack(ys, dim=1), y, t_end, q_sum


def _split_diff(args):
    """Partition the leaves of ``args`` into differentiable (floating-point
    tensors) and passthrough (Python numbers, integer tensors, anything
    else): (dleaves, rebuild, leaves, diff_idx) with rebuild(dleaves) the
    args tree with those leaves replaced."""
    leaves, unflatten = cm.tree_flatten(args)
    diff_idx = [i for i, leaf in enumerate(leaves)
                if isinstance(leaf, torch.Tensor) and leaf.is_floating_point()]

    def rebuild(diff_leaves):
        out = list(leaves)
        for i, v in zip(diff_idx, diff_leaves):
            out[i] = v
        return unflatten(out)

    return [leaves[i] for i in diff_idx], rebuild, leaves, diff_idx


def constrained_ydot(fa, t, y, dl, mass, n_alg, *, use_gmres=False,
                     gmres_iters=20, pivot=True):
    """The true state velocity ẏ at (t, y) for the boundary-time cotangent
    formulas t̄₀ = −λ₀·ẏ(t₀), t̄_f = ȳ·ẏ(T); fa(t, y, dl) is the rhs.

    ODE: ẏ = f. Invertible mass: ẏ = M⁻¹f. Semi-explicit index-1 DAE
    (``n_alg`` trailing algebraic rows, mass = blockdiag(A, 0)): the
    CONSTRAINED velocity ẋ = A⁻¹f_x, ż = −g_z⁻¹(g_t + g_x·ẋ), the
    Cao–Li–Petzold boundary velocity. Matrix-free throughout: g_z from n_alg
    z-slot jvp probes (only the small [n_alg × n_alg] block is factored),
    g_x·ẋ and g_t as jvp's, the A block by dense LU (or batched GMRES under
    ``use_gmres`` for large differential blocks). ``pivot`` is the dense
    factorizations' partial pivoting (the reference fixes it to True, the
    default; callers thread ``Options.pivoting`` through here)."""
    m, dim = y.shape
    f_t = fa(t, y, dl)
    if mass is None and not n_alg:
        return f_t
    mb = cm.like(mass, y).expand(m, dim, dim)

    def dense_solve(mat, rhs):
        if use_gmres:
            return gmres_dense_solve(mat, rhs, gmres_iters)
        return lu_solve(*lu_factor(mat, pivot=pivot), rhs, pivot=pivot)

    if not n_alg:
        return dense_solve(mb, f_t)
    n1 = dim - n_alg

    def f_at(yy):
        return fa(t, yy, dl)

    gz = torch.stack([jvp(f_at, (y,), (_unit(y, n1 + a),))[1][:, n1:]
                      for a in range(n_alg)], dim=-1)
    xdot = dense_solve(mb[:, :n1, :n1], f_t[:, :n1])
    t = t.contiguous()           # forward mode refuses a broadcast primal
    g_t = jvp(lambda tt: fa(tt, y, dl), (t,), (torch.ones_like(t),))[1][:, n1:]
    gx_xdot = jvp(f_at, (y,), (F.pad(xdot, (0, n_alg)),))[1][:, n1:]
    zdot = -lu_solve(*lu_factor(gz, pivot=pivot), g_t + gx_xdot, pivot=pivot)
    return torch.cat([xdot, zdot], dim=-1)


def _unit(y, j):
    e = torch.zeros_like(y)
    e[:, j] = 1.0
    return e


class _RadauAdjointFn(torch.autograd.Function):
    """One adaptive Radau solve (a whole span or one chained segment) with
    the continuous adjoint as its backward. Inputs: the static setup ``cfg``
    (f, options, jac, mass, n_alg, cost, events, the args tree's rebuild,
    remat), then t0, tf, y0, h0 and the differentiable leaves of args.
    Outputs (y, t, h_next, event_idx[, q]); h_next and event_idx (−1 where
    no event fired) are not differentiable."""

    @staticmethod
    def forward(ctx, cfg, t0, tf, y0, h0, *dleaves):
        cap = cfg["opts"].adjoint_steps
        sol = _forward_solve(cfg, t0, tf, y0, h0, dleaves,
                             0 if cfg["remat"] else cap)
        ctx.cfg = cfg
        ctx.lockstep = cm.LOCKSTEP.get()
        ctx.y0_shape = y0.shape
        ctx.n_leaves = len(dleaves)
        ctx.t_in = tuple(x if not isinstance(x, torch.Tensor) else None
                         for x in (t0, tf))
        tensors = [x for x in (t0, tf) if isinstance(x, torch.Tensor)]
        ctx.has_h0 = h0 is not None
        if ctx.has_h0:
            tensors.append(h0)
        idx = event_index(sol)
        tensors += [y0, *dleaves, sol.y, sol.t, idx]
        if not cfg["remat"]:
            tensors += [sol.stats["naccept"], sol.mesh["t"], sol.mesh["h"],
                        sol.mesh["y"], sol.mesh["q"]]
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
        h0 = saved.pop(0) if ctx.has_h0 else None
        y0 = saved.pop(0)
        dleaves = [saved.pop(0) for _ in range(ctx.n_leaves)]
        y_end, t_term, ev_idx = saved.pop(0), saved.pop(0), saved.pop(0)
        if cfg["remat"]:
            # the segment again, this time with its mesh (to the bit the
            # forward pass's solve: same inputs, same warm start)
            sol = _forward_solve(cfg, t0, tf, y0, h0, dleaves,
                                 cfg["opts"].adjoint_steps)
            nacc, mesh = sol.stats["naccept"], sol.mesh
        else:
            nacc = saved.pop(0)
            mesh = dict(zip(("t", "h", "y", "q"), saved))
        del saved
        t0b, tfb, y0b = cm.broadcast_batch(t0, tf, y0)
        lam0, gleaves, t0bar, tfbar = _adjoint_sweep(
            cfg["f"], cfg["opts"], cfg["jac"], cfg["mass"], mesh, nacc, t0b,
            tfb, t_term, y0b, cfg["rebuild"], dleaves, y_end, ybar, tbar,
            cfg["n_alg"], cost=cfg["cost"], qbar=qbar,
            specs=cfg["events"], ev_idx=ev_idx, vo_orders=cfg["vo_orders"])
        return (None, *boundary_cotangents(t0, tf, t0bar, tfbar),
                lam0.reshape(ctx.y0_shape), None, *gleaves)


def event_index(sol):
    """Solution.event_idx, or −1 on every lane of a solve without events."""
    if sol.event_idx is not None:
        return sol.event_idx
    return torch.full(sol.t.shape, -1, dtype=torch.int32, device=sol.t.device)


def boundary_cotangents(t0, tf, t0bar, tfbar):
    """t0's and tf's cotangents in the shapes of the primal inputs: a
    scalar gets the sum over the lanes, and what is no tensor gets None."""
    return [None if not isinstance(x, torch.Tensor)
            else bar.sum().reshape(x.shape) if x.numel() == 1 else bar
            for x, bar in zip((t0, tf), (t0bar, tfbar))]


def _forward_solve(cfg, t0, tf, y0, h0, dleaves, mesh_size):
    solve = solve_radau_vo if cfg["vo_orders"] else solve_radau
    with torch.no_grad():
        return solve(cfg["f"], t0, tf, y0, args=cfg["rebuild"](dleaves),
                     options=cfg["opts"], jac=cfg["jac"], mass=cfg["mass"],
                     quad=cfg["cost"], events=cfg["events"] or None,
                     _mesh_size=mesh_size, _h0=h0)


def _build_adjoint(f, opts, jac_user, mass, n_alg=0, cost=None, remat=False,
                   events=(), vo_orders=None):
    """run(t0, tf, y0, args, h0) -> (y, t, h_next, event_idx[, q]) through
    ``_RadauAdjointFn``. remat: keep only the inputs in the forward pass and
    solve again, with the mesh, in the backward pass (``checkpoints=``).
    vo_orders: the stage counts of a variable-order forward ladder, or
    None (fixed stage count)."""

    def run(t0, tf, y0, args, h0):
        dleaves, rebuild, _, _ = _split_diff(args)
        cfg = {"f": f, "opts": opts, "jac": jac_user, "mass": mass,
               "n_alg": n_alg, "cost": cost, "events": events,
               "rebuild": rebuild, "remat": remat, "vo_orders": vo_orders}
        return _RadauAdjointFn.apply(cfg, t0, tf, y0, h0, *dleaves)

    return run


def event_jump(specs, ev_idx, t_term, y_end, dleaves, rebuild, ybar, ydot,
               tbar_total):
    """The implicit-function jump of a lane stopped by a terminal event:
    (λ(t*) [M, D], the leaves' gradient contributions). With w = tbar_total
    / (g_t + g_y·ẏ*), where tbar_total is the lane's whole dL/dt* through
    the state, t and cost outputs (ȳ·ẏ* + t̄ + q̄·l*), λ(t*) = ȳ − w·g_yᵀ and
    the leaves get −w·g_θ; g is the lane's own event (ev_idx)."""
    is_ev = ev_idx >= 0
    lam = ybar
    grads = [torch.zeros_like(leaf) for leaf in dleaves]
    for j, spec in enumerate(specs):
        def gfun(tt, yy, dl, _sp=spec):
            return _sp.fn(tt, yy, rebuild(dl))

        den = jvp(gfun, (t_term, y_end, dleaves),
                  (torch.ones_like(t_term), ydot,
                   [torch.zeros_like(leaf) for leaf in dleaves]))[1]
        w = tbar_total / torch.where(den == 0.0, 1.0, den)
        on = (ev_idx == j) & is_ev
        _, yg, dg = vjp(gfun, t_term, y_end, dleaves)[1](
            torch.where(on, -w, 0.0))
        lam = lam + torch.where(on[:, None], yg, 0.0)
        grads = [g + d for g, d in zip(grads, dg)]
    return lam, grads


def _transposed_bands(dl, d, du):
    """[M, 3, D] bands of −Jᵀ from J's: (Jᵀ)_dl[i] = J_du[i−1],
    (Jᵀ)_du[i] = J_dl[i+1]. Line-boundary zeros map to line-boundary zeros,
    so 'lines' rides the same shift."""
    return -torch.stack([F.pad(du[:, :-1], (1, 0)), d,
                         F.pad(dl[:, 1:], (0, 1))], dim=1)


def _adjoint_sweep(f, opts, jac_user, mass, mesh, nacc, t0b, tfb, t_term,
                   y0b, rebuild, dleaves, y_end, ybar, tbar, n_alg=0,
                   cost=None, qbar=None, specs=(), ev_idx=None,
                   vo_orders=None):
    """The backward loop over the stored accepted-step mesh. Returns
    (λ(t0) [M, D], the leaves' gradients, t̄0 [M], t̄f [M]). The mesh dict
    is emptied once it has been read, so that a caller that holds no other
    reference frees the rings before the gradients are assembled. specs /
    ev_idx: the terminal events and which one stopped each lane (−1:
    none). vo_orders: a variable-order forward's ladder; its mesh
    polynomials are padded to the top stage count, at which the sweep
    runs."""
    use_cost = cost is not None
    m, dim = y_end.shape
    dtype, dev = y_end.dtype, y_end.device
    s = vo_orders[-1] if vo_orders else opts.min_stages
    tab = radau_tableau(s)
    cap = mesh["t"].shape[1]
    npair = (s - 1) // 2
    c_nodes, b_w, t_mat, ti_mat = (
        torch.as_tensor(a, dtype=dtype, device=dev)
        for a in (tab.c, tab.b, tab.t_mat, tab.ti_mat))
    tol = (opts.newton_tol if opts.newton_tol > 0
           else cm.derived_newton_tol(dtype, opts.rtol))
    use_gmres = opts.stage_solver != "lu"
    g_iters = 0 if opts.stage_solver == "tridiag" else opts.gmres_iters
    syncs = cm._HostSyncs()

    def f2(t, y, dl):
        return f(t, y, rebuild(dl))

    if ybar is None:
        ybar = torch.zeros_like(y_end)
    if use_cost:
        def lfun(t, y, dl):                            # canon [M, Q]
            return cm.canon_cost(cost(t, y, rebuild(dl)))

        l_term = lfun(t_term, y_end, dleaves)
        qb = torch.zeros_like(l_term) if qbar is None \
            else qbar.reshape(l_term.shape)            # [M, Q]

    if not use_gmres:
        jac_fn = (lambda t, y, dl: jac_user(t, y, rebuild(dl))) if jac_user \
            else default_jacobian(f2)

    def dense_solve(mat, rhs):
        """mat⁻¹·rhs for an explicit batched matrix (mass, DAE blocks)."""
        if use_gmres:
            return gmres_dense_solve(mat, rhs, opts.gmres_iters)
        return lu_solve(*lu_factor(mat, pivot=True), rhs)

    mass_t = None if mass is None else mass.mT

    def mdot_t(w):                                     # [M, D] or [M, s, D]
        if mass_t is None:
            return w
        if mass_t.ndim == 2:
            return cm.lane_einsum("ij,...j->...i", mass_t, w)
        return cm.lane_einsum("mij,msj->msi" if w.ndim == 3 else "mij,mj->mi",
                            mass_t, w)

    # terminal velocity ẏ(t_term) = M⁻¹ f(t_term, y_term)
    if n_alg:
        # semi-explicit index-1: J = [[f_x, f_z], [g_x, g_z]] at (T, y(T));
        # ẋ = A⁻¹f_x-rows, ż = −g_z⁻¹(g_t + g_x ẋ). Only the small
        # [n_alg × n_alg] g_z block is ever dense-factored; every large
        # operator is a closure (explicit blocks on the LU path, jvp/vjp
        # pulls + GMRES block solves on the matrix-free path).
        n1 = dim - n_alg
        a_blk = mass.expand(m, dim, dim)[:, :n1, :n1]

        def f_at(yy):
            return f2(t_term, yy, dleaves)

        f_term = f_at(y_end)
        if use_gmres:
            # g_z columns by n_alg z-slot jvp probes of the matrix-free J
            gz = torch.stack(
                [jvp(f_at, (y_end,), (_unit(y_end, n1 + a),))[1][:, n1:]
                 for a in range(n_alg)], dim=-1)
            pull_j = vjp(f_at, y_end)[1]

            def gx_t_dot(u):
                return pull_j(F.pad(u, (n1, 0)))[0][:, :n1]

            def fz_t_dot(v):
                return pull_j(F.pad(v, (0, n_alg)))[0][:, n1:]

            def gx_dot(w):
                return jvp(f_at, (y_end,), (F.pad(w, (0, n_alg)),))[1][:, n1:]
        else:
            jmat_term = jac_fn(t_term, y_end, dleaves)
            fz = jmat_term[:, :n1, n1:]
            gx = jmat_term[:, n1:, :n1]
            gz = jmat_term[:, n1:, n1:]

            def gx_t_dot(u):
                return cm.lane_einsum("mai,ma->mi", gx, u)

            def fz_t_dot(v):
                return cm.lane_einsum("mia,mi->ma", fz, v)

            def gx_dot(w):
                return cm.lane_einsum("mai,mi->ma", gx, w)
        lu_gz = lu_factor(gz, pivot=True)
        lu_gz_t = lu_factor(gz.mT, pivot=True)
        xdot = dense_solve(a_blk, f_term[:, :n1])
        g_t = jvp(lambda tt: f2(tt, y_end, dleaves), (t_term,),
                  (torch.ones_like(t_term),))[1][:, n1:]
        zdot = -lu_solve(*lu_gz, g_t + gx_dot(xdot))
        ydot_term = torch.cat([xdot, zdot], dim=-1)
    else:
        ydot_term = constrained_ydot(f2, t_term, y_end, dleaves, mass, 0,
                                     use_gmres=use_gmres,
                                     gmres_iters=opts.gmres_iters)

    # tf cotangent: dL/dT = λ(T)ᵀ ẏ(T) (+ the t output's cotangent + the
    # quadrature endpoint's q̄·l(T): dq/dT = l(T, y(T)))
    tfbar = torch.sum(ybar * ydot_term, dim=-1)
    if tbar is not None:
        tfbar = tfbar + tbar.to(dtype).broadcast_to((m,))
    if use_cost:
        tfbar = tfbar + torch.sum(qb * l_term, dim=-1)
    grads = [torch.zeros_like(leaf) for leaf in dleaves]
    if specs:
        # implicit-function jump at the terminating event: λ(t*) = ȳ − w·g_yᵀ,
        # grads −= w·g_θ, w = (ȳ·ẏ* + t̄ + q̄·l*)/(g_t + g_y·ẏ*); a lane
        # stopped by an event does not see tf at all
        ybar, jump = event_jump(specs, ev_idx, t_term, y_end, dleaves,
                                rebuild, ybar, ydot_term, tfbar)
        grads = [g + j for g, j in zip(grads, jump)]
        tfbar = torch.where(ev_idx >= 0, 0.0, tfbar)

    # ν(t_term) = M⁻ᵀ λ(t_term)
    if n_alg:
        # consistent adjoint-DAE terminal data (module docstring):
        # ν_x = A⁻ᵀ(ȳ_x − g_xᵀg_z⁻ᵀȳ_z), g_zᵀν_z = −f_zᵀν_x
        u = lu_solve(*lu_gz_t, ybar[:, n1:])
        nu_x = dense_solve(a_blk.mT, ybar[:, :n1] - gx_t_dot(u))
        rhs_z = fz_t_dot(nu_x)
        if use_cost:
            # integral cost on a DAE: the adjoint's algebraic consistency
            # 0 = f_zᵀν_x + g_zᵀν_z + l_zᵀq̄ carries the cost's algebraic
            # gradient into ν_z(T) (Cao-Li-Petzold quadrature sensitivities)
            lbar = vjp(lambda yy: lfun(t_term, yy, dleaves), y_end)[1](qb)[0]
            rhs_z = rhs_z + lbar[:, n1:]
        nu_z = -lu_solve(*lu_gz_t, rhs_z)
        lam = torch.cat([nu_x, nu_z], dim=-1)
    elif mass is not None:
        lam = dense_solve(mass_t.expand(m, dim, dim), ybar)
    else:
        lam = ybar

    bad = nacc > cap                                  # mesh overflow
    theta = 1.0 - c_nodes                             # [s]

    # lanes own nacc of the mesh's slots; the slots past every lane's mesh
    # are dead, so the loop starts at the longest mesh (one host read)
    for k in range(min(syncs.max_int(nacc), cap) - 1, -1, -1):
        live = k < nacc                               # [M]
        tn, hn = mesh["t"][:, k], mesh["h"][:, k]     # step start, signed h
        yn, qq = mesh["y"][:, k], mesh["q"][:, k]     # [M, D], [M, s, D]
        # the step runs to θ_end = 1 on its polynomial, but on event lanes
        # the LAST recorded step holds t*, and the sweep's first step is the
        # PARTIAL step t* → t_n, θ_end = (t*−t_n)/h_n (floored: a root at a
        # step start would give h_eff = 0 in γ/h_b)
        th_end = torch.where(
            (k == nacc - 1) & (ev_idx >= 0), torch.clamp(
                (t_term - tn) / torch.where(hn == 0.0, 1.0, hn), 1e-6, 1.0),
            1.0) if specs else torch.ones_like(hn)
        h_eff = hn * th_end
        # primal interpolant at the backward stage nodes
        # τ_i = t_end + c_i·h_b ⇒ θ_i = θ_end·(1 − c_i) on the step polynomial
        th_i = th_end[:, None] * theta[None, :]                    # [M, s]
        pw = torch.stack([th_i ** (q + 1) for q in range(s)], dim=-1)
        ys = yn[:, None, :] + cm.lane_einsum("msq,mqd->msd", pw, qq)
        pe = torch.stack([th_end ** (q + 1) for q in range(s)], dim=-1)
        y_hi = yn + cm.lane_einsum("mq,mqd->md", pe, qq)
        t_end = tn + h_eff
        hb = torch.where(live, -h_eff, -1.0)          # signed backward step
        taus = t_end[:, None] + c_nodes[None, :] * hb[:, None]

        # dead lanes: substitute safe (finite) evaluation points
        ys = torch.where(live[:, None, None], ys, y_end[:, None, :])
        taus = torch.where(live[:, None], taus, t_term[:, None])
        y_hi = torch.where(live[:, None], y_hi, y_end)
        t_hi = torch.where(live, t_end, t_term)

        # one (y, θ) pull per stage, for the iteration and the quadrature
        pulls, srcs, pulls_l = [], [], []
        for i in range(s):
            ti, yi = taus[:, i], ys[:, i]
            pulls.append(vjp(lambda yy, dl, _t=ti: f2(_t, yy, dl), yi,
                             dleaves)[1])
            if use_cost:
                # running-cost source: λ' picks up −l_yᵀq̄ (constant across
                # the linear iteration), parameters q̄·∫ l_θ dt
                pulls_l.append(vjp(lambda yy, dl, _t=ti: lfun(_t, yy, dl),
                                   yi, dleaves)[1])
                srcs.append(pulls_l[i](qb)[0])        # [M, D]

        # frozen iteration matrix: (γ/h_b·Mᵀ + Jᵀ) from J at the step's
        # later end (where the backward step starts)
        if use_gmres:
            # matrix-free: Jᵀ·v by a vjp pull at the frozen point; the
            # preconditioner of −Jᵀ by transposing the probed structure
            # (bands shifted, blocks transposed per block)
            def f_hi(yy, _t=t_hi):
                return f2(_t, yy, dleaves)

            pull_lin = vjp(f_hi, y_hi)[1]

            def jv_adj(v, _pull=pull_lin):
                return -_pull(v)[0]

            if opts.precond == "block":
                pb = opts.precond_block
                blocks_adj = -blocks_of_jacobian(f_hi, y_hi, pb).mT
                mdotv_t, mblk_t = _gmres_mass_blocks(mass_t, m, dim // pb, pb,
                                                     dtype, dev)
                solve_real, solve_cplx = _gmres_block_core(
                    tab, jv_adj, blocks_adj, hb, mdotv_t, mblk_t, g_iters)
            else:
                bands = line_tridiag_bands(f_hi, y_hi, opts.precond_block) \
                    if opts.precond == "lines" else tridiag_bands(f_hi, y_hi)
                bands_adj = _transposed_bands(*bands)
                solve_real, solve_cplx = _gmres_core(
                    tab, jv_adj, bands_adj, hb,
                    _gmres_mass_ops(mass_t, m, dim, bands_adj[:, 1]), g_iters)
            ok = torch.ones((m,), dtype=torch.bool, device=dev)
        else:
            jac_adj = -jac_fn(t_hi, y_hi, dleaves).mT
            lu_r, piv_r, lu_c, piv_c, ok = _factorize(
                tab, hb, jac_adj, mass_t, opts.pivoting)

            def solve_real(b, _lu=lu_r, _piv=piv_r):
                return lu_solve(_lu, _piv, b, pivot=opts.pivoting)

            def solve_cplx(p, b, _lu=lu_c, _piv=piv_c):
                return lu_solve(_lu[:, p], _piv[:, p], b,
                                pivot=opts.pivoting)

        # transformed simplified iteration on the LINEAR adjoint stage system
        def g_stage(i, z_i):
            base = -pulls[i](lam + z_i)[0]
            return base - srcs[i] if use_cost else base

        w = lam.new_zeros((m, s, dim))
        z = lam.new_zeros((m, s, dim))
        scale = 1.0 + torch.abs(lam)[:, None, :]
        for _ in range(10):
            gs = torch.stack([g_stage(i, z[:, i]) for i in range(s)], dim=1)
            tif = cm.lane_einsum("ij,mjd->mid", ti_mat, gs)
            mw = mdot_t(w)
            rhs_r = tif[:, 0] - (float(tab.mu_real) / hb)[:, None] * mw[:, 0]
            dws = [solve_real(rhs_r)]
            for p in range(npair):
                mu = tab.mu_complex[p]
                mur, mui = float(mu.real), float(mu.imag)
                w1, w2 = mw[:, 1 + 2 * p], mw[:, 2 + 2 * p]
                fr = tif[:, 1 + 2 * p] - (mur * w1 - mui * w2) / hb[:, None]
                fi = tif[:, 2 + 2 * p] - (mur * w2 + mui * w1) / hb[:, None]
                sol = solve_cplx(p, torch.cat([fr, fi], dim=-1))
                dws.append(sol[:, :dim])
                dws.append(sol[:, dim:])
            dw = torch.stack(dws, dim=1)
            w = w + dw
            z = cm.lane_einsum("ij,mjd->mid", t_mat, w)
            dn = cm.safe_sqrt(torch.mean(torch.square(dw / scale),
                                         dim=(1, 2)))
            if not syncs.any(live & ok & (dn > tol) & torch.isfinite(dn)):
                break

        # quadrature: ∂L/∂θ += h Σ_i b_i · (∂f/∂θ)ᵀ ν(τ_i) (+ q̄·l_θ)
        for i in range(s):
            wgt = torch.where(live, h_eff * b_w[i], 0.0)[:, None]   # [M, 1]
            contrib = pulls[i](wgt * (lam + z[:, i, :]))[1]
            grads = [ga + gc for ga, gc in zip(grads, contrib)]
            if use_cost:
                contrib_l = pulls_l[i](wgt * qb)[1]
                grads = [ga + gc for ga, gc in zip(grads, contrib_l)]

        # c_s = 1 ⇒ τ_s = t_n
        lam = torch.where(live[:, None], lam + z[:, -1, :], lam)
        bad = bad | (live & ~ok)
    mesh.clear()                 # the rings are read: let go of them here

    # y0 cotangent: λ(t0) = Mᵀ ν(t0)
    lam0 = mdot_t(lam)
    # t0 cotangent: dL/dt0 = −ν(t0)ᵀ f(t0, y0) − q̄·l(t0, y0)
    t0bar = -torch.sum(lam * f2(t0b, y0b, dleaves), dim=-1)
    if use_cost:
        t0bar = t0bar - torch.sum(qb * lfun(t0b, y0b, dleaves), dim=-1)

    # poison everything if any lane overflowed the mesh or hit a singular
    # backward factorization: a silent wrong gradient is worse than NaN
    any_bad = bad.any()
    lam0, t0bar, tfbar, *grads = (torch.where(any_bad, torch.nan, g)
                                  for g in (lam0, t0bar, tfbar, *grads))
    radau_adjoint.host_syncs = syncs.count
    return lam0, grads, t0bar, tfbar
