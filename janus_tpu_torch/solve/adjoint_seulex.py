"""Discrete-adjoint reverse mode on the batched SEULEX solver.

The port of ``janus_tpu/solve/adjoint_seulex.py``. ``seulex_adjoint``
returns the final state of an adaptive ``solve_seulex`` run through
``solve.discrete.DiscreteAdjointFn``, whose backward pass differentiates the
solver's step map on the recorded accepted-step mesh. One accepted step is

    y_{n+1} = Φ(t_n, h_n, k_n, y_n, θ),

the Aitken–Neville diagonal T[k_n, k_n] of the linearly implicit Euler
ladder (level j: one LU of M/h'_j − J and nseq[j] substeps), where k_n is
the level the controller accepted at. (t_n, h_n, k_n) are data, recorded by
the forward solve (``solve_seulex(_mesh_size=...)``); the backward pass is
``solve.discrete.sweep``: one ``torch.func.vjp`` of a replay of each
recorded step, last to first, dead slots replayed at a benign step under a
zero cotangent, NaN on a lane whose mesh overflowed.

The recording forward refreshes the Jacobian at every new step point
(``_force_jac=True``) instead of the θ-gated reuse, so the replay's fresh
J(t_n, y_n) is the forward's iteration matrix and Φ the exact step map of
the solve whose output this returns. The accepted-level ring is read once
with the sweep's host read (``discrete.live_slots``), so each slot's replay
runs the levels up to the largest level its live lanes accepted at, a
Python int: no host read inside a vjp. For a (lane, level) pair that is not
live, a level above the lane's recorded k or a dead slot, the right-hand
side is masked to zero so the substeps replay the identity: the forward
never ran that level, and integrating it can overflow (Robertson's k2·y2²
at the benign replay point), and 0 × inf in the vjp would poison the
leaves' gradients, which lane masks do not protect.

The gradient is the exact gradient of the computed map. It is NOT the
transpose of ``solve_seulex(tangents=)``: the IND tangents drop ∂A/∂y (the
semi-implicit Euler is a W-method), the replay's vjp differentiates through
the iteration matrix and the Jacobian's evaluation. Both converge to the
true sensitivity at the ladder's order.

Scope: terminal mode; ``t_eval=`` (chained warm-started segments,
``adjoint.chain_segments``); terminal ``events=`` giving (y*, t*), both
differentiable through the vjp of the triggering step's replayed
interpolant (the midpoint Neville table rebuilt level for level) with θ*
re-polished by two Newton steps from the recorded root; ``cost=`` (q̄ pulled
through each step's GL-3 increment, ``common.gl3_increment``, the rule the
forward ``quad=`` accumulates with); ``mass=`` including singular index-1
masses, and with ``n_alg`` the constrained boundary velocity
(``adjoint.constrained_ydot``, pivoting as ``Options.pivoting``). Under
``Options(kernel_lu=True)`` the recording forward factors and solves
through K1/K2; the replay runs the plain pivot-free LU
(``linalg.smalllu``), which has the kernels' arithmetic and a backward.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from janus_tpu_torch.linalg.smalllu import lu_factor, lu_solve
from janus_tpu_torch.solve import common as cm
from janus_tpu_torch.solve import seulex as sx
from janus_tpu_torch.solve.adjoint import (_split_diff, adjoint_outputs,
                                           chain_segments, constrained_ydot,
                                           sampled_outputs)
from janus_tpu_torch.solve.discrete import DiscreteAdjointFn
from janus_tpu_torch.solve.dopri import power_interp
from janus_tpu_torch.solve.events import normalize_events
from janus_tpu_torch.solve.options import Options
from janus_tpu_torch.solve.radau import default_jacobian


def _one_step(f, jac_fn, mass, opts, t, h, y, k_rec, top, args, live,
              want_interp=False):
    """Replay ONE accepted SEULEX step at frozen (t, h, k): the
    differentiable step map Φ, with the level arithmetic of
    ``solve_seulex`` (without the stability probes and the error control,
    which do not touch the accepted value). Levels 0..top run (top: the
    largest k_rec over the live lanes); f is masked to zero on every
    (lane, level) pair that is not live (module docstring).

    want_interp: also return the step's interpolant θ [M, T] -> [M, T, D],
    rebuilt as the forward builds it: each even-nseq level's midpoint
    substep feeds the parallel midpoint table, and the lanes accepted at
    k >= 2 with even nseq take the quartic (mass: the quadratic)."""
    nseq = sx._nseq(opts.seulex_kmax)
    dim = y.shape[-1]
    jmat = jac_fn(t, y, args)
    mm = torch.eye(dim, dtype=y.dtype, device=y.device)[None] \
        if mass is None else (mass[None] if mass.ndim == 2 else mass)

    rows, rows_mid, even_nseq = [], [], []
    y_sel = ymid_sel = torch.zeros_like(y)
    mid_ok = torch.zeros_like(live)
    for k in range(top + 1):
        nj = nseq[k]
        lvl = live & (k <= k_rec)

        def feval(tt, yy, _lvl=lvl):
            return torch.where(_lvl[:, None], f(tt, yy, args), 0.0)

        hsub = sx._over(h, nj)
        lu, piv = lu_factor(mm / hsub[:, None, None] - jmat,
                            pivot=opts.pivoting)

        def slv(b, _lu=lu, _piv=piv):
            return lu_solve(_lu, _piv, b, pivot=opts.pivoting)

        ytemp = y + slv(feval(t + hsub, y))
        d = slv(feval(t + 2.0 * hsub, ytemp))
        ymid = ytemp
        for nn in range(2, nj):
            ytemp = ytemp + d
            if nn == nj // 2:
                ymid = ytemp
            d = slv(feval(t + (nn + 1.0) * hsub, ytemp))
        # zero the lanes that did not run the level, as the forward's
        # skipped levels are zeros
        yk = torch.where(lvl[:, None], ytemp + d, 0.0)
        row = sx.neville_row(rows[-1] if k else [], yk, nseq, k)
        rows.append(row)
        sel = k_rec == k
        y_sel = torch.where(sel[:, None], row[k], y_sel)
        if want_interp and nj % 2 == 0:
            rows_mid.append(sx.midpoint_row(
                rows_mid, even_nseq, torch.where(lvl[:, None], ymid, 0.0),
                nj))
            even_nseq.append(nj)
            ymid_sel = torch.where(sel[:, None], rows_mid[-1][-1], ymid_sel)
            if k >= 2:
                mid_ok = mid_ok | sel
    if not want_interp:
        return y_sel

    def fev(tt, yy):
        return torch.where(live[:, None], f(tt, yy, args), 0.0)

    q = sx.step_poly(y, y_sel, ymid_sel, mid_ok, h, fev(t, y),
                     fev(t + h, y_sel), mass is not None)
    return y_sel, power_interp(y, q)


def seulex_adjoint(f: Callable, tspan, y0, args=None,
                   options: Optional[Options] = None,
                   jac: Optional[Callable] = None, mass=None, t_eval=None,
                   events=None, cost: Optional[Callable] = None,
                   n_alg: int = 0, device=None):
    """Reverse-differentiable batched adaptive SEULEX solve.

    Returns the final state y(T) [M, D], or with ``t_eval`` the sampled
    trajectory ys [M, T, D]. ``backward()`` of any function of the result
    flows through the discrete adjoint to y0, every floating-point tensor
    leaf of ``args``, t0, tf and (t_eval mode) the sample times, where those
    are tensors that require grad. A y0 that is not a tensor goes to
    ``device``, by default the CUDA card. Memory: one (t, h, y, k) slot per
    accepted step, ``options.adjoint_steps`` slots per lane PER SEGMENT (the
    gradient is NaN on overflow). The backward replays every level up to
    the accepted one: cap the ladder with ``Options(seulex_kmax=...)``.

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
    ``seulex_adjoint.host_syncs`` (the forward's in
    ``solve_seulex.host_syncs``).
    """
    opts = options if options is not None else Options()
    if n_alg and mass is None:
        raise ValueError("n_alg > 0 (semi-explicit index-1 DAE boundary "
                         "velocity) needs mass=blockdiag(A, 0); without a "
                         "mass matrix the system is an ODE")
    specs = normalize_events(events)
    if specs and not all(e.terminal for e in specs):
        raise ValueError("seulex_adjoint(events=...) requires every event "
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

        jac_fn = (lambda t, yy, dl: jac(t, yy, rebuild(dl))) if jac \
            else default_jacobian(fa)

        def solve(t0_, tf_, y0_, args0, h0_):
            return sx.solve_seulex(f, t0_, tf_, y0_, args0, opts, jac=jac,
                                   mass=mass, events=specs or None,
                                   quad=cost, _mesh_size=opts.adjoint_steps,
                                   _h0=h0_, _force_jac=True)

        def replay(t, h, yy, dl, live, want_interp, k_col, top):
            k_rec = torch.where(live, k_col.to(torch.int64), 1)
            return _one_step(fa, jac_fn, mass, opts, t, h, yy, k_rec, top,
                             dl, live, want_interp)

        def ydot(t, yy, dl):
            # the TRUE velocity (M⁻¹f, or with n_alg the constrained one)
            return constrained_ydot(fa, t, yy, dl, mass, n_alg,
                                    pivot=opts.pivoting)

        cfg = {"solve": solve, "replay": replay, "level_ring": "k",
               "ydot": ydot, "events": specs, "cost": cost,
               "rebuild": rebuild, "entry": seulex_adjoint}
        return DiscreteAdjointFn.apply(cfg, ta, tb, y, h0, *dleaves)

    if t_eval is None:
        return adjoint_outputs(run(t0, tf, y0, args, None), bool(specs))
    return sampled_outputs(*chain_segments(run, t0, tf, y0, args, t_eval,
                                           bool(specs), "seulex_adjoint"),
                           bool(specs))


seulex_adjoint.host_syncs = 0
