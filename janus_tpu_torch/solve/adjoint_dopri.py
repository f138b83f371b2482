"""Discrete-adjoint reverse mode on the batched Dormand–Prince solvers.

The port of ``janus_tpu/solve/adjoint_dopri.py``. ``dopri_adjoint`` returns
the final state of an adaptive ``solve_erk`` run (dopri5 or dopri853)
through a ``torch.autograd.Function`` whose backward pass is the exact
transpose of the solver's step map on the recorded accepted-step mesh. One
accepted explicit Runge–Kutta step is a closed-form composition of stage
evaluations,

    y_{n+1} = Φ(t_n, h_n, y_n, θ) = y_n + h_n Σ_j b_j k_j,

so the vjp of a replay at the recorded (t_n, h_n) is exact to rounding:
reverse mode through the ADAPTIVE explicit family, the neural-ODE training
path (discretize-then-optimize).

Replay exactness needs no change of the forward pass: the FSAL value the
solve carries equals a fresh f(t_n, y_n) (it was evaluated at exactly that
point when the previous step was accepted), and the replay runs the same
``dopri.stages`` as the forward, so it repeats the forward's stages to the
bit.

The Function and the backward sweep are ``solve.discrete``'s (shared with
the rodas adjoint): a Python loop over the recorded slots after one host
read, a ``torch.func.vjp`` of the replay per slot, NaN on a lane whose mesh
overflowed. Dead slots replay the identity: besides the benign substitute
step, the stage cascade is masked to a zero right-hand side on those lanes,
because an explicit cascade at a substitute point with stiff parameters can
overflow, and 0 × inf = NaN would reach the shared leaves' gradients.

Frozen-mesh convention: (t_n, h_n) are data; against central differences of
the full solve the gradients differ by the controller's O(rtol) mesh
sensitivity.

Scope: terminal mode; ``t_eval=`` (chained warm-started segments,
``adjoint.chain_segments``); terminal ``events=`` returning (y*, t*), both
differentiable through the vjp of the triggering step's replayed dense
interpolant with θ* re-polished by two Newton steps from the recorded root;
events with ``t_eval``; ``cost=`` (q̄ pulled through each step's replayed
GL-3 increment, ``common.gl3_increment``, the function the forward ``quad=``
accumulates with). No kernel runs here.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from janus_tpu_torch.solve import common as cm
from janus_tpu_torch.solve import dopri as dp
from janus_tpu_torch.solve.adjoint import (_split_diff, adjoint_outputs,
                                           chain_segments, sampled_outputs)
from janus_tpu_torch.solve.discrete import DiscreteAdjointFn
from janus_tpu_torch.solve.events import normalize_events
from janus_tpu_torch.solve.options import Options


def _one_step(tab, f, t, h, y, args, live=None, want_interp=False):
    """Replay ONE accepted step at frozen (t, h): the step map Φ, with stage
    0 a fresh f(t, y) (the FSAL value). ``live`` [M] masks the right-hand
    side to zero on lanes replaying a dead slot, so their cascade is the
    identity. want_interp: also return the step's dense interpolant (the
    event endpoint and the quadrature need it; f_new, and for dop853 the
    three extra stages, are evaluated for it)."""
    def feval(tt, yy):
        fv = f(tt, yy, args)
        return fv if live is None else torch.where(live[:, None], fv, 0.0)

    ks, y1 = dp.stages(tab, feval, t, y, h, feval(t, y))
    if not want_interp:
        return y1
    f_new = feval(t + h, y1)
    interp, _ = dp.step_interp(tab, feval, t, y, y1, f_new, h, ks)
    return y1, interp


def dopri_adjoint(f: Callable, tspan, y0, args=None,
                  options: Optional[Options] = None, t_eval=None,
                  method: str = "dopri5", events=None,
                  cost: Optional[Callable] = None, device=None):
    """Reverse-differentiable batched adaptive Dormand–Prince solve.

    Returns the final state y(T) [M, D], or with ``t_eval`` the sampled
    trajectory ys [M, T, D]. ``backward()`` of any function of the result
    flows through the discrete adjoint to y0, every floating-point tensor
    leaf of ``args`` (a tree of dicts, lists and tuples: an MLP's weights),
    t0, tf and (t_eval mode) the sample times, where those are tensors that
    require grad. A y0 that is not a tensor goes to ``device``, by default
    the CUDA card. Memory: one (t, h, y) slot per accepted step,
    ``options.adjoint_steps`` slots per lane PER SEGMENT (the gradient is
    NaN on overflow).

    method: 'dopri5' (7 stages, order 5) or 'dopri853' (12 stages, order 8;
    aliases 'rk45', 'dop853').

    t_eval: strictly monotonic 1-D grid inside (t0, tf], in the direction of
    integration; the solve is chained over t0 → t_eval[0] → … → t_eval[-1]
    (warm-started segments), so samples are exact solve endpoints.

    events: TERMINAL event spec(s). Returns ``(y, t)``, both
    differentiable; with t_eval ``(ys, y*, t*)``, samples strictly past t*
    NaN (mask them out of the loss).

    cost: running-cost integrand ``l(t [M], y [M, D], args) -> [M]`` or
    [M, Q]; appends ``q = ∫ l dt`` to the outputs (``(y, q)``, ``(ys, q)``
    summed over the grid, ``(y, t, q)`` with events, q truncated at t*).

    The host syncs of the last backward sweep are in
    ``dopri_adjoint.host_syncs`` (the forward's in ``solve_erk.host_syncs``).
    """
    method = {"rk45": "dopri5", "dop853": "dopri853"}.get(method, method)
    if method not in dp.TABLEAUS:
        raise ValueError(f"dopri_adjoint: unknown method {method!r}; "
                         f"choose from {sorted(dp.TABLEAUS)}")
    opts = options if options is not None else Options()
    specs = normalize_events(events)
    if specs and not all(e.terminal for e in specs):
        raise ValueError("dopri_adjoint(events=...) requires every event "
                         "terminal (non-terminal recordings have no "
                         "gradient contract)")
    y0 = cm.on_device(y0, device)
    t0, tf = tspan

    tab = dp.TABLEAUS[method]

    def run(ta, tb, y, args_, h0):
        dleaves, rebuild, _, _ = _split_diff(args_)

        def fa(t, yy, dl):
            return f(t, yy, rebuild(dl))

        def solve(t0_, tf_, y0_, args0, h0_):
            return dp.solve_erk(tab, f, t0_, tf_, y0_, args0, opts,
                                events=specs or None, quad=cost,
                                _mesh_size=opts.adjoint_steps, _h0=h0_)

        def replay(t, h, yy, dl, live, want_interp):
            return _one_step(tab, fa, t, h, yy, dl, live=live,
                             want_interp=want_interp)

        cfg = {"solve": solve, "replay": replay, "ydot": fa,
               "events": specs, "cost": cost, "rebuild": rebuild,
               "entry": dopri_adjoint}
        return DiscreteAdjointFn.apply(cfg, ta, tb, y, h0, *dleaves)

    if t_eval is None:
        return adjoint_outputs(run(t0, tf, y0, args, None), bool(specs))
    return sampled_outputs(*chain_segments(run, t0, tf, y0, args, t_eval,
                                           bool(specs), "dopri_adjoint"),
                           bool(specs))


dopri_adjoint.host_syncs = 0
