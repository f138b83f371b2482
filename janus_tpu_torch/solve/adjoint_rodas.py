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

The Function and the backward sweep are ``solve.discrete``'s, shared with
the dopri adjoint: a Python loop over the recorded slots after one host
read, dead slots replayed at a benign step under a zero cotangent, NaN on
a lane whose mesh overflowed.

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

from janus_tpu_torch.linalg.smalllu import lu_factor, lu_solve
from janus_tpu_torch.solve import common as cm
from janus_tpu_torch.solve import rodas as rd
from janus_tpu_torch.solve.adjoint import (_split_diff, adjoint_outputs,
                                           chain_segments, constrained_ydot,
                                           sampled_outputs)
from janus_tpu_torch.solve.discrete import DiscreteAdjointFn
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

        def fa(t, yy, dl):
            return f(t, yy, rebuild(dl))

        jac_fn = (lambda t, yy, dl: jac(t, yy, rebuild(dl))) if jac \
            else default_jacobian(fa)

        def solve(t0_, tf_, y0_, args0, h0_):
            return rd.solve_rodas(f, t0_, tf_, y0_, args0, opts, jac=jac,
                                  mass=mass, events=specs or None, quad=cost,
                                  _mesh_size=opts.adjoint_steps, _h0=h0_)

        def replay(t, h, yy, dl, live, want_interp):
            out = _one_step(fa, jac_fn, mass, opts, t, h, yy, dl,
                            want_interp=want_interp)
            if not want_interp:
                return out
            y_new, c2, c3 = out
            return y_new, rd.contro_interp(yy, y_new, c2, c3)

        def ydot(t, yy, dl):
            # the TRUE velocity (M⁻¹f, or with n_alg the constrained one)
            return constrained_ydot(fa, t, yy, dl, mass, n_alg,
                                    pivot=opts.pivoting)

        cfg = {"solve": solve, "replay": replay, "ydot": ydot,
               "events": specs, "cost": cost, "rebuild": rebuild,
               "entry": rodas_adjoint}
        return DiscreteAdjointFn.apply(cfg, ta, tb, y, h0, *dleaves)

    if t_eval is None:
        return adjoint_outputs(run(t0, tf, y0, args, None), bool(specs))
    return sampled_outputs(*chain_segments(run, t0, tf, y0, args, t_eval,
                                           bool(specs), "rodas_adjoint"),
                           bool(specs))


rodas_adjoint.host_syncs = 0
