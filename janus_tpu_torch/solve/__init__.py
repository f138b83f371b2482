"""Lockstep masked adaptive steppers: every method of the reference. The
explicit Dormand–Prince pairs and their discrete adjoint; fixed-stage radau,
with the dense stage LU or the matrix-free GMRES / tridiagonal stage
solvers, mass matrices, dense output, t_eval, quadratures, events,
step_args, step recording and the QR fallback; its continuous adjoint and
Hessian-vector products; the variable-order Radau ladder (radaup) and its
continuous adjoint; RODAS4 and its discrete adjoint; the variable-order
NDF/BDF and its discrete adjoint; SEULEX and its discrete adjoint; the
fused one-kernel Radau5 step; the legacy steppers BDF2 and GRK4T; and the
fixed-grid reverse-differentiable ``fixed.odeint_fixed``."""

from __future__ import annotations

from typing import Any, Callable, Optional

from janus_tpu_torch.solve.common import (
    Solution,
    RUNNING,
    SUCCESS,
    MAX_STEPS,
    STEP_UNDERFLOW,
    NEWTON_STALL,
    EVENT_TERMINATED,
    PARAMS_EXHAUSTED,
)
from janus_tpu_torch.solve.adjoint import radau_adjoint
from janus_tpu_torch.solve.adjoint_dopri import dopri_adjoint
from janus_tpu_torch.solve.adjoint_ndf import ndf_adjoint
from janus_tpu_torch.solve.adjoint_rodas import rodas_adjoint
from janus_tpu_torch.solve.adjoint_seulex import seulex_adjoint
from janus_tpu_torch.solve.bdf import solve_bdf2
from janus_tpu_torch.solve.dopri import TABLEAUS, solve_erk
from janus_tpu_torch.solve.events import Event
from janus_tpu_torch.solve.hvp import radau_hvp
from janus_tpu_torch.solve.ndf import solve_bdf
from janus_tpu_torch.solve.options import Options
from janus_tpu_torch.solve.radau import solve_radau
from janus_tpu_torch.solve.radau_fused import solve_radau_fused
from janus_tpu_torch.solve.radaup import solve_radau_vo
from janus_tpu_torch.solve.rodas import solve_rodas
from janus_tpu_torch.solve.rosenbrock import solve_ros4
from janus_tpu_torch.solve.seulex import solve_seulex

# method name -> fixed stage count (None: keep options.min_stages)
_RADAU_STAGES = {"radau": None, "radau5": 3, "radau9": 5, "radau13": 7}

# method -> feature support matrix, the reference's. solve_ivp RAISES on an
# unsupported feature instead of dropping it.
FEATURES = {
    #                jac    mass   events t_eval
    "dopri5":       (False, False, True,  True),
    "dopri853":     (False, False, True,  True),
    "radau":        (True,  True,  True,  True),
    "radaup":       (True,  True,  True,  True),
    "radau_fused":  (False, False, False, False),
    "bdf":          (True,  True,  True,  True),
    "bdf2":         (True,  False, False, True),   # legacy: subsumed by bdf
    "seulex":       (True,  True,  True,  True),
    "rodas":        (True,  True,  True,  True),
    "grk4t":        (True,  False, False, True),   # legacy: subsumed by rodas
}

# the reference's aliases (janus_tpu/solve/__init__.py); radau5/9/13 also
# fix the stage count (_RADAU_STAGES)
_ALIASES = {
    "rk45": "dopri5", "dop853": "dopri853",
    "radau5": "radau", "radau9": "radau", "radau13": "radau",
    "ndf": "bdf", "bdf_classic": "bdf",
    "ros4": "grk4t", "rosenbrock": "grk4t",
}

def _canonical(method: str) -> str:
    """The method's canonical name; ValueError for a name the reference
    does not know either."""
    canonical = _ALIASES.get(method, method)
    if canonical not in FEATURES:
        raise ValueError(f"unknown method {method!r}; known: "
                         f"{sorted(FEATURES)} and the aliases "
                         f"{sorted(_ALIASES)}")
    return canonical


def _check_features(method: str, jac, mass, events, t_eval):
    sup_jac, sup_mass, sup_events, sup_teval = FEATURES[method]
    if jac is not None and not sup_jac:
        raise ValueError(f"method {method!r} does not use a Jacobian "
                         "(explicit method); drop jac= or pick a stiff solver")
    if mass is not None and not sup_mass:
        raise ValueError(f"method {method!r} does not support a mass matrix; "
                         "use method='radau', 'radaup', 'seulex', 'rodas' "
                         "or 'bdf' (invertible mass only)")
    if events is not None and not sup_events:
        raise ValueError(f"method {method!r} does not support events; "
                         "use 'dopri5', 'dopri853', 'radau', 'radaup', "
                         "'bdf', 'seulex' or 'rodas'")
    if t_eval is not None and not sup_teval:
        raise ValueError(f"method {method!r} does not support t_eval")


def solve_ivp(f: Callable, tspan, y0, method: str = "dopri5", args: Any = None,
              options: Optional[Options] = None, t_eval=None,
              events=None, jac: Optional[Callable] = None, mass=None,
              tangents=None, args_tangents=None,
              quad: Optional[Callable] = None, dense: int = 0,
              step_args: Any = None, device=None,
              **opt_kw) -> Solution:
    """Batched initial-value-problem solve, as ``janus_tpu.solve.solve_ivp``.

    Methods, every one of the reference's: 'dopri5' (the default) and
    'dopri853' (aliases 'rk45', 'dop853': explicit, with t_eval=, events=,
    quad=, dense=, step_args=); 'radau' (stage count from
    options.min_stages), 'radau5'/'radau9'/'radau13' (s = 3/5/7), fixed
    stage count, with mass= ([D, D] or [M, D, D], singular allowed) and, by
    Options(stage_solver='gmres'|'tridiag', precond='tridiag'|'lines'|
    'block'), matrix-free stage solves for method-of-lines systems, and
    with t_eval= (Solution.ys, and sens_ys with tangents=), dense=N
    (Solution.interpolate), quad= (Solution.quad, and sens_quad with
    tangents=) and events= (``solve.events.Event``; Solution.event_t,
    event_y, event_idx, and sens_t with tangents=); 'radaup' (the
    variable-order ladder, stages 1..7 unless options set a ladder of
    their own; 'radau' with min_stages != max_stages is the same ladder),
    with what fixed-stage radau takes but step_args= and sens_quad;
    'rodas' (RODAS4, with mass=, t_eval=, events=, dense=, quad= and, in
    terminal mode, tangents=); 'bdf'/'ndf' (variable-order NDF, orders
    1-5) and 'bdf_classic' (classical BDF), with mass=, t_eval=, events=,
    dense=, quad=, the matrix-free stage solvers and, in terminal mode,
    tangents=; 'seulex' (extrapolated linearly implicit Euler, with mass=,
    t_eval=, events=, dense=, quad=, step_args= and, in terminal mode,
    tangents=); 'radau_fused' (Radau5 with the whole step attempt in one
    CUDA kernel; on the card f runs through a hand-written functor
    (models.problems.DEVICE_PROBLEMS) or one ops.rhs_codegen generates
    from its trace, D <= 8);
    and the legacy steppers 'bdf2' (variable-step BDF2) and 'grk4t'
    (aliases 'ros4', 'rosenbrock': Kaps-Rentrop GRK4T), with jac= and
    t_eval= only. A name the reference does not know raises ValueError.
    options: Options(...); or pass rtol=…, atol=… etc. as keywords.
    device: where a y0 that is not a torch tensor goes (default: the CUDA
    card; with no card, pass a CPU tensor or device='cpu'). A torch y0
    solves on its own device.
    """
    if options is None:
        options = Options(**opt_kw)
    elif opt_kw:
        options = options.replace(**opt_kw)
    t0, tf = tspan

    method = method.lower()
    canonical = _canonical(method)
    _check_features(canonical, jac, mass, events, t_eval)
    if (tangents is not None or args_tangents is not None) \
            and canonical not in ("radau", "radaup", "rodas", "bdf",
                                  "seulex"):
        raise ValueError("tangents= (internal-differentiation sensitivities)"
                         " is supported by the 'radau'/'radaup' methods, "
                         "'seulex', 'rodas' and 'bdf'; use torch.func.jvp "
                         "through the solve otherwise")
    if quad is not None and canonical not in ("radau", "radaup", "rodas",
                                              "bdf", "seulex", "dopri5",
                                              "dopri853"):
        raise ValueError("quad= (running-cost quadratures) is supported by "
                         "the fixed-stage 'radau' methods (collocation-"
                         "weight rule, incl. sens_quad), 'radaup', 'rodas',"
                         " 'seulex', 'bdf' and 'dopri5'/'dopri853' (Gauss-"
                         "Legendre on the dense interpolant); integrate "
                         "the cost as an extra state otherwise")
    if dense and canonical not in ("radau", "radaup", "rodas", "bdf",
                                   "seulex", "dopri5", "dopri853"):
        raise ValueError("dense= (post-hoc Solution.interpolate) is "
                         "supported by the 'radau'/'radaup' methods, "
                         "'rodas', 'seulex', 'bdf' and "
                         "'dopri5'/'dopri853'; use t_eval= otherwise")
    if step_args is not None and canonical not in ("radau", "rodas",
                                                   "seulex", "dopri5",
                                                   "dopri853"):
        raise ValueError("step_args= (per-accepted-step parameter slabs, "
                         "the reference's theta/nparams_step semantics) is "
                         "supported by the one-step adaptive methods "
                         "'dopri5'/'dopri853', 'seulex', 'rodas' and "
                         "fixed-stage 'radau' (multistep bdf history "
                         "assumes a smooth f across steps); use "
                         "models.controls time-indexed schedules or "
                         "solve.fixed.odeint_fixed(step_args=) otherwise")
    if canonical in TABLEAUS:
        return solve_erk(TABLEAUS[canonical], f, t0, tf, y0, args, options,
                         t_eval, events=events, step_args=step_args,
                         quad=quad, dense=dense, device=device)
    if canonical == "radau_fused":
        return solve_radau_fused(f, t0, tf, y0, args, options, device)
    if canonical == "rodas":
        return solve_rodas(f, t0, tf, y0, args, options, t_eval, jac=jac,
                           mass=mass, events=events, tangents=tangents,
                           args_tangents=args_tangents, quad=quad,
                           dense=dense, step_args=step_args, device=device)
    if canonical == "seulex":
        return solve_seulex(f, t0, tf, y0, args, options, t_eval, jac=jac,
                            mass=mass, events=events, tangents=tangents,
                            args_tangents=args_tangents, quad=quad,
                            dense=dense, step_args=step_args, device=device)
    if canonical == "bdf":
        # variable order 1-5 with the NDF kappas (as scipy's BDF), or
        # classical BDF
        return solve_bdf(f, t0, tf, y0, args, options, t_eval, jac=jac,
                         events=events, mass=mass, tangents=tangents,
                         args_tangents=args_tangents, quad=quad,
                         dense=dense, ndf=method != "bdf_classic",
                         device=device)
    if canonical == "bdf2":
        return solve_bdf2(f, t0, tf, y0, args, options, t_eval, jac=jac,
                          device=device)
    if canonical == "grk4t":
        return solve_ros4(f, t0, tf, y0, args, options, t_eval, jac=jac,
                          device=device)
    stages = _RADAU_STAGES.get(method)
    if stages is not None:
        options = options.replace(min_stages=stages, max_stages=stages)
    if method == "radaup" and options.min_stages == options.max_stages:
        # variable order by default: stages 1..7
        options = options.replace(min_stages=1, max_stages=7)
    if options.min_stages != options.max_stages:
        if step_args is not None:
            raise ValueError("step_args= needs a fixed-stage radau (e.g. "
                             "method='radau5'); the variable-order ladder "
                             "re-attempts steps across orders with no "
                             "slab-row contract")
        return solve_radau_vo(f, t0, tf, y0, args, options, t_eval, jac=jac,
                              mass=mass, events=events, tangents=tangents,
                              args_tangents=args_tangents, quad=quad,
                              dense=dense, device=device)
    return solve_radau(f, t0, tf, y0, args, options, t_eval,
                       jac=jac, mass=mass, events=events,
                       tangents=tangents, args_tangents=args_tangents,
                       quad=quad, dense=dense, step_args=step_args,
                       device=device)


def solve_adjoint(f: Callable, tspan, y0, method: str = "radau",
                  args: Any = None, options: Optional[Options] = None,
                  t_eval=None, **kw):
    """Reverse-differentiable batched solve, the ``solve_ivp`` counterpart
    for training and optimization loops. Returns y(T) [M, D] (or ys
    [M, T, D] with ``t_eval=``); ``backward()`` of any function of the
    result flows through the family's adjoint to y0, the floating-point
    tensor leaves of args, t0, tf and the sample times.

    method: 'radau' (and 'radau5'/'radau9'/'radau13'; the continuous
    adjoint, which also takes events=, cost=, n_alg=, checkpoints=, mass=,
    jac=: see ``radau_adjoint``), 'radaup' (the same continuous adjoint
    over the variable-order forward ladder, stages 1..7 unless options set
    a ladder: per-lane order adaptivity in the recorded mesh, the backward
    sweep at the ladder's top order) and 'rodas' (the discrete adjoint, which
    takes events=, cost=, n_alg=, mass=, jac=: see ``rodas_adjoint``) and
    'dopri5'/'dopri853' (the discrete adjoint of the explicit family, the
    neural-ODE training path; events=, cost=: see ``dopri_adjoint``) and
    'bdf'/'ndf'/'bdf_classic' (the discrete adjoint of the NDF/BDF family,
    which takes events=, cost=, n_alg=, mass=, jac=: see ``ndf_adjoint``;
    'bdf_classic' replays classical BDF) and 'seulex' (the discrete
    adjoint of the extrapolation ladder, which takes events=, cost=,
    n_alg=, mass=, jac=: see ``seulex_adjoint``). With
    terminal events= they return (y*, t*), or (ys, y*, t*) with t_eval=.
    Aliases follow solve_ivp's table. A method with no reverse mode
    ('bdf2', 'grk4t' and its aliases, 'radau_fused') raises ValueError."""
    method = method.lower()
    if method in _RADAU_STAGES:
        stages = _RADAU_STAGES[method]
        if stages is not None:
            options = (options if options is not None else Options()).replace(
                min_stages=stages, max_stages=stages)
        return radau_adjoint(f, tspan, y0, args=args, options=options,
                             t_eval=t_eval, **kw)
    if method == "radaup":
        # variable order by default, as in solve_ivp: the forward solve is
        # the ladder, the backward sweep runs at its top order
        opts = options if options is not None else Options()
        if opts.min_stages == opts.max_stages:
            opts = opts.replace(min_stages=1, max_stages=7)
        return radau_adjoint(f, tspan, y0, args=args, options=opts,
                             t_eval=t_eval, **kw)
    canonical = _ALIASES.get(method, method)
    if canonical == "rodas":
        return rodas_adjoint(f, tspan, y0, args=args, options=options,
                             t_eval=t_eval, **kw)
    if canonical in TABLEAUS:
        return dopri_adjoint(f, tspan, y0, args=args, options=options,
                             t_eval=t_eval, method=canonical, **kw)
    if canonical == "bdf":
        # 'bdf_classic' replays classical BDF, as solve_ivp solves it
        if method == "bdf_classic":
            kw = {"ndf": False, **kw}
        return ndf_adjoint(f, tspan, y0, args=args, options=options,
                           t_eval=t_eval, **kw)
    if canonical == "seulex":
        return seulex_adjoint(f, tspan, y0, args=args, options=options,
                              t_eval=t_eval, **kw)
    raise ValueError(
        f"solve_adjoint: no reverse mode for method {method!r}; available: "
        "radau/radaup (continuous), rodas, bdf, seulex and dopri5/dopri853 "
        "(discrete). Forward sensitivities: solve_ivp(tangents=)")


__all__ = [
    "solve_ivp", "solve_erk", "solve_radau", "solve_radau_fused",
    "solve_radau_vo", "solve_rodas", "solve_bdf", "solve_seulex",
    "solve_bdf2", "solve_ros4", "Solution", "Options", "Event", "FEATURES",
    "radau_adjoint", "radau_hvp", "rodas_adjoint", "dopri_adjoint",
    "ndf_adjoint", "seulex_adjoint",
    "solve_adjoint",
    "RUNNING", "SUCCESS", "MAX_STEPS", "STEP_UNDERFLOW", "NEWTON_STALL",
    "EVENT_TERMINATED", "PARAMS_EXHAUSTED",
]
