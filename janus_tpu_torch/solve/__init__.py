"""Lockstep masked adaptive steppers (the ported subset: the explicit
Dormand–Prince pairs and their discrete adjoint; fixed-stage radau, with the
dense stage LU or the matrix-free GMRES / tridiagonal stage solvers, mass
matrices, dense output, t_eval, quadratures, events, step_args, step
recording and the QR fallback; its continuous adjoint and Hessian-vector
products; RODAS4 and its discrete adjoint; the variable-order NDF/BDF and
its discrete adjoint; SEULEX and its discrete adjoint; and the fused
one-kernel Radau5 step)."""

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
from janus_tpu_torch.solve.dopri import TABLEAUS, solve_erk
from janus_tpu_torch.solve.events import Event
from janus_tpu_torch.solve.hvp import radau_hvp
from janus_tpu_torch.solve.ndf import solve_bdf
from janus_tpu_torch.solve.options import Options
from janus_tpu_torch.solve.radau import solve_radau
from janus_tpu_torch.solve.radau_fused import solve_radau_fused
from janus_tpu_torch.solve.rodas import solve_rodas
from janus_tpu_torch.solve.seulex import solve_seulex

# method name -> fixed stage count (None: keep options.min_stages)
_RADAU_STAGES = {"radau": None, "radau5": 3, "radau9": 5, "radau13": 7}

# method -> feature support matrix, the ported rows of the reference's.
# solve_ivp RAISES on an unsupported feature instead of dropping it.
FEATURES = {
    #                jac    mass   events t_eval
    "dopri5":       (False, False, True,  True),
    "dopri853":     (False, False, True,  True),
    "bdf":          (True,  True,  True,  True),
    "radau":        (True,  True,  True,  True),
    "radau_fused":  (False, False, False, False),
    "rodas":        (True,  True,  True,  True),
    "seulex":       (True,  True,  True,  True),
}

# the reference's aliases (janus_tpu/solve/__init__.py); radau5/9/13 also
# fix the stage count (_RADAU_STAGES)
_ALIASES = {
    "rk45": "dopri5", "dop853": "dopri853",
    "radau5": "radau", "radau9": "radau", "radau13": "radau",
    "ndf": "bdf", "bdf_classic": "bdf",
    "ros4": "grk4t", "rosenbrock": "grk4t",
}

# the reference's methods that are not ported yet -> their ROADMAP.md Queue 1
# item
_UNPORTED = {"radaup": 17, "bdf2": 18, "grk4t": 18}


def _canonical(method: str) -> str:
    """The method's canonical name; NotImplementedError (naming its item)
    for a method of the reference that is not ported, ValueError for a name
    the reference does not know either."""
    canonical = _ALIASES.get(method, method)
    if canonical in _UNPORTED:
        raise NotImplementedError(
            f"method {method!r} is not ported to janus_tpu_torch yet "
            f"(ROADMAP.md Queue 1, item {_UNPORTED[canonical]}); ported: "
            f"{sorted(set(FEATURES) | set(_RADAU_STAGES))}")
    if canonical not in FEATURES:
        raise ValueError(f"unknown method {method!r}; known: "
                         f"{sorted(set(FEATURES) | set(_UNPORTED))} and the "
                         f"aliases {sorted(_ALIASES)}")
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

    Ported methods: 'dopri5' (the default) and 'dopri853' (aliases 'rk45',
    'dop853': explicit, with t_eval=, events=, quad=, dense=, step_args=);
    'radau' (stage count from options.min_stages),
    'radau5'/'radau9'/'radau13' (s = 3/5/7), fixed stage count, with
    mass= ([D, D] or [M, D, D], singular allowed) and, by
    Options(stage_solver='gmres'|'tridiag', precond='tridiag'|'lines'|
    'block'), matrix-free stage solves for method-of-lines systems, and
    with t_eval= (Solution.ys, and sens_ys with tangents=), dense=N
    (Solution.interpolate), quad= (Solution.quad, and sens_quad with
    tangents=) and events= (``solve.events.Event``; Solution.event_t,
    event_y, event_idx, and sens_t with tangents=); 'rodas' (RODAS4, with
    mass=, t_eval=, events=, dense=, quad= and, in terminal mode,
    tangents=); 'bdf'/'ndf' (variable-order NDF, orders 1-5) and
    'bdf_classic' (classical BDF), with mass=, t_eval=, events=, dense=,
    quad=, the matrix-free stage solvers and, in terminal mode, tangents=;
    'seulex' (extrapolated linearly implicit Euler, with mass=, t_eval=,
    events=, dense=, quad=, step_args= and, in terminal mode, tangents=);
    and 'radau_fused' (Radau5 with the whole step attempt in one CUDA kernel;
    on the card f must be in models.problems.DEVICE_PROBLEMS). The
    reference's other methods raise NotImplementedError naming the
    ROADMAP.md item that ports them; a name the reference does not know
    raises ValueError.
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
            and canonical not in ("radau", "rodas", "bdf", "seulex"):
        raise ValueError("tangents= (internal-differentiation sensitivities)"
                         " is supported by the 'radau'/'radaup' methods, "
                         "'seulex', 'rodas' and 'bdf'; use torch.func.jvp "
                         "through the solve otherwise")
    if quad is not None and canonical not in ("radau", "rodas", "bdf",
                                              "seulex", "dopri5",
                                              "dopri853"):
        raise ValueError("quad= (running-cost quadratures) is supported by "
                         "the fixed-stage 'radau' methods (collocation-"
                         "weight rule, incl. sens_quad), 'radaup', 'rodas',"
                         " 'seulex', 'bdf' and 'dopri5'/'dopri853' (Gauss-"
                         "Legendre on the dense interpolant); integrate "
                         "the cost as an extra state otherwise")
    if dense and canonical not in ("radau", "rodas", "bdf", "seulex",
                                   "dopri5", "dopri853"):
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
    stages = _RADAU_STAGES[method]
    if stages is not None:
        options = options.replace(min_stages=stages, max_stages=stages)
    if options.min_stages != options.max_stages:
        raise NotImplementedError(
            "variable-order radau (min_stages != max_stages) is not ported "
            "to janus_tpu_torch yet; it comes with radaup (ROADMAP.md "
            "Queue 1)")
    return solve_radau(f, t0, tf, y0, args, options, t_eval,
                       jac=jac, mass=mass, events=events,
                       tangents=tangents, args_tangents=args_tangents,
                       quad=quad, dense=dense, step_args=step_args,
                       device=device)


# method -> the Queue 1 item of ROADMAP.md that brings its adjoint
_ADJOINT_ITEMS = {"radaup": 17}


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
    jac=: see ``radau_adjoint``) and 'rodas' (the discrete adjoint, which
    takes events=, cost=, n_alg=, mass=, jac=: see ``rodas_adjoint``) and
    'dopri5'/'dopri853' (the discrete adjoint of the explicit family, the
    neural-ODE training path; events=, cost=: see ``dopri_adjoint``) and
    'bdf'/'ndf'/'bdf_classic' (the discrete adjoint of the NDF/BDF family,
    which takes events=, cost=, n_alg=, mass=, jac=: see ``ndf_adjoint``;
    'bdf_classic' replays classical BDF) and 'seulex' (the discrete
    adjoint of the extrapolation ladder, which takes events=, cost=,
    n_alg=, mass=, jac=: see ``seulex_adjoint``). With
    terminal events= they return (y*, t*), or (ys, y*, t*) with t_eval=.
    Aliases follow solve_ivp's table. The reference's other family
    ('radaup') raises
    NotImplementedError until its adjoint is ported (ROADMAP.md Queue
    1); a method with no reverse mode raises ValueError."""
    method = method.lower()
    if method in _RADAU_STAGES:
        stages = _RADAU_STAGES[method]
        if stages is not None:
            options = (options if options is not None else Options()).replace(
                min_stages=stages, max_stages=stages)
        return radau_adjoint(f, tspan, y0, args=args, options=options,
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
    if canonical in _ADJOINT_ITEMS:
        raise NotImplementedError(
            f"solve_adjoint: the adjoint of method {method!r} is not ported "
            f"to janus_tpu_torch yet (ROADMAP.md Queue 1, item "
            f"{_ADJOINT_ITEMS[canonical]}); ported: 'radau', 'rodas', "
            "'bdf', 'seulex', 'dopri5', 'dopri853'")
    raise ValueError(
        f"solve_adjoint: no reverse mode for method {method!r}; available: "
        "radau (continuous), rodas, bdf, seulex and dopri5/dopri853 "
        "(discrete). "
        "Forward sensitivities: solve_ivp(tangents=)")


__all__ = [
    "solve_ivp", "solve_erk", "solve_radau", "solve_radau_fused",
    "solve_rodas", "solve_bdf", "solve_seulex", "Solution", "Options", "Event", "FEATURES",
    "radau_adjoint", "radau_hvp", "rodas_adjoint", "dopri_adjoint",
    "ndf_adjoint", "seulex_adjoint",
    "solve_adjoint",
    "RUNNING", "SUCCESS", "MAX_STEPS", "STEP_UNDERFLOW", "NEWTON_STALL",
    "EVENT_TERMINATED", "PARAMS_EXHAUSTED",
]
