"""Lockstep masked adaptive steppers (the ported subset: fixed-stage radau,
with the dense stage LU or the matrix-free GMRES / tridiagonal stage solvers,
mass matrices, dense output, t_eval and quadratures; its continuous adjoint;
and the fused one-kernel Radau5 step)."""

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
from janus_tpu_torch.solve.options import Options
from janus_tpu_torch.solve.radau import solve_radau
from janus_tpu_torch.solve.radau_fused import solve_radau_fused

# method name -> fixed stage count (None: keep options.min_stages)
_RADAU_STAGES = {"radau": None, "radau5": 3, "radau9": 5, "radau13": 7}

# method -> feature support matrix, the ported rows of the reference's.
# solve_ivp RAISES on an unsupported feature instead of dropping it. Of the
# 'radau' row jac=, mass= and t_eval= work (as do dense= and quad=); events=
# is the reference's and raises NotImplementedError in solve_radau until it
# is ported.
FEATURES = {
    #                jac    mass   events t_eval
    "radau":        (True,  True,  True,  True),
    "radau_fused":  (False, False, False, False),
}


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

    Ported methods: 'radau' (stage count from options.min_stages),
    'radau5'/'radau9'/'radau13' (s = 3/5/7), fixed stage count, with
    mass= ([D, D] or [M, D, D], singular allowed) and, by
    Options(stage_solver='gmres'|'tridiag', precond='tridiag'|'lines'|
    'block'), matrix-free stage solves for method-of-lines systems, and
    with t_eval= (Solution.ys, and sens_ys with tangents=), dense=N
    (Solution.interpolate) and quad= (Solution.quad, and sens_quad with
    tangents=); and
    'radau_fused' (Radau5 with the whole step attempt in one CUDA kernel;
    on the card f must be in models.problems.DEVICE_PROBLEMS). Every other
    method raises NotImplementedError until its slice is ported (ROADMAP.md).
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
    if method not in _RADAU_STAGES and method != "radau_fused":
        raise NotImplementedError(
            f"method {method!r} is not ported to janus_tpu_torch yet; "
            f"ported: {sorted(_RADAU_STAGES) + ['radau_fused']} "
            "(ROADMAP.md Queue 1)")
    canonical = "radau" if method in _RADAU_STAGES else method
    _check_features(canonical, jac, mass, events, t_eval)
    if (tangents is not None or args_tangents is not None) \
            and canonical != "radau":
        raise ValueError("tangents= (internal-differentiation sensitivities)"
                         " is supported by the 'radau'/'radaup' methods, "
                         "'seulex', 'rodas' and 'bdf'; use jax.jvp through "
                         "the solve otherwise")
    if quad is not None and canonical != "radau":
        raise ValueError("quad= (running-cost quadratures) is supported by "
                         "the fixed-stage 'radau' methods (collocation-"
                         "weight rule, incl. sens_quad), 'radaup', 'rodas',"
                         " 'seulex', 'bdf' and 'dopri5'/'dopri853' (Gauss-"
                         "Legendre on the dense interpolant); integrate "
                         "the cost as an extra state otherwise")
    if dense and canonical != "radau":
        raise ValueError("dense= (post-hoc Solution.interpolate) is "
                         "supported by the 'radau'/'radaup' methods, "
                         "'rodas', 'seulex', 'bdf' and "
                         "'dopri5'/'dopri853'; use t_eval= otherwise")
    if step_args is not None and canonical != "radau":
        raise ValueError("step_args= (per-accepted-step parameter slabs, "
                         "the reference's theta/nparams_step semantics) is "
                         "supported by the one-step adaptive methods "
                         "'dopri5'/'dopri853', 'seulex', 'rodas' and "
                         "fixed-stage 'radau' (multistep bdf history "
                         "assumes a smooth f across steps); use "
                         "models.controls time-indexed schedules or "
                         "solve.fixed.odeint_fixed(step_args=) otherwise")
    if canonical == "radau_fused":
        return solve_radau_fused(f, t0, tf, y0, args, options, device)
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
_ADJOINT_ITEMS = {"radaup": 17, "rodas": 13, "seulex": 16, "bdf": 15,
                  "dopri5": 14, "dopri853": 14}


def solve_adjoint(f: Callable, tspan, y0, method: str = "radau",
                  args: Any = None, options: Optional[Options] = None,
                  t_eval=None, **kw):
    """Reverse-differentiable batched solve, the ``solve_ivp`` counterpart
    for training and optimization loops. Returns y(T) [M, D] (or ys
    [M, T, D] with ``t_eval=``); ``backward()`` of any function of the
    result flows through the family's adjoint to y0, the floating-point
    tensor leaves of args, t0, tf and the sample times.

    method: 'radau' (and 'radau5'/'radau9'/'radau13'; the continuous
    adjoint, which also takes cost=, n_alg=, checkpoints=, mass=, jac=: see
    ``radau_adjoint``). The reference's other families ('radaup', 'rodas',
    'seulex', 'bdf', 'dopri5', 'dopri853') raise NotImplementedError until
    their adjoints are ported (ROADMAP.md Queue 1)."""
    method = method.lower()
    if method in _RADAU_STAGES:
        stages = _RADAU_STAGES[method]
        if stages is not None:
            options = (options if options is not None else Options()).replace(
                min_stages=stages, max_stages=stages)
        return radau_adjoint(f, tspan, y0, args=args, options=options,
                             t_eval=t_eval, **kw)
    if method in _ADJOINT_ITEMS:
        raise NotImplementedError(
            f"solve_adjoint: the adjoint of method {method!r} is not ported "
            f"to janus_tpu_torch yet (ROADMAP.md Queue 1, item "
            f"{_ADJOINT_ITEMS[method]}); ported: 'radau'")
    raise ValueError(
        f"solve_adjoint: no reverse mode for method {method!r}; available: "
        "radau (continuous). Forward sensitivities: solve_ivp(tangents=)")


__all__ = [
    "solve_ivp", "solve_radau", "solve_radau_fused", "Solution", "Options",
    "FEATURES", "radau_adjoint", "solve_adjoint",
    "RUNNING", "SUCCESS", "MAX_STEPS", "STEP_UNDERFLOW", "NEWTON_STALL",
    "EVENT_TERMINATED", "PARAMS_EXHAUSTED",
]
