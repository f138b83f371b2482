"""Lockstep masked adaptive steppers (the ported subset: fixed-stage radau
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
from janus_tpu_torch.solve.options import Options
from janus_tpu_torch.solve.radau import solve_radau
from janus_tpu_torch.solve.radau_fused import solve_radau_fused

# method name -> fixed stage count (None: keep options.min_stages)
_RADAU_STAGES = {"radau": None, "radau5": 3, "radau9": 5, "radau13": 7}

# method -> feature support matrix, the ported rows of the reference's.
# solve_ivp RAISES on an unsupported feature instead of dropping it.
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
              step_args: Any = None,
              **opt_kw) -> Solution:
    """Batched initial-value-problem solve, as ``janus_tpu.solve.solve_ivp``.

    Ported methods: 'radau' (stage count from options.min_stages),
    'radau5'/'radau9'/'radau13' (s = 3/5/7), fixed stage count, and
    'radau_fused' (Radau5 with the whole step attempt in one CUDA kernel;
    on the card f must be in models.problems.DEVICE_PROBLEMS). Every other
    method raises NotImplementedError until its slice is ported (ROADMAP.md).
    options: Options(...); or pass rtol=…, atol=… etc. as keywords.
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
        return solve_radau_fused(f, t0, tf, y0, args, options)
    stages = _RADAU_STAGES[method]
    if stages is not None:
        options = options.replace(min_stages=stages, max_stages=stages)
    if options.min_stages != options.max_stages:
        raise NotImplementedError(
            "variable-order radau (min_stages != max_stages) is not ported "
            "to janus_tpu_torch yet; it comes with slice 7 (radaup)")
    return solve_radau(f, t0, tf, y0, args, options, t_eval,
                       jac=jac, mass=mass, events=events,
                       tangents=tangents, args_tangents=args_tangents,
                       quad=quad, dense=dense, step_args=step_args)


__all__ = [
    "solve_ivp", "solve_radau", "solve_radau_fused", "Solution", "Options",
    "FEATURES",
    "RUNNING", "SUCCESS", "MAX_STEPS", "STEP_UNDERFLOW", "NEWTON_STALL",
    "EVENT_TERMINATED", "PARAMS_EXHAUSTED",
]
