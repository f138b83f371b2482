"""Lockstep masked adaptive steppers (the ported subset: fixed-stage radau)."""

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

# method name -> fixed stage count (None: keep options.min_stages)
_RADAU_STAGES = {"radau": None, "radau5": 3, "radau9": 5, "radau13": 7}


def solve_ivp(f: Callable, tspan, y0, method: str = "dopri5", args: Any = None,
              options: Optional[Options] = None, t_eval=None,
              events=None, jac: Optional[Callable] = None, mass=None,
              tangents=None, args_tangents=None,
              quad: Optional[Callable] = None, dense: int = 0,
              step_args: Any = None,
              **opt_kw) -> Solution:
    """Batched initial-value-problem solve, as ``janus_tpu.solve.solve_ivp``.

    Ported methods: 'radau' (stage count from options.min_stages) and
    'radau5'/'radau9'/'radau13' (s = 3/5/7), fixed stage count. Every other
    method raises NotImplementedError until its slice is ported (ROADMAP.md).
    options: Options(...); or pass rtol=…, atol=… etc. as keywords.
    """
    if options is None:
        options = Options(**opt_kw)
    elif opt_kw:
        options = options.replace(**opt_kw)
    t0, tf = tspan

    method = method.lower()
    if method not in _RADAU_STAGES:
        raise NotImplementedError(
            f"method {method!r} is not ported to janus_tpu_torch yet; "
            f"ported: {sorted(_RADAU_STAGES)} (ROADMAP.md Queue 1)")
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
    "solve_ivp", "solve_radau", "Solution", "Options",
    "RUNNING", "SUCCESS", "MAX_STEPS", "STEP_UNDERFLOW", "NEWTON_STALL",
    "EVENT_TERMINATED", "PARAMS_EXHAUSTED",
]
