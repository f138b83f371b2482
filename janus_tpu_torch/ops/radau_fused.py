"""The fused Radau5 step attempt: the CUDA kernel K4 and its plain twin.

The counterpart of the Pallas kernel inside
``janus_tpu/solve/radau_fused.py:solve_radau_fused``. ``radau5_step``
takes the packed SoA state ``[5D+15, M]`` of ``solve.radau_fused._row_layout``
and runs up to ``max_attempts`` step attempts for every active lane:

- for a CUDA tensor it launches ``janus_radau5_step`` of
  ``csrc/radau_fused.cu``, which updates the state IN PLACE and returns it.
  f must be in ``models.problems.DEVICE_PROBLEMS`` (the kernel evaluates f
  through the named CUDA functor, with the parameters built by name); any
  other f raises ValueError. A kernel that fails to build or launch raises:
  the twin never stands in on the card;
- for a CPU tensor it runs the twin ``solve.radau_fused._step_ref`` (any f)
  and returns a new state.

``radau5_step.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from janus_tpu_torch.models.problems import DEVICE_PROBLEMS
from janus_tpu_torch.ops.smalllu import _DTYPE_CODE, _check_cuda, _raise_on
from janus_tpu_torch.solve import common as cm
from janus_tpu_torch.solve import radau_fused as rf

_D = ctypes.c_double


class _Consts(ctypes.Structure):
    """The C struct JanusRadauConsts of csrc/radau_fused.cu, field for field."""

    _fields_ = [
        ("mu_r", _D), ("mu_cr", _D), ("mu_ci", _D), ("c", _D * 3),
        ("t_mat", _D * 9), ("ti_mat", _D * 9), ("e", _D * 3), ("p", _D * 9),
        ("expo", _D), ("newton_tol", _D), ("eps", _D), ("rtol", _D),
        ("atol", _D), ("safety0", _D), ("facl", _D), ("facr", _D),
        ("quot1", _D), ("quot2", _D), ("max_steps", _D),
        ("newton_maxiter", ctypes.c_int), ("st_success", ctypes.c_int),
        ("st_max_steps", ctypes.c_int), ("st_underflow", ctypes.c_int),
        ("st_stall", ctypes.c_int),
    ]


def _c_consts(k: rf.StepConsts) -> _Consts:
    def flat(mat):
        return [v for row in mat for v in row]

    return _Consts(
        k.mu_r, k.mu_cr, k.mu_ci, (_D * 3)(*k.c), (_D * 9)(*flat(k.t_mat)),
        (_D * 9)(*flat(k.ti_mat)), (_D * 3)(*k.e), (_D * 9)(*flat(k.p)),
        k.expo, k.newton_tol, k.eps, k.rtol, k.atol, k.safety0, k.facl,
        k.facr, k.quot1, k.quot2, k.max_steps, k.newton_maxiter,
        cm.SUCCESS, cm.MAX_STEPS, cm.STEP_UNDERFLOW, cm.NEWTON_STALL)


def _registered():
    return ", ".join(f"{fn.__module__}.{fn.__name__} ({p.functor})"
                     for fn, p in DEVICE_PROBLEMS.items())


def param_rows(problem, args, like):
    """[NP, M] parameter rows of a registered problem, by name in the
    functor's order; each value a scalar (broadcast) or an [M] tensor."""
    m = like.shape[-1]
    rows = []
    for name, v in zip(problem.params, problem.values(args)):
        v = cm.like(v, like)
        if v.ndim == 0:
            v = v.broadcast_to((m,))
        elif v.ndim != 1 or v.shape[0] != m:
            raise ValueError(f"radau5_step: parameter {name!r} must be a "
                             f"scalar or [{m}], got {tuple(v.shape)}")
        rows.append(v)
    return torch.stack(rows).contiguous()


def radau5_step(state, tf_row, f, args, consts: rf.StepConsts,
                max_attempts: int = 1):
    """K4: up to max_attempts Radau5 step attempts per active lane on the
    packed state [5D+15, M] (tf_row [1, M]); see the module docstring."""
    if state.ndim != 2 or (state.shape[0] - 15) % 5 or state.shape[0] < 20:
        raise ValueError(f"radau5_step: state must be [5D+15, M], got "
                         f"{tuple(state.shape)}")
    dim = (state.shape[0] - 15) // 5
    m = state.shape[1]
    if tuple(tf_row.shape) != (1, m):
        raise ValueError(f"radau5_step: tf_row {tuple(tf_row.shape)} does "
                         f"not match state {tuple(state.shape)}")
    if max_attempts < 1:
        raise ValueError(f"radau5_step: max_attempts={max_attempts} < 1")
    if state.device.type == "cpu" and tf_row.device.type == "cpu":
        rows, treedef = rf.arg_rows(args, state[0])
        for _ in range(max_attempts):
            state = rf._step_ref(state, tf_row, rows, f, treedef, consts)
        return state
    problem = DEVICE_PROBLEMS.get(f)
    if problem is None:
        raise ValueError(
            f"radau5_step: f={getattr(f, '__name__', f)!r} has no CUDA "
            f"functor; registered problems: {_registered()} "
            "(models/problems.py:DEVICE_PROBLEMS)")
    if problem.dim != dim:
        raise ValueError(f"radau5_step: {problem.functor} has D="
                         f"{problem.dim}, the state D={dim}")
    _check_cuda("radau5_step", 1, state, tf_row)
    params = param_rows(problem, args, state[0])
    if m == 0:
        return state
    from janus_tpu_torch.ops._build import load_library
    lib = load_library()
    c = _c_consts(consts)
    with torch.cuda.device(state.device):
        rc = lib.janus_radau5_step(
            state.data_ptr(), tf_row.data_ptr(), params.data_ptr(), m,
            problem.functor.encode(), dim, len(problem.params),
            _DTYPE_CODE[state.dtype], ctypes.byref(c), max_attempts,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "radau5_step")
    radau5_step.launches += 1
    return state


radau5_step.launches = 0


def reset_launch_counts():
    radau5_step.launches = 0
