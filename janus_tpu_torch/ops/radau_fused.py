"""The fused Radau5 step attempt: the CUDA kernel K4 and its plain twin.

The counterpart of the Pallas kernel inside
``janus_tpu/solve/radau_fused.py:solve_radau_fused``. ``radau5_step``
takes the packed SoA state ``[5D+15, M]`` of ``solve.radau_fused._row_layout``
and runs up to ``max_attempts`` step attempts for every active lane:

- for a CUDA tensor it launches K4 (``csrc/radau5_step.cuh``), which
  updates the state IN PLACE and returns it, by one of two routes
  (``kernel_route``):
  - f in ``models.problems.DEVICE_PROBLEMS`` (``vdp_rhs``,
    ``robertson_rhs``): ``janus_radau5_step`` of ``csrc/radau_fused.cu``
    with the hand-written functor of ``csrc/problems.cuh`` and the
    parameters built by name (PR 3's route);
  - any other f: the functor ``ops.rhs_codegen`` generates from the trace
    of f and its jvp on the state's device, in a unit of its own built at
    first use (``_build/libjanus_rhs_<hash>.so``), with the args' leaves as
    parameter rows (``solve.radau_fused.arg_rows``). A solve traces once
    (``stepper``) and pays that trace in host time: nothing is cached
    across solves. An f the tracer refuses (an op outside its list, one
    that mixes lanes, data-dependent control flow, D > 8) raises
    ValueError naming the op or the limit.
  A kernel that fails to build or launch raises: the twin never stands in
  on the card;
- for a CPU tensor it runs the twin ``solve.radau_fused._step_ref`` (any f)
  and returns a new state.

``radau5_step.launches`` counts kernel launches of both routes;
``kernel_attributes`` reads K4's registers, spills and residency on the
card for either. ``geometry`` chooses a generated unit's layout by (D,
dtype): the lane layout, one lane a thread, where the factors fit shared
memory (D <= 4; 5, 6 in float), and above it the group layout, a lane
over a group of threads with the factors in shared memory (D = 5..8 in
double, 7..8 in float).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from janus_tpu_torch.models.problems import DEVICE_PROBLEMS, DeviceProblem
from janus_tpu_torch.ops import rhs_codegen
from janus_tpu_torch.ops.smalllu import (_DTYPE_CODE, _check_cuda, _raise_on,
                                         refuse_derivatives)
from janus_tpu_torch.solve import common as cm
from janus_tpu_torch.solve import radau_fused as rf

_D = ctypes.c_double
THREADS = 128           # threads per block of K4 (csrc/radau5_step.cuh kThreads)
# D from which a lane spreads over a group of threads: where the lane
# layout's factors no longer fit a block's share of shared memory (csrc Layout, whose
# static_assert refuses the other way round)
GROUP_MIN_DIM = {torch.float64: 5, torch.float32: 7}
GROUP_THREADS = 8       # threads a lane in the group layout
# blocks a SM the group layout asks registers for (__launch_bounds__): the
# fastest of 2-6 on a 32-attempt launch at D = 5..8 on the H100
# (bench.k4_layout, PERF.md)
GROUP_BLOCKS = {torch.float64: 4, torch.float32: 6}


@dataclasses.dataclass(frozen=True)
class Geometry:
    """K4's launch geometry for one (D, dtype), from ``geometry``.

    threads_per_lane: threads that work one lane together (a group, in one
    warp); lanes_per_block: lanes a block; blocks_per_sm: blocks a SM the
    kernel asks registers for (None: the lane layout, whose
    ``min_blocks`` is the kernel's own); scratch_per_lane: values of the
    dtype a lane exchanges through shared memory; smem_bytes: the group
    layout's dynamic shared memory a block, the factors (5 D values a
    thread) and the scratch (0 for the lane layout, whose per-lane arrays
    in shared memory its ``Layout`` sizes)."""

    threads_per_lane: int
    lanes_per_block: int
    blocks_per_sm: Optional[int]
    scratch_per_lane: int
    smem_bytes: int

    @property
    def threads_per_block(self) -> int:
        return self.threads_per_lane * self.lanes_per_block

    def blocks(self, m: int) -> int:
        """Blocks of a launch on m lanes."""
        return -(-m // self.lanes_per_block)

    def lane_of(self, block, thread):
        """(lane, thread within its group) of a thread of a block, as the
        kernel computes them (numbers or numpy arrays)."""
        return (block * self.lanes_per_block + thread // self.threads_per_lane,
                thread % self.threads_per_lane)


def geometry(dim: int, dtype) -> Geometry:
    """The layout K4 takes for a generated functor at D = dim in dtype,
    chosen at build time (the unit is generated with it; the wrapper passes
    it to the launch, which refuses any other):

    - D <= 4, and D = 5, 6 in float: the lane layout, one lane a thread,
      128 lanes a block, the factors in shared memory (where they fit; at D = 5, 6
      in float the group layout measured 3-5x slower, PERF.md);
    - D = 5..8 in double, 7..8 in float: the group layout, a lane over a
      group of 8 threads, 16 lanes a block of 128.
      Thread i < D of a group holds row i of the real factor and rows i and
      i + D of the split-complex one (5 D values; every thread of the block
      has their room) in shared memory, and component i of every per-lane
      vector in registers; each lane exchanges max(D^2, 6D) values (the
      Jacobian's columns, the stages) through shared memory, padded to 8
      modulo 32 so that the four groups of a warp fall on disjoint banks."""
    if dim < GROUP_MIN_DIM[dtype]:
        return Geometry(1, THREADS, None, 0, 0)
    need = max(dim * dim, 6 * dim)
    scratch = need + (8 - need) % 32
    lanes = THREADS // GROUP_THREADS
    itemsize = torch.finfo(dtype).bits // 8
    factors = 5 * dim * THREADS
    return Geometry(GROUP_THREADS, lanes, GROUP_BLOCKS[dtype], scratch,
                    (factors + lanes * scratch) * itemsize)


class _Consts(ctypes.Structure):
    """The C struct JanusRadauConsts of csrc/radau5_step.cuh, field for field."""

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


@dataclasses.dataclass
class Route:
    """How K4 evaluates f for one (f, args) on the card: the hand-written
    functor of a registered problem, or a generated unit and its parameter
    rows [NP, M]."""

    problem: Optional[DeviceProblem] = None
    unit: Optional[rhs_codegen.Unit] = None
    rows: Optional[torch.Tensor] = None


def kernel_route(f, args, state) -> Route:
    """The route of K4 for f with args on the packed state (traces f on
    the state's device when it is not registered)."""
    dim = (state.shape[0] - 15) // 5
    problem = DEVICE_PROBLEMS.get(f)
    if problem is not None:
        if problem.dim != dim:
            raise ValueError(f"radau5_step: {problem.functor} has D="
                             f"{problem.dim}, the state D={dim}")
        return Route(problem=problem)
    rows, _ = rf.arg_rows(args, state[0])
    unit = rhs_codegen.lower(f, args, dim, state.dtype, state.device)
    return Route(unit=unit, rows=rows.contiguous())


def radau5_step(state, tf_row, f, args, consts: rf.StepConsts,
                max_attempts: int = 1, route: Optional[Route] = None):
    """K4: up to max_attempts Radau5 step attempts per active lane on the
    packed state [5D+15, M] (tf_row [1, M]); see the module docstring.
    route (``kernel_route(f, args, state)``, made here when None) lets a
    solve trace f once for all its launches."""
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
    refuse_derivatives("radau5_step (K4)", state, tf_row, args)
    _check_cuda("radau5_step", state, tf_row)
    if route is None:
        route = kernel_route(f, args, state)
    if m == 0:
        return state
    c = _c_consts(consts)
    stream = torch.cuda.current_stream(state.device).cuda_stream
    if route.unit is not None:
        unit = route.unit
        if route.rows.shape != (unit.n_params, m):
            raise ValueError(f"radau5_step: route rows "
                             f"{tuple(route.rows.shape)} for {m} lanes")
        geo = geometry(dim, state.dtype)
        with torch.cuda.device(state.device):
            rc = getattr(unit.library(), f"janus_radau5_step_{unit.name}")(
                state.data_ptr(), tf_row.data_ptr(), route.rows.data_ptr(),
                m, dim, unit.n_params, _DTYPE_CODE[state.dtype],
                ctypes.byref(c), max_attempts, geo.threads_per_lane,
                geo.lanes_per_block, geo.smem_bytes, stream)
    else:
        problem = route.problem
        params = param_rows(problem, args, state[0])
        from janus_tpu_torch.ops._build import load_library
        lib = load_library()
        with torch.cuda.device(state.device):
            rc = lib.janus_radau5_step(
                state.data_ptr(), tf_row.data_ptr(), params.data_ptr(), m,
                problem.functor.encode(), dim, len(problem.params),
                _DTYPE_CODE[state.dtype], ctypes.byref(c), max_attempts,
                stream)
    _raise_on(rc, "radau5_step")
    radau5_step.launches += 1
    return state


def stepper(f, args, max_attempts: int):
    """step(state, tf_row, consts) for a solve loop: K4 launches of up to
    max_attempts attempts, f routed (and, unregistered, traced) once at the
    first launch on the card; the twin on the CPU."""
    route = []

    def step(st, tf_row, consts):
        if st.device.type != "cpu" and not route:
            route.append(kernel_route(f, args, st))
        return radau5_step(st, tf_row, f, args, consts,
                           max_attempts=max_attempts,
                           route=route[0] if route else None)

    return step


def kernel_attributes(f, dtype, unit: Optional[rhs_codegen.Unit] = None
                      ) -> dict:
    """K4's instantiation for f (a registered problem) and dtype, or for a
    generated unit, on the current card: registers and local (spill) bytes
    per thread, dynamic shared bytes per block, per-lane values kept in
    shared memory, resident blocks and warps per SM, SMs, threads a lane,
    lanes a block, threads a block, and the lanes resident at once."""
    from janus_tpu_torch.ops._build import load_library
    out = (ctypes.c_int * 8)()
    if unit is not None:
        rc = getattr(unit.library(), f"janus_radau5_attributes_{unit.name}")(
            out)
    else:
        rc = load_library().janus_radau5_attributes(
            DEVICE_PROBLEMS[f].functor.encode(), _DTYPE_CODE[dtype], out)
    _raise_on(rc, "janus_radau5_attributes")
    regs, local, smem, slots, blocks, sms, per_lane, lanes = out
    return {"registers": regs, "local_bytes": local, "smem_bytes": smem,
            "smem_values_per_lane": slots, "blocks_per_sm": blocks,
            "warps_per_sm": blocks * per_lane * lanes // 32, "sms": sms,
            "threads_per_lane": per_lane, "lanes_per_block": lanes,
            "threads_per_block": per_lane * lanes,
            "resident_lanes": blocks * lanes * sms}


radau5_step.launches = 0


def reset_launch_counts():
    radau5_step.launches = 0
