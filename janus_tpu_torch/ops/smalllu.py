"""Batched small-matrix LU in the SoA layout: the CUDA kernels K1/K2/K3 and
their plain torch twins.

The counterpart of ``janus_tpu/ops/smalllu_pallas.py``. Signatures keep the
reference's SoA layout with the trajectory on the last axis: a_t / lu_t
[D·D, M] (row-major matrix entries), b_t / x_t [D, M]. Pivot-free.

- ``lu_factor_t`` (K1), ``lu_solve_t`` (K2) and ``linsolve_fused`` (K3)
  launch the kernels of ``csrc/smalllu.cu`` for a CUDA tensor, or raise; for
  a CPU tensor they run the twins ``lu_factor_t_ref`` / ``lu_solve_t_ref`` /
  ``linsolve_fused_ref``. Nothing else selects the twin: a kernel that fails
  to build or launch raises.
- K1 and K3 at D = 1..``MAX_UNROLLED_D`` (by kernel and dtype: 11-15) run
  kernels instantiated for their D (unrolled, in registers); above, the
  tile kernels of ``csrc/smalllu_tile.cu``: a block copies a tile of lanes
  whole into shared memory, eliminates there with a lane's rows spread
  over threads of one warp, and writes back once, in the layout
  ``tile_geometry`` chooses by (D, dtype). K2 unrolls D = 1..16 and above
  takes D at run time, one lane a thread in device memory. Every form does
  the same arithmetic.
- Each wrapper counts its kernel launches in ``.launches`` (a plain int).
- The kernels have no derivative rule (the reference's ``pallas_call`` has
  JVP and batching rules; these are raw launches). So a CUDA launch is
  refused with a ValueError (``refuse_derivatives``) when an input carries
  a derivative: it requires grad while grad mode is on, it is a forward-AD
  dual, or a ``torch.func`` transform wraps it. The result would otherwise
  carry no tangent and no grad_fn, and the derivative would be lost
  silently. The ways out: the solvers' IND sweeps (``tangents=``,
  ``args_tangents=``), which call the kernels on plain tensors, or the plain
  route (``Options(kernel_lu=False)``).

Arithmetic (kernels and twins): K1/K2 that of ``janus_tpu.linalg.smalllu``
with pivot=False — divide by the pivot / diagonal, zero guarded to 1. K3 that
of the reference's own fused kernel: multiplier ``a[i][k] * (1/a[k][k])``
with no zero guard, b eliminated in the same loop, back substitution
dividing by the diagonal. The kernels are built without FMA contraction
and do the twins' IEEE operations: on the card they agree to the bit.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
from torch.autograd import forward_ad

from janus_tpu_torch.ops._build import TILE_BOUNDS
from janus_tpu_torch.solve.common import tree_leaves

# K1/K3: D = 1..MAX_UNROLLED_D[kernel, dtype] unroll in registers; above,
# the tile kernels: where the tile form measured faster on the H100
# (bench.kernels' SWITCH_DIMS, PERF.md); both forms give the twins' bits
MAX_UNROLLED_D = {("lu_factor_t", torch.float64): 11,
                  ("linsolve_fused", torch.float64): 12,
                  ("lu_factor_t", torch.float32): 13,
                  ("linsolve_fused", torch.float32): 15}
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}

# the card's shared memory (sm_90)
SMEM_PER_SM = 233_472        # 228 KB
SMEM_PER_BLOCK = 232_448     # 227 KB
SMEM_RESERVED = 1_024        # the system's share of each resident block
SMEM_GRANULE = 128           # a block's shared memory is allocated in these


@dataclasses.dataclass(frozen=True)
class TileGeometry:
    """The tile kernels' layout for one (D, dtype, K1 or K3), from
    ``tile_geometry``: threads_per_lane threads of one warp work a lane, a
    thread owning rows r, r + threads_per_lane, ... (rows_per_thread at
    most); a block holds lanes_per_block lanes, entry (i, j) of lane l at
    ``i * row_stride + j * lanes_per_block + l`` of smem_bytes of dynamic
    shared memory; blocks_per_sm of them fit a SM."""

    threads_per_lane: int
    rows_per_thread: int
    lanes_per_block: int
    blocks_per_sm: int
    row_stride: int
    smem_bytes: int

    @property
    def threads_per_block(self) -> int:
        return self.threads_per_lane * self.lanes_per_block


def _row_stride(ncols: int, lanes: int, threads_per_lane: int,
                itemsize: int) -> int:
    """The least row stride >= ncols * lanes that puts the rows a warp's
    threads own at one column on distinct banks: a bank span (a half-warp's
    16 doubles, a warp's 32 floats) holds h = min(threads_per_lane, span)
    rows of span / h lanes each, so the stride is span / h times an odd
    number."""
    span = 16 if itemsize == 8 else 32
    unit = span // min(threads_per_lane, span)
    rs = -(-ncols * lanes // unit) * unit
    return rs if (rs // unit) % 2 else rs + unit


def tile_fits(d, dtype, fused, g):
    """Every (blocks a SM, lanes a block, row stride, shared bytes) that the
    card takes at g threads a lane: 1-4 blocks a SM, lanes in whole warps,
    within the launch bounds of the instantiation for ceil(d / g) rows a
    thread (``TILE_BOUNDS``) and the shared memory of a block and of a SM.
    Empty where a thread would own more rows than any instantiation."""
    itemsize = torch.finfo(dtype).bits // 8
    rows = -(-d // g)
    q = min((q for q in TILE_BOUNDS if q >= rows), default=None)
    if q is None:
        return []
    block_max, min_blocks = TILE_BOUNDS[q]
    out = []
    for nb in (1, 2, 3, 4):
        for lanes in range(32 // g, block_max // g + 1, 32 // g):
            rs = _row_stride(d + fused, lanes, g, itemsize)
            smem = d * rs * itemsize
            held = -(-smem // SMEM_GRANULE) * SMEM_GRANULE + SMEM_RESERVED
            if (nb * lanes * g > block_max * min_blocks
                    or smem > SMEM_PER_BLOCK or nb * held > SMEM_PER_SM):
                break
            out.append((nb, lanes, rs, smem))
    return out


@functools.lru_cache(maxsize=None)
def tile_geometry(d: int, dtype, fused: bool = False) -> TileGeometry:
    """The tile kernels' layout at D = d in dtype, K1 (fused=False) or K3
    (fused=True, b as one more column): the one place it is chosen; the
    launch refuses any other.

    - threads a lane: 8 up to D = 16, 16 up to 32, 32 above (2 rows a
      thread from D = 9 to 64);
    - lanes a block and blocks a SM: of the tiles the card takes
      (``tile_fits``), the first by, in turn, 2 or more blocks a SM (one
      block loads while another eliminates), lanes that fill whole 32-byte
      sectors of a row (to D = 60 at 2 blocks), the most lanes a SM, the
      more blocks. Timing every geometry the card takes (bench.lu_tile
      --sweep, PERF.md) put this pick within 9% of the fastest at each D
      of the sweep.

    Raises ValueError naming D where a single lane does not fit a block's
    shared memory (D > 169 in float64, > 241 in float32)."""
    itemsize = torch.finfo(dtype).bits // 8
    g = 8 if d <= 16 else 16 if d <= 32 else 32
    fits = tile_fits(d, dtype, fused, g)
    if not fits:
        one = d * _row_stride(d + fused, 1, 32, itemsize) * itemsize
        raise ValueError(
            f"{'linsolve_fused (K3)' if fused else 'lu_factor_t (K1)'}: "
            f"D={d} in {dtype} does not fit the tile kernel: one lane needs "
            f"{one} B of shared memory, a block has {SMEM_PER_BLOCK} B")
    sector = 32 // itemsize
    nb, lanes, rs, smem = max(fits, key=lambda f: (
        f[0] >= 2, f[1] % sector == 0, f[0] * f[1], f[0]))
    return TileGeometry(g, -(-d // g), lanes, nb, rs, smem)


def _dim(n: int, what: str) -> int:
    d = math.isqrt(n)
    if d * d != n:
        raise ValueError(f"{what}: leading axis {n} is not D·D")
    return d


def lu_factor_t_ref(a_t):
    """Plain torch twin of K1: packed pivot-free L\\U of a_t [D·D, M]."""
    d = _dim(a_t.shape[0], "lu_factor_t")
    a = [[a_t[i * d + j] for j in range(d)] for i in range(d)]
    for k in range(d):
        piv = a[k][k]
        safe = torch.where(piv == 0.0, 1.0, piv)
        for i in range(k + 1, d):
            mult = a[i][k] / safe
            a[i][k] = mult
            for j in range(k + 1, d):
                a[i][j] = a[i][j] - mult * a[k][j]
    return torch.stack([a[i][j] for i in range(d) for j in range(d)])


def lu_solve_t_ref(lu_t, b_t):
    """Plain torch twin of K2: x_t [D, M] from K1's factors and b_t [D, M]."""
    d = _dim(lu_t.shape[0], "lu_solve_t")
    v = [b_t[i] for i in range(d)]
    for i in range(1, d):
        for j in range(i):
            v[i] = v[i] - lu_t[i * d + j] * v[j]
    for i in reversed(range(d)):
        for j in range(i + 1, d):
            v[i] = v[i] - lu_t[i * d + j] * v[j]
        diag = lu_t[i * d + i]
        v[i] = v[i] / torch.where(diag == 0.0, 1.0, diag)
    return torch.stack(v)


def linsolve_fused_ref(a_t, b_t):
    """Plain torch twin of K3: x_t [D, M] solving A x = b, one pass."""
    d = _dim(a_t.shape[0], "linsolve_fused")
    a = [[a_t[i * d + j] for j in range(d)] for i in range(d)]
    b = [b_t[i] for i in range(d)]
    for k in range(d):
        inv = a[k][k].new_tensor(1.0) / a[k][k]
        for i in range(k + 1, d):
            mult = a[i][k] * inv
            for j in range(k + 1, d):
                a[i][j] = a[i][j] - mult * a[k][j]
            b[i] = b[i] - mult * b[k]
    x = [None] * d
    for i in reversed(range(d)):
        acc = b[i]
        for j in range(i + 1, d):
            acc = acc - a[i][j] * x[j]
        x[i] = acc / a[i][i]
    return torch.stack(x)


def derivative_carrier(t):
    """Why the tensor t carries a derivative that a raw kernel launch would
    drop ("wrapped by a torch.func transform", "requires grad", "is a
    forward-AD dual"), or None."""
    if not isinstance(t, torch.Tensor):
        return None
    if torch._C._functorch.is_functorch_wrapped_tensor(t):
        return "is wrapped by a torch.func transform (jvp, vmap, grad)"
    if t.requires_grad and torch.is_grad_enabled():
        return "requires grad while grad mode is on"
    if forward_ad.unpack_dual(t).tangent is not None:
        return "is a forward-AD dual"
    return None


def refuse_derivatives(name, *trees):
    """Raise ValueError when a tensor leaf of ``trees`` carries a derivative
    (``derivative_carrier``): the kernels K1-K4 have no derivative rule."""
    for leaf in tree_leaves(trees):
        why = derivative_carrier(leaf)
        if why is not None:
            raise ValueError(
                f"{name}: an input {why}, and the CUDA kernels K1-K4 have no "
                "derivative rule (the result would carry no tangent and no "
                "grad_fn). Take forward sensitivities with the solvers' IND "
                "sweep (tangents=, args_tangents=), or differentiate on the "
                "plain route (Options(kernel_lu=False))")


def _check_cuda(name, *ts):
    for t in ts:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: tensor on {t.device}, expected CUDA")
        if t.device != ts[0].device:
            raise ValueError(f"{name}: tensors on {ts[0].device} and "
                             f"{t.device}")
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"{name}: dtype {t.dtype} (kernel takes float32 "
                            "or float64)")
        if t.dtype != ts[0].dtype:
            raise TypeError(f"{name}: mixed dtypes {ts[0].dtype}, {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: input must be contiguous (the SoA "
                             "boundary makes it so)")


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed "
                           f"(cudaError {rc})")


def _tile(a_t, b_t=None):
    """The tile kernel on CUDA tensors, in its geometry: K1's L\\U of a_t, or
    with b_t K3's x. The wrappers' route above ``MAX_UNROLLED_D`` (tests and
    probes call it at any D, to compare the forms)."""
    from janus_tpu_torch.ops._build import load_library
    d, fused = _dim(a_t.shape[0], "tile kernel"), b_t is not None
    geo = tile_geometry(d, a_t.dtype, fused)
    out = torch.empty_like(a_t if b_t is None else b_t)
    with torch.cuda.device(a_t.device):
        rc = load_library().janus_lu_tile(
            a_t.data_ptr(), b_t.data_ptr() if fused else None,
            out.data_ptr(), d, a_t.shape[1], _DTYPE_CODE[a_t.dtype],
            int(fused), geo.threads_per_lane, geo.lanes_per_block,
            geo.row_stride, geo.smem_bytes,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "linsolve_fused" if fused else "lu_factor_t")
    return out


def _unrolled(a_t, b_t=None):
    """The kernel instantiated for D (D <= 16) on CUDA tensors: K1's L\\U of
    a_t, or with b_t K3's x. The wrappers' route up to ``MAX_UNROLLED_D``."""
    from janus_tpu_torch.ops._build import load_library
    d, lib = _dim(a_t.shape[0], "unrolled kernel"), load_library()
    out = torch.empty_like(a_t if b_t is None else b_t)
    with torch.cuda.device(a_t.device):
        stream = torch.cuda.current_stream().cuda_stream
        if b_t is None:
            rc = lib.janus_lu_factor_t(
                a_t.data_ptr(), out.data_ptr(), d, a_t.shape[1],
                _DTYPE_CODE[a_t.dtype], stream)
        else:
            rc = lib.janus_linsolve_fused(
                a_t.data_ptr(), b_t.data_ptr(), out.data_ptr(), d,
                a_t.shape[1], _DTYPE_CODE[a_t.dtype], stream)
    _raise_on(rc, "lu_factor_t" if b_t is None else "linsolve_fused")
    return out


def lu_factor_t(a_t):
    """K1: packed pivot-free L\\U in the SoA layout [D·D, M]."""
    if a_t.ndim != 2:
        raise ValueError(f"lu_factor_t: a_t must be [D·D, M], got "
                         f"{tuple(a_t.shape)}")
    d = _dim(a_t.shape[0], "lu_factor_t")
    if a_t.device.type == "cpu":
        return lu_factor_t_ref(a_t)
    refuse_derivatives("lu_factor_t (K1)", a_t)
    _check_cuda("lu_factor_t", a_t)
    if a_t.shape[1] == 0:
        return torch.empty_like(a_t)
    form = _tile if d > MAX_UNROLLED_D["lu_factor_t", a_t.dtype] else _unrolled
    out = form(a_t)
    lu_factor_t.launches += 1
    return out


def lu_solve_t(lu_t, b_t):
    """K2: substitution with packed SoA factors lu_t [D·D, M], b_t [D, M]."""
    if lu_t.ndim != 2 or b_t.ndim != 2:
        raise ValueError("lu_solve_t: lu_t must be [D·D, M] and b_t [D, M]")
    d = _dim(lu_t.shape[0], "lu_solve_t")
    if b_t.shape != (d, lu_t.shape[1]):
        raise ValueError(f"lu_solve_t: b_t {tuple(b_t.shape)} does not match "
                         f"lu_t {tuple(lu_t.shape)}")
    if lu_t.device.type == "cpu" and b_t.device.type == "cpu":
        return lu_solve_t_ref(lu_t, b_t)
    refuse_derivatives("lu_solve_t (K2)", lu_t, b_t)
    _check_cuda("lu_solve_t", lu_t, b_t)
    out = torch.empty_like(b_t)
    m = b_t.shape[1]
    if m == 0:
        return out
    from janus_tpu_torch.ops._build import load_library
    lib = load_library()
    with torch.cuda.device(b_t.device):
        rc = lib.janus_lu_solve_t(
            lu_t.data_ptr(), b_t.data_ptr(), out.data_ptr(), d, m,
            _DTYPE_CODE[b_t.dtype], torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "lu_solve_t")
    lu_solve_t.launches += 1
    return out


def linsolve_fused(a_t, b_t):
    """K3: x_t [D, M] solving A x = b for a_t [D·D, M], b_t [D, M] in one
    pass (factor and solve fused; nothing but x is written)."""
    if a_t.ndim != 2 or b_t.ndim != 2:
        raise ValueError("linsolve_fused: a_t must be [D·D, M] and b_t "
                         "[D, M]")
    d = _dim(a_t.shape[0], "linsolve_fused")
    if b_t.shape != (d, a_t.shape[1]):
        raise ValueError(f"linsolve_fused: b_t {tuple(b_t.shape)} does not "
                         f"match a_t {tuple(a_t.shape)}")
    if a_t.device.type == "cpu" and b_t.device.type == "cpu":
        return linsolve_fused_ref(a_t, b_t)
    refuse_derivatives("linsolve_fused (K3)", a_t, b_t)
    _check_cuda("linsolve_fused", a_t, b_t)
    if b_t.shape[1] == 0:
        return torch.empty_like(b_t)
    form = (_tile if d > MAX_UNROLLED_D["linsolve_fused", a_t.dtype]
            else _unrolled)
    out = form(a_t, b_t)
    linsolve_fused.launches += 1
    return out


def tile_attributes(d: int, dtype, fused: bool = False) -> dict:
    """What a tile-kernel launch at D = d in dtype uses on the card, by the
    launch's own reckoning (``janus_lu_tile_attributes``): registers and
    local bytes a thread, dynamic shared bytes a block, resident blocks a SM
    (the occupancy query), and the geometry it was given."""
    import ctypes

    from janus_tpu_torch.ops._build import load_library
    geo = tile_geometry(d, dtype, fused)
    info = (ctypes.c_int64 * 5)()
    rc = load_library().janus_lu_tile_attributes(
        d, _DTYPE_CODE[dtype], int(fused), geo.threads_per_lane,
        geo.lanes_per_block, geo.row_stride, geo.smem_bytes, info)
    _raise_on(rc, "tile_attributes")
    return {"registers": info[0], "local_bytes": info[1],
            "smem_bytes": info[2], "blocks_per_sm": info[3],
            "max_threads": info[4], "geometry": geo}


lu_factor_t.launches = 0
lu_solve_t.launches = 0
linsolve_fused.launches = 0


def reset_launch_counts():
    lu_factor_t.launches = 0
    lu_solve_t.launches = 0
    linsolve_fused.launches = 0
