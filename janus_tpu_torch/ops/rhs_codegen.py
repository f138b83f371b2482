"""Trace a right-hand side f into a per-lane program and a CUDA functor for
K4, the fused Radau5 step kernel.

The counterpart of Pallas inlining the caller's f into the reference's
fused kernel (``janus_tpu/solve/radau_fused.py:141-151``, its Jacobian by
``jax.jvp`` of the inlined f at ``:185-199``; scope there: args leaves of
shape [M] or scalar, D up to ~8). On the card K4
(``csrc/radau5_step.cuh``) evaluates f through a C++ functor; for every f
but the two hand-written ones of ``models.problems.DEVICE_PROBLEMS`` this
module writes that functor:

1. **Trace.** ``torch.fx.experimental.proxy_tensor.make_fx`` (real tensors)
   traces, on tensors of the solve's dtype on the solve's device at a lane
   count unlike D (5, or 7 when D = 5), the very callable and args assembly
   the twin ``solve.radau_fused._step_ref`` runs: ``f(t, y,
   treedef(list(rows)))`` with the rows of ``arg_rows`` and t an [M] row,
   and ``torch.func.jvp`` of ``y -> f(t, y, args)`` for the Jacobian
   columns. A tensor f closes over is a constant of the trace, read where
   it lies (on the card, as the twin reads it there). The jvp is traced as
   torch computes it, so the functor's dual rules are torch.func.jvp's own
   formulas, term order included, on whatever torch runs. The fused solve
   traces once per solve (``ops.radau_fused.stepper``) and caches nothing:
   a changed closure constant gives a new functor, never a stale one, and
   every solve pays the trace in host time (``Unit.trace_seconds``; the
   card's times per f in PERF.md).
2. **Lower.** Each traced tensor becomes an array of elements, one per
   entry, each a node of the per-lane program and the lane it belongs to.
   Shape-only ops (select, slice, unbind, split, view/reshape, expand,
   squeeze/unsqueeze, permute, stack, cat, clone, alias, a same-dtype
   ``_to_copy``, the zero scatters ``select_backward``/``slice_backward``
   that grad leaves) move elements at generation time; arithmetic makes
   nodes, one per (op, operands), so that every lane shares them. Dead code
   of the trace (the jvp's zero-tensor bookkeeping) is skipped.
3. **Emit.** The value program and the jvp's program as one functor with
   ``problems.cuh``'s interface, ``f<T, T>`` and ``f<T, Dual<T>>``, each
   node written as PyTorch's CUDA kernel of its op computes it (``_EMIT``:
   a Python number operand enters as ``T(c)``; a division by a Python
   number or a CPU scalar tensor is ``x * (1/c)``, as ``div_true`` does;
   ``pow`` by a number takes PyTorch's special cases 0, 1, 0.5, -0.5, -1,
   2, 3 and -2; exp, log, sin, cos, tanh, rsqrt, pow and the compound
   formulas are the -fmad=true functions of ``csrc/libm_fmad.cu`` and
   ``pow_fmad.cu``, built as PyTorch builds its kernels). The translation
   unit holds the functor, ``radau5_step.cuh`` and ``extern "C"`` entries
   named by the hash of the source, headers and flags, which also names
   the library ``ops._build.build_unit`` compiles at first use.
4. **Evaluate.** ``Program.evaluate`` is the functor's plain twin: it runs
   the program with the torch op of each node on [M] rows, values, and
   duals with a one-hot tangent (``jacobian``).

Lowered ops: add, sub, rsub, mul, div (Tensor and Scalar forms), neg,
reciprocal, pow (Tensor and Scalar exponent), exp, log, sin, cos, tanh,
sqrt, rsqrt, abs, sign/sgn, where, maximum, minimum, clamp/clamp_min/
clamp_max (number bounds), the comparisons and logical ops, tanh_backward,
zeros/ones/full(_like), scalar_tensor, tensor constants of the closure,
and a sum over a component axis, added in index order. Refused, each with a
ValueError naming f and the op or the limit: an op that combines lanes (a
reduction or product over the batch axis, an index into it), an op outside
the list, data-dependent control flow or indexing (make_fx raises on
``aten._local_scalar_dense``), an in-place op on a view or an input, and
D > 8, the reference kernel's own scope (``MAX_DIM``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import operator
import time
from typing import Callable, Optional

import numpy as np
import torch

from janus_tpu_torch.solve import common as cm

MAX_DIM = 8             # the reference kernel's scope: D up to ~8 in VMEM
_NAME = "@NAME@"        # replaced by the source hash in the emitted unit


class RefusedRhs(ValueError):
    """f cannot run in K4's generated route (the message says why)."""


def _fname(f) -> str:
    mod = getattr(f, "__module__", None) or ""
    name = getattr(f, "__qualname__", None) or type(f).__name__
    return f"{mod}.{name}" if mod else name


# ---- the per-lane program --------------------------------------------------

class _S:
    """A number operand of a node, in the dtype the op computes it in."""

    __slots__ = ("v", "dtype")

    def __init__(self, v, dtype):
        self.v, self.dtype = v, dtype

    def _key(self):
        v = self.v
        return (type(v).__name__, v.hex() if isinstance(v, float) else v,
                str(self.dtype))

    def __eq__(self, other):
        return isinstance(other, _S) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())


class _E:
    """One element of a traced tensor: its node and its lane (None for a
    value every lane shares)."""

    __slots__ = ("nid", "lane")

    def __init__(self, nid, lane):
        self.nid, self.lane = nid, lane


class _TV:
    """A traced tensor: an object array of _E in the tensor's shape, its
    dtype, and whether it is a CPU scalar (a number, or a 0-dim tensor of
    the closure), which PyTorch's CUDA kernels treat as a number."""

    __slots__ = ("arr", "dtype", "cpu_scalar")

    def __init__(self, arr, dtype, cpu_scalar=False):
        self.arr, self.dtype, self.cpu_scalar = arr, dtype, cpu_scalar


_C_TYPE = {torch.float64: "double", torch.float32: "float", torch.bool: "bool"}
# operations a node costs in the bound (+, -, *, /, sqrt, pow and each
# library function one each; negation, fabs, comparisons, selects,
# min/max and casts none)
_OPS = {"add": 1, "sub": 1, "mul": 1, "div": 1, "div_rcp": 1,
        "add_alpha": 2, "reciprocal": 1, "sqrt": 1, "rsqrt": 1, "exp": 1,
        "log": 1, "sin": 1, "cos": 1, "tanh": 1, "pow": 1,
        "tanh_backward": 3}
_POW_OPS = {0.5: 1, -0.5: 1, -1.0: 1, 2.0: 1, 3.0: 2, -2.0: 2}


@dataclasses.dataclass
class Program:
    """Nodes (op, args, dtype) in dependency order (args: node ids, _S
    numbers or None) and the output node ids: f's D values, or for the
    jvp's program its D primal values then its D tangents."""

    nodes: list
    outputs: list
    dim: int
    dual: bool

    def live(self):
        """Ids of the nodes the outputs depend on, in order."""
        need = set(self.outputs)
        for nid in range(len(self.nodes) - 1, -1, -1):
            if nid in need:
                need.update(a for a in self.nodes[nid][1]
                            if isinstance(a, int))
        return sorted(need)

    def op_count(self) -> int:
        n = 0
        for nid in self.live():
            op, args, _ = self.nodes[nid]
            if op == "pow_scalar":
                n += _POW_OPS.get(float(args[1].v), 1)
            else:
                n += _OPS.get(op, 0)
        return n

    def evaluate(self, t, y_rows, p_rows, dy_rows=None):
        """The program on [M] rows with the torch op of each node: f's D
        rows, or for the jvp's program (primal rows, tangent rows)."""
        like = y_rows[0]
        val = {}
        for nid in self.live():
            op, args, dtype = self.nodes[nid]
            a = [val[x] if isinstance(x, int) else
                 (x.v if isinstance(x, _S) else x) for x in args]
            if op == "in_t":
                r = t
            elif op == "in_y":
                r = y_rows[a[0]]
            elif op == "in_dy":
                r = dy_rows[a[0]]
            elif op == "in_p":
                r = p_rows[a[0]]
            elif op == "const":
                r = torch.full(like.shape, a[0], dtype=dtype,
                               device=like.device)
            elif op == "cast":
                r = a[0].to(dtype)
            else:
                r = _EVAL[op](*a)
            val[nid] = r
        out = [val[o] for o in self.outputs]
        if self.dual:
            return out[:self.dim], out[self.dim:]
        return out


def _sub_eval(a, b):
    # a number first is torch's rsub (c - x), as f's ``c - x`` runs
    return b.__rsub__(a) if not isinstance(a, torch.Tensor) else a - b


def _where_eval(c, a, b):
    return torch.where(c, a, b)


_EVAL = {
    "add": lambda a, b: torch.add(a, b),
    "add_alpha": lambda a, b, al: torch.add(a, b, alpha=al),
    "sub": _sub_eval,
    "mul": lambda a, b: torch.mul(a, b) if isinstance(a, torch.Tensor)
    else torch.mul(b, a),
    "div": torch.div,
    "div_rcp": torch.div,
    "neg": torch.neg,
    "reciprocal": torch.reciprocal,
    "exp": torch.exp, "log": torch.log, "sin": torch.sin, "cos": torch.cos,
    "tanh": torch.tanh, "sqrt": torch.sqrt, "rsqrt": torch.rsqrt,
    "abs": torch.abs, "sign": torch.sign,
    "pow_scalar": torch.pow, "pow": torch.pow,
    "maximum": torch.maximum, "minimum": torch.minimum,
    "clamp": lambda a, lo, hi: torch.clamp(a, lo, hi),
    "where": _where_eval,
    "gt": torch.gt, "ge": torch.ge, "lt": torch.lt, "le": torch.le,
    "eq": torch.eq, "ne": torch.ne,
    "logical_and": torch.logical_and, "logical_or": torch.logical_or,
    "logical_not": torch.logical_not,
    "tanh_backward": lambda g, y: torch.ops.aten.tanh_backward(g, y),
}


# ---- lowering the aten graph -----------------------------------------------

_VIEWS = {"select", "slice", "unbind", "split", "split_with_sizes", "view",
          "_unsafe_view", "reshape", "expand", "unsqueeze", "squeeze",
          "permute", "transpose", "t", "alias", "detach", "getitem"}
_BINARY = {"add", "sub", "mul", "div", "maximum", "minimum", "max", "min",
           "gt", "ge", "lt", "le", "eq", "ne", "logical_and", "logical_or",
           "rsub", "pow", "tanh_backward"}
_UNARY = {"neg": "neg", "exp": "exp", "log": "log", "sin": "sin",
          "cos": "cos", "tanh": "tanh", "sqrt": "sqrt", "rsqrt": "rsqrt",
          "abs": "abs", "reciprocal": "reciprocal", "sign": "sign",
          "sgn": "sign", "logical_not": "logical_not"}
_COMPARE = {"gt", "ge", "lt", "le", "eq", "ne"}
_IDENTITY = {"alias", "clone", "detach", "lift_fresh_copy", "contiguous",
             "lift_fresh", "positive"}
_CREATE = {"zeros", "ones", "full", "scalar_tensor"}


def _number_as(v, dtype):
    """v converted to dtype as PyTorch converts a number for a kernel."""
    if dtype is torch.bool:
        return bool(v)
    if dtype is torch.float32:
        return float(np.float32(v))
    if dtype is torch.float64:
        return float(v)
    raise TypeError(dtype)


class _Lowering:
    def __init__(self, fname, gm, m):
        self.fname, self.gm, self.m = fname, gm, m
        self.nodes, self.index = [], {}

    # -- nodes ---------------------------------------------------------------
    def refuse(self, what):
        return RefusedRhs(f"K4 cannot run f={self.fname} on the card: "
                          f"{what}")

    def node(self, op, args, dtype):
        key = (op, tuple(args), dtype)
        nid = self.index.get(key)
        if nid is None:
            nid = len(self.nodes)
            self.nodes.append(key)
            self.index[key] = nid
        return nid

    def const(self, v, dtype):
        return self.node("const", (_S(_number_as(v, dtype), dtype),), dtype)

    def cast(self, nid, dtype):
        op, args, have = self.nodes[nid]
        if have is dtype:
            return nid
        if op == "const":
            return self.const(args[0].v, dtype)
        return self.node("cast", (nid,), dtype)

    def const_tv(self, value, shape, dtype):
        arr = np.empty(tuple(shape), object)
        nid = self.const(value, dtype)
        for idx in np.ndindex(*arr.shape):
            arr[idx] = _E(nid, None)
        return _TV(arr, dtype)

    def tensor_tv(self, tensor, cpu_scalar=False):
        """A tensor constant of the trace (cpu_scalar: a CPU tensor of the
        closure, which PyTorch's CUDA kernels take as a number when it has
        no dimension)."""
        if tensor.dtype not in _C_TYPE and tensor.is_floating_point():
            raise self.refuse(f"a {tensor.dtype} tensor constant")
        vals = tensor.detach().cpu()
        dtype = tensor.dtype
        arr = np.empty(tuple(vals.shape), object)
        flat = vals.reshape(-1).tolist()
        for k, idx in enumerate(np.ndindex(*arr.shape)):
            v = flat[k]
            arr[idx] = _E(self.const(v, dtype if dtype in _C_TYPE
                                     else torch.float64), None)
        out_dtype = dtype if dtype in _C_TYPE else torch.float64
        return _TV(arr, out_dtype, cpu_scalar=cpu_scalar and vals.ndim == 0)

    # -- elementwise -----------------------------------------------------------
    def cast_tv(self, x, dtype):
        arr = np.empty(x.arr.shape, object)
        for idx in np.ndindex(*arr.shape):
            e = x.arr[idx]
            arr[idx] = _E(self.cast(e.nid, dtype), e.lane)
        return _TV(arr, dtype)

    def ew(self, opname, op, operands, out_dtype, compute):
        """op over operands (_TV, numbers or None) elementwise with
        broadcasting; compute: each operand's dtype in the op."""
        tvs = [o for o in operands if isinstance(o, _TV)]
        arrs = np.broadcast_arrays(*[t.arr for t in tvs])
        shape = arrs[0].shape
        out = np.empty(shape, object)
        for idx in np.ndindex(*shape):
            args, lane, k = [], None, 0
            for o, cdt in zip(operands, compute):
                if isinstance(o, _TV):
                    e = arrs[k][idx]
                    k += 1
                    if e.lane is not None:
                        if lane is not None and lane != e.lane:
                            raise self.refuse(
                                f"{opname} combines two lanes (K4 runs f "
                                "one lane a thread)")
                        lane = e.lane
                    args.append(self.cast(e.nid, cdt))
                elif o is None:
                    args.append(None)
                else:
                    args.append(_S(_number_as(o, cdt), cdt))
            out[idx] = _E(self.node(op, args, out_dtype), lane)
        return _TV(out, out_dtype)

    # -- the graph ---------------------------------------------------------------
    def run(self, inputs):
        graph = self.gm.graph
        live = _live(graph)
        env = {}
        placeholders = iter(inputs)
        result = None
        for node in graph.nodes:
            if node.op == "placeholder":
                env[node] = next(placeholders)
            elif node.op == "get_attr":
                const = getattr(self.gm, node.target)
                env[node] = self.tensor_tv(
                    const, cpu_scalar=const.device.type == "cpu")
            elif node.op == "call_function":
                if node not in live:
                    continue
                args = torch.fx.node.map_arg(node.args, lambda n: env[n])
                kwargs = torch.fx.node.map_arg(node.kwargs,
                                               lambda n: env[n])
                out = self.call(node, args, kwargs)
                env[node] = out
                name = _opname(node.target)
                if name.endswith("_") and not name.startswith("_"):
                    target = node.args[0]
                    src = target.target if target.op == "call_function" \
                        else None
                    if target.op != "call_function" or (
                            _opname(src) in _VIEWS):
                        raise self.refuse(
                            f"{_qual(node.target)} writes in place into an "
                            "input or a view")
                    env[target] = out
            elif node.op == "output":
                result = torch.fx.node.map_arg(node.args[0],
                                               lambda n: env[n])
        return result

    def call(self, node, args, kwargs):
        target = node.target
        if target is operator.getitem:
            return args[0][args[1]]
        name = _opname(target)
        qual = _qual(target)
        if not qual.startswith("aten."):
            raise self.refuse(f"{qual} is outside the lowered ops")
        meta = node.meta.get("val")
        out_dtype = getattr(meta, "dtype", None)
        base = name[:-1] if (name.endswith("_") and
                             not name.startswith("_")) else name
        if base in _CREATE:
            return self.created(node, args, kwargs)
        handler = getattr(self, "op_" + base, None)
        if handler is not None:
            return handler(node, args, kwargs, out_dtype)
        if base in _UNARY:
            x = args[0]
            cdt = torch.bool if base == "logical_not" else out_dtype
            return self.ew(qual, _UNARY[base], [x], out_dtype, [cdt])
        if base in _BINARY:
            return self.binary(qual, base, args, kwargs, out_dtype)
        raise self.refuse(f"{qual} is outside the lowered ops")

    # -- arithmetic ---------------------------------------------------------------
    def binary(self, qual, base, args, kwargs, out_dtype):
        a, b = args[0], args[1]
        alpha = kwargs.get("alpha", args[2] if len(args) > 2 else 1)
        if base in _COMPARE:
            cdt = _promote(a, b)
            return self.ew(qual, base, [a, b], torch.bool, [cdt, cdt])
        if base in ("logical_and", "logical_or"):
            return self.ew(qual, base, [a, b], torch.bool,
                           [torch.bool, torch.bool])
        d = [out_dtype, out_dtype]
        if base == "rsub":              # b - alpha * a
            a, b, base = b, a, "sub"
        if base in ("add", "sub"):
            if alpha != 1:
                return self.ew(qual, "add_alpha",
                               [a, b, alpha if base == "add" else -alpha],
                               out_dtype, d + [out_dtype])
            return self.ew(qual, base, [a, b], out_dtype, d)
        if base == "div":
            if kwargs.get("rounding_mode") is not None:
                raise self.refuse(f"{qual} with a rounding mode")
            if _is_cpu_scalar(b):
                return self.ew(qual, "div_rcp", [a, _scalar_of(b, self)],
                               out_dtype, d)
            return self.ew(qual, "div", [a, b], out_dtype, d)
        if base == "pow":
            if not isinstance(a, _TV):
                raise self.refuse(f"{qual} with a number base")
            if _is_cpu_scalar(b):
                e = _scalar_of(b, self)
                if e == 0:
                    return self.const_tv(1.0, a.arr.shape, out_dtype)
                if e == 1:
                    return self.cast_tv(a, out_dtype)
                return self.ew(qual, "pow_scalar", [a, e], out_dtype, d)
            return self.ew(qual, "pow", [a, b], out_dtype, d)
        if base in ("max", "min"):
            base = "maximum" if base == "max" else "minimum"
        return self.ew(qual, base, [a, b], out_dtype, d)

    def op_where(self, node, args, kwargs, out_dtype):
        c, a, b = args
        return self.ew("aten.where", "where", [c, a, b], out_dtype,
                       [torch.bool, out_dtype, out_dtype])

    def op_clamp(self, node, args, kwargs, out_dtype):
        lo = kwargs.get("min", args[1] if len(args) > 1 else None)
        hi = kwargs.get("max", args[2] if len(args) > 2 else None)
        if isinstance(lo, _TV) or isinstance(hi, _TV):
            raise self.refuse("aten.clamp with tensor bounds is outside the "
                              "lowered ops")
        return self.ew("aten.clamp", "clamp", [args[0], lo, hi], out_dtype,
                       [out_dtype] * 3)

    def op_clamp_min(self, node, args, kwargs, out_dtype):
        return self.op_clamp(node, (args[0], args[1], None), {}, out_dtype)

    def op_clamp_max(self, node, args, kwargs, out_dtype):
        return self.op_clamp(node, (args[0], None, args[1]), {}, out_dtype)

    def op__to_copy(self, node, args, kwargs, out_dtype):
        x = args[0]
        if not isinstance(x, _TV):      # a wrapped number: a CPU scalar
            tv = self.const_tv(x, (), out_dtype)
            tv.cpu_scalar = True
            return tv
        if x.dtype is out_dtype:
            return x
        if out_dtype not in _C_TYPE:
            raise self.refuse(f"aten._to_copy to {out_dtype}")
        return self.cast_tv(x, out_dtype)

    def op_sum(self, node, args, kwargs, out_dtype):
        x = args[0]
        nd = x.arr.ndim
        dims = args[1] if len(args) > 1 else kwargs.get("dim")
        keep = args[2] if len(args) > 2 else kwargs.get("keepdim", False)
        if dims is None or (isinstance(dims, (list, tuple)) and not dims):
            dims = list(range(nd))
        dims = sorted(d % nd for d in (dims if isinstance(dims, (list, tuple))
                                        else [dims]))
        rest = [d for d in range(nd) if d not in dims]
        arr = np.transpose(x.arr, rest + dims)
        outer = arr.shape[:len(rest)]
        arr = arr.reshape(outer + (-1,))
        acc = self.cast_tv(_TV(arr[..., 0], x.dtype), out_dtype)
        for k in range(1, arr.shape[-1]):
            acc = self.ew("aten.sum", "add", [acc, _TV(arr[..., k], x.dtype)],
                          out_dtype, [out_dtype, out_dtype])
        if keep:
            acc = _TV(acc.arr.reshape(tuple(1 if d in dims else x.arr.shape[d]
                                            for d in range(nd))), out_dtype)
        return acc

    # -- constants ---------------------------------------------------------------
    def _like(self, node, value, out_dtype):
        shape = tuple(node.meta["val"].shape)
        return self.const_tv(value, shape, out_dtype)

    def op_zeros_like(self, node, args, kwargs, out_dtype):
        return self._like(node, 0.0, out_dtype)

    def op_ones_like(self, node, args, kwargs, out_dtype):
        return self._like(node, 1.0, out_dtype)

    def op_full_like(self, node, args, kwargs, out_dtype):
        return self._like(node, _number(args[1], self), out_dtype)

    op__efficientzerotensor = op_zeros_like
    op_new_zeros = op_zeros_like
    op_new_ones = op_ones_like

    def op_new_full(self, node, args, kwargs, out_dtype):
        return self._like(node, _number(args[2], self), out_dtype)

    def created(self, node, args, kwargs):
        """A tensor made from numbers alone (zeros, ones, full,
        scalar_tensor): made here, on the CPU."""
        kwargs = {k: v for k, v in kwargs.items()
                  if k not in ("device", "pin_memory")}
        return self.tensor_tv(node.target(*args, **kwargs))

    # -- shapes ------------------------------------------------------------------
    def op_select(self, node, args, kwargs, out_dtype):
        x, dim, idx = args[0], args[1], args[2]
        return _TV(np.take(x.arr, idx, axis=dim), x.dtype, x.cpu_scalar)

    def op_slice(self, node, args, kwargs, out_dtype):
        x = args[0]
        dim = args[1] if len(args) > 1 else 0
        start = args[2] if len(args) > 2 else None
        end = args[3] if len(args) > 3 else None
        step = args[4] if len(args) > 4 else 1
        sl = [slice(None)] * x.arr.ndim
        sl[dim] = slice(start, end, step)
        return _TV(x.arr[tuple(sl)], x.dtype)

    def op_unbind(self, node, args, kwargs, out_dtype):
        x = args[0]
        dim = args[1] if len(args) > 1 else kwargs.get("dim", 0)
        return [_TV(np.take(x.arr, i, axis=dim), x.dtype)
                for i in range(x.arr.shape[dim])]

    def op_split(self, node, args, kwargs, out_dtype):
        x, size = args[0], args[1]
        dim = args[2] if len(args) > 2 else kwargs.get("dim", 0)
        n = x.arr.shape[dim]
        sizes = list(size) if isinstance(size, (list, tuple)) else \
            [min(size, n - s) for s in range(0, n, size)]
        cuts = np.cumsum(sizes)[:-1]
        return [_TV(a, x.dtype) for a in np.split(x.arr, cuts, axis=dim)]

    op_split_with_sizes = op_split

    def _reshape(self, x, shape):
        shape = list(shape)
        return _TV(x.arr.reshape(shape), x.dtype, x.cpu_scalar)

    def op_view(self, node, args, kwargs, out_dtype):
        return self._reshape(args[0], node.meta["val"].shape)

    op__unsafe_view = op_view
    op_reshape = op_view
    op_unsqueeze = op_view
    op_squeeze = op_view

    def op_expand(self, node, args, kwargs, out_dtype):
        x = args[0]
        return _TV(np.broadcast_to(x.arr, tuple(node.meta["val"].shape)),
                   x.dtype, x.cpu_scalar)

    def op_permute(self, node, args, kwargs, out_dtype):
        return _TV(np.transpose(args[0].arr, args[1]), args[0].dtype)

    def op_transpose(self, node, args, kwargs, out_dtype):
        return _TV(np.swapaxes(args[0].arr, args[1], args[2]), args[0].dtype)

    def op_t(self, node, args, kwargs, out_dtype):
        return _TV(args[0].arr.T, args[0].dtype)

    def _join(self, node, args, kwargs, out_dtype, fn):
        tensors = [t for t in args[0] if t.arr.size or t.arr.ndim > 1]
        dim = args[1] if len(args) > 1 else kwargs.get("dim", 0)
        tvs = []
        for t in tensors:
            tvs.append(self.cast_tv(t, out_dtype))
        return _TV(fn([t.arr for t in tvs], axis=dim), out_dtype)

    def op_stack(self, node, args, kwargs, out_dtype):
        return self._join(node, args, kwargs, out_dtype, np.stack)

    def op_cat(self, node, args, kwargs, out_dtype):
        return self._join(node, args, kwargs, out_dtype, np.concatenate)

    def _scatter_zeros(self, grad, sizes, index):
        out = self.const_tv(0.0, sizes, grad.dtype)
        arr = out.arr.copy()
        arr[index] = grad.arr
        return _TV(arr, grad.dtype)

    def op_select_backward(self, node, args, kwargs, out_dtype):
        grad, sizes, dim, idx = args
        sl = [slice(None)] * len(sizes)
        sl[dim] = idx
        return self._scatter_zeros(grad, sizes, tuple(sl))

    def op_slice_backward(self, node, args, kwargs, out_dtype):
        grad, sizes, dim, start, end, step = args
        sl = [slice(None)] * len(sizes)
        sl[dim] = slice(start, end, step)
        return self._scatter_zeros(grad, sizes, tuple(sl))


for _n in _IDENTITY:
    setattr(_Lowering, "op_" + _n,
            lambda self, node, args, kwargs, out_dtype: args[0])


def _opname(target) -> str:
    packet = getattr(target, "overloadpacket", None)
    if packet is not None:
        return packet.__name__
    return getattr(target, "__name__", str(target))


def _qual(target) -> str:
    if target is operator.getitem:
        return "getitem"
    name = getattr(target, "name", None)
    if callable(name):
        ns, _, rest = name().partition("::")
        return f"{ns}.{rest}"
    return str(target)


def _live(graph):
    """The call nodes the output depends on, and every in-place op whose
    target is among them."""
    live = set()
    out = next(n for n in reversed(graph.nodes) if n.op == "output")
    stack = list(out.all_input_nodes)
    while True:
        while stack:
            n = stack.pop()
            if n in live:
                continue
            live.add(n)
            stack.extend(n.all_input_nodes)
        for n in graph.nodes:
            if (n.op == "call_function" and n not in live and n.args
                    and isinstance(n.args[0], torch.fx.Node)
                    and n.args[0] in live):
                name = _opname(n.target)
                if name.endswith("_") and not name.startswith("_"):
                    stack.append(n)
        if not stack:
            return live


def _is_cpu_scalar(x):
    return not isinstance(x, _TV) or x.cpu_scalar


def _number(x, low):
    if isinstance(x, _TV):
        raise low.refuse("a tensor where a number is expected")
    return x


def _scalar_of(x, low):
    """The number a CPU scalar operand holds (a 0-dim closure tensor)."""
    if not isinstance(x, _TV):
        return x
    return low.nodes[x.arr.reshape(-1)[0].nid][1][0].v


def _promote(a, b):
    da = a.dtype if isinstance(a, _TV) else None
    db = b.dtype if isinstance(b, _TV) else None
    if da is None:
        return db
    if db is None or da is db:
        return da
    if a.cpu_scalar and not b.cpu_scalar:
        return db
    if b.cpu_scalar and not a.cpu_scalar:
        return da
    return torch.promote_types(da, db)


# ---- tracing ---------------------------------------------------------------

def _trace_lanes(dim: int) -> int:
    return 7 if dim == 5 else 5


def _columns(low, tv, m, dim, what):
    """Output node of each column of an [m, dim] traced result: every lane
    runs the same node, on its own lane's values."""
    if not isinstance(tv, _TV) or tv.arr.shape != (m, dim):
        shape = getattr(getattr(tv, "arr", None), "shape", None)
        raise low.refuse(f"{what} has shape {shape}, not [M, D] = "
                         f"[{m}, {dim}]")
    cols = []
    for i in range(dim):
        nid = tv.arr[0, i].nid
        for lane in range(m):
            e = tv.arr[lane, i]
            if e.lane not in (None, lane):
                raise low.refuse(f"{what}'s lane {lane} reads lane "
                                 f"{e.lane}'s values (K4 runs f one lane a "
                                 "thread)")
            if e.nid != nid:
                raise low.refuse(f"{what} computes column {i} differently "
                                 f"on lane {lane} than on lane 0")
        cols.append(nid)
    return cols


def trace_programs(f: Callable, args, dim: int, dtype, device="cpu"):
    """(value Program, jvp Program, number of parameter rows): f and its
    jvp traced as ``solve.radau_fused._step_ref`` calls them, on inputs on
    device (the solve's)."""
    from torch.fx.experimental.proxy_tensor import make_fx
    from torch.func import jvp

    fname = _fname(f)
    if dim > MAX_DIM:
        raise RefusedRhs(
            f"K4 cannot run f={fname} on the card: D={dim} > {MAX_DIM}, the "
            "scope of the fused kernel (the reference's: D up to ~8 in "
            "VMEM)")
    if dtype not in (torch.float32, torch.float64):
        raise RefusedRhs(f"K4 takes float32 or float64, not {dtype}")
    m = _trace_lanes(dim)
    # the rows and treedef of rf.arg_rows: one row a leaf (a zero row and no
    # args when there is none); the trace's rows are [NP, m]
    leaves, treedef = cm.tree_flatten(args)
    n_params = max(len(leaves), 1)
    treedef = treedef if leaves else None

    def args_of(r):
        return None if treedef is None else treedef(list(r))

    def value(t, y, r):
        return f(t, y, args_of(r))

    def dual(t, y, tang, r):
        a1 = args_of(r)
        return jvp(lambda yy: f(t, yy, a1), (y,), (tang,))

    gen = torch.Generator().manual_seed(0)
    t, y, r = (0.5 + torch.rand(shape, generator=gen, dtype=dtype)
               for shape in (m, (m, dim), (n_params, m)))
    tang = torch.zeros(m, dim, dtype=dtype)
    tang[:, 0] = 1.0
    t, y, r, tang = (x.to(device) for x in (t, y, r, tang))
    progs = []
    for kind, fn, inputs in (("f", value, (t, y, r)),
                             ("jvp of f", dual, (t, y, tang, r))):
        try:
            gm = make_fx(fn, tracing_mode="real")(*inputs)
        except RefusedRhs:
            raise
        except Exception as e:  # data-dependent control flow, or a tensor
            # of f on another device than the solve's
            raise RefusedRhs(
                f"K4 cannot run f={fname} on the card: make_fx could not "
                f"trace {kind} ({type(e).__name__}: "
                f"{str(e).splitlines()[0] if str(e) else ''})") from e
        low = _Lowering(fname, gm, m)
        ins = [_input(low, "in_t", (m,), dtype),
               _input(low, "in_y", (m, dim), dtype)]
        if kind != "f":
            ins.append(_input(low, "in_dy", (m, dim), dtype))
        ins.append(_input(low, "in_p", (n_params, m), dtype))
        out = low.run(ins)
        if kind == "f":
            outs = _columns(low, out, m, dim, "f")
        else:
            if not isinstance(out, (tuple, list)) or len(out) != 2:
                raise low.refuse("its jvp did not return (primal, tangent)")
            outs = (_columns(low, out[0], m, dim, "f")
                    + _columns(low, out[1], m, dim, "the jvp of f"))
        for o in outs:
            if low.nodes[o][2] is not dtype:
                raise low.refuse(f"it returns {low.nodes[o][2]} where the "
                                 f"state is {dtype}")
        progs.append(Program(low.nodes, outs, dim, kind != "f"))
    return progs[0], progs[1], n_params


def _input(low, op, shape, dtype):
    """The traced input of shape [m] (t), [m, D] (y, dy) or [NP, m] (p)."""
    arr = np.empty(shape, object)
    for idx in np.ndindex(*shape):
        if op == "in_t":
            nid, lane = low.node(op, (), dtype), idx[0]
        elif op == "in_p":
            nid, lane = low.node(op, (_S(idx[0], None),), dtype), idx[1]
        else:
            nid, lane = low.node(op, (_S(idx[1], None),), dtype), idx[0]
        arr[idx] = _E(nid, lane)
    return _TV(arr, dtype)


# ---- emitting the functor ---------------------------------------------------

def _lit(v, dtype) -> str:
    if dtype is torch.bool:
        return "true" if v else "false"
    v = float(v)
    if dtype is torch.float32:
        if not np.isfinite(v):
            bits = int(np.array(v, np.float32).view(np.uint32))
            return f"__int_as_float(0x{bits:08x})"
        return f"float({float(np.float32(v)).hex()})"
    if not np.isfinite(v):
        bits = int(np.array(v, np.float64).view(np.uint64))
        return f"__longlong_as_double(0x{bits:016x}LL)"
    return f"double({v.hex()})"


def _rcp(c, dtype):
    if dtype is torch.float32:
        return float(np.float32(1.0) / np.float32(c))
    return 1.0 / float(c)


def _emit_node(op, args, dtype, ref, dual):
    ct = _C_TYPE[dtype]

    def a(i):
        x = args[i]
        if isinstance(x, _S):
            return _lit(x.v, x.dtype)
        return ref(x)

    if op == "in_t":
        return "t"
    if op in ("in_y", "in_dy"):
        i = args[0].v
        if not dual:
            return f"y[{i}]"
        return f"y[{i}].{'v' if op == 'in_y' else 'd'}"
    if op == "in_p":
        return f"p[{args[0].v}]"
    if op == "const":
        return _lit(args[0].v, dtype)
    binop = {"add": "+", "sub": "-", "mul": "*", "div": "/", "gt": ">",
             "ge": ">=", "lt": "<", "le": "<=", "eq": "==", "ne": "!=",
             "logical_and": "&&", "logical_or": "||"}
    if op in binop:
        return f"{a(0)} {binop[op]} {a(1)}"
    if op == "div_rcp":
        c = args[1]
        return f"{a(0)} * {_lit(_rcp(c.v, c.dtype), c.dtype)}"
    if op == "add_alpha":
        return f"janus_add_alpha_fmad({a(0)}, {a(1)}, {a(2)})"
    if op == "neg":
        return f"-{a(0)}"
    if op == "reciprocal":
        return f"{ct}(1) / {a(0)}"
    if op == "sqrt":
        return f"::sqrt({a(0)})"
    if op == "abs":
        return f"::fabs({a(0)})"
    if op == "sign":
        return f"janus_sign({a(0)})"
    if op in ("exp", "log", "sin", "cos", "tanh", "rsqrt"):
        return f"janus_{op}_fmad({a(0)})"
    if op == "pow":
        return f"janus_pow_fmad({a(0)}, {a(1)})"
    if op == "pow_scalar":
        # PyTorch's pow_tensor_scalar_kernel (0 and 1 resolved earlier)
        e, x = float(args[1].v), a(0)
        special = {0.5: f"::sqrt({x})", -0.5: f"janus_rsqrt_fmad({x})",
                   -1.0: f"{ct}(1) / {x}", 2.0: f"{x} * {x}",
                   3.0: f"{x} * {x} * {x}", -2.0: f"{ct}(1) / ({x} * {x})"}
        return special.get(e, f"janus_pow_fmad({x}, {a(1)})")
    if op in ("maximum", "minimum"):
        return f"janus_{op}({a(0)}, {a(1)})"
    if op == "clamp":
        lo, hi = args[1], args[2]
        return (f"janus_clamp({a(0)}, {'true' if lo is not None else 'false'}"
                f", {_lit(lo.v, dtype) if lo is not None else ct + '(0)'}, "
                f"{'true' if hi is not None else 'false'}, "
                f"{_lit(hi.v, dtype) if hi is not None else ct + '(0)'})")
    if op == "where":
        return f"{a(0)} ? {a(1)} : {a(2)}"
    if op == "logical_not":
        return f"!{a(0)}"
    if op == "tanh_backward":
        return f"janus_tanh_backward_fmad({a(0)}, {a(1)})"
    if op == "cast":
        return f"static_cast<{ct}>({a(0)})"
    raise AssertionError(op)


def _emit_program(prog: Program, indent: str) -> list:
    lines = []
    for nid in prog.live():
        op, args, dtype = prog.nodes[nid]
        expr = _emit_node(op, args, dtype, lambda x: f"v{x}", prog.dual)
        lines.append(f"{indent}const {_C_TYPE[dtype]} v{nid} = {expr};")
    d = prog.dim
    for i in range(d):
        if prog.dual:
            lines.append(f"{indent}out[{i}] = S(v{prog.outputs[i]}, "
                         f"v{prog.outputs[d + i]});")
        else:
            lines.append(f"{indent}out[{i}] = v{prog.outputs[i]};")
    return lines


_UNIT = """\
// K4's right-hand side functor for {fname} (D = {dim}, {np} parameter
// row(s), {ct}), generated by janus_tpu_torch/ops/rhs_codegen.py from the
// aten graphs of f and of its torch.func.jvp; built by ops/_build.py.
// Each value is one element of one lane, each operation PyTorch's CUDA
// kernel of the traced op (rhs_ops.cuh, libm_fmad.cu).

#include <type_traits>

#include "radau5_step.cuh"
#include "rhs_ops.cuh"

namespace {{

struct GeneratedRhs {{
  static constexpr int D = {dim};
  static constexpr int NP = {np};
  template <typename T, typename S>
  __device__ static void f(T t, const S (&y)[D], const T* p, S (&out)[D]) {{
    static_assert(std::is_same<T, {ct}>::value, "traced in {ct}");
    if constexpr (std::is_same<S, T>::value) {{
{value}
    }} else {{
{dual}
    }}
  }}
}};

}}  // namespace

{geometry}
extern "C" {{

// K4 on the packed state [5D+15, M] with this functor (radau_fused.cu's
// janus_radau5_step without the problem name), given the launch geometry
// (ops/radau_fused.py:geometry; any other is refused).
int janus_radau5_step_{name}(void* state, const void* tf_row,
                             const void* params, int64_t m, int d,
                             int n_params, int dtype,
                             const JanusRadauConsts* consts,
                             int max_attempts, int threads_per_lane,
                             int lanes_per_block, int64_t smem_bytes,
                             void* stream) {{
  if (d != GeneratedRhs::D || n_params != GeneratedRhs::NP || dtype != {code})
    return (int)cudaErrorInvalidValue;
  return (int){launch}(
      state, tf_row, params, m, *consts, max_attempts, threads_per_lane,
      lanes_per_block, smem_bytes, static_cast<cudaStream_t>(stream));
}}

int janus_radau5_attributes_{name}(int* out) {{
  return {attributes}(out);
}}

// f [D, M] and the Jacobian [D*D, M] at t [M], y [D, M], params [NP, M].
int janus_rhs_eval_{name}(const void* t, const void* y, const void* params,
                          void* f_out, void* jac, int64_t m, void* stream) {{
  return (int)rhs_eval<{ct}, GeneratedRhs>(
      t, y, params, f_out, jac, m, static_cast<cudaStream_t>(stream));
}}

}}  // extern "C"
"""


def geometry_decl(geo) -> str:
    """The line of a unit that compiles the group layout's geometry in."""
    return (f"using Geo = GroupGeometry<{geo.threads_per_lane}, "
            f"{geo.lanes_per_block}, {geo.blocks_per_sm}, "
            f"{geo.scratch_per_lane}>;\n")


def emit_source(fname, value: Program, dual: Program, n_params, dtype):
    """The translation unit, with ``@NAME@`` where the hash goes; K4's
    layout is ``ops.radau_fused.geometry``'s for (D, dtype)."""
    from janus_tpu_torch.ops.radau_fused import geometry
    from janus_tpu_torch.ops.smalllu import _DTYPE_CODE
    ct = _C_TYPE[dtype]
    geo = geometry(value.dim, dtype)
    if geo.threads_per_lane > 1:
        geo_line = ("// K4's group layout (ops/radau_fused.py:geometry)\n"
                    + geometry_decl(geo))
        launch = f"launch_group<{ct}, GeneratedRhs, Geo>"
        attributes = f"group_attributes<{ct}, GeneratedRhs, Geo>"
    else:
        geo_line = ""
        launch = f"launch_lanes<{ct}, GeneratedRhs>"
        attributes = f"attributes_t<{ct}, GeneratedRhs>"
    # the comment names f without an address; a lambda is "<lambda>"
    return _UNIT.format(
        fname=fname.replace("\n", " "), dim=value.dim, np=n_params,
        ct=ct, code=_DTYPE_CODE[dtype], name=_NAME, geometry=geo_line,
        launch=launch, attributes=attributes,
        value="\n".join(_emit_program(value, " " * 6)),
        dual="\n".join(_emit_program(dual, " " * 6)))


# ---- the unit ---------------------------------------------------------------

_LIBS = {}              # unit name -> loaded ctypes library


@dataclasses.dataclass
class Unit:
    """One generated functor: its programs, its source and its library."""

    name: str
    fname: str
    dim: int
    n_params: int
    dtype: torch.dtype
    value: Program
    dual: Program
    source: str
    trace_seconds: Optional[float] = None
    build_seconds: Optional[float] = None

    def f_ops(self):
        """(operations of one f, of one Jacobian column by the jvp)."""
        return self.value.op_count(), self.dual.op_count()

    def build(self) -> float:
        """Compile the unit if its library is not cached; the seconds it
        took (0.0 when cached)."""
        from janus_tpu_torch.ops import _build
        t0 = time.perf_counter()
        fresh = not _build.unit_library_path(self.name).exists()
        _build.build_unit(self.name, self.source)
        self.build_seconds = time.perf_counter() - t0 if fresh else 0.0
        return self.build_seconds

    def library(self):
        lib = _LIBS.get(self.name)
        if lib is None:
            from janus_tpu_torch.ops import _build
            lib = ctypes.CDLL(str(_build.build_unit(self.name, self.source)))
            vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            step = getattr(lib, f"janus_radau5_step_{self.name}")
            step.argtypes = [vp, vp, vp, i64, i32, i32, i32, vp, i32, i32,
                             i32, i64, vp]
            step.restype = i32
            attrs = getattr(lib, f"janus_radau5_attributes_{self.name}")
            attrs.argtypes = [vp]
            attrs.restype = i32
            ev = getattr(lib, f"janus_rhs_eval_{self.name}")
            ev.argtypes = [vp, vp, vp, vp, vp, i64, vp]
            ev.restype = i32
            _LIBS[self.name] = lib
        return lib

    def ptxas_log(self) -> str:
        from janus_tpu_torch.ops import _build
        return _build.build_unit(self.name, self.source).with_suffix(
            ".ptxas.txt").read_text()

    def eval_on_card(self, t, y_t, rows):
        """(f [D, M], Jacobian [D*D, M]) by the functor on the card at t
        [M], y_t [D, M], rows [NP, M] (CUDA tensors of the unit's dtype);
        a check of the functor against f, not a step of the solve."""
        from janus_tpu_torch.ops.smalllu import _raise_on
        m = y_t.shape[1]
        f_out = torch.empty_like(y_t)
        jac = y_t.new_empty((self.dim * self.dim, m))
        ins = [x.contiguous() for x in (t, y_t, rows)]
        with torch.cuda.device(y_t.device):
            rc = getattr(self.library(), f"janus_rhs_eval_{self.name}")(
                ins[0].data_ptr(), ins[1].data_ptr(), ins[2].data_ptr(),
                f_out.data_ptr(), jac.data_ptr(), m,
                torch.cuda.current_stream().cuda_stream)
        _raise_on(rc, "janus_rhs_eval")
        return f_out, jac


def lower(f: Callable, args, dim: int, dtype, device="cpu") -> Unit:
    """Trace f (and its jvp) with args at D = dim in dtype on device and
    write its unit (built and loaded at first use); the unit keeps the
    seconds this took."""
    from janus_tpu_torch.ops import _build
    t0 = time.perf_counter()
    value, dual, n_params = trace_programs(f, args, dim, dtype, device)
    fname = _fname(f)
    source = emit_source(fname, value, dual, n_params, dtype)
    name = _build.unit_hash(source)
    return Unit(name, fname, dim, n_params, dtype, value, dual,
                source.replace(_NAME, name),
                trace_seconds=time.perf_counter() - t0)


def jacobian(prog: Program, t, y_rows, p_rows):
    """The jvp program's D Jacobian columns with one-hot tangents:
    [D][D] rows, entry [i][j] = df_i/dy_j."""
    d = prog.dim
    cols = []
    for j in range(d):
        dy = [torch.full_like(y_rows[0], 1.0 if i == j else 0.0)
              for i in range(d)]
        cols.append(prog.evaluate(t, y_rows, p_rows, dy)[1])
    return [[cols[j][i] for j in range(d)] for i in range(d)]
