"""Jet: batched first-order dual numbers carrying N forward sensitivities, as
``janus_tpu.jet.core``, on torch tensors.

Layout
------
``Jet(r, d)`` with ``r.shape == S`` (any shape, typically ``[M, D]`` for a
batch of M trajectories of state dim D) and ``d.shape == (N, *S)``: the
sensitivity axis is LEADING, so every tangent column is an ordinary
``torch.func.jvp`` tangent and generic lifting is a ``torch.func.vmap``
over axis 0 of ``d``.

Semantics: a Jet represents the family ``x(ε) = r + Σ_n ε_n d[n]`` to first
order. Every op propagates d by the chain rule. Comparisons act on ``r``
only (branching on sensitivities is meaningless). A tensor or a number on
the left of ``+ − × ÷ @`` reaches the Jet's reflected operator (torch's
binary operators give way to an operand type they do not know).

Jets are plain objects, not registered with any pytree library: tree walks
of the port that meet them take ``is_leaf=is_jet`` (``solve.common.tree_map``).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from janus_tpu_torch.solve.common import on_device, tree_map


def is_jet(x: Any) -> bool:
    return isinstance(x, Jet)


class Jet:
    """First-order jet (dual number with N tangent directions)."""

    __slots__ = ("r", "d")

    def __init__(self, r, d):
        self.r = r
        self.d = d

    # -- basic introspection ---------------------------------------------
    @property
    def shape(self):
        return tuple(self.r.shape)

    @property
    def dtype(self):
        return self.r.dtype

    @property
    def device(self):
        return self.r.device

    @property
    def ndim(self):
        return self.r.ndim

    @property
    def nsens(self) -> int:
        """Number of sensitivity directions N."""
        return self.d.shape[0]

    def __repr__(self):
        return f"Jet(r={self.r!r}, d.shape={tuple(self.d.shape)})"

    # -- construction helpers --------------------------------------------
    def zeros_like(self) -> "Jet":
        return Jet(torch.zeros_like(self.r), torch.zeros_like(self.d))

    def ones_like(self) -> "Jet":
        return Jet(torch.ones_like(self.r), torch.zeros_like(self.d))

    def const_like(self, value) -> "Jet":
        r = torch.as_tensor(value, dtype=self.dtype, device=self.device)
        return Jet(r.broadcast_to(self.r.shape), torch.zeros_like(self.d))

    # -- binary arithmetic -------------------------------------------------
    @staticmethod
    def _split(other):
        """(r_other, d_other or None): a non-Jet is a constant."""
        if is_jet(other):
            return other.r, other.d
        return other, None

    def __add__(self, o):
        ro, do = self._split(o)
        r = self.r + ro
        d = self.d if do is None else self.d + do
        return Jet(r, _bcast_d(d, r.shape))

    __radd__ = __add__

    def __sub__(self, o):
        ro, do = self._split(o)
        r = self.r - ro
        d = self.d if do is None else self.d - do
        return Jet(r, _bcast_d(d, r.shape))

    def __rsub__(self, o):
        r = o - self.r
        return Jet(r, _bcast_d(-self.d, r.shape))

    def __mul__(self, o):
        ro, do = self._split(o)
        r = self.r * ro
        d = self.d * ro if do is None else self.d * ro + do * self.r
        return Jet(r, _bcast_d(d, r.shape))

    __rmul__ = __mul__

    def __truediv__(self, o):
        ro, do = self._split(o)
        inv = 1.0 / ro
        r = self.r * inv
        if do is None:
            d = self.d * inv
        else:
            d = (self.d - do * (self.r * inv)) * inv
        return Jet(r, _bcast_d(d, r.shape))

    def __rtruediv__(self, o):
        r = o / self.r
        return Jet(r, _bcast_d(-self.d * (r / self.r), r.shape))

    def __pow__(self, e):
        if is_jet(e):
            return lift(torch.pow, self, e)
        r = self.r ** e
        return Jet(r, _bcast_d(self.d * (e * self.r ** (e - 1)), r.shape))

    def __neg__(self):
        return Jet(-self.r, -self.d)

    def __abs__(self):
        return Jet(torch.abs(self.r), self.d * torch.sign(self.r))

    def __matmul__(self, o):
        return matmul(self, o)

    def __rmatmul__(self, o):
        return matmul(o, self)

    # -- comparisons (on the primal part) ----------------------------------
    def __lt__(self, o):
        return self.r < (o.r if is_jet(o) else o)

    def __le__(self, o):
        return self.r <= (o.r if is_jet(o) else o)

    def __gt__(self, o):
        return self.r > (o.r if is_jet(o) else o)

    def __ge__(self, o):
        return self.r >= (o.r if is_jet(o) else o)

    def __eq__(self, o):  # noqa: D105
        return self.r == (o.r if is_jet(o) else o)

    def __ne__(self, o):
        return self.r != (o.r if is_jet(o) else o)

    __hash__ = None

    # -- elementwise math --------------------------------------------------
    def _unary(self, fr: Callable, dfr: Callable) -> "Jet":
        return Jet(fr(self.r), self.d * dfr(self.r))

    def sqrt(self):
        r = torch.sqrt(self.r)
        return Jet(r, self.d * (0.5 / r))

    def square(self):
        return Jet(torch.square(self.r), self.d * (2.0 * self.r))

    def reciprocal(self):
        inv = 1.0 / self.r
        return Jet(inv, self.d * (-inv * inv))

    def exp(self):
        r = torch.exp(self.r)
        return Jet(r, self.d * r)

    def log(self):
        return self._unary(torch.log, lambda x: 1.0 / x)

    def sin(self):
        return self._unary(torch.sin, torch.cos)

    def cos(self):
        return self._unary(torch.cos, lambda x: -torch.sin(x))

    def tanh(self):
        return self._unary(torch.tanh, lambda x: 1.0 - torch.tanh(x) ** 2)

    def abs(self):
        return abs(self)

    # -- shaping -----------------------------------------------------------
    def __getitem__(self, idx):
        didx = (slice(None),) + (idx if isinstance(idx, tuple) else (idx,))
        return Jet(self.r[idx], self.d[didx])

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        n = self.d.shape[0]
        return Jet(self.r.reshape(shape), self.d.reshape((n,) + tuple(shape)))

    def sum(self, axis=None, keepdims=False):
        return jet_sum(self, axis=axis, keepdims=keepdims)


def _bcast_d(d, rshape):
    """Broadcast a tangent stack to (N, *rshape)."""
    return d.broadcast_to((d.shape[0],) + tuple(rshape))


# -- constructors -----------------------------------------------------------

def jet(r, d, device=None) -> Jet:
    """A Jet from primal ``r`` and tangent stack ``d`` of shape
    (N, *r.shape). Tensors keep their device; anything else goes to
    ``device``, by default the CUDA card."""
    r = on_device(r, device)
    d = on_device(d, device)
    if tuple(d.shape[1:]) != tuple(r.shape):
        raise ValueError(f"tangent shape {tuple(d.shape)} incompatible with "
                         f"primal {tuple(r.shape)}")
    return Jet(r, d)


def const(r, n: int, device=None) -> Jet:
    """A Jet with zero sensitivities (constant w.r.t. all N directions)."""
    r = on_device(r, device)
    return Jet(r, torch.zeros((n,) + tuple(r.shape), dtype=r.dtype,
                              device=r.device))


def seed_identity(y, extra: int = 0, device=None) -> Jet:
    """Identity sensitivities over the LAST axis of ``y``.

    For ``y: [M, D]`` a Jet with N = D + extra, where d[j, :, i] = δ_ij for
    j < D and zero for the ``extra`` trailing directions (parameter and
    final-time columns)."""
    y = on_device(y, device)
    dim = y.shape[-1]
    n = dim + extra
    eye = torch.eye(n, dim, dtype=y.dtype, device=y.device)      # [N, D]
    d = eye.reshape((n,) + (1,) * (y.ndim - 1) + (dim,)).expand(
        (n,) + tuple(y.shape))
    return Jet(y, d)


# -- generic lift -----------------------------------------------------------

def _push(g, primals, tangents):
    """(g(*primals), its N tangents): ``torch.func.vmap`` over the leading
    axis of each tangent stack of ``torch.func.jvp``. The primal is
    unbatched under the vmap, so it is computed once."""
    return torch.func.vmap(lambda *t: torch.func.jvp(g, primals, t),
                           out_dims=(None, 0))(*tangents)


def lift(f: Callable, *args, **kwargs):
    """Apply any ``torch.func``-traceable ``f`` to a mix of Jets and
    constants: the primal once and the N tangents batched, by
    ``torch.func.vmap`` over ``torch.func.jvp`` (the reference's
    ``jax.linearize`` + ``vmap(lin)``; ``torch.func.linearize`` traces f
    with make_fx into a graph first, which costs more for a single use and
    refuses f with data-dependent control flow)."""
    jet_pos = [i for i, a in enumerate(args) if is_jet(a)]
    if not jet_pos:
        return f(*args, **kwargs)

    def g(*jet_primals):
        full = list(args)
        for i, jp in zip(jet_pos, jet_primals):
            full[i] = jp
        return f(*full, **kwargs)

    out_r, out_d = _push(g, tuple(args[i].r for i in jet_pos),
                         tuple(args[i].d for i in jet_pos))
    return tree_map(Jet, out_r, out_d)


def jvp_call(f: Callable, x: Jet, *const_args):
    """``f(x, *const_args)`` lifted over a single Jet argument."""
    out_r, out_d = _push(lambda xr: f(xr, *const_args), (x.r,), (x.d,))
    return Jet(out_r, out_d)


# -- structured ops ---------------------------------------------------------

def _as_jet(x, ref: Jet) -> Jet:
    """x as a Jet with ref's N; a non-tensor takes ref's dtype and
    device."""
    if is_jet(x):
        return x
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x, dtype=ref.dtype, device=ref.device)
    return Jet(x, x.new_zeros((ref.nsens,) + tuple(x.shape)))


def _first_jet(*xs) -> Jet:
    return next(x for x in xs if is_jet(x))


def _expand_d(j: Jet, shape):
    """j's tangent stack broadcast to (N, *shape) as j.r broadcasts to
    shape (the trailing axes align)."""
    lead = (1,) * (len(shape) - j.r.ndim)
    return j.d.reshape((j.nsens,) + lead + tuple(j.r.shape)).expand(
        (j.nsens,) + tuple(shape))


def where(cond, a, b) -> Jet:
    """Elementwise select; cond is a boolean tensor (a primal-level mask)."""
    cond = cond.r if is_jet(cond) else cond
    ref = _first_jet(a, b)
    a, b = _as_jet(a, ref), _as_jet(b, ref)
    r = torch.where(cond, a.r, b.r)
    return Jet(r, torch.where(cond[None], _expand_d(a, r.shape),
                              _expand_d(b, r.shape)))


def concatenate(jets, axis=0) -> Jet:
    ref = _first_jet(*jets)
    jets = [_as_jet(j, ref) for j in jets]
    daxis = axis if axis < 0 else axis + 1
    return Jet(torch.cat([j.r for j in jets], dim=axis),
               torch.cat([j.d for j in jets], dim=daxis))


def stack(jets, axis=0) -> Jet:
    ref = _first_jet(*jets)
    jets = [_as_jet(j, ref) for j in jets]
    daxis = axis if axis < 0 else axis + 1
    return Jet(torch.stack([j.r for j in jets], dim=axis),
               torch.stack([j.d for j in jets], dim=daxis))


def matmul(a, b) -> Jet:
    """Product-rule matmul. TF32 is off for the package
    (``janus_tpu_torch/__init__.py``), the role of the reference's
    ``Precision.HIGHEST``."""
    if is_jet(a) and is_jet(b):
        return Jet(torch.matmul(a.r, b.r),
                   torch.einsum("n...ij,...jk->n...ik", a.d, b.r)
                   + torch.einsum("...ij,n...jk->n...ik", a.r, b.d))
    if is_jet(a):
        return Jet(torch.matmul(a.r, b),
                   torch.einsum("n...ij,...jk->n...ik", a.d, b))
    return Jet(torch.matmul(a, b.r),
               torch.einsum("...ij,n...jk->n...ik", a, b.d))


def einsum(spec: str, *operands):
    """Einsum with product-rule tangents: one term per Jet operand, its
    tangent axis ``z`` prefixed to its spec and to the output's."""
    jets = [i for i, o in enumerate(operands) if is_jet(o)]
    if not jets:
        return torch.einsum(spec, *operands)
    if "->" not in spec:
        raise ValueError("jet einsum requires explicit '->' output spec")
    rs = [o.r if is_jet(o) else o for o in operands]
    r = torch.einsum(spec, *rs)
    ins, out = spec.split("->")
    in_specs = ins.split(",")
    d = None
    for i in jets:
        ops = list(rs)
        ops[i] = operands[i].d
        sp = ",".join(("z" + s) if k == i else s
                      for k, s in enumerate(in_specs)) + "->z" + out
        term = torch.einsum(sp, *ops)
        d = term if d is None else d + term
    return Jet(r, d)


def jet_sum(x: Jet, axis=None, keepdims=False) -> Jet:
    if axis is None:
        dims = tuple(range(1, x.d.ndim))
        r = torch.sum(x.r)
        d = torch.sum(x.d, dim=dims) if dims else x.d
        if keepdims:
            r = r.reshape((1,) * x.r.ndim)
            d = d.reshape((x.nsens,) + (1,) * x.r.ndim)
        return Jet(r, d)
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    daxes = tuple(a + 1 if a >= 0 else a for a in axes)
    return Jet(torch.sum(x.r, dim=axes, keepdim=keepdims),
               torch.sum(x.d, dim=daxes, keepdim=keepdims))


sum = jet_sum  # module-level alias mirroring torch.sum


def max_dual(x: Jet, axis=-1, keepdims=False) -> Jet:
    """Max over an axis; the tangents follow the argmax (the first one on
    a tie)."""
    return _extremum(x, axis, keepdims, torch.argmax)


def min_dual(x: Jet, axis=-1, keepdims=False) -> Jet:
    return _extremum(x, axis, keepdims, torch.argmin)


def _extremum(x: Jet, axis, keepdims, argfn):
    idx = argfn(x.r, dim=axis, keepdim=True)
    r = torch.take_along_dim(x.r, idx, dim=axis)
    daxis = axis + 1 if axis >= 0 else axis
    didx = idx[None].expand((x.nsens,) + tuple(idx.shape))
    d = torch.take_along_dim(x.d, didx, dim=daxis)
    if not keepdims:
        r = r.squeeze(axis)
        d = d.squeeze(daxis)
    return Jet(r, d)


def maximum(a, b) -> Jet:
    return where(a >= b, a, b)      # a Jet compares on its primal


def minimum(a, b) -> Jet:
    return where(a <= b, a, b)

