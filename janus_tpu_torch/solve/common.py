"""Shared machinery for the lockstep masked solvers (the subset radau needs).

The whole batch advances in one Python loop and every per-trajectory
decision is a ``torch.where`` select. The device is the one ``y0`` lies on;
nothing here moves a tensor to another device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

# Status codes (per trajectory), as in janus_tpu.solve.common
RUNNING = 0
SUCCESS = 1
MAX_STEPS = 2
STEP_UNDERFLOW = 3
NEWTON_STALL = 4      # repeated Newton failure / singular iteration matrix
EVENT_TERMINATED = 5
PARAMS_EXHAUSTED = 6  # step_args= slab rows ran out before the lane reached tf


@dataclasses.dataclass
class Solution:
    """Batched solve result (everything has leading batch axis M)."""

    t: torch.Tensor            # [M] final time reached
    y: torch.Tensor            # [M, D] final state
    status: torch.Tensor       # [M] int8, see codes above
    stats: Dict[str, torch.Tensor]   # per-trajectory int32 counters
    ts: Optional[torch.Tensor] = None
    ys: Optional[torch.Tensor] = None
    event_t: Optional[torch.Tensor] = None
    event_y: Optional[torch.Tensor] = None
    event_idx: Optional[torch.Tensor] = None
    dyn: Optional[Dict[str, torch.Tensor]] = None
    sens: Optional[torch.Tensor] = None   # [K, M, D] IND tangents
    mesh: Optional[Dict[str, torch.Tensor]] = None
    sens_ys: Optional[torch.Tensor] = None
    h_next: Optional[torch.Tensor] = None  # [M] signed step proposal at the end
    quad: Optional[torch.Tensor] = None
    sens_quad: Optional[torch.Tensor] = None
    sens_t: Optional[torch.Tensor] = None

    @property
    def success(self):
        return self.status == SUCCESS


def safe_sqrt(x):
    """sqrt of a norm. The reference defines a zero tangent at 0 for AD
    through the solve; nothing differentiates through the port's solve, so
    the plain sqrt is the same function here."""
    return torch.sqrt(x)


def rms_norm(v, scale):
    return safe_sqrt(torch.mean(torch.square(v / scale), dim=-1))


def error_norm(err, y0, y1, rtol, atol):
    """Scaled RMS norm per trajectory (Hairer's err measure)."""
    sc = atol + rtol * torch.maximum(torch.abs(y0), torch.abs(y1))
    return safe_sqrt(torch.mean(torch.square(err / sc), dim=-1))


def initial_step(f, t0, y0, f0, tf, order: int, rtol, atol, args, max_step):
    """Hairer's automatic initial step size (hinit), batched over M.
    Returns a SIGNED h (negative for reverse-time integration)."""
    direction = torch.sign(tf - t0)
    direction = torch.where(direction == 0, 1.0, direction)
    sc = atol + rtol * torch.abs(y0)
    d0 = rms_norm(y0, sc)
    d1 = rms_norm(f0, sc)
    small = (d0 < 1e-5) | (d1 < 1e-5)
    h0 = torch.where(small, 1e-6, 0.01 * d0 / torch.where(d1 == 0, 1.0, d1))
    h0 = torch.minimum(h0, torch.abs(tf - t0))
    y1 = y0 + (h0 * direction)[..., None] * f0
    f1 = f(t0 + h0 * direction, y1, args)
    d2 = rms_norm(f1 - f0, sc) / h0
    dm = torch.maximum(d1, d2)
    h1 = torch.where(dm <= 1e-15,
                     torch.clamp(h0 * 1e-3, min=1e-6),
                     (0.01 / dm) ** (1.0 / (order + 1.0)))
    h = torch.minimum(torch.minimum(100.0 * h0, h1),
                      torch.clamp(torch.abs(tf - t0), max=max_step))
    return h * direction


def zero_stats(m: int, names, device) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros((m,), dtype=torch.int32, device=device)
            for k in names}


def tree_map(fn, tree):
    """fn over the leaves of a tree of dicts, lists and tuples (None stays)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


def tree_flatten(tree):
    """(leaves, unflatten): unflatten(new_leaves) rebuilds tree's structure
    with new_leaves in the order of ``tree_leaves`` (insertion order of
    dicts, where the reference sorts keys; a flatten and its unflatten
    agree, which is all the callers need)."""
    leaves = tree_leaves(tree)

    def unflatten(new_leaves):
        it = iter(new_leaves)
        return tree_map(lambda _: next(it), tree)

    return leaves, unflatten


def like(x, ref):
    """x as a tensor of ref's dtype on ref's device. A tensor already on
    another device is refused, never copied."""
    if isinstance(x, torch.Tensor):
        if x.device != ref.device:
            raise ValueError(f"tensor on {x.device}, expected {ref.device} "
                             "(the device is taken from y0)")
        return x.to(ref.dtype)
    return torch.as_tensor(x, dtype=ref.dtype, device=ref.device)


def broadcast_batch(t0, tf, y0):
    """Normalize (t0, tf, y0) to batched [M]/[M]/[M,D] tensors on y0's device."""
    y0 = torch.as_tensor(y0)
    if y0.ndim < 2:
        y0 = y0.reshape(1, -1)
    m = y0.shape[0]
    t0 = like(t0, y0).broadcast_to((m,))
    tf = like(tf, y0).broadcast_to((m,))
    return t0, tf, y0


def derived_newton_tol(dtype, rtol):
    """Hairer's FNewt with an upper cap: max(10*eps/rtol, sqrt(rtol)) capped
    at 0.03 (the cap matters in f32 at rtol <= 1e-5)."""
    return float(min(0.03, max(10 * float(torch.finfo(dtype).eps) / rtol,
                               rtol ** 0.5)))


def index_weights(opts, dim, dtype, device):
    """Hairer's higher-index DAE weighting: index-2/3 components get error and
    Newton norms scaled by h / h² — returns (exponent vector [D], flag).
    Components must be ordered [index-1 | index-2 | index-3]."""
    ind_exp = torch.zeros(dim, dtype=dtype, device=device)
    if opts.nind2 or opts.nind3:
        n1 = opts.nind1 if opts.nind1 else dim - opts.nind2 - opts.nind3
        ind_exp[n1:n1 + opts.nind2] = 1.0
        ind_exp[n1 + opts.nind2:n1 + opts.nind2 + opts.nind3] = 2.0
    return ind_exp, bool(opts.nind2 or opts.nind3)


def two_sum(a, b):
    """Error-free transform: a + b = s + err exactly (Knuth TwoSum). Eager
    torch keeps IEEE semantics (no reassociation)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def comp_add(hi, lo, x):
    """Double-word accumulate: (hi, lo) + x -> renormalized (hi', lo'); the
    state accumulation of the compensated mode (Options.compensated)."""
    s, e = two_sum(hi, x)
    lo2 = lo + e
    hi2 = s + lo2
    lo3 = lo2 - (hi2 - s)
    return hi2, lo3
