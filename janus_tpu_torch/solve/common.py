"""Shared machinery for the lockstep masked solvers (the subset radau,
rodas and dopri need).

The whole batch advances in one Python loop and every per-trajectory
decision is a ``torch.where`` select. The device is the one ``y0`` lies on;
a ``y0`` that is not a tensor goes to the CUDA card unless the caller asks
for another device (``broadcast_batch``). Nothing here moves a tensor to
another device.
"""

from __future__ import annotations

import contextvars
import dataclasses
import functools
import math
from contextlib import contextmanager
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

    def interpolate(self, ts):
        """Dense-output evaluation after the solve (scipy's ``sol.sol(t)``).

        Needs the accepted-step mesh (``solve_ivp(..., dense=N)`` with N ≥
        the step count). ts: [T] shared query times or [M, T] per lane.
        Returns [M, T, D]: each lane's collocation polynomial evaluated on
        its OWN step containing the query (θ-powers of the stored
        coefficients: solve order everywhere, not Hermite). Queries are
        clamped to the lane's integrated span; lanes whose step count
        overflowed the mesh capacity return NaN (never silently wrong
        values).

        The step is picked by index: a ``searchsorted`` over the lane's step
        starts, then moved by at most one step by the membership tests in
        multiplication form ((tq−t_k)·h_k ≥ 0 and (tq−t_k−h_k)·h_k < 0, valid
        for either sign of h), so a query on a step boundary lands where the
        sum t_k + h_k was rounded to. Peak memory O(M·T·D).
        """
        if not self.mesh or "q" not in self.mesh:
            raise ValueError("interpolate() needs the stored step mesh: "
                             "solve with dense=N (method='radau')")
        tm, hm = self.mesh["t"], self.mesh["h"]        # [M, N]
        ym, qm = self.mesh["y"], self.mesh["q"]        # [M, N, D], [M,N,s,D]
        m, n = tm.shape
        nacc = self.stats["naccept"].to(torch.int64)   # [M]
        ts = like(ts, tm)
        if ts.ndim == 1:
            ts = ts[None, :].expand(m, ts.shape[0])
        last = (torch.clamp(nacc, max=n) - 1).clamp(min=0)[:, None]  # [M,1]
        # clamp to the integrated span (signed h: reverse time works)
        t_stop = torch.where(nacc[:, None] > 0,
                             (tm + hm).gather(1, last), 0.0)
        lo = torch.minimum(tm[:, :1], t_stop)
        hi = torch.maximum(tm[:, :1], t_stop)
        tq = torch.minimum(torch.maximum(ts, lo), hi)  # [M, T]
        # step starts as increasing keys; slots past the lane's mesh are +inf
        sgn = torch.where(hm[:, :1] < 0, -1.0, 1.0)
        slot = torch.arange(n, device=tm.device)[None, :]
        keys = torch.where(slot < nacc[:, None], sgn * tm, torch.inf)
        idx = torch.searchsorted(keys, (sgn * tq).contiguous(), right=True) - 1
        idx = torch.minimum(idx.clamp(min=0), last)

        def at(k):
            num = tq - tm.gather(1, k)
            return num, hm.gather(1, k)

        num, hk = at(idx)
        idx = torch.where(((num - hk) * hk >= 0.0) & (idx < last), idx + 1,
                          torch.where((num * hk < 0.0) & (idx > 0), idx - 1,
                                      idx))
        num, hk = at(idx)
        theta = num / torch.where(hk == 0.0, 1.0, hk)  # [M, T]
        s, dim = qm.shape[2], qm.shape[3]
        yk = ym.gather(1, idx[:, :, None].expand(-1, -1, dim))
        qk = qm.gather(1, idx[:, :, None, None].expand(-1, -1, s, dim))
        thp = torch.stack([theta ** (p + 1) for p in range(s)], dim=-1)
        out = yk + lane_einsum("mtp,mtpd->mtd", thp, qk)
        return torch.where((nacc > n)[:, None, None], torch.nan, out)


def canon_cost(v):
    """A running-cost integrand's output in canonical form: [M] -> [M, 1],
    [M, Q] unchanged (shared by solve_radau(quad=) and
    radau_adjoint(cost=), so that the two agree on the contract)."""
    return v[:, None] if v.ndim == 1 else v


def dense_window(t_eval, t_old, h, accept, s):
    """Which t_eval points an accepted step (t_old, t_old + h] covers, and
    where: (inside [M, T] bool, θ-powers [M, T, s] with θ ∈ [0, 1] the
    point's place in the step, power q+1 at index q)."""
    inside, theta = _dense_inside(t_eval, t_old, h, accept)
    tpow = torch.stack([theta ** (q + 1) for q in range(s)], dim=-1)
    return inside, tpow


def _dense_inside(t_eval, t_old, h, accept):
    t_new = t_old + h
    # direction-aware window membership
    lo = torch.minimum(t_old, t_new)[:, None]
    hi = torch.maximum(t_old, t_new)[:, None]
    tg = t_eval[None, :]
    inside = (tg > lo) & (tg <= hi) | ((tg >= lo) & (tg < hi)
                                       & (h < 0)[:, None] & (tg == lo))
    theta = torch.clamp((tg - t_old[:, None]) / h[:, None], 0.0, 1.0)
    return inside & accept[:, None], theta


def collect_dense(out_ys, t_eval, t_old, h, accept, interp):
    """out_ys [M, T, D] with every t_eval point inside the accepted step
    (t_old, t_old + h] set to the step's continuous extension there;
    interp(θ [M, T]) -> [M, T, D] with θ ∈ [0, 1]."""
    inside, theta = _dense_inside(t_eval, t_old, h, accept)
    return torch.where(inside[..., None], interp(theta), out_ys)


def mask_dense_after_event(out_ys, t_eval, fired, t_event, h):
    """NaN for the t_eval samples strictly past a terminal event time t* in
    the direction of the march (scipy truncates t_eval at t*; with fixed
    shapes the samples turn NaN). ``fired`` [M] flags the lanes whose
    terminal event fired THIS step, whose dense pass filled the whole step
    window; no later step runs for them. A sample at exactly t* keeps
    y(t*). out_ys [..., M, T, D] (a leading tangent axis is allowed)."""
    tg = t_eval[None, :]
    past = torch.where((h >= 0)[:, None], tg > t_event[:, None],
                       tg < t_event[:, None])
    return torch.where((past & fired[:, None])[..., None], torch.nan, out_ys)


_S35 = 0.6 ** 0.5
GL3_NODES = (0.5 * (1 - _S35), 0.5, 0.5 * (1 + _S35))
GL3_WEIGHTS = (5.0 / 18.0, 8.0 / 18.0, 5.0 / 18.0)


def gl3_increment(ql, t_old, h, interp, theta_q):
    """One step's running-cost increment ∫ l dt over [t_old, t_old +
    θ_q·h] by 3-point Gauss-Legendre on the step's interpolant (exact to
    degree 5). ql(t [M], y [M, D]) -> [M, Q]; interp(θ [M, 3]) ->
    [M, 3, D]; theta_q [M]. The forward accumulation (``quad_gl3_step``)
    and the discrete adjoints' replays call this one function, so a replay
    reproduces the forward increment to the bit."""
    xi = torch.tensor(GL3_NODES, dtype=t_old.dtype, device=t_old.device)
    w = torch.tensor(GL3_WEIGHTS, dtype=t_old.dtype, device=t_old.device)
    nodes = theta_q[:, None] * xi[None, :]                     # [M, 3]
    yq = interp(nodes)                                         # [M, 3, D]
    tq = t_old[:, None] + nodes * h[:, None]
    lv = torch.stack([ql(tq[:, i], yq[:, i]) for i in range(3)],
                     dim=1)                                    # [M, 3, Q]
    return (h * theta_q)[:, None] * torch.sum(w[None, :, None] * lv, dim=1)


def quad_gl3_step(ql, t_old, h, interp, accept, terminate, t_ev, q_acc):
    """q_acc [M, Q] plus the accepted steps' GL-3 increments; lanes whose
    terminal event fired this step integrate only to θ* = (t*−t_old)/h."""
    theta_q = torch.where(
        terminate, torch.clamp((t_ev - t_old) / torch.where(h == 0.0, 1.0, h),
                               0.0, 1.0), 1.0)
    inc = gl3_increment(ql, t_old, h, interp, theta_q)
    return torch.where(accept[:, None], q_acc + inc, q_acc)


def ring_write(rings, slot, mask, values):
    """rings[k][i, slot[i]] = values[k][i] on the lanes where mask holds and
    slot[i] is inside the ring; in place, by index (gather, select, scatter:
    no host sync, and a lane's slot is unique, so the write is
    deterministic). rings[k] is [M, N, ...], values[k] [M, ...]."""
    n = next(iter(rings.values())).shape[1]
    at = torch.clamp(slot, max=n - 1).to(torch.int64)
    write = mask & (slot < n)
    for key, ring in rings.items():
        val = values[key].unsqueeze(1)                 # [M, 1, ...]
        index = at.reshape((-1,) + (1,) * (val.ndim - 1)).expand_as(val)
        keep = write.reshape((-1,) + (1,) * (val.ndim - 1))
        ring.scatter_(1, index, torch.where(keep, val, ring.gather(1, index)))


class _SafeSqrt(torch.autograd.Function):
    """sqrt with a zero derivative at x == 0 (the reference's custom_jvp,
    ``janus_tpu/solve/common.py:139-163``).

    Solver error and correction norms are EXACTLY zero on locally
    polynomial dynamics, and d(√u) = du/(2√u) is 0/0 there: one NaN
    tangent poisons every sensitivity carried through the solve (forward
    mode through any method on ẏ = const). The step controller is not
    differentiable at a zero norm anyway, and the zero subgradient is the
    reference's choice. The forward is ``torch.sqrt`` itself, so a NaN norm
    stays NaN and fails its step. ``jvp`` serves ``torch.func.jvp`` and
    forward AD; ``backward`` is the same rule transposed (reverse mode and
    ``torch.func.vjp``); vmap's rule is generated."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return torch.sqrt(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(output)
        ctx.save_for_forward(output)

    @staticmethod
    def _slope(root, dx):
        pos = root > 0
        return torch.where(pos, dx / (2.0 * torch.where(pos, root, 1.0)),
                           torch.zeros_like(dx))

    @staticmethod
    def jvp(ctx, dx):
        (root,) = ctx.saved_tensors
        return _SafeSqrt._slope(root, dx)

    @staticmethod
    def backward(ctx, grad):
        (root,) = ctx.saved_tensors
        return _SafeSqrt._slope(root, grad)


def safe_sqrt(x):
    """sqrt of a norm, with a zero derivative at 0 (``_SafeSqrt``)."""
    return _SafeSqrt.apply(x)


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


def make_slab_selector(step_args, y0):
    """Per-accepted-step parameter slabs (``step_args=``): every leaf of the
    tree shares leading axis S. Returns (S, slab_at) where ``slab_at(nacc
    [M])`` picks each lane's own row nacc (clamped to S−1: an exhausted
    lane stays finite and is failed by the caller) by a gather. A leaf
    whose second axis equals the batch size M is a per-lane table [S, M,
    ...]. Leaves are cast to y0's dtype on y0's device."""
    m = y0.shape[0]
    slabs = tree_map(lambda a: like(a, y0), step_args)
    leaves = tree_leaves(slabs)
    n_slabs = leaves[0].shape[0]
    if any(leaf.shape[0] != n_slabs for leaf in leaves):
        raise ValueError("step_args leaves must share leading axis S")
    lanes = torch.arange(m, device=y0.device)

    def slab_at(nacc):
        row = torch.clamp(nacc, 0, n_slabs - 1).to(torch.int64)

        def pick(leaf):
            if leaf.ndim >= 2 and leaf.shape[1] == m:
                return leaf[row, lanes]
            return leaf.index_select(0, row)

        return tree_map(pick, slabs)

    return n_slabs, slab_at


def zero_stats(m: int, names, device) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros((m,), dtype=torch.int32, device=device)
            for k in names}


def tree_map(fn, tree, *rest, is_leaf=None):
    """fn over the leaves of a tree of dicts, lists and tuples (None stays).
    With more trees of tree's structure, fn(leaf, *their leaves there).
    ``is_leaf(x)`` true makes x a leaf (a Jet, say) where it would be
    looked into."""
    if tree is None:
        return None
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest),
                                   is_leaf=is_leaf)
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree, is_leaf=None):
    out = []
    tree_map(out.append, tree, is_leaf=is_leaf)
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


def default_device(device=None) -> torch.device:
    """The device an array that is not a torch tensor goes to: ``device``
    when given, else the CUDA card. With no card and no device asked for
    this raises; it never picks the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise ValueError(
            "no CUDA device: pass y0 as a CPU tensor, or device='cpu', to "
            "solve on the CPU")
    return torch.device("cuda")


def on_device(x, device=None) -> torch.Tensor:
    """x as a tensor: a torch tensor stays on its device (a different
    ``device`` asked for is refused, never copied to); anything else goes
    to ``default_device(device)``. A device with no index ("cuda") is any
    device of its type."""
    if isinstance(x, torch.Tensor):
        want = torch.device(device) if device is not None else None
        if want is not None and (
                want.type != x.device.type
                or want.index not in (None, x.device.index)):
            raise ValueError(f"tensor on {x.device}, device={device!r} "
                             "asked for (it is not copied)")
        return x
    return torch.as_tensor(x, device=default_device(device))


def broadcast_batch(t0, tf, y0, device=None):
    """Normalize (t0, tf, y0) to batched [M]/[M]/[M,D] tensors on y0's
    device (``on_device``: a y0 that is not a tensor goes to the card)."""
    y0 = on_device(y0, device)
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


# The process group whose ranks read every host gate of a solve together
# (``parallel.lockstep``); None: a process reads its own lanes' gates.
LOCKSTEP = contextvars.ContextVar("janus_tpu_torch_lockstep", default=None)


@contextmanager
def lockstep_group(group):
    """Inside, every host gate is read over ``group``'s ranks (None: each
    process its own lanes)."""
    token = LOCKSTEP.set(group)
    try:
        yield
    finally:
        LOCKSTEP.reset(token)


def keeps_lockstep(backward):
    """An autograd Function's backward, run under the lockstep group its
    forward ran under (``ctx.lockstep``, which the forward sets from
    ``LOCKSTEP``): the engine runs a CUDA backward on a thread of its own,
    where the caller's context variables are not set, so that a sweep
    there would read its gates on each rank alone."""
    @functools.wraps(backward)
    def run(ctx, *grads):
        with lockstep_group(ctx.lockstep):
            return backward(ctx, *grads)
    return run


class _HostSyncs:
    """Counts the host syncs of one solve (each ``bool(t.any())`` is one).

    Inside ``parallel.lockstep`` each read is the maximum over the ranks of
    the process group (one ``all_reduce``), as XLA's gates of a sharded
    while_loop are global: every rank then runs the loop trips the
    one-process solve runs, and a lane's result does not depend on how the
    batch was split. A loop that updates every lane until the last lane
    converges (the IND tangent sweep, the adjoint's stage iteration) needs
    that, and a rank that left a loop early would leave the others waiting
    in a read it never makes.

    Every family's forward loop reads through this object (radau, radaup,
    radau_fused, rodas, grk4t, bdf2, dopri5/853, NDF/BDF, SEULEX, and the
    events' gate), and so do the backward sweeps of ``radau_adjoint`` and of
    the discrete adjoints (``solve.discrete.live_slots``) and the control
    layer's batched loops (``host_any``). ``control.krylov.gmres`` (one
    unbatched system, whose gates are scalars of that system) refuses to
    run inside ``parallel.lockstep`` itself.
    """

    reads = 0      # every read of every solve in this process

    def __init__(self):
        self.count = 0
        self.group = LOCKSTEP.get()

    def read_max(self, vals):
        """vals (a 1-D integer tensor) on the host in one sync, as a list,
        each entry the maximum over the lockstep group's ranks (a mask's
        entry so is the OR)."""
        self.count += 1
        _HostSyncs.reads += 1
        if self.group is not None:
            import torch.distributed as dist
            # NCCL reduces on the card; gloo on the host
            on = vals.device if dist.get_backend(self.group) == "nccl" \
                else "cpu"
            vals = vals.to(on, torch.int64)
            dist.all_reduce(vals, op=dist.ReduceOp.MAX, group=self.group)
        return vals.tolist()

    def any(self, mask) -> bool:
        return bool(self.read_max(mask.any().reshape(1))[0])

    def any_each(self, *masks):
        """(any(m) for m in masks) read in ONE host sync."""
        return [bool(v) for v in
                self.read_max(torch.stack([mask.any() for mask in masks]))]

    def max_int(self, x) -> int:
        """max of an integer tensor, read in one host sync."""
        return self.read_max(x.max().reshape(1))[0]


def host_any(mask) -> bool:
    """``bool(mask.any())``, the gate of a batched host loop outside a
    solve (the control layer's Newton, Ψtc, homotopy, Anderson and GMRES
    loops): inside ``parallel.lockstep`` the OR over every rank's lanes,
    so that no rank leaves its loop while another's next solve waits in a
    read."""
    return _HostSyncs().any(mask)


# ATen's bound (multiply-adds of one product) below which torch.einsum on the
# CPU adds in its own loop rather than calling MKL
ATEN_SMALL = 400


def lane_einsum(eq: str, *ops):
    """``torch.einsum(eq, *ops)`` in a form whose result on each lane does
    not depend on how the batch is split over the ranks of
    ``parallel.lockstep``. The lanes are the index ``m`` (or the ellipsis).
    A BLAS picks its kernel, and with it the order of the adds, by the size
    of the problem: on an H100 cuBLAS parted a 32,768-lane half of the
    headline from the 65,536-lane solve in the Newton's stage transform by
    2.7e-20, so on a CUDA tensor this is one broadcast product and one sum,
    whatever the batch. On the CPU ``torch.einsum`` adds each lane's terms
    in sequence, plainly in ATen's loop below ``ATEN_SMALL`` multiply-adds
    and by MKL's fused multiply-adds above (a product of per-lane matrices,
    where every operand carries an output index, counts one lane's work):
    outside ``lockstep`` this is ``torch.einsum``, whose rounding the parity
    tests hold; inside, the same sums in the order ``torch.einsum`` takes
    for the whole batch over every rank, so that "s,msd->md", "msd,sq->mqd"
    or "ij,mjd->mid" do not round by the shard's lane count (a ulp at 64
    against 128 lanes). That CPU order is ATen's and MKL's as of torch
    2.13.0 (MKL 2024.2, AVX-512), the version the tests check it on.

    ``eq`` must name its lanes ``m`` or ``...``: a lane index of another
    letter would be counted as a shard's, and the ranks would part by an
    ulp, so such an equation raises ``ValueError``."""
    if "m" not in eq and "..." not in eq:
        raise ValueError(f"lane_einsum({eq!r}): name the lane index 'm' or "
                         "'...'")
    if any(t.is_cuda for t in ops):
        return broadcast_einsum(eq, *ops)
    group = LOCKSTEP.get()
    ins, out = _spell_ellipsis(eq, ops)
    if group is None or set(out).intersection(*map(set, ins)):
        return torch.einsum(eq, *ops)
    sizes = {c: n for spec, t in zip(ins, ops) for c, n in zip(spec, t.shape)}
    lane = {c: c == "m" or c.isupper() for c in sizes}
    whole = torch.tensor([math.prod(n for c, n in sizes.items() if lane[c])],
                         dtype=torch.int64)
    import torch.distributed as dist
    dist.all_reduce(whole, group=group)
    work = int(whole) * math.prod(n for c, n in sizes.items() if not lane[c])
    return broadcast_einsum(eq, *ops,
                            order="plain" if work < ATEN_SMALL else "fma")


def _spell_ellipsis(eq: str, ops):
    """eq with each ``...`` spelled out in capital letters (right-aligned
    over the operands' leading dimensions, as einsum broadcasts them):
    (the inputs' index strings, the output's)."""
    ins, out = eq.replace(" ", "").split("->")
    ins = ins.split(",")
    if "..." not in eq:
        return ins, out
    free = [c for c in "ABCDEFGHIJKLMNOPQRSTUVWXYZ" if c not in eq]
    n_ell = [t.ndim - (len(spec) - 3) if "..." in spec else 0
             for spec, t in zip(ins, ops)]
    ell = "".join(free[:max(n_ell)])
    ins = [spec.replace("...", ell[len(ell) - n:])
           for spec, n in zip(ins, n_ell)]
    return ins, out.replace("...", ell)


def broadcast_einsum(eq: str, *ops, order: str = "sum"):
    """``torch.einsum(eq, *ops)`` as a broadcast product of the operands,
    the output's indices first, reduced over the rest: by ``torch.sum``
    (``order="sum"``), or term after term in the order of the contracted
    indices, each added after its product is rounded (``"plain"``) or by a
    fused multiply-add of the last operand (``"fma"``, ``torch.addcmul``)."""
    ins, out = _spell_ellipsis(eq, ops)
    letters = list(out) + [c for c in dict.fromkeys("".join(ins))
                           if c not in out]
    views = []
    for spec, t in zip(ins, ops):
        t = t.permute(sorted(range(len(spec)),
                             key=lambda k: letters.index(spec[k])))
        for pos, c in enumerate(letters):
            if c not in spec:
                t = t.unsqueeze(pos)
        views.append(t)
    n_out = len(out)
    if n_out == len(letters) or order == "sum":
        prod = functools.reduce(torch.mul, views)
        return prod.sum(dim=tuple(range(n_out, len(letters)))) \
            if n_out < len(letters) else prod
    head = functools.reduce(torch.mul, views[:-1]) if len(views) > 1 \
        else torch.ones((1,) * len(letters), dtype=views[0].dtype,
                        device=views[0].device)
    last = views[-1]
    full = torch.broadcast_shapes(head.shape, last.shape)[n_out:]
    head, last = (x.expand(x.shape[:n_out] + full).reshape(
        x.shape[:n_out] + (-1,)) for x in (head, last))
    acc = head[..., 0] * last[..., 0]
    for i in range(1, last.shape[-1]):
        acc = torch.addcmul(acc, head[..., i], last[..., i]) \
            if order == "fma" else acc + head[..., i] * last[..., i]
    return acc
