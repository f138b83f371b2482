"""Fixed-grid integrators: the reverse-differentiable path by plain
backpropagation.

The port of ``janus_tpu/solve/fixed.py``. Fixed-step rk4 and midpoint over
a Python loop that ``torch.autograd`` differentiates through (the
reference's ``lax.scan``), with each step recomputed in the backward pass
under ``remat=True`` (``torch.utils.checkpoint``, non-reentrant: the
reference's ``jax.checkpoint``), so the graph keeps one state per step.
Per-step parameter slabs (piecewise-constant controls) come in through
``step_args``. No kernel: plain torch.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from janus_tpu_torch.solve import common as cm


def _rk4_step(f, t, y, h, args):
    k1 = f(t, y, args)
    k2 = f(t + 0.5 * h, y + 0.5 * h[..., None] * k1, args)
    k3 = f(t + 0.5 * h, y + 0.5 * h[..., None] * k2, args)
    k4 = f(t + h, y + h[..., None] * k3, args)
    return y + (h[..., None] / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


def _midpoint_step(f, t, y, h, args):
    k1 = f(t, y, args)
    return y + h[..., None] * f(t + 0.5 * h, y + 0.5 * h[..., None] * k1,
                                args)


_STEPPERS = {"rk4": _rk4_step, "midpoint": _midpoint_step}


def _records(*trees) -> bool:
    """Whether autograd records a step on these inputs. Only then is a step
    checkpointed: the checkpoint's saved-tensor hooks refuse an f built on
    ``torch.func`` (``ham``'s dynamics), which needs none of it otherwise."""
    return torch.is_grad_enabled() and any(
        isinstance(x, torch.Tensor) and x.requires_grad
        for x in cm.tree_leaves(trees))


def odeint_fixed(f: Callable, t0, tf, y0, n_steps: int, args: Any = None,
                 method: str = "rk4", step_args: Optional[Any] = None,
                 remat: bool = True, save_trajectory: bool = False,
                 device=None):
    """Integrate on a fixed grid of ``n_steps`` steps; reverse-differentiable
    by ``torch.autograd`` in y0, t0, tf and every tensor in args and
    step_args that requires grad.

    f: batched rhs ``f(t [M], y [M, D], args)``; t0, tf: scalars or [M];
    y0: [M, D] or [D] (a torch y0 keeps its device, anything else goes to
    ``device``, by default the CUDA card). step_args: optional tree of
    tensors with leading axis ``n_steps``, sliced per step and passed to f
    as ``(args, slab_k)``. remat: recompute each step in the backward pass
    instead of keeping its stages (when autograd records the step: y, t0,
    tf, args or step_args require grad). save_trajectory: also return ys
    [n_steps + 1, M, D].

    Returns y_final [M, D] (and the trajectory if asked for).
    """
    stepper = _STEPPERS[method]
    y0 = cm.on_device(y0, device)
    if y0.ndim < 2:
        y0 = y0.reshape(1, -1)
    m = y0.shape[0]
    t0 = cm.like(t0, y0).broadcast_to((m,))
    tf = cm.like(tf, y0).broadcast_to((m,))
    h = (tf - t0) / n_steps
    y, traj = y0, [y0]
    for k in range(n_steps):
        t = t0 + h * float(k)
        fa = args if step_args is None else \
            (args, cm.tree_map(lambda a, _k=k: a[_k], step_args))
        if remat and _records(y, t, h, fa):
            y = checkpoint(lambda yy, _t=t, _fa=fa: stepper(f, _t, yy, h,
                                                            _fa),
                           y, use_reentrant=False)
        else:
            y = stepper(f, t, y, h, fa)
        if save_trajectory:
            traj.append(y)
    if save_trajectory:
        return y, torch.stack(traj)
    return y
