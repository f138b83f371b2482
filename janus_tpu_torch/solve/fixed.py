"""Fixed-grid integrators: the reverse-differentiable path by plain
backpropagation.

The port of ``janus_tpu/solve/fixed.py``. Fixed-step rk4 and midpoint over
a Python loop that ``torch.autograd`` differentiates through (the
reference's ``lax.scan``), with each step recomputed in the backward pass
under ``remat=True`` (``_RematStep``, the reference's ``jax.checkpoint``),
so the graph keeps one state per step. Per-step parameter slabs
(piecewise-constant controls) come in through ``step_args``. No kernel:
plain torch.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

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
    recomputed in the backward pass; under a ``torch.func`` transform
    (``grad``, ``vjp``), whose wrapped tensors an ``autograd.Function``
    without a functorch rule refuses, the step keeps its stages."""
    leaves = [x for x in cm.tree_leaves(trees) if isinstance(x, torch.Tensor)]
    if any(torch._C._functorch.is_functorch_wrapped_tensor(x)
           for x in leaves):
        return False
    return torch.is_grad_enabled() and any(x.requires_grad for x in leaves)


class _RematStep(torch.autograd.Function):
    """One step y -> stepper(f, t, y, h, fa) that keeps only its inputs: the
    forward runs the step without a graph, the backward runs it again under
    autograd and pulls the cotangent through it with
    ``torch.autograd.grad``. Inputs: the step (a function of y and the
    leaves), then y and the leaves of (t, h, fa) that require grad. Unlike
    ``torch.utils.checkpoint`` it installs no saved-tensor hooks, which
    ``torch.func`` refuses (an f built on ``torch.func.grad``, as
    ``ham``'s dynamics are), and unlike a reentrant checkpoint it takes
    ``torch.autograd.grad`` as well as ``.backward()``."""

    @staticmethod
    def forward(ctx, run, y, *leaves):
        ctx.run = run
        ctx.lockstep = cm.LOCKSTEP.get()
        ctx.save_for_backward(y, *leaves)
        with torch.no_grad():
            return run(y, leaves)

    @staticmethod
    @cm.keeps_lockstep
    def backward(ctx, ybar):
        create = torch.is_grad_enabled()
        y, *leaves = ctx.saved_tensors
        ins = [x.detach().requires_grad_(need) for x, need in
               zip([y, *leaves], ctx.needs_input_grad[1:])]
        with torch.enable_grad():
            out = ctx.run(ins[0], ins[1:])
        wrt = [x for x in ins if x.requires_grad]
        grads = iter(torch.autograd.grad(out, wrt, ybar, allow_unused=True,
                                         create_graph=create))
        return (None, *(next(grads) if x.requires_grad else None
                        for x in ins))


def _remat_step(stepper, f, t, y, h, fa):
    """stepper(f, t, y, h, fa) through ``_RematStep``, with the tensors of
    (t, h, fa) that require grad as its differentiable inputs."""
    leaves, unflatten = cm.tree_flatten((t, h, fa))
    grad_at = [i for i, x in enumerate(leaves)
               if isinstance(x, torch.Tensor) and x.requires_grad]

    def run(yy, diff):
        new = list(leaves)
        for i, x in zip(grad_at, diff):
            new[i] = x
        tt, hh, ffa = unflatten(new)
        return stepper(f, tt, yy, hh, ffa)

    return _RematStep.apply(run, y, *(leaves[i] for i in grad_at))


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
            y = _remat_step(stepper, f, t, y, h, fa)
        else:
            y = stepper(f, t, y, h, fa)
        if save_trajectory:
            traj.append(y)
    if save_trajectory:
        return y, torch.stack(traj)
    return y
