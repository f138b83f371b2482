"""Hessian-vector products through the adaptive Radau solve
(forward-over-adjoint).

The port of ``janus_tpu/solve/hvp.py``. For L(y0, θ) = loss(y(T; y0, θ), θ)
[+ ∫ cost dt], ``radau_hvp`` computes H·v = ∇²L·(v_y0, v_θ) as the gradient
of the directional derivative L̇ = ∇L·v:

1. the direction's first-order response δ' = f_y·δ + f_θ·v_θ, δ(0) = v_y0,
   is appended to the state, Y = [y, δ], Y' = (f, its ``torch.func.jvp``
   along (δ, v_θ)): the augmented Jacobian is block lower-triangular
   [[J, 0], [∂(Jδ), J]], so the controller's mesh serves both halves;
2. L̇ = ⟨∇_y loss(y_T, θ), δ_T⟩ + ⟨∇_θ loss, v_θ⟩ is a scalar function of
   the augmented terminal state, and one ``radau_adjoint`` backward sweep
   on the augmented system gives the whole (y0, θ) Hessian-vector product.
   That sweep pulls a ``torch.func.vjp`` through the jvp inside f.

A running cost l gets its tangent integrand l̇ = l_y·δ + l_θ·v_θ stacked
into one [M, 2Q] quadrature, and loss sees (y_T, q, θ). The augmented
forward solve is a Radau solve of dimension 2D: with
``Options(kernel_lu=True)`` its stage factor and solves go through K1/K2
(the backward sweep runs the plain LU, as ``radau_adjoint`` does).

Accuracy contract: central differences OF THE ADJOINT GRADIENT to O(rtol).
Full Hessians: loop over the directions, or stack them along the lane axis
(one solve; ``torch.func.vmap`` cannot pass a solver that makes host
syncs). Size ``Options.adjoint_steps`` for the worst direction.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.func import jvp

from janus_tpu_torch.solve import common as cm
from janus_tpu_torch.solve.adjoint import _split_diff, radau_adjoint
from janus_tpu_torch.solve.options import Options


def _aug_mass(mass, dim):
    """blockdiag(M, M) for the augmented [y, δ] state."""
    if mass is None:
        return None
    z = mass.new_zeros(mass.shape[:-2] + (dim, dim))
    return torch.cat([torch.cat([mass, z], dim=-1),
                      torch.cat([z, mass], dim=-1)], dim=-2)


def _leaves_with_none(tree):
    """The leaves of a tree of dicts, lists and tuples, None leaves kept (a
    None direction is a zero direction)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves_with_none(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves_with_none(v)]
    return [tree]


def radau_hvp(f: Callable, tspan, y0, args=None, *, loss: Callable,
              v_y0=None, v_args=None, options: Optional[Options] = None,
              mass=None, cost: Optional[Callable] = None,
              checkpoints: int = 0, device=None):
    """Hessian-vector product of a terminal (+ integral) objective through
    the batched adaptive Radau solve.

    f: ``f(t [M], y [M, D], args) -> [M, D]``; tspan (t0, tf) scalars; y0
    [M, D] (a y0 that is not a tensor goes to ``device``, by default the
    CUDA card); args: a tree whose floating-point tensor leaves are
    differentiated. loss: ``loss(yT [M, D], args) -> scalar``, or with
    ``cost`` ``loss(yT, q, args)`` with q = ∫ cost dt ([M] or [M, Q]).
    v_y0 [M, D] and v_args (args' tree, or its floating leaves; None leaves
    are zero): the direction, zero by default. cost: optional running
    integrand ``l(t, y, args) -> [M] | [M, Q]``. checkpoints: passed to
    ``radau_adjoint``.

    Returns ``((h_y0, h_args), gdotv)``: h_y0 [M, D] = ∇²_{y0}L·v_y0 +
    ∇_{y0}∇_θL·v_θ, h_args a tree like args (None on the leaves that are
    not differentiated), and the directional derivative gdotv = ∇L·v, which
    must equal ⟨∇L, v⟩ of the plain ``radau_adjoint`` gradient.
    """
    opts = options if options is not None else Options()
    y0 = cm.on_device(y0, device)
    if y0.ndim != 2:
        raise ValueError("radau_hvp expects batched y0 [M, D]")
    if mass is not None:
        mass = cm.like(mass, y0)
        if bool((mass.abs().sum(dim=-1) == 0.0).any()):
            raise ValueError(
                "radau_hvp does not support singular (DAE) mass matrices; "
                "first-order DAE gradients are radau_adjoint(n_alg=...)")
    m, dim = y0.shape
    v_y0 = torch.zeros_like(y0) if v_y0 is None else \
        cm.like(v_y0, y0).broadcast_to(y0.shape)

    dleaves, rebuild, leaves, diff_idx = _split_diff(args)
    if v_args is None:
        v_dleaves = [torch.zeros_like(leaf) for leaf in dleaves]
    else:
        vleaves = _leaves_with_none(v_args)
        if len(vleaves) == len(leaves):          # args-shaped direction
            vleaves = [vleaves[i] for i in diff_idx]
        if len(vleaves) != len(dleaves):
            raise ValueError(
                "v_args must match args' tree (or its floating leaves; None "
                f"leaves mean a zero direction): got {len(vleaves)} leaves "
                f"for {len(dleaves)} floating slots")
        v_dleaves = [torch.zeros_like(leaf) if v is None
                     else cm.like(v, leaf).broadcast_to(leaf.shape)
                     for leaf, v in zip(dleaves, vleaves)]
    v_dleaves = tuple(v_dleaves)

    def f_aug(t, yy, dl):
        y, d = yy[:, :dim], yy[:, dim:]
        prim, tang = jvp(lambda q, ll: f(t, q, rebuild(ll)),
                         (y, tuple(dl)), (d, v_dleaves))
        return torch.cat([prim, tang], dim=-1)

    cost_aug = None
    if cost is not None:
        q_scalar = cost(y0.new_zeros((m,)), y0, args).ndim == 1

        def cost_aug(t, yy, dl):
            y, d = yy[:, :dim], yy[:, dim:]
            prim, tang = jvp(
                lambda q, ll: cm.canon_cost(cost(t, q, rebuild(ll))),
                (y, tuple(dl)), (d, v_dleaves))
            return torch.cat([prim, tang], dim=-1)       # [M, 2Q]

    z0 = y0.detach().clone().requires_grad_()
    dl = [leaf.detach().clone().requires_grad_() for leaf in dleaves]
    with torch.enable_grad():
        out = radau_adjoint(f_aug, tspan, torch.cat([z0, v_y0], dim=-1),
                            args=dl, options=opts,
                            mass=_aug_mass(mass, dim), cost=cost_aug,
                            checkpoints=checkpoints)
        if cost is not None:
            yy, q2 = out
            qn = q2.shape[-1] // 2
            q, qdot = q2[:, :qn], q2[:, qn:]
            if q_scalar:
                q, qdot = q[:, 0], qdot[:, 0]
            ldot = jvp(lambda a, b, ll: loss(a, b, rebuild(ll)),
                       (yy[:, :dim], q, tuple(dl)),
                       (yy[:, dim:], qdot, v_dleaves))[1]
        else:
            ldot = jvp(lambda a, ll: loss(a, rebuild(ll)),
                       (out[:, :dim], tuple(dl)),
                       (out[:, dim:], v_dleaves))[1]
        grads = torch.autograd.grad(ldot, [z0, *dl], allow_unused=True)
    h_y0 = grads[0] if grads[0] is not None else torch.zeros_like(y0)
    out_leaves = [None] * len(leaves)
    for i, leaf, g in zip(diff_idx, dleaves, grads[1:]):
        out_leaves[i] = torch.zeros_like(leaf) if g is None else g
    _, unflatten = cm.tree_flatten(args)
    return (h_y0, unflatten(out_leaves)), ldot.detach()
