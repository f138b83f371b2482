"""Implicit-function-theorem reverse mode through the outer root solvers.

The port of ``janus_tpu/control/implicit.py``. The batched Newton / Ψtc /
Anderson / Krylov engines of this package iterate in host loops whose
iteration counts, damping and warm starts should not enter the tape, so a
converged root is differentiated at the root instead:

    x* = implicit_root(F, x0, args)          # F(x*, args) = 0

is a ``torch.autograd.Function``: the forward runs any of the package's
solvers to convergence (under no_grad), and the backward applies the
implicit function theorem at the root,

    x̄ ↦ θ̄ = −(∂F/∂θ)ᵀ w,   (∂F/∂x)ᵀ w = x̄

one batched transposed linear solve (the dense LU for small N, or
matrix-free GMRES with Jᵀ·v as a vjp pull for large N) and one vjp pull of
F in θ. The pulls are ``torch.autograd.grad`` of one evaluation of F at the
root, so a residual holding ``radau_adjoint`` (an autograd.Function) pulls
through its continuous adjoint.

The cotangent of ``x0`` is zero: at a converged root the solution does not
depend on the initial iterate. Lanes that did not converge get NaN
gradients rather than silently wrong ones. Only the floating-point tensor
leaves of ``args`` are differentiated.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Callable, Optional

import torch

from janus_tpu_torch.control.newton import (atleast_2d, fd_or_ad_jacobian,
                                            newton_solve)
from janus_tpu_torch.linalg.gmres import gmres_batched
from janus_tpu_torch.linalg.smalllu import lu_factor, lu_solve
from janus_tpu_torch.solve.common import (LOCKSTEP, keeps_lockstep, on_device,
                                          tree_leaves, tree_map)


def _split_diff(args):
    """(the floating-point tensor leaves of args, rebuild(new leaves) ->
    args with those leaves replaced)."""
    leaves = tree_leaves(args)
    diff_idx = [i for i, leaf in enumerate(leaves)
                if isinstance(leaf, torch.Tensor) and leaf.is_floating_point()]

    def rebuild(diff_leaves):
        new = list(leaves)
        for i, v in zip(diff_idx, diff_leaves):
            new[i] = v
        it = iter(new)
        return tree_map(lambda _: next(it), args)

    return [leaves[i] for i in diff_idx], rebuild


class _ImplicitRootFn(torch.autograd.Function):
    """forward(cfg, x0, *diff_leaves) -> x*; cfg holds the closure."""

    @staticmethod
    def forward(ctx, cfg, x0, *dleaves):
        x, conv = cfg.solve(x0, cfg.rebuild(list(dleaves)))
        ctx.cfg = cfg
        ctx.lockstep = LOCKSTEP.get()
        ctx.save_for_backward(x, conv, *dleaves)
        return x

    @staticmethod
    @keeps_lockstep
    def backward(ctx, xbar):
        cfg = ctx.cfg
        x, conv, *dleaves = ctx.saved_tensors
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            dl = [d.detach().requires_grad_(True) for d in dleaves]
            args_d = cfg.rebuild(dl)
            fx = cfg.f(xx, args_d)

            # solve (∂F/∂x)ᵀ w = x̄ at the root
            if cfg.linear == "lu":
                args_0 = cfg.rebuild(list(dleaves))
                jmat = (cfg.jac(x, args_0) if cfg.jac is not None else
                        fd_or_ad_jacobian(lambda v: cfg.f(v, args_0), x,
                                          cfg.jac_mode))
                lu, piv = lu_factor(jmat.transpose(-1, -2))
                w = lu_solve(lu, piv, xbar)
            else:
                def pull_x(v):
                    return torch.autograd.grad(fx, xx, v,
                                               retain_graph=True)[0]
                w, _ = gmres_batched(pull_x, xbar, precond=cfg.precond,
                                     iters=cfg.gmres_iters)

            # θ̄ = −(∂F/∂θ)ᵀ w, NaN on the lanes that did not converge
            w = torch.where(conv[..., None], w, float("nan"))
            grads = (torch.autograd.grad(fx, dl, -w, allow_unused=True)
                     if dl else ())
        gleaves = [torch.zeros_like(d) if g is None else g
                   for d, g in zip(dleaves, grads)]
        return (None, torch.zeros_like(x), *gleaves)


def implicit_root(f: Callable, x0, args: Any = None, *,
                  solver: Optional[Callable] = None,
                  linear: str = "lu", gmres_iters: int = 30,
                  precond: Optional[Callable] = None,
                  jac: Optional[Callable] = None, jac_mode: str = "ad",
                  device=None, **newton_kw):
    """Differentiable batched root solve: x*(args) with F(x*, args) = 0.

    f      : batched residual ``f(x [M, N], args) -> [M, N]``
    x0     : [M, N] initial iterate (or [N]; zero cotangent, see the module
             docstring); a torch x0 stays on its device, any other goes to
             ``device``, by default the CUDA card
    args   : parameter tree; every floating-point tensor leaf gets a
             gradient
    solver : optional ``solver(g, x0) -> x | result with .x`` running ANY
             root-finding engine on the closed residual ``g(x) = f(x,
             args)`` (e.g. ``lambda g, x0: psitc(g, x0)``); default is this
             package's damped ``newton_solve`` (extra ``newton_kw`` pass
             through to it). The engine's internals are NOT differentiated.
    linear : 'lu' (batched dense, small N) or 'gmres' (matrix-free Jᵀ·v by
             a vjp pull, no Jacobian materialized; optional right
             ``precond``)
    jac    : optional ``jac(x, args) -> [M, N, N]`` residual Jacobian for
             the 'lu' backward; jac_mode ('ad' | 'fd') picks the default
             when absent. A residual holding ``radau_adjoint`` is vjp-able
             but not jvp-able: use linear='gmres', jac_mode='fd', or an
             IND-built ``jac`` there.

    Returns x* [M, N] (the input rank preserved). Gradients of any function
    of x* flow through the implicit function theorem at the root; lanes
    whose forward solve did not converge get NaN gradients.
    """
    if linear not in ("lu", "gmres"):
        raise ValueError("linear must be 'lu' or 'gmres'")
    if solver is not None and newton_kw:
        raise ValueError(f"extra keywords {sorted(newton_kw)} configure the "
                         "default newton_solve; configure your own engine "
                         "inside the solver callable instead")
    x0 = on_device(x0, device)
    squeeze = x0.ndim == 1
    x0b = atleast_2d(x0)

    def solve(x0_, args_):
        def g(x):
            return f(x, args_)

        if solver is None:
            jac_cl = None if jac is None else (lambda xx: jac(xx, args_))
            res = newton_solve(g, x0_, jac_mode=jac_mode, jac=jac_cl,
                               **newton_kw)
        else:
            res = solver(g, x0_)
        x, conv = (res.x, getattr(res, "converged", None)) \
            if hasattr(res, "x") else (res, None)
        if conv is None:
            conv = torch.ones(x.shape[:-1], dtype=torch.bool,
                              device=x.device)
        return x, conv

    dleaves, rebuild = _split_diff(args)
    cfg = SimpleNamespace(f=f, solve=solve, rebuild=rebuild, linear=linear,
                          jac=jac, jac_mode=jac_mode, precond=precond,
                          gmres_iters=gmres_iters)
    x = _ImplicitRootFn.apply(cfg, x0b, *dleaves)
    return x[0] if squeeze else x
