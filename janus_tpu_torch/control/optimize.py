"""Matrix-free second-order minimization: Newton-CG with HVP curvature.

The port of ``janus_tpu/control/optimize.py``, the optimizer that pairs
with ``solve.hvp.radau_hvp``: minimize a smooth objective over a parameter
tree given only its gradient and Hessian-vector products (no Hessian is
materialized). Each outer iteration runs truncated CG (Steihaug: it stops
at negative curvature or at the step cap) on H d = −g, then an Armijo
backtracking line search along the Newton direction, with a gradient
fallback where the model is locally nonconvex. The drivers are host loops,
as in the reference: they run O(10) outer iterations around solves that
take seconds.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from janus_tpu_torch.solve.common import tree_leaves, tree_map


def _dot(a, b):
    return sum(torch.sum(x * y) for x, y in zip(tree_leaves(a),
                                                  tree_leaves(b)))


def _axpy(alpha, x, y):                       # y + alpha * x
    return tree_map(lambda a, b: b + alpha * a, x, y)


def _norm(a):
    return float(torch.sqrt(_dot(a, a)))


@dataclass
class OptimizeResult:
    x: Any                     # final parameters (tree)
    value: float               # final objective
    grad_norm: float
    iters: int                 # outer Newton iterations taken
    converged: bool            # grad_norm <= tol
    nhvp: int                  # total Hessian-vector products
    nfev: int                  # total objective evaluations


def cg_steihaug(hvp: Callable, g, max_iter: int = 10, rtol: float = 0.1,
                step_cap: Optional[float] = None):
    """Truncated CG on H d = −g (tree vectors, matrix-free).

    Stops on the Steihaug conditions: residual down by ``rtol``, negative
    curvature (returns the best descent step found so far; the
    steepest-descent segment if the FIRST direction is already nonconvex),
    or ``step_cap`` on ‖d‖. Returns (d, n_hvp_calls)."""
    d = tree_map(torch.zeros_like, g)
    r = tree_map(lambda x: -x, g)
    p = r
    rr = _dot(r, r)
    r0 = float(torch.sqrt(rr))
    if r0 == 0.0:
        return d, 0
    for it in range(max_iter):
        hp = hvp(p)
        php = float(_dot(p, hp))
        if php <= 0.0:
            if it == 0:
                # nonconvex along −g: the gradient direction, scaled to the
                # cap (or to unit length)
                scale = (step_cap / r0) if step_cap else (1.0 / r0)
                return tree_map(lambda x: scale * x, r), it + 1
            return d, it + 1
        alpha = float(rr / php)
        d_next = _axpy(alpha, p, d)
        if step_cap is not None and _norm(d_next) > step_cap:
            return d, it + 1                   # stop at the region boundary
        d = d_next
        r = _axpy(-alpha, hp, r)
        rr_new = _dot(r, r)
        if float(torch.sqrt(rr_new)) <= rtol * r0:
            return d, it + 1
        p = _axpy(float(rr_new / rr), p, r)
        rr = rr_new
    return d, max_iter


def newton_cg(value_and_grad: Callable, hvp: Callable, x0,
              max_iter: int = 30, tol: float = 1e-8, cg_iters: int = 10,
              cg_rtol: float = 0.1, step_cap: Optional[float] = None,
              backtracks: int = 12, callback: Optional[Callable] = None
              ) -> OptimizeResult:
    """Minimize a scalar objective over a tree with matrix-free curvature.

    value_and_grad : x -> (scalar value, gradient tree)
    hvp            : (x, v) -> H(x)·v tree, e.g.
                     ``lambda x, v: radau_hvp(..., args=x, v_args=v, ...)``
    step_cap       : optional trust-region-style cap on ‖Newton step‖

    Armijo backtracking (c1 = 1e-4) along the CG direction; if even the
    fully backtracked step fails to decrease, the iteration stops (the
    gradient tolerance decides ``converged``).
    """
    x = x0
    nhvp = nfev = 0
    v, g = value_and_grad(x)
    nfev += 1
    gn = _norm(g)
    it = 0
    for it in range(1, max_iter + 1):
        if gn <= tol:
            break
        d, k = cg_steihaug(lambda p: hvp(x, p), g, max_iter=cg_iters,
                           rtol=cg_rtol, step_cap=step_cap)
        nhvp += k
        gd = float(_dot(g, d))
        if gd >= 0.0:                          # not a descent direction
            d = tree_map(lambda a: -a, g)
            gd = -gn * gn
        t = 1.0
        accepted = False
        for _ in range(backtracks):
            x_try = _axpy(t, d, x)
            v_try, g_try = value_and_grad(x_try)
            nfev += 1
            if float(v_try) <= float(v) + 1e-4 * t * gd:
                x, v, g = x_try, v_try, g_try
                gn = _norm(g)
                accepted = True
                break
            t *= 0.5
        if callback is not None:
            callback(it, x, float(v), gn)
        if not accepted:
            break
    return OptimizeResult(x=x, value=float(v), grad_norm=gn, iters=it,
                          converged=gn <= tol, nhvp=nhvp, nfev=nfev)
