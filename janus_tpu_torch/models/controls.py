"""Piecewise control-parameterization helpers (the port of
``janus_tpu/models/controls.py``).

Controls are TIME-indexed: a [K]-knot schedule evaluated inside the RHS
(step-indexed slabs are ill-defined under adaptive stepping; for fixed-grid
runs ``solve.fixed.odeint_fixed(step_args=...)`` keeps per-step slabs).
"""

from __future__ import annotations

import torch

from janus_tpu_torch.solve.common import on_device


def _knots(t_knots, values):
    if isinstance(t_knots, torch.Tensor):
        return t_knots
    return torch.as_tensor(t_knots, dtype=values.dtype, device=values.device)


def _as_t(t, like):
    if isinstance(t, torch.Tensor):
        return t
    return torch.as_tensor(t, dtype=like.dtype, device=like.device)


def piecewise_constant(t_knots, values, device=None):
    """u(t): values[k] on [t_knots[k], t_knots[k+1]) (the last value from
    the last knot on, the first before the first); values may be [K] or
    [K, U] or batched [M, K(, U)] with t broadcast accordingly. A torch
    ``values`` keeps its device; any other goes to ``device``, by default
    the CUDA card; the knots follow it."""
    values = on_device(values, device)
    t_knots = _knots(t_knots, values)

    def u(t):
        t = _as_t(t, t_knots)
        idx = torch.clamp(torch.searchsorted(t_knots, t, right=True) - 1,
                          0, values.shape[-2] if values.ndim > 1 else
                          values.shape[-1])
        idx = torch.clamp(idx, 0, (values.shape[0] if values.ndim == 1
                                   else values.shape[-2]) - 1)
        if values.ndim == 1:
            return values[idx]
        return values[..., idx, :]

    return u


def _interp(x, xp, fp):
    """Linear interpolation of (xp, fp) at x, clamped to fp[0] / fp[-1]
    outside [xp[0], xp[-1]] (numpy's and jax's ``interp``)."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, len(xp) - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    # np.spacing(eps) = eps² (eps a power of two); guards a zero-width knot
    dx0 = torch.abs(dx) <= torch.finfo(xp.dtype).eps ** 2
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def piecewise_linear(t_knots, values, device=None):
    """Linear interpolation between knots, clamped at the ends; values [K]
    or [K, U] (devices as ``piecewise_constant``)."""
    values = on_device(values, device)
    t_knots = _knots(t_knots, values)

    def u(t):
        t = _as_t(t, t_knots)
        if values.ndim == 1:
            return _interp(t, t_knots, values)
        return torch.stack([_interp(t, t_knots, values[..., j])
                            for j in range(values.shape[-1])], dim=-1)

    return u
