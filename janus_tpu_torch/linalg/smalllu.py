"""Batched LU for small D, optional partial pivoting (plain torch).

The stiff stage matrices are tiny (D ≲ 32) but there are tens of thousands of
them. The elimination unrolls over D in Python, so every operation is a
batched [..., ] tensor op over the trajectories. Row swaps are plain index
swaps (gather/scatter); the reference's one-hot swaps were a TPU workaround.

This is the stage solver when ``Options(kernel_lu=False)``. Its pivot-free
mode has the same arithmetic as the CUDA kernels K1/K2 of
``janus_tpu_torch.ops.smalllu`` and their plain twins.
"""

from __future__ import annotations

import torch


def _swap_rows(x, k, p):
    """Swap row k (static) with row p (per batch, [...]) of x [..., D, N] in place."""
    n = x.shape[-1]
    idx = p.to(torch.int64).expand(x.shape[:-2])[..., None, None]
    idx = idx.expand(*x.shape[:-2], 1, n)
    row_p = torch.gather(x, -2, idx)
    row_k = x[..., k:k + 1, :].clone()
    x[..., k:k + 1, :] = row_p
    x.scatter_(-2, idx, row_k)


def lu_factor(a, pivot: bool = True):
    """Batched LU (partial pivoting by default).

    a: [..., D, D] → (lu [..., D, D] packed L\\U, piv [..., D] int32 swap
    targets in LAPACK ipiv convention; with pivot=False piv is the identity).
    A zero pivot is guarded to 1 (the lane then fails ``lu_ok``).
    """
    d = a.shape[-1]
    batch = a.shape[:-2]
    lu = a.clone()
    pivs = []
    for k in range(d):
        if pivot:
            # first maximal |entry| wins, as in the reference's tournament
            p = k + torch.argmax(torch.abs(lu[..., k:, k]), dim=-1)
            _swap_rows(lu, k, p)
            pivs.append(p.to(torch.int32))
        else:
            pivs.append(torch.full(batch, k, dtype=torch.int32,
                                   device=a.device))
        pivval = lu[..., k, k]
        safe = torch.where(pivval == 0.0, 1.0, pivval)
        mult = lu[..., k + 1:, k] / safe[..., None]
        lu[..., k + 1:, k + 1:] = (lu[..., k + 1:, k + 1:]
                                   - mult[..., :, None] * lu[..., k:k + 1, k + 1:])
        lu[..., k + 1:, k] = mult
    return lu, torch.stack(pivs, dim=-1)


def lu_ok(lu, a_scale=None, tol=None):
    """Per-batch regularity check: smallest |pivot| vs matrix scale (the
    singular-retry trigger)."""
    d = lu.shape[-1]
    diag = torch.abs(torch.diagonal(lu, dim1=-2, dim2=-1))
    scale = torch.abs(lu).amax(dim=(-2, -1)) if a_scale is None else a_scale
    if tol is None:
        tol = torch.finfo(lu.dtype).eps * d * 100
    return (diag.amin(dim=-1) > tol * torch.clamp(scale, min=1e-300)) & \
        torch.isfinite(diag).all(dim=-1)


def lu_solve(lu, piv, b):
    """Solve with packed factors. b: [..., D] or [..., D, K]."""
    d = lu.shape[-1]
    vec = b.ndim == lu.ndim - 1
    b = (b[..., None] if vec else b).clone()
    for k in range(d):
        _swap_rows(b, k, piv[..., k])
    # forward substitution (unit lower)
    ys = []
    for i in range(d):
        yi = b[..., i, :]
        for j in range(i):
            yi = yi - lu[..., i, j][..., None] * ys[j]
        ys.append(yi)
    # back substitution
    xs = [None] * d
    for i in reversed(range(d)):
        xi = ys[i]
        for j in range(i + 1, d):
            xi = xi - lu[..., i, j][..., None] * xs[j]
        diag = lu[..., i, i]
        diag = torch.where(diag == 0.0, 1.0, diag)
        xs[i] = xi / diag[..., None]
    x = torch.stack(xs, dim=-2)
    return x[..., 0] if vec else x
