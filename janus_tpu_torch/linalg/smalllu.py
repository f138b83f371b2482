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


def _swap_rows(x, k, p, r):
    """x [..., D, N] with row k (static) and row p >= k (per batch, [...]
    int64) swapped: one gather, out of place (reverse mode passes through
    it). r: arange(D) on x's device."""
    src = torch.where(r == p[..., None], k, r)                    # [..., D]
    src[..., k] = p
    return torch.gather(x, -2, src[..., None].expand(x.shape))


def lu_factor(a, pivot: bool = True):
    """Batched LU (partial pivoting by default).

    a: [..., D, D] → (lu [..., D, D] packed L\\U, piv [..., D] int32 swap
    targets in LAPACK ipiv convention; with pivot=False piv is the identity).
    A zero pivot is guarded to 1 (the lane then fails ``lu_ok``). Out of
    place, so that ``torch.func.vjp`` differentiates through it (the
    discrete adjoints' step replays): each column moves the finished row
    out and rebuilds only the rows below it.
    """
    d = a.shape[-1]
    batch = a.shape[:-2]
    r = torch.arange(d, device=a.device)
    rows, pivs = [], []
    rest = a                                  # rows k.. of the partial factor
    for k in range(d - 1):
        if pivot:
            # first maximal |entry| wins, as in the reference's tournament
            q = torch.argmax(torch.abs(rest[..., k]), dim=-1)
            rest = _swap_rows(rest, 0, q, r[:d - k])
            pivs.append(q + k)
        row = rest[..., 0, :]
        pivval = row[..., k]
        safe = torch.where(pivval == 0.0, 1.0, pivval)
        mult = rest[..., 1:, k] / safe[..., None]
        rest = torch.cat([rest[..., 1:, :k], mult[..., None],
                          rest[..., 1:, k + 1:]
                          - mult[..., None] * row[..., None, k + 1:]], dim=-1)
        rows.append(row)
    rows.append(rest[..., 0, :])              # the last row swaps with itself
    lu = torch.stack(rows, dim=-2)
    if not pivot:
        return lu, r.to(torch.int32).expand(*batch, d)
    pivs.append(r[d - 1].expand(batch))
    return lu, torch.stack(pivs, dim=-1).to(torch.int32)


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


def lu_solve(lu, piv, b, pivot: bool = True):
    """Solve with packed factors. b: [..., D] or [..., D, K]. pivot=False:
    the factor is pivot-free (``lu_factor(pivot=False)``), piv the identity,
    and no row is swapped."""
    d = lu.shape[-1]
    vec = b.ndim == lu.ndim - 1
    b = b[..., None] if vec else b
    if pivot:
        r = torch.arange(d, device=b.device)
        piv = piv.to(torch.int64)
        for k in range(d - 1):                # the last row swaps with itself
            b = _swap_rows(b, k, piv[..., k], r)
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
