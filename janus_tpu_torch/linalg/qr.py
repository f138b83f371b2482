"""Batched Householder QR for small D (``Options(qr_fallback=True)``).

The port of ``janus_tpu/linalg/qr.py``: the stage solve of the lanes whose
LU broke (a zero or tiny pivot that pivot-free elimination cannot avoid).
The elimination unrolls over D, every operation a batched op over the
lanes, out of place (reverse mode passes through it).
"""

from __future__ import annotations

import torch


def qr_factor(a):
    """a [..., D, D] -> (vs, r): column k of vs [..., D, D] is the k-th
    Householder vector (zero above the diagonal), r upper triangular."""
    d = a.shape[-1]
    r = a
    rows = torch.arange(d, device=a.device)
    cols = []
    for k in range(d):
        x = torch.where(rows >= k, r[..., :, k], 0.0)
        normx = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
        e_k = (rows == k).to(a.dtype)
        sign = torch.where(r[..., k:k + 1, k] >= 0, 1.0, -1.0)
        v = x + sign * normx * e_k
        vnorm = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
        v = v / torch.where(vnorm == 0.0, 1.0, vnorm)
        # r <- (I − 2 v vᵀ) r
        vtr = torch.einsum("...i,...ij->...j", v, r)
        r = r - 2.0 * v[..., :, None] * vtr[..., None, :]
        cols.append(v)
    return torch.stack(cols, dim=-1), r


def qr_solve(vs, r, b):
    """x = A⁻¹b with qr_factor's factors; b [..., D] -> x [..., D]."""
    d = r.shape[-1]
    y = b
    for k in range(d):
        v = vs[..., :, k]
        vty = torch.sum(v * y, dim=-1, keepdim=True)
        y = y - 2.0 * v * vty
    xs = [None] * d
    for i in reversed(range(d)):
        acc = y[..., i]
        for j in range(i + 1, d):
            acc = acc - r[..., i, j] * xs[j]
        diag = r[..., i, i]
        xs[i] = acc / torch.where(diag == 0.0, 1.0, diag)
    return torch.stack(xs, dim=-1)


def qr_linsolve(a, b):
    """x = A⁻¹b through batched Householder QR."""
    vs, r = qr_factor(a)
    return qr_solve(vs, r, b)
