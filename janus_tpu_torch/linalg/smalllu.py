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


class _Linsolve(torch.autograd.Function):
    """x = A⁻¹b by ``lu_factor``/``lu_solve``; the factors ride along as
    outputs that carry no derivative, so that the rules reuse them."""

    generate_vmap_rule = True

    @staticmethod
    def forward(a, b):
        lu, piv = lu_factor(a)
        return lu_solve(lu, piv, b), lu, piv

    @staticmethod
    def setup_context(ctx, inputs, output):
        a, b = inputs
        x, lu, piv = output
        ctx.mark_non_differentiable(lu, piv)
        ctx.vec = b.ndim == a.ndim - 1
        ctx.save_for_forward(lu, piv, x)
        ctx.save_for_backward(a, x)

    @staticmethod
    def jvp(ctx, da, db):
        lu, piv, x = ctx.saved_tensors
        rhs = torch.zeros_like(x) if db is None else db
        if da is not None:
            rhs = rhs - (torch.einsum("...ij,...j->...i", da, x) if ctx.vec
                         else da @ x)
        return lu_solve(lu, piv, rhs), None, None

    @staticmethod
    def backward(ctx, gx, glu, gpiv):
        a, x = ctx.saved_tensors
        lu_t, piv_t = lu_factor(a.transpose(-1, -2))
        gb = lu_solve(lu_t, piv_t, gx)
        ga = -(gb[..., :, None] * x[..., None, :] if ctx.vec
               else gb @ x.transpose(-1, -2))
        return ga, gb


def linsolve(a, b):
    """x = A⁻¹b, batched (a [..., D, D], b [..., D] or [..., D, K]), pivoted.

    The tangent rule dx = A⁻¹(db − dA·x) reuses the factorization (the
    reference's custom_jvp, after its solve_LUdual): under ``torch.func``
    vmap over jvp, N directions cost N extra substitutions and no factor.
    Reverse mode is its transpose, b̄ = A⁻ᵀx̄ and Ā = −b̄xᵀ.
    """
    return _Linsolve.apply(a, b)[0]


def solve_real_complex(ar, ai, br, bi):
    """Solve (Ar + i·Ai)(xr + i·xi) = br + i·bi without a complex dtype:
    the split-real 2×2-block system [[Ar, −Ai], [Ai, Ar]] by ``linsolve``."""
    top = torch.cat([ar, -ai], dim=-1)
    bot = torch.cat([ai, ar], dim=-1)
    block = torch.cat([top, bot], dim=-2)
    sol = linsolve(block, torch.cat([br, bi], dim=-1))
    d = ar.shape[-1]
    return sol[..., :d], sol[..., d:]
