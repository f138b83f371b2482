"""Krylov preconditioners from colored Jacobian probes.

The port of ``janus_tpu/control/precond.py``. A cheap approximate inverse
that clusters the spectrum, built from structures a batched device likes:

- **block-Jacobi**: the Jacobian's diagonal blocks, probed with colored
  jvp's (Curtis–Powell–Reid style) and factored with the batched unrolled
  LU of ``linalg.smalllu``: [M, nb, b, b] batched work.
- **tridiagonal**: the three diagonals probed with 3 (or, line-blocked, 6)
  colored jvp's, applied with a Thomas or PCR sweep.

Both are *approximations* when J has entries outside the assumed structure
(coloring folds same-color columns together); that is standard and fine for
preconditioning. They are exact when J matches the structure (block
diagonal / tridiagonal), the method-of-lines regime they target.

f must be traceable by ``torch.func.jvp``: no in-place writes on its input
and no ``.item()``.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.func import jvp

from janus_tpu_torch.linalg.gmres import tridiag_solve
from janus_tpu_torch.linalg.smalllu import lu_factor, lu_solve

__all__ = ["probe_colored_jacobian", "probe_custom_colors", "tridiag_bands",
           "line_tridiag_bands", "blocks_of_jacobian", "guarded_block_lu",
           "block_jacobi_precond", "tridiag_solve", "tridiag_precond"]


def probe_custom_colors(f: Callable, x, colors, ncolors: int):
    """Colored Jacobian probing with an arbitrary color assignment.

    colors: [N] integer tensor mapping column j to its color. Returns
    cols[c] = J @ v_c with v_c[j] = (colors[j] == c), as [ncolors, M, N].
    Entry J[i, j] is recovered exactly from cols[colors[j]][i] whenever no
    OTHER nonzero column of row i shares color colors[j]."""
    probes = (colors[None, :] == torch.arange(
        ncolors, device=x.device)[:, None]).to(x.dtype)         # [C, N]
    return torch.stack([jvp(f, (x,), (v.expand_as(x).contiguous(),))[1]
                        for v in probes])                        # [C, M, N]


def probe_colored_jacobian(f: Callable, x, ncolors: int):
    """J's action on the ``ncolors`` comb vectors v_c[j] = (j % ncolors == c),
    as [ncolors, M, N]. For a banded J with bandwidth < ncolors, column j of
    J is recovered exactly as cols[j % ncolors] restricted to rows near j."""
    colors = torch.arange(x.shape[-1], device=x.device) % ncolors
    return probe_custom_colors(f, x, colors, ncolors)


def _read_colors(cols, cread, valid):
    """out[m, i] = cols[cread[i], m, i] where valid[i], else 0."""
    idx = torch.arange(cols.shape[-1], device=cols.device)
    return torch.where(valid, cols[cread, :, idx].T, 0.0)


def tridiag_bands(f: Callable, x):
    """The three diagonals (dl, d, du) of J at ``x`` from 3 colored jvp's.

    f: [M, N] -> [M, N]. Exact for tridiagonal J (1-D 3-point stencils);
    colored (folded) approximation otherwise. dl[...,0] and du[...,-1] are 0.
    """
    n = x.shape[-1]
    nc = min(3, n)
    cols = probe_colored_jacobian(f, x, nc)                    # [nc, M, N]
    idx = torch.arange(n, device=x.device)

    def diag_at(offset):
        # entry J[i, i+offset] lives in color (i+offset) % nc at row i
        j = idx + offset
        return _read_colors(cols, j % nc, (j >= 0) & (j < n))

    return diag_at(-1), diag_at(0), diag_at(1)


def line_tridiag_bands(f: Callable, x, block: int):
    """In-line tridiagonal bands (dl, d, du) of J for a LINE-BLOCKED state
    layout: the state is ``nb`` consecutive lines of length ``block`` (e.g.
    the rows of an [ny, nx] 2-D MOL grid, or one species' grid in a
    species-major multi-species layout).

    Probing uses 6 colors, (j mod 3) crossed with line parity
    ((j // block) mod 2), so couplings into ADJACENT lines (the ±block
    offsets of 5/9-point stencils) land in the other parity group and can
    never alias onto the in-line bands, unlike the plain 3-color
    ``tridiag_bands``. In-line couplings at |offset| ≥ 2 and couplings two
    lines away still alias. dl/du are zero at line boundaries, so a single
    Thomas/PCR sweep over the full length-N array solves the line-block
    system exactly (the zeros decouple the lines).
    """
    n = x.shape[-1]
    if block < 2 or n % block != 0:
        raise ValueError(f"N={n} not divisible by line length block={block}")
    j = torch.arange(n, device=x.device)
    par3 = 3 * ((j // block) % 2)
    cols = probe_custom_colors(f, x, (j % 3) + par3, 6)        # [6, M, N]

    def diag_at(offset):
        pos = (j % block) + offset
        return _read_colors(cols, (j + offset) % 3 + par3,
                            (pos >= 0) & (pos < block))

    return diag_at(-1), diag_at(0), diag_at(1)


def blocks_of_jacobian(f: Callable, x, block: int):
    """Diagonal blocks of J at ``x``: [M, nb, b, b] from 2b colored jvp's.

    Parity-extended coloring ((j mod b) crossed with block parity) makes the
    extraction EXACT whenever every cross-block coupling goes to an ADJACENT
    block (cell-interleaved MOL layouts: reaction terms are in-block,
    spatial neighbors are ±b). Couplings two or more blocks away alias.
    """
    m, n = x.shape
    b = block
    if b < 1 or n % b != 0:
        raise ValueError(f"N={n} not divisible by block={b}")
    nb = n // b
    j = torch.arange(n, device=x.device)
    colors = (j % b) + b * ((j // b) % 2)
    cols = probe_custom_colors(f, x, colors, 2 * b)            # [2b, M, N]
    # pk[m, k, r, c, parity] = cols[parity*b + c][m, k*b + r]
    pk = cols.reshape(2, b, m, nb, b).permute(2, 3, 4, 1, 0)
    kpar = (torch.arange(nb, device=x.device) % 2)[None, :, None, None]
    return torch.where(kpar == 0, pk[..., 0], pk[..., 1])


def guarded_block_lu(a):
    """Pivoted batched LU of preconditioner blocks [..., b, b] with identity
    fallback on singular/non-finite blocks (preconditioning must never
    inject NaN; the Newton/GMRES layers police a weak preconditioner)."""
    lu, piv = lu_factor(a, pivot=True)
    diag = torch.abs(torch.diagonal(lu, dim1=-2, dim2=-1))
    bad = (diag.amin(dim=-1) <= 0.0) | \
        ~torch.isfinite(lu).all(dim=-1).all(dim=-1)
    b = a.shape[-1]
    lu = torch.where(bad[..., None, None],
                     torch.eye(b, dtype=a.dtype, device=a.device), lu)
    piv = torch.where(bad[..., None], torch.arange(
        b, dtype=piv.dtype, device=a.device), piv)
    return lu, piv


def block_jacobi_precond(f: Callable, x, block: int) -> Callable:
    """Right-preconditioner v ↦ M⁻¹v from J's diagonal blocks at ``x``.

    f: [M, N] -> [M, N]; N must be divisible by ``block``. Costs ``block``
    jvp's to build + one batched LU of [M, nb, b, b]; each application is two
    batched triangular sweeps. Exact when J is block diagonal w.r.t. the
    partition; the standard colored approximation otherwise.
    """
    m, n = x.shape
    if n % block != 0:
        raise ValueError(f"N={n} not divisible by block={block}")
    nb = n // block
    cols = probe_colored_jacobian(f, x, block)                 # [b, M, N]
    # blocks[m, k, r, c] = (J v_c)[m, k*b + r]
    blocks = cols.reshape(block, m, nb, block).permute(1, 2, 3, 0)
    lu, piv = guarded_block_lu(blocks)

    def apply(v):
        return lu_solve(lu, piv, v.reshape(m, nb, block)).reshape(m, n)

    return apply


def tridiag_precond(f: Callable, x) -> Callable:
    """Right-preconditioner from J's tridiagonal part at ``x`` (3 colored
    jvp's + Thomas sweeps). Exact for tridiagonal J (1-D 3-point stencils);
    colored approximation otherwise."""
    dl, dmain, du = tridiag_bands(f, x)
    bad = ~(torch.isfinite(dmain) & (dmain != 0.0)).all(dim=-1, keepdim=True)
    dmain = torch.where(bad, 1.0, dmain)
    dl = torch.where(bad, 0.0, dl)
    du = torch.where(bad, 0.0, du)

    def apply(v):
        return tridiag_solve(dl, dmain, du, v)

    return apply
