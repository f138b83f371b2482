"""The port's Krylov preconditioners (janus_tpu_torch.control.precond)
against the JAX package's, on the CPU in float64.

The same numpy inputs go through both. The stencils are those of
``test_torch_mol_cases``: the 1-D Fisher-KPP line, the 2-D heat grid, the
species-major 2-D Brusselator and the cell-interleaved 2-species line.
Tolerances, relative to the largest entry of the reference's result: probes
and the extracted bands and blocks 1e-14 (the port reads the probed columns
by plain indexing where the reference sums a one-hot selection: the same
numbers); the Thomas solve 1e-13; a preconditioner applied to a random
vector 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janus_tpu.control import precond as ref_pc
from janus_tpu_torch.control import precond as pc
from test_torch_mol_cases import CASES, as_jax, as_torch, close

torch.set_num_threads(1)


def _pair(name):
    """(ref_f(y), f(y), x_ref, x): the case's rhs at t = 0 as functions of
    the state only, and a perturbed state in both packages."""
    ref_f, f, y0, args = CASES[name][0]()
    m = y0.shape[0]
    x = y0 + 0.05 * np.random.default_rng(21).normal(size=y0.shape)
    ja, ta = as_jax(args), as_torch(args)
    tz = torch.zeros(m, dtype=torch.float64)
    return (lambda y: ref_f(jnp.zeros(m), y, ja), lambda y: f(tz, y, ta),
            jnp.asarray(x), torch.from_numpy(x))


@pytest.mark.parametrize("ncolors", [1, 3, 5])
@pytest.mark.parametrize("name", list(CASES))
def test_probe_colored_jacobian(name, ncolors):
    rf, f, xr, x = _pair(name)
    close(pc.probe_colored_jacobian(f, x, ncolors),
          ref_pc.probe_colored_jacobian(rf, xr, ncolors), 1e-14)


@pytest.mark.parametrize("name", list(CASES))
def test_probe_custom_colors(name):
    rf, f, xr, x = _pair(name)
    colors = np.random.default_rng(22).integers(0, 4, size=x.shape[-1])
    close(pc.probe_custom_colors(f, x, torch.from_numpy(colors), 4),
          ref_pc.probe_custom_colors(rf, xr, jnp.asarray(colors), 4), 1e-14)


@pytest.mark.parametrize("name", list(CASES))
def test_tridiag_bands(name):
    rf, f, xr, x = _pair(name)
    for got, ref, band in zip(pc.tridiag_bands(f, x),
                              ref_pc.tridiag_bands(rf, xr), ("dl", "d", "du")):
        close(got, ref, 1e-14, band)


@pytest.mark.parametrize("n", [1, 2])
def test_tridiag_bands_narrow(n):
    """Fewer than 3 columns: min(3, N) colors."""
    a = np.random.default_rng(23).normal(size=(n, n))
    x = np.ones((2, n))
    got = pc.tridiag_bands(lambda y: y @ torch.from_numpy(a).T,
                           torch.from_numpy(x))
    ref = ref_pc.tridiag_bands(lambda y: y @ jnp.asarray(a).T, jnp.asarray(x))
    for g, r in zip(got, ref):
        close(g, r, 1e-14)


@pytest.mark.parametrize("name", list(CASES))
def test_line_tridiag_bands(name):
    rf, f, xr, x = _pair(name)
    block = CASES[name][1]
    for got, ref, band in zip(pc.line_tridiag_bands(f, x, block),
                              ref_pc.line_tridiag_bands(rf, xr, block),
                              ("dl", "d", "du")):
        close(got, ref, 1e-14, band)


@pytest.mark.parametrize("name", list(CASES))
def test_blocks_of_jacobian(name):
    rf, f, xr, x = _pair(name)
    block = CASES[name][2]
    close(pc.blocks_of_jacobian(f, x, block),
          ref_pc.blocks_of_jacobian(rf, xr, block), 1e-14)


def test_extractors_are_exact_on_their_structure():
    """Against the dense Jacobian of the port's own rhs: the 3-colour bands
    on the tridiagonal line, the in-line bands on the heat grid, the 2×2
    blocks on the interleaved line."""
    def dense(f, x):                            # [M, D, D], a jvp a column
        eye = torch.eye(x.shape[-1], dtype=x.dtype)
        return torch.stack([torch.func.jvp(f, (x,), (e.expand_as(x),))[1]
                            for e in eye], dim=-1)

    _, f, _, x = _pair("line")
    jac = dense(f, x)
    dl, d, du = pc.tridiag_bands(f, x)
    torch.testing.assert_close(d, torch.diagonal(jac, dim1=-2, dim2=-1))
    torch.testing.assert_close(dl[:, 1:],
                               torch.diagonal(jac, -1, dim1=-2, dim2=-1))
    torch.testing.assert_close(du[:, :-1],
                               torch.diagonal(jac, 1, dim1=-2, dim2=-1))

    _, f, _, x = _pair("heat")
    jac = dense(f, x)
    dl, d, du = pc.line_tridiag_bands(f, x, 8)
    torch.testing.assert_close(d, torch.diagonal(jac, dim1=-2, dim2=-1))
    sub = torch.diagonal(jac, -1, dim1=-2, dim2=-1).clone()
    sub[:, 7::8] = 0.0                        # no coupling across a line end
    torch.testing.assert_close(dl[:, 1:], sub)
    assert bool((du[:, 7::8] == 0).all()) and bool((dl[:, 0::8] == 0).all())

    _, f, _, x = _pair("interleaved")
    jac = dense(f, x)
    blocks = pc.blocks_of_jacobian(f, x, 2)
    for k in range(blocks.shape[1]):
        torch.testing.assert_close(blocks[:, k],
                                   jac[:, 2 * k:2 * k + 2, 2 * k:2 * k + 2])


@pytest.mark.parametrize("n", [1, 2, 3, 7, 48, 65])
def test_tridiag_solve(n):
    rng = np.random.default_rng(24 + n)
    dl, du, b = rng.normal(size=(3, 3, n))
    d = rng.normal(size=(3, n)) + 6.0
    close(pc.tridiag_solve(*map(torch.from_numpy, (dl, d, du, b))),
          ref_pc.tridiag_solve(*map(jnp.asarray, (dl, d, du, b))), 1e-13)


@pytest.mark.parametrize("name", list(CASES))
def test_tridiag_precond_apply(name):
    rf, f, xr, x = _pair(name)
    v = np.random.default_rng(25).normal(size=x.shape)
    close(pc.tridiag_precond(f, x)(torch.from_numpy(v)),
          ref_pc.tridiag_precond(rf, xr)(jnp.asarray(v)), 1e-12)


@pytest.mark.parametrize("name", list(CASES))
def test_block_jacobi_precond_apply(name):
    rf, f, xr, x = _pair(name)
    block = CASES[name][2]
    v = np.random.default_rng(26).normal(size=x.shape)
    close(pc.block_jacobi_precond(f, x, block)(torch.from_numpy(v)),
          ref_pc.block_jacobi_precond(rf, xr, block)(jnp.asarray(v)), 1e-12)


def test_singular_structure_falls_back_to_identity():
    """A lane whose probed diagonal has a zero keeps the tridiagonal
    preconditioner at the identity; a singular block becomes the identity
    block (both as in the reference)."""
    x = torch.ones((2, 4), dtype=torch.float64)
    v = torch.arange(8.0, dtype=torch.float64).reshape(2, 4)
    scale = torch.tensor([[0.0], [2.0]], dtype=torch.float64)
    got = pc.tridiag_precond(lambda y: scale * y, x)(v)
    torch.testing.assert_close(got, torch.stack([v[0], v[1] / 2.0]))
    got = pc.block_jacobi_precond(lambda y: scale * y, x, 2)(v)
    torch.testing.assert_close(got, torch.stack([v[0], v[1] / 2.0]))


def test_block_size_must_divide():
    x = torch.ones((1, 6), dtype=torch.float64)
    with pytest.raises(ValueError, match="not divisible"):
        pc.line_tridiag_bands(lambda y: y, x, 4)
    with pytest.raises(ValueError, match="not divisible"):
        pc.blocks_of_jacobian(lambda y: y, x, 4)
    with pytest.raises(ValueError, match="not divisible"):
        pc.block_jacobi_precond(lambda y: y, x, 4)
