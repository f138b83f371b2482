"""The method-of-lines problems of the matrix-free Radau tests, in both
packages, and their right-hand sides held against each other on the CPU.

Every problem is a pair: the JAX function (from ``janus_tpu.models.problems``
or written here as the reference's tests and ``bench.py`` write it) and its
torch counterpart (from ``janus_tpu_torch.models.problems``, or the one that
``janus_tpu_torch.bench.mol`` drives on the card). The other
``test_torch_*`` files of the matrix-free path import their problems from
here. Inputs are made from a seed with numpy.
Tolerance of the right-hand sides: 1e-14 relative to the largest entry.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janus_tpu.models import problems as ref_problems
from janus_tpu_torch.bench.mol import fisher_kpp_rhs as line_rhs
from janus_tpu_torch.bench.mol import interleaved_rhs
from janus_tpu_torch.models import problems

torch.set_num_threads(1)


def ref_line_rhs(dx):
    """1-D Fisher-KPP line u' = ν·u_xx + r·u(1−u), Dirichlet 0; args (ν, r)."""
    def rhs(t, y, args):
        nu, r = args
        left = jnp.pad(y[:, :-1], ((0, 0), (1, 0)))
        right = jnp.pad(y[:, 1:], ((0, 0), (0, 1)))
        lap = (left - 2 * y + right) / dx ** 2
        return nu * lap + r * y * (1.0 - y)
    return rhs


def ref_interleaved_rhs(dx):
    """Cell-interleaved stiff 2-species line y = [u0, v0, u1, v1, ...]: slow
    diffusion of both, a stiff exchange k·(u − v) inside each cell; args k."""
    def rhs(t, y, args):
        kk = args
        u, v = y[:, 0::2], y[:, 1::2]
        left = jnp.pad(u[:, :-1], ((0, 0), (1, 0)))
        right = jnp.pad(u[:, 1:], ((0, 0), (0, 1)))
        lap_u = (left - 2 * u + right) / dx ** 2
        lv = jnp.pad(v[:, :-1], ((0, 0), (1, 0)))
        rv = jnp.pad(v[:, 1:], ((0, 0), (0, 1)))
        lap_v = (lv - 2 * v + rv) / dx ** 2
        fu = 0.001 * lap_u - kk * (u - v)
        fv = 0.001 * lap_v + kk * (u - v) - v
        out = jnp.zeros_like(y)
        out = out.at[:, 0::2].set(fu)
        return out.at[:, 1::2].set(fv)
    return rhs


def line_case(d=32, m=4):
    """(ref_f, f, y0 [M, D], args): bench.py's line at width d."""
    dx = 1.0 / (d + 1)
    xg = np.linspace(dx, 1.0 - dx, d)
    y0 = np.tile(np.exp(-100 * (xg - 0.3) ** 2)[None], (m, 1))
    rates = np.linspace(1.0, 8.0, m)[:, None]
    return ref_line_rhs(dx), line_rhs(dx), y0, (0.01, rates)


def heat_case(nx=8, m=3):
    """2-D Fisher-KPP on an nx × nx grid (rows are lines of length nx)."""
    dx = 1.0 / (nx + 1)
    xg = np.linspace(dx, 1.0 - dx, nx)
    xx, yy = np.meshgrid(xg, xg)
    u0 = np.exp(-40 * ((xx - 0.4) ** 2 + (yy - 0.55) ** 2)).ravel()
    y0 = np.tile(u0[None], (m, 1))
    rates = np.linspace(1.0, 6.0, m)[:, None]
    return (ref_problems.heat_2d_rhs(nx, nx, dx),
            problems.heat_2d_rhs(nx, nx, dx), y0, (0.02, rates))


def brusselator_case(nx=6, ny=5, m=3):
    """Species-major 2-D Brusselator, ny odd (exact in-line bands)."""
    dx = 1.0 / (nx + 1)
    rng = np.random.default_rng(5)
    n = nx * ny
    y0 = np.concatenate([1.0 + 0.1 * rng.normal(size=(m, n)),
                         3.0 + 0.1 * rng.normal(size=(m, n))], axis=1)
    args = (np.full(m, 1.0), np.linspace(2.0, 3.0, m), 0.02, 0.01)
    return (ref_problems.brusselator_2d_rhs(nx, ny, dx),
            problems.brusselator_2d_rhs(nx, ny, dx), y0, args)


def interleaved_case(ncell=24, m=2):
    """The stiff 2-species line of the reference's block-preconditioner
    test (k = 200)."""
    dx = 1.0 / (ncell + 1)
    rng = np.random.default_rng(3)
    y0 = 1.0 + 0.2 * rng.normal(size=(m, 2 * ncell))
    return ref_interleaved_rhs(dx), interleaved_rhs(dx), y0, 200.0


# name -> (case, line length for precond='lines', block for precond='block')
CASES = {
    "line": (line_case, 8, 2),
    "heat": (heat_case, 8, 4),
    "brusselator": (brusselator_case, 6, 3),
    "interleaved": (interleaved_case, 4, 2),
}


def as_jax(tree):
    """numpy arrays of a tuple/scalar args tree -> jnp arrays."""
    if isinstance(tree, tuple):
        return tuple(as_jax(x) for x in tree)
    return jnp.asarray(tree) if isinstance(tree, np.ndarray) else tree


def as_torch(tree):
    if isinstance(tree, tuple):
        return tuple(as_torch(x) for x in tree)
    return torch.from_numpy(tree) if isinstance(tree, np.ndarray) else tree


def close(got, ref, tol, what=""):
    """got (torch) against ref (jax), to tol relative to ref's largest entry."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=tol,
                               atol=tol * max(float(np.abs(ref).max()), 1e-300),
                               err_msg=what)


@pytest.mark.parametrize("name", list(CASES))
def test_rhs_matches_reference(name):
    ref_f, f, y0, args = CASES[name][0]()
    m = y0.shape[0]
    rng = np.random.default_rng(11)
    y = y0 + 0.05 * rng.normal(size=y0.shape)
    close(f(torch.zeros(m, dtype=torch.float64), torch.from_numpy(y),
            as_torch(args)),
          ref_f(jnp.zeros(m), jnp.asarray(y), as_jax(args)), 1e-14, name)


def test_laplacian_2d_matches_reference():
    rng = np.random.default_rng(12)
    u = rng.normal(size=(3, 5 * 7))
    close(problems.laplacian_2d(torch.from_numpy(u), 7, 5, 0.125),
          ref_problems.laplacian_2d(jnp.asarray(u), 7, 5, 0.125), 1e-14)
