"""Problems and checks shared by the parity tests of the radaup ladder and
the legacy steppers (``test_torch_radaup.py``,
``test_torch_adjoint_radaup.py``, ``test_torch_legacy.py``), each written
once for both packages (xp: jnp or torch)."""

import jax.numpy as jnp
import numpy as np
import torch

from test_method_zoo_linear import A_ALL, TF, Y0_ALL, YT_ALL

STATS7 = ("nfev", "njev", "nlu", "nsteps", "naccept", "nreject", "nnewton")


def vdp_rhs_xp(xp):
    def rhs(t, y, mu):
        x, v = y[:, 0], y[:, 1]
        return xp.stack([v, mu * (1.0 - x * x) * v - x], -1)
    return rhs


def robertson_xp(xp):
    def rhs(t, y, a):
        d1 = -0.04 * y[:, 0] + 1e4 * y[:, 1] * y[:, 2]
        d3 = 3e7 * y[:, 1] ** 2
        return xp.stack([d1, -d1 - d3, d3], -1)
    return rhs


def linear_rhs(xp):
    """y' = A y per lane, A [M, D, D] as args."""
    return lambda t, y, a: xp.einsum("mij,mj->mi", a, y)


def linear_problems():
    """The random stiff linear systems of tests/test_method_zoo_linear.py
    (A = QΛQᵀ, eigenvalues −10^U(−1, 3)): (A, y0, exact y(TF), TF) as
    writable numpy arrays."""
    return (np.array(A_ALL), np.array(Y0_ALL), np.array(YT_ALL), TF)


def close(got, ref, tol, what):
    """got (torch) within tol of ref relative to ref's largest entry, NaN
    where ref is NaN."""
    ref = np.asarray(ref)
    got = got.detach().numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref), err_msg=what)
    np.testing.assert_allclose(
        got, ref, rtol=0,
        atol=tol * max(float(np.nanmax(np.abs(ref))), 1e-300), err_msg=what)


def test_problems_agree_between_packages():
    """Each shared rhs gives the same values in both packages."""
    rng = np.random.default_rng(0)
    a, y0, _, _ = linear_problems()
    for rhs, y, args in ((vdp_rhs_xp, rng.standard_normal((4, 2)),
                          np.array([1.0, 10.0, 100.0, 1000.0])),
                         (robertson_xp, rng.uniform(0, 1, (3, 3)), None),
                         (linear_rhs, y0, a)):
        t = np.zeros(y.shape[0])
        ref = rhs(jnp)(jnp.asarray(t), jnp.asarray(y),
                       None if args is None else jnp.asarray(args))
        got = rhs(torch)(torch.from_numpy(t), torch.from_numpy(y),
                         None if args is None else torch.from_numpy(args))
        close(got, ref, 1e-15, rhs.__name__)
