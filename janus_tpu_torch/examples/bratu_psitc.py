"""Pseudo-transient continuation on a reaction-diffusion steady state (the
twin of ``examples/bratu_psitc.py``).

The 1-D Bratu problem u'' + λ·e^u = 0, u(0) = u(1) = 0, the classic Ψtc
test (turning point at λ* ≈ 3.51; plain Newton from u = 0 struggles near
it), on N = 48 interior points. One batched run sweeps five λ values in
lockstep through Ψtc (SER-A); then the SAME steady states are solved again
matrix-free by Newton–Krylov with the tridiagonal preconditioner and must
agree. float64.

  python3 -m janus_tpu_torch.examples.bratu_psitc
"""

import numpy as np
import torch

from janus_tpu_torch.control import newton_krylov, psitc
from janus_tpu_torch.solve.common import default_device

N = 48
LAMS = (0.5, 1.0, 2.0, 3.0, 3.4)


def bratu_residual(u):
    m, n = u.shape
    lams = torch.tensor(LAMS, dtype=u.dtype, device=u.device)
    h = 1.0 / (n + 1)
    zero = torch.zeros((m, 1), dtype=u.dtype, device=u.device)
    left = torch.cat([zero, u[:, :-1]], dim=-1)
    right = torch.cat([u[:, 1:], zero], dim=-1)
    upp = (left - 2.0 * u + right) / h**2
    return upp + lams[:, None] * torch.exp(u)


def G(u):
    """Ψtc integrates u̇ = −G toward the steady state, so G needs a
    positive-definite-ish Jacobian for the flow to be stable. The Bratu
    residual's Jacobian is the (negative-definite) Laplacian plus a
    positive reaction shift, so Ψtc gets G = −F (the same roots)."""
    return -bratu_residual(u)


def u0(device, n=N):
    """The zero start of every λ lane on n interior points."""
    return torch.zeros((len(LAMS), n), dtype=torch.float64, device=device)


def solve_psitc(u, max_iter=200):
    return psitc(G, u, controller="ser-a", delta0=1e-2, tol=1e-9,
                 max_iter=max_iter)


def solve_newton_krylov(u, max_iter=30):
    return newton_krylov(bratu_residual, u, precond="tridiag", tol=1e-9,
                         max_iter=max_iter, gmres_restart=10,
                         gmres_maxiter=2)


def main(device=None):
    """Returns (the Ψtc steady states [5, N], Ψtc's iterations, the
    Newton–Krylov iterations, their max |difference|)."""
    device = default_device(device)
    start = u0(device)
    res = solve_psitc(start)
    assert bool(res.converged.all()), res.fnorm.tolist()
    peaks = res.x.max(dim=-1).values.cpu().numpy()
    print("Ψtc (SER-A) lower-branch steady states:")
    for lam, pk, it in zip(LAMS, peaks, res.iters.tolist()):
        print(f"  lam={lam:4.1f}  max(u)={pk:.5f}  iters={int(it)}")
    # solution amplitude grows monotonically toward the fold
    assert np.all(np.diff(peaks) > 0)

    # matrix-free Newton-Krylov + tridiagonal preconditioner, same answer
    nk = solve_newton_krylov(start)
    assert bool(nk.converged.all()), nk.fnorm.tolist()
    agree = float((nk.x - res.x).abs().max())
    print(f"Newton-Krylov(tridiag precond) agrees to {agree:.2e}")
    assert agree < 1e-6
    return res.x, res.iters, nk.iters, agree


if __name__ == "__main__":
    main()
