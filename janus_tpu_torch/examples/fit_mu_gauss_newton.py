"""Parameter estimation with internal-differentiation Jacobians (the twin of
``examples/fit_mu_gauss_newton.py``).

Batched Gauss–Newton: recover each trajectory's Van der Pol stiffness μ
from noisy endpoint observations at three horizons. The residual Jacobian
dr/dμ comes from ONE ``solve_radau(args_tangents=...)`` sweep per horizon
per iteration: no finite differences, no per-parameter re-solves. A whole
batch of independent fitting problems runs in lockstep; each lane converges
on its own μ. float64 at rtol 1e-7, atol 1e-10, the pivot-free stage LU
(the reference's choice); ``kernel_lu=True`` sends every stage factor and
solve through the CUDA kernels K1/K2.

  python3 -m janus_tpu_torch.examples.fit_mu_gauss_newton [m] [--kernel-lu]
"""

import sys

import numpy as np
import torch

from janus_tpu_torch.models.problems import vdp_jac, vdp_rhs
from janus_tpu_torch.solve import Options
from janus_tpu_torch.solve.common import default_device
from janus_tpu_torch.solve.radau import solve_radau

HORIZONS = (0.4, 0.8, 1.2)


def _y0(m, like):
    return torch.tensor([[2.0, 0.0]], dtype=like.dtype,
                        device=like.device).repeat(m, 1)


def observe(mus, opts):
    """Endpoint y at each horizon for true parameters (data generation)."""
    y0 = _y0(mus.shape[0], mus)
    obs = []
    for tf in HORIZONS:
        sol = solve_radau(vdp_rhs, 0.0, tf, y0, args=mus, options=opts,
                          jac=vdp_jac)
        obs.append(sol.y)
    return torch.stack(obs, dim=1)           # [M, H, 2]


def options(kernel_lu=False):
    return Options(rtol=1e-7, atol=1e-10, pivoting=False,
                   kernel_lu=kernel_lu)


def problem(m, device, kernel_lu=False):
    """(mu_true, data) of the reference's draws: np.random.RandomState(0)
    for the true μ and the 1e-4 observation noise."""
    rng = np.random.RandomState(0)
    mu_true = torch.as_tensor(10.0 ** rng.uniform(0.8, 2.2, m),
                              device=device)
    data = observe(mu_true, options(kernel_lu))
    noise = rng.randn(*data.shape)
    data = data + 1e-4 * torch.as_tensor(noise, device=device)
    return mu_true, data


def gn_step(mu_hat, data, opts):
    """One damped scalar Gauss–Newton step of every lane; returns (the new
    μ̂, the RMS residual of the old one, the IND sweeps' Solutions)."""
    m = mu_hat.shape[0]
    y0 = _y0(m, mu_hat)
    ones = torch.ones((1, m), dtype=mu_hat.dtype, device=mu_hat.device)
    r_rows, j_rows, sols = [], [], []
    for h, tf in enumerate(HORIZONS):
        sol = solve_radau(vdp_rhs, 0.0, tf, y0, args=mu_hat, options=opts,
                          jac=vdp_jac, args_tangents=ones)
        r_rows.append(sol.y - data[:, h])
        j_rows.append(sol.sens[0])           # [M, 2] = d y(tf) / d mu
        sols.append(sol)
    r = torch.cat(r_rows, dim=-1)            # [M, 6]
    J = torch.cat(j_rows, dim=-1)            # [M, 6]
    # scalar-parameter Gauss-Newton: delta = (J.r)/(J.J), damped
    num = torch.sum(J * r, dim=-1)
    den = torch.sum(J * J, dim=-1) + 1e-12
    step = -num / den
    # trust region: cap the relative parameter move per iteration
    step = torch.minimum(torch.maximum(step, -0.3 * mu_hat), 0.3 * mu_hat)
    return mu_hat + step, torch.sqrt(torch.mean(r * r, dim=-1)), sols


def mu_start(m, device):
    """The one cold start μ = 30 of every lane."""
    return torch.full((m,), 30.0, dtype=torch.float64, device=device)


def fit(m, device, kernel_lu=False, iters=30):
    """(mu_true, mu_hat, rn) after ``iters`` Gauss–Newton steps from the
    one cold start μ = 30."""
    mu_true, data = problem(m, device, kernel_lu)
    opts = options(kernel_lu)
    mu_hat, rn = mu_start(m, device), None
    for _ in range(iters):
        mu_hat, rn, _ = gn_step(mu_hat, data, opts)
    return mu_true, mu_hat, rn


def main(m=256, device=None, kernel_lu=False):
    """Returns (mu_true, mu_hat, rn, rel) after the reference's prints and
    asserts."""
    device = default_device(device)
    mu_true, mu_hat, rn = fit(m, device, kernel_lu)
    rel = ((mu_hat - mu_true).abs() / mu_true).cpu().numpy()
    print(f"batch {m}: median rel error {np.median(rel):.2e}, "
          f"90th pct {np.percentile(rel, 90):.2e}, "
          f"median resid {float(np.median(rn.cpu().numpy())):.2e}")
    assert np.median(rel) < 5e-3
    assert np.percentile(rel, 90) < 5e-2
    return mu_true, mu_hat, rn, rel


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    main(int(args[0]) if args else 256,
         kernel_lu="--kernel-lu" in sys.argv[1:])
