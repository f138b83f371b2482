"""Massively batched stiff Van der Pol (the twin of
``examples/stiff_vdp_batch.py``).

The headline workload: 65,536 trajectories with heterogeneous stiffness
mu = logspace(1, 3), fixed-stage Radau IIA at the reference example's
default stage count (s = 3, Radau5), analytic Jacobian, pivot-free stage LU;
float64 at rtol 1e-8, atol 1e-11 (the reference's tolerances off the TPU).
``kernel_lu=True`` sends every stage factor and solve through the CUDA
kernels K1/K2.

  python3 -m janus_tpu_torch.examples.stiff_vdp_batch [batch] [--kernel-lu]
"""

import sys
import time

import torch

from janus_tpu_torch.models.problems import vdp_jac, vdp_rhs
from janus_tpu_torch.solve import Options
from janus_tpu_torch.solve.common import default_device
from janus_tpu_torch.solve.radau import solve_radau


def run(y0, mus, kernel_lu=False):
    """(y, status, nsteps) of the batch, as the reference's jitted run."""
    opts = Options(rtol=1e-8, atol=1e-11, pivoting=False, kernel_lu=kernel_lu)
    sol = solve_radau(vdp_rhs, 0.0, 1.0, y0, args=mus, options=opts,
                      jac=vdp_jac)
    return sol.y, sol.status, sol.stats["nsteps"]


def inputs(batch, device):
    y0 = torch.tensor([[2.0, 0.0]], dtype=torch.float64,
                      device=device).repeat(batch, 1)
    mus = torch.logspace(1, 3, batch, dtype=torch.float64, device=device)
    return y0, mus


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(batch=65536, device=None, kernel_lu=False, report=None):
    """Solve the batch once to warm up (the kernels' build), then time a
    solve from y0 + 1e-6; print the rate and return (y, status, nsteps) of
    the timed solve (its seconds go into the dict ``report`` when one is
    given). The batch goes to ``device``: the CUDA card unless the caller
    asks for another."""
    device = default_device(device)
    y0, mus = inputs(batch, device)
    run(y0, mus, kernel_lu)
    _sync(device)
    t0 = time.perf_counter()
    y, status, nsteps = run(y0 + 1e-6, mus, kernel_lu)
    _sync(device)
    dt = time.perf_counter() - t0
    if report is not None:
        report["seconds"] = dt
    ok = float((status == 1).double().mean())
    print(f"batch {batch} (float64, {device.type}, kernel_lu={kernel_lu}): "
          f"{dt:.3f}s  {batch / dt:,.0f} traj/s  success {100 * ok:.1f}%  "
          f"steps[min..max] {int(nsteps.min())}..{int(nsteps.max())}")
    print("y[0] =", y[0].tolist(), " y[-1] =", y[-1].tolist())
    return y, status, nsteps


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    main(int(args[0]) if args else 65536,
         kernel_lu="--kernel-lu" in sys.argv[1:])
