"""Event detection (the twin of ``examples/events_poincare.py``): batched
Poincaré-section crossing times for Van der Pol.

One batched solve finds, for m stiffness values μ = 10^linspace(0, 1.5)
(4,096 by default), the first time the limit-cycle trajectory crosses
x1 = 0 moving downward; the event is located on the solver's collocation
interpolant, with no re-solving. Radau (s = 3), the analytic Jacobian,
horizon 50, float64 at rtol 1e-8, atol 1e-10 with the pivoted stage LU
(the reference's options off the TPU). ``kernel_lu=True`` takes the
reference's TPU options without its float32: the pivot-free stage LU
through the CUDA kernels K1/K2, at the same float64 tolerances.

  python3 -m janus_tpu_torch.examples.events_poincare [m] [--kernel-lu]
"""

import sys

import numpy as np
import torch

from janus_tpu_torch.models.problems import vdp_jac, vdp_rhs
from janus_tpu_torch.solve import EVENT_TERMINATED, Options, solve_ivp
from janus_tpu_torch.solve.common import default_device
from janus_tpu_torch.solve.events import Event

RTOL, ATOL = 1e-8, 1e-10


def crossing(t, y, args):
    return y[:, 0]                           # section x1 = 0


def options(kernel_lu=False):
    """The pivoted stage LU (the reference's options off the TPU) or, with
    ``kernel_lu=True``, the pivot-free one through K1/K2."""
    return Options(rtol=RTOL, atol=ATOL, pivoting=not kernel_lu,
                   kernel_lu=kernel_lu)


def solve(m, device, opts):
    """The batched solve under ``opts``; returns (mus, Solution)."""
    # the falling x1=0 crossing happens ~0.81*mu into the relaxation cycle,
    # so cap mu such that every lane crosses inside the horizon
    mus = torch.as_tensor(10.0 ** np.linspace(0.0, 1.5, m), device=device)
    y0 = torch.tensor([[2.0, 0.0]], dtype=torch.float64,
                      device=device).repeat(m, 1)
    sol = solve_ivp(vdp_rhs, (0.0, 50.0), y0, method="radau", args=mus,
                    jac=vdp_jac, options=opts,
                    events=Event(crossing, terminal=True, direction=-1.0))
    return mus, sol


def main(m=4096, device=None, kernel_lu=False):
    """Returns (mus, Solution) after the reference's prints and asserts."""
    device = default_device(device)
    mus, sol = solve(m, device, options(kernel_lu))
    hit = (sol.status == EVENT_TERMINATED).cpu().numpy()
    t_hit = sol.event_t.cpu().numpy()
    mus_np = mus.cpu().numpy()
    print(f"crossings found: {int(hit.sum())}/{m}")
    for mu_probe in (1.0, 3.0, 10.0, 30.0):
        i = int(np.argmin(np.abs(mus_np - mu_probe)))
        print(f"  mu={mus_np[i]:8.1f}  first x1=0 (falling) at "
              f"t={t_hit[i]:.6f}  x2={float(sol.event_y[i, 1]):+.4f}")
    assert hit.all()
    # sanity: crossing times grow with mu (relaxation slows the descent)
    assert t_hit[-1] > t_hit[0]
    return mus, sol


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    main(int(args[0]) if args else 4096,
         kernel_lu="--kernel-lu" in sys.argv[1:])
