"""Dubins-car PMP steering with a homotopy toward bang-bang control (the
twin of ``examples/dubins_pmp.py``).

The min-time turn-rate control is bang-bang (u* = −umax·sign(p3)); it is
smoothed as u* = −umax·tanh(p3/ε) and ε → 0 by continuation, solving the
shooting problem again at each ε (0.2, 0.1, 0.05, 0.02) from the previous
rung's costates. Single shooting with the Jacobian by forward-mode AD
through the Radau solve (rtol 1e-9, atol 1e-12; the plain route: the
kernels have no derivative rule). float64.

  python3 -m janus_tpu_torch.examples.dubins_pmp
"""

import numpy as np
import torch

from janus_tpu_torch.control import single_shooting
from janus_tpu_torch.models.problems import dubins_pmp_rhs
from janus_tpu_torch.solve import Options, solve_ivp
from janus_tpu_torch.solve.common import default_device

TF = 2.0
TARGET = (1.2, 0.8)
EPS_LADDER = (0.2, 0.1, 0.05, 0.02)


def residual(p0, eps):
    m = p0.shape[0]
    args = {"v": 1.0, "umax": 2.0, "eps": eps}
    y0 = torch.cat([p0.new_zeros((m, 3)), p0], dim=-1)
    sol = solve_ivp(dubins_pmp_rhs, (0.0, TF), y0, method="radau", args=args,
                    options=Options(rtol=1e-9, atol=1e-12))
    target = torch.tensor(TARGET, dtype=p0.dtype, device=p0.device)
    return torch.cat([sol.y[:, :2] - target[None], sol.y[:, 5:6]], dim=-1)


def main(device=None):
    """Returns (p0 [1, 3] after the last rung, the final position [2])."""
    device = default_device(device)
    p0 = torch.tensor([[0.1, 0.1, 0.1]], dtype=torch.float64, device=device)
    for eps in EPS_LADDER:
        res = single_shooting(lambda p: residual(p, eps), p0, tol=1e-8)
        p0 = res.x
        print(f"eps={eps:5.2f} converged={bool(res.converged[0])} "
              f"|res|={float(res.fnorm[0]):.2e} p0={p0[0].tolist()}")

    # inspect the (nearly bang-bang) control signal
    eps = EPS_LADDER[-1]
    args = {"v": 1.0, "umax": 2.0, "eps": eps}
    y0 = torch.cat([p0.new_zeros((1, 3)), p0], dim=-1)
    t_eval = torch.linspace(0.0, TF, 21, dtype=torch.float64, device=device)
    sol = solve_ivp(dubins_pmp_rhs, (0.0, TF), y0, method="radau", args=args,
                    options=Options(rtol=1e-9, atol=1e-12), t_eval=t_eval)
    u = -2.0 * np.tanh(sol.ys[0, :, 5].cpu().numpy() / eps)
    print("u(t):", np.array2string(u, precision=2))
    final = sol.ys[0, -1, :2]
    print("final position:", final.tolist(), "target:", list(TARGET))
    return p0, final


if __name__ == "__main__":
    main()
