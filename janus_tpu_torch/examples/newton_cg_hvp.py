"""Second-order optimization through the solver: Newton-CG with
``radau_hvp`` (the twin of ``examples/newton_cg_hvp.py``).

Choose the damping and stiffness θ = {c, k} of a forced oscillator so the
trajectory parks at the origin with little effort, L(θ) = |y(T)|² + ρ·∫ y₂²
dt (a Mayer + Lagrange objective), on M = 4 initial conditions fitted
jointly. Each Newton step takes the gradient from ``radau_adjoint(cost=)``
and solves H·d = −g by CG on ``radau_hvp`` products (``control.newton_cg``);
gradient descent at the same solve budget is the comparison. float64 at
rtol 1e-9, atol 1e-12, the pivot-free stage LU (the reference's choice),
``adjoint_steps=1024`` (the augmented system takes ~670 accepted steps).
``kernel_lu=True`` sends the forward solves' stage factors and solves
through the CUDA kernels K1/K2 (inside the adjoints' forward passes).

  python3 -m janus_tpu_torch.examples.newton_cg_hvp [--kernel-lu]
"""

import sys

import numpy as np
import torch

from janus_tpu_torch.control import newton_cg
from janus_tpu_torch.solve import Options, radau_adjoint, radau_hvp
from janus_tpu_torch.solve.common import default_device

RHO = 0.2
T = 4.0
M = 4                      # a small batch of initial conditions, fit jointly


def rhs(t, y, th):
    c, k = th["c"], th["k"]
    return torch.stack([y[:, 1],
                        -k * y[:, 0] - c * y[:, 1] + torch.sin(t)], dim=-1)


def cost(t, y, th):
    return y[:, 1] ** 2


def loss_terms(yT, q, th):
    return torch.sum(yT ** 2) + RHO * torch.sum(q)


def make_problem(device, kernel_lu=False, rtol=1e-9, atol=1e-12):
    """(loss, value_and_grad, hvp) over θ = {'c', 'k'} (0-d tensors), at
    the reference's float64 tolerances unless others are given (its
    float32 ones are rtol 1e-5, atol 1e-8)."""
    rng = np.random.RandomState(3)
    y0 = torch.as_tensor(rng.uniform(-1.0, 1.0, (M, 2)), device=device)
    # ~670 accepted steps on the augmented (HVP) system at rtol 1e-9:
    # size adjoint_steps above it or gradients poison to NaN by design
    opts = Options(rtol=rtol, atol=atol, adjoint_steps=1024,
                   pivoting=False, kernel_lu=kernel_lu)

    def loss(th):
        yT, q = radau_adjoint(rhs, (0.0, T), y0, args=th, options=opts,
                              cost=cost)
        return loss_terms(yT, q, th)

    def value_and_grad(th):
        th = {k: v.detach().requires_grad_(True) for k, v in th.items()}
        val = loss(th)
        gc, gk = torch.autograd.grad(val, (th["c"], th["k"]))
        return val.detach(), {"c": gc, "k": gk}

    def hvp(th, v):
        (_, h_th), _ = radau_hvp(rhs, (0.0, T), y0, th, loss=loss_terms,
                                 v_args=v, options=opts, cost=cost)
        return h_th

    return loss, value_and_grad, hvp


def theta0(device):
    return {"c": torch.tensor(0.2, dtype=torch.float64, device=device),
            "k": torch.tensor(4.0, dtype=torch.float64, device=device)}


def main(newton_iters=8, device=None, kernel_lu=False):
    """Returns (the Newton-CG final loss, the gradient-descent final loss)
    as the reference's main."""
    device = default_device(device)
    loss, vg, hvp = make_problem(device, kernel_lu)

    print("Newton-CG (control.newton_cg, radau_hvp curvature):")
    res = newton_cg(vg, hvp, theta0(device), max_iter=newton_iters,
                    cg_iters=4, tol=1e-10,
                    callback=lambda it, x, v, gn: print(
                        f"  it {it}: loss {v:.8f}  |g| {gn:.2e}  "
                        f"c {float(x['c']):.5f}  k {float(x['k']):.5f}"))
    th = res.x

    th_gd = theta0(device)
    # each Newton iteration above costs ~(1 + 4·2) adjoint solves; give
    # gradient descent the same solve budget
    print("gradient descent, equal solve budget:")
    lr = 0.05
    for _ in range(newton_iters * 9):
        _, g = vg(th_gd)
        th_gd = {k: th_gd[k] - lr * g[k] for k in th_gd}
    with torch.no_grad():
        l_gd, l_newton = float(loss(th_gd)), float(loss(th))
    print(f"  final loss {l_gd:.8f}  "
          f"c {float(th_gd['c']):.5f}  k {float(th_gd['k']):.5f}")
    print(f"Newton-CG final loss {l_newton:.8f}")
    return l_newton, l_gd


if __name__ == "__main__":
    main(kernel_lu="--kernel-lu" in sys.argv[1:])
