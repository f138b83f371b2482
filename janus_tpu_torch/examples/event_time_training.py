"""Training THROUGH a stopping condition: gradient-matching event times (the
twin of ``examples/event_time_training.py``).

``dopri_adjoint(events=)`` returns ``(y*, t*)`` with BOTH reverse-
differentiable: the event time t* carries exact implicit-function gradients
through the discrete adjoint, so a loss ON the stopping time trains.

Problem: a batch of m oscillators ẍ = −ω²x released from x(0) = 1; the
event is the first downward crossing of x = 0. Each lane has a TARGET
first-crossing time t_k*; gradient descent (lr 0.3, ``loss.backward()``)
learns the shared parameters (a, b) of ω(k) = a + b·k to match all targets
at once:

    L(a, b) = Σ_k (t*_k(a, b) − t_target_k)²

The crossing is t* = (π/2)/ω, so the solution is known: (a, b) = (1.0,
0.25). The reference's docstring says the example asserts convergence to
it; its ``main`` asserts nothing, and from the start (1.5, 0.1) at lr 0.3
it does NOT converge: after iteration 0 it stands at loss 4.096e-1, θ ≈
(1.2168, 0.3908); by iteration 10 the step has thrown it to θ ≈ (−1.0010,
−43.88), where it stays at loss ≈ 5.125. The port keeps the reference's
lr, start and iteration count and reproduces these iterates. float64.

  python3 -m janus_tpu_torch.examples.event_time_training
"""

import numpy as np
import torch

from janus_tpu_torch.solve import Options, dopri_adjoint
from janus_tpu_torch.solve.common import default_device
from janus_tpu_torch.solve.events import Event

A_TRUE, B_TRUE = 1.0, 0.25
THETA0 = (1.5, 0.1)                      # deliberately wrong start
LR = 0.3


def make_loss(m, device):
    """loss(theta [2]) -> the scalar L, differentiable in theta."""
    lanes = torch.arange(m, dtype=torch.float64, device=device)

    def rhs(t, y, theta):
        a, b = theta
        omega = a + b * lanes
        return torch.stack([y[..., 1], -(omega ** 2) * y[..., 0]], dim=-1)

    y0 = torch.stack([torch.ones(m, dtype=torch.float64, device=device),
                      torch.zeros(m, dtype=torch.float64, device=device)],
                     dim=-1)
    ev = Event(lambda t, y, th: y[..., 0], terminal=True, direction=-1.0)
    opts = Options(rtol=1e-9, atol=1e-12, adjoint_steps=256)
    # targets generated by the TRUE parameters
    t_target = torch.as_tensor(
        (np.pi / 2) / (A_TRUE + B_TRUE * np.arange(m, dtype=np.float64)),
        device=device)

    def loss(theta):
        _, t_star = dopri_adjoint(rhs, (0.0, 8.0), y0, args=theta,
                                  options=opts, method="dopri5", events=ev)
        return torch.sum((t_star - t_target) ** 2)

    return loss


def value_and_grad(loss, theta):
    theta = theta.detach().requires_grad_(True)
    val = loss(theta)
    g, = torch.autograd.grad(val, theta)
    return val.detach(), g


def main(n_iter: int = 60, m: int = 8, verbose: bool = True, device=None):
    """Returns (the final loss, the final theta as a numpy array), as the
    reference's main."""
    device = default_device(device)
    loss = make_loss(m, device)
    theta = torch.tensor(THETA0, dtype=torch.float64, device=device)
    for i in range(n_iter):
        val, g = value_and_grad(loss, theta)
        theta = theta - LR * g
        if verbose and i % 10 == 0:
            print(f"iter {i:3d}  loss {float(val):.3e}  "
                  f"theta ({float(theta[0]):.4f}, {float(theta[1]):.4f})")

    val, _ = value_and_grad(loss, theta)
    if verbose:
        print(f"final loss {float(val):.3e}  "
              f"theta ({float(theta[0]):.5f}, {float(theta[1]):.5f}) "
              f"vs true ({A_TRUE}, {B_TRUE})")
    return float(val), theta.cpu().numpy()


if __name__ == "__main__":
    main()
