"""Hamiltonian-first API (the twin of ``examples/hamiltonian_vdp.py``):
supply a scalar H(x, p, args) and get the dynamics [ṗ, ẋ], the Jacobian and
the sensitivities from automatic differentiation.

Batched Van der Pol as a Hamiltonian system (``models.vdp_hamiltonian``,
μ = 100, 8 lanes, y = [p, x]), solved by Radau, then again with the
identity-seeded sensitivities ∂y(T)/∂y0 and the final-time column
∂y(T)/∂T (``jet.solve.solve_with_sensitivities(wrt_tf=True)``), which must
equal f(T, y(T)). float64 at the reference's tolerances off the TPU (rtol
1e-8, atol 1e-11; the check at rtol 1e-6).

  python3 -m janus_tpu_torch.examples.hamiltonian_vdp
"""

import torch

from janus_tpu_torch import ham
from janus_tpu_torch.jet.solve import solve_with_sensitivities
from janus_tpu_torch.models import vdp_hamiltonian
from janus_tpu_torch.solve import Options, solve_ivp
from janus_tpu_torch.solve.common import default_device

RTOL, ATOL, CHECK_RTOL = 1e-8, 1e-11, 1e-6


def inputs(m, device):
    """y0 = [p0, x0]: x0 = (2, 0), p0 = (linspace(0.1, 1, m), 0)."""
    x0 = torch.tensor([[2.0, 0.0]], dtype=torch.float64,
                      device=device).repeat(m, 1)
    p0 = torch.zeros((m, 2), dtype=torch.float64, device=device)
    p0[:, 0] = torch.linspace(0.1, 1.0, m, dtype=torch.float64,
                              device=device)
    return torch.cat([p0, x0], dim=-1)


def sensitivities(y0, mu=100.0, rtol=RTOL, atol=ATOL):
    """The Jet of y(T) with its [D + 1, M, D] sensitivities (identity seeds
    and the final-time column), and the check that the final-time column
    equals f(T, y(T)) (within CHECK_RTOL at the default tolerances, 1e-3
    otherwise: the reference's TPU check)."""
    f = ham.hamiltonian_dynamics(vdp_hamiltonian)      # y = [p, x]
    yj, _ = solve_with_sensitivities(f, (0.0, 1.0), y0, args={"mu": mu},
                                     options=Options(rtol=rtol, atol=atol),
                                     wrt_tf=True)
    check = CHECK_RTOL if (rtol, atol) == (RTOL, ATOL) else 1e-3
    ok = torch.allclose(yj.d[-1], f(1.0, yj.r, {"mu": mu}), rtol=check,
                        atol=1e-5)
    return yj, ok


def main(device=None, rtol=RTOL, atol=ATOL):
    """Returns (sol, yj, ok): the plain solve, the Jet of y(T) with its
    [D + 1, M, D] sensitivities, and whether the final-time column equals
    f(T, y(T)) within CHECK_RTOL (1e-3 at other tolerances than the
    reference's float64 ones: its TPU check)."""
    device = default_device(device)
    mu = 100.0
    m = 8
    f = ham.hamiltonian_dynamics(vdp_hamiltonian)      # y = [p, x]
    y0 = inputs(m, device)

    sol = solve_ivp(f, (0.0, 1.0), y0, method="radau", args={"mu": mu},
                    rtol=rtol, atol=atol)
    print("status:", sol.status.tolist())
    print("x(T) lane0:", sol.y[0, 2:].tolist())

    # identity-seeded sensitivities ∂y(T)/∂y0 plus the final-time column
    yj, ok = sensitivities(y0, mu, rtol, atol)
    print("sensitivity tensor d shape (N, M, D):", tuple(yj.d.shape))
    print("d x1(T)/d x1(0) lane0:", float(yj.d[2, 0, 2]))
    print("d y(T)/dT == f(T,y):", ok)
    return sol, yj, ok


if __name__ == "__main__":
    main()
