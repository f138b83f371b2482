"""Energy-optimal control of Van der Pol to the origin by PMP shooting (the
twin of ``examples/vdp_pmp_energy.py``).

  minimize  J = ∫ u²/2 dt
  s.t.      ẋ1 = x2,  ẋ2 = μ(1−x1²)x2 − x1 + u,  x(0)=x0, x(T)=0
  PMP:      u* = −p2;  ṗ1 = p2(2μx1x2+1);  ṗ2 = −p1 − p2μ(1−x1²)

Single shooting at μ = 0 and 1 (Newton with the Jacobian by forward-mode AD
through the Radau solve), then a homotopy in μ up to 10 on the unknowns of
multiple shooting over six segments (all segments one lockstep batch),
started from the μ = 0 solution; the optimal control u(t) = −p2(t) and its
cost on a grid. Radau at rtol 1e-8, atol 1e-11, float64; the plain route
(the kernels have no derivative rule).

  python3 -m janus_tpu_torch.examples.vdp_pmp_energy
"""

import numpy as np
import torch

from janus_tpu_torch.control import multiple_shooting_residual, single_shooting
from janus_tpu_torch.control.homotopy import homotopy
from janus_tpu_torch.solve import Options, solve_ivp
from janus_tpu_torch.solve.common import default_device

N_SEG = 6
X0 = (1.0, 0.5)
TF = 3.0


def pmp_rhs(t, y, mu):
    """The PMP Van der Pol system: y = [x1, x2, p1, p2], u* = −p2."""
    x1, x2, p1, p2 = y[..., 0], y[..., 1], y[..., 2], y[..., 3]
    mu = torch.as_tensor(mu, dtype=y.dtype, device=y.device) \
        .broadcast_to(x1.shape)
    return torch.stack([
        x2,
        mu * (1 - x1 ** 2) * x2 - x1 - p2,
        p2 * (2 * mu * x1 * x2 + 1.0),
        -p1 - p2 * mu * (1 - x1 ** 2),
    ], dim=-1)


def _x0(like):
    return torch.tensor([X0], dtype=like.dtype, device=like.device)


def shooting_residual(p0, mu):
    """x(T) must hit the origin; the unknowns are the initial costates
    [M, 2]."""
    m = p0.shape[0]
    y0 = torch.cat([_x0(p0).repeat(m, 1), p0], dim=-1)
    sol = solve_ivp(pmp_rhs, (0.0, TF), y0, method="radau", args=mu,
                    options=Options(rtol=1e-8, atol=1e-11))
    return sol.y[:, :2]


def solve_direct(mu, device, p0_guess=None):
    p0 = (torch.zeros((1, 2), dtype=torch.float64, device=device)
          if p0_guess is None else p0_guess)
    return single_shooting(lambda p: shooting_residual(p, mu), p0, tol=1e-9)


def t_nodes():
    return np.linspace(0.0, TF, N_SEG + 1)


def multishoot_residual(mu):
    """Single-shooting conditions blow up like e^{μT}; MULTIPLE shooting
    keeps each segment short. All segments integrate as ONE lockstep
    batch."""
    def bc(y_start, y_end):
        return torch.cat([y_start[:, :2] - _x0(y_start), y_end[:, :2]],
                         dim=-1)

    return multiple_shooting_residual(
        pmp_rhs, t_nodes(), bc, method="radau", args=mu,
        options=Options(rtol=1e-8, atol=1e-11))


def solve_by_homotopy(mu_target, device):
    """Continuation in μ from the linear problem, solvable at once, on the
    multiple-shooting unknowns z = the stacked segment starts [1, S·4]."""
    res0 = solve_direct(0.0, device)
    assert bool(res0.converged[0])
    # the first multiple-shooting iterate from the μ=0 single-shooting one
    y0 = torch.cat([_x0(res0.x), res0.x], dim=-1)
    t_eval = torch.as_tensor(t_nodes()[:-1], device=device)
    sol = solve_ivp(pmp_rhs, (0.0, TF), y0, method="radau", args=0.0,
                    options=Options(rtol=1e-10, atol=1e-13), t_eval=t_eval)
    z0 = sol.ys.reshape(1, -1)

    def g(z, lam):
        return multishoot_residual(lam * mu_target)(z)

    return homotopy(g, z0, dlam0=0.25, tol=1e-7, newton_iters=6)


def main(device=None):
    """Returns a dict of what the reference prints: the single-shooting
    results at μ = 0 and 1 (p0, converged, |x(T)|), the homotopy's λ, the
    multiple-shooting residual's norm at the target, u(t) on the grid and
    its cost J."""
    device = default_device(device)
    mu_target = 10.0
    out = {}
    for mu in (0.0, 1.0):
        res = solve_direct(mu, device)
        print(f"mu={mu}: converged={bool(res.converged[0])} "
              f"p0={res.x[0].tolist()} |x(T)|={float(res.fnorm[0]):.2e}")
        out[f"direct_mu{mu:g}"] = res

    hres = solve_by_homotopy(mu_target, device)
    print(f"homotopy to mu={mu_target}: lambda={float(hres.lam[0]):.3f}")
    final = multishoot_residual(mu_target)(hres.x)
    final_norm = float(torch.linalg.vector_norm(final))
    print(f"multishoot residual at target: {final_norm:.2e}")

    # optimal control signal u(t) = −p2(t) on a grid
    y0 = hres.x[:, :4]
    t_eval = np.linspace(0.0, TF, 16)
    sol = solve_ivp(pmp_rhs, (0.0, TF), y0, method="radau", args=mu_target,
                    options=Options(rtol=1e-8, atol=1e-11),
                    t_eval=torch.as_tensor(t_eval, device=device))
    u = -sol.ys[0, :, 3].cpu().numpy()
    cost = np.trapezoid(0.5 * u ** 2, t_eval)
    print("u(t):", np.array2string(u, precision=3))
    print(f"J = {cost:.4f}")
    out.update(homotopy=hres, final_norm=final_norm, u=u, cost=float(cost))
    return out


if __name__ == "__main__":
    main()
