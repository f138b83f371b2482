"""Neural ODE trained through the ADAPTIVE Dormand–Prince solver (the twin
of ``examples/neural_ode_dopri.py``).

Fit an MLP vector field [2, 64, 64, 2] to trajectory samples of an unknown
flow by reverse mode THROUGH the adaptive dopri5 solve: ``dopri_adjoint``,
the discrete adjoint on the recorded accepted-step mesh, with ``t_eval=``
chained warm-started segments so every sample is an exact solve endpoint.
Adam (lr 3e-3, the update of optax's ``adam``), then a held-out rollout
from fresh initial conditions through the learned field. float64.

The reference draws y0, the held-out y0 and the weights with jax.random;
here they come from a seeded ``torch.Generator`` unless passed in
(``y0=``, ``params=``, ``y0_test=``).

  python3 -m janus_tpu_torch.examples.neural_ode_dopri
"""

import torch

from janus_tpu_torch.models.neural import mlp_apply, mlp_init
from janus_tpu_torch.solve import Options
from janus_tpu_torch.solve.adjoint_dopri import dopri_adjoint
from janus_tpu_torch.solve.common import default_device, tree_leaves
from janus_tpu_torch.solve.dopri import TABLEAUS, solve_erk

T_FINAL = 3.0
N_SAMPLE = 8          # trajectory samples per lane
M = 16                # batch of initial conditions
OPTS = Options(rtol=1e-6, atol=1e-9, adjoint_steps=32)
SIZES = [2, 64, 64, 2]


def true_rhs(t, y, args):
    """Ground truth: a damped spiral with a mild cubic twist."""
    return torch.stack([-0.1 * y[..., 0] + 2.0 * y[..., 1],
                        -2.0 * y[..., 0] - 0.1 * y[..., 1]
                        - 0.3 * y[..., 1] ** 3], dim=-1)


def nn_rhs(t, y, params):
    return mlp_apply(params, y)


def kinetic(t, y, params):
    return torch.sum(mlp_apply(params, y) ** 2, dim=-1)


def sample_times(like):
    return torch.linspace(T_FINAL / N_SAMPLE, T_FINAL, N_SAMPLE,
                          dtype=like.dtype, device=like.device)


def rollout(f, y0, args, opts, ts):
    m = y0.shape[0]
    return solve_erk(TABLEAUS["dopri5"], f, y0.new_zeros(m),
                     y0.new_full((m,), T_FINAL), y0, args, opts, t_eval=ts)


def make_data(y0):
    """(ts, ys_true) of the ground-truth flow from y0 [M, 2]."""
    ts = sample_times(y0)
    sol = rollout(true_rhs, y0, None, Options(rtol=1e-9, atol=1e-12), ts)
    assert bool((sol.status == 1).all())
    return ts, sol.ys


def loss_fn(params, y0, ts, ys_true, reg=0.0):
    """The fitting loss; reg > 0 adds the kinetic-energy running cost
    λ·∫‖f_θ(y)‖² dt through ``dopri_adjoint(cost=)``, whose gradient flows
    through the same backward sweep as the fit."""
    if reg > 0.0:
        ys, q = dopri_adjoint(nn_rhs, (0.0, T_FINAL), y0, args=params,
                              options=OPTS, t_eval=ts, method="dopri5",
                              cost=kinetic)
        return torch.mean((ys - ys_true) ** 2) + reg * torch.mean(q)
    ys = dopri_adjoint(nn_rhs, (0.0, T_FINAL), y0, args=params,
                       options=OPTS, t_eval=ts, method="dopri5")
    return torch.mean((ys - ys_true) ** 2)


def _uniform(gen, lo, hi, device):
    u = torch.rand((M, 2), generator=gen, dtype=torch.float64)
    return (lo + (hi - lo) * u).to(device)


def main(steps=400, seed=0, verbose=True, reg=0.0, device=None):
    """Returns (loss0, lossN, holdout) as the reference's main: the first
    and the last step's loss and the held-out rollout's MSE."""
    device = default_device(device)
    gen = torch.Generator().manual_seed(seed)
    y0 = _uniform(gen, -1.5, 1.5, device)
    params = mlp_init(SIZES, gen, torch.float64, device)
    y0_test = _uniform(torch.Generator().manual_seed(seed + 1), -1.2, 1.2,
                       device)
    ts, ys_true = make_data(y0)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    opt = torch.optim.Adam(leaves, lr=3e-3)

    loss0 = None
    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params, y0, ts, ys_true, reg)
        loss.backward()
        opt.step()
        if loss0 is None:
            loss0 = loss.item()
        if verbose and (i % 50 == 0 or i == steps - 1):
            print(f"step {i:4d}  loss {loss.item():.3e}")
    lossN = loss.item()

    # held-out rollout: fresh initial conditions through the learned field
    with torch.no_grad():
        sol_true = rollout(true_rhs, y0_test, None,
                           Options(rtol=1e-9, atol=1e-12), ts)
        sol_nn = rollout(nn_rhs, y0_test, params, OPTS, ts)
        holdout = float(torch.mean((sol_nn.ys - sol_true.ys) ** 2))
    if verbose:
        print(f"loss {loss0:.3e} -> {lossN:.3e}  holdout MSE {holdout:.3e}")
    return loss0, lossN, holdout


if __name__ == "__main__":
    main()
