"""Learn a neural-network Hamiltonian from solver data (the twin of
``examples/train_nn_hamiltonian.py``).

1. ground-truth flow segments of the harmonic oscillator from the adaptive
   Radau solver (rtol 1e-10);
2. the dataset written and read back through the native binary IO
   (``native.traj_write``);
3. an MLP Hamiltonian trained through the fixed-step RK4 integrator
   (reverse mode through ``odeint_fixed``) with Adam (lr 3e-3: optax's
   ``adam``, whose update ``torch.optim.Adam`` computes);
4. a checkpoint saved and restored, and the learned field checked on
   held-out states.

Everything in float64. The integrator keeps its stages for the backward
pass (``remat=False``, where the reference recomputes them): 256 lanes ×
16 steps of stages are a few MB, and recomputing them would cost ~65% more
launches a training step, on a loop bound by the host's launches.

  python3 -m janus_tpu_torch.examples.train_nn_hamiltonian
"""

import tempfile
from pathlib import Path

import torch

from janus_tpu_torch import native
from janus_tpu_torch.models.neural import mlp_init
from janus_tpu_torch.models.problems import harmonic_rhs
from janus_tpu_torch.solve import solve_ivp
from janus_tpu_torch.solve.common import default_device, tree_leaves
from janus_tpu_torch.solve.fixed import odeint_fixed
from janus_tpu_torch.utils import restore_checkpoint, save_checkpoint


def nn_rhs(t, y, params):
    """Canonical dynamics from the learned H: q' = ∂H/∂v, v' = −∂H/∂q.

    ∂H/∂y is the reference's ``jax.vmap(jax.grad(H))`` written out: the
    chain rule back through ``models.neural.mlp_apply``'s tanh layers, one
    pass forward and one back, each a batched op over the lanes (a few
    dozen launches a call, where ``torch.func``'s transforms cost some
    hundred). Autograd differentiates it again for the training."""
    ws, bs = params["w"], params["b"]
    hs = [y]
    for w, b in zip(ws[:-1], bs[:-1]):
        hs.append(torch.tanh(hs[-1] @ w + b))
    g = ws[-1].sum(dim=1).expand(y.shape[0], -1)     # ∂H/∂(last hidden)
    for w, h in zip(reversed(ws[:-1]), reversed(hs[1:])):
        g = (g * (1.0 - h * h)) @ w.T
    return torch.stack([g[:, 1], -g[:, 0]], dim=-1)


def main(steps=400, m=256, dt=0.5, workdir=None, device=None,
         report=None):
    """Returns the held-out flow error after the restore (asserted < 0.05;
    the restored parameters are asserted equal to the saved ones to the
    bit). Runs on ``device``: the CUDA card unless the caller asks for
    another. A dict ``report`` receives the first and last loss and the
    error."""
    device = default_device(device)
    gen = torch.Generator().manual_seed(0)
    workdir = Path(workdir or tempfile.mkdtemp(prefix="janus_train_"))
    workdir.mkdir(parents=True, exist_ok=True)
    f64 = torch.float64

    # 1) ground truth from the ADAPTIVE solver (radau, tight tolerance)
    y0s = torch.randn((m, 2), generator=gen, dtype=f64).to(device)
    sol = solve_ivp(harmonic_rhs, (0.0, dt), y0s, method="radau", args=1.0,
                    rtol=1e-10, atol=1e-13)
    assert bool((sol.status == 1).all())

    # 2) dataset round-trip through the native IO
    ds_path = workdir / "flow_pairs.jtrj"
    native.traj_write(ds_path, torch.cat([y0s, sol.y], dim=1).cpu().numpy())
    data = torch.as_tensor(native.traj_read(ds_path), device=device)
    x_train, y_train = data[:, :2], data[:, 2:]
    print(f"dataset: {data.shape[0]} flow pairs via {ds_path}")

    # 3) train through the fixed-step (reverse-differentiable) integrator
    params = mlp_init([2, 32, 32, 1], gen, f64, device)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_()
    opt = torch.optim.Adam(leaves, lr=3e-3)

    def loss_fn(p):
        pred = odeint_fixed(nn_rhs, 0.0, dt, x_train, n_steps=16, args=p,
                            remat=False)
        return torch.mean((pred - y_train) ** 2)

    with torch.no_grad():
        l0 = float(loss_fn(params))
    for i in range(steps):
        opt.zero_grad()
        loss = loss_fn(params)
        loss.backward()
        opt.step()
        if i % 100 == 0:
            print(f"step {i:4d}  loss {loss.item():.3e}")
    last = loss.item()
    print(f"loss: {l0:.3e} -> {last:.3e}  ({l0 / last:.0f}x)")

    # 4) checkpoint + restore + held-out verification
    ckpt = workdir / "ckpt"
    params = {k: [p.detach() for p in v] for k, v in params.items()}
    save_checkpoint(ckpt, params, step=steps)
    params2 = restore_checkpoint(ckpt, template=params)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                 tree_leaves(params2)))
    ytest = torch.tensor([[0.8, -0.4], [-1.2, 0.3]], dtype=f64, device=device)
    with torch.no_grad():
        pred = odeint_fixed(nn_rhs, 0.0, dt, ytest, n_steps=64, args=params2)
        true = odeint_fixed(harmonic_rhs, 0.0, dt, ytest, n_steps=64,
                            args=1.0)
    err = float((pred - true).abs().max())
    print(f"held-out flow error after restore: {err:.2e}")
    if report is not None:
        report.update(loss0=l0, loss=last, err=err)
    assert err < 0.05
    return err


if __name__ == "__main__":
    main()
