"""Learned continuation-step controller (the twin of
``examples/learned_continuation.py``, the reference's SSSC-ML workload).

1. DATA: for a training family of problem instances, probe in ONE batched
   Newton correction over (instance × λ-grid × candidate-Δλ) lanes which
   candidate steps the corrector survives; label = largest safe Δλ.
2. IO: write and read the dataset through the native binary store
   (``native.traj_write``).
3. TRAIN: a small MLP (``models.neural``, float32) maps the features
   (λ, instance parameter) to log Δλ_max, with Adam (lr 1e-2).
4. CLOSE THE LOOP: ``homotopy(dlam_fn=...)`` consults the trained policy
   after every accepted point; on held-out instances it takes FEWER
   continuation steps than the fixed-Δλ schedule.

Problem family: the convex homotopy G(x,λ) = λF(x) + (1−λ)(x−x₀) on
F(x) = [x₁ − a·e^{0.45·x₂}, x₂ − a·e^{0.45·x₁}] (the fold sits at
a ≈ 0.82; a ∈ [0.1, 0.8] spans easy to hard). The states are float64.

  python3 -m janus_tpu_torch.examples.learned_continuation
"""

import tempfile
from pathlib import Path

import numpy as np
import torch

from janus_tpu_torch import native
from janus_tpu_torch.control.homotopy import convex_homotopy, homotopy
from janus_tpu_torch.control.newton import fd_or_ad_jacobian
from janus_tpu_torch.linalg.smalllu import lu_factor, lu_ok, lu_solve
from janus_tpu_torch.models.neural import mlp_apply, mlp_init
from janus_tpu_torch.solve.common import default_device, tree_leaves

TOL = 1e-5   # the reference's f32-honest tolerance (residual floor ~2e-7)
CANDS = np.array([0.02, 0.04, 0.07, 0.12, 0.2, 0.3, 0.45, 0.7, 1.0])


def family_g(c):
    """Convex-homotopy residual for per-lane exponential instances a [M]."""
    def f(x):
        x1, x2 = x[..., 0], x[..., 1]
        return torch.stack([x1 - c * torch.exp(0.45 * x2),
                            x2 - c * torch.exp(0.45 * x1)], dim=-1)
    return convex_homotopy(f, torch.zeros((c.shape[0], 2), dtype=c.dtype,
                                          device=c.device))


def corrector_survives(g, x, lam, iters=3):
    """One batched fixed-iteration Newton correction; True where it lands."""
    for _ in range(iters):
        jm = fd_or_ad_jacobian(lambda z: g(z, lam), x, "ad")
        lu, piv = lu_factor(jm)
        ok = lu_ok(lu)
        step = lu_solve(lu, piv, -g(x, lam))
        x = x + torch.where(ok[:, None], step, 0.0)
    res = torch.linalg.vector_norm(g(x, lam), dim=-1)
    return x, torch.isfinite(res) & (res < TOL)


def generate_dataset(cs, n_lam=12, device=None):
    """Probe Δλ_max over (instance, λ, candidate) in one batched sweep;
    returns (features [n, 2], log labels [n]) as numpy arrays."""
    device = default_device(device)
    f64 = torch.float64
    n_inst = cs.shape[0]
    lams = np.linspace(0.0, 0.95, n_lam)
    # corrected base points x(λ, c): walk each instance up the λ ladder
    g = family_g(torch.as_tensor(cs, dtype=f64, device=device))
    xs = [torch.zeros((n_inst, 2), dtype=f64, device=device)]
    for lam in lams[1:]:
        x, _ = corrector_survives(g, xs[-1], torch.full(
            (n_inst,), lam, dtype=f64, device=device))
        xs.append(x)
    xs = torch.stack(xs, dim=1)                   # [n_inst, n_lam, 2]

    # flatten (instance, λ, candidate) into ONE batched trial correction
    nc = len(CANDS)
    big_c = torch.as_tensor(np.repeat(cs, n_lam * nc), dtype=f64,
                            device=device)
    big_x = xs[:, :, None, :].expand(n_inst, n_lam, nc, 2).reshape(-1, 2)
    big_lam = torch.as_tensor(np.minimum(
        lams[None, :, None] + CANDS[None, None, :], 1.0)
        .repeat(n_inst, axis=0).reshape(-1), dtype=f64, device=device)
    _, ok = corrector_survives(family_g(big_c), big_x, big_lam)
    ok = ok.cpu().numpy().reshape(n_inst, n_lam, nc)

    feats, labels = [], []
    for i in range(n_inst):
        for j, lam in enumerate(lams):
            good = CANDS[ok[i, j]]
            label = good.max() if good.size else CANDS[0] * 0.5
            feats.append([lam, cs[i]])
            labels.append(np.log(label))
    return np.asarray(feats), np.asarray(labels)


def train_policy(feats, labels, seed=0, steps=500, device=None):
    """The float32 MLP policy [2, 16, 16, 1] fit to the labels; returns
    (params, final loss)."""
    device = default_device(device)
    params = mlp_init([2, 16, 16, 1], torch.Generator().manual_seed(seed),
                      torch.float32, device)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_()
    x = torch.as_tensor(feats, dtype=torch.float32, device=device)
    y = torch.as_tensor(labels, dtype=torch.float32, device=device)
    opt = torch.optim.Adam(leaves, lr=1e-2)
    for _ in range(steps):
        opt.zero_grad()
        loss = torch.mean((mlp_apply(params, x)[:, 0] - y) ** 2)
        loss.backward()
        opt.step()
    return {k: [p.detach() for p in v] for k, v in params.items()}, \
        loss.item()


def policy(params, ct):
    """The learned Δλ policy for homotopy(dlam_fn=...) on instances ct:
    the predicted Δλ_max at the new point, with a safety margin."""
    def dlam_policy(x, lam, dlam):
        f = torch.stack([lam, ct], dim=-1).to(torch.float32)
        pred = torch.exp(mlp_apply(params, f)[:, 0]).to(x.dtype)
        return 0.8 * pred
    return dlam_policy


def main(device=None):
    """Returns the (fixed, reactive, learned) homotopy results on the 16
    held-out instances; asserts that the learned policy converges on all of
    them in fewer mean steps than the fixed schedule. Runs on ``device``:
    the CUDA card unless the caller asks for another."""
    device = default_device(device)
    rng = np.random.default_rng(0)
    cs_train = rng.uniform(0.1, 0.8, size=48)
    cs_test = np.linspace(0.15, 0.79, 16)

    feats, labels = generate_dataset(cs_train, device=device)
    # dataset round-trip through the native binary store
    recs = np.concatenate([feats, labels[:, None]], axis=1)
    with tempfile.TemporaryDirectory(prefix="janus_sssc_") as tmp:
        path = Path(tmp) / "sssc_ml_dataset.bin"
        native.traj_write(path, recs)
        back = native.traj_read(path)
    assert np.allclose(back, recs)
    feats, labels = back[:, :2], back[:, 2]
    print(f"dataset: {len(labels)} probes  (Δλ_max range "
          f"{np.exp(labels).min():.3f}..{np.exp(labels).max():.3f})")

    params, final_loss = train_policy(feats, labels, device=device)
    print(f"policy trained, mse(log Δλ) = {final_loss:.4f}")

    ct = torch.as_tensor(cs_test, dtype=torch.float64, device=device)
    g_test = family_g(ct)
    x0 = torch.zeros((len(cs_test), 2), dtype=torch.float64, device=device)

    r_fixed = homotopy(g_test, x0, dlam0=0.05, tol=TOL,
                       dlam_fn=lambda x, lam, d: torch.full_like(d, 0.05))
    r_react = homotopy(g_test, x0, dlam0=0.05, tol=TOL)
    r_ml = homotopy(g_test, x0, dlam0=0.05, tol=TOL,
                    dlam_fn=policy(params, ct))

    for name, r in [("fixed Δλ=0.05", r_fixed),
                    ("reactive 1.5x/0.5x", r_react),
                    ("learned policy", r_ml)]:
        print(f"{name:22s}: converged {int(r.converged.sum())}/"
              f"{len(cs_test)}, mean steps "
              f"{float(r.iters.double().mean()):.1f}")
    assert bool(r_ml.converged.all())
    assert float(r_ml.iters.double().mean()) < float(
        r_fixed.iters.double().mean())
    print("learned policy beats the fixed schedule")
    return r_fixed, r_react, r_ml


if __name__ == "__main__":
    main()
