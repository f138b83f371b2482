"""Minimum-TIME control of Van der Pol to the origin: free-final-time PMP
(the twin of ``examples/vdp_min_time.py``).

  minimize  J = tF
  s.t.      ẋ1 = x2,  ẋ2 = μ(1−x1²)x2 − x1 + u,  |u| ≤ umax,
            x(0) = x0, x(tF) = 0
  PMP:      H = 1 + p1·x2 + p2·(μ(1−x1²)x2 − x1 + u),
            u* = −umax·sign(p2)  → smoothed −umax·tanh(p2/ε) with an
            ε → 0 homotopy (the Dubins example's smoothing pattern),
            residual F(p0, tF) = [x1(tF), x2(tF), H(tF)].

A whole GRID of control bounds umax converges as ONE batch (the batch axis).
The Newton Jacobian comes from the solver's own derivatives, not finite
differences: the p0 columns from internal differentiation
(``solve_radau(tangents=e_k)``, the two costate seed directions through the
same accepted steps), the tF column from ∂y(tF)/∂tF = f(tF, y(tF)) (one rhs
evaluation). Each Levenberg–Marquardt iteration tries four damping levels
for every lane in ONE stacked residual solve of 4·M lanes and keeps the
first smallest |F| (``torch.argmin``, then a gather). Radau (s = 3) with
the pivoted stage LU, float64; the LM systems (3×3, 2×2) by the pivoted
``linalg.smalllu``.

  python3 -m janus_tpu_torch.examples.vdp_min_time
"""

import numpy as np
import torch

from janus_tpu_torch.linalg.smalllu import lu_factor, lu_solve
from janus_tpu_torch.solve import Options
from janus_tpu_torch.solve.common import default_device
from janus_tpu_torch.solve.radau import solve_radau

X0 = (1.0, 0.5)
MU = 1.0
N_LS = 4                      # backtracking candidates per Newton step
TF_MIN, TF_MAX = 0.3, 10.0
LAM_TRY = (0.1, 1.0, 10.0, 100.0)      # per-iteration damping candidates
EPS_LADDER = (1.0, 0.5, 0.2, 0.1, 0.05, 0.02)


def pmp_rhs(t, y, args):
    """y = [x1, x2, p1, p2]; u = −umax·tanh(p2/ε) (smoothed bang-bang)."""
    mu, umax, eps = args
    x1, x2, p1, p2 = y[..., 0], y[..., 1], y[..., 2], y[..., 3]
    u = -umax * torch.tanh(p2 / eps)
    return torch.stack([
        x2,
        mu * (1 - x1 ** 2) * x2 - x1 + u,
        p2 * (2 * mu * x1 * x2 + 1.0),
        -p1 - p2 * mu * (1 - x1 ** 2),
    ], dim=-1)


def hamiltonian(y, args):
    """Control-smoothed H = 1 + p·f(x, u*(p)); H(tF) = 0 is the free-tF
    transversality condition of a min-time problem."""
    mu, umax, eps = args
    x1, x2, p1, p2 = y[..., 0], y[..., 1], y[..., 2], y[..., 3]
    u = -umax * torch.tanh(p2 / eps)
    return 1.0 + p1 * x2 + p2 * (mu * (1 - x1 ** 2) * x2 - x1 + u)


def _y0(p0):
    m = p0.shape[0]
    x0 = torch.tensor([X0], dtype=p0.dtype, device=p0.device).repeat(m, 1)
    return torch.cat([x0, p0], dim=-1)


def _norm(f):
    return torch.sqrt(torch.sum(f ** 2, dim=-1))


def residual_and_jac(z, args, opts):
    """F(z) = [x1(tF), x2(tF), H(tF)] and its exact 3×3 Jacobian per lane.

    z [M, 3] = [p10, p20, tF]. Columns 0-1 from IND tangent sweeps, column 2
    from the endpoint velocity."""
    m = z.shape[0]
    p0, tf = z[:, :2], z[:, 2]
    y0 = _y0(p0)
    seeds = torch.zeros((2, m, 4), dtype=z.dtype, device=z.device)
    seeds[0, :, 2] = 1.0
    seeds[1, :, 3] = 1.0
    sol = solve_radau(pmp_rhs, 0.0, tf, y0, args=args, options=opts,
                      tangents=seeds)
    yT = sol.y                                             # [M, 4]
    f_T = pmp_rhs(tf, yT, args)                            # ∂y(tF)/∂tF
    h_T = hamiltonian(yT, args)
    mu_, umax_, eps_ = args
    um = torch.as_tensor(umax_, dtype=yT.dtype,
                         device=yT.device).broadcast_to((m,))
    h_grad = torch.func.vmap(torch.func.grad(
        lambda yy, ui: hamiltonian(yy, (mu_, ui, eps_))))(yT, um)

    def col(dy):                                           # [M, 4] -> [M, 3]
        return torch.stack([dy[:, 0], dy[:, 1],
                            torch.sum(h_grad * dy, dim=-1)], dim=-1)

    fvec = torch.stack([yT[:, 0], yT[:, 1], h_T], dim=-1)  # [M, 3]
    jac = torch.stack([col(sol.sens[0]), col(sol.sens[1]), col(f_T)],
                      dim=-1)                              # [M, 3, 3]
    return fvec, jac, sol


def residual(z, args, opts):
    """The residual only (no tangent sweeps): the line-search probe."""
    sol = solve_radau(pmp_rhs, 0.0, z[:, 2], _y0(z[:, :2]), args=args,
                      options=opts)
    return torch.stack([sol.y[:, 0], sol.y[:, 1],
                        hamiltonian(sol.y, args)], dim=-1)


def _clamp_tf(z):
    return torch.cat([z[:, :2], z[:, 2:].clamp(TF_MIN, TF_MAX)], dim=-1)


def _stacked_args(args, m, like):
    mu_, umax_, eps_ = args
    um = torch.as_tensor(umax_, dtype=like.dtype,
                         device=like.device).broadcast_to((m,))
    return (mu_, um.repeat(N_LS), eps_)


def lm_candidates(jac, fvec, lam, x, post=None):
    """The N_LS damped LM candidates x + (JᵀJ + λ_k·I)⁻¹(−Jᵀf), [L, M, n]
    for J [M, n, n] (pivoted LU)."""
    eye = torch.eye(jac.shape[-1], dtype=jac.dtype, device=jac.device)
    jtj = torch.einsum("mij,mik->mjk", jac, jac)
    jtf = torch.einsum("mij,mi->mj", jac, fvec)
    cands = []
    for lt in LAM_TRY:
        lk = lam * lt
        lu, piv = lu_factor(jtj + lk[:, None, None] * eye[None])
        c = x + lu_solve(lu, piv, -jtf)
        cands.append(c if post is None else post(c))
    return torch.stack(cands)


def pick_best(cands, fn_try, fn, x, lam):
    """Each lane's first smallest-|F| candidate, kept where it improves on
    |F| = fn; returns (x, lam) after the LM update of the damping."""
    fn_try = torch.where(torch.isfinite(fn_try), fn_try,
                         torch.full_like(fn_try, float("inf")))
    idx = torch.argmin(fn_try, dim=0)                               # [M]
    x_best = cands.gather(0, idx[None, :, None].expand(
        1, *cands.shape[1:]))[0]
    fn_best = fn_try.gather(0, idx[None])[0]
    lam_try = torch.tensor(LAM_TRY, dtype=lam.dtype, device=lam.device)
    lam_best = lam * lam_try[idx]
    improved = fn_best < fn
    x = torch.where(improved[:, None], x_best, x)
    lam = torch.clamp(torch.where(improved, 0.5 * lam_best, 10.0 * lam),
                      1e-8, 1e8)
    return x, lam


def newton_free_tf(z, args, opts, iters=25, tol=1e-9):
    """Batched Levenberg–Marquardt on the free-tF shooting system.

    Pure Newton on min-time shooting blows up (the residual has a spurious
    basin at tF → 0). Each iteration every lane tries N_LS damping levels
    λ·{0.1, 1, 10, 100}, all candidates evaluated in ONE stacked residual
    solve of N_LS·M lanes, keeps its best decrease and adapts its own λ;
    tF is clamped to [TF_MIN, TF_MAX]."""
    m = z.shape[0]
    args_ls = _stacked_args(args, m, z)
    lam = torch.full((m,), 1e-2, dtype=z.dtype, device=z.device)
    for _ in range(iters):
        fvec, jac, _ = residual_and_jac(z, args, opts)
        fn = _norm(fvec)
        if bool((fn < tol).all()):
            break
        cands = lm_candidates(jac, fvec, lam, z, post=_clamp_tf)
        f_try = residual(cands.reshape(N_LS * m, 3), args_ls,
                         opts).reshape(N_LS, m, 3)
        z, lam = pick_best(cands, _norm(f_try), fn, z, lam)
    fvec, _, sol = residual_and_jac(z, args, opts)
    return z, _norm(fvec), sol


def arrival_solve(p0, tf, args, opts, iters=20, tol=1e-10):
    """Phase 1: the FIXED-tF arrival problem x(tF) = 0 over p0 [M, 2], a
    tame 2×2 LM warm start for the free-tF system. Its Jacobian is the
    first two rows of the IND p-columns."""
    m = p0.shape[0]
    args_ls = _stacked_args(args, m, p0)
    lam = torch.full((m,), 1e-2, dtype=p0.dtype, device=p0.device)
    tf_col = torch.as_tensor(tf, dtype=p0.dtype,
                             device=p0.device).broadcast_to((m,))[:, None]
    for _ in range(iters):
        fvec3, jac3, _ = residual_and_jac(torch.cat([p0, tf_col], dim=-1),
                                          args, opts)
        fvec = fvec3[:, :2]
        jac = jac3[:, :2, :2]
        fn = _norm(fvec)
        if bool((fn < tol).all()):
            break
        cands = lm_candidates(jac, fvec, lam, p0)
        z_try = torch.cat([cands.reshape(N_LS * m, 2),
                           tf_col.repeat(N_LS, 1)], dim=-1)
        f_try = residual(z_try, args_ls, opts).reshape(N_LS, m, 3)[:, :, :2]
        p0, lam = pick_best(cands, _norm(f_try), fn, p0, lam)
    return p0


def solve_grid(umax_grid, eps_ladder=EPS_LADDER, rtol=1e-8, tf_warm=None):
    """Converge the whole umax grid [M] (a tensor) in ONE batch: the
    phase-1 fixed-tF arrival warm start, then the free-tF LM through an
    ε → 0 smoothing homotopy, each rung warm-starting the next. Returns
    (z [M, 3], |F| [M], the last rung's args)."""
    m = umax_grid.shape[0]
    like = umax_grid
    opts = Options(rtol=rtol, atol=rtol * 1e-3)
    if tf_warm is None:
        # a per-lane feasible arrival horizon, overestimated: ~1.25× an
        # empirical 1/umax² fit of the min time (below it phase 1 is
        # infeasible; a barely feasible start drops the free-tF LM into
        # the spurious tF→0 basin)
        tf_warm = 1.25 * (1.25 + 1.75 / umax_grid ** 2)
    tf_warm = torch.as_tensor(tf_warm, dtype=like.dtype, device=like.device)

    def eps_t(e):
        return torch.tensor(e, dtype=like.dtype, device=like.device)

    # phase 1 at the smoothest control
    args0 = (MU, umax_grid, eps_t(eps_ladder[0]))
    p_start = torch.tensor([[0.6, 0.6]], dtype=like.dtype,
                           device=like.device).repeat(m, 1)
    p0 = arrival_solve(p_start, tf_warm, args0, opts)
    z = torch.cat([p0, tf_warm.broadcast_to((m,))[:, None]], dim=-1)
    fn = None
    for eps in eps_ladder:
        args = (MU, umax_grid, eps_t(eps))
        z, fn, _ = newton_free_tf(z, args, opts)
    return z, fn, (MU, umax_grid, eps_t(eps_ladder[-1]))


def hamiltonian_samples(z, args, fracs=(0.25, 0.5, 0.75, 1.0)):
    """H along each lane's trajectory at fractions of its tF (rtol 1e-9,
    atol 1e-12), [len(fracs), M]: H is a first integral of the autonomous
    PMP flow."""
    opts = Options(rtol=1e-9, atol=1e-12)
    y0 = _y0(z[:, :2])
    return torch.stack([hamiltonian(solve_radau(
        pmp_rhs, 0.0, z[:, 2] * frac, y0, args=args, options=opts).y, args)
        for frac in fracs])


def main(device=None):
    """Returns (umax, tF, |F|, max |H| along the trajectories), the numbers
    the reference prints."""
    device = default_device(device)
    # grid floor 0.7: below ~0.65 the min time exceeds ~6 VdP windings and
    # the single-shooting system ill-conditions
    umax = torch.linspace(0.7, 2.0, 8, dtype=torch.float64, device=device)
    z, fn, args = solve_grid(umax)
    tf = z[:, 2].cpu().numpy()
    print("umax :", np.array2string(umax.cpu().numpy(), precision=3))
    print("tF   :", np.array2string(tf, precision=5))
    print("|F|  :", np.array2string(fn.cpu().numpy(), precision=2))
    assert np.all(np.diff(tf) < 0), "more control authority must be faster"

    # sanity: H is a first integral of the autonomous PMP flow
    h_max = float(hamiltonian_samples(z, args).abs().max())
    print("max |H| along trajectories:", h_max)
    return umax, z[:, 2], fn, h_max


if __name__ == "__main__":
    main()
