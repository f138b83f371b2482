"""The port's continuous adjoint ``radau_adjoint`` against itself, on the CPU
in float64, without the reference (the cases are those of
``test_torch_adjoint.py``).

Every mode's gradient along one random direction per input against the
central difference of the port's own forward solve, to 1e-5 relative at rtol
1e-8, and against the IND tangents of ``solve_radau(tangents=)`` to 1e-4
(the continuous adjoint differs from the derivative of the discrete solve by
the mesh's local error, which the controller bounds by rtol; IND's tangent
iteration stops at the Newton tolerance); ``checkpoints=`` against the
unsegmented gradient; NaN poisoning on mesh overflow; and the Function's
plumbing: arguments that are no tensors, integer leaves, a leaf that f
broadcasts, scalar and per-lane t0/tf, a [D] y0, the sample times of t_eval
mode, backward twice over one graph.
"""

import numpy as np
import pytest
import torch

from janus_tpu_torch.models.problems import vdp_jac, vdp_rhs
from janus_tpu_torch.solve import (Options, radau_adjoint, solve_adjoint,
                                   solve_radau)
from janus_tpu_torch.solve.adjoint import _split_diff, constrained_ydot
from test_torch_adjoint import (_case_checkpoints, _case_dae, _case_line,
                                _case_mass, _case_reverse, _case_t_eval_cost,
                                _case_terminal, _dae_inputs, _line_inputs,
                                _rob_dae, _vdp_inputs)

torch.set_num_threads(1)

FD_OPTS = Options(rtol=1e-8, atol=1e-11, adjoint_steps=256)


def _fd_check(loss_of, p, tol=1e-5, eps=1e-6):
    """loss_of(p) with p a dict of float64 tensors: for every input, the
    gradient from backward() along one random direction against the central
    difference of the loss along it (two solves per input)."""
    q = {n: v.clone().requires_grad_() for n, v in p.items()}
    loss_of(q).backward()
    rng = np.random.default_rng(3)
    for n, v in p.items():
        g = q[n].grad
        assert g is not None and g.shape == v.shape, n
        assert bool(torch.isfinite(g).all()), n
        d = torch.from_numpy(rng.standard_normal(tuple(v.shape)))
        with torch.no_grad():
            fd = float(loss_of({**p, n: v + eps * d})
                       - loss_of({**p, n: v - eps * d})) / (2 * eps)
        got = float((g * d).sum())
        assert abs(got - fd) <= tol * max(abs(fd), float(g.abs().max())), (
            n, got, fd)
    return q


def _tens(d):
    return {n: torch.tensor(v, dtype=torch.float64) for n, v in d.items()}


FD_CASES = {
    "terminal-t0-tf": (_case_terminal,
                       {**_vdp_inputs(3), "t0": np.float64(0.1),
                        "tf": np.float64(1.1)}, {}),
    "t_eval-cost": (_case_t_eval_cost, _vdp_inputs(2), {}),
    "mass": (_case_mass, _vdp_inputs(2), {}),
    "dae-n_alg": (_case_dae, _dae_inputs(), {}),
    "checkpoints-cost": (_case_checkpoints, _vdp_inputs(2), {}),
    "reverse-time": (_case_reverse, _vdp_inputs(2, 5.0), {}),
    "line-tridiag": (_case_line, _line_inputs(),
                     dict(stage_solver="tridiag")),
}


@pytest.mark.parametrize("name", list(FD_CASES))
def test_gradient_matches_central_differences(name):
    case, inputs, okw = FD_CASES[name]
    opts = FD_OPTS.replace(**okw)
    _fd_check(lambda p: case(torch, radau_adjoint, opts, p)[0], _tens(inputs))


def test_gradient_matches_ind_tangents():
    """⟨∂L/∂y0, v⟩ + ⟨∂L/∂μ, w⟩ against the IND directional derivative of
    the same solve (``solve_radau(tangents=, args_tangents=)``)."""
    inp = _tens(_vdp_inputs(3))
    rng = np.random.default_rng(5)
    v = torch.from_numpy(rng.standard_normal((1, 3, 2)))
    w = torch.from_numpy(rng.standard_normal((1, 3)))
    y0 = inp["y0"].clone().requires_grad_()
    mu = inp["mu"].clone().requires_grad_()
    y = radau_adjoint(vdp_rhs, (0.0, 1.0), y0, args=mu, options=FD_OPTS,
                      jac=vdp_jac)
    (y ** 2).sum().backward()
    sol = solve_radau(vdp_rhs, 0.0, 1.0, inp["y0"], args=inp["mu"],
                      options=FD_OPTS, jac=vdp_jac, tangents=v,
                      args_tangents=w)
    torch.testing.assert_close(y.detach(), sol.y, rtol=0, atol=0)
    ind = float((2 * sol.y * sol.sens[0]).sum())
    got = float((y0.grad * v[0]).sum() + (mu.grad * w[0]).sum())
    assert abs(got - ind) <= 1e-4 * abs(ind), (got, ind)


def test_checkpoints_reproduce_the_unsegmented_gradient():
    """checkpoints=C chains C segments, so its primal is the chained solve;
    its gradient equals the unsegmented adjoint's to O(rtol), with
    adjoint_steps sized per segment, too small for the whole span."""
    inp = _tens(_vdp_inputs(3))

    def grads(opts, **kw):
        y0 = inp["y0"].clone().requires_grad_()
        mu = inp["mu"].clone().requires_grad_()
        y = radau_adjoint(vdp_rhs, (0.0, 2.0), y0, args=mu, options=opts,
                          **kw)
        (y ** 2).sum().backward()
        return y.detach(), y0.grad, mu.grad

    full = grads(FD_OPTS)
    # measured: 161/190/166 accepted steps over the span, at most 171 in a
    # segment
    seg = grads(FD_OPTS.replace(adjoint_steps=180), checkpoints=4)
    for a, b in zip(seg, full):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-8)
    # the whole span does not fit the per-segment budget
    assert not bool(torch.isfinite(
        grads(FD_OPTS.replace(adjoint_steps=180))[1]).any())


def test_mesh_overflow_poisons_every_gradient():
    inp = _tens({**_vdp_inputs(3), "tf": np.float64(1.0)})
    q = {n: v.clone().requires_grad_() for n, v in inp.items()}
    y = radau_adjoint(vdp_rhs, (0.0, q["tf"]), q["y0"], args=q["mu"],
                      options=Options(rtol=1e-6, atol=1e-9, adjoint_steps=8))
    assert bool(torch.isfinite(y).all())          # the primal is untouched
    (y ** 2).sum().backward()
    for n in q:
        assert bool(torch.isnan(q[n].grad).all()), n


# ---- the Function's plumbing ----------------------------------------------

def _mixed_rhs(t, y, args):
    """args = {"k": per-lane [M, 1] tensor (broadcast over D), "n": an
    integer tensor, "c": a Python float, "s": a 0-dim tensor}."""
    return -(args["k"] * args["c"] + args["s"]) * y ** args["n"]


def test_args_that_are_no_float_tensors_pass_through():
    m = 3
    rng = np.random.default_rng(9)
    args = {"k": torch.from_numpy(1.0 + rng.random((m, 1))),
            "n": torch.tensor(1), "c": 0.5,
            "s": torch.tensor(0.25, dtype=torch.float64)}
    dleaves, rebuild, leaves, diff_idx = _split_diff(args)
    assert [leaves[i] is x for i, x in zip(diff_idx, dleaves)] == [True] * 2
    assert rebuild(dleaves)["c"] == 0.5 and rebuild(dleaves)["n"] is args["n"]
    y0 = torch.from_numpy(1.0 + rng.random((m, 2)))
    opts = Options(rtol=1e-9, atol=1e-12, adjoint_steps=256)

    def loss_of(p):
        a = {**args, "k": p["k"], "s": p["s"]}
        y = solve_adjoint(_mixed_rhs, (0.0, 1.0), p["y0"], method="radau5",
                          args=a, options=opts)
        return (y ** 2).sum()

    q = _fd_check(loss_of, {"y0": y0, "k": args["k"], "s": args["s"]})
    # the broadcast leaf and the 0-dim leaf get cotangents of their own shape
    assert q["k"].grad.shape == (m, 1) and q["s"].grad.shape == ()
    # closed form: y(1) = y0·exp(−(k/2 + s)), L = Σ y(1)²
    want = 2 * y0 * torch.exp(-2 * (0.5 * args["k"] + args["s"]))
    torch.testing.assert_close(q["y0"].grad, want, rtol=1e-7, atol=0)


def test_scalar_and_per_lane_times_and_a_single_trajectory():
    opts = Options(rtol=1e-9, atol=1e-12, adjoint_steps=64)

    def decay(t, y, k):
        return -(k[:, None] if isinstance(k, torch.Tensor) else k) * y

    k = torch.tensor([1.0, 2.0], dtype=torch.float64)
    y0 = torch.tensor([[1.0], [3.0]], dtype=torch.float64)
    # y(tf) = y0·exp(−k (tf − t0)): dL/dtf = −2k·y², dL/dt0 = +2k·y²
    yf = y0[:, 0] * torch.exp(-k * 0.5)
    for t0, tf in ((torch.tensor(0.25, dtype=torch.float64),
                    torch.tensor(0.75, dtype=torch.float64)),
                   (torch.tensor([0.25, 0.25], dtype=torch.float64),
                    torch.tensor([0.75, 0.75], dtype=torch.float64))):
        t0, tf = t0.requires_grad_(), tf.requires_grad_()
        y = radau_adjoint(decay, (t0, tf), y0, args=k, options=opts)
        (y ** 2).sum().backward()
        per_lane = 2 * k * yf ** 2
        want = per_lane.sum() if t0.ndim == 0 else per_lane
        assert tf.grad.shape == tf.shape and t0.grad.shape == t0.shape
        torch.testing.assert_close(tf.grad, -want, rtol=1e-7, atol=0)
        torch.testing.assert_close(t0.grad, want, rtol=1e-7, atol=0)
    # Python-number times and a [D] y0: nothing to differentiate but y0
    y1 = torch.tensor([1.5], dtype=torch.float64, requires_grad=True)
    y = radau_adjoint(decay, (0.0, 0.5), y1, args=2.0, options=opts)
    assert y.shape == (1, 1)
    y.sum().backward()
    assert y1.grad.shape == (1,)
    torch.testing.assert_close(y1.grad, torch.exp(torch.tensor([-1.0])).double(),
                               rtol=1e-7, atol=0)
    # backward twice over one graph (retain_graph) gives the same gradient
    y2 = y0.clone().requires_grad_()
    out = radau_adjoint(decay, (0.0, 0.5), y2, args=k, options=opts).sum()
    g1, = torch.autograd.grad(out, y2, retain_graph=True)
    g2, = torch.autograd.grad(out, y2)
    torch.testing.assert_close(g1, g2, rtol=0, atol=0)


def test_sample_time_gradient_in_t_eval_mode():
    """d/dt_j of Σ_j y(t_j)² for y' = −k y is −2k·y(t_j)² per sample."""
    opts = Options(rtol=1e-9, atol=1e-12, adjoint_steps=64)
    k = torch.tensor([1.0, 2.0], dtype=torch.float64)
    y0 = torch.tensor([[1.0], [3.0]], dtype=torch.float64)
    ts = torch.tensor([0.3, 0.6, 1.0], dtype=torch.float64,
                      requires_grad=True)
    ys = radau_adjoint(lambda t, y, kk: -kk[:, None] * y, (0.0, 1.0), y0,
                       args=k, options=opts, t_eval=ts)
    assert ys.shape == (2, 3, 1)
    (ys ** 2).sum().backward()
    want = (-2 * k[:, None] * (y0 * torch.exp(-k[:, None] * ts.detach())) ** 2
            ).sum(0)
    torch.testing.assert_close(ts.grad, want, rtol=1e-6, atol=0)


def test_constrained_ydot_threads_pivot():
    """ẏ of the Robertson DAE: the constraint's derivative vanishes along
    it, with and without pivoting in the small dense factorizations."""
    inp = _tens(_dae_inputs())
    xd = inp["x0"]
    y = torch.cat([xd, (1.0 - xd.sum(-1))[:, None]], -1)
    k = {n: inp[n] for n in ("k1", "k2", "k3")}
    mass = torch.diag(torch.tensor([2.0, 1.0, 0.0], dtype=torch.float64))
    t = torch.zeros(2, dtype=torch.float64)
    fa = lambda tt, yy, dl: _rob_dae(torch)(tt, yy, dl)   # noqa: E731
    outs = [constrained_ydot(fa, t, y, k, mass, 1, pivot=piv)
            for piv in (True, False)]
    f = fa(t, y, k)
    for yd in outs:
        torch.testing.assert_close(yd[:, 0], f[:, 0] / 2.0)
        torch.testing.assert_close(yd[:, 1], f[:, 1])
        torch.testing.assert_close(yd.sum(-1), torch.zeros(2).double(),
                                   atol=1e-14, rtol=0)
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-13, atol=1e-15)
