"""The CUDA kernels have no derivative rule: a derivative through them is
refused, never dropped.

K1/K2/K3 (and K4) launch through raw device pointers, so their results
would carry no tangent and no grad_fn, and a derivative through a
``kernel_lu=True`` solve on the card would be lost silently (the
reference's ``pallas_call`` has JVP and batching rules). The wrappers and
every solve's kernel_lu entry refuse such inputs with a ValueError that
names the kernel and the ways out: the IND sweep (``tangents=``) or the
plain route.

CPU: the guard itself sees a tensor that requires grad (with grad mode
on), a forward-AD dual and a ``torch.func``-wrapped tensor; on the CPU the
kernel route runs the differentiable twins, so nothing is refused there;
reverse mode through a plain Radau solve is finite and agrees with forward
mode (the step-size controller's unused ratio no longer sends 0 ** expo
into the tape).

On a CUDA card (marked ``gpu``; skipped where there is none; no jax is
imported, so it runs there with ``--noconftest``): ``torch.func.jvp``,
``torch.func.vmap`` over jvp, ``torch.autograd.forward_ad`` and
``.backward()`` through a kernel_lu=True Radau solve of 8 Van der Pol lanes
each raise the error before any kernel launch; the same four on the plain
route agree with central differences within 1e-6 (measured on the CPU:
3.5e-10 to 7.8e-10 at h = 1e-4, rtol 1e-10); and the multiple-shooting PMP
Newton of ``bench.control`` through K1/K2 equals the plain LU to the bit.
"""

import pytest
import torch
from torch.autograd import forward_ad as fwad

from janus_tpu_torch.bench import control as control_probe
from janus_tpu_torch.bench import mol
from janus_tpu_torch.control import newton_solve
from janus_tpu_torch.models.problems import vdp_jac, vdp_rhs
from janus_tpu_torch.ops.smalllu import derivative_carrier, refuse_derivatives
from janus_tpu_torch.solve import Options, solve_ivp

F64 = torch.float64
REFUSAL = "have no derivative rule"
TRANSFORMS = ("jvp", "vmap_jvp", "forward_ad", "backward")
FD_H = 1e-4
FD_BOUND = 1e-6


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _y_end(mu, kernel_lu, rtol=1e-10, atol=1e-12):
    """y(1) of Van der Pol lanes y0 = (2, 0) with parameter mu [M]."""
    y0 = torch.tensor([[2.0, 0.0]], dtype=F64,
                      device=mu.device).repeat(mu.shape[0], 1)
    return solve_ivp(vdp_rhs, (0.0, 1.0), y0, method="radau", args=mu,
                     jac=vdp_jac,
                     options=Options(rtol=rtol, atol=atol, pivoting=False,
                                     kernel_lu=kernel_lu)).y


def _derivative(transform, mu, kernel_lu, **kw):
    """dy(1)/dmu per lane (lanes are independent) by one of the four
    transforms: [M, 2] (for 'backward' the gradient of sum y(1)[:, 0],
    which per lane is dy0/dmu, in column 0 and column 1 left 0)."""
    ones = torch.ones_like(mu)

    def fn(m):
        return _y_end(m, kernel_lu, **kw)

    if transform == "jvp":
        return torch.func.jvp(fn, (mu,), (ones,))[1]
    if transform == "vmap_jvp":
        out = torch.func.vmap(lambda v: torch.func.jvp(fn, (mu,), (v,))[1])(
            torch.stack([ones, 2.0 * ones]))
        assert torch.equal(out[1], 2.0 * out[0])
        return out[0]
    if transform == "forward_ad":
        with fwad.dual_level():
            return fwad.unpack_dual(fn(fwad.make_dual(mu, ones))).tangent
    leaf = mu.clone().requires_grad_(True)
    fn(leaf)[:, 0].sum().backward()
    return torch.stack([leaf.grad, torch.zeros_like(leaf.grad)], dim=-1)


# ---- CPU ------------------------------------------------------------------

def test_guard_sees_every_derivative_carrier():
    t = torch.ones(3, dtype=F64)
    assert derivative_carrier(t) is None
    assert derivative_carrier(2.0) is None
    r = t.clone().requires_grad_(True)
    assert "requires grad" in derivative_carrier(r)
    with torch.no_grad():
        assert derivative_carrier(r) is None
    with fwad.dual_level():
        assert "forward-AD dual" in derivative_carrier(
            fwad.make_dual(t, torch.ones_like(t)))
    seen = []

    def look(x):
        seen.append(derivative_carrier(x))
        return x

    torch.func.jvp(look, (t,), (t,))
    torch.func.vmap(look)(t.reshape(3, 1))
    torch.func.grad(lambda x: look(x).sum())(t)
    assert len(seen) == 3 and all("torch.func" in s for s in seen), seen


def test_guard_raises_naming_the_kernel_and_the_ways_out():
    refuse_derivatives("K1", None, 1.0, {"a": [torch.ones(2)]})
    with pytest.raises(ValueError, match=r"lu_solve_t \(K2\): an input "
                       r"requires grad.*no derivative rule.*tangents=.*"
                       r"kernel_lu=False"):
        refuse_derivatives("lu_solve_t (K2)",
                           {"a": [torch.ones(2, requires_grad=True)]})


def test_cpu_kernel_route_carries_derivatives_like_the_plain_route():
    """On the CPU the kernel route runs the twins, which are plain torch:
    jvp through kernel_lu=True equals jvp through the plain LU (the same
    pivot-free arithmetic)."""
    mu = torch.tensor([1.0, 3.0], dtype=F64)
    got = _derivative("jvp", mu, True, rtol=1e-6, atol=1e-9)
    want = _derivative("jvp", mu, False, rtol=1e-6, atol=1e-9)
    assert torch.equal(got, want)


def test_reverse_mode_through_a_plain_radau_solve_is_finite():
    """.backward() through a plain Radau solve agrees with forward mode
    (it was NaN: 0 ** expo in the controller's unselected branch)."""
    mu = torch.tensor([1.0, 3.0], dtype=F64)
    rev = _derivative("backward", mu, False, rtol=1e-6, atol=1e-9)
    fwd = _derivative("jvp", mu, False, rtol=1e-6, atol=1e-9)
    assert torch.isfinite(rev).all()
    torch.testing.assert_close(rev[:, 0], fwd[:, 0], rtol=1e-12, atol=1e-14)


# ---- on the card ----------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("transform", TRANSFORMS)
def test_kernel_route_refuses_derivatives_on_card(transform):
    dev = _card()
    mu = torch.linspace(1.0, 5.0, 8, dtype=F64, device=dev)
    mol._reset_kernel_launches()
    with pytest.raises(ValueError, match=REFUSAL):
        _derivative(transform, mu, True)
    assert not any(mol._kernel_launches().values()), \
        "the refusal must come before any kernel launch"


@pytest.mark.gpu
@pytest.mark.parametrize("transform", TRANSFORMS)
def test_plain_route_derivatives_on_card(transform):
    dev = _card()
    mu = torch.linspace(1.0, 5.0, 8, dtype=F64, device=dev)
    fd = (_y_end(mu + FD_H, False) - _y_end(mu - FD_H, False)) / (2 * FD_H)
    got = _derivative(transform, mu, False)
    cols = slice(0, 1) if transform == "backward" else slice(None)
    err = float((got[:, cols] - fd[:, cols]).abs().max())
    assert err <= FD_BOUND, err


@pytest.mark.gpu
def test_shooting_newton_through_kernels_equals_plain_lu_on_card():
    """bench.control's IND Newton at 256 instances: K1/K2 launched, x,
    iters and fnorm equal to the bit to the plain pivot-free LU; the AD
    Jacobian through kernel_lu=True refused."""
    dev = _card()
    mu = control_probe.mus(256, dev)
    mol._reset_kernel_launches()
    got = control_probe.ind_newton(mu, True)
    launches = mol._kernel_launches()
    want = control_probe.ind_newton(mu, False)
    assert launches["K1"] > 0 and launches["K2"] > 0, launches
    assert bool(got.converged.all())
    for what in ("x", "iters", "fnorm"):
        assert torch.equal(getattr(got, what), getattr(want, what)), what
    with pytest.raises(ValueError, match=REFUSAL):
        newton_solve(control_probe.ms_residual(mu[:2], True),
                     control_probe.z0(2, dev))
