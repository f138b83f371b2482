"""Where the port's entry points put their arrays, on the CPU.

A torch tensor keeps its device. Anything else (a numpy array, a list) goes
to the CUDA card unless the caller asks for another device with
``device="cpu"``; with no card and no such request the entry points raise
ValueError instead of running on the CPU. The card is hidden here by
monkeypatching ``torch.cuda.is_available``, so the tests behave the same on
a machine that has one. A solve of a numpy y0 with ``device="cpu"`` equals
the solve of the same y0 as a CPU tensor exactly. The matrix-free stage
solvers, ``mass=`` and the adjoint entry points follow the same rule, and a
mass on another device than y0 is refused. No module of the package imports jax or the JAX package
(a walk over its sources).
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from janus_tpu_torch.interop import tree_to_torch
from janus_tpu_torch.models.problems import vdp_rhs
from janus_tpu_torch.solve import common as cm
from janus_tpu_torch.solve import (Options, radau_adjoint, solve_adjoint,
                                   solve_ivp, solve_radau, solve_radau_fused)

torch.set_num_threads(1)

Y0 = np.array([[2.0, 0.0], [1.5, 0.1], [2.0, -0.2]])
KW = dict(args=50.0, rtol=1e-6, atol=1e-9)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _equal(a, b):
    assert a.y.device.type == b.y.device.type == "cpu"
    torch.testing.assert_close(a.y, b.y, rtol=0, atol=0)
    torch.testing.assert_close(a.status, b.status, rtol=0, atol=0)


@pytest.mark.parametrize("method", ["radau5", "radau9", "radau_fused"])
def test_numpy_y0_with_device_cpu_solves_on_the_cpu(method, no_card):
    got = solve_ivp(vdp_rhs, (0.0, 1.0), Y0, method=method, device="cpu",
                    **KW)
    ref = solve_ivp(vdp_rhs, (0.0, 1.0), torch.from_numpy(Y0), method=method,
                    **KW)
    assert bool((ref.status == 1).all())
    _equal(got, ref)


def test_solvers_take_device(no_card):
    opts = Options(rtol=1e-6, atol=1e-9)
    for solve in (solve_radau, solve_radau_fused):
        got = solve(vdp_rhs, 0.0, 1.0, Y0, 50.0, opts, device="cpu")
        ref = solve(vdp_rhs, 0.0, 1.0, torch.from_numpy(Y0), 50.0, opts)
        _equal(got, ref)


@pytest.mark.parametrize("entry", ["radau5", "radau_fused", "solve_radau",
                                   "solve_radau_fused"])
def test_numpy_y0_without_card_raises(entry, no_card):
    with pytest.raises(ValueError, match="pass y0 as a CPU tensor"):
        if entry.startswith("solve_"):
            solve = {"solve_radau": solve_radau,
                     "solve_radau_fused": solve_radau_fused}[entry]
            solve(vdp_rhs, 0.0, 1.0, Y0, 50.0)
        else:
            solve_ivp(vdp_rhs, (0.0, 1.0), Y0, method=entry, **KW)


def _decay(t, y, args):
    return -args * y


MATRIX_FREE = {
    "tridiag": dict(stage_solver="tridiag"),
    "gmres": dict(stage_solver="gmres", gmres_iters=4),
    "gmres-lines": dict(stage_solver="gmres", gmres_iters=4, precond="lines",
                        precond_block=2),
    "gmres-block": dict(stage_solver="gmres", gmres_iters=4, precond="block",
                        precond_block=2),
    "mass": dict(mass=np.diag([1.0, 2.0])),
    "mass-gmres": dict(mass=np.diag([1.0, 2.0]), stage_solver="gmres",
                       gmres_iters=4),
}


@pytest.mark.parametrize("case", list(MATRIX_FREE))
def test_matrix_free_and_mass_obey_the_device_rule(case, no_card):
    kw = dict(MATRIX_FREE[case], args=3.0, rtol=1e-6, atol=1e-9)
    with pytest.raises(ValueError, match="pass y0 as a CPU tensor"):
        solve_ivp(_decay, (0.0, 1.0), Y0, method="radau5", **kw)
    got = solve_ivp(_decay, (0.0, 1.0), Y0, method="radau5", device="cpu",
                    **kw)
    ref = solve_ivp(_decay, (0.0, 1.0), torch.from_numpy(Y0),
                    method="radau5", **kw)
    assert bool((ref.status == 1).all())
    _equal(got, ref)


@pytest.mark.parametrize("entry", ["radau_adjoint", "solve_adjoint"])
def test_adjoint_obeys_the_device_rule(entry, no_card):
    adj = {"radau_adjoint": radau_adjoint, "solve_adjoint": solve_adjoint}[
        entry]
    kw = dict(args=torch.tensor(3.0, dtype=torch.float64, requires_grad=True),
              options=Options(rtol=1e-6, atol=1e-9, adjoint_steps=64))
    with pytest.raises(ValueError, match="pass y0 as a CPU tensor"):
        adj(_decay, (0.0, 1.0), Y0, **kw)
    got = adj(_decay, (0.0, 1.0), Y0, device="cpu", **kw)
    ref = adj(_decay, (0.0, 1.0), torch.from_numpy(Y0), **kw)
    assert got.device.type == "cpu" and got.requires_grad
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    got.sum().backward()
    assert kw["args"].grad.device.type == "cpu"
    assert bool(torch.isfinite(kw["args"].grad))
    with pytest.raises(ValueError, match="the device is taken from y0"):
        adj(_decay, (0.0, 1.0), torch.from_numpy(Y0), mass=torch.eye(
            2, dtype=torch.float64, device="meta"), **kw)


def test_mass_on_another_device_is_refused(no_card):
    with pytest.raises(ValueError, match="the device is taken from y0"):
        solve_ivp(_decay, (0.0, 1.0), torch.from_numpy(Y0), method="radau5",
                  args=3.0, mass=torch.eye(2, dtype=torch.float64,
                                           device="meta"))


def test_no_module_of_the_port_imports_jax():
    root = pathlib.Path(__file__).resolve().parents[1]
    sources = sorted((root / "janus_tpu_torch").rglob("*.py"))
    sources.append(root / "chip_smoke.py")
    assert len(sources) > 15
    names = {str(p.relative_to(root)) for p in sources}
    for module in ("solve/dopri.py", "solve/adjoint_dopri.py",
                   "solve/discrete.py", "solve/hvp.py", "diag/record.py",
                   "linalg/qr.py", "models/neural.py", "bench/dopri.py",
                   "solve/ndf.py", "solve/adjoint_ndf.py", "bench/ndf.py",
                   "solve/seulex.py", "solve/adjoint_seulex.py",
                   "bench/seulex.py", "solve/radaup.py", "solve/bdf.py",
                   "solve/rosenbrock.py", "solve/fixed.py",
                   "bench/radaup.py"):
        assert f"janus_tpu_torch/{module}" in names, module
    pattern = re.compile(r"^\s*(import|from)\s+(jax|janus_tpu)([.\s]|$)",
                         re.MULTILINE)
    for path in sources:
        hit = pattern.search(path.read_text())
        assert hit is None, f"{path.relative_to(root)}: {hit.group(0)!r}"


def test_default_device_is_the_card_when_there_is_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert cm.default_device() == torch.device("cuda")
    assert cm.default_device("cpu") == torch.device("cpu")


def test_tensor_keeps_its_device_and_refuses_another(no_card):
    y0 = torch.from_numpy(Y0)
    assert cm.on_device(y0) is y0 and cm.on_device(y0, "cpu") is y0
    with pytest.raises(ValueError, match="not copied"):
        cm.on_device(y0, "meta")
    with pytest.raises(ValueError, match="not copied"):
        solve_ivp(vdp_rhs, (0.0, 1.0), y0, method="radau5", device="meta",
                  **KW)


def test_tree_to_torch_device(no_card):
    tree = {"a": np.ones(3), "b": [np.zeros((2, 2)), 1.5, None], "c": (7,)}
    got = tree_to_torch(tree, device="cpu", dtype=torch.float32)
    assert got["a"].device.type == "cpu" and got["a"].dtype == torch.float32
    assert got["b"][0].device.type == "cpu" and got["b"][1:] == [1.5, None]
    assert got["c"] == (7,)
    assert tree_to_torch(None) is None and tree_to_torch({"x": 2.0}) == {
        "x": 2.0}
    with pytest.raises(ValueError, match="no CUDA device"):
        tree_to_torch(tree)


@pytest.mark.parametrize("entry", ["dopri5", "dopri853", "dopri_adjoint",
                                   "radau_hvp"])
def test_explicit_family_and_hvp_obey_the_device_rule(entry, no_card):
    """A numpy y0 raises with no card, solves on the CPU with device="cpu",
    and equals the same solve of a CPU tensor."""
    from janus_tpu_torch.solve import dopri_adjoint, radau_hvp
    y0 = Y0[:, :1]
    if entry in ("dopri5", "dopri853"):
        def run(y, **kw):
            return solve_ivp(_decay, (0.0, 1.0), y, method=entry, args=3.0,
                             rtol=1e-6, atol=1e-9, **kw).y
    elif entry == "dopri_adjoint":
        def run(y, **kw):
            return dopri_adjoint(_decay, (0.0, 1.0), y, args=3.0, **kw)
    else:
        def run(y, **kw):
            (h, _), _ = radau_hvp(
                _decay, (0.0, 1.0), y, torch.tensor(3.0, dtype=torch.float64),
                loss=lambda yT, a: torch.sum(yT ** 2),
                v_y0=np.ones_like(y0), **kw)
            return h
    with pytest.raises(ValueError, match="pass y0 as a CPU tensor"):
        run(y0)
    got = run(y0, device="cpu")
    assert got.device.type == "cpu"
    torch.testing.assert_close(got, run(torch.from_numpy(y0)), rtol=0,
                               atol=0)


@pytest.mark.parametrize("entry", ["bdf", "ndf_adjoint"])
def test_ndf_family_obeys_the_device_rule(entry, no_card):
    """A numpy y0 raises with no card, solves on the CPU with device="cpu",
    and equals the same solve of a CPU tensor."""
    from janus_tpu_torch.solve import ndf_adjoint
    if entry == "bdf":
        def run(y, **kw):
            return solve_ivp(_decay, (0.0, 1.0), y, method="bdf", args=3.0,
                             rtol=1e-6, atol=1e-9, **kw).y
    else:
        def run(y, **kw):
            return ndf_adjoint(_decay, (0.0, 1.0), y, args=3.0, **kw)
    _obeys_the_device_rule(run)


@pytest.mark.parametrize("entry", ["seulex", "seulex_adjoint"])
def test_seulex_family_obeys_the_device_rule(entry, no_card):
    """As the NDF family: SEULEX's solve and its adjoint."""
    from janus_tpu_torch.solve import seulex_adjoint
    if entry == "seulex":
        def run(y, **kw):
            return solve_ivp(_decay, (0.0, 1.0), y, method="seulex",
                             args=3.0, rtol=1e-6, atol=1e-9, **kw).y
    else:
        def run(y, **kw):
            return seulex_adjoint(_decay, (0.0, 1.0), y, args=3.0, **kw)
    _obeys_the_device_rule(run)


@pytest.mark.parametrize("entry", ["radaup", "radaup_adjoint", "bdf2",
                                   "grk4t", "odeint_fixed"])
def test_ladder_and_legacy_obey_the_device_rule(entry, no_card):
    """As the NDF family: the radaup ladder, its adjoint, the legacy
    steppers and the fixed grid."""
    from janus_tpu_torch.solve import solve_adjoint
    from janus_tpu_torch.solve.fixed import odeint_fixed
    if entry == "radaup_adjoint":
        def run(y, **kw):
            return solve_adjoint(_decay, (0.0, 1.0), y, method="radaup",
                                 args=3.0, **kw)
    elif entry == "odeint_fixed":
        def run(y, **kw):
            return odeint_fixed(_decay, 0.0, 1.0, y, 8, 3.0, **kw)
    else:
        def run(y, **kw):
            return solve_ivp(_decay, (0.0, 1.0), y, method=entry, args=3.0,
                             rtol=1e-6, atol=1e-9, **kw).y
    _obeys_the_device_rule(run)


def _obeys_the_device_rule(run):
    with pytest.raises(ValueError, match="pass y0 as a CPU tensor"):
        run(Y0)
    got = run(Y0, device="cpu")
    assert got.device.type == "cpu"
    torch.testing.assert_close(got, run(torch.from_numpy(Y0)), rtol=0,
                               atol=0)


def test_mlp_init_obeys_the_device_rule(no_card):
    """The network's weights go to the card unless the caller asks for the
    CPU: with no card mlp_init raises, and device="cpu" gives the same draw
    on the CPU."""
    from janus_tpu_torch.models.neural import mlp_init
    with pytest.raises(ValueError, match="no CUDA device"):
        mlp_init([2, 8, 2], torch.Generator().manual_seed(0))
    got = mlp_init([2, 8, 2], torch.Generator().manual_seed(0),
                   dtype=torch.float64, device="cpu")
    again = mlp_init([2, 8, 2], torch.Generator().manual_seed(0),
                     dtype=torch.float64, device="cpu")
    assert all(leaf.device.type == "cpu" for leaf in got["w"] + got["b"])
    assert all(torch.equal(a, b) for a, b in zip(got["w"], again["w"]))
