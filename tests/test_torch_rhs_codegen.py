"""K4's generated route on the CPU: the tracer of ``ops.rhs_codegen``, its
plain twin, its refusals, and the fused solve of the right-hand sides it
serves against the JAX reference.

- For every right-hand side of ``models.problems`` with D <= 8 (harmonic,
  vdp, robertson, brusselator, dubins, dubins_pmp, hires, orego, e5), the
  Hamiltonian VdP ``ham.hamiltonian_dynamics(vdp_hamiltonian)`` (mu in a
  closure) and ``torch_rhs_cases.mixed_ops_rhs`` (where, maximum, minimum,
  clamp, exp, log, sqrt, abs, pow by -1, -2, 0.5, 1.5 and -0.5, divisions
  by a number and by a row), in float64 and float32 at M = 5, on inputs
  made with numpy: the traced program evaluated with torch
  (``Program.evaluate``, the functor's twin) equals f to the bit, and its
  jvp program with one-hot tangents equals ``torch.func.jvp``'s Jacobian
  columns to the bit, as ``solve.radau_fused._step_ref`` calls both.
- The generated source is deterministic: the same f gives the same hash;
  a changed closure constant a different one.
- The refusals: ``y.sum(0)``, a data-dependent ``if``,
  ``torch.linalg.solve`` inside f and D = 9 raise ValueError naming the op
  (``aten.sum``, ``aten._local_scalar_dense``, ``aten._linalg_solve_ex``)
  or the limit.
- Reference parity: ``solve_ivp(..., method='radau_fused',
  device='cpu')`` of the port (the twin ``_step_ref`` on every attempt)
  against ``janus_tpu.solve.radau_fused.solve_radau_fused(...,
  interpret=True)`` for orego (D = 3), dubins (D = 3, sin and cos) and the
  Hamiltonian VdP (D = 4) at 16 lanes: status and the five counters equal,
  t and y within rtol 1e-10 plus atol 1e-12 (float64), as
  ``tests/test_torch_radau_fused.py`` holds its cases. dubins_pmp (D = 6)
  and HIRES (D = 8) against the reference are marked slow (the
  interpret-mode compile of the unrolled 12x12 and 16x16 LU is long); in
  the fast tier they are held to the port's eager radau5 within 1e-6
  relative plus 1e-9 absolute (HIRES: atol 1e-10 and 1e-8 absolute, its
  state being ~1e-3).
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jvp

from janus_tpu.ham.core import hamiltonian_dynamics as ref_ham_dynamics
from janus_tpu.models import problems as ref_problems
from janus_tpu.solve import Options as RefOptions
from janus_tpu.solve.radau_fused import solve_radau_fused as ref_fused
from janus_tpu_torch.ham.core import hamiltonian_dynamics
from janus_tpu_torch.models import problems as P
from janus_tpu_torch.ops import rhs_codegen
from janus_tpu_torch.solve import solve_ivp
from janus_tpu_torch.solve import radau_fused as rf

sys.path.insert(0, os.path.dirname(__file__))
from torch_rhs_cases import mixed_ops_rhs  # noqa: E402

torch.set_num_threads(1)

MU = 10.0


def _ham_vdp():
    return hamiltonian_dynamics(lambda x, p, a: P.vdp_hamiltonian(x, p, MU))


CASES = {
    "harmonic": (lambda: P.harmonic_rhs, 2.0, 2),
    "vdp": (lambda: P.vdp_rhs, 100.0, 2),
    "robertson": (lambda: P.robertson_rhs, None, 3),
    "brusselator": (lambda: P.brusselator_rhs, {"a": 1.0, "b": 3.0}, 2),
    "dubins": (lambda: P.dubins_rhs, {"v": 1.5, "u": 0.3}, 3),
    "dubins_pmp": (lambda: P.dubins_pmp_rhs,
                   {"v": 1.0, "umax": 1.0, "eps": 0.1}, 6),
    "hires": (lambda: P.hires_rhs, None, 8),
    "orego": (lambda: P.orego_rhs, None, 3),
    "e5": (lambda: P.e5_rhs, None, 4),
    "ham_vdp": (_ham_vdp, None, 4),
    "mixed_ops": (lambda: mixed_ops_rhs, {"k": 2.0}, 3),
}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", sorted(CASES))
def test_program_equals_f_and_its_jvp_to_the_bit(name, dtype):
    make, args, dim = CASES[name]
    _program_equals_f_and_its_jvp(make(), args, dim, dtype, len(name))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_closure_tensors_are_constants_read_where_they_lie(dtype):
    """Tensors f closes over are constants of the trace: a 0-dim CPU tensor
    divides as PyTorch's CUDA kernels take a CPU scalar (times its
    reciprocal), a [D] row element by element; the program equals f and
    its jvp to the bit."""
    w = torch.tensor([1.0, 2.0, 3.0], dtype=dtype)
    s = torch.tensor(7.0, dtype=dtype)

    def f(t, y, a):
        return -(w * y) / s + y / w + torch.cos(t)[:, None]

    unit = _program_equals_f_and_its_jvp(f, None, 3, dtype, 3)
    ops = [node[0] for node in unit.value.nodes]
    # one node a column of each division
    assert ops.count("div_rcp") == 3 and ops.count("div") == 3


def _program_equals_f_and_its_jvp(f, args, dim, dtype, seed):
    unit = rhs_codegen.lower(f, args, dim, dtype)
    m = 5
    rng = np.random.default_rng(seed)
    y = torch.from_numpy(0.3 + rng.random((m, dim))).to(dtype)
    t = torch.from_numpy(rng.random(m)).to(dtype)
    rows, treedef = rf.arg_rows(args, y[:, 0])
    a1 = None if treedef is None else treedef(list(rows))
    y_rows = [y[:, i] for i in range(dim)]
    want = f(t, y, a1)
    got = unit.value.evaluate(t, y_rows, list(rows))
    for i in range(dim):
        assert torch.equal(got[i], want[:, i]), i
    jac = rhs_codegen.jacobian(unit.dual, t, y_rows, list(rows))
    for j in range(dim):
        tang = torch.zeros_like(y)
        tang[:, j] = 1.0
        _, col = jvp(lambda yy: f(t, yy, a1), (y,), (tang,))
        for i in range(dim):
            assert torch.equal(jac[i][j], col[:, i]), (i, j)
    assert unit.dim == dim and unit.n_params == max(rows.shape[0], 1)
    assert f"janus_radau5_step_{unit.name}" in unit.source
    assert "@NAME@" not in unit.source
    return unit


def test_source_is_deterministic_and_follows_closure_constants():
    def make(mu):
        return lambda t, y, a: P.vdp_rhs(t, y, mu)

    names = [rhs_codegen.lower(make(mu), None, 2, torch.float64).name
             for mu in (10.0, 10.0, 11.0)]
    assert names[0] == names[1] != names[2]
    again = rhs_codegen.lower(_ham_vdp(), None, 4, torch.float64)
    assert again.source == rhs_codegen.lower(_ham_vdp(), None, 4,
                                             torch.float64).source
    assert again.name != rhs_codegen.lower(_ham_vdp(), None, 4,
                                           torch.float32).name


def _sum_over_lanes(t, y, a):
    return y - y.sum(0)


def _data_dependent(t, y, a):
    if (y[:, 0] > 0).all():
        return 2.0 * y
    return y


def _linalg(t, y, a):
    eye = torch.stack([torch.stack([torch.ones_like(y[:, 0]),
                                    torch.zeros_like(y[:, 0])], -1),
                       torch.stack([torch.zeros_like(y[:, 0]),
                                    torch.ones_like(y[:, 0])], -1)], -2)
    return torch.linalg.solve(3.0 * eye, y)


@pytest.mark.parametrize("f,dim,match", [
    (_sum_over_lanes, 2, "aten.sum.* combines two lanes"),
    (_data_dependent, 2, "aten._local_scalar_dense"),
    (_linalg, 2, "aten._linalg_solve_ex"),
    (lambda t, y, a: -y, 9, "D=9 > 8"),
])
def test_refusals_name_the_op_or_the_limit(f, dim, match):
    with pytest.raises(ValueError, match=match) as info:
        rhs_codegen.lower(f, None, dim, torch.float64)
    assert getattr(f, "__qualname__", "<lambda>") in str(info.value)


# ---- the fused solve against the reference ----------------------------------

def _parity_setup(name):
    """(port f, reference f, tspan, y0 [16, D], args, options dict)."""
    rng = np.random.default_rng(5)
    m = 16
    if name == "orego":
        y0 = np.asarray(P.OREGO_Y0)[None] * (1 + 1e-3 * rng.random((m, 1)))
        return (P.orego_rhs, ref_problems.orego_rhs, 5.0, y0, None,
                dict(rtol=1e-6, atol=1e-10))
    if name == "dubins":
        y0 = rng.uniform(-1.0, 1.0, (m, 3))
        args = {"v": 1.5, "u": rng.uniform(-1.0, 1.0, m)}
        return (P.dubins_rhs, ref_problems.dubins_rhs, 2.0, y0, args,
                dict(rtol=1e-7, atol=1e-10))
    if name == "ham_vdp":
        y0 = np.concatenate([rng.uniform(0.1, 1.0, (m, 1)), np.zeros((m, 1)),
                             2.0 + 0.1 * rng.standard_normal((m, 1)),
                             np.zeros((m, 1))], 1)
        ref = ref_ham_dynamics(
            lambda x, p, a: ref_problems.vdp_hamiltonian(x, p, MU))
        return _ham_vdp(), ref, 1.0, y0, None, dict(rtol=1e-6, atol=1e-9)
    if name == "dubins_pmp":
        y0 = np.concatenate([rng.uniform(-1, 1, (m, 2)),
                             rng.uniform(-np.pi, np.pi, (m, 1)),
                             rng.uniform(-1, 1, (m, 3))], 1)
        return (P.dubins_pmp_rhs, ref_problems.dubins_pmp_rhs, 1.0, y0,
                {"v": 1.0, "umax": 1.0, "eps": 0.1},
                dict(rtol=1e-6, atol=1e-9))
    y0 = np.asarray(P.HIRES_Y0)[None] * (1 + 1e-3 * rng.random((m, 1)))
    return (P.hires_rhs, ref_problems.hires_rhs, 0.1, y0, None,
            dict(rtol=1e-6, atol=1e-10))


def _to(args, conv):
    if isinstance(args, dict):
        return {k: _to(v, conv) for k, v in args.items()}
    return conv(args) if isinstance(args, np.ndarray) else args


def _port(name, method="radau_fused"):
    f, _, tf, y0, args, opts = _parity_setup(name)
    return solve_ivp(f, (0.0, tf), torch.from_numpy(y0), method=method,
                     args=_to(args, torch.from_numpy), device="cpu", **opts)


def _against_reference(name):
    _, f_ref, tf, y0, args, opts = _parity_setup(name)
    ref = ref_fused(f_ref, 0.0, tf, jnp.asarray(y0),
                    args=_to(args, jnp.asarray), options=RefOptions(**opts),
                    tile=16, interpret=True)
    got = _port(name)
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    assert (got.status.numpy() == 1).all()
    for k in rf.STATS:
        np.testing.assert_array_equal(got.stats[k].numpy(),
                                      np.asarray(ref.stats[k]), err_msg=k)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(got.y.numpy(), np.asarray(ref.y), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("name", ["orego", "dubins", "ham_vdp"])
def test_fused_matches_reference_per_lane(name):
    _against_reference(name)


@pytest.mark.slow
@pytest.mark.parametrize("name", ["dubins_pmp", "hires"])
def test_fused_matches_reference_per_lane_slow(name):
    _against_reference(name)


@pytest.mark.parametrize("name,atol", [("dubins_pmp", 1e-9), ("hires", 1e-8)])
def test_fused_matches_port_radau5(name, atol):
    fused = _port(name)
    eager = _port(name, method="radau5")
    assert (fused.status.numpy() == 1).all()
    np.testing.assert_allclose(fused.y.numpy(), eager.y.numpy(), rtol=1e-6,
                               atol=atol)
