"""The fused Radau5 solve of the port against the JAX reference, on the CPU.

The same inputs, made with numpy, go through the reference's
``solve_radau_fused(..., interpret=True)`` (its Pallas kernel run in
interpret mode) and the port's ``solve_ivp(method='radau_fused')``, which on
CPU tensors runs the plain twin ``_step_ref`` of the CUDA kernel K4. Setups:
the three of tests/test_radau_fused.py (heterogeneous μ with m=64, a ragged
m=37, scalar args), Robertson with m=16 and tf=logspace(−2, 2) and
args=None, and Robertson with a dict of rates whose keys are not sorted (JAX
flattens dicts by sorted keys, the port in insertion order). Tolerances:
each lane's status and all five counters equal; t and y to rtol 1e-10 plus
atol 1e-12 (float64).

Also: the port's fused solve against its own eager radau5 within 1e-6
relative plus 1e-9 absolute (as the reference's test holds its pair), the
dispatcher's raises, the args check, the device registry, the K4
wrapper's refusal of anything but a CPU or a CUDA tensor, and the ctypes
Structure of K4's constants against the C struct (names, types, array
lengths, size).
"""

import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janus_tpu.models.problems import robertson_rhs as ref_robertson
from janus_tpu.models.problems import vdp_rhs as ref_vdp
from janus_tpu.solve import Options as RefOptions
from janus_tpu.solve.radau_fused import solve_radau_fused as ref_fused
from janus_tpu_torch.models.problems import (DEVICE_PROBLEMS,
                                             ROBERTSON_DEFAULTS,
                                             robertson_rhs, vdp_rhs)
from janus_tpu_torch.ops import radau_fused as k4
from janus_tpu_torch.solve import Options, solve_ivp
from janus_tpu_torch.solve import radau_fused as rf

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parent.parent / "janus_tpu_torch" / "csrc"


def _setup(name):
    """(problem, tspan, y0, args as numpy or None, options dict, ref tile)."""
    if name == "hetero":
        m = 64
        return ("vdp", (0.0, 1.0), np.tile([[2.0, 0.0]], (m, 1)),
                np.linspace(5.0, 1000.0, m),
                dict(rtol=1e-6, atol=1e-9, pivoting=False), 64)
    if name == "ragged":
        m = 37
        return ("vdp", (0.0, 2.0), np.tile([[2.0, 0.0]], (m, 1)),
                np.full((m,), 50.0), dict(rtol=1e-7, atol=1e-10), 16)
    if name == "scalar":
        return ("vdp", (0.0, 1.0), np.array([[2.0, 0.0]]), 100.0,
                dict(rtol=1e-7, atol=1e-10), 8)
    m = 16
    tspan = (0.0, np.logspace(-2, 2, m))
    y0 = np.tile([[1.0, 0.0, 0.0]], (m, 1))
    if name == "robertson":
        return "robertson", tspan, y0, None, dict(rtol=1e-6, atol=1e-10), 16
    rng = np.random.default_rng(3)
    args = {"c": 3e7 * (1.0 + 0.1 * rng.standard_normal(m)), "a": 0.05}
    return "robertson", tspan, y0, args, dict(rtol=1e-6, atol=1e-10), 16


CASES = ["hetero", "ragged", "scalar", "robertson", "robertson-dict-args"]


def _to(args, conv):
    if isinstance(args, dict):
        return {k: _to(v, conv) for k, v in args.items()}
    return conv(args) if isinstance(args, np.ndarray) else args


def _port_solve(name, method="radau_fused"):
    problem, (t0, tf), y0, args, opts, _ = _setup(name)
    f = vdp_rhs if problem == "vdp" else robertson_rhs
    tf = torch.from_numpy(tf) if isinstance(tf, np.ndarray) else tf
    return solve_ivp(f, (t0, tf), torch.from_numpy(y0), method=method,
                     args=_to(args, torch.from_numpy), **opts)


@pytest.mark.parametrize("name", CASES)
def test_fused_matches_reference_per_lane(name):
    problem, (t0, tf), y0, args, opts, tile = _setup(name)
    f_ref = ref_vdp if problem == "vdp" else ref_robertson
    tf_ref = jnp.asarray(tf) if isinstance(tf, np.ndarray) else tf
    ref = ref_fused(f_ref, t0, tf_ref, jnp.asarray(y0),
                    args=_to(args, jnp.asarray), options=RefOptions(**opts),
                    tile=tile, interpret=True)
    got = _port_solve(name)
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    assert set(got.stats) == set(ref.stats) == set(rf.STATS)
    for k in rf.STATS:
        np.testing.assert_array_equal(got.stats[k].numpy(),
                                      np.asarray(ref.stats[k]), err_msg=k)
    assert (got.status.numpy() == 1).all()
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(got.y.numpy(), np.asarray(ref.y), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("name", ["hetero", "ragged", "scalar"])
def test_fused_matches_port_radau5(name):
    fused = _port_solve(name)
    eager = _port_solve(name, method="radau5")
    assert (fused.status.numpy() == 1).all()
    np.testing.assert_allclose(fused.y.numpy(), eager.y.numpy(), rtol=1e-6,
                               atol=1e-9)


def test_twin_loop_equals_op_path_on_cpu():
    """solve_radau_fused_ref (one _step_ref per trip) equals the op path
    (radau5_step with up to MAX_ATTEMPTS attempts per call) exactly."""
    problem, (t0, tf), y0, args, opts, _ = _setup("hetero")
    a = torch.from_numpy(args)
    ref = rf.solve_radau_fused_ref(vdp_rhs, t0, tf, torch.from_numpy(y0), a,
                                   Options(**opts))
    got = _port_solve("hetero")
    torch.testing.assert_close(got.y, ref.y, rtol=0, atol=0)
    for k in rf.STATS:
        torch.testing.assert_close(got.stats[k], ref.stats[k], rtol=0, atol=0)
    assert rf.solve_radau_fused.host_syncs >= 2


@pytest.mark.parametrize("kw,match", [
    ({"jac": lambda t, y, a: None}, "does not use a Jacobian"),
    ({"mass": np.eye(2)}, "does not support a mass matrix"),
    ({"events": [lambda t, y, a: y[..., 0]]}, "does not support events"),
    ({"t_eval": np.linspace(0.0, 1.0, 3)}, "does not support t_eval"),
    ({"tangents": np.zeros((1, 1, 2))}, "tangents="),
    ({"args_tangents": 1.0}, "tangents="),
    ({"quad": lambda t, y, a: y[..., 0]}, "quad="),
    ({"dense": 8}, "dense="),
    ({"step_args": np.zeros((4, 1))}, "step_args="),
])
def test_dispatcher_raises_for_unsupported_features(kw, match):
    with pytest.raises(ValueError, match=match):
        solve_ivp(vdp_rhs, (0.0, 1.0), torch.tensor([[2.0, 0.0]]),
                  method="radau_fused", args=10.0, **kw)


def test_args_leaves_must_be_scalar_or_lanes():
    y0 = torch.tensor([[2.0, 0.0]] * 3)
    with pytest.raises(ValueError, match="scalar or \\[M\\] args leaves"):
        solve_ivp(vdp_rhs, (0.0, 1.0), y0, method="radau_fused",
                  args=torch.ones(3, 2))


def test_robertson_defaults_and_registry():
    y = torch.from_numpy(np.random.default_rng(0).random((5, 3)))
    t = torch.zeros(5)
    torch.testing.assert_close(robertson_rhs(t, y, None),
                               robertson_rhs(t, y, dict(ROBERTSON_DEFAULTS)),
                               rtol=0, atol=0)
    np.testing.assert_allclose(robertson_rhs(t, y, None).numpy(),
                               np.asarray(ref_robertson(t.numpy(), y.numpy(),
                                                        None)), rtol=1e-15)
    prob = DEVICE_PROBLEMS[robertson_rhs]
    assert (prob.functor, prob.dim, prob.params) == ("robertson", 3,
                                                     ("a", "b", "c"))
    like = torch.zeros(5, dtype=torch.float64)
    rows = k4.param_rows(prob, None, like)
    np.testing.assert_array_equal(rows.numpy(),
                                  np.tile([[0.04], [1e4], [3e7]], (1, 5)))
    # by name, not by the order of the dict
    rows = k4.param_rows(prob, {"c": torch.arange(5.0), "a": 2.0}, like)
    np.testing.assert_array_equal(rows.numpy(), [[2.0] * 5, [1e4] * 5,
                                                 list(range(5))])
    vdp = DEVICE_PROBLEMS[vdp_rhs]
    assert (vdp.functor, vdp.dim, vdp.params) == ("vdp", 2, ("mu",))
    np.testing.assert_array_equal(
        k4.param_rows(vdp, {"mu": 3.0}, like).numpy(), [[3.0] * 5])


def test_k4_wrapper_takes_twin_only_on_cpu():
    opts = Options(rtol=1e-6, atol=1e-9)
    y0 = torch.tensor([[2.0, 0.0]] * 4, dtype=torch.float64)
    mus = torch.full((4,), 100.0, dtype=torch.float64)
    state, tf_row = rf.initial_state(vdp_rhs, 0.0, 1.0, y0, mus, opts)
    consts = rf.step_consts(opts, torch.float64)
    rows, treedef = rf.arg_rows(mus, state[0])
    k4.reset_launch_counts()
    got = k4.radau5_step(state, tf_row, vdp_rhs, mus, consts)
    ref = rf._step_ref(state, tf_row, rows, vdp_rhs, treedef, consts)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert k4.radau5_step.launches == 0
    share, errs, abs_err = rf.state_agreement(got, ref, 2)
    assert (share, abs_err) == (1.0, 0.0) and set(errs) == {
        "t", "y0", "y1", "f00", "f01", "h", "h_old", "err_old", "q0", "q1",
        "q2", "q3", "q4", "q5", "h_prev"}
    # off the CPU the wrapper launches the kernel or raises: an f that the
    # generated route would take raises on a device with no kernel ...
    meta = (state.to("meta"), tf_row.to("meta"))
    with pytest.raises(ValueError, match="expected CUDA"):
        k4.radau5_step(*meta, lambda t, y, a: vdp_rhs(t, y, a), mus, consts)
    # ... and a registered f too; an f with an op outside the generated
    # route's list is refused by its route, naming the op
    with pytest.raises(ValueError, match="expected CUDA"):
        k4.radau5_step(*meta, vdp_rhs, mus.to("meta"), consts)
    with pytest.raises(ValueError, match="aten.cumsum"):
        k4.kernel_route(lambda t, y, a: torch.cumsum(y, -1), mus, state)
    with pytest.raises(ValueError, match="5D\\+15"):
        k4.radau5_step(state[:-1], tf_row, vdp_rhs, mus, consts)


def test_consts_struct_matches_cuda_source():
    """The ctypes Structure lists the C struct's fields in its order."""
    src = (CSRC / "radau5_step.cuh").read_text()
    body = re.search(r"struct JanusRadauConsts \{(.*?)\};", src, re.S).group(1)
    decls = [d.split(None, 1)[1] for d in re.sub(r"//[^\n]*", "", body)
             .split(";") if d.strip()]          # "double c[3]" -> "c[3]"
    names = [re.sub(r"\[\d+\]", "", n).strip()
             for d in decls for n in d.split(",")]
    assert names == [f[0] for f in k4._Consts._fields_]


_C_TYPES = {"double": ctypes.c_double, "int": ctypes.c_int}


def test_consts_struct_types_and_size_match_cuda_source():
    """Every field of JanusRadauConsts, with its C type and array length, is
    the ctypes field of the same position, and the two structs have one
    size: a field added on one side only fails here."""
    src = (CSRC / "radau5_step.cuh").read_text()
    body = re.search(r"struct JanusRadauConsts \{(.*?)\};", src, re.S).group(1)
    fields = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        if not decl.strip():
            continue
        ctype, names = decl.split(None, 1)
        for name in names.split(","):
            m = re.fullmatch(r"\s*(\w+)\s*(?:\[(\d+)\])?\s*", name)
            base = _C_TYPES[ctype]
            fields.append((m.group(1),
                           base * int(m.group(2)) if m.group(2) else base))
    got = k4._Consts._fields_
    assert [n for n, _ in got] == [n for n, _ in fields]
    for (name, want), (_, have) in zip(fields, got):
        assert (ctypes.sizeof(have), getattr(have, "_type_", have)) == (
            ctypes.sizeof(want), getattr(want, "_type_", want)), name

    class Mirror(ctypes.Structure):
        _fields_ = fields

    assert ctypes.sizeof(k4._Consts) == ctypes.sizeof(Mirror)
