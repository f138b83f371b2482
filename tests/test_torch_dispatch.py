"""The port's dispatchers ``solve_ivp`` and ``solve_adjoint`` against the
reference's method table, on the CPU (no JAX call: the tables are read from
the JAX package's module).

- every method name and alias the reference knows runs (every one is
  ported); a name the reference does not know raises ValueError, as the
  reference does;
- ``FEATURES`` says what runs: every feature a row marks True runs, every
  one it marks False raises ValueError;
- the port's messages point to torch, not to JAX.
"""

import numpy as np
import pytest
import torch

import janus_tpu.solve as ref_solve
from janus_tpu_torch.models.problems import vdp_jac, vdp_rhs
from janus_tpu_torch.solve import (FEATURES, Event, Options, solve_adjoint,
                                   solve_ivp)

torch.set_num_threads(1)

Y0 = torch.tensor([[2.0, 0.0]], dtype=torch.float64)
KW = dict(args=5.0, rtol=1e-5, atol=1e-8)
@pytest.mark.parametrize("method", sorted(set(ref_solve.FEATURES)
                                          | set(ref_solve._ALIASES)))
def test_every_reference_method_runs_or_names_its_item(method):
    """Every method is ported now: each name and alias runs."""
    assert ref_solve._ALIASES.get(method, method) in FEATURES
    sol = solve_ivp(vdp_rhs, (0.0, 0.5), Y0, method=method, **KW)
    assert int(sol.status[0]) == 1


@pytest.mark.parametrize("method", ["foo", "radau7", "rk4"])
def test_unknown_method_raises_value_error(method):
    assert method not in ref_solve.FEATURES and method not in ref_solve._ALIASES
    with pytest.raises(ValueError, match="unknown method"):
        solve_ivp(vdp_rhs, (0.0, 0.5), Y0, method=method, **KW)


def test_solve_adjoint_methods():
    """radau, radaup, rodas, bdf, seulex, dopri5 and dopri853 (and their
    aliases) have reverse modes; bdf2, grk4t and unknown names have
    none."""
    y0 = Y0.clone().requires_grad_()
    opts = Options(rtol=1e-6, atol=1e-9)
    for method in ("radau5", "radaup", "rodas", "rk45", "dop853", "ndf",
                   "bdf_classic", "seulex"):
        y = solve_adjoint(vdp_rhs, (0.0, 0.5), y0, method=method, args=5.0,
                          options=opts)
        (g,) = torch.autograd.grad(y.sum(), y0)
        assert bool(torch.isfinite(g).all()), method
    for method in ("bdf2", "grk4t", "rosenbrock", "foo"):
        with pytest.raises(ValueError, match="no reverse mode"):
            solve_adjoint(vdp_rhs, (0.0, 0.5), Y0, method=method, args=5.0)


# feature -> the keywords that switch it on
_FEATURE_KW = {
    "jac": dict(jac=vdp_jac),
    "mass": dict(mass=torch.eye(2, dtype=torch.float64)),
    "events": dict(events=Event(lambda t, y, a: y[:, 0] - 10.0)),
    "t_eval": dict(t_eval=np.array([0.25, 0.5])),
}


@pytest.mark.parametrize("method", sorted(FEATURES))
def test_features_table_says_what_runs(method):
    assert method in ref_solve.FEATURES
    for name, supported in zip(("jac", "mass", "events", "t_eval"),
                               FEATURES[method]):
        if supported:
            sol = solve_ivp(vdp_rhs, (0.0, 0.5), Y0, method=method,
                            **_FEATURE_KW[name], **KW)
            assert int(sol.status[0]) == 1, (method, name)
        else:
            with pytest.raises(ValueError, match="does not"):
                solve_ivp(vdp_rhs, (0.0, 0.5), Y0, method=method,
                          **_FEATURE_KW[name], **KW)


def test_messages_point_to_torch():
    with pytest.raises(ValueError, match="torch.func.jvp") as err:
        solve_ivp(vdp_rhs, (0.0, 0.5), Y0, method="radau_fused",
                  tangents=torch.zeros((1, 1, 2), dtype=torch.float64), **KW)
    assert "jax" not in str(err.value)
