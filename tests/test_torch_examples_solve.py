"""The port's reverse_time and events_poincare (janus_tpu_torch/examples/)
against the reference's (examples/), on the CPU in float64.

- reverse_time: the Radau round trip and the dopri853 backward error within
  1e-12 of the reference's (the same solves, rtol 1e-10), over [0, 1.5]
  where the example's span is [0, 6], to keep the case short;
- events_poincare at 64 lanes: status equal, event_t and event_y within
  1e-9.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from janus_tpu.models.problems import vdp_jac as j_vdp_jac
from janus_tpu.models.problems import vdp_rhs as j_vdp_rhs
from janus_tpu.solve import Options as JOptions
from janus_tpu.solve import solve_ivp as j_solve_ivp
from janus_tpu.solve.events import Event as JEvent
from janus_tpu_torch.examples import events_poincare as ep
from janus_tpu_torch.examples import reverse_time as rt

_HERE = os.path.dirname(__file__)
sys.path.insert(0, os.path.join(_HERE, "..", "examples"))
import events_poincare as ep_ref  # noqa: E402
import reverse_time as rt_ref  # noqa: E402

torch.set_num_threads(1)
CPU = torch.device("cpu")


def test_reverse_time_round_trips_match_reference():
    t_final = 1.5                       # the example's span is [0, 6]
    err, err8 = rt.main(device="cpu", t_final=t_final)
    y0 = jnp.array([[1.0, 0.0], [0.3, -0.4], [2.0, 1.0]])
    opts = JOptions(rtol=1e-10, atol=1e-12)

    @jax.jit
    def ref_errors(y0):
        fwd = j_solve_ivp(rt_ref.rhs, (0.0, t_final), y0, method="radau",
                          options=opts)
        bwd = j_solve_ivp(rt_ref.rhs, (t_final, 0.0), fwd.y, method="radau",
                          options=opts)
        bwd8 = j_solve_ivp(rt_ref.rhs, (t_final, 0.0), fwd.y,
                           method="dopri853", options=opts)
        return (jnp.max(jnp.abs(bwd.y - y0)), jnp.max(jnp.abs(bwd8.y - y0)),
                fwd.success & bwd.success)

    want, want8, ok = ref_errors(y0)
    assert bool(jnp.all(ok))
    assert err < 1e-7
    assert abs(err - float(want)) < 1e-12
    assert abs(err8 - float(want8)) < 1e-12


def test_events_poincare_matches_reference():
    m = 64
    mus, sol = ep.solve(m, CPU, ep.options())
    want = j_solve_ivp(
        j_vdp_rhs, (0.0, 50.0), jnp.tile(jnp.array([[2.0, 0.0]]), (m, 1)),
        method="radau", args=jnp.asarray(mus.numpy()), jac=j_vdp_jac,
        options=JOptions(rtol=1e-8, atol=1e-10),
        events=JEvent(lambda t, y, a: y[:, 0], terminal=True,
                      direction=-1.0))
    assert ep_ref.EVENT_TERMINATED == ep.EVENT_TERMINATED
    np.testing.assert_array_equal(sol.status.numpy(),
                                  np.asarray(want.status))
    assert bool((sol.status == ep.EVENT_TERMINATED).all())
    np.testing.assert_allclose(sol.event_t.numpy(), np.asarray(want.event_t),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(sol.event_y.numpy(), np.asarray(want.event_y),
                               rtol=0, atol=1e-9)
