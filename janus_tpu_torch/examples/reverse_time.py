"""Reverse-time integration (the twin of ``examples/reverse_time.py``).

The solvers accept tf < t0 directly (signed h throughout), so a backward
sweep needs no rewriting of the problem. Integrate the damped oscillator
forward 0 → T, then run time BACKWARD T → 0 from the endpoint and recover
the initial state to the solver's tolerance: by Radau, then by dopri853.
float64.

  python3 -m janus_tpu_torch.examples.reverse_time
"""

import torch

from janus_tpu_torch.solve import Options, solve_ivp
from janus_tpu_torch.solve.common import default_device


def rhs(t, y, args):
    q, v = y[..., 0], y[..., 1]
    return torch.stack([v, -q - 0.15 * v], dim=-1)


def main(device=None, t_final=6.0):
    """Returns (the Radau round-trip error, the dopri853 backward error),
    both max |y(0) - y0| over the lanes, for the span [0, t_final] (the
    reference's 6.0 by default)."""
    device = default_device(device)
    T = t_final
    y0 = torch.tensor([[1.0, 0.0], [0.3, -0.4], [2.0, 1.0]],
                      dtype=torch.float64, device=device)
    opts = Options(rtol=1e-10, atol=1e-12)

    fwd = solve_ivp(rhs, (0.0, T), y0, method="radau", options=opts)
    assert bool(fwd.success.all())

    bwd = solve_ivp(rhs, (T, 0.0), fwd.y, method="radau", options=opts)
    assert bool(bwd.success.all())

    err = float((bwd.y - y0).abs().max())
    print(f"forward endpoint:  {fwd.y[0].tolist()}")
    print(f"roundtrip error:   {err:.2e}  (tolerance-level)")
    assert err < 1e-7
    # stiff solvers are not the only ones: dopri853 backward too
    bwd8 = solve_ivp(rhs, (T, 0.0), fwd.y, method="dopri853", options=opts)
    err8 = float((bwd8.y - y0).abs().max())
    print(f"dopri853 backward: {err8:.2e}")
    return err, err8


if __name__ == "__main__":
    main()
