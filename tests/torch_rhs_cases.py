"""Right-hand sides for the tests of K4's generated route that no problem
of the library covers (imported by test_torch_rhs_codegen.py and
test_torch_kernels_gpu.py; no jax here)."""

import torch


def mixed_ops_rhs(t, y, a):
    """D = 3, args {'k'}: where, maximum, minimum, clamp, exp, log, sqrt,
    abs, pow by -1, -2, 0.5, 1.5 and -0.5, reciprocal, a division by a
    number, one by an args row and one of a number by a row."""
    x0, x1, x2 = y[..., 0], y[..., 1], y[..., 2]
    s = torch.sqrt(torch.abs(x0) + 1.0)
    e = torch.exp(-x1) * torch.log(x2 * x2 + 1.0)
    w = torch.where(x0 > x1, torch.maximum(x0, x2), torch.minimum(x1, x2))
    p = (x0 ** -1 + x1 ** -2 + x2 ** 0.5 + torch.abs(x0) ** 1.5
         + x1 ** -0.5)
    c = (torch.clamp(x2, -0.5, 2.0) + 1.0 / x0 + x1 / a["k"] + x2 / 3.0
         + t * torch.reciprocal(x1))
    return torch.stack([s + e, w * p, c], dim=-1)


def ring_rhs(t, y, a):
    """Any D (y's last axis), no args: component i decays at rate
    1 + 50 i, is driven by its two ring neighbours' product and by
    0.1 sin(t); for K4's group layout at the D no library problem has."""
    d = y.shape[-1]
    return torch.stack([-(1.0 + 50.0 * i) * y[..., i]
                        + 0.5 * y[..., (i + 1) % d] * y[..., (i - 1) % d]
                        + 0.1 * torch.sin(t) for i in range(d)], dim=-1)
