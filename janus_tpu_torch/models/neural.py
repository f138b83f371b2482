"""Multilayer perceptrons as vector fields and Hamiltonians.

The port of ``janus_tpu/models/neural.py``: the parameters are a plain tree
``{'w': [[n_in, n_out], ...], 'b': [[n_out], ...]}`` of tensors, so the
solvers' adjoints differentiate every leaf (``dopri_adjoint(args=params)``).
``interop.tree_to_torch`` carries the reference's parameter tree across.
"""

from __future__ import annotations

from typing import Sequence

import torch

from janus_tpu_torch.solve.common import default_device


def mlp_init(sizes: Sequence[int], generator: torch.Generator,
             dtype=torch.float32, device=None):
    """sizes = [in, hidden..., out]: He-normal weights drawn from
    ``generator`` (a seeded ``torch.Generator`` on the CPU) and zero biases,
    made on the CPU and moved to ``device``: the CUDA card unless the caller
    asks for another (``device="cpu"``); with no card and no device asked
    for this raises, as the solvers do."""
    device = default_device(device)
    ws, bs = [], []
    for n_in, n_out in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((n_in, n_out), generator=generator,
                        dtype=torch.float64) * (2.0 / n_in) ** 0.5
        ws.append(w.to(device=device, dtype=dtype))
        bs.append(torch.zeros((n_out,), dtype=dtype, device=device))
    return {"w": ws, "b": bs}


def mlp_apply(params, x, activation=torch.tanh):
    h = x
    n = len(params["w"])
    for i, (w, b) in enumerate(zip(params["w"], params["b"])):
        h = h @ w + b
        if i < n - 1:
            h = activation(h)
    return h


def nn_hamiltonian(params):
    """Scalar H(x, p, args) from an MLP over the concatenated phase point
    (per sample: x, p are [D/2] vectors)."""
    def ham(x, p, args):
        return torch.sum(mlp_apply(params, torch.cat([x, p])))

    return ham
