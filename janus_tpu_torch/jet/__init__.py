"""Batched dual-number ("jet") arithmetic, as ``janus_tpu.jet``: a Jet is a
pair {r: primal, d: stacked tangents with a LEADING sensitivity axis N};
common ops have hand-written tangent rules and everything else lifts
generically through ``torch.func.vmap`` over ``torch.func.jvp``, so every
``torch.func``-traceable function takes Jets.
"""

from janus_tpu_torch.jet.core import (
    Jet,
    jet,
    const,
    seed_identity,
    lift,
    where,
    concatenate,
    stack,
    einsum,
    matmul,
    sum as jsum,
    max_dual,
    min_dual,
    maximum,
    minimum,
    jvp_call,
)

__all__ = [
    "Jet",
    "jet",
    "const",
    "seed_identity",
    "lift",
    "where",
    "concatenate",
    "stack",
    "einsum",
    "matmul",
    "jsum",
    "max_dual",
    "min_dual",
    "maximum",
    "minimum",
    "jvp_call",
]
