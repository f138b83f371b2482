"""Carry the JAX package's problem state across to the port.

The "weights" of this system are its ``Options``, ``args``, ``y0`` and
tangent seeds. ``options_from_jax`` reads a ``janus_tpu`` Options object by
field name (duck-typed: no jax import here) and ``tree_to_torch`` converts
arrays, so that both packages solve the same problem.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from janus_tpu_torch.solve.common import tree_map
from janus_tpu_torch.solve.options import Options

# field renames, port name -> reference name
_RENAMED = {"kernel_lu": "pallas_lu"}


def options_from_jax(opts) -> Options:
    """The port's Options with every field read from the reference's Options
    (``pallas_lu`` → ``kernel_lu``), each coerced to the port's field type."""
    kw = {}
    for fld in dataclasses.fields(Options):
        val = getattr(opts, _RENAMED.get(fld.name, fld.name))
        kw[fld.name] = type(fld.default)(val)
    return Options(**kw)


def tree_to_torch(tree, device=None, dtype=None):
    """Arrays (numpy, or anything with ``__array__``) in a tree of dicts,
    lists and tuples → torch tensors on ``device``; floating arrays are cast
    to ``dtype`` when given. Python scalars and None stay as they are."""
    def conv(x):
        if x is None or isinstance(x, (bool, int, float)):
            return x
        t = torch.from_numpy(np.array(x))
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device) if device is not None else t
    return tree_map(conv, tree)
