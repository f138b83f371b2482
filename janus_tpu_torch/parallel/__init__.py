"""Sharding of the trajectory batch over the ranks of a process group.

The port of ``janus_tpu/parallel``. The reference shards the [M] batch axis
over a ``jax.sharding.Mesh`` and lets XLA partition its one lockstep loop
and insert the collectives. Eager torch cannot partition a host loop, so
here each rank of a ``torch.distributed`` process group holds a shard of the
batch as a ``DTensor`` (``shard_batch``), runs the solve on its own local
rows (``local_shards``: the solver's op stream never goes through DTensor
dispatch) inside ``lockstep`` (the solve's host gates read over every rank,
as XLA's are), and the results come back together through the group
(``gather``), or a reduction is an explicit ``all_reduce``. The gathered
result then equals the one-process solve to the bit.
"""

from janus_tpu_torch.parallel.distributed import (global_batch_mesh,
                                                  initialize)
from janus_tpu_torch.parallel.mesh import (batch_sharding, gather,
                                           local_shards, lockstep, make_mesh,
                                           replicate, shard_batch)

__all__ = ["make_mesh", "shard_batch", "replicate", "batch_sharding",
           "local_shards", "lockstep", "gather", "initialize",
           "global_batch_mesh"]
