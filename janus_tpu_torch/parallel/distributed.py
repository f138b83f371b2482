"""Multi-process initialization (the reference's ``jax.distributed`` role).

A job of several processes, on one host or many, joins one
``torch.distributed`` process group; the batch mesh then spans every rank.
On a single process this is a no-op.
"""

from __future__ import annotations

import logging
import os

import torch
import torch.distributed as dist

log = logging.getLogger("janus_tpu_torch.distributed")

# the variables a launcher such as torchrun sets for each process
CLUSTER_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def _backend(backend):
    if backend is not None:
        return backend
    if not torch.cuda.is_available():
        raise ValueError("no CUDA device: pass backend='gloo' to run the "
                         "process group on the CPU")
    return "nccl"


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               backend=None):
    """Join the job's process group, if the job has one.

    Explicit arguments (``coordinator_address`` as "host:port", the number
    of processes and this one's rank), or a launcher's environment
    (``CLUSTER_ENV``), describe a real multi-process job: failures there are
    raised, so a misconfigured job never runs as a single process. With no
    arguments and no such environment this is a logged no-op. Calling it
    again once the group exists is tolerated. ``backend`` defaults to NCCL,
    which needs a card (and one card a rank); ``backend="gloo"`` runs the
    collectives on the CPU, or through the host between ranks that share a
    card.
    """
    explicit = (coordinator_address, num_processes, process_id) != (
        None, None, None)
    if dist.is_initialized():
        log.info("torch.distributed already initialized; ignoring")
        return
    if explicit:
        if None in (coordinator_address, num_processes, process_id):
            raise ValueError("coordinator_address, num_processes and "
                             "process_id are given together")
        if not 0 <= process_id < num_processes:
            raise ValueError(f"process_id {process_id} is not a rank of "
                             f"{num_processes} processes")
        init = dict(init_method=f"tcp://{coordinator_address}",
                    world_size=num_processes, rank=process_id)
    elif any(k in os.environ for k in CLUSTER_ENV):
        init = dict(init_method="env://")
    else:
        log.info("single-process run (no cluster environment)")
        return
    dist.init_process_group(_backend(backend), **init)
    log.info("torch.distributed initialized: rank %d / %d",
             dist.get_rank(), dist.get_world_size())


def global_batch_mesh(axis: str = "data", device=None):
    """1-D mesh over every rank of the job."""
    from janus_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(axes=(axis,), device=device)
