"""Mesh construction and batch-axis sharding helpers, on
``torch.distributed``'s ``DeviceMesh`` and ``DTensor``."""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from janus_tpu_torch.solve.common import (default_device, lockstep_group,
                                          tree_map)


def make_mesh(n_devices: Optional[int] = None,
              axes: Sequence[str] = ("data",),
              shape: Optional[Sequence[int]] = None,
              device=None) -> DeviceMesh:
    """A ``DeviceMesh`` over every rank of the process group. Default: 1-D
    over the axis 'data'; for 2-D (data, model) pass both axes and a shape,
    or let every rank go on the first axis.

    The mesh's tensors live on ``device``: the CUDA card unless the caller
    asks for the CPU (``device="cpu"``); with no card and no device asked
    for this raises. Ranks that share one card (NCCL refuses that) take a
    gloo group and a mesh on the CPU, and copy their shards to the card to
    solve (``local_shards(..., device=)``). A process that joined no group
    gets a one-rank group of its own (an in-process store: no address, no
    environment variable).
    ``n_devices``, when given, must be the number of ranks.
    """
    dev = default_device(device)
    if not dist.is_initialized():
        dist.init_process_group("gloo" if dev.type == "cpu" else "nccl",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"a mesh of {n_devices} ranks in a group of {n}: "
                         "the mesh spans every rank")
    if shape is None:
        shape = (n,) + (1,) * (len(axes) - 1)
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {tuple(shape)} != {n} ranks")
    return DeviceMesh(dev.type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def batch_sharding(mesh: DeviceMesh, ndim: int, axis: str = "data"):
    """Placements that split dimension 0 (the trajectory axis) of an
    ``ndim``-dimensional tensor over the mesh axis ``axis`` and replicate
    it over the others."""
    return _placements(mesh, 0, axis, ndim)


def _placements(mesh, dim, axis, ndim):
    if not 0 <= dim < ndim:
        raise ValueError(f"cannot shard dimension {dim} of a {ndim}-d "
                         "tensor")
    if axis not in mesh.mesh_dim_names:
        raise ValueError(f"mesh has no axis {axis!r} "
                         f"({mesh.mesh_dim_names})")
    return [Shard(dim) if name == axis else Replicate()
            for name in mesh.mesh_dim_names]


def _mesh_device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _distribute(x, mesh, placements):
    # every rank holds the same whole tensor (made from a seed): each keeps
    # its own rows and nothing is sent (src_data_rank=None)
    t = torch.as_tensor(x).to(_mesh_device(mesh))
    return distribute_tensor(t, mesh, placements(t), src_data_rank=None)


def shard_batch(tree, mesh: DeviceMesh, axis: str = "data"):
    """Each leaf of a tree of [M, ...] arrays as a ``DTensor`` whose batch
    axis is split over the mesh axis ``axis``, on the mesh's device. Every
    rank passes the same whole tree."""
    return tree_map(lambda x: _distribute(
        x, mesh, lambda t: batch_sharding(mesh, t.ndim, axis)), tree)


def replicate(tree, mesh: DeviceMesh):
    """Each leaf of a tree as a ``DTensor`` replicated over the mesh."""
    return tree_map(lambda x: _distribute(
        x, mesh, lambda t: [Replicate()] * mesh.ndim), tree)


def local_shards(tree, device=None):
    """The rank's own rows of each ``DTensor`` leaf (other leaves as they
    are), on ``device`` when given: what a solve runs on. A gloo mesh holds
    its shards on the host; its ranks solve on a card by asking for it
    here."""
    def own(x):
        x = x.to_local() if isinstance(x, DTensor) else x
        return x.to(device) if device is not None else x
    return tree_map(own, tree)


def gather(tree, mesh: DeviceMesh, dim: int = 0, axis: str = "data"):
    """The whole tensors, on every rank and on the mesh's device, of a tree
    of per-rank shards split along ``dim`` over the mesh axis ``axis`` (in
    rank order), gathered through the process group; a shard on another
    device (a card, for a gloo mesh on the host) is copied to the mesh's
    first. Shards may differ in length."""
    group = mesh.get_group(axis)
    dev = _mesh_device(mesh)

    def whole(x):
        x = x.to(dev)
        n = torch.tensor([x.shape[dim]], dtype=torch.int64, device=dev)
        dist.all_reduce(n, group=group)
        shape = list(x.shape)
        shape[dim] = int(n)
        stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
        return DTensor.from_local(
            x.contiguous(), mesh, _placements(mesh, dim, axis, x.ndim),
            shape=torch.Size(shape), stride=stride).full_tensor()

    return tree_map(whole, tree)


@contextmanager
def lockstep(mesh: DeviceMesh, axis: str = "data"):
    """Solves inside read their host gates together over the ranks of the
    mesh axis ``axis``: each gate is the OR (or the maximum) over every
    rank's lanes, as XLA's gates of the reference's sharded loop are
    global. Every rank then runs the one-process solve's loop trips, so the
    gathered result equals the one-process solve to the bit: some loops
    update every lane until the last lane converges (the IND tangent sweep,
    the adjoint's stage iteration), and with each rank's own gate a rank
    whose lanes converge sooner would stop sooner, and leave the others
    waiting in a read it never makes. Costs one ``all_reduce`` a gate.

    Covers every family's forward (radau, radaup, radau_fused, rodas,
    grk4t, bdf2, dopri5/853, NDF/BDF, SEULEX, with events and IND
    tangents), ``radau_adjoint`` and the discrete adjoints' backward sweeps
    (whose shared-parameter gradients stay each rank's own sum: the caller
    all-reduces them), and the control layer's batched loops (Newton, Ψtc,
    homotopy, Anderson, Newton–Krylov's outer loop: ``common.host_any``).
    ``control.krylov.gmres``, one Krylov space over one unbatched system,
    raises inside: its gates are scalars of that system, which a sharded
    solve would have to reduce as norms over every rank's rows."""
    with lockstep_group(mesh.get_group(axis)):
        yield
