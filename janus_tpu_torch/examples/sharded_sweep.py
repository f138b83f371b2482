"""Sharded parameter sweep (the twin of ``examples/sharded_sweep.py``).

The sweep is the batch axis, split over the ranks of a ``torch.distributed``
process group: each rank solves its own 8,192 lanes (Radau IIA s = 3,
rtol 1e-6, float64, mu = 10^linspace(0.5, 3) over the whole sweep; its
loop's gates read over every rank, ``parallel.lockstep``), and the
global mean of the steps and the success share come from one explicit
``all_reduce``, where XLA emits the psum in the reference. With no group
this runs as a one-rank sweep.

  python3 -m janus_tpu_torch.examples.sharded_sweep          # one process
  torchrun --nproc-per-node 2 -m janus_tpu_torch.examples.sharded_sweep \\
      --backend gloo                 # two ranks (gloo: also on one card)
"""

import sys

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from janus_tpu_torch.models.problems import vdp_jac, vdp_rhs
from janus_tpu_torch.parallel import (initialize, local_shards, lockstep,
                                      make_mesh, shard_batch)
from janus_tpu_torch.solve import SUCCESS, Options
from janus_tpu_torch.solve.common import default_device
from janus_tpu_torch.solve.radau import solve_radau

LANES_PER_RANK = 8192


def main(device=None, lanes_per_rank=LANES_PER_RANK, mesh=None):
    """Returns (y [the sweep's final states as a DTensor sharded over the
    mesh], mean steps per lane, success fraction); asserts that every lane
    succeeded. Each rank solves on ``device`` (the CUDA card unless the
    caller asks for another); ``mesh`` defaults to ``make_mesh`` on the
    same device (ranks sharing one card pass a gloo mesh on the CPU)."""
    device = default_device(device)
    mesh = make_mesh(device=device) if mesh is None else mesh
    n_ranks = mesh.size()
    m = lanes_per_rank * n_ranks
    print(f"ranks: {n_ranks}  batch: {m}  solve on: {device}  mesh on: "
          f"{mesh.device_type}")

    mus = torch.as_tensor(10.0 ** np.linspace(0.5, 3.0, m))
    y0 = torch.tensor([[2.0, 0.0]], dtype=torch.float64).repeat(m, 1)
    y0, mus = local_shards(shard_batch((y0, mus), mesh), device=device)

    opts = Options(rtol=1e-6, atol=1e-9, pivoting=False)
    with lockstep(mesh):    # the solve's gates read over every rank
        sol = solve_radau(vdp_rhs, 0.0, 1.0, y0, args=mus, jac=vdp_jac,
                          options=opts)
    # the global reduction (the reference's psum): sums over every rank
    sums = torch.stack([sol.stats["nsteps"].sum(),
                        (sol.status == SUCCESS).sum()]).to(
        mesh.device_type, torch.float64)
    dist.all_reduce(sums, group=mesh.get_group())
    mean_steps, ok = (sums / m).tolist()
    y = DTensor.from_local(sol.y.to(mesh.device_type), mesh, [Shard(0)])
    print(f"success fraction: {ok:.4f}")
    print(f"mean steps/lane:  {mean_steps:.1f}")
    print(f"output placements: {y.placements} over {y.device_mesh}")
    assert ok == 1.0
    return y, mean_steps, ok


if __name__ == "__main__":
    backend = sys.argv[sys.argv.index("--backend") + 1] \
        if "--backend" in sys.argv else None
    initialize(backend=backend)
    # a gloo job keeps its mesh on the host, and solves on the card if any
    main(device=None if torch.cuda.is_available() else "cpu",
         mesh=make_mesh(device="cpu") if backend == "gloo" else None)
