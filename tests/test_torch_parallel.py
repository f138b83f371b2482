"""janus_tpu_torch.parallel on CPU process groups (gloo), against the
one-process solve.

Partition invariance, the twin of ``tests/test_sharded_scale.py`` and
``tests/test_fixed_and_parallel.py::test_sharded_solve_matches_single_device``:
two real OS processes join a gloo group through ``parallel.initialize``,
each solves its half of the batch on its own rows (``shard_batch`` →
``local_shards``), and the results come back through the group
(``gather``). A lane's arithmetic does not depend on the other lanes, so the
gathered y, sens, status and naccept equal the one-process solve to the bit.
The adjoint gradient split the same way is held within rtol 1e-14 (the
reference's bound), and the shared-parameter gradient all-reduced over the
ranks within rtol 1e-12 of the sum of the shards' local gradients, equal on
every rank (``tests/test_distributed.py::
test_two_process_adjoint_gradient_allreduce``). The workers run once for
the module; the one-process solves run in the test process meanwhile.
"""

import json
import logging
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from janus_tpu_torch import parallel
from janus_tpu_torch.bench import infra
from janus_tpu_torch.models.problems import vdp_jac, vdp_rhs
from janus_tpu_torch.parallel import distributed
from janus_tpu_torch.solve import Options, solve_ivp
from janus_tpu_torch.solve.adjoint import radau_adjoint
from janus_tpu_torch.solve.radau import solve_radau

RANKS = 2
M_HEADLINE = 1024
M_ADJOINT = 64
SWEEP_LANES = 256
ADJ_OPTS = dict(rtol=1e-8, atol=1e-11, adjoint_steps=512, pivoting=False)
CPU = torch.device("cpu")

WORKER = r"""
import json, sys
from pathlib import Path
import numpy as np, torch, torch.distributed as dist
rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          Path(sys.argv[4]))
from janus_tpu_torch.parallel import (initialize, make_mesh, gather,
                                      local_shards, lockstep, shard_batch)
from janus_tpu_torch.bench.infra import sharded_headline
from janus_tpu_torch.models.problems import vdp_jac, vdp_rhs
from janus_tpu_torch.solve import Options, solve_ivp
from janus_tpu_torch.solve.adjoint import radau_adjoint
from janus_tpu_torch.solve.radau import solve_radau
import test_torch_parallel as T

kw = dict(coordinator_address=f"localhost:{port}", num_processes=world,
          process_id=rank, backend="gloo")
initialize(**kw)
initialize(**kw)                  # a second call is tolerated
mesh = make_mesh(device="cpu")
rec = {"world": dist.get_world_size(), "rank": dist.get_rank()}

whole, _, _ = sharded_headline(mesh, T.M_HEADLINE, "cpu", False,
                               mus=T.headline_mus())

y0, mus = local_shards(shard_batch(T.adjoint_inputs(), mesh))
with lockstep(mesh):
    gy, gm = T.adjoint_gradient(y0, mus)
g = gather({"gy": gy, "gm": gm}, mesh)

k = torch.tensor(30.0, dtype=torch.float64, requires_grad=True)
y_own = torch.tensor([[2.0, 0.0], [1.5 + 0.3 * rank, 0.2]],
                     dtype=torch.float64)
yT = radau_adjoint(vdp_rhs, (0.0, 0.5), y_own, args=k * torch.ones(2,
                   dtype=torch.float64), options=Options(rtol=1e-8,
                   atol=1e-11))
torch.sum(yT ** 2).backward()
total = k.grad.detach().clone()
dist.all_reduce(total)
rec.update(local=float(k.grad), total=float(total))

from janus_tpu_torch.examples import sharded_sweep
_, mean_steps, ok = sharded_sweep.main(device="cpu", mesh=mesh,
                                       lanes_per_rank=T.SWEEP_LANES)
rec.update(sweep_mean_steps=mean_steps, sweep_ok=ok)
np.savez(out / f"rank{rank}.npz", gy=g["gy"].numpy(), gm=g["gm"].numpy(),
         **{key: v.numpy() for key, v in whole.items()})
(out / f"rank{rank}.json").write_text(json.dumps(rec))
dist.destroy_process_group()
"""


def headline_mus():
    return torch.logspace(1, 3, M_HEADLINE, dtype=torch.float64)


def adjoint_inputs():
    y0 = torch.tensor([[2.0, 0.0]], dtype=torch.float64).repeat(M_ADJOINT, 1)
    return y0, torch.logspace(1.0, 2.5, M_ADJOINT, dtype=torch.float64)


def adjoint_gradient(y0, mus):
    """d/dy0 and d/dmu of the per-lane sum(y(T)^2), summed."""
    y0 = y0.detach().clone().requires_grad_()
    mus = mus.detach().clone().requires_grad_()
    yT = radau_adjoint(vdp_rhs, (0.0, 1.0), y0, args=mus, jac=vdp_jac,
                       options=Options(**ADJ_OPTS))
    torch.sum(yT ** 2).backward()
    return y0.grad, mus.grad


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's gathered arrays and record, with the one-process
    results computed while the workers ran."""
    out = tmp_path_factory.mktemp("ranks")
    script = out / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ)
    here = Path(__file__).resolve().parent
    env["PYTHONPATH"] = os.pathsep.join(
        [str(here.parent), str(here), env.get("PYTHONPATH", "")])
    procs = infra.start_workers(RANKS, out, cmd=[sys.executable, str(script)],
                                env=env)
    y0, mus, seeds = infra.headline_inputs(M_HEADLINE, CPU, headline_mus())
    one = infra.headline_solve(y0, mus, seeds, False)
    gy, gm = adjoint_gradient(*adjoint_inputs())
    rcs, logs = infra.wait_workers(procs, out, timeout=600)
    assert rcs == [0] * RANKS, "\n---\n".join(o[-3000:] for o in logs)
    return {"one": one, "gy": gy, "gm": gm,
            "npz": [dict(np.load(out / f"rank{r}.npz")) for r in range(RANKS)],
            "rec": [json.loads((out / f"rank{r}.json").read_text())
                    for r in range(RANKS)]}


def test_sharded_headline_equals_one_process(ranks):
    one = ranks["one"]
    assert bool((one.status == 1).all())
    want = {"y": one.y, "sens": one.sens, "status": one.status,
            "naccept": one.stats["naccept"]}
    for r in range(RANKS):
        assert ranks["rec"][r]["world"] == RANKS
        for key, v in want.items():
            np.testing.assert_array_equal(ranks["npz"][r][key], v.numpy(),
                                          err_msg=f"rank {r} {key}")


def test_sharded_adjoint_gradient_equals_one_process(ranks):
    for r in range(RANKS):
        for key in ("gy", "gm"):
            np.testing.assert_allclose(ranks["npz"][r][key],
                                       ranks[key].numpy(), rtol=1e-14,
                                       atol=1e-15)


def test_shared_parameter_gradient_allreduce(ranks):
    locals_ = [rec["local"] for rec in ranks["rec"]]
    totals = [rec["total"] for rec in ranks["rec"]]
    assert locals_[0] != locals_[1]          # each rank its own shard
    assert totals[0] == totals[1]
    np.testing.assert_allclose(totals[0], sum(locals_), rtol=1e-12)


def _no_cluster_env(monkeypatch):
    for k in distributed.CLUSTER_ENV:
        monkeypatch.delenv(k, raising=False)


def test_initialize_without_cluster_is_a_logged_no_op(monkeypatch, caplog):
    _no_cluster_env(monkeypatch)
    with caplog.at_level(logging.INFO, logger="janus_tpu_torch.distributed"):
        parallel.initialize()
    assert not dist.is_initialized()
    assert "single-process" in caplog.text


def test_initialize_raises_on_a_broken_job(monkeypatch):
    _no_cluster_env(monkeypatch)
    with pytest.raises(ValueError, match="together"):
        parallel.initialize(coordinator_address="localhost:1")
    with pytest.raises(ValueError, match="not a rank"):
        parallel.initialize("localhost:1", num_processes=2, process_id=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="no CUDA device"):
        parallel.initialize("localhost:1", num_processes=1, process_id=0)
    assert not dist.is_initialized()


def test_initialize_is_idempotent(ranks):
    # each worker called initialize twice on a live group
    assert [rec["rank"] for rec in ranks["rec"]] == list(range(RANKS))


def test_one_rank_mesh_shards_and_gathers(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="no CUDA device"):
        parallel.make_mesh()
    assert not dist.is_initialized()
    try:
        mesh = parallel.make_mesh(device="cpu")
        assert mesh.size() == 1 and mesh.mesh_dim_names == ("data",)
        with pytest.raises(ValueError, match="mesh shape"):
            parallel.make_mesh(axes=("data", "model"), shape=(2, 1),
                               device="cpu")
        (place,) = parallel.batch_sharding(mesh, 2)
        assert place.is_shard(0)
        x = torch.arange(10.0, dtype=torch.float64).reshape(5, 2)
        xs, ns = parallel.shard_batch((x, np.arange(5)), mesh)
        assert xs.placements[0].is_shard(0)
        assert torch.equal(parallel.local_shards(xs), x)
        assert torch.equal(parallel.gather(parallel.local_shards(xs), mesh),
                           x)
        assert torch.equal(parallel.local_shards(ns), torch.arange(5))
        rep = parallel.replicate({"w": x}, mesh)["w"]
        assert rep.placements[0].is_replicate()
        assert torch.equal(rep.full_tensor(), x)
        assert parallel.global_batch_mesh(device="cpu").size() == 1
        # lockstep on one rank: the gates read through the group, the same
        # solve, for fixed-stage Radau and for another family (bdf)
        y0 = torch.tensor([[2.0, 0.0]] * 3, dtype=torch.float64)
        mus = torch.tensor([1.0, 10.0, 100.0], dtype=torch.float64)
        opts = Options(rtol=1e-6, atol=1e-9)
        want = solve_radau(vdp_rhs, 0.0, 0.5, y0, args=mus, options=opts)
        want_bdf = solve_ivp(vdp_rhs, (0.0, 0.5), y0, method="bdf", args=mus)
        with parallel.lockstep(mesh):
            got = solve_radau(vdp_rhs, 0.0, 0.5, y0, args=mus, options=opts)
            got_bdf = solve_ivp(vdp_rhs, (0.0, 0.5), y0, method="bdf",
                                args=mus)
        for a, b in ((got, want), (got_bdf, want_bdf)):
            assert torch.equal(a.y, b.y)
            assert torch.equal(a.status, b.status)
            assert torch.equal(a.stats["naccept"], b.stats["naccept"])
    finally:
        dist.destroy_process_group()


def test_sharded_sweep_matches_the_reference_sweep(ranks):
    """examples/sharded_sweep.py's sweep at 2 x 256 lanes: the global mean
    of the steps (all_reduce over the ranks) equals the reference's
    jnp.mean over the same lanes solved in one program."""
    import jax.numpy as jnp

    from janus_tpu.models.problems import vdp_jac as j_vdp_jac
    from janus_tpu.models.problems import vdp_rhs as j_vdp_rhs
    from janus_tpu.solve import Options as JOptions
    from janus_tpu.solve.radau import solve_radau as j_solve_radau

    m = SWEEP_LANES * RANKS
    sol = j_solve_radau(j_vdp_rhs, 0.0, 1.0, jnp.tile(jnp.array([[2.0, 0.0]]),
                                                        (m, 1)),
                        args=jnp.asarray(10.0 ** np.linspace(0.5, 3.0, m)),
                        jac=j_vdp_jac, options=JOptions(rtol=1e-6, atol=1e-9,
                                                        pivoting=False))
    want = float(jnp.mean(sol.stats["nsteps"]))
    for rec in ranks["rec"]:
        assert rec["sweep_ok"] == 1.0
        assert rec["sweep_mean_steps"] == want


@pytest.mark.parametrize("eq,shapes", [
    ("ij,mjd->mid", [(5, 5), (7, 5, 2)]),
    ("ij,...j->...i", [(5, 5), (2, 7, 5)]),
    ("mij,...mj->...mi", [(7, 5, 5), (7, 5)]),
    ("mij,...mj->...mi", [(7, 5, 5), (3, 7, 5)]),
    ("ij,kmjd->kmid", [(5, 5), (2, 7, 5, 2)]),
    ("msq,mqd->msd", [(7, 5, 5), (7, 5, 2)]),
    ("s,msd->md", [(5,), (7, 5, 2)]),
    ("kmsd,sq->kmqd", [(2, 7, 5, 2), (5, 5)]),
    ("mtq,kmqd->kmtd", [(7, 3, 5), (2, 7, 5, 2)]),
    ("kmqd,mq->kmd", [(2, 7, 5, 2), (7, 5)]),
])
def test_broadcast_einsum_is_einsum(eq, shapes):
    """The batch-size-free forms of the lane contractions (``lane_einsum``:
    a broadcast product and a sum on a CUDA tensor, the terms added in
    sequence, plainly or by fused multiply-adds, on the CPU in
    ``lockstep``) compute torch.einsum's function."""
    from janus_tpu_torch.solve.common import broadcast_einsum
    rng = np.random.default_rng(0)
    ops = [torch.as_tensor(rng.standard_normal(s)) for s in shapes]
    want = torch.einsum(eq, *ops)
    for order in ("sum", "plain", "fma"):
        got = broadcast_einsum(eq, *ops, order=order)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-13,
                                   atol=1e-14)
