"""``parallel.lockstep`` for every solver family, the discrete adjoints and
the control loops, on CPU process groups (gloo), against the one-process
solve and against the reference's sharded solve.

Two real OS processes (``bench.lockstep``'s ranks, started once for the
module) join a gloo group, each solves its half of the lanes of every case
in ``parallel.lockstep`` (every host gate read over both ranks) and the
results come back through the group; the one-process solves run in the test
process meanwhile. The inputs are ``bench.lockstep``'s, with mu =
logspace(1, 3) where a probe's headline has one mu, so that the ranks'
own gates would part:
- each family of ``bench.lockstep.FORWARD`` (128 lanes, K=2 IND where the
  family takes tangents, K1/K2's twins through ``kernel_lu=True`` where it
  factors): y, sens, status, naccept and nreject equal to the one-process
  solve to the bit;
- the four discrete adjoints and the radaup gradient (64 lanes): lambda(t0)
  and each lane's dL/dmu equal to the bit, the shared parameters' gradient
  all-reduced over the ranks within 1e-12 of its largest entry;
- one iteration of the multiple-shooting PMP Newton (16 instances): x,
  fnorm and iters equal to the bit.
rodas, dopri5 and NDF are also held to the reference's ``shard_batch``
solve on the 8-device virtual mesh (``tests/test_fixed_and_parallel.py``'s
form) at their parity tests' tolerances: status and naccept equal, y to
1e-10 of the array's largest entry, sens to 1e-9 (rodas) and 1e-7 (NDF).
In one process: every family under a one-rank ``lockstep`` equals its plain
solve to the bit, and the unbatched GMRES of ``control.krylov`` refuses to
run in ``lockstep``.
"""

import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from janus_tpu_torch import parallel
from janus_tpu_torch.bench import lockstep as L

M_FORWARD = 128
M_ADJOINT = 64
M_NEWTON = 16
CASES = L.FORWARD + L.ADJOINT + L.NEWTON
LANES = {**{c: M_FORWARD for c in L.FORWARD},
         **{c: M_ADJOINT for c in L.ADJOINT},
         **{c: M_NEWTON for c in L.NEWTON}}
CPU = torch.device("cpu")
SENS_TOL = {"rodas": 1e-9, "ndf": 1e-7}


def _inputs(name):
    return L.case_inputs(name, LANES[name])


def _reference_sharded(name):
    """The reference's solve of the case's inputs, sharded over the
    8-device virtual mesh as tests/test_fixed_and_parallel.py shards it:
    {y, status, naccept[, sens]} as numpy."""
    from janus_tpu.models.problems import vdp_jac, vdp_rhs
    from janus_tpu.parallel import make_mesh, shard_batch
    from janus_tpu.solve import Options, solve_ivp

    inp = {k: jnp.asarray(v.numpy()) for k, (v, _) in _inputs(name).items()}
    mesh = make_mesh(8)
    y0, mus = shard_batch((inp["y0"], inp["mus"]), mesh)
    if name == "dopri5":
        kw = dict(method="dopri5", options=Options(rtol=1e-7, atol=1e-9))
        span = (0.0, 10.0)
    else:
        kw = dict(method={"rodas": "rodas", "ndf": "bdf"}[name], jac=vdp_jac,
                  options=Options(rtol=1e-6, atol=1e-9, pivoting=False,
                                  pallas_lu=True))
        span = (0.0, 1.0)
    seeds = inp.get("seeds")
    if seeds is not None:
        seeds = jax.device_put(seeds, NamedSharding(mesh, P(None, "data")))

    @jax.jit
    def run(y0, mus, seeds):
        sol = solve_ivp(vdp_rhs, span, y0, args=mus, tangents=seeds, **kw)
        return sol.y, sol.status, sol.stats["naccept"], sol.sens

    y, status, naccept, sens = run(y0, mus, seeds)
    assert len(y.sharding.device_set) == 8
    out = {"y": y, "status": status, "naccept": naccept}
    if sens is not None:
        out["sens"] = sens
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each case's gathered arrays, with the one-process results and the
    reference's sharded solves computed while the ranks ran."""
    out = tmp_path_factory.mktemp("lockstep")
    env = dict(os.environ)
    here = Path(__file__).resolve().parent
    env["PYTHONPATH"] = os.pathsep.join([str(here.parent),
                                         env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    procs = L.start(out, CASES, LANES, "cpu", env=env,
                    cmd=[sys.executable, "-m", "janus_tpu_torch.bench.lockstep",
                         "--worker"])
    try:
        one = {name: L.case_run(name, L.on(_inputs(name), CPU))
               for name in CASES}
        ref = {name: _reference_sharded(name)
               for name in ("rodas", "dopri5", "ndf")}
        got, recs = L.collect(procs, out, CASES, timeout=900)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return {"one": one, "ref": ref, "got": got, "recs": recs}


@pytest.mark.parametrize("family", L.FORWARD)
def test_sharded_family_equals_one_process(ranks, family):
    res, _ = ranks["one"][family]
    assert L.compare(family, ranks["got"][family], res) == 0.0
    assert set(res) >= {"y", "status", "naccept", "nreject"}
    # the lanes' own gates would part: their step counts differ
    assert len(np.unique(res["naccept"][0].numpy())) > 1


@pytest.mark.parametrize("case", L.ADJOINT)
def test_sharded_adjoint_equals_one_process(ranks, case):
    res, shared = ranks["one"][case]
    assert "lam0" in res and shared
    assert np.isfinite(res["lam0"][0].numpy()).all()
    assert L.compare(case, ranks["got"][case], res, shared) <= 1e-12


def test_sharded_shooting_newton_equals_one_process(ranks):
    res, _ = ranks["one"]["newton"]
    assert (res["iters"][0] == 1).all()
    assert L.compare("newton", ranks["got"]["newton"], res) == 0.0


@pytest.mark.parametrize("family", ["rodas", "dopri5", "ndf"])
def test_sharded_family_matches_the_reference_sharded_solve(ranks, family):
    got, ref = ranks["got"][family], ranks["ref"][family]
    for k in ("status", "naccept"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for k, tol in (("y", 1e-10), ("sens", SENS_TOL.get(family))):
        if k in ref:
            np.testing.assert_allclose(
                got[k], ref[k], rtol=0,
                atol=tol * float(np.max(np.abs(ref[k]))), err_msg=k)


def test_one_rank_lockstep_and_the_unbatched_gmres_refusal():
    """On a one-rank group every family's solve in lockstep equals its
    plain solve to the bit (the reads go through the group); krylov.gmres
    and newton_krylov, whose gates are scalars of one unbatched system,
    raise there."""
    from janus_tpu_torch.control import krylov
    from janus_tpu_torch.solve.common import host_any

    assert not dist.is_initialized()
    try:
        mesh = parallel.make_mesh(device="cpu")
        for name in L.FORWARD:
            inp = L.on(L.case_inputs(name, 8), CPU)
            want, _ = L.case_run(name, inp, span=0.1)
            with parallel.lockstep(mesh):
                got, _ = L.case_run(name, inp, span=0.1)
            for k, (v, _) in want.items():
                assert torch.equal(got[k][0], v), f"{name} {k}"
        a = torch.tensor([[4.0, 1.0], [1.0, 3.0]], dtype=torch.float64)
        b = torch.tensor([1.0, 2.0], dtype=torch.float64)
        x = krylov.gmres(lambda v: a @ v, b, tol=1e-12)
        np.testing.assert_allclose((a @ x).numpy(), b.numpy(), atol=1e-10)
        with parallel.lockstep(mesh):
            assert host_any(torch.tensor([False, True]))
            assert not host_any(torch.zeros(3, dtype=torch.bool))
            with pytest.raises(NotImplementedError, match="lockstep"):
                krylov.gmres(lambda v: a @ v, b)
            with pytest.raises(NotImplementedError, match="krylov.gmres"):
                krylov.newton_krylov(lambda z: z * z - 2.0,
                                     torch.ones((3, 2), dtype=torch.float64))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("case", ["rodas_adjoint", "radaup_adjoint"])
def test_backward_on_another_thread_reads_over_the_group(monkeypatch, case):
    """The autograd engine runs a CUDA backward on a thread of its own,
    where the caller's ``lockstep`` context is not set: the adjoints'
    backward sweeps (the discrete one's and radau_adjoint's) still read
    their gates over the group their forward ran under. Here the backward
    runs on a fresh thread, and every host read it makes goes through the
    one-rank group."""
    import threading

    from janus_tpu_torch.solve import common as cm

    groups = []
    init = cm._HostSyncs.__init__

    def spy(self, *a, **kw):
        init(self, *a, **kw)
        groups.append(self.group)

    assert not dist.is_initialized()
    try:
        mesh = parallel.make_mesh(device="cpu")
        inp = L.on(L.case_inputs(case, 4), CPU)
        y0 = inp["y0"].clone().requires_grad_()
        from janus_tpu_torch.models.problems import vdp_jac, vdp_rhs
        from janus_tpu_torch.solve import Options, solve_adjoint
        from janus_tpu_torch.bench import radaup as rp
        from janus_tpu_torch.bench import rodas as ro
        method, opts = {"rodas_adjoint": ("rodas", ro.ADJ_OPTS),
                        "radaup_adjoint": ("radaup", rp.ADJ_OPTS)}[case]
        with parallel.lockstep(mesh):
            y_end = solve_adjoint(vdp_rhs, (0.0, 0.2), y0, method=method,
                                  args=inp["mus"], options=Options(**opts),
                                  jac=vdp_jac)
        monkeypatch.setattr(cm._HostSyncs, "__init__", spy)
        worker = threading.Thread(
            target=lambda: torch.sum(y_end ** 2).backward())
        worker.start()
        worker.join()
        assert groups and all(g is mesh.get_group() for g in groups)
        assert torch.isfinite(y0.grad).all()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("eq,shape_of", [
    ("s,msd->md", lambda m, s: [(s,), (m, s, 2)]),
    ("ij,mjd->mid", lambda m, s: [(s, s), (m, s, 2)]),
    ("ij,kmjd->kmid", lambda m, s: [(s, s), (2, m, s, 2)]),
    ("msd,sq->mqd", lambda m, s: [(m, s, 2), (s, s)]),
    ("ij,...j->...i", lambda m, s: [(s, s), (2, m, s)]),
    ("msq,mqd->msd", lambda m, s: [(m, s, s), (m, s, 2)]),
])
def test_cpu_contractions_in_lockstep_round_as_torch_einsum(eq, shape_of):
    """On the CPU ``torch.einsum`` adds plainly below ATen's 400
    multiply-adds and by MKL's fused multiply-adds above, so its rounding
    follows the lane count; inside ``lockstep`` ``lane_einsum`` takes the
    order ``torch.einsum`` takes for the whole batch over the ranks: on one
    rank, exactly ``torch.einsum``'s result, on either side of the bound."""
    from janus_tpu_torch.solve.common import lane_einsum

    rng = np.random.default_rng(7)
    assert not dist.is_initialized()
    try:
        mesh = parallel.make_mesh(device="cpu")
        for m in (2, 7, 13, 20, 40, 64, 129):
            for s in (1, 3, 5, 7):
                ops = [torch.as_tensor(rng.standard_normal(sh))
                       for sh in shape_of(m, s)]
                with parallel.lockstep(mesh):
                    got = lane_einsum(eq, *ops)
                assert torch.equal(got, torch.einsum(eq, *ops)), (m, s)
    finally:
        dist.destroy_process_group()


def test_lane_einsum_refuses_an_unnamed_lane_index():
    """The lanes of a ``lane_einsum`` are ``m`` or ``...``: an equation
    that names neither raises, on every device and outside ``lockstep``
    too, so that a new call site cannot part the ranks by an ulp."""
    from janus_tpu_torch.solve.common import lane_einsum

    a = torch.ones((3, 2), dtype=torch.float64)
    v = torch.ones((4, 2), dtype=torch.float64)
    with pytest.raises(ValueError, match="lane index"):
        lane_einsum("ij,nj->ni", a, v)
    assert torch.equal(lane_einsum("ij,mj->mi", a, v),
                       torch.einsum("ij,mj->mi", a, v))
