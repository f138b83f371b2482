"""janus_tpu_torch.diag's profiler hooks on torch.profiler (twins of
tests/test_profile.py), and the Radau step's four named spans."""

import glob
import os

import numpy as np
import torch

from janus_tpu_torch import diag
from janus_tpu_torch.models.problems import vdp_jac, vdp_rhs
from janus_tpu_torch.solve import Options, solve_ivp
from janus_tpu_torch.solve.radau import solve_radau

SPANS = ("radau.jacobian", "radau.factorize", "radau.qr_fallback",
         "radau.newton")


def test_trace_writes_profile(tmp_path):
    logdir = str(tmp_path / "jtrace")

    def rhs(t, y, args):
        return -y

    with diag.trace(logdir):
        sol = solve_ivp(rhs, (0.0, 1.0), torch.ones((4, 2),
                                                    dtype=torch.float64),
                        method="dopri5", options=Options(rtol=1e-6,
                                                         atol=1e-9))
    hits = glob.glob(os.path.join(logdir, "**", "*.pt.trace.json"),
                     recursive=True)
    assert hits, f"no trace written under {logdir}"
    assert bool((sol.status == 1).all())


def test_annotate_and_scope_are_transparent():
    with diag.annotate("outer"):
        with diag.scope("inner"):
            x = torch.arange(4.0) * 2.0
    np.testing.assert_allclose(x.numpy(), [0.0, 2.0, 4.0, 6.0])

    def f(v):
        with diag.scope("phase"):
            return v * v

    v = torch.tensor(3.0, dtype=torch.float64)
    val, tan = torch.func.jvp(f, (v,), (torch.ones_like(v),))
    assert float(val) == 9.0 and float(tan) == 6.0
    assert float(torch.func.grad(f)(v)) == 6.0
    np.testing.assert_allclose(torch.func.vmap(f)(torch.arange(3.0)).numpy(),
                               [0.0, 1.0, 4.0])


def test_radau_spans_in_a_cpu_profile():
    """One span of each phase an attempt; the QR fallback's only with
    Options(qr_fallback=True)."""
    m = 4
    y0 = torch.tensor([[2.0, 0.0]], dtype=torch.float64).repeat(m, 1)
    mus = torch.logspace(0, 1, m, dtype=torch.float64)
    for qr in (False, True):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            sol = solve_radau(vdp_rhs, 0.0, 0.02, y0, args=mus, jac=vdp_jac,
                              options=Options(rtol=1e-6, atol=1e-9,
                                              qr_fallback=qr))
        calls = {s: 0 for s in SPANS}
        for e in prof.events():
            if e.name in calls:
                calls[e.name] += 1
        attempts = int(sol.stats["nsteps"].max())
        assert attempts > 1
        want = {s: attempts for s in SPANS}
        if not qr:
            want["radau.qr_fallback"] = 0
        assert calls == want


def test_device_memory_stats_shape():
    stats = diag.device_memory_stats()
    assert isinstance(stats, dict)
    assert diag.device_memory_stats("cpu") == {}


def test_marginal_seconds_positive():
    def make_chained(n):
        def run(x):
            for _ in range(n * 200):
                x = torch.sin(x) + 1e-6
            return x
        return run

    dt = diag.marginal_seconds(make_chained, torch.ones(256),
                               n_lo=1, n_hi=4)
    assert dt > 0.0


def test_trace_file_spans_match_the_profiler(tmp_path):
    """bench.infra.trace_spans reads the radau.* spans from the written
    trace: the calls the profiler's own events count."""
    from janus_tpu_torch.bench import infra
    y0 = torch.tensor([[2.0, 0.0]], dtype=torch.float64).repeat(4, 1)
    with diag.trace(str(tmp_path)) as prof:
        solve_radau(vdp_rhs, 0.0, 0.02, y0, args=2.0, jac=vdp_jac,
                    options=Options(rtol=1e-6, atol=1e-9, qr_fallback=True))
    (path,) = tmp_path.glob("*.pt.trace.json")
    got = infra.trace_spans(path)
    want = {s: 0 for s in SPANS}
    for e in prof.events():
        if e.name in want:
            want[e.name] += 1
    assert {s: v["calls"] for s, v in got.items()} == want
    assert min(want.values()) > 0
    assert all(v["host_ms"] > 0 for v in got.values())
