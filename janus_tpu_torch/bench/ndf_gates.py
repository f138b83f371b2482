"""A/B of the NDF loop's gates on a card: ``solve_bdf`` as it is (one host
read an attempt serves the loop condition and the gates of the deferred
end-of-attempt rescale, the boundary clamp, the Jacobian refresh and the
factorization) against the same solve with those four gates forced open
(every attempt builds both transforms, evaluates J and factors, and selects
per lane, the way ``solve_rodas`` works).

    python3 -m janus_tpu_torch.bench.ndf_gates [--json PATH]

The ungated variant is made at run time from the source of
``janus_tpu_torch/solve/ndf.py`` by replacing the one statement that reads
the gates; nothing of it is kept. Both run the 65,536 headline lanes of
``bench.ndf`` (VdP mu = 1e3, rtol 1e-6, K=2 IND), with kernel_lu=True and
with the plain pivot-free LU, in alternating turns (gated, ungated,
ungated, gated, gated, ungated; CUDA events), then one solve of each under
torch.profiler. Checks: results equal to the bit, host syncs equal.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import sys
from pathlib import Path

import torch

from janus_tpu_torch.bench import mol
from janus_tpu_torch.bench.kernels import events_ms
from janus_tpu_torch.bench.ndf import FWD_OPTS, M_FWD
from janus_tpu_torch.models.problems import vdp_jac, vdp_rhs
from janus_tpu_torch.solve import Options
from janus_tpu_torch.solve import ndf as gated

GATE_READ = '''        go, any_resc, any_clamp, any_j, any_f = syncs.any_each(
            active, rescale, clamped, needj, needf)'''
OPEN = '''        go = syncs.any(active)
        any_resc = any_clamp = any_j = any_f = True'''


def ungated_module():
    """solve/ndf.py with its four gates forced open, as a module of its
    own."""
    src = Path(gated.__file__).read_text()
    if src.count(GATE_READ) != 1:
        raise RuntimeError("solve/ndf.py no longer reads its gates in the "
                           "expected statement")
    spec = importlib.util.spec_from_loader("ndf_ungated", loader=None)
    mod = importlib.util.module_from_spec(spec)
    exec(compile(src.replace(GATE_READ, OPEN), "ndf_ungated", "exec"),
         mod.__dict__)
    return mod


def solve(mod, dev, kernel_lu, m=M_FWD):
    dtype = torch.float64
    y0 = torch.tensor([[2.0, 0.0]], dtype=dtype, device=dev).repeat(m, 1)
    mus = torch.full((m,), 1e3, dtype=dtype, device=dev)
    seeds = torch.zeros((2, m, 2), dtype=dtype, device=dev)
    seeds[0, :, 0] = 1.0
    seeds[1, :, 1] = 1.0
    return mod.solve_bdf(vdp_rhs, 0.0, 1.0, y0, mus,
                         Options(kernel_lu=kernel_lu, **FWD_OPTS),
                         jac=vdp_jac, tangents=seeds)


def run(dev):
    mods = {"gated": gated, "ungated": ungated_module()}
    report = {}
    for kernel_lu in (True, False):
        for mod in mods.values():
            solve(mod, dev, kernel_lu, m=64)              # warm-up, build
        ms = {name: [] for name in mods}
        out = {}
        for name in ("gated", "ungated", "ungated", "gated", "gated",
                     "ungated"):
            mol._reset_kernel_launches()
            res = []
            ms[name].append(events_ms(
                lambda: res.append(solve(mods[name], dev, kernel_lu)), 1))
            out[name] = (res[0], mol._kernel_launches(),
                         mods[name].solve_bdf.host_syncs)
        a, b = out["gated"][0], out["ungated"][0]
        if not (torch.equal(a.y, b.y) and torch.equal(a.sens, b.sens)
                and out["gated"][2] == out["ungated"][2]):
            raise RuntimeError("gated and ungated solves differ")
        prof = {name: mol.profile_solve(
            lambda wrap, _m=mod: solve(_m, dev, kernel_lu))
            for name, mod in mods.items()}
        key = "kernel_lu" if kernel_lu else "plain_lu"
        report[key] = {
            "ms": ms, "median_ms": {k: statistics.median(v)
                                    for k, v in ms.items()},
            "launches_K": {k: v[1] for k, v in out.items()},
            "host_syncs": {k: v[2] for k, v in out.items()},
            "launches": {k: v["launches"] for k, v in prof.items()},
            "busy_ms": {k: v["busy_ms"] for k, v in prof.items()}}
        print(f"[ndf gates {key}] " + json.dumps(report[key]), flush=True)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", type=Path, default=None)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ndf_gates: no CUDA device", file=sys.stderr)
        return 2
    report = {"device": torch.cuda.get_device_name(0),
              **run(torch.device("cuda:0"))}
    line = json.dumps(report)
    if a.json is not None:
        a.json.parent.mkdir(parents=True, exist_ok=True)
        a.json.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
