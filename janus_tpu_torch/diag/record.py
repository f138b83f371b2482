"""Fixed-capacity per-step playback buffers (``Solution.dyn``).

The port of ``janus_tpu/diag/record.py``. One record per step attempt of a
lane: t, h, the error norm, the Newton iterations and whether the attempt
was accepted, written by index (gather, select, scatter, as
``solve.common.ring_write``): no host sync.
"""

from __future__ import annotations

import torch

DYN_FIELDS = ("t", "h", "err", "niter", "accepted")


def init_dyn(m: int, capacity: int, y0, dim: int = 0):
    """Buffers [M, K] (NaN-padded), or None when capacity <= 0. With dim >
    0 the accepted state is stored too, [M, K, D]. y0 gives the dtype and
    the device."""
    if capacity <= 0:
        return None
    dev = y0.device
    out = {
        "t": y0.new_full((m, capacity), torch.nan),
        "h": y0.new_full((m, capacity), torch.nan),
        "err": y0.new_full((m, capacity), torch.nan),
        "niter": torch.zeros((m, capacity), dtype=torch.int32, device=dev),
        "accepted": torch.zeros((m, capacity), dtype=torch.bool, device=dev),
        "idx": torch.zeros((m,), dtype=torch.int32, device=dev),
    }
    if dim:
        out["y"] = y0.new_full((m, capacity, dim), torch.nan)
    return out


def record_step(dyn, attempted, t, h, err, niter, accepted, y=None):
    """Write one attempt's record for every lane in ``attempted`` [M] at the
    lane's next slot, the last slot once the capacity is used up (it then
    keeps the latest attempt). In place; returns dyn."""
    if dyn is None:
        return None
    cap = dyn["t"].shape[1]
    at = torch.clamp(dyn["idx"], max=cap - 1).to(torch.int64)
    values = {"t": t, "h": h, "err": err, "niter": niter,
              "accepted": accepted}
    if "y" in dyn and y is not None:
        values["y"] = y
    for key, val in values.items():
        buf = dyn[key]
        val = val.to(buf.dtype).unsqueeze(1)                # [M, 1, ...]
        index = at.reshape((-1,) + (1,) * (val.ndim - 1)).expand_as(val)
        keep = attempted.reshape((-1,) + (1,) * (val.ndim - 1))
        buf.scatter_(1, index, torch.where(keep, val, buf.gather(1, index)))
    dyn["idx"] = dyn["idx"] + attempted.to(torch.int32)
    return dyn
