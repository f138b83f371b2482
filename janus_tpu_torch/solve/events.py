"""Vectorized event detection on the continuous extension.

The port of ``janus_tpu/solve/events.py``. After each accepted step, sign
changes of g(t, y) over the step window are bracketed per (trajectory,
event) lane and polished by a fixed-count bisection on the step's
interpolant, the whole batch at once.

Event spec: ``Event(fn, terminal=True, direction=0)`` with batched
``fn(t [M], y [M, D], args) -> [M]``. direction: 0 = any crossing, +1 = g
rising through zero, −1 = falling.

The reference gates the bisection with ``lax.cond(any(crossed))``. Here the
gate is one host ``any()`` per step: the bisection costs N_BISECT × E
evaluations of g plus the interpolant (some 600+ launches for one event),
one sync much less.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import torch

N_BISECT = 60


@dataclass(frozen=True)
class Event:
    fn: Callable
    terminal: bool = True
    direction: float = 0.0


def normalize_events(events) -> Sequence[Event]:
    if events is None:
        return ()
    if isinstance(events, Event):
        return (events,)
    if callable(events):
        return (Event(events),)
    return tuple(e if isinstance(e, Event) else Event(e) for e in events)


def eval_events(specs, t, y, args):
    """[M, E] stack of event values (E = len(specs); E may be 0)."""
    if not specs:
        return y.new_zeros(y.shape[:-1] + (0,))
    return torch.stack([e.fn(t, y, args) for e in specs], dim=-1)


def init_event_state(specs, m, dim, t0, y0, args):
    return {
        "g": eval_events(specs, t0, y0, args),
        "event_t": y0.new_full((m,), torch.nan),
        "event_y": y0.new_full((m, dim), torch.nan),
        "event_idx": torch.full((m,), -1, dtype=torch.int32,
                                device=y0.device),
    }


def _first(theta):
    """(index, value) of each row's first minimum (the first of a tie, and
    0 on a row of +inf, as ``jnp.argmin``)."""
    idx = torch.argmin(theta, dim=-1)
    return idx, theta.gather(-1, idx[:, None])[:, 0]


def handle_events(specs, ev_state, t_old, h, t_new, y_new, interp, accept,
                  args, syncs=None):
    """Detect and locate events on accepted steps.

    interp: theta [M, K] -> y [M, K, D] (the step's continuous extension).
    syncs: the solve's host-sync counter (``common._HostSyncs``), or None.
    Returns (new_ev_state, terminate [M], t_event [M], y_event [M, D],
    idx [M]: which event fired THIS step, 0 when none).
    """
    m = t_old.shape[0]
    dev = t_old.device
    zero_idx = torch.zeros((m,), dtype=torch.int32, device=dev)
    if not specs:
        return (ev_state, torch.zeros((m,), dtype=torch.bool, device=dev),
                t_new, y_new, zero_idx)

    n_ev = len(specs)
    g_old = ev_state["g"]
    g_new = eval_events(specs, t_new, y_new, args)

    dirs = torch.tensor([e.direction for e in specs], dtype=t_old.dtype,
                        device=dev)
    terminal = torch.tensor([e.terminal for e in specs], dtype=torch.bool,
                            device=dev)

    sign_change = (g_old * g_new <= 0.0) & (g_old != g_new)
    dir_ok = torch.where(dirs[None, :] == 0.0, True,
                         torch.where(dirs[None, :] > 0.0, g_old < g_new,
                                     g_old > g_new))
    crossed = sign_change & dir_ok & accept[:, None] & (g_old != 0.0)

    if not (syncs.any(crossed) if syncs is not None else bool(crossed.any())):
        hit = torch.zeros((m,), dtype=torch.bool, device=dev)
        terminate, idx, t_ev, y_ev = hit, zero_idx, t_new, y_new
    else:
        # bisection per (lane, event) on theta ∈ [0, 1]
        lo = torch.zeros_like(g_old)
        hi = torch.ones_like(g_old)
        glo = g_old

        def g_at(theta):
            y_pts = interp(theta)                         # [M, E, D]
            t_pts = t_old[:, None] + theta * h[:, None]
            return torch.stack([specs[e].fn(t_pts[:, e], y_pts[:, e, :], args)
                                for e in range(n_ev)], dim=-1)

        for _ in range(N_BISECT):
            mid = 0.5 * (lo + hi)
            gmid = g_at(mid)
            left = glo * gmid <= 0.0
            hi = torch.where(left, mid, hi)
            lo = torch.where(left, lo, mid)
            glo = torch.where(left, glo, gmid)
        theta_root = torch.where(crossed, 0.5 * (lo + hi), torch.inf)
        # earliest crossing per lane (any event), and the earliest TERMINAL
        # crossing: the solve stops there even when a non-terminal event
        # crossed earlier in the same step (scipy's semantics)
        first, theta_first = _first(theta_root)
        first_term, theta_first_term = _first(
            torch.where(terminal[None, :], theta_root, torch.inf))
        hit = crossed.any(dim=-1)
        terminate = (crossed & terminal[None, :]).any(dim=-1)
        # terminating lanes report the terminal crossing (the truncation
        # point, and the adjoint's and IND's jump data); others the earliest
        idx = torch.where(terminate, first_term, first).to(torch.int32)
        theta_sel = torch.where(terminate, theta_first_term, theta_first)
        theta_eval = torch.where(torch.isfinite(theta_sel), theta_sel, 1.0)
        y_ev = interp(theta_eval[:, None])[:, 0, :]
        t_ev = t_old + theta_eval * h

    # record the FIRST event per lane; a terminal crossing is authoritative
    # (the truncation point the adjoint jump reads through event_idx/t) and
    # overwrites a non-terminal recording from an earlier step
    fresh = (hit & (ev_state["event_idx"] < 0)) | terminate
    new_state = {
        "g": torch.where(accept[:, None], g_new, g_old),
        "event_t": torch.where(fresh, t_ev, ev_state["event_t"]),
        "event_y": torch.where(fresh[:, None], y_ev, ev_state["event_y"]),
        "event_idx": torch.where(fresh, idx, ev_state["event_idx"]),
    }
    return new_state, terminate, t_ev, y_ev, idx
