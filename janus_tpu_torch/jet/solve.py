"""Dual-number solves, as ``janus_tpu.jet.solve``: seed N tangent
directions, push them through the adaptive solve, get a Jet solution back.

Two routes compute the same sensitivities. The fast one is the solvers'
internal differentiation (``tangents=``/``args_tangents=``: one primal solve
whose accepted steps carry the N tangent sweeps on the step's own LU
factors). Every other request goes through the transform:
``torch.func.vmap`` over ``torch.func.jvp`` of the whole solve, so the
tangents flow through step-size selection, Newton and accept/reject as the
reference's duals do, including the final-time column (pass a Jet tf).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable

import torch

from janus_tpu_torch.jet.core import Jet, is_jet, seed_identity
from janus_tpu_torch.solve import Options, solve_ivp
from janus_tpu_torch.solve.common import like, on_device, tree_leaves, tree_map

_RADAU = ("radau", "radau5", "radau9", "radau13")
_IND = _RADAU + ("radaup", "seulex", "rodas", "bdf", "ndf", "bdf_classic")
_TERMINAL_ONLY = ("seulex", "rodas", "bdf", "ndf", "bdf_classic")
_OPT_FIELDS = {f.name for f in dataclasses.fields(Options)}


def _fast_path_blockers(method, tf_is_jet, options, kw):
    """(blockers, options, kw): why the IND sweep cannot serve this request
    (the reference's list and words), and, when it can, the options with
    the option keywords folded in and kw cut to what solve_ivp takes."""
    terminal_only = method in _TERMINAL_ONLY
    pass_kw = {"jac", "mass", "device"} | (set() if terminal_only
                                           else {"t_eval", "events"})
    blockers = []
    if tf_is_jet and ("mass" in kw or "events" in kw):
        # dy/dtf = M⁻¹f needs a mass solve; an event lane's terminal time
        # is t*, not tf: both stay on the transform path
        blockers.append("tf tangents with mass/events")
    extra_kw = set(kw) - pass_kw - _OPT_FIELDS
    if extra_kw:
        blockers.append(f"kwargs {sorted(extra_kw)}"
                        + (f" ({method} IND is terminal-mode only)"
                           if terminal_only else ""))
    if blockers:
        return blockers, options, kw
    o = options if options is not None else Options()
    o = o.replace(**{k: v for k, v in kw.items() if k in _OPT_FIELDS})
    kw = {k: v for k, v in kw.items() if k in pass_kw}
    if method in _RADAU and o.min_stages != o.max_stages:
        blockers.append("variable stage count (min_stages != max_stages)")
    if o.stage_solver != "lu" and method not in _RADAU + (
            "bdf", "ndf", "bdf_classic"):
        blockers.append("stage_solver='gmres' (IND rides the matrix-free "
                        "stage solvers in radau and bdf only)")
    return blockers, o, kw


def dual_solve_ivp(f: Callable, tspan, y0, method: str = "radau",
                   args: Any = None, options=None, **kw):
    """solve_ivp with Jet-valued y0 / tf / args leaves.

    Any of y0, tspan[1], or args leaves may be Jets (sharing one sensitivity
    width N). Returns (y_final as Jet [M, D], t_final as Jet [M], Solution
    of the primal solve for stats/status). ``device=`` is solve_ivp's.
    """
    t0, tf = tspan
    jets = []

    def split(x):
        if is_jet(x):
            jets.append(x)
            return x.r
        return x

    y0_r = on_device(split(y0), kw.get("device"))
    tf_r = split(tf)
    args_r = tree_map(split, args, is_leaf=is_jet)
    if not jets:
        raise ValueError("dual_solve_ivp: no Jet inputs; use solve_ivp")
    n = jets[0].nsens

    def tangent_of(x, xr):
        if is_jet(x):
            return x.d
        z = like(xr, y0_r)
        return z.new_zeros((n,) + tuple(z.shape))

    y0_d = tangent_of(y0, y0_r)
    tf_d = tangent_of(tf, tf_r)
    args_has_d = any(is_jet(a) for a in tree_leaves(args, is_leaf=is_jet))
    tf_is_jet = is_jet(tf)

    if method in _IND:
        blockers, o, ind_kw = _fast_path_blockers(method, tf_is_jet, options,
                                                  kw)
        if not blockers:
            args_d = (tree_map(tangent_of, args, args_r, is_leaf=is_jet)
                      if args_has_d else None)
            sol = solve_ivp(f, (t0, tf_r), y0_r, method=method, args=args_r,
                            options=o, tangents=y0_d, args_tangents=args_d,
                            **ind_kw)
            sens = sol.sens
            dtz = sol.t.new_zeros((n,) + tuple(sol.t.shape))
            if tf_is_jet:
                # terminal-time column: dy(T)/dT = f(T, y(T)), one rhs call
                f_term = f(sol.t, sol.y, args_r)
                tfd = tf_d if tf_d.ndim == 2 else tf_d[:, None]
                tfd = tfd.broadcast_to((n,) + tuple(sol.t.shape)).to(
                    sol.t.dtype)
                sens = sens + tfd[:, :, None] * f_term[None]
                dtz = tfd
            if sol.sens_t is not None:
                # event-terminated lanes: t* moves with the seeds
                # (implicit-function dt*; zero on lanes that ran to tf)
                dtz = sol.sens_t
            return Jet(sol.y, sens), Jet(sol.t, dtz), sol
        warnings.warn(
            "dual_solve_ivp: falling back to the vmapped-jvp transform "
            f"(~3x slower than internal differentiation) because: "
            f"{'; '.join(blockers)}", stacklevel=2)

    # the transform: jvp in y0, tf and the Jet leaves of args (the other
    # leaves have zero tangents and need not be tensors)
    flat = tree_leaves(args, is_leaf=is_jet)
    flat_r = tree_leaves(args_r)
    at = [i for i, a in enumerate(flat) if is_jet(a)]
    tf_t = like(tf_r, y0_r)

    def args_with(leaves):
        new = list(flat_r)
        for i, leaf in zip(at, leaves):
            new[i] = leaf
        it = iter(new)
        return tree_map(lambda _: next(it), args_r)

    def primal(y0p, tfp, *jet_leaves):
        sol = solve_ivp(f, (t0, tfp), y0p, method=method,
                        args=args_with(jet_leaves), options=options, **kw)
        return sol.y, sol.t

    sol_full = solve_ivp(f, (t0, tf_r), y0_r, method=method, args=args_r,
                         options=options, **kw)
    primals = (y0_r, tf_t) + tuple(flat_r[i] for i in at)

    def one(dy0, dtf, *dargs):
        return torch.func.jvp(primal, primals, (dy0, dtf) + dargs)[1]

    dy, dt = torch.func.vmap(one)(y0_d, tf_d, *(flat[i].d for i in at))
    return Jet(sol_full.y, dy), Jet(sol_full.t, dt), sol_full


def solve_with_sensitivities(f: Callable, tspan, y0, method: str = "radau",
                             args: Any = None, options=None,
                             wrt_tf: bool = False, **kw):
    """Identity-seeded ∂y(T)/∂y0 (and the final-time column with wrt_tf).

    Returns (Jet y_final with N = D (+1) sensitivities, Solution). d[j] for
    j < D is ∂y(T)/∂y0_j; the last column (with wrt_tf) is ∂y(T)/∂T =
    f(T, y(T)). ``device=`` is solve_ivp's.
    """
    y0 = on_device(y0, kw.get("device"))
    if y0.ndim < 2:
        y0 = y0.reshape(1, -1)
    extra = 1 if wrt_tf else 0
    y0j = seed_identity(y0, extra=extra)
    t0, tf = tspan
    if wrt_tf:
        m = y0.shape[0]
        tfr = like(tf, y0).broadcast_to((m,))
        dtf = y0.new_zeros((y0.shape[-1] + 1, m))
        dtf[-1] = 1.0
        tf_in = Jet(tfr, dtf)
    else:
        tf_in = tf
    yj, _, sol = dual_solve_ivp(f, (t0, tf_in), y0j, method=method,
                                args=args, options=options, **kw)
    return yj, sol
