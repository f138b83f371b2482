"""Radau IIA tableaux derived numerically for any stage count s ∈ {1,3,5,7}.

The port's own copy of ``janus_tpu/solve/radau_tables.py`` (numpy only):
importing the reference module would import jax through
``janus_tpu/__init__.py``. Nodes come from the right-Radau polynomial, A from
the collocation conditions, the real/complex eigen-structure of A⁻¹ for the
transformed Newton systems, the embedded-error weights E from quadrature
order conditions, and the dense-output matrix P from the collocation
polynomial — all in float64 numpy, once per s.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np


class RadauTableau(NamedTuple):
    s: int                    # number of stages
    order: int                # 2s - 1
    c: np.ndarray             # [s] abscissae, c[-1] == 1
    a: np.ndarray             # [s, s] Runge-Kutta matrix
    b: np.ndarray             # [s] weights (== a[-1], stiffly accurate)
    mu_real: float            # the real eigenvalue of A⁻¹
    mu_complex: np.ndarray    # [(s-1)//2] complex (conjugate taken, Im < 0)
    t_mat: np.ndarray         # [s, s] W→Z transform (Z = T W)
    ti_mat: np.ndarray        # [s, s] Z→W transform (W = TI Z)
    e: np.ndarray             # [s] embedded-error weights: err ≈ LU⁻¹(f0 + Z·E/h)
    p: np.ndarray             # [s, s] dense-output: Q = Zᵀ·P, y(θ)=y0+Q·[θ,…,θˢ]


def _radau_nodes(s: int) -> np.ndarray:
    """Right-Radau abscissae on (0, 1]: roots of P̃_s − P̃_{s−1} (shifted
    Legendre), which include the endpoint 1."""
    from numpy.polynomial import legendre as L

    ck = np.zeros(s + 1)
    ck[s] = 1.0
    ck[s - 1] = -1.0
    roots_t = L.legroots(ck)
    x = (roots_t + 1.0) / 2.0
    x = np.sort(np.real_if_close(x))
    x[-1] = 1.0
    return x


@lru_cache(maxsize=None)
def radau_tableau(s: int) -> RadauTableau:
    if s == 1:
        # implicit Euler (Radau IIA with one stage)
        c = np.array([1.0])
        a = np.array([[1.0]])
        return RadauTableau(
            s=1, order=1, c=c, a=a, b=a[-1],
            mu_real=1.0, mu_complex=np.zeros(0, complex),
            t_mat=np.array([[1.0]]), ti_mat=np.array([[1.0]]),
            e=np.array([-1.0]),
            p=np.array([[1.0]]),
        )
    if s % 2 == 0:
        raise ValueError("Radau IIA stage count must be odd (1,3,5,7)")

    c = _radau_nodes(s)
    # collocation: A·V = R with V[j,k] = c_j^{k-1}, R[i,k] = c_i^k/k
    vand = np.vander(c, s, increasing=True)
    rhs = np.stack([c ** k / k for k in range(1, s + 1)], axis=-1)
    a = rhs @ np.linalg.inv(vand)
    b = a[-1]

    ainv = np.linalg.inv(a)
    lam, v = np.linalg.eig(ainv)
    # the single real eigenvalue first, then complex pairs by ascending |Im|,
    # keeping the +Im member
    real_idx = int(np.argmin(np.abs(lam.imag)))
    mu_real = float(lam[real_idx].real)
    pos = [i for i in range(s) if i != real_idx and lam[i].imag > 0]
    pos.sort(key=lambda i: abs(lam[i].imag))
    cols = [np.real(v[:, real_idx])]
    mus = []
    for i in pos:
        vec = v[:, i]
        vec = vec / vec[-1] if abs(vec[-1]) > 1e-8 else vec / vec[np.argmax(np.abs(vec))]
        cols.append(np.real(vec))
        cols.append(np.imag(vec))
        # left-row combination TI[2k-1]+i·TI[2k] has eigenvalue conj(λ)
        mus.append(np.conj(lam[i]))
    vr = cols[0]
    vr = vr / vr[-1] if abs(vr[-1]) > 1e-8 else vr / vr[np.argmax(np.abs(vr))]
    cols[0] = vr
    t_mat = np.stack(cols, axis=1)
    ti_mat = np.linalg.inv(t_mat)

    # embedded error: ŷ uses the extra node 0 with weight b̂0 = 1/mu_real
    gamma0 = 1.0 / mu_real
    vm = np.vander(c, s, increasing=True).T
    rhs_b = np.array([1.0 / k for k in range(1, s + 1)])
    rhs_b[0] -= gamma0
    bhat = np.linalg.solve(vm, rhs_b)
    e = mu_real * (bhat - b) @ ainv

    # dense output: P = (W⁻¹)ᵀ with W[j,q] = c_j^{q+1}
    w = np.stack([c ** (q + 1) for q in range(s)], axis=1)
    p = np.linalg.inv(w).T

    return RadauTableau(
        s=s, order=2 * s - 1, c=c, a=a, b=b,
        mu_real=mu_real, mu_complex=np.asarray(mus),
        t_mat=t_mat, ti_mat=ti_mat, e=e, p=p,
    )
