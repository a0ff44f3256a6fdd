"""GPSR: gradient projection for sparse reconstruction (L1-regularized QP).

(ref: matrix/kaldi-gpsr.h — used by the SGMM code to solve
 min_x 0.5 x'Hx - g'x + tau*||x||_1; the reference implements the
 Figueiredo/Nowak/Wright GPSR-BB algorithm on the split-variable
 nonnegative QP. Same algorithm here, vectorized with numpy — problem
 sizes are tiny (phonetic-subspace dims), so host numpy is the right
 altitude; the surrounding EM runs on the device.)
"""

from __future__ import annotations

import numpy as np


def gpsr(H: np.ndarray, g: np.ndarray, tau: float,
         max_iter: int = 500, tol: float = 1e-8) -> np.ndarray:
    """min_x 0.5 x'Hx - g'x + tau*||x||_1 via split-variable projected
    Barzilai-Borwein gradient steps (GPSR-BB).

    x = u - v with u, v >= 0; grad_u = Hx - g + tau, grad_v = -(Hx-g)+tau.
    """
    H = np.asarray(H, np.float64)
    g = np.asarray(g, np.float64)
    n = len(g)
    u = np.maximum(np.linalg.solve(H + 1e-8 * np.eye(n), g), 0.0)
    v = np.maximum(-np.linalg.solve(H + 1e-8 * np.eye(n), g), 0.0)
    alpha = 1.0
    prev_gu = prev_gv = prev_u = prev_v = None
    for _ in range(max_iter):
        x = u - v
        q = H @ x - g
        gu = q + tau
        gv = -q + tau
        # BB step length from the previous iterate
        if prev_u is not None:
            du = np.concatenate([u - prev_u, v - prev_v])
            dg = np.concatenate([gu - prev_gu, gv - prev_gv])
            denom = du @ dg
            alpha = (du @ du) / denom if denom > 1e-20 else 1.0
            alpha = float(np.clip(alpha, 1e-8, 1e8))
        prev_u, prev_v, prev_gu, prev_gv = u, v, gu, gv
        nu = np.maximum(u - alpha * gu, 0.0)
        nv = np.maximum(v - alpha * gv, 0.0)
        if max(np.abs(nu - u).max(initial=0.0),
               np.abs(nv - v).max(initial=0.0)) < tol:
            u, v = nu, nv
            break
        u, v = nu, nv
    return u - v


def gpsr_optimality_gap(H, g, tau, x, ) -> float:
    """Max violation of the L1-QP optimality conditions (0 at optimum):
    for x_i != 0: |(Hx - g)_i + tau*sign(x_i)|; for x_i == 0:
    max(|Hx - g|_i - tau, 0)."""
    q = np.asarray(H) @ np.asarray(x) - np.asarray(g)
    gap = 0.0
    for i, xi in enumerate(np.asarray(x)):
        if abs(xi) > 1e-10:
            gap = max(gap, abs(q[i] + tau * np.sign(xi)))
        else:
            gap = max(gap, max(abs(q[i]) - tau, 0.0))
    return float(gap)
