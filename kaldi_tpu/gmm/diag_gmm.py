"""Diagonal-covariance GMM stored in normal-inverted form so that
log-likelihood of a whole block of frames is one GEMM.

(ref: gmm/diag-gmm.h:43-160 — gconsts_ + means_invvars_ + inv_vars_;
 LogLikelihoods matrix version gmm/diag-gmm.h:92.)

loglike(x, m) = gconst[m] + <mean*invvar[m], x> - 0.5 <invvar[m], x^2>
             => stack [x, x^2] [T, 2D] @ [2D, M] + gconst — one GEMM.
"""

from __future__ import annotations

import math

import numpy as np

M_LOG_2PI = math.log(2.0 * math.pi)


class DiagGmm:
    """Parameters are plain numpy on host; scoring helpers build jnp programs."""

    def __init__(self, weights, means, variances):
        """weights [M], means [M, D], variances (diagonal) [M, D]."""
        self.weights = np.asarray(weights, np.float64)
        self.means = np.asarray(means, np.float64)
        self.vars = np.asarray(variances, np.float64)
        assert self.means.shape == self.vars.shape
        assert self.weights.shape[0] == self.means.shape[0]

    @property
    def num_gauss(self) -> int:
        return self.weights.shape[0]

    @property
    def dim(self) -> int:
        return self.means.shape[1]

    # --- derived (inverted) parameters ---

    def gconsts(self) -> np.ndarray:
        """[M] log(w) - 0.5(D log 2pi + sum log var + sum mean^2/var)
        (ref: diag-gmm.cc ComputeGconsts)."""
        with np.errstate(divide="ignore"):
            logw = np.log(self.weights)
        return (
            logw
            - 0.5 * (self.dim * M_LOG_2PI
                     + np.sum(np.log(self.vars), axis=1)
                     + np.sum(self.means ** 2 / self.vars, axis=1))
        ).astype(np.float32)

    def means_invvars(self) -> np.ndarray:
        return (self.means / self.vars).astype(np.float32)

    def inv_vars(self) -> np.ndarray:
        return (1.0 / self.vars).astype(np.float32)

    def packed(self) -> np.ndarray:
        """[2D+1, M] scoring matrix: loglikes = [x, -0.5 x^2, 1] @ packed."""
        return np.concatenate(
            [self.means_invvars().T, self.inv_vars().T, self.gconsts()[None, :]],
            axis=0,
        ).astype(np.float32)

    # --- host-side scoring (numpy; the batched jnp path lives in am_gmm) ---

    def loglikes(self, x: np.ndarray) -> np.ndarray:
        """x [T, D] -> per-component loglikes [T, M]."""
        x = np.asarray(x, np.float32)
        aug = np.concatenate(
            [x, -0.5 * x * x, np.ones((len(x), 1), np.float32)], axis=1)
        return aug @ self.packed()

    def loglike(self, x: np.ndarray) -> np.ndarray:
        """Total log-likelihood per frame [T]."""
        ll = self.loglikes(x)
        m = ll.max(axis=1, keepdims=True)
        return (m[:, 0] + np.log(np.sum(np.exp(ll - m), axis=1)))

    def posteriors(self, x: np.ndarray) -> np.ndarray:
        ll = self.loglikes(x)
        m = ll.max(axis=1, keepdims=True)
        e = np.exp(ll - m)
        return e / e.sum(axis=1, keepdims=True)

    # --- mixture surgery (ref: diag-gmm.h:147-160 Split/Merge) ---

    def split(self, target: int, perturb_factor: float = 0.01,
              rng: np.random.RandomState | None = None) -> "DiagGmm":
        rng = rng or np.random.RandomState(0)
        weights = list(self.weights)
        means = list(self.means)
        variances = list(self.vars)
        while len(weights) < target:
            i = int(np.argmax(weights))
            w = weights[i] / 2
            std = np.sqrt(variances[i])
            pert = perturb_factor * std * rng.randn(self.dim)
            weights[i] = w
            means_i = means[i]
            means[i] = means_i + pert
            weights.append(w)
            means.append(means_i - pert)
            variances.append(variances[i].copy())
        return DiagGmm(np.asarray(weights), np.asarray(means), np.asarray(variances))

    def merge(self, target: int) -> "DiagGmm":
        """Merge lowest-occupancy pairs until <= target comps (simple greedy)."""
        g = self
        while g.num_gauss > target:
            i, j = np.argsort(g.weights)[:2]
            wi, wj = g.weights[i], g.weights[j]
            w = wi + wj
            mean = (wi * g.means[i] + wj * g.means[j]) / w
            second = (wi * (g.vars[i] + g.means[i] ** 2)
                      + wj * (g.vars[j] + g.means[j] ** 2)) / w
            var = second - mean ** 2
            keep = [k for k in range(g.num_gauss) if k not in (i, j)]
            g = DiagGmm(
                np.concatenate([g.weights[keep], [w]]),
                np.vstack([g.means[keep], mean[None]]),
                np.vstack([g.vars[keep], var[None]]),
            )
        return g

    @staticmethod
    def from_stats(mean: np.ndarray, var: np.ndarray) -> "DiagGmm":
        """Single-component flat start from global feature moments."""
        return DiagGmm(np.ones(1), mean[None, :], var[None, :])

    def copy(self) -> "DiagGmm":
        return DiagGmm(self.weights.copy(), self.means.copy(), self.vars.copy())
