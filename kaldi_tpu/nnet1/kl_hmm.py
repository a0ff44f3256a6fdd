"""KL-HMM layer: KL-divergence acoustic scores over posterior features.

(ref: nnet/nnet-kl-hmm.h Nnet1's KlHmm component — each HMM state s keeps
 an accumulated categorical distribution y_s over posterior-feature
 dimensions; the forward pass scores a posterior frame z with
 -KL(y_s || z) = sum_d y_s[d] * log(z[d]) + const, i.e. the
 cross-entropy of the state distribution under the observed posterior.
 Training = counting: accumulate per-state posterior sums from frame
 alignments, then normalize.)

Accelerator-first: scoring all states for all frames is one [T, D] x [D, S]
matmul of log-posteriors against the state distributions.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


class KlHmm:
    def __init__(self, dim: int, num_states: int):
        self.counts = np.zeros((num_states, dim), np.float64)

    @property
    def num_states(self) -> int:
        return self.counts.shape[0]

    def accumulate(self, posteriors: np.ndarray, state_ali: np.ndarray):
        """posteriors [T, D] (rows sum to 1), state_ali [T] int states."""
        posteriors = np.asarray(posteriors, np.float64)
        for s in np.unique(state_ali):
            self.counts[int(s)] += posteriors[state_ali == s].sum(axis=0)

    def state_dists(self) -> np.ndarray:
        """[S, D] normalized state distributions (uniform if untrained)."""
        tot = self.counts.sum(axis=1, keepdims=True)
        D = self.counts.shape[1]
        uni = np.full_like(self.counts, 1.0 / D)
        return np.where(tot > 0, self.counts / np.maximum(tot, 1e-20), uni)

    def scores(self, posteriors) -> jnp.ndarray:
        """[..., T, D] posteriors -> [..., T, S] per-state scores
        sum_d y_s[d] log z[d] (= -KL(y_s||z) - H(y_s), the decodable
        loglike surrogate the reference's Propagate emits)."""
        y = jnp.asarray(self.state_dists(), jnp.float32)  # [S, D]
        logz = jnp.log(jnp.maximum(jnp.asarray(posteriors, jnp.float32),
                                   1e-20))
        return jnp.matmul(logz, y.T)
