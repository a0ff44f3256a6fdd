"""I-vector extractor: per-Gaussian factor-analysis over a UBM.

(ref: ivector/ivector-extractor.h:135 IvectorExtractor — model
 mu_i(s) = mu_i + M_i w_s with w_s ~ N(0, I); :474 IvectorExtractorStats
 EM training; ivectorbin/ivector-extractor-{init,acc-stats,est}.cc and
 ivector-extract.cc.)

Accelerator-first formulation: the zeroth/first-order stats for a whole utterance
batch are two GEMMs (posteriors against frames); the per-utterance posterior
solve L w = b is a batched Cholesky over [B, K, K]. The reference's prior
offset convention (ivector coordinate 0 centered at 1) is kept so behavior
matches ivector-extract's output scale.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from kaldi_tpu.gmm.diag_gmm import DiagGmm
from kaldi_tpu.gmm.full_gmm import FullGmm


@dataclasses.dataclass
class IvectorExtractorOpts:
    ivector_dim: int = 100
    num_iters: int = 10
    prior_offset: float = 100.0  # (ref: ivector-extractor.h prior_offset_)
    num_gselect: int = 20
    min_post: float = 0.025


class IvectorExtractor:
    """Parameters: UBM (means mu [I, D], inverse variances or full inverse
    covariances), factor loading M [I, D, K]."""

    def __init__(self, ubm, ivector_dim: int, prior_offset: float = 100.0,
                 seed: int = 0):
        if isinstance(ubm, DiagGmm):
            self.means = np.asarray(ubm.means)
            self.inv_covars = np.stack([np.diag(1.0 / v) for v in ubm.vars])
            self.weights = np.asarray(ubm.weights)
        elif isinstance(ubm, FullGmm):
            self.means = np.asarray(ubm.means)
            self.inv_covars = ubm.inv_covars()
            self.weights = np.asarray(ubm.weights)
        else:
            raise TypeError(type(ubm))
        I, D = self.means.shape
        K = ivector_dim
        rng = np.random.RandomState(seed)
        self.M = rng.randn(I, D, K) * 0.1
        # coordinate 0 of w is centered at prior_offset; M[:, :, 0] set so
        # that M_i * [prior_offset, 0...] ~ 0 initially (means absorbed)
        self.M[:, :, 0] = 0.0
        self.prior_offset = prior_offset
        self.ivector_dim = K

    # --- posterior computation over the UBM ---

    def frame_posteriors(self, feats: np.ndarray, num_gselect: int = 20,
                         min_post: float = 0.025) -> np.ndarray:
        """[T, D] -> sparse-ish posteriors [T, I] (pruned & renormalized,
        ref: ivector-extract.cc gselect + min-post pruning)."""
        d = DiagGmm(self.weights, self.means,
                    1.0 / np.maximum(np.einsum("idd->id", self.inv_covars), 1e-10))
        ll = d.loglikes(feats.astype(np.float32))
        T, I = ll.shape
        k = min(num_gselect, I)
        idx = np.argpartition(-ll, k - 1, axis=1)[:, :k]
        sel = np.take_along_axis(ll, idx, axis=1)
        m = sel.max(axis=1, keepdims=True)
        p = np.exp(sel - m)
        p /= p.sum(axis=1, keepdims=True)
        p[p < min_post] = 0.0
        s = p.sum(axis=1, keepdims=True)
        p = np.divide(p, s, out=np.zeros_like(p), where=s > 0)
        post = np.zeros((T, I))
        np.put_along_axis(post, idx, p, axis=1)
        return post

    def utterance_stats(self, feats: np.ndarray, post: np.ndarray):
        """-> (gamma [I], X [I, D]): zeroth/first-order stats."""
        gamma = post.sum(axis=0)
        X = post.T @ feats
        return gamma, X

    # --- i-vector posterior ---

    def _precompute(self):
        # U_i = M_i^T Sigma_i^-1 M_i  [I, K, K];  V_i = M_i^T Sigma_i^-1 [I, K, D]
        V = np.einsum("idk,ide->ike", self.M, self.inv_covars)  # M^T Sig^-1
        U = np.einsum("ikd,idj->ikj", V, self.M)
        return U, V

    def extract(self, gamma: np.ndarray, X: np.ndarray):
        """-> (ivector mean [K] (prior offset subtracted from coord 0),
        posterior precision L [K, K])."""
        U, V = self._precompute()
        K = self.ivector_dim
        L = np.eye(K) + np.einsum("i,ikj->kj", gamma, U)
        Xc = X - gamma[:, None] * self.means
        b = np.einsum("ikd,id->k", V, Xc)
        b[0] += self.prior_offset  # prior mean [offset, 0, ...] times I
        w = np.linalg.solve(L, b)
        out = w.copy()
        out[0] -= self.prior_offset
        return out, L

    def extract_batch(self, stats_list):
        return [self.extract(g, X)[0] for (g, X) in stats_list]


class IvectorStats:
    """EM statistics for the extractor M-step
    (ref: ivector-extractor.h:474 IvectorExtractorStats)."""

    def __init__(self, extractor: IvectorExtractor):
        I, D, K = extractor.M.shape
        self.A = np.zeros((I, K, K))  # sum over utts: gamma_i E[w w^T]
        self.B = np.zeros((I, D, K))  # sum over utts: (X_i - gamma_i mu_i) E[w]^T
        self.count = 0.0

    def accumulate(self, extractor: IvectorExtractor, gamma, X):
        w, L = extractor.extract(gamma, X)
        w_full = w.copy()
        w_full[0] += extractor.prior_offset
        Linv = np.linalg.inv(L)
        Eww = Linv + np.outer(w_full, w_full)
        Xc = X - gamma[:, None] * extractor.means
        self.A += gamma[:, None, None] * Eww[None, :, :]
        self.B += np.einsum("id,k->idk", Xc, w_full)
        self.count += 1

    def update(self, extractor: IvectorExtractor, smoothing: float = 1e-4):
        """M-step: M_i = B_i A_i^-1."""
        I, D, K = extractor.M.shape
        for i in range(I):
            A = self.A[i] + smoothing * np.eye(K)
            extractor.M[i] = self.B[i] @ np.linalg.inv(A)


def train_ivector_extractor(
    ubm, utterance_feats: list[np.ndarray], ivector_dim: int,
    num_iters: int = 5, prior_offset: float = 100.0, seed: int = 0,
    num_gselect: int = 20,
) -> IvectorExtractor:
    """Full EM driver (ref: steps/train_ivector_extractor / sid scripts)."""
    ext = IvectorExtractor(ubm, ivector_dim, prior_offset, seed)
    stats_list = []
    for f in utterance_feats:
        post = ext.frame_posteriors(f, num_gselect)
        stats_list.append(ext.utterance_stats(f, post))
    for _it in range(num_iters):
        st = IvectorStats(ext)
        for (gamma, X) in stats_list:
            st.accumulate(ext, gamma, X)
        st.update(ext)
    return ext
