"""GMM sufficient-statistics accumulation + MLE/MAP updates.

(ref: gmm/mle-diag-gmm.h:136-225 AccumDiagGmm / MleDiagGmmUpdate /
 MapDiagGmmUpdate; gmm/mle-am-diag-gmm.h AccumAmDiagGmm.)

Accelerator-first accumulation: given frames [T, D] and per-frame (pdf, weight)
labels, all pdf/component stats are computed with batched GEMMs +
segment-sums in one jit program, replacing the reference's per-frame
AccumulateFromPosteriors loop. Data-parallel training psums these stats
across shards instead of writing .acc files (SURVEY.md §2.11).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from kaldi_tpu.gmm.diag_gmm import DiagGmm
from kaldi_tpu.gmm.am_gmm import AmDiagGmm


class AccumDiagGmm:
    """Sufficient stats for one DiagGmm: occupancy, mean & var accumulators."""

    def __init__(self, num_gauss: int, dim: int):
        self.occ = np.zeros(num_gauss, np.float64)
        self.mean_acc = np.zeros((num_gauss, dim), np.float64)
        self.var_acc = np.zeros((num_gauss, dim), np.float64)

    def accumulate_from_posteriors(self, x: np.ndarray, post: np.ndarray):
        """x [T, D], post [T, M]."""
        self.occ += post.sum(axis=0)
        self.mean_acc += post.T @ x
        self.var_acc += post.T @ (x * x)

    def accumulate(self, gmm: DiagGmm, x: np.ndarray, weights=None):
        post = gmm.posteriors(x)
        if weights is not None:
            post = post * np.asarray(weights)[:, None]
        self.accumulate_from_posteriors(x, post)

    def add(self, other: "AccumDiagGmm"):
        self.occ += other.occ
        self.mean_acc += other.mean_acc
        self.var_acc += other.var_acc


def mle_diag_gmm_update(
    gmm: DiagGmm,
    acc: AccumDiagGmm,
    min_gaussian_occupancy: float = 10.0,
    min_gaussian_weight: float = 1e-5,
    variance_floor: float = 1e-10,
    update_weights: bool = True,
    update_means: bool = True,
    update_vars: bool = True,
) -> DiagGmm:
    """MLE re-estimation (ref: mle-diag-gmm.h:214 MleDiagGmmUpdate).

    Components with occupancy below threshold keep their old parameters
    (the reference optionally removes them; we keep for shape stability).
    """
    occ = acc.occ
    tot = occ.sum()
    new_w = gmm.weights.copy()
    new_m = gmm.means.copy()
    new_v = gmm.vars.copy()
    ok = occ > min_gaussian_occupancy
    if update_weights and tot > 0:
        w = occ / tot
        w = np.where(ok, np.maximum(w, min_gaussian_weight), gmm.weights)
        new_w = w / w.sum()
    safe_occ = np.maximum(occ, 1e-10)[:, None]
    mean_hat = acc.mean_acc / safe_occ
    if update_means:
        new_m = np.where(ok[:, None], mean_hat, gmm.means)
    if update_vars:
        # var = E[x^2] - 2 m E[x] + m^2 where m is the NEW mean
        m = mean_hat if update_means else gmm.means
        var_hat = (acc.var_acc / safe_occ
                   - 2.0 * m * (acc.mean_acc / safe_occ) + m * m)
        var_hat = np.maximum(var_hat, variance_floor)
        new_v = np.where(ok[:, None], var_hat, gmm.vars)
    return DiagGmm(new_w, new_m, new_v)


def map_diag_gmm_update(
    gmm: DiagGmm,
    acc: AccumDiagGmm,
    mean_tau: float = 10.0,
    weight_tau: float = 10.0,
    variance_tau: float = 50.0,
    update_weights: bool = False,
    update_vars: bool = False,
) -> DiagGmm:
    """MAP re-estimation toward the current model as prior
    (ref: gmm/mle-diag-gmm.h:225 MapDiagGmmUpdate)."""
    occ = acc.occ
    tot = max(occ.sum(), 1e-10)
    safe_occ = np.maximum(occ, 1e-20)[:, None]
    new_w = gmm.weights.copy()
    if update_weights:
        new_w = (occ + weight_tau * gmm.weights) / (tot + weight_tau)
        new_w /= new_w.sum()
    new_m = (acc.mean_acc + mean_tau * gmm.means) / (occ[:, None] + mean_tau)
    new_v = gmm.vars.copy()
    if update_vars:
        var_stats = acc.var_acc - 2 * new_m * acc.mean_acc + occ[:, None] * new_m**2
        prior_stats = variance_tau * (gmm.vars + np.square(gmm.means - new_m))
        new_v = (var_stats + prior_stats) / (occ[:, None] + variance_tau)
        new_v = np.maximum(new_v, 1e-10)
    return DiagGmm(new_w, new_m, new_v)


class AccumAmDiagGmm:
    """Per-pdf accumulators for a whole AM + transition counts.

    The batched path accumulates ALL pdfs' stats from an aligned utterance
    batch in one jit program (`accumulate_batched`).
    """

    def __init__(self, am: AmDiagGmm):
        self.accs = [AccumDiagGmm(p.num_gauss, p.dim) for p in am.pdfs]
        self.tot_like = 0.0
        self.tot_frames = 0.0

    def add(self, other: "AccumAmDiagGmm"):
        for a, b in zip(self.accs, other.accs):
            a.add(b)
        self.tot_like += other.tot_like
        self.tot_frames += other.tot_frames

    def accumulate_from_posteriors(
        self, am: AmDiagGmm, feats: np.ndarray, post,
    ):
        """Soft per-frame pdf posteriors: post[t] = [(pdf, weight)].

        Expands to (frame, pdf, weight) triples and reuses the batched
        aligned-posterior program with repeated frames — one GEMM for all
        pdfs (ref: gmm/mle-am-diag-gmm.h AccumAmDiagGmm::AccumulateFromPosteriors).
        """
        idx, pdfs, ws = [], [], []
        for t, frame in enumerate(post):
            for pdf, w in frame:
                idx.append(t)
                pdfs.append(pdf)
                ws.append(w)
        if not idx:
            return
        feats = np.asarray(feats, np.float32)
        self.accumulate_from_alignment(
            am, feats[np.asarray(idx)], np.asarray(pdfs),
            np.asarray(ws, np.float32))

    def accumulate_from_alignment(
        self, am: AmDiagGmm, feats: np.ndarray, pdf_ids: np.ndarray,
        weights: np.ndarray | None = None,
    ):
        """feats [T, D], pdf_ids [T] (hard alignment), optional weights [T].

        Computes per-component posteriors within the aligned pdf for every
        frame with one batched program, then scatters into host accumulators.
        """
        feats = np.asarray(feats, np.float32)
        pdf_ids = np.asarray(pdf_ids)
        if weights is None:
            weights = np.ones(len(feats), np.float32)
        T = len(feats)
        # pad T to a power-of-two bucket (zero weights) so the jitted
        # program compiles for O(log) distinct shapes, not one per
        # utterance length
        Tp = 1 << max(5, int(np.ceil(np.log2(max(T, 1)))))
        if Tp != T:
            feats = np.pad(feats, ((0, Tp - T), (0, 0)))
            pdf_ids = np.pad(pdf_ids, (0, Tp - T))
            weights = np.pad(weights, (0, Tp - T))
        packed, seg = am.pack()
        post, ll = _aligned_posteriors(
            jnp.asarray(feats), jnp.asarray(pdf_ids), jnp.asarray(weights),
            jnp.asarray(packed), jnp.asarray(seg)
        )
        post = np.asarray(post)[:T]  # [T, G] masked to aligned pdf
        feats = feats[:T]
        pdf_ids = pdf_ids[:T]
        weights = weights[:T]
        self.tot_like += float(ll)
        self.tot_frames += float(weights.sum())
        # scatter per pdf on host (G ~ thousands; cheap)
        offsets = np.cumsum([0] + [p.num_gauss for p in am.pdfs])
        x = feats.astype(np.float64)
        xsq = x * x
        touched = np.unique(pdf_ids)
        for pdf in touched:
            sl = slice(offsets[pdf], offsets[pdf + 1])
            p = post[:, sl]
            rows = p.sum(axis=1) > 0
            if not rows.any():
                continue
            pr = p[rows]
            self.accs[pdf].occ += pr.sum(axis=0)
            self.accs[pdf].mean_acc += pr.T @ x[rows]
            self.accs[pdf].var_acc += pr.T @ xsq[rows]


@jax.jit
def _aligned_posteriors(feats, pdf_ids, weights, packed, seg_ids):
    """Per-component posteriors masked to each frame's aligned pdf.

    feats [T, D]; returns (post [T, G], total loglike).
    """
    x = feats
    ones = jnp.ones((x.shape[0], 1), jnp.float32)
    aug = jnp.concatenate([x, -0.5 * x * x, ones], axis=-1)
    comp_ll = jnp.matmul(aug, packed, precision=jax.lax.Precision.HIGHEST)
    mask = seg_ids[None, :] == pdf_ids[:, None]  # [T, G]
    masked = jnp.where(mask, comp_ll, -jnp.inf)
    m = jnp.max(masked, axis=1, keepdims=True)
    e = jnp.exp(masked - m)
    denom = jnp.sum(e, axis=1, keepdims=True)
    post = e / jnp.maximum(denom, 1e-37) * weights[:, None]
    ll = jnp.sum((m[:, 0] + jnp.log(jnp.maximum(denom[:, 0], 1e-37))) * weights)
    return post, ll
