"""AmDiagGmm: one DiagGmm per pdf, packed for single-GEMM scoring of ALL pdfs.

(ref: gmm/am-diag-gmm.h:36 AmDiagGmm; gmm/decodable-am-diag-gmm.h:45.)

Accelerator-first design: instead of per-pdf scoring on demand (the reference caches
per-frame likelihoods per transition-id), we pack every gaussian of every pdf
into one [2D+1, total_gauss] matrix. Scoring a [T, D] block of frames against
ALL pdfs is then

    aug[T, 2D+1] @ packed[2D+1, G]  -> comp loglikes [T, G]   (one GEMM)
    segment-logsumexp over G by pdf -> [T, num_pdfs]

which is exactly how the batched decoder/aligner wants its inputs. Pdfs may
have different component counts; a segment-id vector handles that without
padding waste.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from kaldi_tpu.gmm.diag_gmm import DiagGmm


class AmDiagGmm:
    def __init__(self, pdfs: list[DiagGmm]):
        self.pdfs = list(pdfs)
        self._packed_cache = None

    @property
    def num_pdfs(self) -> int:
        return len(self.pdfs)

    @property
    def dim(self) -> int:
        return self.pdfs[0].dim

    @property
    def total_gauss(self) -> int:
        return sum(p.num_gauss for p in self.pdfs)

    def invalidate(self):
        self._packed_cache = None

    def pack(self):
        """-> (packed [2D+1, G] f32, seg_ids [G] i32, num_pdfs)."""
        if self._packed_cache is None:
            packed = np.concatenate([p.packed() for p in self.pdfs], axis=1)
            seg = np.concatenate(
                [np.full(p.num_gauss, i, np.int32) for i, p in enumerate(self.pdfs)]
            )
            self._packed_cache = (packed, seg)
        return self._packed_cache

    def loglikes(self, feats, scale: float = 1.0) -> jnp.ndarray:
        """feats [..., T, D] -> per-pdf loglikes [..., T, num_pdfs] (jit)."""
        packed, seg = self.pack()
        return _am_loglikes(
            jnp.asarray(feats), jnp.asarray(packed), jnp.asarray(seg),
            self.num_pdfs, float(scale)
        )

    def loglikes_np(self, feats: np.ndarray, scale: float = 1.0) -> np.ndarray:
        return np.asarray(self.loglikes(feats, scale))

    # --- model surgery ---

    def split_by_count(self, target_total: int, perturb_factor=0.01,
                       power: float = 0.2, min_count: float = 20.0,
                       occs: np.ndarray | None = None,
                       rng=None):
        """Distribute `target_total` gaussians across pdfs ∝ occupancy^power
        (ref: am-diag-gmm.cc SplitByCount / GetSplitTargets)."""
        rng = rng or np.random.RandomState(0)
        if occs is None:
            occs = np.ones(self.num_pdfs)
        occs = np.asarray(occs, np.float64)
        powered = np.power(np.maximum(occs, 1e-10), power)
        shares = powered / powered.sum() * target_total
        targets = np.maximum(1, np.floor(shares).astype(int))
        # distribute the flooring remainder to the largest fractional
        # parts so the requested TOTAL is actually reached
        # (ref: GetSplitTargets allocates iteratively to hit the total)
        short = int(target_total - targets.sum())
        if short > 0:
            frac = shares - np.floor(shares)
            frac[occs < min_count] = -1.0   # ineligible pdfs
            for i in np.argsort(-frac)[:short]:
                if frac[i] > 0:
                    targets[i] += 1
        # pdfs with occupancy below min_count stay at current size
        for i, p in enumerate(self.pdfs):
            t = int(targets[i])
            if occs[i] < min_count:
                continue
            if t > p.num_gauss:
                self.pdfs[i] = p.split(t, perturb_factor, rng)
        self.invalidate()

    def copy(self) -> "AmDiagGmm":
        return AmDiagGmm([p.copy() for p in self.pdfs])


@functools.partial(jax.jit, static_argnames=("num_pdfs", "scale"))
def _am_loglikes(feats, packed, seg_ids, num_pdfs: int, scale: float):
    x = feats.astype(jnp.float32)
    ones = jnp.ones(x.shape[:-1] + (1,), jnp.float32)
    aug = jnp.concatenate([x, -0.5 * x * x, ones], axis=-1)
    comp_ll = jnp.matmul(aug, packed, precision=jax.lax.Precision.HIGHEST)
    # segment logsumexp over components -> pdfs
    seg_max = jax.ops.segment_max(
        jnp.moveaxis(comp_ll, -1, 0), seg_ids, num_segments=num_pdfs
    )  # [num_pdfs, ..., T]
    seg_max = jnp.where(jnp.isfinite(seg_max), seg_max, 0.0)
    gathered_max = seg_max[seg_ids]  # [G, ..., T]
    e = jnp.exp(jnp.moveaxis(comp_ll, -1, 0) - gathered_max)
    seg_sum = jax.ops.segment_sum(e, seg_ids, num_segments=num_pdfs)
    ll = seg_max + jnp.log(jnp.maximum(seg_sum, 1e-37))
    return scale * jnp.moveaxis(ll, 0, -1)
