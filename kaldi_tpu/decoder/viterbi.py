"""Batched Viterbi alignment over per-utterance training graphs.

The tensor-program replacement for gmm-align-compiled's FasterDecoder loop
(ref: decoder/faster-decoder.h:61, gmmbin/gmm-align-compiled.cc): alignment
graphs are small, so instead of token passing with hashing we run DENSE
masked dynamic programming over the padded [B, S] state space:

    alpha[t+1, dst] = min over arcs a into dst of
        alpha[t, src(a)] + graph_cost(a) + acoustic_cost(t+1, pdf(a))

realized as one gather + segment-min per frame under `lax.scan`; the argmin
arc indexes form the backpointer tensor [B, T, S] and the traceback is a
host-side walk (or a second scan). Assumes no input-epsilon arcs (training
graphs after self-loop insertion are fully emitting).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from kaldi_tpu.decoder.graph_pack import PackedGraphBatch

BIG = np.float32(1e10)


@functools.partial(jax.jit, static_argnames=("num_states",))
def _viterbi_forward(loglikes, src, nextstate, cost, pdf, start, final,
                     frame_mask, num_states: int):
    """loglikes [B,T,P]; graph arrays [B,A]; returns (bp [B,T,S],
    best_final_state [B], total_cost [B]).

    frame_mask [B,T] bool marks real (unpadded) frames; padded frames copy
    alpha through unchanged.
    """
    B, T, P = loglikes.shape

    init_alpha = jnp.full((B, num_states), BIG)
    init_alpha = init_alpha.at[jnp.arange(B), start].set(0.0)

    def step(alpha, inputs):
        ll_t, mask_t = inputs  # [B,P], [B]
        # arc scores: alpha[src] + graph cost + acoustic cost of arc pdf
        a_src = jnp.take_along_axis(alpha, src, axis=1)  # [B,A]
        am = -jnp.take_along_axis(ll_t, pdf, axis=1)  # [B,A] acoustic cost
        score = a_src + cost + am
        # dense min-scatter into destination states
        new_alpha = jnp.full((B, num_states), BIG)
        new_alpha = new_alpha.at[
            jnp.arange(B)[:, None], nextstate
        ].min(score, mode="drop")
        # winning arc per dst: recompute via equality (cheap, avoids argmin scatter)
        dst_best = jnp.take_along_axis(new_alpha, nextstate, axis=1)  # [B,A]
        is_best = (score <= dst_best + 1e-6) & (score < BIG * 0.5)
        A = score.shape[1]
        arc_idx = jnp.arange(A)[None, :]
        # take the smallest arc index among winners (sentinel A+1 = none)
        bp_val = jnp.where(is_best, arc_idx, A + 1)
        bp = jnp.full((B, num_states), A + 1, jnp.int32)
        bp = bp.at[jnp.arange(B)[:, None], nextstate].min(
            bp_val.astype(jnp.int32), mode="drop")
        bp = jnp.where(bp > A, -1, bp)
        alpha_out = jnp.where(mask_t[:, None], new_alpha, alpha)
        bp_out = jnp.where(mask_t[:, None], bp, -1)
        return alpha_out, bp_out

    alpha_final, bps = jax.lax.scan(
        step, init_alpha,
        (jnp.moveaxis(loglikes, 1, 0), jnp.moveaxis(frame_mask, 1, 0)),
    )
    total = alpha_final + final  # [B,S]
    best_state = jnp.argmin(total, axis=1)
    best_cost = jnp.take_along_axis(total, best_state[:, None], axis=1)[:, 0]
    return jnp.moveaxis(bps, 0, 1), best_state, best_cost


def viterbi_align(
    batch: PackedGraphBatch,
    loglikes: np.ndarray,
    num_frames: np.ndarray,
    acoustic_scale: float = 1.0,
):
    """Align a batch. loglikes [B, T, num_pdfs] (unscaled), num_frames [B].

    Returns list over batch of (tids [T_b], words, total_cost) or None if
    alignment failed (no path).
    """
    B, T, P = loglikes.shape
    mask = np.arange(T)[None, :] < np.asarray(num_frames)[:, None]
    bp, best_state, best_cost = _viterbi_forward(
        jnp.asarray(loglikes * acoustic_scale),
        jnp.asarray(batch.src), jnp.asarray(batch.nextstate),
        jnp.asarray(batch.cost), jnp.asarray(batch.pdf),
        jnp.asarray(batch.start), jnp.asarray(batch.final),
        jnp.asarray(mask), int(batch.final.shape[1]),
    )
    bp = np.asarray(bp)
    best_state = np.asarray(best_state)
    best_cost = np.asarray(best_cost)
    results = []
    for b in range(B):
        Tb = int(num_frames[b])
        if not np.isfinite(best_cost[b]) or best_cost[b] >= BIG * 0.5:
            results.append(None)
            continue
        tids = np.zeros(Tb, np.int32)
        words = []
        s = int(best_state[b])
        ok = True
        for t in range(Tb - 1, -1, -1):
            a = int(bp[b, t, s])
            if a < 0:
                ok = False
                break
            tids[t] = batch.ilabel[b, a]
            if batch.olabel[b, a] != 0:
                words.append(int(batch.olabel[b, a]))
            s = int(batch.src[b, a])
        words.reverse()
        results.append((tids, words, float(best_cost[b])) if ok else None)
    return results


def equal_align(batch: PackedGraphBatch, num_frames: np.ndarray, seed: int = 0):
    """A legal T-frame path through each graph, acoustics-free.

    (ref: bin/align-equal-compiled.cc / fstext EqualAlign — used for the 0th
    training iteration.) We run the same DP with zero acoustic input and a
    small random perturbation on arc costs so ties spread across paths.
    """
    rng = np.random.RandomState(seed)
    B = len(batch.start)
    T = int(np.max(num_frames))
    ll = np.zeros((B, T, 1), np.float32)
    pert = batch.cost + rng.uniform(0.0, 0.01, batch.cost.shape).astype(np.float32)
    batch2 = PackedGraphBatch(
        batch.arc_start, batch.ilabel, batch.olabel, pert, batch.nextstate,
        batch.src, np.zeros_like(batch.pdf), batch.final, batch.start,
        batch.num_states, batch.num_arcs,
    )
    return viterbi_align(batch2, ll, num_frames)
