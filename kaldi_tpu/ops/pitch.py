"""Kaldi-style pitch tracker: NCCF + Viterbi lag smoothing + POV features.

(ref: feat/pitch-functions.h:42-432 — ComputeKaldiPitch computes, per
 frame, normalized cross-correlation over candidate lags (50-400 Hz),
 then Viterbi-smooths the lag track with a log-lag transition penalty and
 outputs (NCCF/POV, pitch); ProcessPitch :407 turns that into the 3-dim
 (pov-feature, normalized-log-pitch, delta-pitch) feature.)

Accelerator-first: NCCF for all frames and lags is one batched correlation
(a matmul-shaped reduction); the Viterbi over lags is a `lax.scan` over
frames with an [L, L] transition-cost matrix — dense DP like the aligner.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import jax
import jax.numpy as jnp

from kaldi_tpu.ops.resample import LinearResample


@dataclasses.dataclass(frozen=True)
class PitchOpts:
    """(ref: pitch-functions.h:42 PitchExtractionOptions)"""

    samp_freq: float = 16000.0
    frame_shift_ms: float = 10.0
    frame_length_ms: float = 25.0
    min_f0: float = 50.0
    max_f0: float = 400.0
    resample_freq: float = 4000.0
    penalty_factor: float = 0.1
    delta_pitch: float = 0.005
    soft_min_f0: float = 10.0
    nccf_ballast: float = 7000.0
    lowpass_cutoff: float = 1000.0


@dataclasses.dataclass(frozen=True)
class ProcessPitchOpts:
    """(ref: pitch-functions.h:210 ProcessPitchOptions)"""

    pitch_scale: float = 2.0
    pov_scale: float = 2.0
    delta_pitch_scale: float = 10.0
    normalization_window: int = 151  # frames, for mean log-pitch


def _nccf(frames: np.ndarray, lags: np.ndarray, win: int,
          ballast: float) -> np.ndarray:
    """frames [T, win + max_lag]; -> nccf [T, L]."""
    T = frames.shape[0]
    L = len(lags)
    out = np.zeros((T, L))
    a = frames[:, :win]
    a = a - a.mean(axis=1, keepdims=True)
    e1 = np.sum(a * a, axis=1)
    for li, lag in enumerate(lags):
        b = frames[:, lag: lag + win]
        b = b - b.mean(axis=1, keepdims=True)
        e2 = np.sum(b * b, axis=1)
        num = np.sum(a * b, axis=1)
        out[:, li] = num / np.sqrt(e1 * e2 + ballast + 1e-10)
    return out


@functools.partial(jax.jit, static_argnames=())
def _viterbi_lags(costs, trans):
    """costs [T, L] local costs; trans [L, L] transition costs ->
    best lag index per frame [T]."""
    T, L = costs.shape

    def step(alpha, c_t):
        # alpha [L]; new[j] = min_i alpha[i] + trans[i, j] + c_t[j]
        m = alpha[:, None] + trans
        best_prev = jnp.argmin(m, axis=0)
        new = jnp.min(m, axis=0) + c_t
        return new, best_prev

    alpha0 = costs[0]
    alpha, bps = jax.lax.scan(step, alpha0, costs[1:])
    last = jnp.argmin(alpha)

    def back(carry, bp_t):
        j = carry
        i = bp_t[j]
        return i, j

    # reverse scan emits [s_1 .. s_{T-1}] into path_rev and leaves s_0 in
    # the final carry — prepend it (dropping it shifted the whole track
    # by one frame and duplicated the last state)
    s0, path_rev = jax.lax.scan(back, last, bps, reverse=True)
    return jnp.concatenate([s0[None], path_rev])


def compute_kaldi_pitch(wave: np.ndarray,
                        opts: PitchOpts = PitchOpts()) -> np.ndarray:
    """wave [S] at opts.samp_freq -> [T, 2] (nccf_pov, pitch_hz)."""
    wave = np.asarray(wave, np.float64)
    if opts.samp_freq != opts.resample_freq:
        rs = LinearResample(opts.samp_freq, opts.resample_freq,
                            filter_cutoff=opts.lowpass_cutoff)
        wave = rs.resample(wave).astype(np.float64)
    sf = opts.resample_freq
    shift = int(sf * 0.001 * opts.frame_shift_ms)
    win = int(sf * 0.001 * opts.frame_length_ms)
    min_lag = int(sf / opts.max_f0)
    max_lag = int(math.ceil(sf / opts.min_f0))
    lags = np.arange(min_lag, max_lag + 1)
    need = win + max_lag
    T = max(0, 1 + (len(wave) - need) // shift)
    if T == 0:
        return np.zeros((0, 2), np.float32)
    idx = (np.arange(T) * shift)[:, None] + np.arange(need)[None, :]
    frames = wave[idx]
    # ballast scales with signal energy (ref: nccf_ballast semantics)
    mean_sq = float(np.mean(wave * wave)) + 1e-10
    ballast = opts.nccf_ballast * (mean_sq * win) ** 1.0
    nccf = _nccf(frames, lags, win, ballast)
    # local cost: 1 - nccf + soft-min-f0 lag penalty (breaks octave ties in
    # favor of the shorter lag, ref: soft_min_f0 in ComputeLocalCost);
    # transition: penalty * (log lag diff)^2
    lag_penalty = opts.soft_min_f0 * (lags / sf)
    nccf_for_search = nccf - lag_penalty[None, :]
    log_lags = np.log(lags.astype(np.float64))
    d = log_lags[:, None] - log_lags[None, :]
    trans = opts.penalty_factor * (d * d) / (opts.delta_pitch ** 0.5)
    path = np.asarray(_viterbi_lags(jnp.asarray(1.0 - nccf_for_search),
                                    jnp.asarray(trans)))
    pitch = sf / lags[path]
    pov = nccf[np.arange(T), path]
    return np.stack([pov, pitch], axis=1).astype(np.float32)


def process_pitch(pitch_feats: np.ndarray,
                  opts: ProcessPitchOpts = ProcessPitchOpts()) -> np.ndarray:
    """[T, 2] (nccf, pitch) -> [T, 3] (pov_feature, norm_log_pitch,
    delta_pitch) (ref: pitch-functions.h:407 ProcessPitch)."""
    nccf = np.clip(pitch_feats[:, 0], -1.0, 1.0)
    pitch = np.maximum(pitch_feats[:, 1], 1e-3)
    T = len(nccf)
    # POV nonlinearity: pow(1.0001 - nccf, 0.15) - 1, signed — NOT abs()
    # (ref: pitch-functions.cc:44-52 NccfToPovFeature; abs would map a
    # strongly unvoiced nccf=-0.9 onto the same value as voiced +0.9 and
    # destroy the probability-of-voicing signal)
    pov = (1.0001 - nccf) ** 0.15 - 1.0
    pov_feature = opts.pov_scale * pov
    log_pitch = np.log(pitch)
    # mean-subtract log pitch over a sliding window, POV-weighted
    w = (nccf + 1.0) / 2.0 + 1e-3
    half = opts.normalization_window // 2
    norm_lp = np.zeros(T)
    csw = np.concatenate([[0], np.cumsum(w)])
    cswp = np.concatenate([[0], np.cumsum(w * log_pitch)])
    for t in range(T):
        lo, hi = max(0, t - half), min(T, t + half + 1)
        mean_lp = (cswp[hi] - cswp[lo]) / (csw[hi] - csw[lo])
        norm_lp[t] = log_pitch[t] - mean_lp
    norm_log_pitch = opts.pitch_scale * norm_lp
    dp = np.zeros(T)
    dp[1:] = log_pitch[1:] - log_pitch[:-1]
    delta_pitch = opts.delta_pitch_scale * dp
    return np.stack([pov_feature, norm_log_pitch, delta_pitch],
                    axis=1).astype(np.float32)
