"""Length-bucketed batch decoding for production serving.

(ref role: gmm-latgen-faster-parallel's TaskSequencer feeds utterances of
 wildly different lengths through one thread pool; the equivalent here
 batches utterances into padded tensors — bucketing by length bounds the
 padding waste AND keeps the set of jit shapes small, so each bucket shape
 compiles once. SURVEY.md §5 long-context row: pad/bucket frames per
 utterance into [B, T, D].)
"""

from __future__ import annotations

import numpy as np


def bucket_boundaries(lengths, max_buckets: int = 6,
                      growth: float = 1.4, min_len: int = 64):
    """Geometric length buckets covering the data."""
    lo = max(min_len, int(min(lengths)))
    hi = int(max(lengths))
    bounds = [lo]
    while bounds[-1] < hi and len(bounds) < max_buckets:
        bounds.append(int(np.ceil(bounds[-1] * growth)))
    bounds[-1] = max(bounds[-1], hi)
    return bounds


def decode_batched(decoder, utts, score_fn, batch_size: int = 16,
                   max_buckets: int = 6):
    """Decode a keyed dataset with length bucketing.

    utts: [(key, feats [T, D])]; score_fn(batch_feats [B, T, D]) ->
    loglikes [B, T, P] (the acoustic model, jitted by the caller).
    -> {key: (words, tids, cost) or None}.

    Utterances are grouped into geometric length buckets; each bucket is
    decoded in fixed-size batches padded to the bucket's boundary, so the
    whole dataset touches at most max_buckets × 1 compiled shapes.
    """
    if not utts:
        return {}
    lengths = [f.shape[0] for (_k, f) in utts]
    bounds = bucket_boundaries(lengths, max_buckets=max_buckets)
    D = utts[0][1].shape[1]
    out: dict = {}
    for bi, bound in enumerate(bounds):
        lo = 0 if bi == 0 else bounds[bi - 1]
        members = [(k, f) for (k, f) in utts
                   if (lo < f.shape[0] <= bound) or
                      (bi == 0 and f.shape[0] <= bound)]
        for start in range(0, len(members), batch_size):
            chunk = members[start: start + batch_size]
            B = len(chunk)
            # pad the batch itself to batch_size to keep ONE shape/bucket
            feats = np.zeros((batch_size, bound, D), np.float32)
            nf = np.zeros(batch_size, np.int32)
            for b, (_k, f) in enumerate(chunk):
                feats[b, : f.shape[0]] = f
                nf[b] = f.shape[0]
            if B < batch_size:
                nf[B:] = 1   # dummy rows decode 1 frame, discarded
            ll = score_fn(feats)
            res = decoder.decode(ll, nf)
            for b, (k, _f) in enumerate(chunk):
                out[k] = res[b]
    return out
