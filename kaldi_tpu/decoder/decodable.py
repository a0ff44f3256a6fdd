"""Decodable adapters: the tensor equivalents of the DecodableInterface zoo.

(ref: itf/decodable-itf.h:83-118 DecodableInterface;
 decoder/decodable-matrix.h:33 DecodableMatrixScaledMapped, :169
 DecodableMatrixScaled; decoder/decodable-mapped.h DecodableMapped;
 decoder/decodable-sum.h DecodableSum / DecodableSumScaled.)

Accelerator-first shape: a "decodable" is just a loglikes tensor [..., T, N]
(N = pdfs or tids) plus the pure functions below; the decoders take the
tensor directly, so each reference adapter class collapses to one lazy
array transformation XLA fuses into the decode program — no per-frame
virtual calls.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def scale_loglikes(loglikes, acoustic_scale: float):
    """DecodableMatrixScaled: lls * scale (ref: decodable-matrix.h:169)."""
    return loglikes * acoustic_scale


def map_loglikes(loglikes, id2pdf: np.ndarray, acoustic_scale: float = 1.0):
    """Per-pdf loglikes [..., T, num_pdfs] -> per-transition-id
    [..., T, num_tids] via the tid->pdf map (ref: decodable-matrix.h:33
    DecodableMatrixScaledMapped — LogLikelihood(frame, tid) =
    scale * lls(frame, id2pdf[tid])). tid 0 is invalid and maps to pdf -1
    in the table; it gets column 0's value but is never consulted (no arc
    carries tid 0)."""
    idx = jnp.asarray(np.maximum(np.asarray(id2pdf), 0))
    return acoustic_scale * jnp.take(loglikes, idx, axis=-1)


def index_map_loglikes(loglikes, index_map):
    """DecodableMapped: generic index remap of the score axis
    (ref: decoder/decodable-mapped.h — LogLikelihood(frame, i) =
    base(frame, index_map[i]))."""
    return jnp.take(loglikes, jnp.asarray(index_map), axis=-1)


def sum_loglikes(loglikes_list, scales=None):
    """DecodableSum(Scaled): model interpolation by adding (optionally
    scaled) log-likelihood tensors of the same shape
    (ref: decoder/decodable-sum.h — used e.g. to combine two acoustic
    models over the same tree)."""
    if scales is None:
        scales = [1.0] * len(loglikes_list)
    if len(scales) != len(loglikes_list):
        raise ValueError("one scale per decodable")
    acc = None
    for lls, s in zip(loglikes_list, scales):
        term = lls if s == 1.0 else lls * s
        acc = term if acc is None else acc + term
    return acc
