"""Int8 weight-quantized affine layers for serving.

(ref role: the reference serves GMM/DNN scores in float on 2015 hardware;
 here affine weights can be quantized to int8 with per-output-channel
 scales, so the memory-bound layers read 4x fewer weight bytes; XLA fuses
 the dequant into the matmul.)
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


def quantize_weights(w: np.ndarray):
    """w [out, in] float -> (w_int8 [out, in], scale [out] f32):
    per-output-channel symmetric scaling."""
    w = np.asarray(w, np.float32)
    amax = np.abs(w).max(axis=1)
    scale = np.maximum(amax, 1e-10) / 127.0
    q = np.clip(np.round(w / scale[:, None]), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def qaffine(x, wq: np.ndarray | jnp.ndarray, scale, bias):
    """Quantized affine y = x Wᵀ·diag(scale) + b.

    x [..., K]; wq [N, K] int8; scale/bias [N]. The int8 weights stay
    int8 in device memory (4x less model memory); XLA fuses the dequant
    into the matmul."""
    lead = x.shape[:-1]
    K = x.shape[-1]
    x2 = jnp.asarray(x, jnp.float32).reshape(-1, K)
    wq = jnp.asarray(wq)
    scale = jnp.asarray(scale, jnp.float32)
    bias = jnp.asarray(bias, jnp.float32)
    y = x2 @ (wq.astype(jnp.float32).T * scale[None, :]) + bias
    return y.reshape(*lead, -1)


def quantize_tdnn(params):
    """Quantize every affine weight matrix of a Tdnn params pytree.
    Returns a parallel pytree of {'wq', 'scale', 'b'} dicts."""
    out = {"layers": [], "final": None}
    for layer in params["layers"]:
        # Tdnn stores w as [in, out]; quantization is per OUTPUT channel
        wq, sc = quantize_weights(np.asarray(layer["w"]).T)
        out["layers"].append({"wq": wq, "scale": sc,
                              "b": np.asarray(layer["b"])})
    wq, sc = quantize_weights(np.asarray(params["final"]["w"]).T)
    out["final"] = {"wq": wq, "scale": sc,
                    "b": np.asarray(params["final"]["b"])}
    return out


def tdnn_apply_quantized(model, qparams, feats, pad_context: bool = True):
    """Quantized forward pass of a Tdnn (mirrors Tdnn.apply; ref:
    kaldi_tpu/nnet/tdnn.py) producing log-posteriors."""
    from kaldi_tpu.nnet.components import (splice_valid, pnorm,
                                           normalize, ACTIVATIONS)
    cfg = model.config
    x = model.edge_pad(feats) if pad_context else jnp.asarray(feats)
    for ctx, layer in zip(cfg.splice_indexes, qparams["layers"]):
        x = splice_valid(x, ctx)
        x = qaffine(x, layer["wq"], layer["scale"], layer["b"])
        if cfg.nonlinearity == "pnorm":
            x = pnorm(x, cfg.pnorm_output_dim)
            x = normalize(x)
        else:
            x = ACTIVATIONS["relu"](x)
            x = normalize(x)
    f = qparams["final"]
    logits = qaffine(x, f["wq"], f["scale"], f["b"])
    return jax.nn.log_softmax(logits, axis=-1)
