"""Int8-quantized affine serving path (XLA dequant-matmul).

(correctness oracle = the float path, tolerance set by int8 resolution.)
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from kaldi_tpu.nnet.quantized import (quantize_weights, qaffine,
                                      quantize_tdnn, tdnn_apply_quantized)
from kaldi_tpu.nnet.tdnn import Tdnn, TdnnConfig


def test_quantize_weights_resolution():
    rng = np.random.RandomState(0)
    w = rng.randn(16, 32).astype(np.float32)
    wq, sc = quantize_weights(w)
    assert wq.dtype == np.int8 and sc.shape == (16,)
    recon = wq.astype(np.float32) * sc[:, None]
    # per-channel error bounded by half a quantization step
    step = sc[:, None]
    assert np.all(np.abs(recon - w) <= 0.51 * step)


def test_qaffine_xla_matches_float():
    rng = np.random.RandomState(1)
    K, N, M = 64, 48, 20
    w = rng.randn(N, K).astype(np.float32)
    b = rng.randn(N).astype(np.float32)
    x = rng.randn(M, K).astype(np.float32)
    wq, sc = quantize_weights(w)
    y_float = x @ w.T + b
    y_q = np.asarray(qaffine(jnp.asarray(x), wq, sc, b))
    rel = np.abs(y_q - y_float).max() / (np.abs(y_float).max() + 1e-6)
    assert rel < 0.02


def test_qaffine_keeps_leading_dims():
    """[..., K] inputs map to [..., N] exactly like the flattened call."""
    rng = np.random.RandomState(2)
    K, N = 24, 40
    w = rng.randn(N, K).astype(np.float32)
    b = rng.randn(N).astype(np.float32)
    x = rng.randn(2, 5, K).astype(np.float32)
    wq, sc = quantize_weights(w)
    y3 = np.asarray(qaffine(jnp.asarray(x), wq, sc, b))
    y2 = np.asarray(qaffine(jnp.asarray(x.reshape(10, K)), wq, sc, b))
    assert y3.shape == (2, 5, N)
    np.testing.assert_array_equal(y3.reshape(10, N), y2)


def test_quantized_tdnn_close_to_float():
    rng = np.random.RandomState(3)
    cfg = TdnnConfig(feat_dim=8, num_pdfs=32, hidden_dim=64,
                     pnorm_output_dim=16,
                     splice_indexes=((-1, 0, 1), (-1, 1), (0,)))
    model = Tdnn(cfg)
    params = model.init(jax.random.PRNGKey(0))
    # give the final layer nonzero weights (init is zeros)
    params["final"]["w"] = 0.1 * jax.random.normal(
        jax.random.PRNGKey(1), params["final"]["w"].shape)
    qp = quantize_tdnn(params)
    x = jnp.asarray(rng.randn(2, 20, 8), jnp.float32)
    y_f = np.asarray(model.apply(params, x, pad_context=True))
    y_q = np.asarray(tdnn_apply_quantized(model, qp, x, pad_context=True))
    # posteriors must agree closely; argmax should rarely differ
    assert np.abs(y_q - y_f).mean() < 0.02
    agree = (y_q.argmax(-1) == y_f.argmax(-1)).mean()
    assert agree > 0.95


def test_quantized_tdnn_pads_input_edges_like_float():
    """pad_context=True is valid-mode over the edge-padded input, the
    same edge rule as Tdnn.apply."""
    rng = np.random.RandomState(4)
    cfg = TdnnConfig(feat_dim=8, num_pdfs=16, hidden_dim=32,
                     pnorm_output_dim=8, nonlinearity="relu",
                     splice_indexes=((-2, 0, 1), (-1, 2), (0,)))
    model = Tdnn(cfg)
    params = model.init(jax.random.PRNGKey(0))
    params["final"]["w"] = 0.1 * jax.random.normal(
        jax.random.PRNGKey(1), params["final"]["w"].shape)
    qp = quantize_tdnn(params)
    x = jnp.asarray(rng.randn(1, 12, 8), jnp.float32)
    y_pad = np.asarray(tdnn_apply_quantized(model, qp, x, pad_context=True))
    y_valid = np.asarray(tdnn_apply_quantized(model, qp, model.edge_pad(x),
                                              pad_context=False))
    assert y_pad.shape == (1, 12, 16)
    np.testing.assert_array_equal(y_pad, y_valid)
