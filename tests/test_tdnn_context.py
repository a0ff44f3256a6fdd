"""Tdnn edge handling: pad_context=True replicates the input's edge frames
by the model context and then runs valid-mode, in both the f32 and the
bf16 paths (the reference pads nnet input at utterance edges; the
streaming decoders clamp their feature ring the same way)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from kaldi_tpu.nnet.tdnn import Tdnn, TdnnConfig


def _model(nonlinearity):
    cfg = TdnnConfig(feat_dim=6, num_pdfs=10, hidden_dim=16,
                     pnorm_output_dim=8, nonlinearity=nonlinearity,
                     splice_indexes=((-2, -1, 0, 1, 2), (-1, 2), (-3, 3),
                                     (0,)))
    model = Tdnn(cfg)
    params = model.init(jax.random.PRNGKey(0))
    # init() zeroes the final affine: random weights make edges visible
    params["final"]["w"] = jax.random.normal(
        jax.random.PRNGKey(1), params["final"]["w"].shape)
    return model, params


@pytest.mark.parametrize("compute_dtype", [None, jnp.bfloat16])
@pytest.mark.parametrize("nonlinearity", ["relu", "pnorm"])
def test_pad_context_is_valid_mode_on_edge_padded_input(compute_dtype,
                                                        nonlinearity):
    model, params = _model(nonlinearity)
    x = jnp.asarray(np.random.RandomState(0).randn(2, 15, 6), jnp.float32)
    y = model.apply(params, x, pad_context=True, compute_dtype=compute_dtype)
    lc, rc = model.context_of(None)
    xp = jnp.concatenate([jnp.repeat(x[:, :1], lc, axis=1), x,
                          jnp.repeat(x[:, -1:], rc, axis=1)], axis=1)
    y_valid = model.apply(params, xp, pad_context=False,
                          compute_dtype=compute_dtype)
    assert y.shape == (2, 15, 10)
    np.testing.assert_array_equal(np.asarray(y), np.asarray(y_valid))


def test_partial_depth_pads_by_its_own_context():
    model, params = _model("relu")
    x = jnp.asarray(np.random.RandomState(1).randn(1, 11, 6), jnp.float32)
    assert model.context_of(2) == (3, 4)
    y = model.apply(params, x, pad_context=True, num_layers=2)
    assert y.shape == (1, 11, 10)
    y_valid = model.apply(params, model.edge_pad(x, 2), pad_context=False,
                          num_layers=2)
    np.testing.assert_array_equal(np.asarray(y), np.asarray(y_valid))


def test_apply_logits_and_hidden_stats_use_the_same_edges():
    model, params = _model("relu")
    x = jnp.asarray(np.random.RandomState(2).randn(1, 9, 6), jnp.float32)
    logits = model.apply_logits(params, x, pad_context=True)
    logp = model.apply(params, x, pad_context=True)
    np.testing.assert_allclose(np.asarray(jax.nn.log_softmax(logits, -1)),
                               np.asarray(logp), rtol=1e-5, atol=1e-5)
    stats = model.hidden_mean_abs(params, x, pad_context=True)
    assert len(stats) == len(model.config.splice_indexes)
