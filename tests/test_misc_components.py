"""Smaller inventory items: logistic regression LID, sinusoid detection,
HTK export roundtrip, shifted delta cepstra sanity.

(ref: ivector/logistic-regression-test.cc, feat/sinusoid-detection-test.cc,
 featbin/copy-feats-to-htk.cc, feature-functions.cc:247-285.)
"""

import numpy as np
import pytest

import jax.numpy as jnp

from kaldi_tpu.ivector.logistic_regression import (LogisticRegression,
                                                   LogisticRegressionConfig)
from kaldi_tpu.ops.sinusoid import detect_sinusoids, detect_tones
from kaldi_tpu.io.htk import read_htk, write_htk
from kaldi_tpu.ops.delta import shifted_delta


def test_logistic_regression_separates_classes():
    rng = np.random.RandomState(0)
    C, D, N = 3, 8, 200
    means = rng.randn(C, D) * 2.0
    X = np.concatenate([means[c] + rng.randn(N, D) for c in range(C)])
    y = np.repeat(np.arange(C), N)
    lr = LogisticRegression()
    loss = lr.train(X, y, LogisticRegressionConfig(max_steps=60))
    assert np.isfinite(loss)
    acc = (lr.classify(X) == y).mean()
    assert acc > 0.95
    lp = lr.log_posteriors(X[:5])
    np.testing.assert_allclose(np.exp(lp).sum(1), 1.0, atol=1e-5)
    # prior scaling shifts decisions toward the boosted class
    before = (lr.classify(X) == 2).sum()
    lr.scale_priors(np.array([0.0, 0.0, 5.0]))
    after = (lr.classify(X) == 2).sum()
    assert after > before


def test_sinusoid_detection():
    sr = 8000.0
    t = np.arange(int(sr * 0.025)) / sr
    frame = (1.5 * np.cos(2 * np.pi * 697 * t + 0.3)
             + 0.8 * np.cos(2 * np.pi * 1209 * t - 1.0))
    out = detect_sinusoids(frame, sr, max_sinusoids=2)
    assert len(out) == 2
    freqs = sorted(s.freq for s in out)
    assert abs(freqs[0] - 697) < 10 and abs(freqs[1] - 1209) < 10
    assert out[0].amplitude > out[1].amplitude  # strongest first
    # white noise: no confident sinusoids above the energy ratio
    rng = np.random.RandomState(1)
    noise = rng.randn(len(t))
    weak = detect_sinusoids(noise, sr, min_energy_ratio=0.5)
    assert weak == []


def test_detect_tones_tracks():
    sr = 8000.0
    t = np.arange(int(sr * 0.3)) / sr
    wave = np.cos(2 * np.pi * 440 * t) * 100
    tracks = detect_tones(wave, sr)
    assert len(tracks) > 20
    for (_ts, sins) in tracks[2:-2]:
        assert sins and abs(sins[0].freq - 440) < 8


def test_htk_roundtrip(tmp_path):
    rng = np.random.RandomState(2)
    x = rng.randn(50, 13).astype(np.float32)
    p = str(tmp_path / "f.htk")
    write_htk(p, x)
    y, hdr = read_htk(p)
    np.testing.assert_allclose(y, x, atol=1e-6)
    assert hdr["n_samples"] == 50 and hdr["samp_size"] == 52


def test_shifted_delta_shape():
    rng = np.random.RandomState(3)
    x = jnp.asarray(rng.randn(30, 7), jnp.float32)
    out = np.asarray(shifted_delta(x))
    # SDC default 7-1-3-7: output dim = d*(k+1) with k blocks... accept the
    # module's documented contract: first 7 dims = static features
    assert out.shape[0] == 30
    np.testing.assert_allclose(out[:, :7], np.asarray(x), atol=1e-6)


def test_train_epochs_small_corpus_pads_batch():
    """N < minibatch_size must tile the permutation up to a full batch
    (regression: short batches retrace jit / break mesh divisibility)."""
    import jax
    import numpy as np
    from kaldi_tpu.nnet.tdnn import Tdnn, TdnnConfig
    from kaldi_tpu.nnet.train import NnetTrainOpts, train_epochs, make_egs
    cfg = TdnnConfig(feat_dim=4, num_pdfs=3, splice_indexes=((-1, 0, 1),),
                     hidden_dim=8, nonlinearity="relu")
    model = Tdnn(cfg)
    params = model.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    utts = [(rng.randn(11, 4).astype(np.float32),
             rng.randint(0, 3, 11))]
    egs = make_egs(utts, cfg.left_context, cfg.right_context, chunk=4)
    assert egs["feats"].shape[0] < 16
    opts = NnetTrainOpts(num_epochs=1, minibatch_size=16)
    params2, hist = train_epochs(model, params, egs, opts)
    assert hist and np.isfinite(hist[0][2])


def test_tdnn_bf16_inference_close_to_f32():
    """bf16 fast path: log-posteriors near f32, argmax agrees."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from kaldi_tpu.nnet.tdnn import Tdnn, TdnnConfig
    cfg = TdnnConfig(feat_dim=8, num_pdfs=32, hidden_dim=64,
                     pnorm_output_dim=16,
                     splice_indexes=((-1, 0, 1), (0,)))
    model = Tdnn(cfg)
    params = model.init(jax.random.PRNGKey(0))
    x = jnp.asarray(np.random.RandomState(0).randn(2, 20, 8), np.float32)
    f32 = np.asarray(model.apply(params, x))
    bf16 = np.asarray(model.apply(params, x, compute_dtype=jnp.bfloat16))
    assert np.abs(f32 - bf16).max() < 0.15
    agree = (f32.argmax(-1) == bf16.argmax(-1)).mean()
    assert agree > 0.95
