"""FusedOnlineDecoder: single-dispatch streaming == offline batch decode.

The contract (ref: online2/online-nnet2-decoding.h:67 +
online2bin/online2-wav-nnet2-latgen-faster.cc): however the audio is
chunked, the streamed hypothesis must equal whole-utterance decoding —
here checked against the offline batch decoders' words, tids and cost,
for both search engines (padded expand and degree-tiered CSR).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from kaldi_tpu.ops import FbankOpts, FrameOpts, MelOpts, fbank
from kaldi_tpu.nnet.tdnn import Tdnn, TdnnConfig
from kaldi_tpu.nnet.am_nnet import AmNnet
from kaldi_tpu.decoder.biggraph import make_big_hclg, BigGraphConfig
from kaldi_tpu.decoder.beam_search import BeamSearchDecoder, BeamSearchOpts
from kaldi_tpu.decoder.csr_beam import CsrBeamDecoder, CsrBeamOpts
from kaldi_tpu.online.fused import FusedOnlineDecoder


@pytest.fixture(scope="module", params=["padded", "csr"])
def setup(request):
    fb_opts = FbankOpts(frame_opts=FrameOpts(dither=0.0),
                        mel_opts=MelOpts(num_bins=24))
    graph, n_tids = make_big_hclg(BigGraphConfig(
        vocab=40, avg_bigram_succ=6, num_pdfs=16, seed=3))
    cfg = TdnnConfig(feat_dim=24, num_pdfs=16, hidden_dim=64,
                     pnorm_output_dim=32, nonlinearity="relu",
                     splice_indexes=((-2, -1, 0, 1, 2), (-1, 2), (0,)))
    model = Tdnn(cfg)
    am = AmNnet(model, model.init(jax.random.PRNGKey(0)))
    if request.param == "padded":
        dec = BeamSearchDecoder(graph, BeamSearchOpts(
            beam=11.0, max_active=128, acoustic_scale=0.1))
    else:
        dec = CsrBeamDecoder(graph, CsrBeamOpts(
            beam=11.0, max_active=128, acoustic_scale=0.1,
            expand_budget=2048, eps_budget=512, hub_threshold=64))
    fused = FusedOnlineDecoder(am, dec, fb_opts, chunk_samples=2560,
                               t_max=256)
    return fb_opts, am, dec, fused


def _offline(am, dec, wave, fb_opts):
    feats = np.asarray(fbank(jnp.asarray(wave), fb_opts))
    ll = am.loglikes_np(feats[None])
    return dec.decode(ll, np.array([feats.shape[0]], np.int32))[0]


def _stream(fused, wave, chunk):
    fused.reset()
    pos = 0
    while pos < len(wave):
        fused.accept_waveform(wave[pos: pos + chunk])
        pos += chunk
    fused.input_finished()
    return fused.best_path()


@pytest.mark.parametrize("chunk", [2560, 1000, 7000])
def test_fused_equals_offline(setup, chunk):
    fb_opts, am, dec, fused = setup
    rng = np.random.default_rng(11)
    for trial in range(3):
        wave = (rng.standard_normal(rng.integers(9000, 30000))
                .astype(np.float32) * 4000)
        off_w, off_t, off_c = _offline(am, dec, wave, fb_opts)
        got = _stream(fused, wave, chunk)
        assert got is not None
        w, t, c = got
        assert list(w) == list(off_w)
        assert list(t) == list(off_t)
        assert c == pytest.approx(off_c, rel=1e-4, abs=1e-2)


def test_fused_short_utterance(setup):
    """Shorter than one dispatch chunk (ramp-up == flush)."""
    fb_opts, am, dec, fused = setup
    rng = np.random.default_rng(5)
    wave = rng.standard_normal(1700).astype(np.float32) * 4000
    off_w, off_t, off_c = _offline(am, dec, wave, fb_opts)
    got = _stream(fused, wave, 2560)
    assert got is not None
    w, t, c = got
    assert list(w) == list(off_w)
    assert list(t) == list(off_t)
    assert c == pytest.approx(off_c, rel=1e-4, abs=1e-2)


def test_fused_partial_best_path(setup):
    """Mid-stream partial results exist and final cost is finite."""
    fb_opts, am, dec, fused = setup
    rng = np.random.default_rng(7)
    wave = rng.standard_normal(16000).astype(np.float32) * 4000
    fused.reset()
    fused.accept_waveform(wave[:8000])
    partial = fused.best_path(use_final_probs=False)
    assert partial is not None
    assert np.isfinite(partial[2])
    assert np.isfinite(fused.final_relative_cost())
    fused.accept_waveform(wave[8000:])
    fused.input_finished()
    final = fused.best_path()
    off_w, _t, _c = _offline(am, dec, wave, fb_opts)
    assert list(final[0]) == list(off_w)


def test_fused_subframe_feeds(setup):
    """Many tiny accept_waveform calls (smaller than one frame)."""
    fb_opts, am, dec, fused = setup
    rng = np.random.default_rng(9)
    wave = rng.standard_normal(12000).astype(np.float32) * 4000
    off_w, off_t, off_c = _offline(am, dec, wave, fb_opts)
    got = _stream(fused, wave, 130)
    assert list(got[0]) == list(off_w)
    assert list(got[1]) == list(off_t)


def test_fused_get_lattice_equals_offline(setup):
    """Online latgen (ref: online2/online-nnet2-decoding.h:96
    GetLattice): the fused decoder's finalize-time lattice must have the
    exact path set of offline latgen on the same audio."""
    from kaldi_tpu.lat.generate import decode_to_lattices
    fb_opts, am, dec, _fused = setup
    fused = FusedOnlineDecoder(am, dec, fb_opts, chunk_samples=2560,
                               t_max=256, keep_loglikes=True)
    rng = np.random.default_rng(13)
    wave = rng.standard_normal(14000).astype(np.float32) * 4000
    feats = np.asarray(fbank(jnp.asarray(wave), fb_opts))
    ll = am.loglikes_np(feats[None])
    off = decode_to_lattices(dec, ll,
                             np.array([feats.shape[0]], np.int32), 6.0)[0]
    got = _stream(fused, wave, 2560)
    assert got is not None
    lat = fused.get_lattice(6.0)
    assert (lat is None) == (off is None)
    if lat is None:
        return
    po = {(w, t): round(c, 2) for (w, t, c) in off.paths(max_paths=100000)}
    pg = {(w, t): round(c, 2) for (w, t, c) in lat.paths(max_paths=100000)}
    assert po == pg


def test_fused_endpointing(setup):
    """Endpoint rules over the fused decoder's partial state: with every
    phone mapped to silence, trailing silence grows with the stream and
    rule1 (long trailing silence, no nonsilence required) fires."""
    import math
    from kaldi_tpu.online.endpoint import EndpointConfig, EndpointRule
    fb_opts, am, dec, fused = setup
    rng = np.random.default_rng(17)
    wave = rng.standard_normal(16000).astype(np.float32) * 4000

    class _AllSilence:
        @staticmethod
        def transition_id_to_phone(tid):
            return 0

    cfg_fire = EndpointConfig(
        rule1=EndpointRule(False, 0.05, math.inf, 0.0))
    cfg_hold = EndpointConfig(
        rule1=EndpointRule(False, 1e9, math.inf, 0.0),
        rule2=EndpointRule(True, 1e9, -1e9, 0.0),
        rule3=EndpointRule(True, 1e9, -1e9, 0.0),
        rule4=EndpointRule(True, 1e9, math.inf, 0.0),
        rule5=EndpointRule(False, 0.0, math.inf, 1e9))
    fused.reset()
    fused.accept_waveform(wave)
    assert fused.endpoint_detected(cfg_fire, {0}, _AllSilence)
    assert not fused.endpoint_detected(cfg_hold, {0}, _AllSilence)
    fused.input_finished()


def test_fused_near_capacity_utterance(setup):
    """Utterance whose final dispatch lands within ndmax frames of t_max.

    Regression: arena writes are fixed ndmax-row blocks at d0 and
    dynamic_update_slice CLAMPS the start index, so with an unpadded
    arena the final chunk's records were written at shifted positions,
    corrupting earlier frames' backpointers. The arena is now padded by
    ndmax rows; streamed output must equal offline right up to t_max."""
    fb_opts, am, dec, _fused = setup
    rng = np.random.default_rng(31)
    wave = rng.standard_normal(40000).astype(np.float32) * 4000
    from kaldi_tpu.ops import fbank as _fb
    total = np.asarray(_fb(jnp.asarray(wave), fb_opts)).shape[0]
    tight = FusedOnlineDecoder(am, dec, fb_opts, chunk_samples=2560,
                               t_max=total)      # exactly-full arena
    off_w, off_t, off_c = _offline(am, dec, wave, fb_opts)
    got = _stream(tight, wave, 2560)
    assert got is not None
    w, t, c = got
    assert list(w) == list(off_w)
    assert list(t) == list(off_t)
    assert c == pytest.approx(off_c, rel=1e-4, abs=1e-2)


def test_fused_loglikes_equal_offline_at_edges(setup):
    """With a non-uniform model (init() zeroes the final affine, which
    hides edge frames), the streamed per-frame scores equal offline
    AM scoring on every frame, first and last lc/rc frames included."""
    fb_opts, am, dec, _fused = setup
    params = dict(am.params)
    params["final"] = dict(params["final"])
    params["final"]["w"] = jax.random.normal(
        jax.random.PRNGKey(5), params["final"]["w"].shape)
    am2 = AmNnet(am.model, params)
    fused = FusedOnlineDecoder(am2, dec, fb_opts, chunk_samples=2560,
                               t_max=256, keep_loglikes=True)
    wave = (np.random.default_rng(13).standard_normal(14000)
            .astype(np.float32) * 4000)
    for pos in range(0, len(wave), 2560):
        fused.accept_waveform(wave[pos: pos + 2560])
    fused.input_finished()
    n = fused.num_frames_decoded
    ll_stream = np.asarray(fused._carry[-1][:n])
    feats = np.asarray(fbank(jnp.asarray(wave), fb_opts))
    ll_off = am2.loglikes_np(feats[None])[0]
    assert ll_stream.shape == ll_off.shape
    np.testing.assert_allclose(ll_stream, ll_off, rtol=1e-5, atol=1e-4)
    got = fused.best_path()
    off_w, off_t, off_c = _offline(am2, dec, wave, fb_opts)
    assert list(got[0]) == list(off_w)
    assert list(got[1]) == list(off_t)
