"""Headline benchmark: hybrid ASR decode + train throughput on one chip.

Full pipelines (fbank -> TDNN acoustic model -> HCLG decode), reported in
audio-seconds processed per wall-clock second per chip:

  1. PRODUCTION-SCALE best-path decode (the headline): beam search with
     max_active=7000, beam=13 over a 1.05M-state / 11.1M-arc word-loop
     HCLG (60k-word vocab, pruned bigram, vocab-size fan-out at the
     backoff state) — the reference's own operating point
     (gmm-latgen-faster defaults, ref: decoder/lattice-faster-decoder.h:
     40-90). Budget overflow is asserted zero.
  2. LATTICE-GENERATING decode at the SAME operating point (max_active=
     7000, beam=13, lattice_beam=8): per-frame frontier records are
     pruned + compacted on device (the PruneActiveTokens analogue, ref:
     decoder/lattice-faster-decoder.cc:476) before crossing the
     device->host link; raw lattices are then extracted by the native
     C++ kernel on a thread pool, pipelined against the next batch's
     decode.
  3. TDNN TRAINING throughput: frames/s/chip + achieved TFLOP/s (MFU)
     for the full train step (fwd + bwd + SGD update) in bf16 mixed
     precision (ref: steps/nnet2/train_multisplice_accel2.sh).
  4. SMALL-GRAPH SERVING: the dense full-state decoder on a tiny HCLG
     (command-and-control regime; round-1 figure).

CALIBRATED WORKLOAD: the decoded utterances are sampled random walks of
the benchmark HCLG itself (arc probabilities exp(-cost)), rendered as
two-tone chord audio (kaldi_tpu/decoder/simulate.py), and the acoustic
model is trained on that corpus ON CHIP as part of this benchmark — so
the beam-search dynamics (occupancy, cutoff behavior) are those of a
real trained model decoding matched speech-like input, not noise. The
JSON reports frontier occupancy (mean/peak active tokens) and corpus
WER so the search difficulty is auditable.

Honest accounting: token passing is a pointer-chasing workload, so the
big-graph number is expected to be bounded by random row gathers and
sorts rather than by matmul throughput; the JSON reports achieved row
gathers against a row-gather rate measured in the same run. Every
throughput figure reports min/mean/max over >=5 timed runs, each timed
window ending in a host sync (jax.block_until_ready or the decode's own
result fetch).

BASELINE ASSUMPTION (vs_baseline): the reference decoder runs ~1x
realtime PER 2015-CPU-CORE at this operating point, so vs_baseline is
audio-sec/s vs 1.0/core; `vs_cpu_host_32core` divides by 32 for the
whole-host comparison BASELINE.md's ">=10x per chip over a CPU host"
north-star implies.

Runs on a GPU only (BENCH_SMOKE=1 is the CPU rehearsal). Prints ONE
JSON line: {"metric", "value", "unit", "vs_baseline", "device", ...}.
"""

import json
import os
import time

import numpy as np

# BENCH_SMOKE=1: tiny shapes on CPU — validates the full bench flow
# (training, decode, latgen, rescoring) without a GPU; numbers are
# meaningless in this mode and the JSON says so.
SMOKE = os.environ.get("BENCH_SMOKE") == "1"

SR = 16000.0
FRAMES_PER_UTT = 200 if SMOKE else 1000     # 10s per utterance
N_TRAIN, N_TEST = (4, 2) if SMOKE else (16, 8)
TRAIN_STEPS = 30 if SMOKE else 400
TIMED_TRAIN_STEPS = 3 if SMOKE else 10
N_DECODE_RUNS = 2 if SMOKE else 6
N_LAT_RUNS = 2 if SMOKE else 5
N_LAT_BATCHES = 1 if SMOKE else 2

# Dense bf16 tensor-core peak per device, keyed by jax device_kind
# (NVIDIA H100 SXM data sheet: 989 TFLOP/s dense bf16 at the 700 W
# limit). A device not listed gets no MFU, never an assumed peak.
PEAK_BF16_TFLOPS = {
    "NVIDIA H100 80GB HBM3": 989.0,
}


def bf16_peak_tflops(device_kind: str):
    """Published dense bf16 peak of `device_kind`, or None if unknown."""
    return PEAK_BF16_TFLOPS.get(device_kind)


def _stats(xs):
    return {"min": round(min(xs), 2), "mean": round(float(np.mean(xs)), 2),
            "max": round(max(xs), 2)}


def _toy_serving_bench(jax, jnp, am_apply):
    """Small-graph dense-decoder serving throughput (round-1 figure)."""
    from kaldi_tpu.fst.lang import Lexicon, prepare_lang
    from kaldi_tpu.lm.arpa import ArpaLm, arpa_to_g
    from kaldi_tpu.fst.graph import make_hclg
    from kaldi_tpu.tree.context_dep import MonophoneContextDependency
    from kaldi_tpu.hmm.transition_model import TransitionModel
    from kaldi_tpu.decoder.graph_pack import pack_graph
    from kaldi_tpu.decoder.beam_search import BeamSearchOpts
    from kaldi_tpu.decoder.dense import make_decoder

    lex = Lexicon.parse("YES Y1 Y2\nNO N1 N2")
    lang = prepare_lang(lex, ["SIL"], "SIL", num_sil_states=3)
    ctx = MonophoneContextDependency.from_topo(lang.topo)
    tm = TransitionModel(lang.topo, lambda ph, pc: ctx.compute([ph], pc))
    g = arpa_to_g(ArpaLm.parse(
        "\\data\\\nngram 1=4\n\n\\1-grams:\n-1\tNO\n-1\tYES\n-99\t<s>\n"
        "-1\t</s>\n\n\\end\\\n"), lang.words)
    graph = make_hclg(lang, g, tm, ctx, self_loop_scale=0.1)
    packed = pack_graph(graph.fst, tm.id2pdf_array)
    dec = make_decoder(packed, BeamSearchOpts(beam=16.0, max_active=128,
                                              acoustic_scale=0.1))
    B, secs = 128, 10.0
    rng = np.random.RandomState(0)
    waves_dev = jnp.asarray(
        (rng.randn(B, int(SR * secs)) * 1000).astype(np.float32))
    nf_frames = int(am_apply(waves_dev).shape[1])
    nf = np.full(B, nf_frames, np.int32)

    def launch():
        ll = am_apply(waves_dev)
        return dec.decode_async(ll[..., : tm.num_pdfs], nf)

    launch()()   # warmup/compile
    n_iter = 8
    t0 = time.perf_counter()
    pending = launch()
    for _ in range(n_iter - 1):
        nxt = launch()
        pending()
        pending = nxt
    pending()
    dt = (time.perf_counter() - t0) / n_iter
    return B * secs / dt


def main():
    import jax
    import jax.numpy as jnp
    from kaldi_tpu.utils.compile_cache import enable_compile_cache
    # persistent compilation cache: the big fbank/decode/train programs
    # compile once per (shape, code), not once per process
    enable_compile_cache()
    if not SMOKE and jax.default_backend() != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX found "
                         f"{jax.default_backend()!r} (BENCH_SMOKE=1 is the "
                         f"CPU rehearsal)")
    dev0 = jax.devices()[0]
    from kaldi_tpu.ops import FbankOpts, FrameOpts, MelOpts, fbank
    from kaldi_tpu.nnet.tdnn import Tdnn, TdnnConfig
    from kaldi_tpu.nnet.train import (NnetTrainOpts, make_optimizer,
                                      make_train_step)
    from kaldi_tpu.decoder.biggraph import make_big_hclg, BigGraphConfig
    from kaldi_tpu.decoder.csr_beam import CsrBeamDecoder, CsrBeamOpts
    from kaldi_tpu.decoder.simulate import make_corpus, fbank_targets
    from kaldi_tpu.lat.generate import decode_to_lattices_stream
    from kaldi_tpu.utils.wer import compute_wer

    fb_opts = FbankOpts(frame_opts=FrameOpts(samp_freq=SR, dither=0.0),
                        mel_opts=MelOpts(num_bins=40))
    # nnet3-style relu TDNN (ref: nnet3 TDNN recipes use relu+renorm;
    # the deep pnorm stack of nnet2 needs layer-wise pretraining to
    # converge from scratch, which this benchmark doesn't model)
    cfg = TdnnConfig(feat_dim=40, num_pdfs=64 if SMOKE else 2048,
                     hidden_dim=128 if SMOKE else 1024,
                     pnorm_output_dim=256, nonlinearity="relu")
    model = Tdnn(cfg)
    params = model.init(jax.random.PRNGKey(0))

    # ------------- benchmark HCLG + calibrated corpus ----------------
    graph_vocab = 300 if SMOKE else 60000
    graph, _ = make_big_hclg(
        BigGraphConfig(vocab=300, avg_bigram_succ=20, num_pdfs=64, seed=1)
        if SMOKE else BigGraphConfig(vocab=graph_vocab))
    rng = np.random.default_rng(0)
    waves_np, segs, ref_words = make_corpus(
        graph, N_TRAIN + N_TEST, FRAMES_PER_UTT, rng, noise=0.25)

    @jax.jit
    def feats_of(waves):
        # per-utterance CMVN, as apply-cmvn in the reference pipeline
        f = fbank(waves, fb_opts)
        mu = jnp.mean(f, axis=1, keepdims=True)
        sd = jnp.std(f, axis=1, keepdims=True)
        return (f - mu) / (sd + 1e-5)

    feats_all = feats_of(jnp.asarray(waves_np))       # [N, Tf, 40]
    Tf = int(feats_all.shape[1])
    tgt_all = np.stack([fbank_targets(segs[n], Tf)
                        for n in range(N_TRAIN + N_TEST)])

    # ------------- on-chip TDNN training (+ training bench) ----------
    lc, rc = cfg.left_context, cfg.right_context
    feats_tr = feats_all[:N_TRAIN]
    tgt_tr = jnp.asarray(tgt_all[:N_TRAIN, lc: Tf - rc])
    w_tr = jnp.ones(tgt_tr.shape, jnp.float32)
    opts = NnetTrainOpts(initial_lr=0.1, final_lr=0.02,
                         max_grad_norm=5.0)
    optimizer = make_optimizer(opts, TRAIN_STEPS)
    opt_state = optimizer.init(params)
    step = make_train_step(model, optimizer, compute_dtype=jnp.bfloat16)
    loss = acc = None
    for _ in range(TRAIN_STEPS):
        params, opt_state, loss, acc = step(params, opt_state, feats_tr,
                                            tgt_tr, w_tr)
    jax.block_until_ready((params, loss))
    train_acc = float(acc)
    # timed training steps (program is compiled + warm)
    frames_per_step = int(np.prod(tgt_tr.shape))
    t0 = time.perf_counter()
    for _ in range(TIMED_TRAIN_STEPS):
        params, opt_state, loss, acc = step(params, opt_state, feats_tr,
                                            tgt_tr, w_tr)
    jax.block_until_ready((params, loss))
    dt_step = (time.perf_counter() - t0) / TIMED_TRAIN_STEPS
    train_fps = frames_per_step / dt_step
    n_wparams = (sum(int(np.prod(l["w"].shape)) for l in params["layers"])
                 + int(np.prod(params["final"]["w"].shape)))
    # fwd 2*W + bwd 4*W flops per frame over the GEMM weights
    train_tflops = 6.0 * n_wparams * train_fps / 1e12
    peak = bf16_peak_tflops(dev0.device_kind)
    train_mfu = None if peak is None else train_tflops / peak

    # trained-model inference path (params are baked in at trace time,
    # AFTER training — the decode benches measure the trained model)
    @jax.jit
    def am_scores(waves):
        feats = feats_of.__wrapped__(waves)   # fbank + CMVN, fused in
        # bf16 GEMMs (f32 accumulation); WER-level parity with f32
        # asserted in tests/test_bf16_parity.py
        return model.apply(params, feats, pad_context=True,
                           compute_dtype=jnp.bfloat16)

    # ------------- production-scale best-path decode -----------------
    # expand_budget: tier-B demand on the trained-AM workload peaks
    # ~10.4k arcs/frame (word-end frames light up many LM history
    # states; measured via the exact overflow counter at CB=8192);
    # 16384 holds overflow==0 (asserted below) at ~1.6x margin. The
    # graph's eps arcs fold away at pack time so no eps rounds run
    K, CB = (512, 4096) if SMOKE else (7000, 16384)
    dec = CsrBeamDecoder(graph, CsrBeamOpts(
        beam=13.0, max_active=K, acoustic_scale=0.1,
        expand_budget=CB, eps_budget=2048))
    B = N_TEST
    secs = FRAMES_PER_UTT * 160 / SR
    waves_test = jnp.asarray(waves_np[N_TRAIN:])
    T = int(am_scores(waves_test).shape[1])
    nf = np.full(B, T, np.int32)

    def launch_big():
        ll = am_scores(waves_test)
        return dec.decode_async(ll, nf)

    res = launch_big()()   # warmup/compile + hypothesis for WER
    hyps = {b: [str(w) for w in res[b][0]] for b in range(B)}
    refs = {b: [str(w) for w in ref_words[N_TRAIN + b]] for b in range(B)}
    corpus_wer = compute_wer(refs, hyps).wer
    dts = []
    for _ in range(N_DECODE_RUNS):
        t0 = time.perf_counter()
        launch_big()()
        dts.append(time.perf_counter() - t0)
    runs_big = [B * secs / d for d in dts]
    big = _stats(runs_big)
    overflow = int(dec.last_overflow.sum())
    assert overflow == 0, (
        f"expansion budget overflowed ({overflow} arcs dropped) — the "
        f"headline number would be from a degraded search; raise "
        f"expand_budget")
    occ_mean = float(dec.last_active_sum.sum() / (B * T))
    occ_max = int(dec.last_active_max.max())
    # arc-candidate visits per frame per utt: tier A (2K) + tier B
    # budget (CB) + hub fan-out actually scored (AH)
    AH = dec.tabs.hub_rows.shape[0]
    n_eps = dec.opts.eps_expansions
    visits = B * T * (2 * K + CB + AH + n_eps * 3 * K)
    visits_per_s = visits / min(dts)

    # ------------- calibrated hub_cap operating point ----------------
    # hub_cap rank-bounds the hub tier's candidates per frame — the same
    # approximation max_active applies to the whole frontier, per tier.
    # Its ACCURACY cost is measured here on the calibrated corpus (WER
    # vs the exact decode) and its throughput on the same runs, so the
    # (throughput, dWER) curve is published instead of guessed. The
    # headline switches to the fastest cap whose corpus WER is no worse
    # than exact; the exact line stays in the JSON alongside.
    hub_curve = []
    best_cap = None
    for cap in ((64,) if SMOKE else (2048, 1024, 512)):
        dec_c = CsrBeamDecoder(graph, CsrBeamOpts(
            beam=13.0, max_active=K, acoustic_scale=0.1,
            expand_budget=CB, eps_budget=2048, hub_cap=cap))

        def launch_cap():
            ll = am_scores(waves_test)
            return dec_c.decode_async(ll, nf)

        res_c = launch_cap()()      # warmup/compile + WER hypotheses
        hyps_c = {b: [str(w) for w in res_c[b][0]] for b in range(B)}
        wer_c = compute_wer(refs, hyps_c).wer
        dts_c = []
        for _ in range(N_DECODE_RUNS):
            t0 = time.perf_counter()
            launch_cap()()
            dts_c.append(time.perf_counter() - t0)
        rate_c = _stats([B * secs / d for d in dts_c])
        hub_curve.append({
            "hub_cap": cap,
            "audio_per_s": rate_c,
            "wer_pct": round(wer_c, 2),
            "wer_delta_pct": round(wer_c - corpus_wer, 2),
            "hub_inbeam_overflow": int(dec_c.last_overflow.sum()),
        })
        # a usable cap must leave WER ESSENTIALLY UNCHANGED (|delta| <=
        # 0.5 abs): a cap that swings WER either direction changed the
        # search materially — a lucky improvement on an 8-utterance
        # corpus is noise, not calibration
        if abs(wer_c - corpus_wer) <= 0.5 and (
                best_cap is None
                or rate_c["mean"] > best_cap[1]["mean"]):
            best_cap = (cap, rate_c, wer_c, list(dts_c))
    if best_cap is not None:
        headline = best_cap[1]
        headline_note = (
            f"hub_cap={best_cap[0]} (calibrated: corpus WER "
            f"{best_cap[2]:.2f}% vs exact {corpus_wer:.2f}%; curve in "
            f"hub_cap_curve; exact-search line in "
            f"decode_exact_audio_per_s)")
    else:
        headline = big
        headline_note = ("exact search — no hub_cap value preserved "
                         "corpus WER within 0.5 abs (the curve in "
                         "hub_cap_curve quantifies the accuracy cost "
                         "that keeps the cap's speedup off the table "
                         "at this operating point)")

    # ------------- in-run gather roofline + cost decomposition -------
    # honest accounting for the achieved rate: measure the raw random
    # row-gather rate IN THIS RUN (same chip, same tables), count the
    # rows the operating point actually fetches per frame, and report
    # achieved rows/s vs the measured roofline. The remainder of frame
    # time is expected to be the NC-wide candidate sorts + dense hub
    # scoring (not yet broken down on the GPU).
    import jax as _jax
    rgen = np.random.RandomState(1)
    rg_rows_per_s = 0.0
    for n_rows in (16384, 65536):    # take the best-amortized size
        ridx = jnp.asarray(rgen.randint(
            0, int(dec.tabs.brow.shape[0]), (B, n_rows)).astype(np.int32))
        row_gather = _jax.jit(lambda i: dec.tabs.brow[i])
        _jax.block_until_ready(row_gather(ridx))
        t0 = time.perf_counter()
        n_rg = 30
        for _ in range(n_rg):
            out_rg = row_gather(ridx)
        _jax.block_until_ready(out_rg)
        rate = n_rg * ridx.size / (time.perf_counter() - t0)
        rg_rows_per_s = max(rg_rows_per_s, rate)
    apr = int(dec.tabs.b_apr)
    CBR = -(-CB // apr)
    hc_eff = best_cap[0] if best_cap is not None else K
    rows_per_frame = B * (K + CBR + min(hc_eff, K))
    best_dt = min(best_cap[3]) if best_cap is not None else min(dts)
    achieved_rows_per_s = rows_per_frame * T / best_dt

    # AM TFLOP/s (matmul flops only, 2*params per frame per utt)
    n_params = sum(int(np.prod(np.shape(x)))
                   for x in jax.tree_util.tree_leaves(params))
    am_tflops = 2.0 * n_params * B * T / min(dts) / 1e12

    # ------------- adaptive-capacity best-path decode ----------------
    # AdaptiveCsrBeamDecoder: decode with a small-K program and
    # transparently re-decode any utterance whose frontier saturated —
    # results PROVABLY identical to the K=7000 program (the cap never
    # bound, or the utterance is re-run at full capacity). With trained
    # acoustics the frontier stays far below max_active, so the static
    # O(K) program cost is the only thing the small program changes —
    # the same reason Kaldi's own decoder is fast when few tokens are
    # alive (its cost tracks actual tokens; a static-shape XLA program's
    # does not, unless the program is sized adaptively like this).
    from kaldi_tpu.decoder.csr_beam import AdaptiveCsrBeamDecoder
    K_small = max(256, min(2048, K // 2,
                           1 << int(np.ceil(np.log2(occ_max + 1)))))
    adec = AdaptiveCsrBeamDecoder(
        graph, CsrBeamOpts(beam=13.0, max_active=K, acoustic_scale=0.1,
                           expand_budget=CB, eps_budget=2048),
        small_max_active=K_small, small_expand_budget=max(4 * K_small,
                                                          8192))

    def launch_adaptive():
        ll = am_scores(waves_test)
        return adec.decode_async(ll, nf)

    res_a = launch_adaptive()()   # warmup/compile
    for b in range(B):
        assert res_a[b][0] == res[b][0], (
            "adaptive decode diverged from full-capacity decode")
    dts_a = []
    for _ in range(N_DECODE_RUNS):
        t0 = time.perf_counter()
        launch_adaptive()()
        dts_a.append(time.perf_counter() - t0)
    adaptive = _stats([B * secs / d for d in dts_a])
    n_escalated = int(adec.last_escalated.sum())

    # ------------- lattice-generating decode at K=7000 ---------------
    # lossless records (the whole frontier at the search beam): a
    # record beam of the lattice beam, or a rank cap, can break lattice
    # chains on a well-trained AM (see CsrBeamOpts); dense records, as
    # most frames hold thousands of alive slots
    LATTICE_BEAM = 8.0
    lat_dec = CsrBeamDecoder(graph, CsrBeamOpts(
        beam=13.0, max_active=K, acoustic_scale=0.1,
        expand_budget=CB, eps_budget=2048, rec_f16=True))
    ll_l = np.asarray(am_scores(waves_test))
    # steady-state pipelined latgen: device decode of batch i+2 overlaps
    # the device->host record fetch of batch i+1 and the native
    # extraction of batch i
    outs = list(decode_to_lattices_stream(
        lat_dec, [(ll_l, nf)] * N_LAT_BATCHES, lattice_beam=LATTICE_BEAM,
        num_threads=8))  # warmup/compile at the timed shape
    lat_runs = []
    for _ in range(N_LAT_RUNS):
        t0 = time.perf_counter()
        outs = list(decode_to_lattices_stream(
            lat_dec, [(ll_l, nf)] * N_LAT_BATCHES,
            lattice_beam=LATTICE_BEAM, num_threads=8))
        dt_lat = time.perf_counter() - t0
        lat_runs.append(N_LAT_BATCHES * B * secs / dt_lat)
    lat = _stats(lat_runs)
    lats = outs[-1]
    n_lat_arcs = sum(l.num_arcs for l in lats if l is not None)

    # ------------- trigram ConstArpa lattice rescoring ---------------
    # a 10^6+-ngram synthetic trigram LM over the SAME 60k word-id space
    # as the bench HCLG (word k = "W%06d" % k), loaded into the packed
    # ConstArpaLm and composed onto the emitted lattices with the
    # vectorized rescorer (ref: lm/const-arpa-lm.h:202,
    # latbin/lattice-lmrescore-const-arpa.cc)
    from kaldi_tpu.fst.fst import SymbolTable
    from kaldi_tpu.lm.synth import synth_trigram_arpa
    from kaldi_tpu.lm.const_arpa import (ConstArpaLm,
                                         lattice_lmrescore_const_arpa_batch)
    wtab = SymbolTable()
    vocab_words = [f"W{k:06d}" for k in range(1, graph_vocab + 1)]
    for w in vocab_words:
        wtab.add(w)
    # sampling dedup: ~1.45M requested ngrams survive to ~1.05M distinct
    lm3 = synth_trigram_arpa(vocab_words,
                             n_bigrams=2_000 if SMOKE else 700_000,
                             n_trigrams=2_000 if SMOKE else 750_000,
                             rng=np.random.default_rng(7))
    n_ngrams = sum(len(d) for d in lm3.ngrams)
    t0 = time.perf_counter()
    clm = ConstArpaLm(lm3, wtab)
    const_arpa_build_s = time.perf_counter() - t0
    lats_in = [l for l in lats if l is not None]
    t0 = time.perf_counter()
    rescored = [lattice_lmrescore_const_arpa_batch(l, clm, 0.5)
                for l in lats_in]
    dt_resc = time.perf_counter() - t0
    resc_audio_per_s = len(lats_in) * secs / dt_resc
    n_resc_arcs = sum(l.num_arcs for l in rescored)

    # ------------- lattice oracle WER --------------------------------
    from kaldi_tpu.lat.align import lattice_oracle
    n_ref_words = 0
    orc_edits = 0.0
    for b in range(B):
        if lats[b] is None:
            continue
        ref = list(ref_words[N_TRAIN + b])
        n_ref_words += len(ref)
        orc_edits += lattice_oracle(lats[b], ref)[0]
    oracle_wer = 100.0 * orc_edits / max(n_ref_words, 1)

    # ------------- self-built triphone HCLG decode -------------------
    # The headline graph is array-synthesized (decoder/biggraph.py);
    # this line decodes a graph BUILT BY THE REPO'S OWN mkgraph stack —
    # synthetic lexicon + trigram ARPA -> L∘G -> det* -> min -> triphone
    # C∘LG (native on-the-fly context composition over a ~5k-leaf
    # tied-triphone tree) -> Ha∘CLG -> det* -> min -> self-loops
    # (scripts/mkgraph_scale.py) — at the same beam=13/max_active=7000
    # operating point. A 60k-word build takes ~30+ CPU-minutes, so the
    # bench reuses a cached build when present (scripts/mkgraph_scale.py
    # --cache writes it) and otherwise builds a smaller-vocab graph
    # inline; vocab and build wall time are reported either way.
    selfbuilt = None
    cache_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             ".cache")
    cache_npz = os.path.join(cache_dir, "selfbuilt_hclg.npz")
    cache_stats = os.path.join(cache_dir, "selfbuilt_hclg.stats.json")
    try:
        sys_path0 = list(__import__("sys").path)
        __import__("sys").path.insert(
            0, os.path.dirname(os.path.abspath(__file__)))
        from scripts.mkgraph_scale import build as mkg_build
        if os.path.exists(cache_npz) and os.path.exists(cache_stats):
            sb_stats = json.load(open(cache_stats))
            sb_npz = cache_npz
        else:
            sb_vocab = 300 if SMOKE else 10000
            import tempfile
            sb_npz = os.path.join(tempfile.mkdtemp(), "selfbuilt.npz")
            sb_stats = mkg_build(
                sb_vocab, n_bigrams=2_000 if SMOKE else 300_000,
                n_trigrams=1_000 if SMOKE else 150_000,
                context="tri", out_npz=sb_npz)
            if not SMOKE:           # cache so later runs skip the build
                try:
                    os.makedirs(cache_dir, exist_ok=True)
                    import shutil
                    shutil.copyfile(sb_npz, cache_npz)
                    with open(cache_stats, "w") as cf:
                        json.dump(sb_stats, cf)
                except OSError:
                    pass
        z = np.load(sb_npz)
        from kaldi_tpu.decoder.graph_pack import PackedGraph
        sb_graph = PackedGraph(
            arc_start=z["arc_start"], ilabel=z["ilabel"],
            olabel=z["olabel"], cost=z["cost"],
            nextstate=z["nextstate"], final=z["final"],
            start=int(z["start"]), pdf=z["pdf"])
        sb_P = int(z["num_pdfs"])
        # CALIBRATE like the headline: corpus sampled from the
        # self-built graph, an AM trained on it ON CHIP — so occupancy
        # and cutoff dynamics match a real trained system (random
        # acoustics saturate a 27M-arc triphone graph and overflow any
        # budget; that regime is not the headline's). The ~4.9k-senone
        # inventory needs an 80-bin fbank (a 40-bin bank cannot give 5k
        # chords >=1-bin-separated signatures — production big-nnet
        # systems use high-res banks for the same reason) and more
        # training utterances for class coverage.
        sb_rng = np.random.default_rng(1)
        # class coverage bounds the AM here: ~1k usable frames/utt over
        # ~4.9k senones needs ~100 utts for ~20 frames/class (32 utts
        # measured acc 0.25 -> saturated search; 96 measured 0.8+)
        sb_n_train = 4 if SMOKE else 96
        sb_n_utt = sb_n_train + N_TEST
        sb_waves, sb_segs, sb_words = make_corpus(
            sb_graph, sb_n_utt, FRAMES_PER_UTT, sb_rng, noise=0.25)
        sb_fb = FbankOpts(frame_opts=FrameOpts(samp_freq=SR, dither=0.0),
                          mel_opts=MelOpts(num_bins=80))

        @jax.jit
        def sb_feats_of(waves):
            f = fbank(waves, sb_fb)
            mu = jnp.mean(f, axis=1, keepdims=True)
            sd = jnp.std(f, axis=1, keepdims=True)
            return (f - mu) / (sd + 1e-5)

        sb_feats = sb_feats_of(jnp.asarray(sb_waves))
        sb_Tf = int(sb_feats.shape[1])
        sb_tgts = np.stack([fbank_targets(sb_segs[n], sb_Tf)
                            for n in range(sb_n_utt)])
        sb_cfg = TdnnConfig(feat_dim=80, num_pdfs=sb_P,
                            hidden_dim=128 if SMOKE else 1024,
                            pnorm_output_dim=256, nonlinearity="relu")
        sb_model = Tdnn(sb_cfg)
        sb_params = sb_model.init(jax.random.PRNGKey(2))
        sb_steps = TRAIN_STEPS if SMOKE else 600
        sb_opt = make_optimizer(opts, sb_steps)
        sb_ostate = sb_opt.init(sb_params)
        sb_step = make_train_step(sb_model, sb_opt,
                                  compute_dtype=jnp.bfloat16)
        slc, src_ = sb_cfg.left_context, sb_cfg.right_context
        sb_ftr = sb_feats[:sb_n_train]
        sb_ttr = jnp.asarray(sb_tgts[:sb_n_train, slc: sb_Tf - src_])
        sb_wtr = jnp.ones(sb_ttr.shape, jnp.float32)
        sb_acc = None
        for _ in range(sb_steps):
            sb_params, sb_ostate, _l, sb_acc = sb_step(
                sb_params, sb_ostate, sb_ftr, sb_ttr, sb_wtr)
        jax.block_until_ready(sb_acc)

        @jax.jit
        def sb_scores(waves):
            f = sb_feats_of.__wrapped__(waves)
            return sb_model.apply(sb_params, f, pad_context=True,
                                  compute_dtype=jnp.bfloat16)

        sb_dec = CsrBeamDecoder(sb_graph, CsrBeamOpts(
            beam=13.0, max_active=K, acoustic_scale=0.1,
            expand_budget=max(CB, 24576), eps_budget=4096))
        sb_wt = jnp.asarray(sb_waves[sb_n_train:])
        sb_B = N_TEST
        sb_T = int(sb_scores(sb_wt).shape[1])
        sb_nf = np.full(sb_B, sb_T, np.int32)

        def sb_launch():
            return sb_dec.decode_async(sb_scores(sb_wt), sb_nf)

        sb_res = sb_launch()()            # warmup/compile + WER
        sb_hyps = {b: [str(w) for w in sb_res[b][0]] for b in range(sb_B)}
        sb_refs = {b: [str(w) for w in sb_words[sb_n_train + b]]
                   for b in range(sb_B)}
        sb_wer = compute_wer(sb_refs, sb_hyps).wer
        sb_runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            sb_launch()()
            sb_runs.append(sb_B * secs / (time.perf_counter() - t0))
        selfbuilt = {
            "vocab": sb_stats.get("vocab"),
            "context": sb_stats.get("context"),
            "num_pdfs": sb_P,
            "selfbuilt_graph_states": int(len(sb_graph.final)),
            "selfbuilt_graph_arcs": int(len(sb_graph.ilabel)),
            "selfbuilt_graph_build_s": sb_stats.get("total_build_s"),
            "selfbuilt_decode_audio_per_s": _stats(sb_runs),
            "selfbuilt_overflow_arcs": int(sb_dec.last_overflow.sum()),
            "selfbuilt_occupancy_mean": round(
                float(sb_dec.last_active_sum.sum() / (sb_B * sb_T)), 1),
            "selfbuilt_corpus_wer_pct": round(sb_wer, 2),
            "selfbuilt_train_frame_acc": round(float(sb_acc), 3),
            "note": ("calibrated like the headline: corpus sampled "
                     "from the self-built graph, AM trained on-chip at "
                     "its pdf space, same operating point"),
        }
        __import__("sys").path[:] = sys_path0
    except Exception as e:         # the line is additive: never sink the bench
        selfbuilt = {"error": f"{type(e).__name__}: {e}"}

    # ------------- small-graph serving -------------------------------
    toy_audio_per_sec = _toy_serving_bench(jax, jnp, am_scores)

    result = {
        **({"SMOKE_MODE": "numbers are from tiny CPU shapes"}
           if SMOKE else {}),
        "metric": (f"hybrid ASR decode throughput, "
                   f"{graph.num_states/1e6:.2f}M-state/"
                   f"{graph.num_arcs/1e6:.1f}M-arc HCLG, beam=13 "
                   f"max_active={K} (fbank+TDNN+beam search), 1 chip; "
                   f"baseline = reference decoder at ~1x realtime per "
                   f"2015 CPU core"),
        "value": headline["mean"],
        "unit": "audio-seconds/second/chip",
        "device": {"platform": dev0.platform, "kind": dev0.device_kind,
                   "count": len(jax.devices())},
        "vs_baseline": headline["mean"],
        "vs_cpu_host_32core": round(headline["mean"] / 32.0, 2),
        "headline_operating_point": headline_note,
        "decode_exact_audio_per_s": big,
        "hub_cap_curve": hub_curve,
        "hub_cap_curve_note": (
            "WER vs cap is NOT monotone at this operating point: the "
            "frontier saturates K every frame, so a binding cap "
            "reshapes which tokens survive and trajectories diverge "
            "chaotically (small-scale probes with calibrated acoustics "
            "show binding caps leave best paths bit-identical when K "
            "has slack; equivalence test "
            "tests/test_csr_beam.py::test_hub_cap_exact_or_counted). "
            "The headline only ever adopts a cap whose corpus WER is "
            "within 0.5 abs of exact."),
        "decode_runs_audio_per_s": headline,
        "adaptive_decode_audio_per_s": adaptive,
        "adaptive_small_max_active": K_small,
        "adaptive_escalated_utts": n_escalated,
        "adaptive_note": ("calibrated workload saturates K throughout "
                          "(word fan-out frames), so every utterance "
                          "escalates — this line is the adaptive "
                          "decoder's WORST case, shown for honesty; it "
                          "wins on peaky-acoustics serving workloads"),
        "graph_states": graph.num_states,
        "graph_arcs": graph.num_arcs,
        "budget_overflow_arcs": overflow,
        "frontier_occupancy_mean": round(occ_mean, 1),
        "frontier_occupancy_peak": occ_max,
        "corpus_wer_pct": round(corpus_wer, 2),  # WerStats.wer is %
        "workload": (f"{N_TEST}x{secs:.0f}s utterances sampled from the "
                     f"bench HCLG, two-tone synth audio (noise=0.25), "
                     f"TDNN trained on-chip ({TRAIN_STEPS} steps, frame "
                     f"acc {train_acc:.3f})"),
        "arc_candidate_visits_per_s": round(visits_per_s / 1e6, 1),
        "gather_roofline_Mrows_per_s": round(rg_rows_per_s / 1e6, 1),
        "achieved_row_gathers_Mrows_per_s": round(
            achieved_rows_per_s / 1e6, 1),
        "row_gather_roofline_note": (
            "roofline measured IN this run (random 16-lane rows from the "
            "packed arc table); achieved counts the operating point's "
            "srow+brow+hub row fetches per frame. The gap to roofline is "
            "the frame's non-gather work"),
        "am_tflops": round(am_tflops, 3),
        "lattice_decode_audio_per_s": lat,
        "lattice_arcs_emitted": n_lat_arcs,
        "lattice_empty_utts": sum(l is None for l in lats),
        "lattice_oracle_wer_pct": round(oracle_wer, 3),
        "selfbuilt_graph": selfbuilt,
        "rescore_const_arpa_audio_per_s": round(resc_audio_per_s, 2),
        "rescore_lm_ngrams": n_ngrams,
        "rescore_lattice_arcs": n_resc_arcs,
        "const_arpa_build_s": round(const_arpa_build_s, 1),
        "train_frames_per_s": round(train_fps, 0),
        "train_tflops": round(train_tflops, 2),
        "train_mfu_pct_bf16": (None if train_mfu is None
                               else round(100.0 * train_mfu, 1)),
        "train_mfu_note": (f"against {peak} TFLOP/s dense bf16" if peak
                           else f"no published bf16 peak for "
                                f"{dev0.device_kind!r}"),
        "train_step_ms": round(dt_step * 1e3, 2),
        "toy_graph_serving_audio_per_s": round(toy_audio_per_sec, 2),
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
