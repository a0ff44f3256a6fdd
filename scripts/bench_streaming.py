"""Streaming (online) decoding latency + RTF benchmark on one chip.

Drives the online2-wav-nnet2-latgen-faster analogue chunk by chunk over
synthetic utterances sampled from the decoding graph, and reports:

  online_rtf            total compute / total audio (OnlineTimingStats,
                        ref: online2/online-timing.h:41-83)
  chunk_latency_ms_p50/p95   wall time of one accept_waveform +
                        advance (160 ms audio chunks), fully synced
  max_delay_s           worst lag behind the real-time audio clock
  streamed==offline     the parity contract: chunked hypotheses equal
                        whole-utterance decoding of the same audio

Two paths are measured:
  * fused (headline): FusedOnlineDecoder — framing+fbank+TDNN+token
    passing as ONE jitted dispatch per chunk, device-resident state,
    on-device traceback (kaldi_tpu/online/fused.py);
  * generic: SingleUtteranceNnet2Decoder — the flexible host-driven
    pipeline (i-vectors, CMVN, endpointing) with per-stage device calls.

Prints one JSON line. Run it alone on the GPU: a second JAX process on
the same card would compete for its memory and its time.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    import jax.numpy as jnp
    from kaldi_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    from kaldi_tpu.ops import FbankOpts, FrameOpts, MelOpts, fbank
    from kaldi_tpu.nnet.tdnn import Tdnn, TdnnConfig
    from kaldi_tpu.nnet.am_nnet import AmNnet
    from kaldi_tpu.nnet.train import (NnetTrainOpts, make_optimizer,
                                      make_train_step)
    from kaldi_tpu.decoder.biggraph import make_big_hclg, BigGraphConfig
    from kaldi_tpu.decoder.simulate import make_corpus, fbank_targets
    from kaldi_tpu.decoder.beam_search import (BeamSearchDecoder,
                                               BeamSearchOpts)
    from kaldi_tpu.decoder.csr_beam import CsrBeamDecoder, CsrBeamOpts
    from kaldi_tpu.online.features import OnlineMfcc
    from kaldi_tpu.online.fused import FusedOnlineDecoder
    from kaldi_tpu.online.nnet2_decoding import (OnlineNnet2FeaturePipeline,
                                                 SingleUtteranceNnet2Decoder)
    from kaldi_tpu.online.timing import OnlineTimer, OnlineTimingStats

    SR = 16000.0
    CHUNK_S = 0.16                      # 160 ms audio chunks
    fb_opts = FbankOpts(frame_opts=FrameOpts(samp_freq=SR, dither=0.0),
                        mel_opts=MelOpts(num_bins=40))
    # small-vocab graph: the serving regime the online decoder targets
    graph, n_tids = make_big_hclg(BigGraphConfig(
        vocab=300, avg_bigram_succ=20, num_pdfs=64, seed=1))
    rng = np.random.default_rng(0)
    N_TRAIN, N_TEST, T = 12, 6, 600
    waves, segs, words = make_corpus(graph, N_TRAIN + N_TEST, T, rng,
                                     noise=0.25)

    @jax.jit
    def feats_of(w):
        return fbank(w, fb_opts)

    feats = np.asarray(feats_of(jnp.asarray(waves)))
    Tf = feats.shape[1]
    tgt = np.stack([fbank_targets(segs[n], Tf)
                    for n in range(N_TRAIN + N_TEST)])
    cfg = TdnnConfig(feat_dim=40, num_pdfs=64, hidden_dim=512,
                     pnorm_output_dim=128, nonlinearity="relu",
                     splice_indexes=((-2, -1, 0, 1, 2), (-1, 2), (0,)))
    model = Tdnn(cfg)
    params = model.init(jax.random.PRNGKey(0))
    lc, rc = cfg.left_context, cfg.right_context
    opts = NnetTrainOpts(initial_lr=0.1, final_lr=0.02)
    optimizer = make_optimizer(opts, 300)
    opt_state = optimizer.init(params)
    step = make_train_step(model, optimizer, compute_dtype=jnp.bfloat16)
    ft = jnp.asarray(feats[:N_TRAIN])
    tt = jnp.asarray(tgt[:N_TRAIN, lc: Tf - rc])
    wt = jnp.ones(tt.shape, jnp.float32)
    loss = acc = None
    for _ in range(300):
        params, opt_state, loss, acc = step(params, opt_state, ft, tt, wt)
    jax.block_until_ready(loss)
    am = AmNnet(model, params)
    am.set_priors_from_alignment_counts(
        np.bincount(tgt[:N_TRAIN].ravel(), minlength=64) + 1.0)

    class _TmShim:
        """Online decoder needs only id2pdf for trailing-silence checks."""
        id2pdf_array = graph.pdf
        num_pdfs = 64

        @staticmethod
        def transition_id_to_phone(tid):
            return 0

    base_dec = BeamSearchDecoder(graph, BeamSearchOpts(
        beam=13.0, max_active=512, acoustic_scale=0.1))
    # production engine for the fused path: degree-tiered expansion keeps
    # per-frame work O(visited arcs) (this graph's max out-degree is 300
    # but mean degree ~3: the padded [K, E_max] expand wastes ~100x)
    csr_dec = CsrBeamDecoder(graph, CsrBeamOpts(
        beam=13.0, max_active=512, acoustic_scale=0.1,
        expand_budget=8192, eps_budget=1024))

    # offline hypotheses (whole-utterance decode) for the parity check,
    # per engine (engines may tie-break differently)
    ll_off = am.loglikes_np(feats[N_TRAIN:])
    nf = np.full(N_TEST, Tf, np.int32)
    off = base_dec.decode(ll_off, nf)
    off_csr = csr_dec.decode(ll_off, nf)

    chunk = int(SR * CHUNK_S)

    # ---------------- fused path (headline) ----------------
    fused = FusedOnlineDecoder(am, csr_dec, fb_opts, chunk_samples=chunk,
                               t_max=1024, keep_loglikes=True)
    f_stats = OnlineTimingStats()
    f_lat = []
    f_mism = 0
    for pass_ in range(2):              # pass 0 = warmup/compile
        if pass_ == 1:
            f_stats = OnlineTimingStats()
            f_lat = []
        for u in range(N_TEST):
            wave = waves[N_TRAIN + u]
            fused.reset()
            timer = OnlineTimer(f"u{u}")
            pos = 0
            while pos < len(wave):
                t0 = time.perf_counter()
                fused.accept_waveform(wave[pos: pos + chunk])
                fused.sync()
                f_lat.append((time.perf_counter() - t0) * 1e3)
                pos += chunk
                timer.wait_until(min(pos, len(wave)) / SR)
            t0 = time.perf_counter()
            fused.input_finished()
            res = fused.best_path()
            fin_ms = (time.perf_counter() - t0) * 1e3
            timer.finish(f_stats)
            # online latgen: GetLattice at utterance end (== offline
            # latgen on the same log-likes, by construction); timed
            # separately so online_rtf stays the decode-path figure
            t0 = time.perf_counter()
            lat = fused.get_lattice(8.0)
            lat_ms = (time.perf_counter() - t0) * 1e3
            if res is None or list(res[0]) != list(off_csr[u][0]):
                f_mism += 1
            if lat is None:
                f_mism += 1
    fp50, fp95 = np.percentile(f_lat, [50, 95])

    # ---------------- batched serving (N lockstep streams) ----------------
    # streams sweep: step-time vs stream count finds the dispatch-
    # amortization knee; the capacity headline is the best N (each
    # lockstep step advances every stream by one 160 ms chunk, so N
    # streams are real-time iff step p95 < 160 ms).
    from kaldi_tpu.online.serving import FusedStreamingServer

    def serve_bench(n_streams):
        srv = FusedStreamingServer(am, csr_dec, fb_opts,
                                   n_streams=n_streams,
                                   chunk_samples=chunk, t_max=1024)
        mism = 0
        step_ms = []
        for pass_ in range(2):              # pass 0 = warmup/compile
            if pass_ == 1:
                step_ms = []
            slots = [srv.open() for _ in range(n_streams)]
            utts = [waves[N_TRAIN + (i % N_TEST)]
                    for i in range(n_streams)]
            pos = [0] * n_streams
            while any(p < len(w) for p, w in zip(pos, utts)):
                for i in range(n_streams):
                    if pos[i] < len(utts[i]):
                        srv.feed(slots[i], utts[i][pos[i]: pos[i] + chunk])
                        pos[i] += chunk
                    elif not srv._want_flush[slots[i]]:
                        srv.input_finished(slots[i])
                t0 = time.perf_counter()
                srv.step()
                srv.sync()
                step_ms.append((time.perf_counter() - t0) * 1e3)
            for i in range(n_streams):
                if not srv._want_flush[slots[i]]:
                    srv.input_finished(slots[i])
                srv.drain(slots[i])
                res = srv.best_path(slots[i])
                if res is None or \
                        list(res[0]) != list(off_csr[i % N_TEST][0]):
                    mism += 1
                srv.close(slots[i])
        p50, p95 = np.percentile(step_ms, [50, 95])
        return {
            "n_streams": n_streams,
            "step_ms_p50": round(float(p50), 2),
            "step_ms_p95": round(float(p95), 2),
            "aggregate_audio_per_s": round(
                n_streams * CHUNK_S / (np.mean(step_ms) / 1e3), 1),
            "realtime": bool(p95 < CHUNK_S * 1e3),
            "hyp_mismatches": mism,
        }

    streams_sweep = [serve_bench(n) for n in (16, 32, 64, 128)]
    rt = [row for row in streams_sweep if row["realtime"]
          and row["hyp_mismatches"] == 0]
    best = max(rt, key=lambda r: r["n_streams"]) if rt else \
        streams_sweep[0]
    N_STREAMS = best["n_streams"]
    sp50, sp95 = best["step_ms_p50"], best["step_ms_p95"]
    agg_audio_per_s = best["aggregate_audio_per_s"]
    s_mism = best["hyp_mismatches"]
    # capacity: largest swept N whose p95 step stays under the chunk
    # interval (plus the sub-interval headroom at that N)
    capacity = int(N_STREAMS * (CHUNK_S * 1e3) / max(sp95, 1e-9))

    # ---------------- generic path ----------------
    g_stats = OnlineTimingStats()
    g_lat = []
    g_mism = 0
    for pass_ in range(2):
        if pass_ == 1:
            g_stats = OnlineTimingStats()
            g_lat = []
        for u in range(min(N_TEST, 3)):
            wave = waves[N_TRAIN + u]
            fe = OnlineMfcc(fb_opts, computer=fbank)
            pipe = OnlineNnet2FeaturePipeline(fe)
            dec = SingleUtteranceNnet2Decoder(
                am, _TmShim, base_dec, pipe, chunk_frames=16)
            timer = OnlineTimer(f"u{u}")
            pos = 0
            while pos < len(wave):
                t0 = time.perf_counter()
                dec.pipeline.accept_waveform(wave[pos: pos + chunk])
                dec.advance_decoding()
                g_lat.append((time.perf_counter() - t0) * 1e3)
                pos += chunk
                timer.wait_until(min(pos, len(wave)) / SR)
            dec.finalize_decoding()
            timer.finish(g_stats)
            res = dec.best_path()
            if res is None or list(res[0]) != list(off[u][0]):
                g_mism += 1
    gp50, gp95 = np.percentile(g_lat, [50, 95])

    out = {
        "metric": ("online nnet2 streaming decode (OnlineFbank+TDNN+"
                   "beam search), 160ms chunks, 1 chip, fused "
                   "single-dispatch path"),
        "online_rtf": round(f_stats.real_time_factor, 4),
        "inv_rtf_streams_per_chip": round(
            1.0 / max(f_stats.real_time_factor, 1e-9), 1),
        "chunk_latency_ms_p50": round(float(fp50), 2),
        "chunk_latency_ms_p95": round(float(fp95), 2),
        "finalize_ms": round(fin_ms, 2),
        "get_lattice_ms": round(lat_ms, 2),
        "max_delay_s": round(f_stats.max_delay, 3),
        "audio_s": round(f_stats.total_audio, 1),
        "streamed_equals_offline": f_mism == 0,
        "hyp_mismatches": f_mism,
        "serving": {
            "n_streams_lockstep": N_STREAMS,
            "step_ms_p50": round(float(sp50), 2),
            "step_ms_p95": round(float(sp95), 2),
            "aggregate_audio_per_s": round(float(agg_audio_per_s), 1),
            "realtime_stream_capacity_per_chip": capacity,
            "streams_sweep": streams_sweep,
            "streamed_equals_offline": s_mism == 0,
            "hyp_mismatches": s_mism,
        },
        "generic_path": {
            "online_rtf": round(g_stats.real_time_factor, 4),
            "chunk_latency_ms_p50": round(float(gp50), 2),
            "chunk_latency_ms_p95": round(float(gp95), 2),
            "streamed_equals_offline": g_mism == 0,
        },
        "graph_states": graph.num_states,
        "graph_arcs": graph.num_arcs,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
