"""Single-dispatch fused streaming decoder: one XLA program per chunk.

(ref: online2/online-nnet2-decoding.h:67 SingleUtteranceNnet2Decoder and
 the driving binary online2bin/online2-wav-nnet2-latgen-faster.cc.)

The reference advances feature extraction, nnet evaluation and token
passing as three separate per-chunk C++ loops over host memory. Here the
whole chunk — sample buffering, framing+fbank, TDNN scoring with carried
temporal context, beam-search token passing, and backpointer recording —
is ONE jitted program whose state (sample buffer, feature ring, token
frontier, backpointer arena) lives on the device across chunks. A 160 ms
chunk therefore costs a single dispatch with ZERO device->host transfer;
nothing crosses the link until traceback (partial or final), which runs
on-device (reverse scan of gathers) and ships only the label sequence.
Per-chunk wall time is one dispatch, not one round trip per pipeline
stage.

Two search engines plug into the same fused front-end:
  * CsrBeamDecoder (production): the degree-tiered expansion
    (csr_beam._make_rounds) — per-frame work O(visited arcs);
  * BeamSearchDecoder: the padded [S, E] expansion — fine for small
    max-out-degree graphs, O(K * E_max) per frame otherwise.

Numerical parity with offline decoding is preserved by construction:
  * frames depend only on their own sample window (snip-edges), so
    chunk-relative framing at the same absolute sample offsets is exact;
  * the TDNN scores each frame with `left_context` frames of true
    history, and frames within `right_context` of the stream head are
    delayed until their future context exists; edge clamping happens
    only at the true stream edges (matching apply(pad_context=True));
  * the per-frame token-passing program is the same expand/dedup/prune
    code the offline batch decoder jits, including the on-device initial
    epsilon closure (computed once per graph, reused per utterance).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from kaldi_tpu.decoder.beam_search import (BeamSearchDecoder, _dedup_prune,
                                           BIG)
from kaldi_tpu.decoder.csr_beam import CsrBeamDecoder, _make_rounds
from kaldi_tpu.ops.features import fbank, FbankOpts
from kaldi_tpu.ops.window import num_frames


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


class FusedOnlineDecoder:
    """Streaming wave -> words with device-resident state.

    Parameters
    ----------
    am : AmNnet              acoustic model (priors folded on device)
    dec : CsrBeamDecoder | BeamSearchDecoder   packed graph + search opts
    feat_opts : FbankOpts    frame/mel options (dither must be 0 and
                             snip_edges True for exact offline parity)
    chunk_samples : int      dispatch granularity; multiple of the frame
                             shift (e.g. 2560 = 160 ms at 16 kHz)
    t_max : int              backpointer-arena capacity in frames
    computer                 feature fn(wave, opts) -> [T, D] (fbank)
    """

    def __init__(self, am, dec, feat_opts: FbankOpts,
                 chunk_samples: int = 2560, t_max: int = 2048,
                 computer=fbank, keep_loglikes: bool = False):
        fo = feat_opts.frame_opts
        assert fo.snip_edges, "fused streaming assumes snip-edges framing"
        assert fo.dither == 0.0, (
            "dither makes chunked features stochastic; disable it for the "
            "streamed==offline parity contract")
        self.shift = fo.window_shift
        self.wsize = fo.window_size
        assert chunk_samples % self.shift == 0
        assert getattr(am, "group_ids", None) is None, (
            "mixed-up AMs (group-summed posteriors) not supported on the "
            "fused path; use SingleUtteranceNnet2Decoder")
        self.am = am
        self.dec = dec
        self.feat_opts = feat_opts
        self.computer = computer
        self.C = chunk_samples
        self.F = chunk_samples // self.shift
        self.lead = _ceil_div(self.wsize - self.shift, self.shift)
        self.BUF = self.C + self.lead * self.shift
        model = am.model
        self.lc = model.config.left_context
        self.rc = model.config.right_context
        self.ndmax = self.F + self.rc
        self.M = self.F + self.lc + self.rc           # feature ring frames
        self.Mw = self.ndmax + self.lc + self.rc      # scoring window
        self.t_max = t_max
        # keep_loglikes: store each decoded frame's (unscaled) pseudo
        # log-likes in a device arena so get_lattice() can run the full
        # record decode at finalize — the online-latgen role of
        # online2bin/online2-wav-nnet2-latgen-faster (the reference also
        # materializes the lattice at EndpointDetected/utterance end)
        self._keep_ll = bool(keep_loglikes)
        o = dec.opts
        self.K = int(o.max_active)
        self.R = 1 + int(o.eps_expansions)
        self._is_csr = isinstance(dec, CsrBeamDecoder)
        self._log_prior = jnp.asarray(
            np.log(np.maximum(np.asarray(am.priors), 1e-20)), jnp.float32)
        self._feat_dim = model.config.feat_dim
        if self._is_csr:
            self._final_np = np.asarray(dec.tabs.final)
            self._kbits = max((self.K - 1).bit_length(), 1)
            self._kmask = np.int32((1 << self._kbits) - 1)
            self._build_csr()
        else:
            self._final_np = np.asarray(dec._final)
            self._build_padded()
        self._init_closure()
        self.reset()

    # ---------------------------------------------------- shared front-end

    def _make_feat_am(self):
        """Sample ring -> fbank -> feature ring -> TDNN window scoring;
        returns scaled pseudo-loglikes for the chunk's decode block."""
        C, F, M, Mw, lc = self.C, self.F, self.M, self.Mw, self.lc
        model = self.am.model
        computer, feat_opts = self.computer, self.feat_opts
        ascale = float(self.dec.opts.acoustic_scale)

        def feat_am(buf, fifo, nhist, chunk, nf, v0, d0, total, params,
                    log_prior):
            # 1. sample ring: newest C samples enter on the right
            buf = jnp.concatenate([buf, chunk])[C:]
            # 2. framing + fbank over the ring (frame grid stays aligned
            #    to absolute sample offsets because BUF % shift == 0)
            fr = computer(buf, feat_opts)                  # [F, D]
            rolled = jnp.roll(fr, -v0, axis=0)             # valid at front
            cat = jnp.concatenate([fifo, rolled])
            fifo = jax.lax.dynamic_slice_in_dim(cat, nf, M, axis=0)
            nhist = jnp.minimum(nhist + nf, M)
            # 3. AM scoring window: frames [d0-lc, d0+ndmax-1+rc] gathered
            #    from the ring with edge clamping (== pad_context at the
            #    true stream edges, exact history elsewhere)
            gidx = d0 - lc + jnp.arange(Mw)
            fidx = jnp.clip(gidx - total + M, M - nhist, M - 1)
            window = fifo[fidx]
            log_post = model.apply(params, window, pad_context=False)
            ll_raw = log_post - log_prior                  # [ndmax, P]
            return buf, fifo, nhist, ll_raw * ascale, ll_raw

        return feat_am

    # ----------------------------------------------------- padded engine

    def _build_padded(self):
        o = self.dec.opts
        K, E = self.K, self.dec.E
        n_eps = int(o.eps_expansions)
        beam = float(o.beam)
        ndmax, R, t_max = self.ndmax, self.R, self.t_max
        tabs = self.dec._tabs
        feat_am = self._make_feat_am()

        def expand(st, sc, frame_ll, emitting):
            arcs_i = tabs["ilabel"][st]
            arcs_o = tabs["olabel"][st]
            arcs_c = tabs["cost"][st]
            arcs_n = tabs["nxt"][st]
            arcs_p = tabs["pdf"][st]
            if emitting:
                amc = -frame_ll[arcs_p]
                use = arcs_i > 0
            else:
                amc = jnp.zeros_like(arcs_c)
                use = arcs_i == 0
            cand = jnp.where(use, sc[:, None] + arcs_c + amc, BIG)
            prev = jnp.broadcast_to(jnp.arange(K)[:, None], (K, E))
            return (arcs_n.reshape(-1), cand.reshape(-1), prev.reshape(-1),
                    arcs_o.reshape(-1), arcs_i.reshape(-1))

        def beam_cut(scores):
            best = jnp.min(scores)
            return jnp.minimum(
                jnp.where(scores > best + beam, BIG, scores), BIG)

        def frame_step(carry, inputs):
            st0, sc0 = carry
            frame_ll, mask_t = inputs
            est, esc, epv, eol, eil = expand(st0, sc0, frame_ll, True)
            esc = beam_cut(esc)
            st, sc, pv, ol, il = _dedup_prune(est, esc, epv, eol, eil, K)
            records = [(pv, ol, il)]
            for _ in range(n_eps):
                est, esc, epv, eol, eil = expand(st, sc, frame_ll, False)
                mst = jnp.concatenate([st, est])
                msc = beam_cut(jnp.concatenate([sc, esc]))
                mpv = jnp.concatenate([jnp.arange(K), epv])
                mol = jnp.concatenate([jnp.zeros(K, jnp.int32), eol])
                mil = jnp.concatenate([jnp.zeros(K, jnp.int32), eil])
                st, sc, pv, ol, il = _dedup_prune(mst, msc, mpv, mol,
                                                  mil, K)
                records.append((pv, ol, il))
            out_st = jnp.where(mask_t, st, st0)
            out_sc = jnp.where(mask_t, sc, sc0)
            ident = jnp.arange(K)
            zero = jnp.zeros(K, jnp.int32)
            rec = jnp.stack([
                jnp.stack([jnp.where(mask_t, r_pv, ident),
                           jnp.where(mask_t, r_ol, zero),
                           jnp.where(mask_t, r_il, zero)])
                for (r_pv, r_ol, r_il) in records])        # [R, 3, K]
            return (out_st, out_sc), rec

        keep_ll = self._keep_ll

        def step(carry, chunk, nf, v0, nd, d0, total, params, log_prior):
            buf, fifo, nhist, st, sc, arena, llar = carry
            buf, fifo, nhist, ll, ll_raw = feat_am(
                buf, fifo, nhist, chunk, nf, v0, d0, total, params,
                log_prior)
            mask = jnp.arange(ndmax) < nd
            (st, sc), recs = jax.lax.scan(frame_step, (st, sc), (ll, mask))
            arena = jax.lax.dynamic_update_slice_in_dim(
                arena, recs, d0, axis=0)                   # [t_max,R,3,K]
            if keep_ll:
                llar = jax.lax.dynamic_update_slice_in_dim(
                    llar, ll_raw, d0, axis=0)
            return (buf, fifo, nhist, st, sc, arena, llar)

        self._step = jax.jit(step, donate_argnums=(0,))

        final = self.dec._final

        def traceback(carry, total, use_final):
            """On-device reverse walk; ships [t_max, R] labels, not the
            arena (ref: lattice-faster-online-decoder.h BestPathIterator)."""
            _b, _f, _n, st, sc, arena = carry[:6]
            costs = sc + final[st]
            has_final = jnp.min(costs) < BIG / 2
            use_f = jnp.logical_and(use_final, has_final)
            slot0 = jnp.where(use_f, jnp.argmin(costs), jnp.argmin(sc))
            cost0 = jnp.where(use_f, jnp.min(costs), jnp.min(sc))
            alive = jnp.min(sc) < BIG / 2

            def tstep(slot, t):
                active = t < total
                ols, ils = [], []
                for r in range(R - 1, -1, -1):
                    ols.append(jnp.where(active, arena[t, r, 1, slot], 0))
                    ils.append(jnp.where(active, arena[t, r, 2, slot], 0))
                    slot = jnp.where(active, arena[t, r, 0, slot], slot)
                return slot, (jnp.stack(ols[::-1]), jnp.stack(ils[::-1]))

            slot_end, (ols, ils) = jax.lax.scan(
                tstep, slot0, jnp.arange(t_max), reverse=True)
            flat = jnp.concatenate([
                ols.reshape(-1), ils.reshape(-1),
                slot_end.reshape(1),
                jnp.asarray(cost0, jnp.float32).reshape(1).view(jnp.int32),
                alive.astype(jnp.int32).reshape(1)])
            return flat

        self._traceback = jax.jit(traceback)
        self._ils_cols = R

        def closure(st, sc):
            recs = []
            dummy_ll = jnp.zeros((1,), jnp.float32)
            for _ in range(n_eps):
                est, esc, epv, eol, eil = expand(st, sc, dummy_ll, False)
                mst = jnp.concatenate([st, est])
                msc = jnp.concatenate([sc, esc])
                mpv = jnp.concatenate([jnp.arange(K), epv])
                mol = jnp.concatenate([jnp.zeros(K, jnp.int32), eol])
                mil = jnp.concatenate([jnp.zeros(K, jnp.int32), eil])
                st, sc, pv, ol, il = _dedup_prune(mst, msc, mpv, mol,
                                                  mil, K)
                recs.append((pv, ol))
            return st, sc, recs

        self._closure = jax.jit(closure)

    def _arena_init(self):
        # arenas are padded by ndmax rows: step() writes a fixed
        # ndmax-row block at d0, and dynamic_update_slice CLAMPS the start
        # index — without the pad, a final chunk with d0 > t_max - ndmax
        # would silently shift its writes over earlier frames' records.
        # Rows [t_max, t_max+ndmax) are scratch; no reader indexes them.
        P = self.am.num_pdfs
        tm = self.t_max + self.ndmax
        llar = jnp.zeros((tm if self._keep_ll else 1, P), jnp.float32)
        if self._is_csr:
            return (jnp.zeros((tm, self.R, self.K), jnp.int32),
                    jnp.zeros((tm, self.K), jnp.int32), llar)
        return (jnp.zeros((tm, self.R, 3, self.K), jnp.int32),
                llar)

    # -------------------------------------------------------- csr engine

    def _build_csr(self):
        dec = self.dec
        o = dec.opts
        K = self.K
        n_eps = int(o.eps_expansions)
        beam = float(o.beam)
        CB, CZ = int(o.expand_budget), int(o.eps_budget)
        ndmax, R, t_max = self.ndmax, self.R, self.t_max
        kbits, kmask = self._kbits, int(self._kmask)
        t = dec.tabs
        feat_am = self._make_feat_am()

        def rounds():
            return _make_rounds(
                t.srow, t.zrow, t.brow, t.zbrow, dec._hub_state_arr,
                t.hub_rows, t.hub_cost, t.hub_onehot, t.hub_gpdf,
                t.hub_pdf, t.hub_bounds, 1, K, CB, CZ, beam,
                b_apr=t.b_apr)

        self_prev = jnp.broadcast_to(jnp.arange(K, dtype=jnp.int32)[None],
                                     (1, K))

        def frame_step(carry, inputs):
            st0, sc0 = carry                   # [1, K]
            ll_t, mask_t = inputs              # [1, P], [1]
            emit_round, eps_round = rounds()
            st, sc, rec, il, _ovf = emit_round(st0, sc0, ll_t)
            recs = [rec]
            for _ in range(n_eps):
                st, sc, rec, _il, _o = eps_round(st, sc)
                recs.append(rec)
            m = mask_t[:, None]
            out_st = jnp.where(m, st, st0)
            out_sc = jnp.where(m, sc, sc0)
            rec_blob = jnp.stack(
                [jnp.where(m, r, self_prev)[0] for r in recs])  # [R, K]
            il_blob = jnp.where(m, il, 0)[0]                    # [K]
            return (out_st, out_sc), (rec_blob, il_blob)

        keep_ll = self._keep_ll

        def step(carry, chunk, nf, v0, nd, d0, total, params, log_prior):
            buf, fifo, nhist, st, sc, arena, ilar, llar = carry
            buf, fifo, nhist, ll, ll_raw = feat_am(
                buf, fifo, nhist, chunk, nf, v0, d0, total, params,
                log_prior)
            mask = jnp.arange(ndmax) < nd
            (st, sc), (recs, ils) = jax.lax.scan(
                frame_step, (st, sc), (ll[:, None, :], mask[:, None]))
            arena = jax.lax.dynamic_update_slice_in_dim(
                arena, recs, d0, axis=0)                  # [t_max, R, K]
            ilar = jax.lax.dynamic_update_slice_in_dim(
                ilar, ils, d0, axis=0)                    # [t_max, K]
            if keep_ll:
                llar = jax.lax.dynamic_update_slice_in_dim(
                    llar, ll_raw, d0, axis=0)
            return (buf, fifo, nhist, st, sc, arena, ilar, llar)

        self._step = jax.jit(step, donate_argnums=(0,))

        final = t.final

        def traceback(carry, total, use_final):
            _b, _f, _n, st, sc, arena, ilar = carry[:7]
            st0, sc0 = st[0], sc[0]
            costs = sc0 + final[st0]
            has_final = jnp.min(costs) < BIG / 2
            use_f = jnp.logical_and(use_final, has_final)
            slot0 = jnp.where(use_f, jnp.argmin(costs), jnp.argmin(sc0))
            cost0 = jnp.where(use_f, jnp.min(costs), jnp.min(sc0))
            alive = jnp.min(sc0) < BIG / 2

            def tstep(slot, t):
                # unwind eps rounds first; the transition id is read at
                # the EMITTING-round slot (matching _csr_decode_traced)
                active = t < total
                ols = [None] * R
                s = slot
                for r in range(R - 1, 0, -1):
                    pr = arena[t, r, s]
                    ols[r] = jnp.where(active, pr >> kbits, 0)
                    s = jnp.where(active, pr & kmask, s)
                il = jnp.where(active, ilar[t, s], 0)
                pr = arena[t, 0, s]
                ols[0] = jnp.where(active, pr >> kbits, 0)
                s = jnp.where(active, pr & kmask, s)
                s = jnp.where(active, s, slot)
                return s, (jnp.stack(ols), il)

            slot_end, (ols, ils) = jax.lax.scan(
                tstep, slot0, jnp.arange(t_max), reverse=True)
            flat = jnp.concatenate([
                ols.reshape(-1), ils.reshape(-1),
                slot_end.reshape(1),
                jnp.asarray(cost0, jnp.float32).reshape(1).view(jnp.int32),
                alive.astype(jnp.int32).reshape(1)])
            return flat

        self._traceback = jax.jit(traceback)
        self._ils_cols = 1

        def closure(st, sc):
            _emit, eps_round = rounds()
            recs = []
            for _ in range(n_eps):
                st, sc, rec, _il, _o = eps_round(st, sc)
                recs.append(rec[0])
            return st, sc, recs

        self._closure = jax.jit(closure)

    # ------------------------------------------------------ init closure

    def _init_closure(self):
        """Initial eps closure from the start state — graph-constant, so
        run once on device (same expand/dedup program as offline decode)
        and reuse for every utterance."""
        K = self.K
        if self._is_csr:
            start = int(self.dec.csr.start)
            st = np.zeros((1, K), np.int32)
            sc = np.full((1, K), BIG, np.float32)
            st[0, 0] = start
            sc[0, 0] = 0.0
        else:
            st = np.zeros(K, np.int32)
            sc = np.full(K, BIG, np.float32)
            st[0] = self.dec.graph.start
            sc[0] = 0.0
        cst, csc, recs = self._closure(jnp.asarray(st), jnp.asarray(sc))
        # host copies: the per-step carry is donated, so each reset() must
        # materialize FRESH device arrays for the initial frontier
        self._init_st_np = np.asarray(cst)
        self._init_sc_np = np.asarray(csc)
        if self._is_csr:
            self._init_records = [
                (np.asarray(r) & self._kmask,
                 np.asarray(r) >> self._kbits) for r in recs]
        else:
            self._init_records = [(np.asarray(pv), np.asarray(ol))
                                  for (pv, ol) in recs]

    # ------------------------------------------------------------- stream

    def reset(self):
        D = self._feat_dim
        self._carry = (
            jnp.zeros(self.BUF, jnp.float32),
            jnp.zeros((self.M, D), jnp.float32),
            jnp.asarray(0, jnp.int32),
            jnp.asarray(self._init_st_np),
            jnp.asarray(self._init_sc_np),
        ) + self._arena_init()
        self._staging = np.zeros(0, np.float32)
        self._samples = 0          # true samples accepted
        self._chunks = 0           # C-sized chunks dispatched
        self._frames = 0           # feature frames pushed to the ring
        self._decoded = 0          # frames consumed by the search
        self._finished = False

    @property
    def num_frames_decoded(self) -> int:
        return self._decoded

    def _dispatch(self, chunk: np.ndarray, flush: bool):
        fed = (self._chunks + 1) * self.C
        # frames computable from samples ON the device after this chunk
        # (accept_waveform may stage more than one chunk's worth)
        total_now = num_frames(min(self._samples, fed),
                               self.feat_opts.frame_opts)
        nf = total_now - self._frames
        # ring-slot of the first new frame (slot grid is fed-sample based)
        v0 = self._frames - (fed - self.BUF) // self.shift
        nd_end = total_now if flush else max(self._decoded,
                                             total_now - self.rc)
        nd = nd_end - self._decoded
        assert 0 <= nd <= self.ndmax and 0 <= v0 <= self.lead
        assert nd_end <= self.t_max, (
            f"utterance exceeds arena capacity t_max={self.t_max}")
        self._carry = self._step(
            self._carry, jnp.asarray(chunk, jnp.float32),
            jnp.asarray(nf, jnp.int32), jnp.asarray(v0, jnp.int32),
            jnp.asarray(nd, jnp.int32),
            jnp.asarray(self._decoded, jnp.int32),
            jnp.asarray(total_now, jnp.int32),
            self.am.params, self._log_prior)
        self._chunks += 1
        self._frames = total_now
        self._decoded = nd_end

    def accept_waveform(self, wave: np.ndarray):
        assert not self._finished
        self._staging = np.concatenate(
            [self._staging, np.asarray(wave, np.float32)])
        self._samples += len(wave)
        while len(self._staging) >= self.C:
            self._dispatch(self._staging[:self.C], flush=False)
            self._staging = self._staging[self.C:]

    def input_finished(self):
        """Flush: pad the remainder to one chunk (frames never cover the
        padding — num_frames() of the TRUE sample count gates them) and
        decode through the final frame with right-edge clamping."""
        assert not self._finished
        self._finished = True
        pad = np.zeros(self.C - len(self._staging), np.float32)
        self._dispatch(np.concatenate([self._staging, pad]), flush=True)
        self._staging = np.zeros(0, np.float32)

    def sync(self):
        """Block until all dispatched chunks have executed (for latency
        measurement; the dispatches themselves are async)."""
        jax.block_until_ready(self._carry[4])

    # ------------------------------------------------------------ results

    def best_path(self, use_final_probs: bool = True):
        """-> (words, tids, cost) or None; partial result when called
        before input_finished() (ref: lattice-faster-online-decoder.h
        BestPathIterator / GetBestPath)."""
        flat = np.asarray(self._traceback(
            self._carry, jnp.asarray(self._decoded, jnp.int32),
            jnp.asarray(use_final_probs)))
        n_ol = self.t_max * self.R
        n_il = self.t_max * self._ils_cols
        ols = flat[:n_ol].reshape(self.t_max, self.R)
        ils = flat[n_ol:n_ol + n_il].reshape(self.t_max, self._ils_cols)
        slot_end = int(flat[n_ol + n_il])
        cost = float(flat[n_ol + n_il + 1:n_ol + n_il + 2]
                     .view(np.float32)[0])
        alive = bool(flat[n_ol + n_il + 2])
        if not alive:
            return None
        t_used = self._decoded
        words = [int(o) for o in ols[:t_used].reshape(-1) if o != 0]
        tids = [int(i) for i in ils[:t_used].reshape(-1) if i != 0]
        # init-closure tail (eps arcs out of the start state)
        init_words = []
        slot = slot_end
        for (pv, ol) in reversed(self._init_records):
            o = int(ol.reshape(-1)[slot])
            if o != 0:
                init_words.append(o)
            slot = int(pv.reshape(-1)[slot])
        return init_words[::-1] + words, tids, cost

    def final_relative_cost(self) -> float:
        """(ref: lattice-faster-online-decoder FinalRelativeCost; feeds
        the endpointing rules)."""
        sc = np.asarray(self._carry[4]).reshape(-1)
        st = np.asarray(self._carry[3]).reshape(-1)
        best = sc.min()
        if best >= BIG / 2:
            return float("inf")
        return float((sc + self._final_np[st]).min() - best)

    def trailing_silence_frames(self, silence_phones: set,
                                trans_model) -> int:
        """Consecutive final frames whose best-path phone is silence
        (ref: online2/online-endpoint.h TrailingSilenceLength). Costs one
        partial traceback dispatch."""
        res = self.best_path(use_final_probs=False)
        if res is None:
            return 0
        _w, tids, _c = res
        count = 0
        for tid in reversed(tids):
            if trans_model.transition_id_to_phone(tid) in silence_phones:
                count += 1
            else:
                break
        return count

    def endpoint_detected(self, config, silence_phones: set, trans_model,
                          frame_shift: float = 0.01) -> bool:
        """(ref: online2/online-endpoint.cc EndpointDetected over the
        fused decoder's partial state.)"""
        from kaldi_tpu.online.endpoint import endpoint_detected
        trailing = self.trailing_silence_frames(silence_phones,
                                                trans_model)
        return endpoint_detected(config, frame_shift, self._decoded,
                                 trailing, self.final_relative_cost())

    def get_lattice(self, lattice_beam: float = 8.0):
        """Raw lattice for the utterance so far (the reference's online
        GetLattice, ref: online2/online-nnet2-decoding.h:96): fetch the
        stored per-frame log-likes (ONE transfer) and run the offline
        full-record decode + extraction on them. Because the stored
        log-likes are bit-identical to offline AM scoring (the parity
        contract), the lattice is exactly the offline latgen lattice.
        Requires keep_loglikes=True."""
        assert self._keep_ll, "construct with keep_loglikes=True"
        from kaldi_tpu.lat.generate import decode_to_lattices
        n = self._decoded
        if n == 0:
            return None
        ll = np.asarray(self._carry[-1][:n])
        return decode_to_lattices(
            self.dec, ll[None], np.array([n], np.int32),
            lattice_beam)[0]
