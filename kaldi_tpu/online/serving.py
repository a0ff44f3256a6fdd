"""Batched streaming ASR serving: N concurrent streams, one dispatch.

(ref: the reference serves concurrent live streams with one decoder
 process per stream — online2bin/online2-tcp-nnet3-decode-faster.cc,
 onlinebin/online-server-gmm-decode-faster.cc. An accelerator inverts
 that economics: the device is fast and the dispatch round trip is the cost, so
 the server advances ALL active streams in lockstep with ONE fused XLA
 program per chunk interval — framing, fbank, TDNN scoring and
 degree-tiered token passing batched over streams, per-stream state
 (sample ring, feature ring, frontier, backpointer arena) resident on
 device. Per-stream control (ramp-up, flush, slot reuse) rides traced
 scalar vectors, so one compiled program serves every stream phase.)

Parity: each stream's hypothesis equals offline whole-utterance decoding
(same contract and mechanics as kaldi_tpu/online/fused.py; the batched
search rounds are csr_beam._make_rounds with B = n_streams).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from kaldi_tpu.decoder.csr_beam import CsrBeamDecoder, _make_rounds, BIG
from kaldi_tpu.ops.features import fbank, FbankOpts
from kaldi_tpu.ops.window import num_frames


class FusedStreamingServer:
    """Slot-based streaming server over one device-resident batch.

    Usage:
        srv = FusedStreamingServer(am, dec, fb_opts, n_streams=16)
        s = srv.open()                  # -> slot id (None if full)
        srv.feed(s, samples)            # stage audio (any size)
        srv.input_finished(s)           # end of utterance
        srv.step()                      # ONE dispatch: advance all slots
                                        #   with a chunk staged or flushing
        if srv.finished(s):
            words, tids, cost = srv.best_path(s)
            srv.close(s)
    """

    def __init__(self, am, dec: CsrBeamDecoder, feat_opts: FbankOpts,
                 n_streams: int = 8, chunk_samples: int = 2560,
                 t_max: int = 1024, computer=fbank,
                 keep_loglikes: bool = False, mesh=None,
                 mesh_axis: str = "data"):
        """mesh: an optional jax.sharding.Mesh — the stream axis is
        sharded over `mesh_axis`, so one lockstep serving batch spans
        the mesh's chips (GSPMD partitions the per-stream feature/AM
        front-end and the batched token passing; the graph tables are
        replicated). n_streams must divide evenly by the axis size."""
        assert isinstance(dec, CsrBeamDecoder)
        self._keep_ll = bool(keep_loglikes)
        self._mesh = mesh
        self._mesh_axis = mesh_axis
        if mesh is not None:
            assert n_streams % mesh.shape[mesh_axis] == 0
        fo = feat_opts.frame_opts
        assert fo.snip_edges and fo.dither == 0.0
        assert getattr(am, "group_ids", None) is None
        self.shift = fo.window_shift
        self.wsize = fo.window_size
        assert chunk_samples % self.shift == 0
        self.am = am
        self.dec = dec
        self.feat_opts = feat_opts
        self.computer = computer
        self.N = n_streams
        self.C = chunk_samples
        self.F = chunk_samples // self.shift
        self.lead = -(-(self.wsize - self.shift) // self.shift)
        self.BUF = self.C + self.lead * self.shift
        model = am.model
        self.lc = model.config.left_context
        self.rc = model.config.right_context
        self.ndmax = self.F + self.rc
        self.M = self.F + self.lc + self.rc
        self.Mw = self.ndmax + self.lc + self.rc
        self.t_max = t_max
        o = dec.opts
        self.K = int(o.max_active)
        self.R = 1 + int(o.eps_expansions)
        self._kbits = max((self.K - 1).bit_length(), 1)
        self._kmask = np.int32((1 << self._kbits) - 1)
        self._log_prior = jnp.asarray(
            np.log(np.maximum(np.asarray(am.priors), 1e-20)), jnp.float32)
        self._feat_dim = model.config.feat_dim
        self._final_np = np.asarray(dec.tabs.final)
        self._build()
        self._init_frontier()
        self._reset_all()

    # ------------------------------------------------------------ device

    def _build(self):
        dec = self.dec
        o = dec.opts
        N, K = self.N, self.K
        n_eps = int(o.eps_expansions)
        beam = float(o.beam)
        ascale = float(o.acoustic_scale)
        CB, CZ = int(o.expand_budget), int(o.eps_budget)
        C, F, M, Mw, lc = self.C, self.F, self.M, self.Mw, self.lc
        ndmax, R, t_max = self.ndmax, self.R, self.t_max
        kbits, kmask = self._kbits, int(self._kmask)
        t = dec.tabs
        model = self.am.model
        computer, feat_opts = self.computer, self.feat_opts

        def rounds():
            return _make_rounds(
                t.srow, t.zrow, t.brow, t.zbrow, dec._hub_state_arr,
                t.hub_rows, t.hub_cost, t.hub_onehot, t.hub_gpdf,
                t.hub_pdf, t.hub_bounds, N, K, CB, CZ, beam,
                b_apr=t.b_apr)

        self_prev = jnp.broadcast_to(jnp.arange(K, dtype=jnp.int32)[None],
                                     (N, K))

        def feat_one(buf, fifo, nhist, chunk, active, nf, v0, d0, total,
                     params, log_prior):
            """Single-stream feature/AM front-end (vmapped over slots)."""
            shifted = jnp.concatenate([buf, chunk])[C:]
            buf = jnp.where(active, shifted, buf)
            fr = computer(buf, feat_opts)                  # [F, D]
            rolled = jnp.roll(fr, -v0, axis=0)
            cat = jnp.concatenate([fifo, rolled])
            fifo = jax.lax.dynamic_slice_in_dim(cat, nf, M, axis=0)
            nhist = jnp.minimum(nhist + nf, M)
            gidx = d0 - lc + jnp.arange(Mw)
            fidx = jnp.clip(gidx - total + M, M - nhist, M - 1)
            window = fifo[fidx]
            log_post = model.apply(params, window, pad_context=False)
            ll_raw = log_post - log_prior                  # [ndmax, P]
            return buf, fifo, nhist, ll_raw * ascale, ll_raw

        def frame_step(carry, inputs):
            st0, sc0 = carry                   # [N, K]
            ll_t, mask_t = inputs              # [N, P], [N]
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
                [jnp.where(m, r, self_prev) for r in recs], axis=1)
            il_blob = jnp.where(m, il, 0)                  # [N, K]
            return (out_st, out_sc), (rec_blob, il_blob)   # [N, R, K]

        keep_ll = self._keep_ll

        def step(carry, chunks, active, reset, nf, v0, nd, d0, total,
                 init_st, init_sc, params, log_prior):
            buf, fifo, nhist, st, sc, arena, ilar, llar = carry
            # slot reuse: re-initialize reset slots in-device
            rm = reset[:, None]
            buf = jnp.where(rm, 0.0, buf)
            fifo = jnp.where(reset[:, None, None], 0.0, fifo)
            nhist = jnp.where(reset, 0, nhist)
            st = jnp.where(rm, init_st[None, :], st)
            sc = jnp.where(rm, init_sc[None, :], sc)
            buf, fifo, nhist, ll, ll_raw = jax.vmap(
                feat_one, in_axes=(0, 0, 0, 0, 0, 0, 0, 0, 0, None, None)
            )(buf, fifo, nhist, chunks, active, nf, v0, d0, total,
              params, log_prior)
            # lockstep token passing: stream n decodes its j-th new frame
            # at scan step j; mask gates slots whose nd is smaller
            mask = jnp.arange(ndmax)[:, None] < nd[None, :]   # [ndmax, N]
            (st, sc), (recs, ils) = jax.lax.scan(
                frame_step, (st, sc),
                (jnp.moveaxis(ll, 0, 1), mask))
            # recs [ndmax, N, R, K] -> arena writes at per-slot d0
            arena = jax.vmap(
                lambda a, r, d: jax.lax.dynamic_update_slice_in_dim(
                    a, r, d, axis=0)
            )(arena, jnp.moveaxis(recs, 0, 1), d0)
            ilar = jax.vmap(
                lambda a, r, d: jax.lax.dynamic_update_slice_in_dim(
                    a, r, d, axis=0)
            )(ilar, jnp.moveaxis(ils, 0, 1), d0)
            if keep_ll:
                llar = jax.vmap(
                    lambda a, r, d: jax.lax.dynamic_update_slice_in_dim(
                        a, r, d, axis=0))(llar, ll_raw, d0)
            return (buf, fifo, nhist, st, sc, arena, ilar, llar)

        self._step = jax.jit(step, donate_argnums=(0,))

        final = t.final

        def traceback_one(carry, n, total, use_final):
            _b, _f, _n, st, sc, arena, ilar = carry[:7]
            st0, sc0 = st[n], sc[n]
            aren, iln = arena[n], ilar[n]
            costs = sc0 + final[st0]
            has_final = jnp.min(costs) < BIG / 2
            use_f = jnp.logical_and(use_final, has_final)
            slot0 = jnp.where(use_f, jnp.argmin(costs), jnp.argmin(sc0))
            cost0 = jnp.where(use_f, jnp.min(costs), jnp.min(sc0))
            alive = jnp.min(sc0) < BIG / 2

            def tstep(slot, tt):
                active = tt < total
                ols = [None] * R
                s = slot
                for r in range(R - 1, 0, -1):
                    pr = aren[tt, r, s]
                    ols[r] = jnp.where(active, pr >> kbits, 0)
                    s = jnp.where(active, pr & kmask, s)
                il = jnp.where(active, iln[tt, s], 0)
                pr = aren[tt, 0, s]
                ols[0] = jnp.where(active, pr >> kbits, 0)
                s = jnp.where(active, pr & kmask, s)
                return s, (jnp.stack(ols), il)

            slot_end, (ols, ils) = jax.lax.scan(
                tstep, slot0, jnp.arange(t_max), reverse=True)
            return jnp.concatenate([
                ols.reshape(-1), ils.reshape(-1),
                slot_end.reshape(1),
                jnp.asarray(cost0, jnp.float32).reshape(1).view(jnp.int32),
                alive.astype(jnp.int32).reshape(1)])

        self._traceback = jax.jit(traceback_one)

        def closure(st, sc):
            emit_round, eps_round = _make_rounds(
                t.srow, t.zrow, t.brow, t.zbrow, dec._hub_state_arr,
                t.hub_rows, t.hub_cost, t.hub_onehot, t.hub_gpdf,
                t.hub_pdf, t.hub_bounds, 1, K, CB, CZ, beam,
                b_apr=t.b_apr)
            recs = []
            for _ in range(n_eps):
                st, sc, rec, _il, _o = eps_round(st, sc)
                recs.append(rec[0])
            return st, sc, recs

        self._closure = jax.jit(closure)

    def _init_frontier(self):
        K = self.K
        st = np.zeros((1, K), np.int32)
        sc = np.full((1, K), BIG, np.float32)
        st[0, 0] = int(self.dec.csr.start)
        sc[0, 0] = 0.0
        cst, csc, recs = self._closure(jnp.asarray(st), jnp.asarray(sc))
        self._init_st_np = np.asarray(cst)[0]
        self._init_sc_np = np.asarray(csc)[0]
        self._init_records = [
            (np.asarray(r) & self._kmask, np.asarray(r) >> self._kbits)
            for r in recs]

    # ------------------------------------------------------------- slots

    def _reset_all(self):
        N, D = self.N, self._feat_dim
        carry = (
            jnp.zeros((N, self.BUF), jnp.float32),
            jnp.zeros((N, self.M, D), jnp.float32),
            jnp.zeros(N, jnp.int32),
            jnp.tile(self._init_st_np[None], (N, 1)),
            jnp.tile(self._init_sc_np[None], (N, 1)),
            # padded by ndmax rows: per-slot writes are fixed ndmax-row
            # blocks at d0 and dynamic_update_slice clamps — without the
            # pad a near-capacity stream's tail records get shifted over
            # earlier frames (and idle in-use slots, which write identity
            # records at their d0 every dispatch, would clobber a finished
            # near-capacity stream's tail). Pad rows are never read.
            jnp.zeros((N, self.t_max + self.ndmax, self.R, self.K),
                      jnp.int32),
            jnp.zeros((N, self.t_max + self.ndmax, self.K), jnp.int32),
            jnp.zeros((N, (self.t_max + self.ndmax) if self._keep_ll
                       else 1, self.am.num_pdfs), jnp.float32),
        )
        if self._mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            carry = tuple(
                jax.device_put(c, NamedSharding(
                    self._mesh,
                    P(self._mesh_axis, *([None] * (c.ndim - 1)))))
                for c in carry)
        self._carry = carry
        self._free = list(range(N))
        self._stage = [np.zeros(0, np.float32) for _ in range(N)]
        self._samples = np.zeros(N, np.int64)
        self._chunks = np.zeros(N, np.int64)
        self._frames = np.zeros(N, np.int64)
        self._decoded = np.zeros(N, np.int64)
        self._want_flush = np.zeros(N, bool)
        self._flushed = np.zeros(N, bool)
        self._pending_reset = np.zeros(N, bool)
        self._in_use = np.zeros(N, bool)

    def open(self) -> int | None:
        """Claim a stream slot (None if the batch is full)."""
        if not self._free:
            return None
        s = self._free.pop()
        self._in_use[s] = True
        self._pending_reset[s] = True
        self._stage[s] = np.zeros(0, np.float32)
        self._samples[s] = self._chunks[s] = 0
        self._frames[s] = self._decoded[s] = 0
        self._want_flush[s] = self._flushed[s] = False
        return s

    def feed(self, s: int, wave: np.ndarray):
        assert self._in_use[s] and not self._want_flush[s]
        self._stage[s] = np.concatenate(
            [self._stage[s], np.asarray(wave, np.float32)])
        self._samples[s] += len(wave)

    def input_finished(self, s: int):
        assert self._in_use[s]
        self._want_flush[s] = True

    def finished(self, s: int) -> bool:
        return bool(self._flushed[s])

    def close(self, s: int):
        assert self._in_use[s]
        self._in_use[s] = False
        self._free.append(s)

    def pending(self, s: int) -> int:
        """Staged samples not yet dispatched."""
        return len(self._stage[s])

    # -------------------------------------------------------------- step

    def step(self) -> list[int]:
        """Advance every slot that has a full chunk staged (or is
        flushing) by one chunk — ONE device dispatch. Returns the list
        of advanced slots; call repeatedly to drain multi-chunk stages."""
        N, C = self.N, self.C
        chunks = np.zeros((N, C), np.float32)
        active = np.zeros(N, bool)
        nf = np.zeros(N, np.int32)
        v0 = np.zeros(N, np.int32)
        nd = np.zeros(N, np.int32)
        d0 = np.zeros(N, np.int32)
        total = np.zeros(N, np.int32)
        advanced = []
        fo = self.feat_opts.frame_opts
        for s in range(N):
            if not self._in_use[s]:
                continue
            flush = self._want_flush[s] and not self._flushed[s]
            if len(self._stage[s]) >= C:
                chunks[s] = self._stage[s][:C]
                self._stage[s] = self._stage[s][C:]
            elif flush and len(self._stage[s]) < C:
                chunks[s, :len(self._stage[s])] = self._stage[s]
                self._stage[s] = np.zeros(0, np.float32)
                self._flushed[s] = True
            else:
                total[s] = self._frames[s]
                d0[s] = self._decoded[s]
                continue
            active[s] = True
            fed = (self._chunks[s] + 1) * C
            tot = num_frames(int(min(self._samples[s], fed)), fo)
            nf[s] = tot - self._frames[s]
            v0[s] = self._frames[s] - (fed - self.BUF) // self.shift
            if self._flushed[s]:
                nd_end = tot
            else:
                nd_end = max(self._decoded[s], tot - self.rc)
            nd[s] = nd_end - self._decoded[s]
            d0[s] = self._decoded[s]
            total[s] = tot
            assert nd_end <= self.t_max
            self._chunks[s] += 1
            self._frames[s] = tot
            self._decoded[s] = nd_end
            advanced.append(s)
        if not advanced:
            return []
        reset = self._pending_reset.copy()
        self._pending_reset[:] = False
        self._carry = self._step(
            self._carry, jnp.asarray(chunks), jnp.asarray(active),
            jnp.asarray(reset), jnp.asarray(nf), jnp.asarray(v0),
            jnp.asarray(nd), jnp.asarray(d0), jnp.asarray(total),
            jnp.asarray(self._init_st_np), jnp.asarray(self._init_sc_np),
            self.am.params, self._log_prior)
        return advanced

    def drain(self, s: int):
        """Step until slot s has consumed its stage (incl. flush)."""
        while (len(self._stage[s]) >= self.C or
               (self._want_flush[s] and not self._flushed[s])):
            self.step()

    def sync(self):
        jax.block_until_ready(self._carry[4])

    # ------------------------------------------------------------ results

    def best_path(self, s: int, use_final_probs: bool = True):
        flat = np.asarray(self._traceback(
            self._carry, jnp.asarray(s, jnp.int32),
            jnp.asarray(int(self._decoded[s]), jnp.int32),
            jnp.asarray(use_final_probs)))
        n_ol = self.t_max * self.R
        ols = flat[:n_ol].reshape(self.t_max, self.R)
        ils = flat[n_ol:n_ol + self.t_max]
        slot_end = int(flat[n_ol + self.t_max])
        cost = float(flat[n_ol + self.t_max + 1:n_ol + self.t_max + 2]
                     .view(np.float32)[0])
        alive = bool(flat[n_ol + self.t_max + 2])
        if not alive:
            return None
        t_used = int(self._decoded[s])
        words = [int(o) for o in ols[:t_used].reshape(-1) if o != 0]
        tids = [int(i) for i in ils[:t_used] if i != 0]
        init_words = []
        slot = slot_end
        for (pv, ol) in reversed(self._init_records):
            o = int(ol.reshape(-1)[slot])
            if o != 0:
                init_words.append(o)
            slot = int(pv.reshape(-1)[slot])
        return init_words[::-1] + words, tids, cost

    def get_lattice(self, s: int, lattice_beam: float = 8.0):
        """Raw lattice for stream s (== offline latgen on the same
        log-likes; see FusedOnlineDecoder.get_lattice). Requires
        keep_loglikes=True."""
        assert self._keep_ll, "construct with keep_loglikes=True"
        from kaldi_tpu.lat.generate import decode_to_lattices
        n = int(self._decoded[s])
        if n == 0:
            return None
        ll = np.asarray(self._carry[-1][s, :n])
        return decode_to_lattices(
            self.dec, ll[None], np.array([n], np.int32),
            lattice_beam)[0]
