"""Frontier-sharded beam search over a device mesh.

SURVEY.md §2.11's big-graph prescription: when one utterance's decode must
scale past a chip (giant HCLG, low-latency single stream), the token
frontier itself shards over devices — each device expands its K/D slice
of the frontier through its (replicated) tier tables, candidate sets are
exchanged with `all_gather` across devices, and dedup+selection runs
replicated so every device holds the identical next frontier. The
reference's analogue is nothing: its decoder is single-threaded per
utterance (decoder/lattice-faster-decoder.cc); utterance-level sharding
(parallel/mesh.decode_sharded) covers its job-array parallelism, and
this module covers the scaling axis the reference does not have.

Built on shard_map so the collective is explicit (all_gather on the
named axis); numerics match CsrBeamDecoder exactly — asserted by
tests/test_decode_sharded.py on the 8-virtual-device CPU mesh.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from kaldi_tpu.decoder.csr_beam import (BIG, _bits_to_f32,
                                        _segment_map, CsrBeamDecoder)


def _make_fs_decode(dec: CsrBeamDecoder, mesh: Mesh, axis: str,
                    T: int):
    """Build the shard_map'd single-utterance decode for a fixed T."""
    o = dec.opts
    t = dec.tabs
    K = o.max_active
    D = mesh.shape[axis]
    assert K % D == 0, (K, D)
    Kl = K // D
    CB = max(o.expand_budget // D, Kl)
    CZ = max(o.eps_budget // D, Kl)
    n_eps = o.eps_expansions
    beam = float(o.beam)
    start = int(dec.csr.start)
    kbits = max((K - 1).bit_length(), 1)
    H = len(t.hub_bounds) - 1
    AH = t.hub_rows.shape[0]
    hub_state_arr = dec._hub_state_arr
    hub_bounds = t.hub_bounds

    def dedup_topk(cst, csc, crec, cil):
        # sort-based FindOrAddToken, mirroring csr_beam._dedup_topk:
        # sort by (state, score, candidate index), run heads win,
        # masked top_k; non-key fields ride as passengers
        C = cst.shape[0]
        j = jnp.arange(C, dtype=jnp.int32)
        ss, ssc, _sj, srec, sil = jax.lax.sort((cst, csc, j, crec, cil),
                                               dimension=0, num_keys=3)
        first = jnp.concatenate([jnp.ones((1,), bool), ss[1:] != ss[:-1]])
        sel = jnp.where(first, ssc, BIG)
        negv, kidx = jax.lax.top_k(-sel, K)
        return (ss[kidx], jnp.minimum(-negv, BIG), srec[kidx], sil[kidx])

    def local_slice(x):
        lo = jax.lax.axis_index(axis) * Kl
        return jax.lax.dynamic_slice_in_dim(x, lo, Kl)

    def emit_round(tok_state, tok_score, ll_t):
        # --- sharded expansion: this device's K/D token slice only
        ts, sc = local_slice(tok_state), local_slice(tok_score)
        lo = jax.lax.axis_index(axis) * Kl
        row = t.srow[ts]                                  # [Kl, 16]
        cands = []
        for j in (0, 1):
            base = 5 * j
            cost = _bits_to_f32(row[:, base + 0])
            am = -ll_t[row[:, base + 2]]
            csc = jnp.where(cost < BIG * 0.5, sc + cost + am, BIG)
            cands.append((row[:, base + 1], csc,
                          (lo + jnp.arange(Kl, dtype=jnp.int32))
                          | (row[:, base + 4] << kbits),
                          row[:, base + 3]))
        # tier B (row-budgeted packed arc rows, triple or quad layout —
        # see csr_beam.TierTables) on the local slice
        apr = t.b_apr
        deg = jnp.where(sc < BIG * 0.5, row[:, 11], 0)
        rows_n = (deg + (apr - 1)) // apr
        roff = jnp.cumsum(rows_n) - rows_n
        CBR = -(-CB // apr)
        tj, rj, valid, _ovr = _segment_map(
            roff[None, :], rows_n[None, :], CBR, Kl, 1,
            base=row[None, :, 10])
        tj, rj, valid = tj[0], rj[0], valid[0]
        rj = jnp.where(valid, rj, 0)
        arcr = t.brow[rj]                     # [CBR, 16]
        base_b = jnp.where(valid, sc[tj], BIG)
        for k in range(apr):
            if apr == 4:
                base = 4 * k
                pdf = arcr[:, base + 2] & 0xFFFF
                tid = (arcr[:, base + 2] >> 16) & 0xFFFF
                ol = arcr[:, base + 3]
            else:
                base = 5 * k
                pdf = arcr[:, base + 2]
                tid = arcr[:, base + 3]
                ol = arcr[:, base + 4]
            cost = _bits_to_f32(arcr[:, base])
            am = -ll_t[pdf]
            csc = jnp.where(cost < BIG * 0.5, base_b + cost + am, BIG)
            cands.append((arcr[:, base + 1], csc,
                          (lo + tj) | (ol << kbits), tid))
        kept_rows = jnp.clip(CBR - roff, 0, rows_n)
        ovf_b = jnp.sum(deg - jnp.minimum(deg, apr * kept_rows),
                        keepdims=True)
        # hubs: scoring is replicated over the FULL frontier (cheap dense
        # work); each device emits its rank slice [d*Kl, (d+1)*Kl) of the
        # global hub top-K, so the all_gathered union equals the
        # unsharded decoder's hub candidates exactly
        if H:
            match = (tok_state[:, None] == hub_state_arr[None, :]) & \
                (tok_score[:, None] < BIG * 0.5)          # [K, H]
            msc = jnp.where(match, tok_score[:, None], BIG)
            hub_sc = jnp.min(msc, axis=0)
            hub_slot = jnp.argmin(msc, axis=0).astype(jnp.int32)
            base_sc = jnp.zeros(AH, jnp.float32)
            slot_flat = jnp.zeros(AH, jnp.int32)
            for h in range(H):
                a, b = hub_bounds[h], hub_bounds[h + 1]
                base_sc = base_sc.at[a:b].set(hub_sc[h])
                slot_flat = slot_flat.at[a:b].set(hub_slot[h])
            if t.hub_onehot is not None:
                am_flat = jnp.matmul(t.hub_onehot, -ll_t[t.hub_gpdf],
                                     precision=jax.lax.Precision.HIGHEST)
            else:
                am_flat = -ll_t[t.hub_pdf]
            sc_flat = base_sc + t.hub_cost + am_flat
            negv, idx = jax.lax.top_k(-sc_flat, K)
            negv = jax.lax.dynamic_slice_in_dim(negv, lo, Kl)
            idx = jax.lax.dynamic_slice_in_dim(idx, lo, Kl)
            rows = t.hub_rows[idx]
            cands.append((rows[:, 1], jnp.minimum(-negv, BIG),
                          slot_flat[idx] | (rows[:, 4] << kbits),
                          rows[:, 3]))
        cl = [jnp.concatenate([c[i] for c in cands]) for i in range(4)]
        # --- frontier exchange: ALL devices' candidates (all_gather)
        cl = [jax.lax.all_gather(x, axis, tiled=True) for x in cl]
        cst, csc, crec, cil = cl
        best = jnp.min(csc)
        csc = jnp.where(csc > best + beam, BIG, csc)
        out = dedup_topk(cst, csc, crec, cil)
        return out + (ovf_b[0],)

    def eps_round(tok_state, tok_score):
        ts, sc = local_slice(tok_state), local_slice(tok_score)
        lo = jax.lax.axis_index(axis) * Kl
        row = t.zrow[ts]
        cands = [(ts, sc, lo + jnp.arange(Kl, dtype=jnp.int32),
                  jnp.zeros(Kl, jnp.int32))]
        for j in (0, 1):
            base = 3 * j
            cost = _bits_to_f32(row[:, base + 0])
            csc = jnp.where(cost < BIG * 0.5, sc + cost, BIG)
            cands.append((row[:, base + 1], csc,
                          (lo + jnp.arange(Kl, dtype=jnp.int32))
                          | (row[:, base + 2] << kbits),
                          jnp.zeros(Kl, jnp.int32)))
        ovf = jnp.int32(0)
        if t.zbrow.shape[0] > 1:    # tier-B eps (eps fan-out > 2)
            deg = jnp.where(sc < BIG * 0.5, row[:, 7], 0)
            coff = jnp.cumsum(deg) - deg
            tj, aj, valid, ovf_z = _segment_map(
                coff[None, :], deg[None, :], CZ, Kl, 1,
                base=row[None, :, 6])
            tj, aj, valid = tj[0], aj[0], valid[0]
            aj = jnp.where(valid, aj, 0)
            arc = t.zbrow[aj]
            cost = _bits_to_f32(arc[:, 0])
            csc = jnp.where(valid, sc[tj] + cost, BIG)
            cands.append((arc[:, 1], csc, (lo + tj) | (arc[:, 2] << kbits),
                          jnp.zeros_like(tj)))
            ovf = ovf + ovf_z[0]
        cl = [jnp.concatenate([c[i] for c in cands]) for i in range(4)]
        cl = [jax.lax.all_gather(x, axis, tiled=True) for x in cl]
        cst, csc, crec, cil = cl
        best = jnp.min(csc)
        csc = jnp.where(csc > best + beam, BIG, csc)
        out = dedup_topk(cst, csc, crec, cil)
        return out + (ovf,)

    def decode(ll, mask):
        """ll [T, P], mask [T] — runs identically on every device except
        for the sharded expansion; outputs are replicated."""
        tok_state = jnp.zeros(K, jnp.int32).at[0].set(start)
        tok_score = jnp.full(K, BIG).at[0].set(0.0)
        init_recs = []
        st, sc = tok_state, tok_score
        ovf0 = jnp.int32(0)
        for _ in range(n_eps):
            st, sc, rec, _il, ovf_z = eps_round(st, sc)
            ovf0 = ovf0 + ovf_z
            init_recs.append(rec)
        init_recs = (jnp.stack(init_recs) if init_recs
                     else jnp.zeros((0, K), jnp.int32))
        self_rec = jnp.arange(K, dtype=jnp.int32)

        def frame_step(carry, inputs):
            st, sc, ovf = carry
            ll_t, m = inputs
            nst, nsc, rec, il, ovf_e = emit_round(st, sc, ll_t)
            ovf_f = ovf_e
            recs = [rec]
            il_emit = il
            for _ in range(n_eps):
                nst, nsc, rec, _il, ovf_z = eps_round(nst, nsc)
                ovf_f = ovf_f + ovf_z
                recs.append(rec)
            out_st = jnp.where(m, nst, st)
            out_sc = jnp.where(m, nsc, sc)
            recs = jnp.stack([jnp.where(m, r, self_rec) for r in recs])
            ovf = ovf + jnp.where(m, ovf_f, 0)
            return (out_st, out_sc, ovf), \
                (recs, jnp.where(m, il_emit, 0))

        (fs, fsc, ovf), (recs, il_emit) = jax.lax.scan(
            frame_step, (st, sc, ovf0), (ll, mask))
        # overflow counts are per-device (each expands its own slice):
        # sum over the axis so every device reports the global count
        ovf = jax.lax.psum(ovf, axis)
        total = fsc + t.final[fs]
        bslot = jnp.argmin(total)
        bcost = total[bslot]
        aslot = jnp.argmin(fsc)
        ok = bcost < BIG * 0.5
        bslot = jnp.where(ok, bslot, aslot)
        bcost = jnp.where(ok, bcost, fsc[aslot])
        return init_recs, recs, il_emit, bslot, bcost, ovf

    fs_decode = jax.shard_map(
        decode, mesh=mesh,
        in_specs=(P(), P()), out_specs=(P(), P(), P(), P(), P(), P()),
        check_vma=False)
    return jax.jit(fs_decode), kbits


def decode_frontier_sharded(dec: CsrBeamDecoder, loglikes, num_frames,
                            mesh: Mesh, axis: str = "model"):
    """Single-stream decode with the frontier sharded over `axis`.

    -> list of per-utterance (words, tids, total_cost) like
    CsrBeamDecoder.decode (utterances run sequentially: this mode targets
    one giant-graph stream; batch throughput uses decode_sharded)."""
    B, T, P_ = loglikes.shape
    fs_decode, kbits = _make_fs_decode(dec, mesh, axis, T)
    kmask = (1 << kbits) - 1
    nf = np.asarray(num_frames)
    out = []
    overflow = np.zeros(B, np.int64)
    for b in range(B):
        ll = jnp.asarray(loglikes[b]) * dec.opts.acoustic_scale
        mask = jnp.asarray(np.arange(T) < nf[b])
        init_recs, recs, il_emit, bslot, bcost, ovf = jax.tree.map(
            np.asarray, fs_decode(ll, mask))
        overflow[b] = int(np.asarray(ovf).reshape(-1)[0])
        if bcost >= BIG * 0.5:
            out.append(None)
            continue
        # host traceback (records are replicated and small at test scale)
        words_rev, tids_rev = [], []
        s = int(bslot)
        R = recs.shape[1]
        for ti in range(T - 1, -1, -1):
            for r in range(R - 1, -1, -1):
                if r == 0:
                    il = int(il_emit[ti, s])
                    if il:
                        tids_rev.append(il)
                pr = int(recs[ti, r, s])
                olab = pr >> kbits
                if olab:
                    words_rev.append(olab)
                s = pr & kmask
        for r in range(init_recs.shape[0] - 1, -1, -1):
            pr = int(init_recs[r, s])
            if pr >> kbits:
                words_rev.append(pr >> kbits)
            s = pr & kmask
        out.append((words_rev[::-1], tids_rev[::-1], float(bcost)))
    dec.last_overflow = overflow
    return out
