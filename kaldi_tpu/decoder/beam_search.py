"""Batched Viterbi beam search over HCLG as a tensor program.

The tensor-program replacement for FasterDecoder/LatticeFasterDecoder's token
passing (ref: decoder/lattice-faster-decoder.cc:660-750 ProcessEmitting,
ProcessNonemitting, GetCutoff :591): instead of a hash map of Tokens and
linked ForwardLinks, the frontier is a fixed-capacity (max-active) tensor
of (state, score, backpointer-slot); per frame we

  1. expand every arc of every frontier token with one gather
     (arcs are CSR-packed, emitting arcs first, padded to max out-degree),
  2. dedup by target state with a sort + segment-min (replacing
     FindOrAddToken's hash insert),
  3. prune to the beam and to max-active with top_k (the reference's
     adaptive GetCutoff),
  4. repeat 1-3 over epsilon arcs for the non-emitting closure,
  5. append (prev-slot, olabel) records to a preallocated backpointer arena
     (the tensor analogue of ForwardLinks).

B utterances decode as one jit program — the batched replacement for
gmm-latgen-faster-parallel's TaskSequencer (SURVEY.md §2.11).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp

from kaldi_tpu.decoder.graph_pack import PackedGraph

BIG = np.float32(1e10)


@dataclasses.dataclass(frozen=True)
class BeamSearchOpts:
    """(ref: decoder/faster-decoder.h:26-50 FasterDecoderOptions)"""

    beam: float = 16.0
    max_active: int = 512       # frontier capacity K (tokens kept per frame)
    # ProcessNonemitting rounds (static). None = infer the exact eps-chain
    # depth from the graph; construction FAILS if the eps subgraph is
    # cyclic or unboundedly deep (the reference iterates to a fixpoint —
    # a silently-truncated closure would decode incorrectly).
    eps_expansions: int | None = None
    acoustic_scale: float = 0.1


def _pad_csr(graph: PackedGraph):
    """Pack per-state arc lists into dense [S, E] tables, emitting-first.

    Vectorized scatter (no per-state Python loop — packing a
    multimillion-state HCLG is one-time but must not take minutes):
    arc a of state s lands at row s, column a - arc_start[s].
    """
    S = graph.num_states
    deg = np.diff(graph.arc_start)
    E = int(deg.max()) if S else 1
    A = len(graph.ilabel)
    rows = np.repeat(np.arange(S), deg)
    cols = np.arange(A) - np.repeat(graph.arc_start[:-1], deg)
    ilabel = np.zeros((S, E), np.int32)
    olabel = np.zeros((S, E), np.int32)
    cost = np.full((S, E), BIG, np.float32)
    nxt = np.zeros((S, E), np.int32)
    pdf = np.zeros((S, E), np.int32)
    ilabel[rows, cols] = graph.ilabel
    olabel[rows, cols] = graph.olabel
    cost[rows, cols] = graph.cost
    nxt[rows, cols] = graph.nextstate
    if graph.pdf is not None:
        pdf[rows, cols] = np.maximum(graph.pdf, 0)
    return dict(ilabel=ilabel, olabel=olabel, cost=cost, nxt=nxt, pdf=pdf,
                max_deg=E)


def _dedup_prune(states, scores, prevs, olabels, ilabels, K):
    """Keep the best-scoring token per state, then the best K overall.

    states/scores/prevs/olabels: [N] candidate arrays (N >= K).
    Dead candidates have score >= BIG/2. Returns [K] arrays.

    Two stable argsorts (by score, then by state) give groups ordered
    best-first; first-of-group + top_k then replace the reference's
    FindOrAddToken hash insert + GetCutoff pruning. (Measured faster than
    one multi-operand lax.sort carrying the payloads: gathers are cheaper
    than shuffling payload lanes through the sorting network.)
    """
    idx1 = jnp.argsort(scores, stable=True)
    idx = idx1[jnp.argsort(states[idx1], stable=True)]
    st_g = states[idx]
    sc_g = scores[idx]
    first = jnp.concatenate(
        [jnp.ones(1, bool), st_g[1:] != st_g[:-1]])
    sc_masked = jnp.where(first, sc_g, BIG)
    topv, topi = jax.lax.top_k(-sc_masked, K)
    sel = idx[topi]
    return (states[sel], jnp.minimum(-topv, BIG), prevs[sel], olabels[sel],
            ilabels[sel])


@functools.partial(jax.jit, static_argnames=("K", "E", "n_eps", "beam"))
def _decode_batch(
    ll,            # [B, T, P] scaled loglikes
    frame_mask,    # [B, T]
    tab_ilabel, tab_olabel, tab_cost, tab_nxt, tab_pdf,  # [S, E]
    final,         # [S]
    start: int, K: int, E: int, n_eps: int, beam: float,
):
    B, T, P = ll.shape

    def expand(tok_state, tok_score, frame_ll, emitting):
        """tok_* [K]; returns candidates [K*E]: state/score/prev-slot/olabel."""
        arcs_i = tab_ilabel[tok_state]     # [K, E]
        arcs_o = tab_olabel[tok_state]
        arcs_c = tab_cost[tok_state]
        arcs_n = tab_nxt[tok_state]
        arcs_p = tab_pdf[tok_state]
        if emitting:
            am = -frame_ll[arcs_p]         # [K, E]
            use = arcs_i > 0
        else:
            am = jnp.zeros_like(arcs_c)
            use = arcs_i == 0
        cand = tok_score[:, None] + arcs_c + am
        cand = jnp.where(use, cand, BIG)
        prev = jnp.broadcast_to(jnp.arange(K)[:, None], (K, E))
        return (arcs_n.reshape(-1), cand.reshape(-1),
                prev.reshape(-1), arcs_o.reshape(-1), arcs_i.reshape(-1))

    def beam_cut(scores):
        best = jnp.min(scores)
        return jnp.minimum(jnp.where(scores > best + beam, BIG, scores), BIG)

    def frame_step(carry, inputs):
        tok_state, tok_score = carry
        frame_ll, mask_t = inputs
        # --- ProcessEmitting ---
        cst, csc, cpv, col, cil = expand(tok_state, tok_score, frame_ll, True)
        csc = beam_cut(csc)
        st, sc, pv, ol, il = _dedup_prune(cst, csc, cpv, col, cil, K)
        records = [(st, sc, pv, ol, il)]
        # --- ProcessNonemitting rounds ---
        for _ in range(n_eps):
            est, esc, epv, eol, eil = expand(st, sc, frame_ll, False)
            # merge with current frontier (tokens keep themselves: prev=self,
            # olabel=0, so the backtrace can skip)
            mst = jnp.concatenate([st, est])
            msc = jnp.concatenate([sc, esc])
            mpv = jnp.concatenate([jnp.arange(K), epv])
            mol = jnp.concatenate([jnp.zeros(K, jnp.int32), eol])
            mil = jnp.concatenate([jnp.zeros(K, jnp.int32), eil])
            msc = beam_cut(msc)
            st, sc, pv, ol, il = _dedup_prune(mst, msc, mpv, mol, mil, K)
            records.append((st, sc, pv, ol, il))
        # masked (padded) frames: pass tokens through, record self-links
        out_state = jnp.where(mask_t, st, tok_state)
        out_score = jnp.where(mask_t, sc, tok_score)
        rec = tuple(
            (jnp.where(mask_t, r_st, tok_state),
             jnp.where(mask_t, r_sc, tok_score),
             jnp.where(mask_t, r_pv, jnp.arange(K)),
             jnp.where(mask_t, r_ol, 0),
             jnp.where(mask_t, r_il, 0))
            for (r_st, r_sc, r_pv, r_ol, r_il) in records
        )
        return (out_state, out_score), rec

    def decode_one(ll_b, mask_b):
        tok_state = jnp.zeros(K, jnp.int32)
        tok_score = jnp.full(K, BIG)
        tok_score = tok_score.at[0].set(0.0)
        tok_state = tok_state.at[0].set(start)
        # initial eps closure from the start state (one record per round)
        st, sc = tok_state, tok_score
        init_records = []
        for _ in range(n_eps):
            est, esc, epv, eol, eil = expand(st, sc, ll_b[0], False)
            mst = jnp.concatenate([st, est])
            msc = jnp.concatenate([sc, esc])
            mpv = jnp.concatenate([jnp.arange(K), epv])
            mol = jnp.concatenate([jnp.zeros(K, jnp.int32), eol])
            mil = jnp.concatenate([jnp.zeros(K, jnp.int32), eil])
            st, sc, pv, ol, il = _dedup_prune(mst, msc, mpv, mol, mil, K)
            init_records.append((st, sc, pv, ol, il))
        init_records = tuple(init_records)
        (fs, fsc), recs = jax.lax.scan(
            frame_step, (st, sc), (ll_b, mask_b))
        total = fsc + final[fs]
        best_final_slot = jnp.argmin(total)
        best_final_cost = total[best_final_slot]
        # fallback: best partial path when the beam pruned all final-state
        # tokens (ref: decoder-wrappers.cc "No final token found" path)
        best_any_slot = jnp.argmin(fsc)
        reached_final = best_final_cost < BIG * 0.5
        best_slot = jnp.where(reached_final, best_final_slot, best_any_slot)
        best_cost = jnp.where(reached_final, best_final_cost,
                              fsc[best_any_slot])
        return init_records, recs, fs, fsc, best_slot, best_cost

    return jax.vmap(decode_one)(ll, frame_mask)


@functools.partial(jax.jit, static_argnames=("K", "E", "n_eps", "beam"))
def _decode_batch_traced(
    ll, frame_mask,
    tab_ilabel, tab_olabel, tab_cost, tab_nxt, tab_pdf, final,
    start: int, K: int, E: int, n_eps: int, beam: float,
):
    """Decode + ON-DEVICE backtrace: returns per-frame (olabels, ilabels)
    [B, T, R] plus (best_cost) — avoids shipping the [B, T, K] record
    arena to the host (HBM→host is the bottleneck at batch scale; the
    traceback itself is a cheap reverse scan of gathers)."""
    init_recs, recs, fs, fsc, best_slot, best_cost = _decode_batch(
        ll, frame_mask, tab_ilabel, tab_olabel, tab_cost, tab_nxt, tab_pdf,
        final, start, K, E, n_eps, beam)
    R = 1 + n_eps
    B, T, P = ll.shape

    def trace_one(recs_b, mask_b, slot0):
        # recs_b: tuple over R rounds of (st, sc, pv, ol, il) each [T, K]
        def step(slot, inputs):
            t_mask, *per_round = inputs  # per_round: R x (pv, ol, il)
            ols = []
            ils = []
            for r in range(R - 1, -1, -1):
                pv, ol, il = per_round[r]
                ols.append(ol[slot])
                ils.append(il[slot])
                slot = pv[slot]
            return slot, (jnp.stack(ols[::-1]), jnp.stack(ils[::-1]))

        xs = (mask_b,) + tuple(
            (recs_b[r][2], recs_b[r][3], recs_b[r][4]) for r in range(R))
        s0, (ols, ils) = jax.lax.scan(step, slot0, xs, reverse=True)
        # s0 = slot entering frame 0 (used to trace the init closure)
        return ols, ils, s0  # [T, R], [T, R], []

    ols, ils, slot0 = jax.vmap(trace_one)(recs, frame_mask, best_slot)

    # continue the trace through the initial eps-closure records
    def trace_init(init_b, s0):
        ols0 = []
        for r in range(len(init_recs) - 1, -1, -1):
            _st, _sc, pv, ol, _il = init_b[r]
            ols0.append(ol[s0])
            s0 = pv[s0]
        if not ols0:
            return jnp.zeros((0,), jnp.int32)
        return jnp.stack(ols0[::-1])

    init_ols = jax.vmap(trace_init)(init_recs, slot0) if n_eps > 0 \
        else jnp.zeros((B, 0), jnp.int32)
    return ols, ils, init_ols, best_cost


def eps_chain_depth(graph: PackedGraph, cap: int = 8) -> int | None:
    """Longest eps-arc chain in the graph (None if the eps subgraph has a
    cycle or is deeper than cap). Lets decoders run exactly as many
    non-emitting closure rounds as the graph needs — the reference's
    ProcessNonemitting iterates to a fixpoint; here the fixpoint count is
    static per graph. (Delegates to the vectorized graph_pack.eps_depth.)"""
    from kaldi_tpu.decoder.graph_pack import eps_depth
    return eps_depth(graph, cap)


def resolve_eps_rounds(graph: PackedGraph, requested: int | None) -> int:
    """Static non-emitting-closure round count for a graph.

    The exact eps-chain depth wins when it is boundable; a cyclic or
    >8-deep eps subgraph with no explicit override raises — the reference
    runs ProcessNonemitting to a fixpoint, so silently keeping a default
    round count would decode such graphs incorrectly
    (ref: decoder/lattice-faster-decoder.cc ProcessNonemitting)."""
    depth = eps_chain_depth(graph)
    if depth is not None:
        return depth
    if requested is None:
        raise ValueError(
            "graph has cyclic (or >8-deep) epsilon chains: a static "
            "closure-round count cannot be inferred. Remove eps cycles "
            "(determinize/rmepsilon the graph) or set eps_expansions "
            "explicitly to accept truncated closure.")
    return requested


class BeamSearchDecoder:
    """Host wrapper: pack the graph once, decode utterance batches."""

    def __init__(self, graph: PackedGraph, opts: BeamSearchOpts = BeamSearchOpts()):
        assert graph.pdf is not None, (
            "PackedGraph has no tid->pdf mapping: pack_graph() must be "
            "given tid_to_pdf for decoding (otherwise every arc would "
            "silently score pdf 0)")
        self.graph = graph
        opts = dataclasses.replace(
            opts, eps_expansions=resolve_eps_rounds(graph, opts.eps_expansions))
        self.opts = opts
        tabs = _pad_csr(graph)
        self.E = tabs["max_deg"]
        self._tabs = {k: jnp.asarray(v) for k, v in tabs.items()
                      if k not in ("max_deg",)}
        self._final = jnp.asarray(np.where(np.isfinite(graph.final),
                                           graph.final, BIG))
        from kaldi_tpu.decoder.graph_pack import split_csr
        self.csr = split_csr(graph)   # host CSR for lattice extraction

    def decode_raw(self, loglikes: np.ndarray, num_frames: np.ndarray):
        """Run the jit decode and return per-round frontier snapshots as
        the dict consumed by lat.generate.raw_lattice_from_decode."""
        o = self.opts
        B, T, P = loglikes.shape
        from kaldi_tpu.decoder.dense import _device_mask
        mask = _device_mask(np.asarray(num_frames), T)
        ll_scaled = loglikes * o.acoustic_scale
        out = _decode_batch(
            jnp.asarray(ll_scaled), mask,
            self._tabs["ilabel"], self._tabs["olabel"], self._tabs["cost"],
            self._tabs["nxt"], self._tabs["pdf"], self._final,
            int(self.graph.start), int(o.max_active), int(self.E),
            int(o.eps_expansions), float(o.beam),
        )
        from kaldi_tpu.decoder.hostpack import fetch_tree
        init_recs, recs, fs, fsc, best_slot, best_cost = fetch_tree(out)
        # stack per-round (st, sc) tuples -> [B, R0/T*R, K] snapshots
        if init_recs:
            ist = np.stack([r[0] for r in init_recs], axis=1)
            isc = np.stack([r[1] for r in init_recs], axis=1)
        else:
            K = fs.shape[-1]
            ist = np.zeros((B, 0, K), np.int32)
            isc = np.zeros((B, 0, K), np.float32)
        fst = np.stack([r[0] for r in recs], axis=2)    # [B, T, R, K]
        fsc_r = np.stack([r[1] for r in recs], axis=2)
        return dict(
            init_states=ist, init_scores=isc,
            states=fst, scores=fsc_r,
            final_states=fs, final_scores=fsc,
            best_slot=best_slot, best_cost=best_cost,
            ll_scaled=np.asarray(ll_scaled))

    def decode_async(self, loglikes, num_frames: np.ndarray):
        """Dispatch the decode program; -> finisher callable producing the
        per-utterance (words, tids, total_cost) list (one device->host
        transfer at finish time, so a serving loop can overlap batches).

        loglikes [B, T, P] unscaled (np or jnp — device arrays stay on
        device).

        The backtrace runs on-device (_decode_batch_traced); only [B, T, R]
        label sequences cross to the host — at max_active=512 that is
        ~500x less HBM→host traffic than shipping the record arena.
        """
        o = self.opts
        B, T, P = loglikes.shape
        from kaldi_tpu.decoder.dense import _device_mask
        mask = _device_mask(np.asarray(num_frames), T)
        ll = jnp.asarray(loglikes) * o.acoustic_scale
        ols, ils, init_ols, best_cost = _decode_batch_traced(
            ll, mask,
            self._tabs["ilabel"], self._tabs["olabel"], self._tabs["cost"],
            self._tabs["nxt"], self._tabs["pdf"], self._final,
            int(self.graph.start), int(o.max_active), int(self.E),
            int(o.eps_expansions), float(o.beam),
        )
        from kaldi_tpu.decoder.hostpack import pack4, unpack4
        from kaldi_tpu.decoder.dense import _parse_label_seqs
        # [B, T, R] label sequences + costs packed for ONE device->host
        # transfer at finish() time
        packed, shapes = pack4(ols, ils, init_ols, best_cost)
        nf = np.asarray(num_frames)

        def finish():
            o_, i_, n_, c_ = unpack4(np.asarray(packed), shapes)
            return _parse_label_seqs(o_, i_, n_, c_, nf)

        return finish

    def decode(self, loglikes, num_frames: np.ndarray):
        return self.decode_async(loglikes, num_frames)()
