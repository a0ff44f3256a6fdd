"""Dense Viterbi decoding over the FULL state space — the fast path for
small/medium HCLG graphs.

(ref: decoder/faster-decoder.h:61 FasterDecoder — best-path decoding
 without lattices. Token passing prunes because 2015 CPUs couldn't touch
 every state; on an accelerator, when S·B fits in device memory the
 dense recurrence

     alpha[t+1, dst] = min over arcs (alpha[t, src] + w + am[pdf])

 is a handful of fused gathers/scatter-mins per frame with NO sorts, far
 cheaper than the beam machinery. The beam decoder (beam_search.py)
 remains the path for large graphs and for lattice generation; the
 `make_decoder` factory picks by state count — the same split as the
 reference's FasterDecoder vs LatticeFasterDecoder.)
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp

from kaldi_tpu.decoder.graph_pack import PackedGraph

BIG = np.float32(1e10)


def _incoming_tables(dst: np.ndarray, A: int, S: int, cap: int = 64):
    """Static incoming-arc tables for gather-based min relaxation.

    Scatters serialize on destination conflicts; gathers run at memory
    bandwidth. Arcs are grouped by destination ONCE (host side): a
    [S, cap] table of incoming arc ids for normal states, plus a small
    hub table [H, E_hub] for high-in-degree states (e.g. the HCLG loop
    state, where thousands of word arcs converge — padding every state
    to that width would blow up memory). Dummy slot = A.
    -> (t1 [S, cap] int32, hub_states [H] int32, t2 [H, E_hub] int32).
    """
    if A == 0:
        return (np.full((S, 1), A, np.int32), np.zeros(0, np.int32),
                np.full((0, 1), A, np.int32))
    order = np.argsort(dst, kind="stable").astype(np.int32)
    indeg = np.bincount(dst, minlength=S)
    start = np.concatenate([[0], np.cumsum(indeg)])
    cap = int(min(cap, max(indeg.max(), 1)))
    hub = indeg > cap
    hub_states = np.where(hub)[0].astype(np.int32)
    t1 = np.full((S, cap), A, np.int32)
    sorted_dst = dst[order]
    cols = np.arange(A) - start[sorted_dst]
    lo = ~hub[sorted_dst]
    t1[sorted_dst[lo], cols[lo]] = order[lo]
    if len(hub_states):
        Em = int(indeg[hub_states].max())
        t2 = np.full((len(hub_states), Em), A, np.int32)
        hidx = np.zeros(S, np.int64)
        hidx[hub_states] = np.arange(len(hub_states))
        hi = ~lo
        t2[hidx[sorted_dst[hi]], cols[hi]] = order[hi]
    else:
        t2 = np.full((0, 1), A, np.int32)
    return t1, hub_states, t2


def _gather_min(cand_pad, t1, hub_states, t2, S: int, A: int):
    """cand_pad [B, A+1] (slot A = BIG dummy) -> per-state (min [B, S],
    winning arc id [B, S] int32, -1 where nothing reached)."""
    B = cand_pad.shape[0]
    g1 = jnp.take(cand_pad, t1, axis=1)                 # [B, S, cap]
    new = jnp.min(g1, axis=-1)
    pos = jnp.argmin(g1, axis=-1)
    arc = jnp.take_along_axis(jnp.broadcast_to(t1, (B,) + t1.shape),
                              pos[..., None], axis=2)[..., 0]
    if t2.shape[0]:
        g2 = jnp.take(cand_pad, t2, axis=1)             # [B, H, Em]
        hmin = jnp.min(g2, axis=-1)
        hpos = jnp.argmin(g2, axis=-1)
        harc = jnp.take_along_axis(jnp.broadcast_to(t2, (B,) + t2.shape),
                                   hpos[..., None], axis=2)[..., 0]
        cur = new[:, hub_states]
        better = hmin < cur
        new = new.at[:, hub_states].set(jnp.where(better, hmin, cur))
        arc = arc.at[:, hub_states].set(
            jnp.where(better, harc, arc[:, hub_states]))
    bp = jnp.where((new < BIG * 0.5) & (arc < A), arc, -1).astype(jnp.int32)
    return new, bp


def _build_steps(e_src, e_cost, e_pdf, z_src, z_cost,
                 e_tabs, z_tabs, B: int, S: int, n_eps: int):
    """The per-frame gather-min relaxation + eps-closure rounds, shared
    by the full-arena and checkpointed dense forward passes. Backpointer
    arrays hold the winning ARC id per (batch, state), -1 if unreached."""
    Ae = e_src.shape[0]
    Az = z_src.shape[0]
    pad1 = jnp.full((B, 1), BIG)

    def eps_round(alpha):
        cand = jnp.minimum(alpha[:, z_src] + z_cost[None, :], BIG)
        relaxed, bp = _gather_min(jnp.concatenate([cand, pad1], axis=1),
                                  *z_tabs, S, Az)
        keep = alpha <= relaxed
        new = jnp.where(keep, alpha, relaxed)
        bp = jnp.where(keep, -1, bp)
        return new, bp

    def frame_step(alpha, inputs):
        ll_t, mask_t = inputs
        am = -ll_t[:, e_pdf]                               # [B, Ae]
        cand = jnp.minimum(alpha[:, e_src] + e_cost[None, :] + am, BIG)
        new, bp_e = _gather_min(jnp.concatenate([cand, pad1], axis=1),
                                *e_tabs, S, Ae)
        bps_z = []
        for _ in range(n_eps):
            new, bp_z = eps_round(new)
            bps_z.append(bp_z)
        out = jnp.where(mask_t[:, None], new, alpha)
        bp_e = jnp.where(mask_t[:, None], bp_e, -1)
        bps_z = [jnp.where(mask_t[:, None], b, -1) for b in bps_z]
        return out, (bp_e, tuple(bps_z))

    return eps_round, frame_step


def _best_end_state(alpha_T, final):
    total = alpha_T + final[None, :]
    best_state = jnp.argmin(total, axis=1)
    best_final_cost = jnp.take_along_axis(total, best_state[:, None],
                                          axis=1)[:, 0]
    any_state = jnp.argmin(alpha_T, axis=1)
    reached = best_final_cost < BIG * 0.5
    state0 = jnp.where(reached, best_state, any_state)
    cost = jnp.where(reached, best_final_cost,
                     jnp.take_along_axis(alpha_T, any_state[:, None],
                                         axis=1)[:, 0])
    return state0, cost


@functools.partial(jax.jit, static_argnames=("S", "n_eps"))
def _dense_decode(
    ll,                 # [B, T, P] scaled loglikes
    frame_mask,         # [B, T]
    e_src, e_cost, e_pdf, e_ol, e_il,          # emitting arcs [Ae]
    z_src, z_cost, z_ol,                       # eps arcs [Az]
    e_tabs, z_tabs,     # incoming-arc gather tables
    final,              # [S]
    start: int, S: int, n_eps: int,
):
    B, T, P = ll.shape
    eps_round, frame_step = _build_steps(
        e_src, e_cost, e_pdf, z_src, z_cost, e_tabs, z_tabs, B, S, n_eps)

    alpha0 = jnp.full((B, S), BIG).at[:, start].set(0.0)
    init_bps = []
    for _ in range(n_eps):
        alpha0, bp_z = eps_round(alpha0)
        init_bps.append(bp_z)

    alpha_T, (bp_e_all, bp_z_all) = jax.lax.scan(
        frame_step, alpha0,
        (jnp.moveaxis(ll, 1, 0), jnp.moveaxis(frame_mask, 1, 0)))

    total = alpha_T + final[None, :]
    best_state = jnp.argmin(total, axis=1)
    best_final_cost = jnp.take_along_axis(total, best_state[:, None],
                                          axis=1)[:, 0]
    any_state = jnp.argmin(alpha_T, axis=1)
    reached = best_final_cost < BIG * 0.5
    state0 = jnp.where(reached, best_state, any_state)
    cost = jnp.where(reached, best_final_cost,
                     jnp.take_along_axis(alpha_T, any_state[:, None],
                                         axis=1)[:, 0])

    ols, ils, init_ols = _traceback(
        jnp.moveaxis(bp_e_all, 0, 1),
        tuple(jnp.moveaxis(b, 0, 1) for b in bp_z_all),
        tuple(init_bps), state0,
        e_src, e_ol, e_il, z_src, z_ol, n_eps)
    return ols, ils, init_ols, cost


@functools.partial(jax.jit, static_argnames=("S", "n_eps", "C"))
def _dense_decode_ckpt(
    ll, frame_mask,
    e_src, e_cost, e_pdf, e_ol, e_il,
    z_src, z_cost, z_ol,
    e_tabs, z_tabs,
    final, start: int, S: int, n_eps: int, C: int,
):
    """Checkpointed-memory dense Viterbi: the [T, rounds, B, S]
    backpointer arena of _dense_decode is replaced by rematerialization —
    forward stores only each C-frame chunk's entry alpha [n_chunks, B, S];
    the traceback re-runs each chunk's forward (backpointers live only
    for one chunk at a time inside the reverse scan) and walks it.
    Memory O(T/C·B·S + C·rounds·B·S) for ~2x forward compute — the
    jax.checkpoint idea applied to Viterbi (T must be a multiple of C;
    pad with masked frames)."""
    B, T, P = ll.shape
    assert T % C == 0
    n_chunks = T // C
    eps_round, frame_step = _build_steps(
        e_src, e_cost, e_pdf, z_src, z_cost, e_tabs, z_tabs, B, S, n_eps)

    alpha0 = jnp.full((B, S), BIG).at[:, start].set(0.0)
    init_bps = []
    for _ in range(n_eps):
        alpha0, bp_z = eps_round(alpha0)
        init_bps.append(bp_z)

    ll_c = jnp.moveaxis(ll, 1, 0).reshape(n_chunks, C, B, P)
    mask_c = jnp.moveaxis(frame_mask, 1, 0).reshape(n_chunks, C, B)

    def fwd_chunk(alpha, inputs):
        llc, mc = inputs
        alpha_out, _ = jax.lax.scan(
            lambda a, i: (frame_step(a, i)[0], None), alpha, (llc, mc))
        return alpha_out, alpha        # store the chunk's ENTRY alpha

    alpha_T, alphas_in = jax.lax.scan(fwd_chunk, alpha0, (ll_c, mask_c))
    state0, cost = _best_end_state(alpha_T, final)

    def back_chunk(s_end, inputs):
        llc, mc, alpha_in = inputs
        _, (bp_e, bps_z) = jax.lax.scan(frame_step, alpha_in, (llc, mc))
        ols, ils, s_start = _trace_frames(
            jnp.moveaxis(bp_e, 0, 1),
            tuple(jnp.moveaxis(b, 0, 1) for b in bps_z),
            s_end, e_src, e_ol, e_il, z_src, z_ol, n_eps)
        return s_start, (ols, ils)

    s_first, (ols_c, ils_c) = jax.lax.scan(
        back_chunk, state0, (ll_c, mask_c, alphas_in), reverse=True)
    # [n_chunks, B, C, R] -> [B, T, R] (chunk order is preserved: a
    # reverse scan still writes outputs at their original indices)
    ols = jnp.moveaxis(ols_c, 0, 1).reshape(B, T, -1)
    ils = jnp.moveaxis(ils_c, 0, 1).reshape(B, T, -1)
    init_ols = _trace_init(tuple(init_bps), s_first, z_src, z_ol, n_eps, B)
    return ols, ils, init_ols, cost


def _trace_frames(bp_e, bps_z, state0, e_src, e_ol, e_il, z_src, z_ol,
                  n_eps: int):
    """Walk states backward over a span of frames.

    bp_e [B, T, S]; bps_z: tuple of n_eps arrays [B, T, S]; state0 [B]
    is the state at the END of the span. -> (ols [B, T, n_eps+1],
    ils [B, T, 1], s_start [B] — the state at span start)."""

    def trace_one(bp_e_b, bp_z_b, s0):
        def step(s, inputs):
            bp_e_t, bp_z_t = inputs
            ols, ils = [], []
            for r in range(n_eps - 1, -1, -1):
                a = bp_z_t[r][s]
                taken = a >= 0
                ols.append(jnp.where(taken, z_ol[jnp.maximum(a, 0)], 0))
                s = jnp.where(taken, z_src[jnp.maximum(a, 0)], s)
            a = bp_e_t[s]
            taken = a >= 0
            ols.append(jnp.where(taken, e_ol[jnp.maximum(a, 0)], 0))
            ils.append(jnp.where(taken, e_il[jnp.maximum(a, 0)], 0))
            s = jnp.where(taken, e_src[jnp.maximum(a, 0)], s)
            return s, (jnp.stack(ols[::-1]), jnp.stack(ils))

        s_fin, (ols, ils) = jax.lax.scan(
            step, s0, (bp_e_b, tuple(bp_z_b)), reverse=True)
        return ols, ils, s_fin

    return jax.vmap(trace_one)(bp_e, bps_z, state0)


def _trace_init(init_bps, s_start, z_src, z_ol, n_eps: int, B: int):
    """Trace the pre-frame-0 eps closure. -> init_ols [B, n_eps]."""
    if n_eps == 0:
        return jnp.zeros((B, 0), jnp.int32)

    def trace_init(init_b, s0):
        ols0 = []
        for r in range(n_eps - 1, -1, -1):
            a = init_b[r][s0]
            taken = a >= 0
            ols0.append(jnp.where(taken, z_ol[jnp.maximum(a, 0)], 0))
            s0 = jnp.where(taken, z_src[jnp.maximum(a, 0)], s0)
        return jnp.stack(ols0[::-1])

    return jax.vmap(trace_init)(init_bps, s_start)


def _traceback(bp_e, bps_z, init_bps, state0,
               e_src, e_ol, e_il, z_src, z_ol, n_eps: int):
    """Full on-device traceback: frames then the initial eps closure.
    -> (ols [B, T, n_eps+1], ils [B, T, 1], init_ols [B, n_eps])."""
    B = bp_e.shape[0]
    ols, ils, s_start = _trace_frames(bp_e, bps_z, state0,
                                      e_src, e_ol, e_il, z_src, z_ol,
                                      n_eps)
    init_ols = _trace_init(init_bps, s_start, z_src, z_ol, n_eps, B)
    return ols, ils, init_ols


@functools.partial(jax.jit, static_argnames=("S", "n_eps"))
def _dense_decode_assoc(
    ll, frame_mask,
    e_src, e_nxt, e_cost, e_pdf, e_ol, e_il,
    z_src, z_nxt, z_cost, z_ol,
    final, start: int, S: int, n_eps: int,
):
    """Depth-parallel Viterbi: the frame recurrence is a min-plus
    matrix product, so the whole forward pass is ONE associative scan of
    per-frame [S, S] transition matrices (O(log T) depth instead of a
    T-step sequential loop). Backpointers are then recomputed for all
    frames at once from the per-frame alphas — a handful of large fused
    ops instead of ~15 small ops per frame. Memory is O(B·T·S²), so this
    path is gated to small S by the caller."""
    B, T, P = ll.shape
    Ae = e_src.shape[0]
    Az = z_src.shape[0]

    def minplus(x, y):
        # x [..., i, k] ⊗ y [k, j] or [..., k, j]
        return jnp.min(x[..., :, :, None] + y[..., None, :, :], axis=-2)

    eye = jnp.where(jnp.eye(S, dtype=bool), 0.0, BIG)
    Z = jnp.full((S, S), BIG).at[z_src, z_nxt].min(z_cost)
    IZ = jnp.minimum(Z, eye)
    E = eye
    for _ in range(n_eps):
        E = minplus(E[None], IZ)[0]

    # per-frame emitting min-plus matrices (+ eps closure folded in)
    am = -ll[..., e_pdf]                                   # [B, T, Ae]
    cand = am + e_cost[None, None, :]
    Mt = jnp.full((B, T, S, S), BIG)
    Mt = Mt.at[:, :, e_src, e_nxt].min(cand)
    A = minplus(Mt, E)                                     # [B, T, S, S]
    # padded frames are identity (tokens pass through unchanged)
    A = jnp.where(frame_mask[:, :, None, None], A, eye[None, None])

    def combine(x, y):
        # min-plus matrix product: out[..., i, j] = min_k x[i,k] + y[k,j]
        return jnp.min(x[..., :, :, None] + y[..., None, :, :], axis=-2)

    Pt = jax.lax.associative_scan(combine, A, axis=1)      # prefix products
    alpha0 = E[start]                                      # [S]
    alpha_t = jnp.min(alpha0[None, None, :, None] + Pt, axis=-2)  # [B,T,S]
    alpha_prev = jnp.concatenate(
        [jnp.broadcast_to(alpha0, (B, 1, S)), alpha_t[:, :-1]], axis=1)

    # recompute per-frame backpointers for ALL frames in fused ops
    cand_e = alpha_prev[..., e_src] + e_cost + am          # [B, T, Ae]
    after = jnp.full((B, T, S), BIG).at[:, :, e_nxt].min(cand_e)
    dst_best = after[..., e_nxt]
    is_best = (cand_e <= dst_best + 1e-6) & (cand_e < BIG * 0.5)
    bp_val = jnp.where(is_best, jnp.arange(Ae)[None, None, :], Ae + 1)
    bp_e = jnp.full((B, T, S), Ae + 1, jnp.int32)
    bp_e = bp_e.at[:, :, e_nxt].min(bp_val.astype(jnp.int32))
    bp_e = jnp.where(bp_e > Ae, -1, bp_e)
    bp_e = jnp.where(frame_mask[:, :, None], bp_e, -1)

    bps_z = []
    cur = after
    for _ in range(n_eps):
        cz = cur[..., z_src] + z_cost                      # [B, T, Az]
        new = cur.at[:, :, z_nxt].min(cz)
        dstb = new[..., z_nxt]
        isb = (cz <= dstb + 1e-6) & (cz < BIG * 0.5) & (cz < cur[..., z_nxt])
        bv = jnp.where(isb, jnp.arange(Az)[None, None, :], Az + 1)
        bz = jnp.full((B, T, S), Az + 1, jnp.int32)
        bz = bz.at[:, :, z_nxt].min(bv.astype(jnp.int32))
        bz = jnp.where(bz > Az, -1, bz)
        bz = jnp.where(frame_mask[:, :, None], bz, -1)
        bps_z.append(bz)
        cur = new

    # padded tails: A is identity there, so the prefix-product alpha at
    # T-1 is the last REAL frame's alpha
    alpha_T = alpha_t[:, -1]
    total = alpha_T + final[None, :]
    best_state = jnp.argmin(total, axis=1)
    best_final_cost = jnp.take_along_axis(total, best_state[:, None],
                                          axis=1)[:, 0]
    any_state = jnp.argmin(alpha_T, axis=1)
    reached = best_final_cost < BIG * 0.5
    state0 = jnp.where(reached, best_state, any_state)
    cost = jnp.where(reached, best_final_cost,
                     jnp.take_along_axis(alpha_T, any_state[:, None],
                                         axis=1)[:, 0])

    # initial eps-closure records from the bare start state
    a0 = jnp.full((S,), BIG).at[start].set(0.0)
    init_bps = []
    a0b = jnp.broadcast_to(a0, (B, S))
    for _ in range(n_eps):
        czi = a0b[:, z_src] + z_cost
        newi = a0b.at[jnp.arange(B)[:, None],
                      jnp.broadcast_to(z_nxt, (B, Az))].min(czi)
        dstb = newi[:, z_nxt]
        isb = (czi <= dstb + 1e-6) & (czi < BIG * 0.5) \
            & (czi < a0b[:, z_nxt])
        bv = jnp.where(isb, jnp.arange(Az)[None, :], Az + 1)
        bzi = jnp.full((B, S), Az + 1, jnp.int32)
        bzi = bzi.at[jnp.arange(B)[:, None],
                     jnp.broadcast_to(z_nxt, (B, Az))].min(
            bv.astype(jnp.int32))
        bzi = jnp.where(bzi > Az, -1, bzi)
        init_bps.append(bzi)
        a0b = newi

    ols, ils, init_ols = _traceback(
        bp_e, tuple(bps_z), tuple(init_bps), state0,
        e_src, e_ol, e_il, z_src, z_ol, n_eps)
    return ols, ils, init_ols, cost


def _parse_label_seqs(ols, ils, init_ols, cost, num_frames):
    """Host parse shared by the dense and beam decoders: strip label-0
    padding -> per-utterance (words, tids, total_cost) or None."""
    out = []
    for b in range(len(num_frames)):
        Tb = int(num_frames[b])
        if cost[b] >= BIG * 0.5:
            out.append(None)
            continue
        flat_o = np.concatenate([init_ols[b].ravel(),
                                 ols[b, :Tb].ravel()])
        words = flat_o[flat_o != 0].tolist()
        flat_i = ils[b, :Tb].ravel()
        tids = flat_i[flat_i != 0].tolist()
        out.append((words, tids, float(cost[b])))
    return out


_mask_cache: dict = {}


def _device_mask(num_frames: np.ndarray, T: int):
    """Device-resident frame-validity mask [B, T], cached by value.

    Streaming/bench loops call decode with the same lengths every batch;
    re-uploading the mask each call costs a host->device transfer on the
    critical path."""
    key = (num_frames.tobytes(), T)
    m = _mask_cache.get(key)
    if m is None:
        if len(_mask_cache) > 256:
            _mask_cache.clear()
        m = jnp.asarray(np.arange(T)[None, :] < num_frames[:, None])
        _mask_cache[key] = m
    return m


@dataclasses.dataclass(frozen=True)
class DenseDecoderOpts:
    eps_expansions: int | None = None   # None = infer exact eps depth
    acoustic_scale: float = 0.1
    # time-parallel (associative-scan) forward pass when S is small enough
    # that O(B·T·S²) matrices fit comfortably; 0 disables
    assoc_max_states: int = 48
    # >0: checkpointed traceback with this chunk size — the [T,rounds,B,S]
    # backpointer arena becomes O(T/C + C) per (B,S) at ~2x forward
    # compute; enables the dense path on graphs/batches whose full arena
    # would not fit HBM (set automatically by make_decoder)
    traceback_chunk: int = 0


class DenseViterbiDecoder:
    """Best-path decoder over the full state space (small graphs)."""

    def __init__(self, graph: PackedGraph, opts=DenseDecoderOpts()):
        from kaldi_tpu.decoder.beam_search import resolve_eps_rounds
        assert graph.pdf is not None, (
            "PackedGraph has no tid->pdf mapping: pack_graph() must be "
            "given tid_to_pdf for decoding")
        self.graph = graph
        opts = dataclasses.replace(
            opts, eps_expansions=resolve_eps_rounds(graph, opts.eps_expansions))
        self.opts = opts
        il = np.asarray(graph.ilabel)
        emit = il > 0
        src = np.repeat(np.arange(graph.num_states),
                        np.diff(graph.arc_start))
        pdf = (np.maximum(graph.pdf, 0) if graph.pdf is not None
               else np.zeros_like(il))
        self._e = (jnp.asarray(src[emit]), jnp.asarray(graph.nextstate[emit]),
                   jnp.asarray(graph.cost[emit].astype(np.float32)),
                   jnp.asarray(pdf[emit]))
        z = ~emit
        if z.any():
            self._z = (jnp.asarray(src[z]), jnp.asarray(graph.nextstate[z]),
                       jnp.asarray(graph.cost[z].astype(np.float32)))
            self._z_np = (src[z], graph.nextstate[z], graph.olabel[z])
        else:
            self._z = (jnp.zeros(1, np.int32), jnp.zeros(1, np.int32),
                       jnp.full(1, BIG, np.float32))
            self._z_np = (np.zeros(1, np.int64), np.zeros(1, np.int64),
                          np.zeros(1, np.int64))
        self._final = jnp.asarray(
            np.where(np.isfinite(graph.final), graph.final,
                     BIG).astype(np.float32))
        # label tables for the traced lookup (module-level device consts)
        self._ol_e = jnp.asarray(graph.olabel[emit].astype(np.int32))
        self._il_e = jnp.asarray(il[emit].astype(np.int32))
        self._ol_z = jnp.asarray(self._z_np[2].astype(np.int32))
        # incoming-arc gather tables (scatter-free min relaxation)
        e_dst = np.asarray(graph.nextstate[emit], np.int64)
        z_dst = np.asarray(self._z_np[1], np.int64)
        S = graph.num_states
        self._e_tabs = tuple(jnp.asarray(a) for a in _incoming_tables(
            e_dst, len(e_dst), S))
        # the placeholder eps arc (no real eps arcs) has cost BIG and
        # must never win: exclude it from the tables by passing A=0
        self._z_tabs = tuple(jnp.asarray(a) for a in _incoming_tables(
            z_dst if z.any() else np.zeros(0, np.int64),
            int(z.sum()), S))

    def decode_async(self, loglikes, num_frames: np.ndarray):
        """Launch the decode program and return a finisher callable.

        The device program is dispatched immediately; calling the
        returned thunk performs the single device->host transfer and the
        host-side parse. Lets a serving loop overlap batch N+1's compute
        with batch N's result fetch (the streaming analogue of the
        reference's TaskSequencer pipelining)."""
        from kaldi_tpu.decoder.hostpack import pack4, unpack4
        o = self.opts
        B, T, P = loglikes.shape
        nf = np.asarray(num_frames)
        C = int(o.traceback_chunk)
        use_ckpt = C > 0 and self.graph.num_states > o.assoc_max_states
        if use_ckpt and T % C:
            pad = C - T % C   # masked pad frames pass alpha/bp through
            loglikes = jnp.pad(jnp.asarray(loglikes),
                               ((0, 0), (0, pad), (0, 0)))
            T += pad
        mask = _device_mask(nf, T)
        ll = jnp.asarray(loglikes) * o.acoustic_scale
        tail = (self._final, int(self.graph.start),
                int(self.graph.num_states), int(o.eps_expansions))
        if self.graph.num_states <= o.assoc_max_states:
            ols, ils, init_ols, cost = _dense_decode_assoc(
                ll, mask,
                self._e[0], self._e[1], self._e[2], self._e[3],
                self._ol_e, self._il_e,
                self._z[0], self._z[1], self._z[2], self._ol_z, *tail)
        else:
            common = (ll, mask,
                      self._e[0], self._e[2], self._e[3],
                      self._ol_e, self._il_e,
                      self._z[0], self._z[2], self._ol_z,
                      self._e_tabs, self._z_tabs) + tail
            if use_ckpt:
                ols, ils, init_ols, cost = _dense_decode_ckpt(*common, C)
            else:
                ols, ils, init_ols, cost = _dense_decode(*common)
        packed, shapes = pack4(ols, ils, init_ols, cost)

        def finish():
            ols, ils, init_ols, cost = unpack4(np.asarray(packed), shapes)
            return _parse_label_seqs(ols, ils, init_ols, cost, nf)

        return finish

    def decode(self, loglikes, num_frames: np.ndarray):
        return self.decode_async(loglikes, num_frames)()


def make_decoder(graph: PackedGraph, beam_opts=None,
                 dense_threshold: int = 200_000,
                 batch_hint: tuple[int, int] | None = None,
                 arena_budget_bytes: int = 4 << 30):
    """Pick a decoder: dense full-state Viterbi when feasible, beam
    search otherwise (both expose .decode/.decode_async).

    The dense path's backpointer arena is [T, eps_rounds+1, B, S] int32,
    so feasibility depends on B*T as much as on S. With batch_hint=(B, T)
    the choice is by ARENA MEMORY against arena_budget_bytes: if the full
    arena fits, plain dense; else a checkpointed traceback chunk size C
    is picked so only O(T/C + C) of the arena is live (rematerialized
    traceback, ~2x forward compute); only when even that fails (or S
    exceeds dense_threshold) does the sort-based beam path take over —
    scatter-min relaxation was measured far cheaper than sorting on the
    previous accelerator, so dense-with-checkpointing is preferred up to
    ~200k states (a threshold to re-measure on the GPU).
    """
    from kaldi_tpu.decoder.beam_search import (BeamSearchDecoder,
                                               BeamSearchOpts,
                                               resolve_eps_rounds)
    beam_opts = beam_opts or BeamSearchOpts()
    S = graph.num_states
    rounds = resolve_eps_rounds(graph, beam_opts.eps_expansions) + 1
    # production-scale graphs: the padded [S, E_max] beam tables blow up
    # on real HCLG fan-out (word-end states reach vocab size) — route to
    # the O(arcs) CSR budget decoder instead
    if S > dense_threshold:
        padded_cells = S * max(graph.max_out_degree, 1)
        if padded_cells > 32_000_000 or graph.max_out_degree > 1024:
            from kaldi_tpu.decoder.csr_beam import (CsrBeamDecoder,
                                                    CsrBeamOpts)
            return CsrBeamDecoder(graph, CsrBeamOpts(
                beam=beam_opts.beam, max_active=beam_opts.max_active,
                acoustic_scale=beam_opts.acoustic_scale,
                eps_expansions=beam_opts.eps_expansions))
    if S <= dense_threshold:
        chunk = 0
        if batch_hint is not None:
            B, T = batch_hint
            per_frame = 4 * rounds * B * S          # bp arena bytes/frame
            if per_frame * T > arena_budget_bytes:
                # checkpoints [T/C, B, S] + live chunk [C, rounds, B, S]
                c = arena_budget_bytes // (2 * max(per_frame, 1))
                chunk = int(min(max(c, 0), 256))
                if chunk < 8:
                    return BeamSearchDecoder(graph, beam_opts)
        return DenseViterbiDecoder(
            graph, DenseDecoderOpts(
                eps_expansions=beam_opts.eps_expansions,
                acoustic_scale=beam_opts.acoustic_scale,
                traceback_chunk=chunk))
    return BeamSearchDecoder(graph, beam_opts)
