"""Degree-tiered beam search for production-scale HCLG graphs.

The tensor-program replacement for LatticeFasterDecoder's token passing
at real graph scale (ref: decoder/lattice-faster-decoder.cc:660-750
ProcessEmitting/ProcessNonemitting, util/hash-list.h:50 token hash).
Memory is O(arcs); per-frame work is O(visited arcs), never O(S) or
O(S * E_max).

The cost model behind this design (measured on the previous
accelerator; a hypothesis on the GPU until re-measured there):
  - a random gather costs about the same per ROW for any row width up
    to 16 lanes — so every table is row-packed and fetched once,
  - random scatters into a large device table are the most expensive
    primitive, while dense sorts and top_k are cheap — so FindOrAddToken
    dedup is a stable variadic SORT of the candidate set by
    (state, score) plus a run-head compare, not a hash/scatter: exact
    single-winner semantics, and no persistent token table at all.

States are partitioned by out-degree into three tiers at pack time:

  tier A (deg <= 2, the HMM chain states, ~94% of a real HCLG): both
      arcs live in ONE row of a packed [S, 16] int32 table — a frame
      expands the whole frontier with a single [K, 16] row gather.
  tier B (2 < deg <= hub_threshold, LM history states): flat CSR with
      arc TRIPLES row-packed as [ABR, 16] (3 arcs x 5 cols per row —
      a random row fetch costs the same for any width <= 16 lanes, so
      three arcs ride each fetch); a load-balanced budgeted segmented
      gather (cumsum + scatter-max + cummax) assigns ROW slots, so cost
      is O(budget/3) row fetches regardless of fan-out skew. Budget
      overflow drops the WORST tokens' arcs first (the frontier is kept
      score-sorted) and is counted exactly in arcs, never silent.
  tier C "hubs" (deg > hub_threshold, e.g. the unigram/backoff state
      fanning out to the whole vocabulary): arcs stay DENSE per hub,
      pdf-grouped at pack time; acoustic costs come from a static
      one-hot matmul over the <=128 distinct entry pdfs instead of a
      60k-element gather, and a dense top_k picks the hub's best
      max-active candidates.

Per frame: expand tiers -> beam cutoff vs frame-best (GetCutoff :591)
-> sort-based dedup by target state (the hash-free FindOrAddToken;
work stays O(candidates log C)) -> top_k keeps max-active tokens
score-sorted -> eps rounds repeat over the eps tier tables.

Backpointers pack (prev-slot | olabel << kbits) into one int32 arena;
the traceback runs on device and ships only [B, T, R] label ids.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp

from kaldi_tpu.decoder.graph_pack import PackedGraph, split_csr, SplitCsr

BIG = np.float32(1e10)
BIG_BITS = int(np.array(1e10, np.float32).view(np.int32))  # f32 bit pattern
INT_BIG = np.int32(2**30)
INT32_MAX = np.int32(2**31 - 1)


@dataclasses.dataclass(frozen=True)
class CsrBeamOpts:
    """(ref: decoder/lattice-faster-decoder.h:40-90 LatticeFasterDecoderConfig)"""

    beam: float = 13.0
    max_active: int = 7000      # frontier capacity K (tokens kept per frame)
    acoustic_scale: float = 0.1
    eps_expansions: int | None = None   # None = infer exact eps depth
    expand_budget: int = 32768  # tier-B emitting candidate slots per frame
    eps_budget: int = 4096      # tier-B eps candidate slots per round
    hub_threshold: int = 1024   # out-degree above which a state is a hub
    hub_cap: int | None = None  # hub candidates entering the merge per
                                # frame (None = max_active = exact). An
                                # APPROXIMATE speed knob with the same
                                # semantics as a smaller max_active
                                # applied to the hub tier only: the hub
                                # row gather is B*max_active rows at
                                # K=7000 (half the frame's gather
                                # budget), and capping it trades search
                                # width on vocab-fan-out frames for
                                # throughput. Within-beam
                                # candidates beyond the cap are counted
                                # into last_overflow as a binding
                                # indicator (0 = the cap provably never
                                # bound this batch)
    exact_dedup: bool = False   # retained for API compat: dedup is now
                                # always bit-exact (stable-sort winner per
                                # state, candidate-index tie-break)
    force_b_triple: bool = False  # pin the tier-B triple row layout even
                                  # when the quad layout applies (testing
                                  # knob — quad is bit-exact and 25%
                                  # fewer row fetches; see TierTables)
    fold_eps: bool = True       # eps-remove the graph at pack time when
                                # exactly representable (fold_epsilons),
                                # eliminating all per-frame eps rounds
    # --- lattice-record compaction (decode_raw path only) ---
    # The device prunes each recorded frontier snapshot against the
    # frame-best token BEFORE it ships device->host: slots with
    # score > frame_best + rec_beam are dead, and only the first
    # rec_cap slots cross the link (the frontier is score-sorted, so
    # compaction is a mask + slice). With the defaults (rec_beam = the
    # search beam, rec_cap = max_active) the records hold the whole
    # frontier and are lossless: every Viterbi-chain link survives, so
    # the lattice's best path is the decode's. Anything tighter is
    # LOSSY, unlike PruneForwardLinks (ref:
    # decoder/lattice-faster-decoder.cc:476), which prunes with
    # backward costs: a forward score can sit further than the lattice
    # beam behind the frame best and still lie on the final best path
    # (one word-entry LM cost swings the ranking by more than a lattice
    # beam), and a frame whose records all lose their predecessors
    # breaks the chain — an empty lattice. Truncation (alive slots
    # beyond rec_cap) is counted exactly in last_rec_trunc.
    rec_cap: int | None = None   # record slots shipped per round
                                 # (None = max_active: no truncation)
    rec_beam: float | None = None  # record prune beam vs frame best
                                   # (None = beam: exactly the search's
                                   # own liveness, no extra pruning)
    rec_f16: bool = False        # ship snapshot scores as float16
                                 # RELATIVE to the frame best (exact
                                 # f32 best shipped per round): halves
                                 # score bytes on the host link at
                                 # ~0.008 quantization within the
                                 # rec_beam range — decode_raw
                                 # reconstructs f32 absolutes on host
    # flat bin-packed records: the alive prefix of every snapshot is
    # packed contiguously into one per-utterance buffer on device, so
    # the host link ships ~mean-occupancy slots per frame instead of
    # rec_cap-padded rows (within-lattice-beam occupancy is typically
    # ~10x below the cap; the cap only binds on fan-out frames). The
    # host rebuilds the dense [T, R, Keff] view for the extractors.
    rec_flat: bool = False
    rec_flat_cap: int = 512      # flat-buffer slots per (frame, round):
                                 # CAPB = rec_flat_cap * T * R; overflow
                                 # triggers a dense-mode re-decode and is
                                 # counted in last_flat_fallbacks


@dataclasses.dataclass
class TierTables:
    """Device-resident tier tables built once per graph."""

    srow: jnp.ndarray      # [S, 16] int32 packed per-state emitting row:
    #   cols 0-4: arc0 (cost bits, nxt, pdf, tid, ol), 5-9: arc1,
    #   col 10: tier-B arc-triple ROW offset, col 11: tier-B deg (arcs)
    zrow: jnp.ndarray      # [S, 8] int32 packed per-state eps row:
    #   cols 0-2: arc0 (cost bits, nxt, ol), 3-5: arc1,
    #   col 6: tier-B eps offset, col 7: tier-B eps deg
    brow: jnp.ndarray      # [ABR, 16] int32 tier-B arc rows,
    #   ceil(deg/b_apr) rows per state; layout per b_apr:
    #     4 (quad): 4 arcs x (cost bits, nxt, pdf|tid<<16, ol) at cols
    #       0/4/8/12 — requires pdf/tid/ol < 2^16
    #     3 (triple): 3 arcs x (cost bits, nxt, pdf, tid, ol) at cols
    #       0/5/10
    #   padding arcs carry cost=BIG in both
    zbrow: jnp.ndarray     # [AZB, 8] int32 tier-B eps arc rows
    #   (cost bits, nxt, ol, 0, ...)
    final: jnp.ndarray     # [S] f32
    # hub tier (static per graph; H == 0 disables)
    hub_states: np.ndarray      # [H] int64 host-side
    hub_bounds: tuple           # H+1 python ints: flat arc ranges per hub
    hub_rows: jnp.ndarray       # [AH, 8] int32 (cost bits, nxt, pdf, tid, ol)
    hub_cost: jnp.ndarray       # [AH] f32
    hub_onehot: jnp.ndarray | None  # [AH, Gpad] f32 pdf-group one-hot
    hub_gpdf: jnp.ndarray | None    # [Gpad] int32 distinct pdfs per group
    hub_pdf: jnp.ndarray | None     # [AH] int32 (fallback when G > 128)
    b_apr: int = 3                  # tier-B arcs per packed row (4 = quad)


def _pack_rows(cols: list[np.ndarray], width: int) -> np.ndarray:
    n = len(cols[0]) if cols else 0
    out = np.zeros((n, width), np.int32)
    for i, c in enumerate(cols):
        out[:, i] = c
    return out


def build_tier_tables(csr: SplitCsr, hub_threshold: int,
                      force_triple: bool = False) -> TierTables:
    """Vectorized tier partition + row packing (numpy, runs once).

    force_triple pins the tier-B fallback layout (3 arcs x 5 lanes) even
    when the quad layout applies — a testing knob for layout-equivalence
    assertions."""
    S = csr.num_states
    e_deg = np.diff(csr.estart).astype(np.int64)
    z_deg = np.diff(csr.zstart).astype(np.int64)
    cost_bits = csr.e_cost.view(np.int32)
    z_cost_bits = csr.z_cost.view(np.int32)

    is_hub = e_deg > hub_threshold
    tier_a = (~is_hub) & (e_deg <= 2)
    tier_b = (~is_hub) & (e_deg > 2)

    # --- srow: tier A arcs inline + tier B CSR offsets
    srow = np.zeros((S, 16), np.int32)
    srow[:, 0] = BIG_BITS
    srow[:, 5] = BIG_BITS
    for j in (0, 1):
        has = tier_a & (e_deg > j)
        a = csr.estart[:-1][has] + j
        base = 5 * j
        srow[has, base + 0] = cost_bits[a]
        srow[has, base + 1] = csr.e_nxt[a]
        srow[has, base + 2] = csr.e_pdf[a]
        srow[has, base + 3] = csr.e_tid[a]
        srow[has, base + 4] = csr.e_ol[a]
    # tier B packed arc rows. Two layouts, chosen at pack time:
    #   QUAD (default when every tier-B pdf/tid/olabel fits 16 bits —
    #     true for any real vocabulary-scale HCLG: 60k words, ~10k pdfs,
    #     ~40k tids): 4 arcs x 4 lanes (cost f32 bits, nxt i32,
    #     pdf | tid << 16, olabel) — 16 lanes exactly. If a random row
    #     fetch costs the same for any width <= 16 lanes, packing 4
    #     arcs/row instead of 3 cuts the tier-B row fetches by 25% at
    #     identical bit-exact semantics.
    #   TRIPLE (fallback for huge label spaces): 3 arcs x 5 full lanes
    #     (cols 0-4 / 5-9 / 10-14).
    # Padding arcs are dead (cost = BIG) in both.
    b_deg = np.where(tier_b, e_deg, 0)
    b_start = np.zeros(S + 1, np.int64)
    np.cumsum(b_deg, out=b_start[1:])
    AB = int(b_start[-1])
    if AB:
        bs = np.flatnonzero(tier_b)
        reps = e_deg[bs]
        offs = np.repeat(csr.estart[:-1][bs].astype(np.int64), reps)
        within = np.arange(AB) - np.repeat(b_start[bs], reps)
        src_idx = offs + within
        fits16 = (int(csr.e_pdf[src_idx].max(initial=0)) < (1 << 16)
                  and int(csr.e_tid[src_idx].max(initial=0)) < (1 << 16)
                  and int(csr.e_ol[src_idx].max(initial=0)) < (1 << 16))
        apr = 4 if (fits16 and not force_triple) else 3
    else:
        apr = 3
    b_rows = -(-b_deg // apr)
    r_start = np.zeros(S + 1, np.int64)
    np.cumsum(b_rows, out=r_start[1:])
    ABR = int(r_start[-1])
    if ABR:
        # at least 2 rows: a [1, 16] table is the EMPTY-tier dummy
        # sentinel (have_b = shape[0] > 1 at trace time), and a real
        # tier-B fitting exactly one packed row must not be mistaken
        # for it — the padding row is dead (cost = BIG)
        brow = np.zeros((max(ABR, 2), 16), np.int32)
        for k in range(apr):
            brow[:, (4 if apr == 4 else 5) * k] = BIG_BITS
        rowi = np.repeat(r_start[bs], reps) + within // apr
        if apr == 4:
            colb = 4 * (within % 4)
            pt = (csr.e_pdf[src_idx].astype(np.uint32)
                  | (csr.e_tid[src_idx].astype(np.uint32) << np.uint32(16)))
            for c, vals in enumerate((cost_bits[src_idx],
                                      csr.e_nxt[src_idx],
                                      pt.view(np.int32),
                                      csr.e_ol[src_idx])):
                brow[rowi, colb + c] = vals
        else:
            colb = 5 * (within % 3)
            for c, vals in enumerate((cost_bits[src_idx],
                                      csr.e_nxt[src_idx],
                                      csr.e_pdf[src_idx],
                                      csr.e_tid[src_idx],
                                      csr.e_ol[src_idx])):
                brow[rowi, colb + c] = vals
    else:
        brow = np.zeros((1, 16), np.int32)
        for k in range(apr):
            brow[0, (4 if apr == 4 else 5) * k] = BIG_BITS
    srow[:, 10] = r_start[:-1]
    srow[:, 11] = b_deg

    # --- zrow: eps arcs (tier A inline; tier B CSR for deg > 2)
    zrow = np.zeros((S, 8), np.int32)
    zrow[:, 0] = BIG_BITS
    zrow[:, 3] = BIG_BITS
    z_a = z_deg <= 2
    for j in (0, 1):
        has = z_a & (z_deg > j)
        a = csr.zstart[:-1][has] + j
        base = 3 * j
        zrow[has, base + 0] = z_cost_bits[a]
        zrow[has, base + 1] = csr.z_nxt[a]
        zrow[has, base + 2] = csr.z_ol[a]
    zb_deg = np.where(z_a, 0, z_deg)
    zb_start = np.zeros(S + 1, np.int64)
    np.cumsum(zb_deg, out=zb_start[1:])
    AZB = int(zb_start[-1])
    if AZB:
        zs = np.flatnonzero(~z_a)
        reps = z_deg[zs]
        offs = np.repeat(csr.zstart[:-1][zs].astype(np.int64), reps)
        within = np.arange(AZB) - np.repeat(zb_start[zs], reps)
        zi = offs + within
        zbrow = _pack_rows([z_cost_bits[zi], csr.z_nxt[zi],
                            csr.z_ol[zi]], 8)
    else:
        zbrow = np.zeros((1, 8), np.int32)
        zbrow[0, 0] = BIG_BITS
    zrow[:, 6] = zb_start[:-1]
    zrow[:, 7] = zb_deg

    # --- hub tier: dense pdf-grouped arcs
    hubs = np.flatnonzero(is_hub)
    hub_bounds = [0]
    rows_parts = []
    cost_parts = []
    pdf_parts = []
    for h in hubs:
        a0, a1 = int(csr.estart[h]), int(csr.estart[h + 1])
        order = np.argsort(csr.e_pdf[a0:a1], kind="stable") + a0
        rows_parts.append(_pack_rows(
            [cost_bits[order], csr.e_nxt[order], csr.e_pdf[order],
             csr.e_tid[order], csr.e_ol[order]], 8))
        cost_parts.append(csr.e_cost[order])
        pdf_parts.append(csr.e_pdf[order])
        hub_bounds.append(hub_bounds[-1] + (a1 - a0))
    if hubs.size:
        hub_rows = np.concatenate(rows_parts)
        hub_cost = np.concatenate(cost_parts)
        hub_pdf = np.concatenate(pdf_parts)
        gpdf, ginv = np.unique(hub_pdf, return_inverse=True)
        G = len(gpdf)
        if G <= 128:
            Gpad = 128
            onehot = np.zeros((len(hub_pdf), Gpad), np.float32)
            onehot[np.arange(len(hub_pdf)), ginv] = 1.0
            gp = np.zeros(Gpad, np.int32)
            gp[:G] = gpdf
            hub_onehot = jnp.asarray(onehot)
            hub_gpdf = jnp.asarray(gp)
            hub_pdf_dev = None
        else:
            hub_onehot = None
            hub_gpdf = None
            hub_pdf_dev = jnp.asarray(hub_pdf.astype(np.int32))
        tables_hub = (hubs, tuple(hub_bounds), jnp.asarray(hub_rows),
                      jnp.asarray(hub_cost), hub_onehot, hub_gpdf,
                      hub_pdf_dev)
    else:
        tables_hub = (hubs, (0,), jnp.zeros((1, 8), jnp.int32),
                      jnp.full((1,), BIG, jnp.float32), None, None, None)

    return TierTables(
        srow=jnp.asarray(srow), zrow=jnp.asarray(zrow),
        brow=jnp.asarray(brow), zbrow=jnp.asarray(zbrow),
        final=jnp.asarray(csr.final),
        hub_states=tables_hub[0], hub_bounds=tables_hub[1],
        hub_rows=tables_hub[2], hub_cost=tables_hub[3],
        hub_onehot=tables_hub[4], hub_gpdf=tables_hub[5],
        hub_pdf=tables_hub[6], b_apr=apr)


def _bits_to_f32(x):
    return jax.lax.bitcast_convert_type(x, jnp.float32)


def _segment_map(off, deg, C: int, K: int, B: int, base=None):
    """Load-balanced slot->token mapping for the budgeted tier: slot j of
    utterance b belongs to the token whose [off, off+deg) range contains
    j. Batched explicitly (scatter into a flat [B*C] buffer rather than
    a vmapped scatter).

    Returns (tj, pos, valid, overflow) where pos[b, j] is the flat arc
    index `base[b, tj] + (j - off[b, tj])` (or just the within-segment
    offset when base is None). pos is built WITHOUT gathering off/base
    through tj: token ranges tile [0, total) contiguously, so scattering
    per-token value DELTAS at each run start and prefix-summing
    reconstructs base[tj] - off[tj] at every slot exactly (int32 math) —
    two scatters + two dense scans in place of five random element
    gathers.
    Contiguity also makes `valid = j < total` sufficient (a slot inside
    the tiled region always satisfies within < deg of its owner)."""
    total = off[:, -1] + deg[:, -1]                       # [B]
    boff = (jnp.arange(B, dtype=jnp.int32) * C)[:, None]
    flat_idx = jnp.where(off < C, off + boff, B * C).reshape(-1)
    vals = jnp.broadcast_to(
        jnp.where(deg > 0, jnp.arange(K, dtype=jnp.int32)[None, :], 0),
        (B, K)).reshape(-1)
    ids = jnp.zeros(B * C, jnp.int32).at[flat_idx].max(vals, mode="drop")
    tj = jax.lax.cummax(ids.reshape(B, C), axis=1)        # [B, C]
    j = jnp.arange(C, dtype=jnp.int32)[None, :]
    val = (base - off) if base is not None else (-off)    # [B, K] per token
    delta = jnp.concatenate([val[:, :1], val[:, 1:] - val[:, :-1]], axis=1)
    dsum = jnp.zeros(B * C, jnp.int32).at[flat_idx].add(
        delta.reshape(-1), mode="drop")
    pos = j + jnp.cumsum(dsum.reshape(B, C), axis=1)      # [B, C]
    valid = j < total[:, None]
    overflow = jnp.maximum(total - C, 0)
    return tj, pos, valid, overflow


def _dedup_topk(c_state, c_score, c_rec, c_il, K: int,
                state_sort: bool = False):
    """Best token per state, then best K overall, score-sorted.

    The hash-free FindOrAddToken (ref: lattice-faster-decoder.cc:232):
    one variadic sort by (state, score, candidate-index) groups each
    target state's candidates with its best first; a neighbor-compare
    marks the run heads (single winner per state, candidate-index
    tie-break — bit-exact semantics); masked top_k keeps the K best
    winners. Dedup is purely within the candidate set, so no persistent
    table is carried and the cost is O(C log C) dense sorting instead of
    a scatter-min over a flat [B*S] table. The non-key fields ride the
    sorts as passengers, so no element gathers through sort indices are
    needed. c_rec is the pre-packed backpointer record
    `prev_slot | olabel << kbits`.
    All arrays are [B, C]."""
    B, C = c_state.shape
    # candidate-index tie-break comes FREE from sort stability (lax.sort
    # is stable by default): among equal (state, score) pairs the
    # original candidate order is preserved, which is exactly the
    # explicit index key this sort used to carry — dropping it saves one
    # int32 array through every bitonic pass (the sorts are the frame's
    # largest HBM cost at production NC)
    ss, ssc, srec, sil = jax.lax.sort(
        (c_state, c_score, c_rec, c_il), dimension=1, num_keys=2)
    first = jnp.concatenate(
        [jnp.ones((B, 1), bool), ss[:, 1:] != ss[:, :-1]], axis=1)
    sel = jnp.where(first, ssc, BIG)                      # dead sort last
    # keep the K best winners with a SECOND variadic sort keyed on the
    # masked score (stable, so equal scores break by state-sorted
    # position — the same order lax.top_k(-sel) produced), with the
    # other fields as passengers instead of top_k + 3 gathers
    sc2, st2, rec2, il2 = jax.lax.sort((sel, ss, srec, sil),
                                       dimension=1, num_keys=1)
    st2, sc2 = st2[:, :K], jnp.minimum(sc2[:, :K], BIG)
    rec2, il2 = rec2[:, :K], il2[:, :K]
    if state_sort:
        # best-path-only locality pass: order the kept tokens by STATE
        # (dead slots stay last via the 2^30 key) so the next frame's
        # srow/brow row gathers hit adjacent table rows. NOT used when
        # record compaction or budget-overflow drop-order semantics
        # need the score-sorted frontier (latgen, streaming arenas):
        # those keep the canonical order.
        keyb = jnp.where(sc2 < BIG * 0.5, st2, INT_BIG)
        _kb, st2, sc2, rec2, il2 = jax.lax.sort(
            (keyb, st2, sc2, rec2, il2), dimension=1, num_keys=1)
    return st2, sc2, rec2, il2


def _make_rounds(srow, zrow, brow, zbrow,
                 hub_state_arr, hub_rows, hub_cost, hub_onehot, hub_gpdf,
                 hub_pdf, hub_bounds: tuple,
                 B: int, K: int, CB: int, CZ: int, beam: float,
                 HC: int | None = None, b_apr: int = 3,
                 state_sort: bool = True):
    """Build the per-frame (emit_round, eps_round) expansion programs over
    the tier tables for a [B, K] frontier. Shared by the offline batch
    decoders below and the fused streaming decoder
    (kaldi_tpu/online/fused.py, B == 1) so both search identically.

    HC (hub_cap): at most HC hub candidates enter the merge per frame
    (the hub-arc row gather is B*K rows otherwise — about half the
    per-frame row fetches at K=7000 — while only the within-beam few
    survive). Within-beam candidates beyond rank HC are counted EXACTLY
    in the overflow output (vs the hub's own frame best, a superset of
    merge survivors), so a too-small cap is loud, never silent — the
    same contract as expand_budget."""
    kbits = max((K - 1).bit_length(), 1)
    HC = K if HC is None else min(HC, K)
    H = len(hub_bounds) - 1
    AH = hub_rows.shape[0]
    have_b = brow.shape[0] > 1
    have_zb = zbrow.shape[0] > 1
    CBR = -(-CB // b_apr)   # tier-B budget in packed arc ROWS
    iarange = jnp.arange(K, dtype=jnp.int32)[None, :]
    self_prev = jnp.broadcast_to(iarange, (B, K))
    zeros_bk = jnp.zeros((B, K), jnp.int32)

    def unpack_arc(row, base, with_pdf=True):
        cost = _bits_to_f32(row[..., base + 0])
        nxt = row[..., base + 1]
        if with_pdf:
            return cost, nxt, row[..., base + 2], row[..., base + 3], \
                row[..., base + 4]
        return cost, nxt, row[..., base + 2]

    def b_pdf(arcr, k):
        """pdf of packed tier-B sub-arc k (layout per b_apr)."""
        if b_apr == 4:
            return arcr[..., 4 * k + 2] & 0xFFFF
        return arcr[..., 5 * k + 2]

    def unpack_b_arc(arcr, k):
        """(cost, nxt, tid, ol) of packed tier-B sub-arc k."""
        if b_apr == 4:
            base = 4 * k
            tid = (arcr[..., base + 2] >> 16) & 0xFFFF
            return (_bits_to_f32(arcr[..., base]), arcr[..., base + 1],
                    tid, arcr[..., base + 3])
        base = 5 * k
        return (_bits_to_f32(arcr[..., base]), arcr[..., base + 1],
                arcr[..., base + 3], arcr[..., base + 4])

    def take_ll(ll_t, pdf):
        """Batched small-table lookup: ll_t [B, P], pdf [B, ...] -> the
        same shape as pdf. The [B, P] table is small enough to stay in
        cache, and XLA fuses the gather into its consumers."""
        return jnp.take_along_axis(ll_t, pdf.reshape(B, -1), axis=1) \
            .reshape(pdf.shape)

    def tier_b_emit(tok_score, row):
        """Row-budgeted expansion over the packed arc table: CBR =
        ceil(expand_budget/b_apr) row slots, each yielding b_apr
        candidates from ONE row fetch. Returns the gathered rows +
        per-slot base scores/token slots; the acoustic lookup happens in
        the caller's fused batch. Overflow is counted exactly in ARCS."""
        off_all = row[..., 10]                    # brow ROW offsets
        deg = jnp.where(tok_score < BIG * 0.5, row[..., 11], 0)
        rows_n = (deg + (b_apr - 1)) // b_apr
        roff = jnp.cumsum(rows_n, axis=1) - rows_n
        tj, rj, valid, _ovr = _segment_map(roff, rows_n, CBR, K, B,
                                           base=off_all)
        # frontier scores are a small [B, K] table, looked up per slot
        base_sc = take_ll(tok_score, tj)
        base_sc = jnp.where(valid, base_sc, BIG)
        rj = jnp.where(valid, rj, 0)
        arcr = brow[rj]                     # [B, CBR, 16] one row gather
        # exact dropped-arc count (rows tile token-contiguously)
        kept_rows = jnp.clip(CBR - roff, 0, rows_n)
        ovf = jnp.sum(deg - jnp.minimum(deg, b_apr * kept_rows), axis=1)
        return (arcr, base_sc, tj), ovf

    def hub_emit(tok_state, tok_score, ll_t):
        """Dense per-hub expansion; returns K best hub candidates per b."""
        match = (tok_state[:, :, None] == hub_state_arr[None, None, :]) & \
            (tok_score[:, :, None] < BIG * 0.5)           # [B, K, H]
        msc = jnp.where(match, tok_score[:, :, None], BIG)
        hub_sc = jnp.min(msc, axis=1)                     # [B, H]
        hub_slot = jnp.argmin(msc, axis=1).astype(jnp.int32)
        base = jnp.zeros((B, AH), jnp.float32)
        slot_flat = jnp.zeros((B, AH), jnp.int32)
        for h in range(H):
            lo, hi = hub_bounds[h], hub_bounds[h + 1]
            base = base.at[:, lo:hi].set(hub_sc[:, h:h + 1])
            slot_flat = slot_flat.at[:, lo:hi].set(hub_slot[:, h:h + 1])
        if hub_onehot is not None:
            am_g = -ll_t[:, hub_gpdf]                     # [B, Gpad]
            # one matmul streams the static one-hot once for all B;
            # HIGHEST keeps it a true f32 product (exact for a one-hot),
            # so hub costs equal the tier-A/B lookup of the same pdf
            # (TF32, the GPU default, would round the scores)
            am_flat = jnp.einsum("ag,bg->ba", hub_onehot, am_g,
                                 precision=jax.lax.Precision.HIGHEST,
                                 preferred_element_type=jnp.float32)
        else:
            am_flat = -take_ll(ll_t, jnp.broadcast_to(hub_pdf[None, :],
                                                      (B, AH)))
        sc_flat = base + hub_cost[None, :] + am_flat
        # exact HC-best hub candidates, tie-break = lowest arc index
        # (lax.top_k's own tie rule); partial selection instead of a
        # full sort of [B, AH]
        negv, idx = jax.lax.top_k(-sc_flat, HC)           # [B, HC]
        sc = jnp.minimum(-negv, BIG)
        # cap-binding indicator: within-beam-of-hub-best candidates
        # beyond rank HC (a conservative superset of merge survivors —
        # nonzero means the cap MAY have altered the search, like a
        # binding max_active). Identically zero when the cap is off.
        if HC >= K:
            hov = jnp.zeros(B, jnp.int32)
        else:
            hub_best = jnp.min(sc_flat, axis=1, keepdims=True)
            n_in_beam = jnp.sum(sc_flat <= hub_best + beam, axis=1,
                                dtype=jnp.int32)
            # no live token on any hub this frame -> nothing can bind
            hov = jnp.where(hub_best[:, 0] < BIG * 0.5,
                            jnp.maximum(n_in_beam - HC, 0), 0)
        rows = hub_rows[idx]                              # [B, HC, 8]
        prev = jnp.take_along_axis(slot_flat, idx, axis=1)
        return (rows[..., 1], sc, prev | (rows[..., 4] << kbits),
                rows[..., 3]), hov

    def merge(cands):
        cst = jnp.concatenate([c[0] for c in cands], axis=1)
        csc = jnp.concatenate([c[1] for c in cands], axis=1)
        crec = jnp.concatenate([c[2] for c in cands], axis=1)
        cil = jnp.concatenate([c[3] for c in cands], axis=1)
        best = jnp.min(csc, axis=1, keepdims=True)
        csc = jnp.where(csc > best + beam, BIG, csc)
        return cst, csc, crec, cil

    def emit_round(tok_state, tok_score, ll_t):
        row = srow[tok_state]                             # [B, K, 16]
        pdfs = [row[..., 2], row[..., 7]]                 # tier-A arc pdfs
        if have_b:
            (arcr, base_b, tj_b), ovf = tier_b_emit(tok_score, row)
            pdfs.extend(b_pdf(arcr, k) for k in range(b_apr))
        else:
            ovf = jnp.zeros(B, jnp.int32)
        # ONE fused acoustic lookup for every tier-A/B candidate
        am_cat = -take_ll(ll_t, jnp.concatenate(pdfs, axis=1))
        cands = []
        off = 0
        for j in (0, 1):
            cost, nxt, pdf, tid, ol = unpack_arc(row, 5 * j)
            am = am_cat[:, off:off + K]
            off += K
            sc = jnp.where(cost < BIG * 0.5, tok_score + cost + am, BIG)
            cands.append((nxt, sc, self_prev | (ol << kbits), tid))
        if have_b:
            for k in range(b_apr):
                cost, nxt, tid, ol = unpack_b_arc(arcr, k)
                am_b = am_cat[:, off:off + CBR]
                off += CBR
                sc_b = jnp.where(cost < BIG * 0.5, base_b + cost + am_b,
                                 BIG)
                cands.append((nxt, sc_b, tj_b | (ol << kbits), tid))
        if H:
            hub_cand, hov = hub_emit(tok_state, tok_score, ll_t)
            cands.append(hub_cand)
            ovf = ovf + hov
        cst, csc, crec, cil = merge(cands)
        st, sc, rec, il = _dedup_topk(cst, csc, crec, cil, K,
                                      state_sort=state_sort)
        return st, sc, rec, il, ovf

    def eps_round(tok_state, tok_score):
        row = zrow[tok_state]                             # [B, K, 8]
        cands = [(tok_state, tok_score, self_prev, zeros_bk)]
        for j in (0, 1):
            cost, nxt, ol = unpack_arc(row, 3 * j, with_pdf=False)
            sc = jnp.where(cost < BIG * 0.5, tok_score + cost, BIG)
            cands.append((nxt, sc, self_prev | (ol << kbits), zeros_bk))
        if have_zb:   # tier-B eps (rare: eps fan-out > 2)
            off_all = row[..., 6]
            deg = jnp.where(tok_score < BIG * 0.5, row[..., 7], 0)
            coff = jnp.cumsum(deg, axis=1) - deg
            tj, aj, valid, ovf = _segment_map(coff, deg, CZ, K, B,
                                              base=off_all)
            base_sc = jnp.take_along_axis(tok_score, tj, axis=1)
            aj = jnp.where(valid, aj, 0)
            arc = zbrow[aj]
            cost = _bits_to_f32(arc[..., 0])
            sc = jnp.where(valid, base_sc + cost, BIG)
            cands.append((arc[..., 1], sc,
                          tj | (arc[..., 2] << kbits), jnp.zeros_like(tj)))
        else:
            ovf = jnp.zeros(B, jnp.int32)
        cst, csc, crec, cil = merge(cands)
        st, sc, rec, il = _dedup_topk(cst, csc, crec, cil, K,
                                      state_sort=state_sort)
        return st, sc, rec, il, ovf

    return emit_round, eps_round


@functools.partial(
    jax.jit,
    static_argnames=("start", "K", "CB", "CZ", "n_eps", "beam",
                     "hub_bounds", "record_full", "Kc", "rec_beam",
                     "rec_f16", "rec_flat", "CAPB", "HC", "b_apr"))
def _csr_decode(
    ll,            # [B, T, P] scaled loglikes
    frame_mask,    # [B, T] bool
    srow, zrow, brow, zbrow, final,
    hub_state_arr,  # [H] int32 device (or [1] dummy)
    hub_rows, hub_cost, hub_onehot, hub_gpdf, hub_pdf,
    start: int, K: int, CB: int, CZ: int, n_eps: int, beam: float,
    hub_bounds: tuple, record_full: bool,
    Kc: int = 0, rec_beam: float = 0.0,   # record compaction (see opts)
    rec_f16: bool = False,
    rec_flat: bool = False, CAPB: int = 0,  # flat bin-packed records
    HC: int | None = None,                  # hub candidate cap
    b_apr: int = 3,                         # tier-B row layout
):
    B, T, P = ll.shape
    # record compaction relies on the score-sorted frontier prefix; the
    # best-path program takes the state-sorted locality layout instead
    emit_round, eps_round = _make_rounds(
        srow, zrow, brow, zbrow, hub_state_arr, hub_rows, hub_cost,
        hub_onehot, hub_gpdf, hub_pdf, hub_bounds, B, K, CB, CZ, beam,
        HC, b_apr, state_sort=not record_full)
    self_prev = jnp.broadcast_to(jnp.arange(K, dtype=jnp.int32)[None, :],
                                 (B, K))

    def compact_rec(s_eff, c_eff):
        """Mask + slice one recorded frontier snapshot: the frontier is
        score-sorted (dead = BIG last), so the PruneActiveTokens
        analogue costs no sort — kill slots beyond frame_best +
        rec_beam, ship only the first Kc slots, count truncated-alive
        slots exactly. -> (states, scores, frame_best, trunc); with
        rec_f16 the scores are f16 RELATIVE to frame_best (masked =
        +inf), else absolute f32 (masked = BIG)."""
        keep = c_eff <= c_eff[:, :1] + rec_beam
        n_alive = jnp.sum(keep, axis=1, dtype=jnp.int32)
        best = c_eff[:, 0]
        if rec_f16:
            rel = jnp.where(keep, c_eff - c_eff[:, :1], jnp.inf)[:, :Kc]
            sc_out = rel.astype(jnp.float16)
        else:
            sc_out = jnp.where(keep, c_eff, BIG)[:, :Kc]
        return (s_eff[:, :Kc], sc_out, best,
                jnp.maximum(n_alive - Kc, 0), n_alive)

    def frame_step(carry, inputs):
        if record_full and rec_flat:
            tok_state, tok_score, fbst, fbsc, cursor, fovf = carry
        else:
            tok_state, tok_score = carry
        ll_t, mask_t = inputs                  # [B, P], [B]
        m = mask_t[:, None]
        st, sc, rec, il, ovf = emit_round(tok_state, tok_score, ll_t)
        recs = [rec]
        il_emit = il
        full = [(st, sc)]
        for _ in range(n_eps):
            st, sc, rec, _il, ovf_z = eps_round(st, sc)
            recs.append(rec)
            full.append((st, sc))
            ovf = ovf + ovf_z
        out_state = jnp.where(m, st, tok_state)
        out_score = jnp.where(m, sc, tok_score)
        # frontier saturation: the worst slot alive means max_active
        # bound the search this frame (frontier is score-sorted)
        sat = mask_t & (sc[:, -1] < BIG * 0.5)
        # occupancy: alive tokens after this frame's rounds (0 when the
        # utterance already ended)
        n_act = jnp.where(mask_t,
                          jnp.sum(sc < BIG * 0.5, axis=1,
                                  dtype=jnp.int32), 0)
        if record_full:
            # lattice extraction re-derives links from the frontier
            # snapshots, so backpointer records are neither produced nor
            # shipped device->host.
            # Each snapshot is compacted on device (compact_rec) before
            # it enters the scan outputs — HBM and fetch cost scale
            # with Kc, not K.
            trunc = jnp.zeros(B, jnp.int32)
            if rec_flat:
                # bin-pack the alive prefix of each snapshot into a flat
                # per-utterance buffer: the frontier is score-sorted, so
                # within-rec_beam slots are a contiguous prefix; writing
                # a fixed Kc-slot window at a cursor that advances only
                # by the alive count lets the next round overwrite the
                # dead tail — no scatter, and the host link ships the
                # packed buffer (~mean-occupancy slots/frame) instead of
                # a Kc-padded one
                cnt_l, cb_l = [], []
                for (s, c) in full:
                    s_c, c_c, b_c, tr, n_alive = compact_rec(
                        jnp.where(m, s, tok_state),
                        jnp.where(m, c, tok_score))
                    w = jnp.where(mask_t, jnp.minimum(n_alive, Kc), 0)
                    safe = jnp.minimum(cursor, CAPB - Kc)
                    fovf = fovf | (mask_t & (cursor > CAPB - Kc))
                    upd = jax.vmap(
                        lambda buf, v, s0: jax.lax.
                        dynamic_update_slice_in_dim(buf, v, s0, axis=0))
                    fbst = upd(fbst, s_c, safe)
                    fbsc = upd(fbsc, c_c, safe)
                    cursor = cursor + w
                    cnt_l.append(w)
                    cb_l.append(b_c)
                    trunc = trunc + jnp.where(mask_t, tr, 0)
                ys = (jnp.where(mask_t, ovf, 0), sat, jnp.stack(cnt_l),
                      trunc, n_act, jnp.stack(cb_l))
                return (out_state, out_score, fbst, fbsc, cursor,
                        fovf), ys
            cs_l, cc_l, cb_l = [], [], []
            for (s, c) in full:
                s_c, c_c, b_c, tr, _na = compact_rec(
                    jnp.where(m, s, tok_state),
                    jnp.where(m, c, tok_score))
                cs_l.append(s_c)
                cc_l.append(c_c)
                cb_l.append(b_c)
                trunc = trunc + jnp.where(mask_t, tr, 0)
            ys = (jnp.where(mask_t, ovf, 0), sat, jnp.stack(cs_l),
                  jnp.stack(cc_l), trunc, n_act, jnp.stack(cb_l))
        else:
            recs = jnp.stack([jnp.where(m, r, self_prev) for r in recs])
            il_emit = jnp.where(m, il_emit, 0)
            ys = (recs, il_emit, jnp.where(mask_t, ovf, 0), sat, n_act)
        return (out_state, out_score), ys

    tok_state = jnp.zeros((B, K), jnp.int32).at[:, 0].set(start)
    tok_score = jnp.full((B, K), BIG).at[:, 0].set(0.0)
    init_recs = []
    init_full = []
    st, sc = tok_state, tok_score
    for _ in range(n_eps):
        st, sc, rec, _il, _ovf = eps_round(st, sc)
        init_recs.append(rec)
        init_full.append((st, sc))
    init_recs = (jnp.stack(init_recs, axis=1) if init_recs
                 else jnp.zeros((B, 0, K), jnp.int32))
    rec_dtype = jnp.float16 if rec_f16 else jnp.float32
    carry0 = (st, sc)
    if record_full and rec_flat:
        carry0 = (st, sc,
                  jnp.zeros((B, CAPB), jnp.int32),
                  jnp.full((B, CAPB), np.inf if rec_f16 else BIG,
                           rec_dtype),
                  jnp.zeros(B, jnp.int32), jnp.zeros(B, bool))
    carry_out, ys = jax.lax.scan(
        frame_step, carry0,
        (jnp.moveaxis(ll, 1, 0), jnp.moveaxis(frame_mask, 1, 0)))
    fs, fsc = carry_out[0], carry_out[1]
    if record_full:
        ovf, sat = ys[0], ys[1]
        n_act = ys[4] if rec_flat else ys[5]
    else:
        recs, il_emit, ovf, sat, n_act = ys     # [T,R,B,K],[T,B,K],[T,B]
        recs = jnp.moveaxis(recs, 2, 0)         # [B, T, R, K]
        il_emit = jnp.moveaxis(il_emit, 1, 0)   # [B, T, K]
    act_sum = jnp.sum(n_act, axis=0)                     # [B] (int32:
    #   T * K stays well under 2^31 at any supported shape)
    act_max = jnp.max(n_act, axis=0)                     # [B]
    total = fsc + final[fs]
    best_final_slot = jnp.argmin(total, axis=1)
    best_final_cost = jnp.take_along_axis(
        total, best_final_slot[:, None], axis=1)[:, 0]
    best_any_slot = jnp.argmin(fsc, axis=1)
    best_any_cost = jnp.take_along_axis(
        fsc, best_any_slot[:, None], axis=1)[:, 0]
    reached_final = best_final_cost < BIG * 0.5
    best_slot = jnp.where(reached_final, best_final_slot,
                          best_any_slot).astype(jnp.int32)
    best_cost = jnp.where(reached_final, best_final_cost, best_any_cost)
    if record_full:
        if init_full:
            ic = [compact_rec(s, c) for (s, c) in init_full]
            ist = jnp.stack([s for (s, _c, _b, _t, _n) in ic], axis=1)
            isc = jnp.stack([c for (_s, c, _b, _t, _n) in ic], axis=1)
            ibest = jnp.stack([b for (_s, _c, b, _t, _n) in ic], axis=1)
            init_trunc = sum(t for (_s, _c, _b, t, _n) in ic)
        else:
            ist = jnp.zeros((B, 0, Kc), jnp.int32)
            isc = jnp.zeros((B, 0, Kc), rec_dtype)
            ibest = jnp.zeros((B, 0), jnp.float32)
            init_trunc = jnp.zeros(B, jnp.int32)
        if rec_flat:
            _st_, _sc_, fbst, fbsc, cursor, fovf = carry_out
            counts = jnp.moveaxis(ys[2], 2, 0)     # [B, T, R]
            fbest = jnp.moveaxis(ys[5], 2, 0)      # [B, T, R]
            rec_trunc = jnp.sum(ys[3], axis=0) + init_trunc
            return (fs, fsc, best_slot, best_cost, jnp.sum(ovf, axis=0),
                    jnp.any(sat, axis=0), ist, isc, counts, fbst, fbsc,
                    rec_trunc, act_sum, act_max, fbest, ibest, fovf,
                    cursor)
        fst = jnp.moveaxis(ys[2], 2, 0)         # [B, T, R, Kc]
        fsc_r = jnp.moveaxis(ys[3], 2, 0)
        fbest = jnp.moveaxis(ys[6], 2, 0)       # [B, T, R]
        rec_trunc = jnp.sum(ys[4], axis=0) + init_trunc   # [B]
        return (fs, fsc, best_slot, best_cost, jnp.sum(ovf, axis=0),
                jnp.any(sat, axis=0), ist, isc, fst, fsc_r, rec_trunc,
                act_sum, act_max, fbest, ibest)
    return (init_recs, recs, il_emit, fs, fsc, best_slot, best_cost,
            jnp.sum(ovf, axis=0), jnp.any(sat, axis=0), act_sum, act_max)


@functools.partial(
    jax.jit,
    static_argnames=("start", "K", "CB", "CZ", "n_eps", "beam",
                     "hub_bounds", "HC", "b_apr"))
def _csr_decode_traced(
    ll, frame_mask, srow, zrow, brow, zbrow, final,
    hub_state_arr, hub_rows, hub_cost, hub_onehot, hub_gpdf, hub_pdf,
    start: int, K: int, CB: int, CZ: int, n_eps: int, beam: float,
    hub_bounds: tuple, HC: int | None = None, b_apr: int = 3,
):
    """Decode + on-device traceback -> ([B,T,R] olabels, [B,T] tids,
    [B,R0] init olabels, [B] cost, [B] overflow, [B] saturated,
    [B] active-token sum, [B] active-token max)."""
    (init_recs, recs, il_emit, fs, fsc, best_slot, best_cost,
     ovf, sat, act_sum, act_max) = _csr_decode(
        ll, frame_mask, srow, zrow, brow, zbrow, final,
        hub_state_arr, hub_rows, hub_cost, hub_onehot, hub_gpdf, hub_pdf,
        start, K, CB, CZ, n_eps, beam, hub_bounds, False, HC=HC,
        b_apr=b_apr)
    kbits = max((K - 1).bit_length(), 1)
    kmask = np.int32((1 << kbits) - 1)
    R = 1 + n_eps
    R0 = init_recs.shape[1]

    def trace_one(recs_b, il_b, init_b, slot0):
        def step(slot, inputs):
            rec_t, il_t = inputs          # [R, K], [K]
            ols = [None] * R
            s = slot
            il = jnp.int32(0)
            for r in range(R - 1, -1, -1):
                if r == 0:
                    il = il_t[s]
                pr = rec_t[r, s]
                ols[r] = pr >> kbits
                s = pr & kmask
            return s, (jnp.stack(ols), il)

        s0, (ols, ils) = jax.lax.scan(step, slot0, (recs_b, il_b),
                                      reverse=True)
        init_ols = [jnp.int32(0)] * R0
        for r in range(R0 - 1, -1, -1):
            pr = init_b[r, s0]
            init_ols[r] = pr >> kbits
            s0 = pr & kmask
        init_ols = (jnp.stack(init_ols) if R0
                    else jnp.zeros((0,), jnp.int32))
        return ols, ils, init_ols

    ols, ils, init_ols = jax.vmap(trace_one)(recs, il_emit, init_recs,
                                             best_slot)
    return ols, ils, init_ols, best_cost, ovf, sat, act_sum, act_max


class CsrBeamDecoder:
    """Host wrapper: tier-pack the graph once, decode utterance batches.

    Handles graphs the padded-dense BeamSearchDecoder cannot: memory is
    O(arcs) regardless of max out-degree, so multimillion-state HCLG
    with vocab-size fan-out at LM states decodes in one jit program."""

    def __init__(self, graph: PackedGraph, opts: CsrBeamOpts = CsrBeamOpts()):
        from kaldi_tpu.decoder.beam_search import resolve_eps_rounds
        from kaldi_tpu.decoder.graph_pack import fold_epsilons
        assert graph.pdf is not None, (
            "PackedGraph has no tid->pdf mapping: pack_graph() must be "
            "given tid_to_pdf for decoding")
        if opts.fold_eps:
            folded = fold_epsilons(graph)
            if folded is not None:
                graph = folded     # eps rounds resolve to 0 below
        self.graph = graph
        opts = dataclasses.replace(
            opts,
            eps_expansions=resolve_eps_rounds(graph, opts.eps_expansions),
            expand_budget=max(opts.expand_budget, opts.max_active),
            eps_budget=max(opts.eps_budget, 256))
        self.opts = opts
        csr = split_csr(graph)
        self.csr = csr          # host-side CSR kept for lattice extraction
        kbits = max((opts.max_active - 1).bit_length(), 1)
        if csr.max_olabel >= (1 << (31 - kbits)):
            raise ValueError(
                f"olabel range {csr.max_olabel} too large to pack with "
                f"max_active={opts.max_active}")
        self.tabs = build_tier_tables(csr, opts.hub_threshold,
                                      force_triple=opts.force_b_triple)
        t = self.tabs
        self._hub_state_arr = jnp.asarray(
            t.hub_states.astype(np.int32) if t.hub_states.size
            else np.full(1, -1, np.int32))
        self.last_overflow: np.ndarray | None = None   # [B] dropped arcs
        self.last_saturated: np.ndarray | None = None  # [B] cap ever hit
        self.last_active_sum: np.ndarray | None = None  # [B] sum over
        #   frames of alive tokens (mean occupancy = sum / num_frames)
        self.last_active_max: np.ndarray | None = None  # [B] peak alive
        self.last_rec_trunc: np.ndarray | None = None   # [B] alive slots
        #   dropped by record compaction (decode_raw path only)
        self.last_flat_fallbacks = 0    # batches re-decoded dense after
        #   a rec_flat buffer overflow (cumulative)

    def _args(self, ll, mask):
        t = self.tabs
        o = self.opts
        return (ll, mask, t.srow, t.zrow, t.brow, t.zbrow, t.final,
                self._hub_state_arr, t.hub_rows, t.hub_cost,
                t.hub_onehot, t.hub_gpdf, t.hub_pdf,
                int(self.csr.start), int(o.max_active),
                int(o.expand_budget), int(o.eps_budget),
                int(o.eps_expansions), float(o.beam),
                t.hub_bounds)

    @property
    def _hc(self):
        o = self.opts
        return None if o.hub_cap is None else int(o.hub_cap)

    def decode_async(self, loglikes, num_frames: np.ndarray):
        """Dispatch the decode+traceback program; returns a finisher
        producing per-utterance (words, tids, total_cost) — one
        device->host transfer at finish time."""
        from kaldi_tpu.decoder.dense import _device_mask, _parse_label_seqs
        from kaldi_tpu.decoder.hostpack import pack4, unpack4
        o = self.opts
        B, T, P = loglikes.shape
        nf = np.asarray(num_frames)
        mask = _device_mask(nf, T)
        ll = jnp.asarray(loglikes) * o.acoustic_scale
        (ols, ils, init_ols, cost, ovf, sat, act_sum,
         act_max) = _csr_decode_traced(*self._args(ll, mask),
                                      HC=self._hc,
                                      b_apr=self.tabs.b_apr)
        packed, shapes = pack4(ols, ils[..., None], init_ols, cost)
        from kaldi_tpu.decoder.hostpack import fetch_tree_async
        stats_fetch = fetch_tree_async((ovf, sat, act_sum, act_max))

        def finish():
            o_, i_, n_, c_ = unpack4(np.asarray(packed), shapes)
            (self.last_overflow, self.last_saturated,
             self.last_active_sum, self.last_active_max) = stats_fetch()
            return _parse_label_seqs(o_, i_, n_, c_, nf)

        return finish

    def decode(self, loglikes, num_frames: np.ndarray):
        return self.decode_async(loglikes, num_frames)()

    def decode_raw_async(self, loglikes, num_frames: np.ndarray):
        """Dispatch a full-record decode for lattice generation; returns
        a finisher producing the record dict (ONE blocking device->host
        transfer at finish time). Delaying the fetch lets the device run
        the NEXT batch's decode while this batch's records ship — the
        overlap decode_to_lattices_stream builds its pipeline on."""
        from kaldi_tpu.decoder.dense import _device_mask
        o = self.opts
        B, T, P = loglikes.shape
        nf = np.asarray(num_frames)
        mask = _device_mask(nf, T)
        ll_scaled = np.asarray(loglikes) * o.acoustic_scale
        Kc = min(o.rec_cap or o.max_active, o.max_active)
        rec_beam = o.rec_beam if o.rec_beam is not None else o.beam
        R = 1 + int(o.eps_expansions)
        CAPB = max(int(o.rec_flat_cap) * T * R, 2 * Kc) if o.rec_flat \
            else 0
        out = _csr_decode(*self._args(jnp.asarray(ll_scaled), mask), True,
                          Kc=Kc, rec_beam=float(rec_beam),
                          rec_f16=bool(o.rec_f16),
                          rec_flat=bool(o.rec_flat), CAPB=CAPB,
                          HC=self._hc, b_apr=self.tabs.b_apr)
        # ONE device->host transfer for the whole record set
        from kaldi_tpu.decoder.hostpack import fetch_tree_async
        fetch = fetch_tree_async(out)

        def _expand_init(isc, ibest):
            if o.rec_f16:
                isc = isc.astype(np.float32) + ibest[..., None]
                isc = np.where(np.isfinite(isc), isc, np.float32(BIG))
            return isc

        def finish_flat():
            (fs, fsc, best_slot, best_cost, ovf, sat, ist, isc, counts,
             fbst, fbsc, rec_trunc, act_sum, act_max, fbest, ibest,
             fovf, _cursor) = fetch()
            if fovf.any():
                # flat buffer overflowed for some utterance: fall back
                # to the dense record format for this batch (exact, just
                # more wire bytes) and remember the event
                self.last_flat_fallbacks += int(fovf.sum())
                dense = dataclasses.replace(o, rec_flat=False)
                saved, self.opts = self.opts, dense
                try:
                    return self.decode_raw_async(loglikes, nf)()
                finally:
                    self.opts = saved
            self.last_overflow = ovf
            self.last_saturated = sat
            self.last_rec_trunc = rec_trunc
            self.last_active_sum = act_sum
            self.last_active_max = act_max
            # rebuild the dense [B, T, R, Keff] view from the packed
            # alive prefixes (vectorized; Keff = widest snapshot, which
            # is far below rec_cap on typical batches)
            Keff = max(int(counts.max()), 1)
            fst = np.zeros((B, T * R, Keff), np.int32)
            fsc_r = np.full((B, T * R, Keff), BIG, np.float32)
            for b in range(B):
                cb = counts[b].reshape(-1).astype(np.int64)
                off = np.concatenate([[0], np.cumsum(cb)])
                tot = int(off[-1])
                rows = np.repeat(np.arange(T * R), cb)
                ks = np.arange(tot) - off[:-1].repeat(cb)
                fst[b, rows, ks] = fbst[b, :tot]
                sc = fbsc[b, :tot].astype(np.float32)
                if o.rec_f16:
                    sc = sc + fbest[b].reshape(-1)[rows]
                fsc_r[b, rows, ks] = sc
            return dict(
                init_states=ist,
                init_scores=_expand_init(isc, ibest),   # [B, R0, Kc]
                states=fst.reshape(B, T, R, Keff),
                scores=fsc_r.reshape(B, T, R, Keff),
                final_states=fs, final_scores=fsc,      # [B, K]
                best_slot=best_slot, best_cost=best_cost,
                rec_trunc=rec_trunc,
                rec_wire_slots=int(_cursor.sum()),
                ll_scaled=ll_scaled)

        def finish():
            (fs, fsc, best_slot, best_cost, ovf, sat, ist, isc, fst,
             fsc_r, rec_trunc, act_sum, act_max, fbest, ibest) = fetch()
            self.last_overflow = ovf
            self.last_saturated = sat
            self.last_rec_trunc = rec_trunc
            self.last_active_sum = act_sum
            self.last_active_max = act_max
            if o.rec_f16:
                # reconstruct absolute f32 scores: rel + per-round best
                # (masked slots were +inf; map back to the BIG sentinel)
                fsc_r = fsc_r.astype(np.float32) + fbest[..., None]
                fsc_r = np.where(np.isfinite(fsc_r), fsc_r,
                                 np.float32(BIG))
            return dict(
                init_states=ist,
                init_scores=_expand_init(isc, ibest),   # [B, R0, Kc]
                states=fst, scores=fsc_r,               # [B, T, R, Kc]
                final_states=fs, final_scores=fsc,      # [B, K]
                best_slot=best_slot, best_cost=best_cost,
                rec_trunc=rec_trunc,
                ll_scaled=ll_scaled)

        return finish_flat if o.rec_flat else finish

    def decode_raw(self, loglikes, num_frames: np.ndarray):
        """Full-record decode for lattice generation: returns a dict with
        per-round frontier snapshots (states/scores) — the input of
        lat.generate.raw_lattice_from_decode."""
        return self.decode_raw_async(loglikes, num_frames)()


@functools.partial(
    jax.jit,
    static_argnames=("start", "K", "CB", "CZ", "n_eps", "beam",
                     "hub_bounds", "HC", "b_apr"),
    donate_argnums=(0,))
def _csr_chunk_step(
    carry,          # (st [B,K], sc [B,K], arena [B,Tp,R,K], ilar [B,Tp,K])
    ll_chunk,       # [B, Tc, P] scaled loglikes
    mask_chunk,     # [B, Tc]
    t0,             # scalar int32 global frame offset of this chunk
    srow, zrow, brow, zbrow, final,
    hub_state_arr, hub_rows, hub_cost, hub_onehot, hub_gpdf, hub_pdf,
    start: int, K: int, CB: int, CZ: int, n_eps: int, beam: float,
    hub_bounds: tuple, HC: int | None = None, b_apr: int = 3,
):
    """One chunk of the incremental offline decode: advance the carried
    frontier Tc frames, writing backpointer records into the
    device-resident arena at frame offset t0 (the fused streaming
    decoder's arena pattern applied to offline batches). Returns
    (carry', (sat [B] any-frame-saturated, ovf [B] dropped arcs,
    act_sum [B], act_max [B]))."""
    st, sc, arena, ilar = carry
    B, Tc, P = ll_chunk.shape
    emit_round, eps_round = _make_rounds(
        srow, zrow, brow, zbrow, hub_state_arr, hub_rows, hub_cost,
        hub_onehot, hub_gpdf, hub_pdf, hub_bounds, B, K, CB, CZ, beam,
        HC, b_apr)
    self_prev = jnp.broadcast_to(jnp.arange(K, dtype=jnp.int32)[None, :],
                                 (B, K))

    def frame_step(carry_f, inputs):
        tok_state, tok_score = carry_f
        ll_t, mask_t = inputs
        m = mask_t[:, None]
        st_, sc_, rec, il, ovf = emit_round(tok_state, tok_score, ll_t)
        recs = [rec]
        for _ in range(n_eps):
            st_, sc_, rec, _il, ovf_z = eps_round(st_, sc_)
            recs.append(rec)
            ovf = ovf + ovf_z
        out_state = jnp.where(m, st_, tok_state)
        out_score = jnp.where(m, sc_, tok_score)
        sat = mask_t & (sc_[:, -1] < BIG * 0.5)
        n_act = jnp.where(mask_t,
                          jnp.sum(sc_ < BIG * 0.5, axis=1,
                                  dtype=jnp.int32), 0)
        recs = jnp.stack([jnp.where(m, r, self_prev) for r in recs])
        il_emit = jnp.where(m, il, 0)
        return (out_state, out_score), \
            (recs, il_emit, jnp.where(mask_t, ovf, 0), sat, n_act)

    (st, sc), (recs, il_emit, ovf, sat, n_act) = jax.lax.scan(
        frame_step, (st, sc),
        (jnp.moveaxis(ll_chunk, 1, 0), jnp.moveaxis(mask_chunk, 1, 0)))
    arena = jax.lax.dynamic_update_slice_in_dim(
        arena, jnp.moveaxis(recs, 2, 0), t0, axis=1)    # [B, Tp, R, K]
    ilar = jax.lax.dynamic_update_slice_in_dim(
        ilar, jnp.moveaxis(il_emit, 1, 0), t0, axis=1)  # [B, Tp, K]
    return (st, sc, arena, ilar), \
        (jnp.any(sat, axis=0), jnp.sum(ovf, axis=0),
         jnp.sum(n_act, axis=0), jnp.max(n_act, axis=0))


@functools.partial(
    jax.jit,
    static_argnames=("K", "n_eps"))
def _csr_chunk_trace(carry, init_recs, final, K: int, n_eps: int):
    """On-device traceback over the chunk decoder's arena; mirrors
    _csr_decode_traced exactly (untouched arena rows are identity
    records, so no frame gating is needed)."""
    st, sc, arena, ilar = carry
    kbits = max((K - 1).bit_length(), 1)
    kmask = np.int32((1 << kbits) - 1)
    R = 1 + n_eps
    R0 = init_recs.shape[1]
    total = sc + final[st]
    best_final_slot = jnp.argmin(total, axis=1)
    best_final_cost = jnp.take_along_axis(
        total, best_final_slot[:, None], axis=1)[:, 0]
    best_any_slot = jnp.argmin(sc, axis=1)
    best_any_cost = jnp.take_along_axis(
        sc, best_any_slot[:, None], axis=1)[:, 0]
    ok = best_final_cost < BIG * 0.5
    best_slot = jnp.where(ok, best_final_slot,
                          best_any_slot).astype(jnp.int32)
    best_cost = jnp.where(ok, best_final_cost, best_any_cost)

    def trace_one(recs_b, il_b, init_b, slot0):
        def step(slot, inputs):
            rec_t, il_t = inputs
            ols = [None] * R
            s = slot
            il = jnp.int32(0)
            for r in range(R - 1, -1, -1):
                if r == 0:
                    il = il_t[s]
                pr = rec_t[r, s]
                ols[r] = pr >> kbits
                s = pr & kmask
            return s, (jnp.stack(ols), il)

        s0, (ols, ils) = jax.lax.scan(step, slot0, (recs_b, il_b),
                                      reverse=True)
        init_ols = [jnp.int32(0)] * R0
        for r in range(R0 - 1, -1, -1):
            pr = init_b[r, s0]
            init_ols[r] = pr >> kbits
            s0 = pr & kmask
        init_ols = (jnp.stack(init_ols) if R0
                    else jnp.zeros((0,), jnp.int32))
        return ols, ils, init_ols

    ols, ils, init_ols = jax.vmap(trace_one)(arena, ilar, init_recs,
                                             best_slot)
    return ols, ils, init_ols, best_cost


class ChunkedCsrBeamDecoder:
    """Incremental offline decode: the utterance batch advances in
    Tc-frame chunks with the frontier and backpointer arena resident on
    device, so the host sees per-chunk saturation/overflow flags (a few
    bytes) while the search runs — and a caller can STOP the decode
    between chunks.

    This is the detection half of adaptive-capacity decoding: the
    AdaptiveCsrBeamDecoder runs its small-K program chunked and aborts
    as soon as every utterance has disqualified itself (saturated
    frontier or budget overflow), capping the adaptive worst case near
    one full-K decode instead of small + full. Chunking changes no
    numerics: the per-frame program is _make_rounds exactly, and
    chunked == one-shot is asserted bit-exact in tests."""

    def __init__(self, graph: PackedGraph,
                 opts: CsrBeamOpts = CsrBeamOpts(),
                 chunk_frames: int = 128):
        self._dec = CsrBeamDecoder(graph, opts)
        self.graph = graph
        self.opts = self._dec.opts
        self.Tc = int(chunk_frames)
        self.tabs = self._dec.tabs
        self.last_overflow: np.ndarray | None = None
        self.last_saturated: np.ndarray | None = None
        self.last_active_sum: np.ndarray | None = None
        self.last_active_max: np.ndarray | None = None
        self.chunks_run = 0          # chunks executed by the last decode

    def _static_args(self):
        o, t = self.opts, self.tabs
        return dict(start=int(self._dec.csr.start), K=int(o.max_active),
                    CB=int(o.expand_budget), CZ=int(o.eps_budget),
                    n_eps=int(o.eps_expansions), beam=float(o.beam),
                    hub_bounds=t.hub_bounds, HC=self._dec._hc,
                    b_apr=t.b_apr)

    def decode_async(self, loglikes, num_frames: np.ndarray,
                     stop_when=None):
        """Chunked decode. stop_when: optional callable
        (sat_cum [B] bool, ovf_cum [B] int) -> bool evaluated after each
        chunk's flags arrive; True aborts the remaining chunks (results
        are then only meaningful for the caller's escalation logic).
        Returns a finisher -> per-utterance (words, tids, cost)."""
        from kaldi_tpu.decoder.dense import _device_mask, _parse_label_seqs
        from kaldi_tpu.decoder.hostpack import pack4, unpack4
        o = self.opts
        t = self.tabs
        K = int(o.max_active)
        B, T, P = loglikes.shape
        Tc = self.Tc
        n_chunks = -(-T // Tc)
        Tp = n_chunks * Tc
        nf = np.asarray(num_frames)
        ll = jnp.asarray(loglikes) * o.acoustic_scale
        if Tp != T:
            ll = jnp.pad(ll, ((0, 0), (0, Tp - T), (0, 0)))
        mask = _device_mask(nf, Tp)
        R = 1 + int(o.eps_expansions)
        sargs = self._static_args()

        # init frontier + init eps records (once)
        st = jnp.zeros((B, K), jnp.int32).at[:, 0].set(sargs["start"])
        sc = jnp.full((B, K), BIG).at[:, 0].set(0.0)
        emit_round, eps_round = _make_rounds(
            t.srow, t.zrow, t.brow, t.zbrow, self._dec._hub_state_arr,
            t.hub_rows, t.hub_cost, t.hub_onehot, t.hub_gpdf, t.hub_pdf,
            t.hub_bounds, B, K, sargs["CB"], sargs["CZ"], sargs["beam"],
            sargs["HC"], sargs["b_apr"])
        init_recs = []
        for _ in range(sargs["n_eps"]):
            st, sc, rec, _il, _ovf = jax.jit(eps_round)(st, sc)
            init_recs.append(rec)
        init_recs = (jnp.stack(init_recs, axis=1) if init_recs
                     else jnp.zeros((B, 0, K), jnp.int32))
        self_prev = jnp.broadcast_to(
            jnp.arange(K, dtype=jnp.int32)[None, None, None, :],
            (B, Tp, R, K))
        carry = (st, sc, jnp.asarray(self_prev),
                 jnp.zeros((B, Tp, K), jnp.int32))

        sat_cum = np.zeros(B, bool)
        ovf_cum = np.zeros(B, np.int64)
        act_sum = np.zeros(B, np.int64)
        act_max = np.zeros(B, np.int64)
        pending = None      # (flags tuple of device arrays)
        self.chunks_run = 0

        def absorb(flags):
            nonlocal sat_cum, ovf_cum, act_sum, act_max
            s_, o_, asum, amax = [np.asarray(x) for x in flags]
            sat_cum |= s_
            ovf_cum += o_
            act_sum += asum
            np.maximum(act_max, amax, out=act_max)

        aborted = False
        for c in range(n_chunks):
            lo = c * Tc
            carry, flags = _csr_chunk_step(
                carry, jax.lax.slice_in_dim(ll, lo, lo + Tc, axis=1),
                jax.lax.slice_in_dim(mask, lo, lo + Tc, axis=1),
                jnp.asarray(lo, jnp.int32),
                t.srow, t.zrow, t.brow, t.zbrow, t.final,
                self._dec._hub_state_arr, t.hub_rows, t.hub_cost,
                t.hub_onehot, t.hub_gpdf, t.hub_pdf, **sargs)
            self.chunks_run += 1
            # pipeline: absorb the PREVIOUS chunk's flags while this one
            # runs, so the device never waits on the host round-trip
            if pending is not None:
                absorb(pending)
                if stop_when is not None and stop_when(sat_cum, ovf_cum):
                    aborted = True
                    break
            pending = flags
        if pending is not None and not aborted:
            absorb(pending)
            if stop_when is not None and stop_when(sat_cum, ovf_cum):
                aborted = True
        self.aborted = aborted

        ols, ils, init_ols, cost = _csr_chunk_trace(
            carry, init_recs, t.final, K=K, n_eps=sargs["n_eps"])
        packed, shapes = pack4(ols, ils[..., None], init_ols, cost)

        def finish():
            from kaldi_tpu.decoder.hostpack import unpack4 as _u
            o_, i_, n_, c_ = _u(np.asarray(packed), shapes)
            self.last_overflow = ovf_cum
            self.last_saturated = sat_cum
            self.last_active_sum = act_sum
            self.last_active_max = act_max
            return _parse_label_seqs(o_, i_, n_, c_, nf)

        return finish

    def decode(self, loglikes, num_frames: np.ndarray):
        return self.decode_async(loglikes, num_frames)()


class AdaptiveCsrBeamDecoder:
    """Two-tier serving wrapper: decode with a SMALL max_active program
    and transparently re-decode any utterance whose frontier saturated
    (or whose budget overflowed) with the full-capacity program.

    Guarantees results identical to decoding everything at
    `full_opts.max_active` — when the small frontier never fills, the
    small program's search is exactly the big one's (the cap never
    bound), and saturated utterances are re-run. Real acoustics are
    peaky (few active tokens), so most batches pay the small price; the
    static-shape cost of a jit program is O(max_active) whether or not
    tokens are alive, which is what this recovers.

    The small program runs CHUNKED (ChunkedCsrBeamDecoder) and ABORTS
    the moment every utterance in the batch has disqualified itself, so
    the worst case — a workload that saturates the small frontier from
    the first frames, like the calibrated bench corpus — costs one
    full-K decode plus one small chunk, not small + full. Escalation
    keeps the loglikes on device.
    (ref: the GetCutoff adaptive-beam idea of faster-decoder.cc:591,
    applied at program granularity under XLA's static shapes.)
    """

    def __init__(self, graph: PackedGraph,
                 full_opts: CsrBeamOpts = CsrBeamOpts(),
                 small_max_active: int = 1024,
                 small_expand_budget: int | None = None,
                 chunk_frames: int = 128):
        self.full = CsrBeamDecoder(graph, full_opts)
        small = dataclasses.replace(
            full_opts, max_active=small_max_active,
            expand_budget=(small_expand_budget
                           or max(small_max_active * 4, 4096)))
        self.small = ChunkedCsrBeamDecoder(graph, small,
                                           chunk_frames=chunk_frames)
        self.graph = graph
        self.opts = full_opts
        self.last_escalated: np.ndarray | None = None   # [B] bool
        self.last_small_chunks = 0   # chunks the small program executed

    def decode_async(self, loglikes, num_frames: np.ndarray):
        nf = np.asarray(num_frames)
        ll_dev = jnp.asarray(loglikes)    # keep acoustics device-resident
        B = ll_dev.shape[0]

        fin_small = self.small.decode_async(
            ll_dev, nf,
            stop_when=lambda sat, ovf: bool((sat | (ovf > 0)).all()))

        def finish():
            res = fin_small()
            self.last_small_chunks = self.small.chunks_run
            redo = (self.small.last_saturated.astype(bool)
                    | (self.small.last_overflow > 0))
            self.last_escalated = redo
            if redo.all():
                # whole batch escalates: reuse the full decoder's
                # already-compiled batch-B program directly
                return self.full.decode(ll_dev, nf)
            if redo.any():
                idx = np.flatnonzero(redo)
                ll_sub = jnp.take(ll_dev, jnp.asarray(idx), axis=0)
                res_big = self.full.decode(ll_sub, nf[idx])
                for j, b in enumerate(idx):
                    res[b] = res_big[j]
            return res

        return finish

    def decode(self, loglikes, num_frames: np.ndarray):
        return self.decode_async(loglikes, num_frames)()
