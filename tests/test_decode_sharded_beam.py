"""Sharded beam search: utterance sharding (GSPMD) and frontier sharding
(shard_map + all_gather) must equal single-device decoding exactly.

(ref: SURVEY.md §2.11 — job-array decode parallelism becomes a sharded
batch dim; the frontier exchange for giant graphs uses all_gather collectives.)
"""

import numpy as np
import pytest
import jax

from kaldi_tpu.decoder.biggraph import make_big_hclg, BigGraphConfig
from kaldi_tpu.decoder.csr_beam import CsrBeamDecoder, CsrBeamOpts
from kaldi_tpu.decoder.beam_search import BeamSearchDecoder, BeamSearchOpts
from kaldi_tpu.parallel.mesh import make_mesh, decode_sharded
from kaldi_tpu.parallel.frontier_decode import decode_frontier_sharded


@pytest.fixture(scope="module")
def graph():
    g, _ = make_big_hclg(BigGraphConfig(vocab=200, avg_bigram_succ=12,
                                        num_pdfs=48, seed=3))
    return g


@pytest.fixture(scope="module")
def ll_nf():
    rng = np.random.RandomState(11)
    B, T, P = 8, 40, 48
    ll = (rng.randn(B, T, P) * 3).astype(np.float32)
    nf = np.array([40, 30, 40, 25, 40, 40, 33, 40], np.int32)
    return ll, nf


def _same(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    assert a[0] == b[0]
    assert a[1] == b[1]
    assert abs(a[2] - b[2]) < 1e-2


@pytest.mark.slow
def test_utterance_sharded_beam_search(graph, ll_nf):
    """decode_sharded (GSPMD over 'data') == single for BeamSearchDecoder
    and CsrBeamDecoder."""
    ll, nf = ll_nf
    mesh = make_mesh(data=8, model=1)
    for dec in (
        BeamSearchDecoder(graph, BeamSearchOpts(
            beam=1e9, max_active=128, acoustic_scale=0.1)),
        CsrBeamDecoder(graph, CsrBeamOpts(
            beam=1e9, max_active=128, acoustic_scale=0.1,
            expand_budget=4096, eps_budget=512)),
    ):
        single = dec.decode(ll, nf)
        sharded = decode_sharded(dec, ll, nf, mesh)
        for b in range(len(nf)):
            _same(single[b], sharded[b])


def test_frontier_sharded_beam_search(graph, ll_nf):
    """Frontier-sharded decode (token slices per device, candidate
    all_gather over the mesh axis) == the unsharded CSR decoder."""
    ll, nf = ll_nf
    mesh = make_mesh(data=1, model=8)
    dec = CsrBeamDecoder(graph, CsrBeamOpts(
        beam=1e9, max_active=128, acoustic_scale=0.1,
        expand_budget=4096, eps_budget=512))
    single = dec.decode(ll[:2], nf[:2])
    sharded = decode_frontier_sharded(dec, ll[:2], nf[:2], mesh,
                                      axis="model")
    for b in range(2):
        _same(single[b], sharded[b])


def test_frontier_sharded_tier_b_eps(graph):
    """Regression (round-2 self-review): states with eps out-degree > 2
    (tier-B eps) were silently dropped by the frontier-sharded decoder.
    Build a graph whose start state has 3 eps arcs and assert parity."""
    from kaldi_tpu.decoder.graph_pack import PackedGraph
    # start 0 --eps x3--> {1,2,3}; each has an emitting self-loop and an
    # emitting arc to final state 4
    arc_start = np.array([0, 3, 5, 7, 9, 10], np.int32)
    il = np.array([0, 0, 0,  1, 2,  1, 3,  1, 4,  1], np.int32)
    ol = np.array([0, 0, 0,  0, 11, 0, 12, 0, 13, 0], np.int32)
    cost = np.array([0.1, 0.2, 0.3, 0.5, 0.6, 0.5, 0.6, 0.5, 0.6, 0.5],
                    np.float32)
    nxt = np.array([1, 2, 3,  1, 4,  2, 4,  3, 4,  4], np.int32)
    pdf = np.where(il > 0, il - 1, -1).astype(np.int32)
    final = np.array([np.inf, np.inf, np.inf, np.inf, 0.0], np.float32)
    g = PackedGraph(start=0, arc_start=arc_start, ilabel=il, olabel=ol,
                    cost=cost, nextstate=nxt, pdf=pdf, final=final)
    rng = np.random.RandomState(3)
    ll = (rng.randn(1, 6, 4) * 2).astype(np.float32)
    nf = np.array([6], np.int32)
    dec = CsrBeamDecoder(g, CsrBeamOpts(beam=1e9, max_active=8,
                                        acoustic_scale=1.0,
                                        expand_budget=64, eps_budget=64))
    single = dec.decode(ll, nf)
    mesh = make_mesh(data=1, model=8)
    sharded = decode_frontier_sharded(dec, ll, nf, mesh, axis="model")
    _same(single[0], sharded[0])
    assert sharded[0] is not None
    assert dec.last_overflow is not None and dec.last_overflow[0] == 0


@pytest.mark.slow
def test_frontier_sharded_large_frontier_matches_single(graph):
    """VERDICT r03 #8: frontier-sharding a genuinely LARGE frontier
    (K=4096) on the big graph must match the single-device decoder
    exactly, with the per-frame all_gather volume accounted."""
    from kaldi_tpu.decoder.csr_beam import CsrBeamDecoder, CsrBeamOpts
    rng = np.random.RandomState(21)
    B, T, P = 2, 25, 48
    # flat (noise) acoustics keep thousands of tokens alive -> the
    # frontier genuinely spans devices
    ll = (rng.randn(B, T, P) * 2).astype(np.float32)
    nf = np.array([25, 20], np.int32)
    K = 4096
    dec = CsrBeamDecoder(graph, CsrBeamOpts(
        beam=1e9, max_active=K, acoustic_scale=0.1,
        expand_budget=16384, eps_budget=2048))
    single = dec.decode(ll, nf)
    occupancy = int(dec.last_active_max.max())
    assert occupancy > 2048, occupancy   # the frontier really is large
    D = 8
    mesh = make_mesh(data=1, model=D)
    sharded = decode_frontier_sharded(dec, ll, nf, mesh, axis="model")
    for b in range(B):
        _same(single[b], sharded[b])

    # all_gather volume per emitting frame: 4 int32/f32 columns of the
    # full candidate union (tier A 2*K + tier B 3*ceil(CB/D/3)*D + hub
    # rank-slices K), gathered by every device
    Kl = K // D
    CBR = -(-(dec.opts.expand_budget // D) // 3)
    n_cands = 2 * K + 3 * CBR * D + (K if dec.tabs.hub_rows.shape[0] > 1
                                     else 0)
    gather_mb_per_frame = 4 * n_cands * 4 / 1e6
    # a 1.05M-state graph decode ships ~1 MB/frame between devices;
    # assert the accounting stays in that regime so regressions
    # surface
    assert gather_mb_per_frame < 4.0, gather_mb_per_frame
