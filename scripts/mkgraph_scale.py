"""Build a production-scale HCLG through the full fst/ pipeline and
decode it at the reference operating point.

(ref: egs/wsj/s5/utils/mkgraph.sh — this demonstrates the repo's own
graph stack at 60k-word vocabulary, answering "does mkgraph scale":
synthetic lexicon + pruned trigram ARPA -> L∘G -> det* -> min ->
triphone C∘LG (native on-the-fly context composition over a ~5k-leaf
tied-triphone tree, the production configuration; --mono for the
monophone variant) -> Ha∘CLG -> det* -> min -> rm-disambig ->
self-loops -> pack -> CSR decode at beam=13/max_active=7000.

Usage: python scripts/mkgraph_scale.py [vocab] [out.json] [--mono] [--cache]
Stage 1 (host CPU): build + pack, save arrays to .cache/mkgraph_scale.npz
Stage 2 (GPU): decode the packed graph at headline settings.
--cache publishes the graph as .cache/selfbuilt_hclg.npz for bench.py.
"""

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
CACHE_DIR = os.path.join(REPO, ".cache")
GRAPH_NPZ = os.path.join(CACHE_DIR, "mkgraph_scale.npz")


def build(vocab=60000, n_bigrams=2_000_000, n_trigrams=1_000_000,
          context="tri", out_npz=GRAPH_NPZ):
    from kaldi_tpu.fst.lang import Lexicon, prepare_lang
    from kaldi_tpu.lm.arpa import arpa_to_g
    from kaldi_tpu.lm.synth import synth_lexicon_text, synth_trigram_arpa
    from kaldi_tpu.fst.mkgraph_flat import make_hclg_flat, pack_graph_flat
    from kaldi_tpu.tree.context_dep import MonophoneContextDependency
    from kaldi_tpu.tree.synth import synth_triphone_tree
    from kaldi_tpu.steps.deltas import transition_model_from_tree
    from kaldi_tpu.hmm.transition_model import TransitionModel

    rng = np.random.default_rng(0)
    stats = {"vocab": vocab, "context": context}
    t_all = time.time()
    text, words = synth_lexicon_text(vocab, n_phones=39, rng=rng)
    lm = synth_trigram_arpa(words, n_bigrams, n_trigrams, rng=rng)
    stats["ngrams"] = [len(d) for d in lm.ngrams]
    lex = Lexicon.parse(text)
    lang = prepare_lang(lex, ["SIL"], "SIL", num_sil_states=3)
    if context == "tri":
        # ~5k-leaf tied-triphone tree (40 phones x 3 classes x 6x7
        # context cells, silence context-independent) — the reference's
        # production regime, e.g. the sre10 5297-senone system
        ctx = synth_triphone_tree(lang.topo,
                                  sil_phones=[lang.phones["SIL"]],
                                  n_left_groups=6, n_right_groups=7,
                                  rng=rng)
        tm = transition_model_from_tree(lang, ctx)
    else:
        ctx = MonophoneContextDependency.from_topo(lang.topo)
        tm = TransitionModel(lang.topo, lambda ph, pc: ctx.compute([ph], pc))
    stats["num_pdfs"] = int(tm.num_pdfs)
    stats["num_tids"] = int(tm.num_transition_ids)
    t0 = time.time()
    g = arpa_to_g(lm, lang.words)
    stats["g_states"], stats["g_arcs"] = g.num_states, g.num_arcs
    stats["arpa_to_g_s"] = round(time.time() - t0, 1)
    t0 = time.time()
    hclg, st = make_hclg_flat(lang, g, tm, ctx, self_loop_scale=0.1,
                              verbose=True)
    stats.update(st)
    stats["mkgraph_s"] = round(time.time() - t0, 1)
    stats["total_build_s"] = round(time.time() - t_all, 1)
    packed = pack_graph_flat(hclg, tm.id2pdf_array)
    os.makedirs(os.path.dirname(os.path.abspath(out_npz)), exist_ok=True)
    np.savez(out_npz,
             arc_start=packed.arc_start, ilabel=packed.ilabel,
             olabel=packed.olabel, cost=packed.cost,
             nextstate=packed.nextstate, final=packed.final,
             start=packed.start, pdf=packed.pdf,
             num_pdfs=tm.num_pdfs)
    return stats


def decode(stats):
    from kaldi_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    from kaldi_tpu.decoder.graph_pack import PackedGraph
    from kaldi_tpu.decoder.csr_beam import CsrBeamDecoder, CsrBeamOpts

    z = np.load(GRAPH_NPZ)
    packed = PackedGraph(
        arc_start=z["arc_start"], ilabel=z["ilabel"], olabel=z["olabel"],
        cost=z["cost"], nextstate=z["nextstate"], final=z["final"],
        start=int(z["start"]), pdf=z["pdf"])
    P = int(z["num_pdfs"])
    t0 = time.time()
    dec = CsrBeamDecoder(packed, CsrBeamOpts(
        beam=13.0, max_active=7000, acoustic_scale=0.1,
        expand_budget=24576, eps_budget=4096))
    stats["tier_pack_s"] = round(time.time() - t0, 1)
    B, T = 8, 998
    rng = np.random.RandomState(0)
    ll = (rng.randn(B, T, P) * 2).astype(np.float32)
    nf = np.full(B, T, np.int32)
    fin = dec.decode_async(ll, nf)   # compile+run
    fin()
    t0 = time.time()
    n_iter = 3
    for _ in range(n_iter):
        dec.decode(ll, nf)
    dt = (time.time() - t0) / n_iter
    stats["decode_audio_per_s"] = round(B * T * 0.01 / dt, 2)
    stats["overflow_arcs"] = int(dec.last_overflow.sum())
    stats["occupancy_mean"] = round(float(dec.last_active_sum.sum())
                                    / (B * T), 1)
    return stats


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    context = "mono" if "--mono" in sys.argv else "tri"
    vocab = int(args[0]) if args else 60000
    out = args[1] if len(args) > 1 else os.path.join(CACHE_DIR,
                                                     "mkgraph_scale.json")
    stats = build(vocab, context=context)
    print(json.dumps(stats), flush=True)
    if "--cache" in sys.argv:
        # publish for bench.py's selfbuilt_graph line
        import shutil
        shutil.copy(GRAPH_NPZ, os.path.join(CACHE_DIR, "selfbuilt_hclg.npz"))
        with open(os.path.join(CACHE_DIR, "selfbuilt_hclg.stats.json"),
                  "w") as f:
            json.dump(stats, f)
    stats = decode(stats)
    with open(out, "w") as f:
        json.dump(stats, f, indent=1)
    print(json.dumps(stats))
