"""SimpleDecoder: slow, obviously-correct host-side Viterbi over HCLG.

(ref: decoder/simple-decoder.h:37 — kept solely as the correctness oracle
for the batched device decoder, mirroring the reference's test strategy of
keeping a simple baseline decoder, SURVEY.md §4.3.)
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from kaldi_tpu.decoder.graph_pack import PackedGraph


@dataclasses.dataclass
class _Token:
    cost: float
    words: tuple
    tids: tuple


def simple_decode(graph: PackedGraph, loglikes: np.ndarray,
                  acoustic_scale: float = 0.1, beam: float = 1e30):
    """loglikes [T, P] unscaled -> (words, tids, cost) or None."""
    ll = loglikes * acoustic_scale
    T = ll.shape[0]

    def eps_closure(tokens: dict):
        # relax over input-eps arcs to fixpoint
        agenda = list(tokens)
        while agenda:
            s = agenda.pop()
            tok = tokens[s]
            for a in range(graph.arc_start[s], graph.arc_start[s + 1]):
                if graph.ilabel[a] != 0:
                    continue
                d = int(graph.nextstate[a])
                c = tok.cost + float(graph.cost[a])
                w = tok.words + ((int(graph.olabel[a]),)
                                 if graph.olabel[a] != 0 else ())
                if d not in tokens or c < tokens[d].cost - 1e-12:
                    tokens[d] = _Token(c, w, tok.tids)
                    agenda.append(d)
        return tokens

    tokens = eps_closure({graph.start: _Token(0.0, (), ())})
    for t in range(T):
        new: dict = {}
        best = math.inf
        for s, tok in tokens.items():
            for a in range(graph.arc_start[s], graph.arc_start[s + 1]):
                if graph.ilabel[a] == 0:
                    continue
                pdf = int(graph.pdf[a])
                c = tok.cost + float(graph.cost[a]) - float(ll[t, pdf])
                if c > best + beam:
                    continue
                best = min(best, c)
                d = int(graph.nextstate[a])
                if d not in new or c < new[d].cost - 1e-12:
                    w = tok.words + ((int(graph.olabel[a]),)
                                     if graph.olabel[a] != 0 else ())
                    new[d] = _Token(c, w, tok.tids + (int(graph.ilabel[a]),))
        tokens = eps_closure(new)
        if not tokens:
            return None
    best_tok, best_cost = None, math.inf
    for s, tok in tokens.items():
        f = float(graph.final[s])
        if math.isfinite(f) and tok.cost + f < best_cost:
            best_cost = tok.cost + f
            best_tok = tok
    if best_tok is None:
        return None
    return list(best_tok.words), list(best_tok.tids), best_cost
