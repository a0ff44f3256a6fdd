"""Batched Viterbi alignment & beam-search decoding as tensor programs
(ref: src/decoder)."""

from kaldi_tpu.decoder.graph_pack import PackedGraph, pack_graph, pack_graphs
from kaldi_tpu.decoder.viterbi import viterbi_align, equal_align
from kaldi_tpu.decoder.graph_pack import split_csr, eps_depth
from kaldi_tpu.decoder.csr_beam import (CsrBeamDecoder, CsrBeamOpts,
                                        AdaptiveCsrBeamDecoder)
from kaldi_tpu.decoder.beam_search import BeamSearchDecoder, BeamSearchOpts
from kaldi_tpu.decoder.dense import (DenseViterbiDecoder, DenseDecoderOpts,
                                     make_decoder)
from kaldi_tpu.decoder.biggraph import make_big_hclg, BigGraphConfig
