"""Host-side WFST algebra — our own implementation, no OpenFst dependency.

(ref: src/fstext + OpenFst usage in utils/mkgraph.sh.) Graph construction
runs once per system on the host; the decode-time product is an immutable
CSR-packed arc table consumed by the batched beam-search decoder
(kaldi_tpu.decoder). Costs are negative log probabilities throughout.
"""

from kaldi_tpu.fst.fst import Fst, EPS, SymbolTable
from kaldi_tpu.fst.compose import compose, table_compose
from kaldi_tpu.fst.determinize import determinize_star
from kaldi_tpu.fst.minimize import minimize_encoded
from kaldi_tpu.fst.epsilon import remove_eps_local, remove_symbols, rm_epsilon
