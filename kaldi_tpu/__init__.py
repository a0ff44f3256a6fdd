"""kaldi_tpu — a hybrid speech recognition & speaker recognition framework.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of classic Kaldi
(the david-ryan-snyder fork; see SURVEY.md): feature extraction, GMM-HMM and
DNN acoustic models, decision-tree state tying, WFST decoding graphs, lattice
beam search, speaker adaptation, and i-vector/PLDA speaker recognition —
expressed as batched tensor programs over `[B, T, D]` arrays, data-parallel
over `jax.sharding.Mesh` device meshes.

Layering (mirrors the capability layers of the reference, SURVEY.md §1, but
collapsed into an idiomatic JAX design):

  ops/        feature extraction & math kernels (ref: src/feat, src/matrix)
  io/         keyed tables, ark/scp, wave I/O     (ref: src/util, src/feat/wave-reader)
  hmm/        topology, transition model          (ref: src/hmm)
  gmm/        diagonal/full GMMs + estimation     (ref: src/gmm)
  tree/       decision trees & clustering         (ref: src/tree)
  fst/        host-side WFST algebra & graphs     (ref: src/fstext + openfst usage)
  decoder/    batched Viterbi/lattice beam search (ref: src/decoder)
  lat/        lattice processing                  (ref: src/lat)
  lm/         ARPA language models                (ref: src/lm)
  nnet/       DNN/TDNN acoustic models            (ref: src/nnet2, src/nnet3)
  ivector/    i-vector extractor + PLDA           (ref: src/ivector)
  transform/  LDA/MLLT/fMLLR/CMVN                 (ref: src/transform)
  online/     streaming pipelines & endpointing   (ref: src/online2)
  parallel/   mesh & sharding utilities           (ref: utils/{run,queue}.pl roles)
  utils/      config, logging, WER scoring        (ref: src/util, src/bin)
"""

__version__ = "0.2.0"
