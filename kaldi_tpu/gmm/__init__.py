"""GMM acoustic models (ref: src/gmm): diagonal/full GMMs, AM container,
MLE/MAP estimation — scoring is batched GEMMs."""

from kaldi_tpu.gmm.diag_gmm import DiagGmm
from kaldi_tpu.gmm.full_gmm import FullGmm
from kaldi_tpu.gmm.am_gmm import AmDiagGmm
from kaldi_tpu.gmm.estimation import (
    AccumDiagGmm,
    AccumAmDiagGmm,
    mle_diag_gmm_update,
    map_diag_gmm_update,
)
