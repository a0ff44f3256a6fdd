"""Math & feature kernels: the tensor-program replacement for src/feat + src/matrix.

Everything here operates on batched arrays (leading batch dim optional via
vmap) with static shapes, jit-friendly control flow, and matmul-shaped inner
loops so XLA can tile them into matmuls.
"""

from kaldi_tpu.ops.window import (
    FrameOpts,
    num_frames,
    feature_window,
    frame_signal,
    extract_windows,
)
from kaldi_tpu.ops.mel import MelOpts, mel_scale, inverse_mel_scale, mel_banks
from kaldi_tpu.ops.dct import dct_matrix, lifter_coeffs
from kaldi_tpu.ops.features import (
    MfccOpts,
    FbankOpts,
    PlpOpts,
    SpectrogramOpts,
    mfcc,
    fbank,
    plp,
    spectrogram,
)
from kaldi_tpu.ops.delta import DeltaOpts, add_deltas, splice_frames, sliding_cmvn
