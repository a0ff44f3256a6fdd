"""MFCC / fbank / PLP / spectrogram as fused batched XLA programs.

Behavioral parity with the reference computers
(ref: feat/feature-mfcc.cc:117-200 Mfcc::ComputeInternal,
 feat/feature-fbank.cc, feat/feature-plp.cc:160-260 Plp::ComputeInternal,
 feat/feature-spectrogram.cc), re-designed accelerator-first:

  * the whole utterance (or a batch of utterances) is framed with one gather,
  * FFT is one batched `jnp.fft.rfft` over a static power-of-two length,
  * mel filterbank and DCT are dense matmuls,
  * everything is fused by XLA under `jit`; there is no per-frame loop.

All compute is float32 (matching BaseFloat); inputs are int16-scale float
waveforms as produced by `kaldi_tpu.io.wave`.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from kaldi_tpu.ops.window import FrameOpts, extract_windows, num_frames
from kaldi_tpu.ops.mel import MelOpts, mel_banks, center_freqs
from kaldi_tpu.ops.dct import dct_matrix, lifter_coeffs

FLT_TINY = float(np.finfo(np.float32).tiny)

# Feature matmuls (mel bank, DCT, IDFT) are tiny compared to AM scoring but
# numerically load-bearing (they sit under a log); always run them in full
# f32, never in a reduced-precision default (TF32 on the GPU).
_HI = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=_HI)


@dataclasses.dataclass(frozen=True)
class MfccOpts:
    """(ref: feat/feature-mfcc.h:37-84 MfccOptions)"""

    frame_opts: FrameOpts = FrameOpts()
    mel_opts: MelOpts = MelOpts()
    num_ceps: int = 13
    use_energy: bool = True
    energy_floor: float = 0.0
    raw_energy: bool = True
    cepstral_lifter: float = 22.0
    htk_compat: bool = False

    @property
    def dim(self) -> int:
        return self.num_ceps


@dataclasses.dataclass(frozen=True)
class FbankOpts:
    """(ref: feat/feature-fbank.h FbankOptions)"""

    frame_opts: FrameOpts = FrameOpts()
    mel_opts: MelOpts = MelOpts()
    use_energy: bool = False
    energy_floor: float = 0.0
    raw_energy: bool = True
    htk_compat: bool = False
    use_log_fbank: bool = True

    @property
    def dim(self) -> int:
        return self.mel_opts.num_bins + (1 if self.use_energy else 0)


@dataclasses.dataclass(frozen=True)
class PlpOpts:
    """(ref: feat/feature-plp.h PlpOptions)"""

    frame_opts: FrameOpts = FrameOpts()
    mel_opts: MelOpts = MelOpts()
    lpc_order: int = 12
    num_ceps: int = 13
    use_energy: bool = True
    energy_floor: float = 0.0
    raw_energy: bool = True
    compress_factor: float = 0.33333
    cepstral_lifter: float = 22.0
    cepstral_scale: float = 1.0
    htk_compat: bool = False

    @property
    def dim(self) -> int:
        return self.num_ceps


@dataclasses.dataclass(frozen=True)
class SpectrogramOpts:
    """(ref: feat/feature-spectrogram.h SpectrogramOptions)"""

    frame_opts: FrameOpts = FrameOpts()
    energy_floor: float = 0.0
    raw_energy: bool = True


def _power_spectrum(windows: jnp.ndarray) -> jnp.ndarray:
    """[..., F, P] windowed frames -> [..., F, P/2+1] power spectrum."""
    spec = jnp.fft.rfft(windows, axis=-1)
    return jnp.square(jnp.real(spec)) + jnp.square(jnp.imag(spec))


def _window_energy(windows, opts_use_energy, raw_energy, raw_log_energy, win_len):
    """Log energy, either raw (pre-window) or post-window."""
    if not opts_use_energy:
        return None
    if raw_energy:
        return raw_log_energy
    e = jnp.maximum(jnp.sum(jnp.square(windows[..., :win_len]), axis=-1), FLT_TINY)
    return jnp.log(e)


def _apply_energy_floor(log_energy, energy_floor):
    if energy_floor > 0.0:
        return jnp.maximum(log_energy, math.log(energy_floor))
    return log_energy


def _htk_reorder(feats: jnp.ndarray, scale_c0: bool) -> jnp.ndarray:
    """Move element 0 to the end (HTK feature ordering)."""
    first = feats[..., :1]
    if scale_c0:
        first = first * math.sqrt(2.0)
    return jnp.concatenate([feats[..., 1:], first], axis=-1)


@functools.partial(jax.jit, static_argnames=("opts", "vtln_warp"))
def mfcc(
    wave: jnp.ndarray,
    opts: MfccOpts = MfccOpts(),
    vtln_warp: float = 1.0,
    dither_key: jax.Array | None = None,
) -> jnp.ndarray:
    """wave [..., S] -> mfcc [..., F, num_ceps]."""
    fo = opts.frame_opts
    windows, raw_le = extract_windows(
        wave, fo, dither_key, want_raw_energy=opts.use_energy and opts.raw_energy
    )
    log_energy = _window_energy(windows, opts.use_energy, opts.raw_energy,
                                raw_le, fo.window_size)
    power = _power_spectrum(windows)[..., : fo.padded_window_size // 2]
    banks = mel_banks(opts.mel_opts, fo, vtln_warp)
    mel_e = _mm(power, banks.T)
    if opts.mel_opts.htk_mode:
        mel_e = jnp.maximum(mel_e, 1.0)  # HTK-like flooring (ref: mel-computations.cc:231)
    log_mel = jnp.log(jnp.maximum(mel_e, FLT_TINY))
    dct = dct_matrix(opts.num_ceps, opts.mel_opts.num_bins)
    feats = _mm(log_mel, dct.T)
    if opts.cepstral_lifter != 0.0:
        feats = feats * lifter_coeffs(opts.cepstral_lifter, opts.num_ceps)
    if opts.use_energy:
        log_energy = _apply_energy_floor(log_energy, opts.energy_floor)
        feats = jnp.concatenate([log_energy[..., None], feats[..., 1:]], axis=-1)
    if opts.htk_compat:
        feats = _htk_reorder(feats, scale_c0=not opts.use_energy)
    return feats


@functools.partial(jax.jit, static_argnames=("opts", "vtln_warp"))
def fbank(
    wave: jnp.ndarray,
    opts: FbankOpts = FbankOpts(),
    vtln_warp: float = 1.0,
    dither_key: jax.Array | None = None,
) -> jnp.ndarray:
    """wave [..., S] -> (log-)mel filterbank [..., F, num_bins(+1)]."""
    fo = opts.frame_opts
    windows, raw_le = extract_windows(
        wave, fo, dither_key, want_raw_energy=opts.use_energy and opts.raw_energy
    )
    log_energy = _window_energy(windows, opts.use_energy, opts.raw_energy,
                                raw_le, fo.window_size)
    power = _power_spectrum(windows)[..., : fo.padded_window_size // 2]
    banks = mel_banks(opts.mel_opts, fo, vtln_warp)
    mel_e = _mm(power, banks.T)
    if opts.mel_opts.htk_mode:
        mel_e = jnp.maximum(mel_e, 1.0)
    if opts.use_log_fbank:
        mel_e = jnp.log(jnp.maximum(mel_e, FLT_TINY))
    if opts.use_energy:
        log_energy = _apply_energy_floor(log_energy, opts.energy_floor)
        # energy goes FIRST in kaldi mode, LAST in htk_compat mode
        if opts.htk_compat:
            return jnp.concatenate([mel_e, log_energy[..., None]], axis=-1)
        return jnp.concatenate([log_energy[..., None], mel_e], axis=-1)
    return mel_e


@functools.partial(jax.jit, static_argnames=("opts",))
def spectrogram(
    wave: jnp.ndarray,
    opts: SpectrogramOpts = SpectrogramOpts(),
    dither_key: jax.Array | None = None,
) -> jnp.ndarray:
    """wave [..., S] -> log power spectrogram [..., F, P/2+1] with log-energy at idx 0."""
    fo = opts.frame_opts
    windows, raw_le = extract_windows(wave, fo, dither_key,
                                      want_raw_energy=opts.raw_energy)
    log_energy = _window_energy(windows, True, opts.raw_energy, raw_le,
                                fo.window_size)
    log_energy = _apply_energy_floor(log_energy, opts.energy_floor)
    power = _power_spectrum(windows)
    log_power = jnp.log(jnp.maximum(power, FLT_TINY))
    return jnp.concatenate([log_energy[..., None], log_power[..., 1:]], axis=-1)


@functools.lru_cache(maxsize=None)
def _idft_bases_np(n_bases: int, dimension: int) -> np.ndarray:
    """IDFT bases for PLP autocorrelation (ref: feature-functions.cc:360-373)."""
    angle = math.pi / (dimension - 1)
    scale = 1.0 / (2.0 * (dimension - 1))
    i = np.arange(n_bases, dtype=np.float64)[:, None]
    j = np.arange(dimension, dtype=np.float64)[None, :]
    m = 2.0 * scale * np.cos(angle * i * j)
    m[:, 0] = scale
    m[:, -1] = scale * np.cos(angle * i[:, 0] * (dimension - 1))
    return m.astype(np.float32)


def _durbin(autocorr: jnp.ndarray, order: int):
    """Levinson-Durbin, vectorized over leading dims.

    autocorr: [..., order+1] -> (lpc [..., order], final prediction error [...]).
    (ref: mel-computations.cc:262-292 Durbin)
    """
    E = autocorr[..., 0]
    lpc = jnp.zeros(autocorr.shape[:-1] + (order,), autocorr.dtype)
    # order is small & static (default 12): unrolled python loop traces fine.
    for i in range(order):
        ki = autocorr[..., i + 1]
        for j in range(i):
            ki = ki + lpc[..., j] * autocorr[..., i - j]
        ki = ki / E
        c = jnp.maximum(1.0 - ki * ki, 1.0e-5)
        E = E * c
        new = [None] * (i + 1)
        for j in range(i):
            new[j] = lpc[..., j] - ki * lpc[..., i - j - 1]
        new[i] = -ki
        lpc = jnp.concatenate(
            [jnp.stack(new, axis=-1), lpc[..., i + 1:]], axis=-1
        )
    return lpc, E


def _lpc_to_cepstrum(lpc: jnp.ndarray, order: int) -> jnp.ndarray:
    """LPC -> cepstrum recursion (ref: mel-computations.cc:295-304 Lpc2Cepstrum)."""
    ceps = []
    for i in range(order):
        s = jnp.zeros(lpc.shape[:-1], lpc.dtype)
        for j in range(i):
            s = s + (i - j) * lpc[..., j] * ceps[i - j - 1]
        ceps.append(-lpc[..., i] - s / (i + 1))
    return jnp.stack(ceps, axis=-1)


@functools.partial(jax.jit, static_argnames=("opts", "vtln_warp"))
def plp(
    wave: jnp.ndarray,
    opts: PlpOpts = PlpOpts(),
    vtln_warp: float = 1.0,
    dither_key: jax.Array | None = None,
) -> jnp.ndarray:
    """wave [..., S] -> PLP cepstra [..., F, num_ceps].

    (ref: feat/feature-plp.cc:160-260 Plp::ComputeInternal)
    """
    assert opts.num_ceps <= opts.lpc_order + 1
    fo = opts.frame_opts
    nbins = opts.mel_opts.num_bins
    windows, raw_le = extract_windows(
        wave, fo, dither_key, want_raw_energy=opts.use_energy and opts.raw_energy
    )
    log_energy = _window_energy(windows, opts.use_energy, opts.raw_energy,
                                raw_le, fo.window_size)
    power = _power_spectrum(windows)[..., : fo.padded_window_size // 2]
    banks = mel_banks(opts.mel_opts, fo, vtln_warp)
    mel_e = _mm(power, banks.T)
    if opts.mel_opts.htk_mode:
        mel_e = jnp.maximum(mel_e, 1.0)
    # equal loudness (ref: feature-functions.cc:345-356)
    f0 = center_freqs(opts.mel_opts, fo, vtln_warp)
    fsq = f0 * f0
    fsub = fsq / (fsq + 1.6e5)
    eql = (fsub * fsub * ((fsq + 1.44e6) / (fsq + 9.61e6))).astype(np.float32)
    mel_e = mel_e * jnp.asarray(eql)
    mel_e = jnp.power(jnp.maximum(mel_e, FLT_TINY), opts.compress_factor)
    # duplicate first/last, IDFT -> autocorrelation
    dup = jnp.concatenate([mel_e[..., :1], mel_e, mel_e[..., -1:]], axis=-1)
    idft = jnp.asarray(_idft_bases_np(opts.lpc_order + 1, nbins + 2))
    autocorr = _mm(dup, idft.T)
    lpc, E = _durbin(autocorr, opts.lpc_order)
    lpc_energy = -jnp.log(1.0 / jnp.maximum(E, FLT_TINY))
    raw_ceps = _lpc_to_cepstrum(lpc, opts.lpc_order)
    feats = jnp.concatenate(
        [lpc_energy[..., None], raw_ceps[..., : opts.num_ceps - 1]], axis=-1
    )
    if opts.cepstral_lifter != 0.0:
        feats = feats * lifter_coeffs(opts.cepstral_lifter, opts.num_ceps)
    if opts.cepstral_scale != 1.0:
        feats = feats * opts.cepstral_scale
    if opts.use_energy:
        log_energy = _apply_energy_floor(log_energy, opts.energy_floor)
        feats = jnp.concatenate([log_energy[..., None], feats[..., 1:]], axis=-1)
    if opts.htk_compat:
        feats = _htk_reorder(feats, scale_c0=False)
    return feats


def feature_dim(opts) -> int:
    return opts.dim


def compute_num_frames(num_samples: int, opts) -> int:
    return num_frames(num_samples, opts.frame_opts)
