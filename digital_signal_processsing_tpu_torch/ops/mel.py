"""Mel-frequency audio features on the STFT: the port of
``digital_signal_processsing_tpu/ops/mel.py``.

The mel filterbank and the DCT are designed on the host (NumPy, cached,
copies of the reference's) and applied as dense products over the
spectrogram, (frames, bins) x (bins, mels) and (frames, mels) x (mels,
ceps), with ``torch.matmul`` in IEEE float32 (``fir.ieee_fp32_matmul``:
a caller's TF32 setting does not reach them). The spectrogram comes from
``ops.fft.stft`` (``torch.fft``). Delta features are shift-and-add over the
frame axis. Everything runs on the input's device; the streaming state
(``mfcc_init``) is made on the card unless the caller names the CPU.

Conventions match the de-facto standard (librosa/HTK): Slaney mel scale by
default (linear below 1 kHz, log above) with ``htk=True`` for the
2595*log10(1+f/700) variant; triangular filters on mel-spaced edges;
optional Slaney area normalization; orthonormal DCT-II for MFCCs.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .fir import ieee_fp32_matmul

__all__ = [
    "hz_to_mel",
    "mel_to_hz",
    "mel_frequencies",
    "mel_filterbank",
    "dct_matrix",
    "melspectrogram",
    "log_melspectrogram",
    "mfcc",
    "mfcc_init",
    "mfcc_chunk",
    "delta",
]

_F_SP = 200.0 / 3.0  # Slaney: Hz per mel below the 1 kHz knee
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0  # Slaney: mel step above the knee


def hz_to_mel(f, *, htk: bool = False) -> np.ndarray:
    """Hz -> mel (host-side; Slaney by default, HTK optional)."""
    f = np.asarray(f, np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    return np.where(
        f >= _MIN_LOG_HZ,
        _MIN_LOG_MEL + np.log(np.maximum(f, _MIN_LOG_HZ) / _MIN_LOG_HZ) / _LOGSTEP,
        f / _F_SP,
    )


def mel_to_hz(m, *, htk: bool = False) -> np.ndarray:
    """mel -> Hz, the exact inverse of :func:`hz_to_mel`."""
    m = np.asarray(m, np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    return np.where(
        m >= _MIN_LOG_MEL,
        _MIN_LOG_HZ * np.exp(_LOGSTEP * (np.maximum(m, _MIN_LOG_MEL) - _MIN_LOG_MEL)),
        _F_SP * m,
    )


def mel_frequencies(
    n_mels: int, *, fmin: float = 0.0, fmax: float = 11025.0, htk: bool = False
) -> np.ndarray:
    """``n_mels`` frequencies evenly spaced on the mel scale (Hz)."""
    mels = np.linspace(hz_to_mel(fmin, htk=htk), hz_to_mel(fmax, htk=htk), n_mels)
    return mel_to_hz(mels, htk=htk)


@functools.lru_cache(maxsize=32)
def _mel_filterbank_cached(n_mels, nfft, sample_rate, fmin, fmax, htk, norm):
    n_bins = nfft // 2 + 1
    fftfreqs = np.arange(n_bins, dtype=np.float64) * (sample_rate / nfft)
    edges = mel_frequencies(n_mels + 2, fmin=fmin, fmax=fmax, htk=htk)
    fdiff = np.diff(edges)
    ramps = edges[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]  # rising edge of each triangle
    upper = ramps[2:] / fdiff[1:, None]  # falling edge
    weights = np.maximum(0.0, np.minimum(lower, upper))
    if norm == "slaney":
        # Equal-area filters: divide by the triangle's Hz width / 2.
        weights *= (2.0 / (edges[2:] - edges[:-2]))[:, None]
    elif norm is not None:
        raise ValueError(f"norm must be 'slaney' or None, got {norm!r}")
    return weights.astype(np.float32)


def mel_filterbank(
    n_mels: int,
    nfft: int,
    sample_rate: float,
    *,
    fmin: float = 0.0,
    fmax: float | None = None,
    htk: bool = False,
    norm: str | None = "slaney",
) -> np.ndarray:
    """Triangular mel filterbank, (n_mels, nfft//2 + 1) float32 (host-side).

    Filters are triangles between ``n_mels + 2`` mel-spaced edge
    frequencies in [fmin, fmax]; with ``norm=None`` adjacent filters sum to
    one between their centers, with ``norm='slaney'`` each is scaled to
    unit area (2 / Hz-width).
    """
    if n_mels < 1:
        raise ValueError(f"n_mels must be >= 1, got {n_mels}")
    if fmax is None:
        fmax = sample_rate / 2.0
    if not 0.0 <= fmin < fmax:
        raise ValueError(f"need 0 <= fmin < fmax, got ({fmin}, {fmax})")
    return _mel_filterbank_cached(
        n_mels, nfft, float(sample_rate), float(fmin), float(fmax), htk, norm
    )


@functools.lru_cache(maxsize=16)
def dct_matrix(n_out: int, n_in: int, norm: str = "ortho") -> np.ndarray:
    """First ``n_out`` DCT-II basis rows over ``n_in`` points, float32.

    ``norm='ortho'`` matches ``scipy.fft.dct(type=2, norm='ortho')``: rows
    are orthonormal, so MFCC energy is preserved under truncation.
    """
    if norm != "ortho":
        raise ValueError(f"only norm='ortho' is supported, got {norm!r}")
    k = np.arange(n_out, dtype=np.float64)[:, None]
    n = np.arange(n_in, dtype=np.float64)[None, :]
    m = np.cos(np.pi * k * (2.0 * n + 1.0) / (2.0 * n_in)) * np.sqrt(2.0 / n_in)
    m[0] /= np.sqrt(2.0)
    return m.astype(np.float32)


@functools.lru_cache(maxsize=32)
def _filterbank_on(n_mels, nfft, sample_rate, fmin, fmax, htk, norm, device: str) -> torch.Tensor:
    """The transposed filterbank, (bins, mels) float32 on ``device``, built once."""
    fb = mel_filterbank(n_mels, nfft, sample_rate, fmin=fmin, fmax=fmax, htk=htk, norm=norm)
    return torch.from_numpy(np.ascontiguousarray(fb.T)).to(device)


@functools.lru_cache(maxsize=16)
def _dct_on(n_out: int, n_in: int, device: str) -> torch.Tensor:
    """The transposed DCT-II rows, (n_in, n_out) float32 on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(dct_matrix(n_out, n_in).T)).to(device)


def _mel_power(p: torch.Tensor, n_mels, nfft, sample_rate, fmin, fmax, htk, norm) -> torch.Tensor:
    fb = _filterbank_on(n_mels, nfft, float(sample_rate), fmin, fmax, htk, norm, str(p.device))
    with ieee_fp32_matmul():
        return p @ fb


def melspectrogram(
    x,
    *,
    sample_rate: float,
    nfft: int = 1024,
    hop: int = 256,
    window: str = "hann",
    n_mels: int = 80,
    fmin: float = 0.0,
    fmax: float | None = None,
    htk: bool = False,
    norm: str | None = "slaney",
    method: str = "auto",
) -> torch.Tensor:
    """Mel power spectrogram: (..., frames, n_mels).

    ``|STFT|^2`` (``method`` as in ``ops.fft.stft``) followed by ONE
    (bins, mels) product in IEEE float32.
    """
    from .fft import spectrogram

    p = spectrogram(x, nfft=nfft, hop=hop, window=window, method=method)
    return _mel_power(p, n_mels, nfft, sample_rate, fmin, fmax, htk, norm)


def log_melspectrogram(x, *, floor: float = 1e-10, **kw) -> torch.Tensor:
    """Natural-log mel spectrogram with a numerical floor."""
    return torch.log(torch.clamp(melspectrogram(x, **kw), min=floor))


def _cepstral_lift(c: torch.Tensor, n_mfcc: int, lifter: float) -> torch.Tensor:
    if lifter > 0.0:
        k = np.arange(n_mfcc, dtype=np.float64)
        lift = 1.0 + (lifter / 2.0) * np.sin(np.pi * (k + 1.0) / lifter)
        return c * torch.from_numpy(lift.astype(np.float32)).to(c.device)
    if lifter < 0.0:
        raise ValueError(f"lifter must be >= 0, got {lifter}")
    return c


def _dct(lm: torch.Tensor, n_mfcc: int) -> torch.Tensor:
    d = _dct_on(n_mfcc, lm.shape[-1], str(lm.device))
    with ieee_fp32_matmul():
        return lm @ d


def mfcc(
    x,
    *,
    sample_rate: float,
    n_mfcc: int = 13,
    lifter: float = 0.0,
    floor: float = 1e-10,
    **kw,
) -> torch.Tensor:
    """Mel-frequency cepstral coefficients: (..., frames, n_mfcc).

    Orthonormal DCT-II of the log-mel spectrogram (one more product);
    ``lifter`` > 0 applies the standard sinusoidal liftering
    1 + (L/2) sin(pi (k+1) / L).
    """
    lm = log_melspectrogram(x, sample_rate=sample_rate, floor=floor, **kw)
    n_mels = lm.shape[-1]
    if not 1 <= n_mfcc <= n_mels:
        raise ValueError(f"n_mfcc must be in [1, {n_mels}], got {n_mfcc}")
    return _cepstral_lift(_dct(lm, n_mfcc), n_mfcc, lifter)


def mfcc_init(nfft: int, hop: int, channels: int = 1, *, device="cuda"):
    """Streaming-MFCC state: the streaming-STFT tail carry
    (``ops.streaming.stft_init``, needs hop | nfft) on ``device``."""
    from .streaming import stft_init

    return stft_init(nfft, hop, channels, device=device)


def mfcc_chunk(
    state,
    x,
    *,
    sample_rate: float,
    n_mfcc: int = 13,
    nfft: int = 1024,
    hop: int = 256,
    window: str = "hann",
    n_mels: int = 80,
    fmin: float = 0.0,
    fmax: float | None = None,
    htk: bool = False,
    norm: str | None = "slaney",
    floor: float = 1e-10,
    lifter: float = 0.0,
    method: str = "auto",
):
    """One chunk of streaming MFCC extraction: (channels, L) -> (state,
    (channels, L//hop, n_mfcc)), L a nonzero multiple of hop.

    Rides ``ops.streaming.stft_chunk``'s tail carry, so concatenated chunk
    outputs equal the one-shot :func:`mfcc` of the stream prefixed with
    nfft - hop zeros (real-time priming; drop the first nfft//hop - 1
    frames for unprimed parity). The serving front end for feature
    extraction — see ``serve.stream_mfcc``.
    """
    from .streaming import stft_chunk

    if not 1 <= n_mfcc <= n_mels:
        raise ValueError(f"n_mfcc must be in [1, {n_mels}], got {n_mfcc}")
    state, s = stft_chunk(state, x, nfft=nfft, hop=hop, window=window, method=method)
    p = (s.real**2 + s.imag**2).to(torch.float32)
    mel = _mel_power(p, n_mels, nfft, sample_rate, fmin, fmax, htk, norm)
    lm = torch.log(torch.clamp(mel, min=floor))
    return state, _cepstral_lift(_dct(lm, n_mfcc), n_mfcc, lifter)


def delta(feat: torch.Tensor, *, width: int = 9) -> torch.Tensor:
    """Regression delta features over the frame axis (-2).

    The standard formula d[t] = sum_k k (x[t+k] - x[t-k]) / (2 sum_k k^2)
    with edge-replicated frames, as a static shift-and-add.
    """
    if width < 3 or width % 2 == 0:
        raise ValueError(f"width must be odd and >= 3, got {width}")
    half = width // 2
    if feat.dim() < 2:
        raise ValueError("delta expects (..., frames, features)")
    nframes = feat.shape[-2]
    # edge-replicate half frames on each side of the frame axis
    idx = torch.arange(-half, nframes + half, device=feat.device).clamp_(0, max(nframes - 1, 0))
    fp = feat.index_select(-2, idx)
    denom = 2.0 * sum(k * k for k in range(1, half + 1))
    out = torch.zeros_like(feat)
    for k in range(1, half + 1):
        plus = fp.narrow(-2, half + k, nframes)
        minus = fp.narrow(-2, half - k, nframes)
        out = out + (k / denom) * (plus - minus)
    return out
