"""FFT stage: the spectral surface of ``digital_signal_processsing_tpu/ops/fft.py``.

Every transform here is ``torch.fft`` on the input's device (cuFFT on the
card). The reference picks a DFT engine with ``method``: ``xla`` (jnp.fft)
or ``mxu`` (its factored-DFT matmuls for the TPU's matrix unit), ``auto``
choosing ``mxu`` on a TPU only. The port accepts the same three names and
raises on any other, as the reference does, and computes all three with
``torch.fft``: cuFFT is the card's native transform. The reference's
matmul engines (``fft_mxu.dft_factored``, ``fft_large``, ``rfft_dense``,
``rfft_dense_framed``, ``irfft_dense``) are in the port's ``fft_mxu`` as
``torch.fft`` calls under the same contract, and no route here goes through
them. So ``method="mxu"``
here differs from the reference's ``mxu`` by that engine's rounding (about
1e-5 of the output on its TPU at HIGH precision, ROADMAP H3; about 2e-7
on the CPU), and from its ``xla`` not at all.

No function here reaches a hand-written kernel but one: ``hilbert_fir``
(and ``hilbert``'s ``fir`` route) filters through ``fir.fir_filter``,
which takes the fused overlap-save kernel B8 on the card. The dense
products (``czt``'s chirp matrix, ``tone_power``'s oscillator bank) are
``torch.matmul`` pinned to IEEE float32, the reference's
``Precision.HIGHEST``.

The windows (:func:`spectral_window`, :func:`get_window` and their
helpers, :func:`dpss_windows`) and the WOLA checks are NumPy-only copies
of the reference's, float64 on the host as there.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import as_tensor
from ..utils.dispatch import record_choice
from ..utils.layout import overlapping_frames

FFT_METHODS = ("auto", "xla", "mxu")

# The reference's largest length for XLA's full-length FFT on its TPU (its
# compile time); kept for its callers. cuFFT takes every length.
XLA_FFT_MAX_N = 1 << 23


def _check_fft_method(method: str) -> None:
    """Refuse an engine name the reference does not know; every name runs on
    ``torch.fft``."""
    if method not in FFT_METHODS:
        raise ValueError(f"unknown method {method!r}; options {FFT_METHODS}")


def as_signal(x) -> torch.Tensor:
    """A tensor stays where it is; anything else goes to the card (raises without one)."""
    return as_tensor(x)


def as_signal_like(v, ref: torch.Tensor) -> torch.Tensor:
    """A second operand (a template, taps, another channel): a tensor stays
    where it is; anything else goes to ``ref``'s device."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(np.asarray(v), device=ref.device)


def _real32(x) -> torch.Tensor:
    x = as_signal(x)
    return (x.real if x.is_complex() else x).to(torch.float32)


@functools.lru_cache(maxsize=64)
def _window_on(window, nfft: int, device: str) -> torch.Tensor:
    """:func:`spectral_window` as a float32 tensor on ``device``, built once."""
    return torch.from_numpy(spectral_window(window, nfft)).to(device)


@functools.lru_cache(maxsize=64)
def _one_sided_scale(n: int, device: str) -> torch.Tensor:
    """Doubling of the one-sided bins: all but DC (and Nyquist for even n)."""
    scale = np.full(n // 2 + 1, 2.0, np.float32)
    scale[0] = 1.0
    if n % 2 == 0:
        scale[-1] = 1.0
    return torch.from_numpy(scale).to(device)


def fft(a, n=None, axis=-1):
    return torch.fft.fft(as_signal(a), n=n, dim=axis)


def ifft(a, n=None, axis=-1):
    return torch.fft.ifft(as_signal(a), n=n, dim=axis).resolve_conj()


def rfft(a, n=None, axis=-1):
    """One-sided FFT of a real tensor (``numpy.fft.rfft`` semantics)."""
    return torch.fft.rfft(as_signal(a), n=n, dim=axis)


def irfft(a, n=None, axis=-1):
    return torch.fft.irfft(as_signal(a), n=n, dim=axis)


def stft(
    x,
    *,
    nfft: int = 1024,
    hop: int = 256,
    window: str = "hann",
    method: str = "auto",
    detrend_segments: bool = False,
) -> torch.Tensor:
    """Short-time FT of (channels, time) -> (channels, frames, nfft//2+1) complex64.

    Frame i is ``x[..., i*hop : i*hop + nfft]``, whole frames only, times the
    periodic analysis window. ``method``: an engine name of the reference,
    all computed by ``torch.fft.rfft`` (see the module docstring).
    """
    if hop < 1:
        raise ValueError(f"hop must be >= 1, got {hop}")
    _check_fft_method(method)
    x = _real32(x)
    xp = x if x.dim() == 2 else x[None, :]
    c, t = xp.shape
    nframes = max(0, (t - nfft) // hop + 1)
    if nframes == 0:
        out = xp.new_zeros((c, 0, nfft // 2 + 1), dtype=torch.complex64)
    else:
        segs = overlapping_frames(xp, nframes, hop, nfft)
        if detrend_segments:
            # scipy's welch-family detrend='constant': per-UNWINDOWED-segment
            # mean removal before the analysis window
            segs = segs - segs.mean(dim=-1, keepdim=True)
        out = torch.fft.rfft(segs * _window_on(window, nfft, str(xp.device)), dim=-1)
    return out if x.dim() == 2 else out[0]


def _overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """(c, f, r*hop) frames -> (c, (f+r-1)*hop) summed on the hop grid.

    R shifted adds of (f, hop) planes into one tensor, never a scatter.
    """
    c, f, n = frames.shape
    r = n // hop
    parts = frames.reshape(c, f, r, hop)
    out = frames.new_zeros((c, f + r - 1, hop))
    for i in range(r):
        out[:, i : i + f, :] += parts[:, :, i, :]
    return out.reshape(c, (f + r - 1) * hop)


def istft(
    s,
    *,
    nfft: int = 1024,
    hop: int = 512,
    window: str = "sqrt_hann",
    method: str = "auto",
) -> torch.Tensor:
    """Inverse STFT by windowed overlap-add — the WOLA synthesis bank.

    With ``window='sqrt_hann'`` and ``hop = nfft // 2`` this inverts
    :func:`stft` with the same arguments away from the edges (analysis x
    synthesis window = periodic hann, which overlap-adds to 1 at 50%
    overlap). Requires ``nfft % hop == 0``; the OLA is R shifted adds.

    ``s``: (..., frames, nfft//2+1) complex -> (..., (frames-1)*hop + nfft).
    """
    if hop < 1 or nfft % hop != 0:
        raise ValueError(f"need hop >= 1 dividing nfft, got hop={hop} nfft={nfft}")
    _check_fft_method(method)
    s = as_signal(s)
    squeeze = s.dim() == 2
    sp = s[None] if squeeze else s
    frames = torch.fft.irfft(sp, n=nfft, dim=-1) * _window_on(window, nfft, str(sp.device))
    t_out = (frames.shape[1] - 1) * hop + nfft
    y = _overlap_add(frames, hop)[:, :t_out]
    return y[0] if squeeze else y


def power_spectrum(x, *, nfft: int = 1024, method: str = "auto") -> torch.Tensor:
    """Mean periodogram over whole frames of the signal."""
    s = stft(x, nfft=nfft, hop=nfft, window="rect", method=method)
    return (s.abs() ** 2).mean(dim=-2)


def _psd_norm(window, nfft: int, fs: float, scaling: str) -> float:
    w = spectral_window(window, nfft)  # the same array the STFT applied
    if scaling == "density":
        return fs * float((w**2).sum())
    if scaling == "spectrum":
        return float(w.sum()) ** 2
    raise ValueError(f"unknown scaling {scaling!r}")


def welch(
    x,
    *,
    nfft: int = 1024,
    hop: int | None = None,
    window: str = "hann",
    fs: float = 1.0,
    scaling: str = "density",
    method: str = "auto",
    detrend_segments: bool = False,
) -> torch.Tensor:
    """Welch PSD estimate of (channels, time) or (time,) -> (..., nfft//2+1).

    Mean of windowed-overlapped periodograms (default 50% overlap),
    normalized like scipy.signal.welch: "density" divides by fs*sum(w^2),
    one-sided doubling of the interior bins.
    """
    if hop is None:
        hop = nfft // 2
    if hop < 1:
        raise ValueError(f"hop must be >= 1, got {hop}")
    s = stft(x, nfft=nfft, hop=hop, window=window, method=method,
             detrend_segments=detrend_segments)
    norm = _psd_norm(window, nfft, fs, scaling)
    p = (s.abs() ** 2).mean(dim=-2) / norm
    return p * _one_sided_scale(nfft, str(p.device))


def periodogram(
    x,
    *,
    fs: float = 1.0,
    nfft: int | None = None,
    window: str = "rect",
    scaling: str = "density",
    method: str = "auto",
) -> torch.Tensor:
    """Single-frame PSD estimate (scipy.signal.periodogram, constant detrend).

    The whole (mean-removed, windowed) signal is one DFT frame; one-sided
    density/spectrum scaling like :func:`welch`. ``nfft`` defaults to the
    stream length (zero-pads beyond it).
    """
    x = _real32(x)
    xp = x if x.dim() == 2 else x[None, :]
    t = xp.shape[-1]
    n = nfft or t
    if n < t:
        raise ValueError(f"nfft {n} < signal length {t}")
    _check_fft_method(method)
    xf = xp - xp.mean(dim=-1, keepdim=True)
    s = torch.fft.rfft(xf * _window_on(window, t, str(xp.device)), n=n, dim=-1)
    p = (s.abs() ** 2) / _psd_norm(window, t, fs, scaling)
    out = p * _one_sided_scale(n, str(p.device))
    return out if x.dim() == 2 else out[0]


def _cross_spectra(x, y, nfft, hop, window, method, detrend_segments):
    x = as_signal(x)
    y = as_signal_like(y, x)
    if hop is None:
        hop = nfft // 2
    kw = dict(nfft=nfft, hop=hop, window=window, method=method,
              detrend_segments=detrend_segments)
    return stft(x, **kw), stft(y, **kw)


def csd(
    x,
    y,
    *,
    nfft: int = 1024,
    hop: int | None = None,
    window: str = "hann",
    fs: float = 1.0,
    scaling: str = "density",
    method: str = "auto",
    detrend_segments: bool = False,
) -> torch.Tensor:
    """Welch cross-spectral density conj(X)*Y (scipy.signal.csd semantics),
    complex64. ``csd(x, x)`` reduces to :func:`welch` of x."""
    sx, sy = _cross_spectra(x, y, nfft, hop, window, method, detrend_segments)
    norm = _psd_norm(window, nfft, fs, scaling)
    p = (sx.conj() * sy).mean(dim=-2) / norm
    return p * _one_sided_scale(nfft, str(p.device))


def coherence(
    x,
    y,
    *,
    nfft: int = 1024,
    hop: int | None = None,
    window: str = "hann",
    method: str = "auto",
    detrend_segments: bool = False,
) -> torch.Tensor:
    """Magnitude-squared coherence |Pxy|^2 / (Pxx Pyy) in [0, 1]
    (scipy.signal.coherence semantics); real float32 output."""
    sx, sy = _cross_spectra(x, y, nfft, hop, window, method, detrend_segments)
    pxy = (sx.conj() * sy).mean(dim=-2)
    pxx = (sx.abs() ** 2).mean(dim=-2)
    pyy = (sy.abs() ** 2).mean(dim=-2)
    return (pxy.abs() ** 2 / torch.clamp(pxx * pyy, min=1e-30)).to(torch.float32)


def spectrogram(
    x,
    *,
    nfft: int = 1024,
    hop: int = 256,
    window: str = "hann",
    method: str = "auto",
) -> torch.Tensor:
    """Power spectrogram |STFT|^2: (..., frames, nfft//2+1), float32."""
    s = stft(x, nfft=nfft, hop=hop, window=window, method=method)
    return (s.real**2 + s.imag**2).to(torch.float32)


def tone_power(x, freqs) -> torch.Tensor:
    """Power of x at EXACT (non-bin) frequencies — the Goertzel use case.

    ``freqs``: (K,) in cycles/sample. Returns (..., K) estimates of the
    tone's mean power, amplitude^2/2. A dot of x against the exact-phase
    oscillator bank (``demod.oscillator_bank``), one IEEE float32 product a
    part (the reference's ``Precision.HIGHEST``).
    """
    from .demod import oscillator_bank
    from .fir import ieee_fp32_matmul

    xf = _real32(x)
    t = xf.shape[-1]
    f = torch.atleast_1d(torch.as_tensor(freqs, dtype=torch.float32).to(xf.device))
    c, s = oscillator_bank(f, t)  # (K, t)
    with ieee_fp32_matmul():
        re = torch.tensordot(xf, c, dims=([-1], [1])) / t
        im = torch.tensordot(xf, s, dims=([-1], [1])) / t
    return 2.0 * (re**2 + im**2)


# The reference's exactness/speed boundary for ``hilbert``'s auto: below it
# the exact FFT, at or above it the FIR approximation (measured 3x faster on
# its TPU v5e; the H100's own A/B is an open question in ROADMAP.md).
HILBERT_BLOCKED_MIN_T = 1 << 22
# The reference's largest length for XLA's full-length FFT on its TPU (kept
# for its callers; cuFFT takes every length).
HILBERT_XLA_MAX_T = XLA_FFT_MAX_N


def hilbert(x, *, method: str = "auto", num_taps: int = 513) -> torch.Tensor:
    """Analytic signal of a real input over the last axis (complex64).

    AUTO ACCURACY ENVELOPE: for ``t >= HILBERT_BLOCKED_MIN_T`` (2^22)
    ``auto`` returns the FIR approximation (~1e-4 mid-band ripple, worse
    near DC/Nyquist), the reference's rule. Pin ``method='fft'`` for
    exactness at those lengths.

    ``method='fft'``: the exact spectral method (zero the negative
    frequencies, double the positive ones) by ``torch.fft`` at any length,
    the analytic mask built on the device from an index.
    ``method='fir'``: :func:`hilbert_fir`, a windowed ideal-Hilbert FIR
    (B8 on the card), group-delay aligned.
    """
    t = x.shape[-1]
    if method == "auto":
        method = "fft" if t < HILBERT_BLOCKED_MIN_T else "fir"
    record_choice("hilbert", method)
    if method == "fir":
        return hilbert_fir(x, num_taps=num_taps)
    if method != "fft":
        raise ValueError(f"unknown method {method!r}; options ('auto','fft','fir')")
    return _hilbert_fft(x)


def _analytic_mask(t: int, device) -> torch.Tensor:
    """1 at DC (and Nyquist for even t), 2 on the positive bins, 0 elsewhere."""
    idx = torch.arange(t, device=device)
    one = (idx == 0) | ((t % 2 == 0) & (idx == t // 2))
    two = (idx >= 1) & (idx < (t + 1) // 2)
    return one.to(torch.float32) + 2.0 * two.to(torch.float32)


def _hilbert_fft(x) -> torch.Tensor:
    xf = _real32(x)
    t = xf.shape[-1]
    spec = torch.fft.fft(xf, dim=-1)
    return torch.fft.ifft(spec * _analytic_mask(t, xf.device), dim=-1)


def design_hilbert_fir(num_taps: int, *, beta: float = 8.0) -> np.ndarray:
    """Kaiser-windowed ideal-Hilbert-kernel FIR (type III: odd, antisymmetric).

    h[m] = 2/(pi*m) for odd offsets m from center, 0 for even — the ideal
    transformer's impulse response — windowed to ``num_taps``. Frequency
    response approximates -j*sign(f) over the band, rolling off near DC and
    Nyquist (inherent to every FIR Hilbert).
    """
    if num_taps % 2 == 0 or num_taps < 3:
        raise ValueError(f"hilbert FIR needs odd num_taps >= 3, got {num_taps}")
    mid = (num_taps - 1) // 2
    m = np.arange(num_taps) - mid
    with np.errstate(divide="ignore"):
        h = np.where(m % 2 != 0, 2.0 / (np.pi * m), 0.0)
    h[mid] = 0.0
    return (h * np.kaiser(num_taps, beta)).astype(np.float32)


def hilbert_fir(x, *, num_taps: int = 513, row_len: int = 1 << 20) -> torch.Tensor:
    """Blocked analytic signal: FIR Hilbert transformer + delay alignment.

    The causal FIR by ``fir.fir_filter`` (``auto``: B8 on the card), with
    the imaginary part shifted back by the group delay
    ``d = (num_taps-1)//2`` so it aligns with the real input. Samples within
    half the FIR of either end see zero padding.

    ``row_len`` is accepted for the reference's signature: there it folds
    long streams into rows to bound XLA's compile time, computing the same
    function; the port filters every length in one call.
    """
    from .fir import fir_filter

    if row_len < 1:
        raise ValueError(f"row_len must be >= 1, got {row_len}")
    h = design_hilbert_fir(num_taps)
    d = (num_taps - 1) // 2
    xr = _real32(x)
    squeeze = xr.dim() == 1
    xp = xr[None, :] if squeeze else xr
    t = xp.shape[-1]
    ext = F.pad(xp, (0, d))  # future halo for the delay shift
    im = fir_filter(ext, h)[..., d : d + t]
    z = torch.complex(xp, im)
    return z[0] if squeeze else z


def envelope(x, *, method: str = "auto") -> torch.Tensor:
    """Instantaneous amplitude of a real signal: |hilbert(x)|."""
    return hilbert(x, method=method).abs().to(torch.float32)


# --- chirp-z / zoom spectra ----------------------------------------------------

_CZT_MATMUL_MAX = 1 << 23  # t*m entries: the reference's dense-product bound, kept


def _czt_chirp(t: int, m: int, w: complex, a: complex):
    """(t, m) chirp matrix M[n, k] = a^-n w^(nk) as host float64 planar
    (cos, sin) parts. Phases via float64 mod-2pi; magnitudes via logs so
    off-circle a/w don't overflow."""
    n = np.arange(t, dtype=np.float64)[:, None]
    k = np.arange(m, dtype=np.float64)[None, :]
    nk = n * k
    la, ta_ = np.log(np.abs(a)), np.angle(a)
    lw, tw = np.log(np.abs(w)), np.angle(w)
    mag = np.exp(-n * la + nk * lw)
    ph = -n * ta_ + np.mod(nk * tw, 2.0 * np.pi)
    return (mag * np.cos(ph)).astype(np.float32), (mag * np.sin(ph)).astype(
        np.float32
    )


@functools.lru_cache(maxsize=8)
def _czt_chirp_on(t: int, m: int, w: complex, a: complex, device: str):
    mr, mi = _czt_chirp(t, m, w, a)
    return torch.from_numpy(mr).to(device), torch.from_numpy(mi).to(device)


def _cexp(logmag, phase) -> torch.Tensor:
    """complex64 tensor of exp(logmag + i*phase), formed on the host in float64."""
    mag = np.exp(logmag)
    re = torch.from_numpy((mag * np.cos(phase)).astype(np.float32))
    im = torch.from_numpy((mag * np.sin(phase)).astype(np.float32))
    return torch.complex(re, im)


@functools.lru_cache(maxsize=8)
def _bluestein_on(t: int, m: int, w: complex, a: complex, device: str):
    """(pre-chirp a^-n w^(n^2/2), FFT of the chirp filter w^(-j^2/2), post-chirp
    w^(k^2/2), FFT length) on ``device``, built once a plan."""
    n = np.arange(t, dtype=np.float64)
    j = np.arange(-(t - 1), m, dtype=np.float64)
    k = np.arange(m, dtype=np.float64)
    la, ta_ = np.log(np.abs(a)), np.angle(a)
    lw, tw = np.log(np.abs(w)), np.angle(w)
    nfft = 1 << int(np.ceil(np.log2(t + m + t - 2)))
    pre = _cexp(-n * la + (n * n / 2.0) * lw, -n * ta_ + np.mod(n * n / 2.0 * tw, 2 * np.pi))
    filt = _cexp(-(j * j / 2.0) * lw, np.mod(-(j * j / 2.0) * tw, 2 * np.pi))
    post = _cexp((k * k / 2.0) * lw, np.mod(k * k / 2.0 * tw, 2 * np.pi))
    return pre.to(device), torch.fft.fft(filt.to(device), n=nfft), post.to(device), nfft


def czt(x, m: int | None = None, w: complex | None = None, a: complex = 1.0 + 0.0j) -> torch.Tensor:
    """Chirp-z transform: ``m`` samples along the spiral z_k = a w^-k
    (scipy.signal.czt semantics; default w spaces the unit circle evenly,
    reducing to the DFT). Real or complex input; complex64 output.

    Up to t x m = 2^23 entries one dense (t, m) chirp-matrix product in
    IEEE float32 (``czt`` route ``matmul``); past it Bluestein's
    chirp-convolution identity nk = (n^2 + k^2 - (k-n)^2)/2 on ``torch.fft``
    (route ``bluestein``).
    """
    from .fir import ieee_fp32_matmul

    x = as_signal(x)
    t = x.shape[-1]
    if m is None:
        m = t
    if m < 1:
        raise ValueError(f"m must be >= 1, got {m}")
    if w is None:
        w = complex(np.exp(-2j * np.pi / m))
    w = complex(w)
    a = complex(a)
    if x.is_complex():
        xr, xi = x.real.to(torch.float32), x.imag.to(torch.float32)
    else:
        xr, xi = x.to(torch.float32), None
    if t * m <= _CZT_MATMUL_MAX:
        record_choice("czt", "matmul")
        mr, mi = _czt_chirp_on(t, m, w, a, str(xr.device))
        with ieee_fp32_matmul():
            yr = xr @ mr
            yi = xr @ mi
            if xi is not None:
                yr = yr - xi @ mi
                yi = yi + xi @ mr
        return torch.complex(yr, yi)
    record_choice("czt", "bluestein")
    # X[k] = w^(k^2/2) * conv(x[n] a^-n w^(n^2/2), w^(-j^2/2))[t-1+k]
    pre, filt_f, post, nfft = _bluestein_on(t, m, w, a, str(xr.device))
    u = (xr if xi is None else torch.complex(xr, xi)) * pre
    conv = torch.fft.ifft(torch.fft.fft(u, n=nfft) * filt_f, n=nfft)
    return conv[..., t - 1 : t - 1 + m] * post


def zoomfft(x, fn, m: int | None = None, *, fs: float = 2.0) -> torch.Tensor:
    """Zoomed DFT: ``m`` bins spanning [f1, f2) without computing the full
    spectrum (scipy.signal.zoomfft, endpoint=False), by :func:`czt`.

    ``fn``: (f1, f2) in the units of ``fs`` (default Nyquist units), or a
    scalar for [0, fn).
    """
    fn = np.atleast_1d(np.asarray(fn, np.float64))
    if fn.size == 1:
        fn = np.array([0.0, float(fn[0])])
    f1, f2 = float(fn[0]), float(fn[1])
    if not -fs / 2 <= f1 <= f2 <= fs:
        raise ValueError(f"need f1 <= f2 within the sampling band, got {fn}")
    t = x.shape[-1]
    if m is None:
        m = t
    a = complex(np.exp(2j * np.pi * f1 / fs))
    w = complex(np.exp(-2j * np.pi * (f2 - f1) / (m * fs)))
    return czt(x, m, w, a)


def hilbert2(x, n=None) -> torch.Tensor:
    """2-D analytic signal over the last two axes (scipy.signal.hilbert2):
    fft2, zero the negative quadrants, double the positive ones, ifft2."""
    xf = _real32(x)
    if xf.dim() < 2:
        raise ValueError("hilbert2 needs at least 2 dimensions")
    if n is None:
        n1, n2 = xf.shape[-2], xf.shape[-1]
    else:
        n1, n2 = (n, n) if np.ndim(n) == 0 else (int(n[0]), int(n[1]))
        if n1 < 1 or n2 < 1:
            raise ValueError("shape must be positive")
    spec = torch.fft.fft2(xf, s=(n1, n2), dim=(-2, -1))

    def half_mask(m: int) -> np.ndarray:
        # scipy.hilbert2 drops the Nyquist bin for even sizes (unlike the
        # 1-D hilbert, which keeps it at weight 1)
        h = np.zeros(m, np.float32)
        h[0] = 1.0
        h[1 : (m + 1) // 2] = 2.0
        return h

    mask = torch.from_numpy(np.outer(half_mask(n1), half_mask(n2))).to(xf.device)
    return torch.fft.ifft2(spec * mask, dim=(-2, -1))


# --- scipy-compat window factory + WOLA validity checks ------------------------


def spectral_window(window: str | tuple, nfft: int) -> np.ndarray:
    """PERIODIC analysis window (the scipy.signal spectral convention —
    np.hanning's symmetric form biases every PSD bin ~0.3%).

    The classic four ("hann"/"sqrt_hann"/"hamming"/"rect") are computed
    directly; any other name or ``(name, param)`` spec goes through
    :func:`get_window`'s full family (fftbins form), so the spectral ops
    accept every scipy window spec.
    """
    k = np.arange(nfft)
    if window == "hann":
        return (0.5 - 0.5 * np.cos(2 * np.pi * k / nfft)).astype(np.float32)
    if window == "sqrt_hann":
        # analysis*synthesis = hann, which overlap-adds to a constant at
        # hop = nfft/2: the WOLA perfect-reconstruction pair
        return np.sqrt(0.5 - 0.5 * np.cos(2 * np.pi * k / nfft)).astype(
            np.float32
        )
    if window == "hamming":
        return (0.54 - 0.46 * np.cos(2 * np.pi * k / nfft)).astype(np.float32)
    if window == "rect":
        return np.ones(nfft, np.float32)
    return get_window(window, nfft, fftbins=True).astype(np.float32)


def get_window(window, Nx: int, fftbins: bool = True) -> np.ndarray:
    """Window factory (scipy.signal.get_window): string name or
    ``(name, param)``; ``fftbins=True`` gives the PERIODIC form used for
    spectral analysis, ``False`` the symmetric filter-design form."""
    if isinstance(window, (tuple, list)):
        name, *params = window
    else:
        name, params = window, []
    if Nx < 1:
        raise ValueError(f"Nx must be >= 1, got {Nx}")
    m = Nx + 1 if fftbins else Nx
    n = np.arange(m, dtype=np.float64)
    if m > 1:
        t = 2.0 * np.pi * n / (m - 1)
    else:
        t = np.zeros(1)

    def cos_sum(coefs):
        w = np.zeros(m)
        for k, c in enumerate(coefs):
            w += c * np.cos(k * t) * (-1.0) ** k
        return w

    name = {"hanning": "hann", "rect": "boxcar", "rectangular": "boxcar"}.get(
        name, name
    )
    if name == "boxcar":
        w = np.ones(m)
    elif name in ("triang",):
        # scipy triang is NOT bartlett: no zero endpoints
        k = np.arange(1, (m + 1) // 2 + 1)
        if m % 2 == 0:
            half = (2 * k - 1) / m
            w = np.concatenate([half, half[::-1]])
        else:
            half = 2 * k / (m + 1)
            w = np.concatenate([half, half[-2::-1]])
    elif name == "bartlett":
        w = 1.0 - np.abs(2.0 * n / (m - 1) - 1.0) if m > 1 else np.ones(1)
    elif name == "hann":
        w = cos_sum([0.5, 0.5])
    elif name == "hamming":
        w = cos_sum([0.54, 0.46])
    elif name == "blackman":
        w = cos_sum([0.42, 0.5, 0.08])
    elif name == "blackmanharris":
        w = cos_sum([0.35875, 0.48829, 0.14128, 0.01168])
    elif name == "nuttall":
        w = cos_sum([0.3635819, 0.4891775, 0.1365995, 0.0106411])
    elif name == "flattop":
        w = cos_sum(
            [0.21557895, 0.41663158, 0.277263158, 0.083578947, 0.006947368]
        )
    elif name == "barthann":
        frac = np.abs(n / (m - 1) - 0.5) if m > 1 else np.zeros(1)
        w = 0.62 - 0.48 * frac + 0.38 * np.cos(2 * np.pi * frac)
    elif name == "bohman":
        frac = np.abs(2.0 * n / (m - 1) - 1.0) if m > 1 else np.zeros(1)
        w = (1 - frac) * np.cos(np.pi * frac) + np.sin(np.pi * frac) / np.pi
        w[0] = w[-1] = 0.0
    elif name == "parzen":
        # scipy's parzen scales by m/2 (not m-1) with the split at (m-1)/4
        nn = np.arange(-(m - 1) / 2.0, (m - 1) / 2.0 + 0.5, 1.0)
        an = np.abs(nn) / (m / 2.0)
        w = np.where(
            np.abs(nn) <= (m - 1) / 4.0,
            1.0 - 6.0 * an**2 + 6.0 * an**3,
            2.0 * (1.0 - an) ** 3,
        )
    elif name == "cosine":
        w = np.sin(np.pi * (n + 0.5) / m)
    elif name == "lanczos":
        w = np.sinc(2.0 * n / (m - 1) - 1.0) if m > 1 else np.ones(1)
    elif name == "kaiser":
        if not params:
            raise ValueError("kaiser window needs a beta parameter")
        w = np.kaiser(m, params[0])
    elif name == "gaussian":
        if not params:
            raise ValueError("gaussian window needs a std parameter")
        w = np.exp(-0.5 * ((n - (m - 1) / 2.0) / params[0]) ** 2)
    elif name == "exponential":
        # scipy's parameter order is (center, tau) — the single-param
        # spelling sets the CENTER; pass (None, tau) for a decay scale
        center = params[0] if len(params) >= 1 else None
        tau = params[1] if len(params) >= 2 else 1.0
        if not fftbins and center is not None:
            raise ValueError("symmetric exponential requires center=None")
        if center is None:
            center = (m - 1) / 2.0
        w = np.exp(-np.abs(n - center) / tau)
    elif name == "tukey":
        alpha = params[0] if params else 0.5
        if alpha <= 0:
            w = np.ones(m)
        elif alpha >= 1:
            w = cos_sum([0.5, 0.5])
        else:
            w = np.ones(m)
            width = int(np.floor(alpha * (m - 1) / 2.0))
            idx = np.arange(width + 1)
            edge = 0.5 * (
                1 + np.cos(np.pi * (2.0 * idx / (alpha * (m - 1)) - 1.0))
            )
            w[: width + 1] = edge
            w[m - width - 1 :] = edge[::-1]
    elif name == "general_cosine":
        if not params:
            raise ValueError("general_cosine needs a coefficient sequence")
        w = cos_sum(np.asarray(params[0], np.float64))
    elif name == "general_hamming":
        if not params:
            raise ValueError("general_hamming needs alpha")
        alpha = float(params[0])
        w = cos_sum([alpha, 1.0 - alpha])
    elif name == "general_gaussian":
        if len(params) < 2:
            raise ValueError("general_gaussian needs (p, sigma)")
        pw, sig = float(params[0]), float(params[1])
        w = np.exp(-0.5 * np.abs((n - (m - 1) / 2.0) / sig) ** (2 * pw))
    elif name == "chebwin":
        if not params:
            raise ValueError("chebwin needs an attenuation in dB")
        w = _chebwin(m, float(params[0]))
    elif name == "taylor":
        nbar = int(params[0]) if len(params) >= 1 else 4
        sll = float(params[1]) if len(params) >= 2 else 30.0
        norm = bool(params[2]) if len(params) >= 3 else True
        w = _taylor(m, nbar, sll, norm)
    elif name == "dpss":
        if not params:
            raise ValueError("dpss needs a half-bandwidth parameter NW")
        nw_ = float(params[0])
        w = dpss_windows(m, nw_, 1)[0][0]
        # scipy's 'approximate' norm: max-normalize, with an even-length
        # half-sample correction M^2/(M^2 + NW)
        w = w / np.max(np.abs(w))
        if m % 2 == 0:
            w = w * (m * m / (m * m + nw_))
    elif name == "kaiser_bessel_derived":
        if not params:
            raise ValueError("kaiser_bessel_derived needs beta")
        if fftbins:
            raise ValueError(
                "Kaiser-Bessel Derived windows are only defined for "
                "symmetric shapes"
            )
        w = _kbd(m, float(params[0]))
    else:
        raise ValueError(f"unknown window {name!r}")
    if fftbins:
        w = w[:-1]
    return w.astype(np.float64)


def check_cola(window, nperseg: int, noverlap: int, tol: float = 1e-10) -> bool:
    """Constant-overlap-add check (scipy.signal.check_COLA): windows
    summed at the hop must be constant — the istft/WOLA exactness
    precondition."""
    if not 0 <= noverlap < nperseg:
        raise ValueError("need 0 <= noverlap < nperseg")
    w = (
        np.asarray(window, np.float64)
        if not isinstance(window, (str, tuple))
        else get_window(window, nperseg)
    )
    if w.shape[0] != nperseg:
        raise ValueError("window length must equal nperseg")
    hop = nperseg - noverlap
    binsums = np.sum(
        [w[i * hop : i * hop + hop] for i in range(nperseg // hop)], axis=0
    )
    if nperseg % hop != 0:
        binsums[: nperseg % hop] += w[-(nperseg % hop) :]
    return bool(np.max(np.abs(binsums - binsums[0])) < tol)


def check_nola(window, nperseg: int, noverlap: int, tol: float = 1e-10) -> bool:
    """Nonzero-overlap-add check (scipy.signal.check_NOLA): the weaker
    invertibility condition for least-squares istft."""
    if not 0 <= noverlap < nperseg:
        raise ValueError("need 0 <= noverlap < nperseg")
    w = (
        np.asarray(window, np.float64)
        if not isinstance(window, (str, tuple))
        else get_window(window, nperseg)
    )
    if w.shape[0] != nperseg:
        raise ValueError("window length must equal nperseg")
    hop = nperseg - noverlap
    binsums = np.sum(
        [w[i * hop : i * hop + hop] ** 2 for i in range(nperseg // hop)],
        axis=0,
    )
    if nperseg % hop != 0:
        binsums[: nperseg % hop] += w[-(nperseg % hop) :] ** 2
    return bool(np.min(binsums) > tol)


def czt_points(m: int, w: complex | None = None, a: complex = 1 + 0j):
    """The m contour points a * w^-k the CZT evaluates at
    (scipy.signal.czt_points); host NumPy."""
    k = np.arange(m)
    if w is None:
        w = np.exp(-2j * np.pi / m)
    return a * np.asarray(w) ** -k


class CZT:
    """Plan-style callable chirp-z transform (scipy.signal.CZT): freezes
    (n, m, w, a); the chirp matrix is built once a device."""

    def __init__(self, n: int, m: int | None = None, w=None, a=1 + 0j):
        if m is None:
            m = n
        if w is None:
            w = np.exp(-2j * np.pi / m)
        self._n, self._m, self._w, self._a = int(n), int(m), w, a

    def __call__(self, x, *, axis: int = -1):
        xm = torch.movedim(as_signal(x), axis, -1)
        if xm.shape[-1] != self._n:
            raise ValueError(
                f"CZT planned for n={self._n}, got {xm.shape[-1]}"
            )
        out = czt(xm, m=self._m, w=self._w, a=self._a)
        return torch.movedim(out, -1, axis)

    def points(self):
        return czt_points(self._m, self._w, self._a)


class ZoomFFT(CZT):
    """Plan-style zoom FFT over a frequency band (scipy.signal.ZoomFFT)."""

    def __init__(self, n: int, fn, m: int | None = None, *, fs: float = 2.0):
        fn = np.atleast_1d(np.asarray(fn, np.float64))
        if fn.size == 1:
            f1, f2 = 0.0, float(fn[0])
        else:
            f1, f2 = float(fn[0]), float(fn[1])
        if m is None:
            m = n
        w = np.exp(-2j * np.pi * (f2 - f1) / (m * fs))
        a = np.exp(2j * np.pi * f1 / fs)
        super().__init__(n, m, w, a)
        self.f1, self.f2, self.fs = f1, f2, fs


def _chebwin(m: int, at: float) -> np.ndarray:
    """Dolph-Chebyshev window (scipy.signal.windows.chebwin): inverse DFT
    of the equiripple Chebyshev spectrum."""
    if m == 1:
        return np.ones(1)
    order = m - 1.0
    beta = np.cosh(1.0 / order * np.arccosh(10 ** (abs(at) / 20.0)))
    k = np.arange(m)
    x = beta * np.cos(np.pi * k / m)
    # Chebyshev polynomial T_order evaluated off [-1, 1] without overflow;
    # T_n(-x) = (-1)^n T_n(x) supplies the sign for x < -1
    p = np.zeros(m)
    big = np.abs(x) > 1
    p[big] = np.cosh(order * np.arccosh(np.abs(x[big])))
    p[big & (x < 0)] *= (-1.0) ** (int(order) % 2)
    p[~big] = np.cos(order * np.arccos(x[~big]))
    if m % 2:
        wr = np.real(np.fft.fft(p))
        half = (m + 1) // 2
        wr = wr[:half]
        w = np.concatenate([wr[:0:-1], wr])
    else:
        p_ = p * np.exp(1j * np.pi / m * np.arange(m))
        wr = np.real(np.fft.fft(p_))
        half = m // 2 + 1
        wr = wr[1:half]
        w = np.concatenate([wr[::-1], wr])
    return w / np.max(w)


def _taylor(
    m: int, nbar: int, sll: float, norm: bool
) -> np.ndarray:
    """Taylor window (scipy.signal.windows.taylor semantics)."""
    if m == 1:
        return np.ones(1)
    b = 10.0 ** (sll / 20.0)
    a = np.arccosh(b) / np.pi
    s2 = nbar**2 / (a**2 + (nbar - 0.5) ** 2)
    ma = np.arange(1, nbar)
    fm = np.empty(nbar - 1)
    signs = np.empty_like(ma, float)
    signs[::2] = 1.0
    signs[1::2] = -1.0
    m2 = ma**2
    for mi, _ in enumerate(ma):
        numer = signs[mi] * np.prod(
            1 - m2[mi] / s2 / (a**2 + (ma - 0.5) ** 2)
        )
        denom = 2 * np.prod(1 - m2[mi] / m2[:mi]) * np.prod(
            1 - m2[mi] / m2[mi + 1 :]
        )
        fm[mi] = numer / denom

    def get(n_):
        return 1 + 2 * np.dot(
            fm, np.cos(2 * np.pi * ma[:, None] * (n_ - m / 2.0 + 0.5) / m)
        )
    w = get(np.arange(m))
    if norm:
        w = w / get((m - 1) / 2.0)
    return w


def _kbd(m: int, beta: float) -> np.ndarray:
    """Kaiser-Bessel derived window (symmetric only)."""
    if m % 2:
        raise ValueError("kaiser_bessel_derived requires an even length")
    kw = np.kaiser(m // 2 + 1, beta)
    csum = np.cumsum(kw)
    half = np.sqrt(csum[:-1] / csum[-1])
    return np.concatenate([half, half[::-1]])


def dpss_windows(
    m: int, nw: float, k_max: int, *, return_ratios: bool = False
):
    """Discrete prolate spheroidal (Slepian) sequences — the first
    ``k_max`` maximally band-concentrated windows (scipy.signal.windows.dpss
    semantics: tridiagonal eigenvector formulation, even windows
    positive-mean, odd windows positive-initial-slope).

    Returns ``(windows, ratios)`` with ``windows`` of shape
    ``(k_max, m)``; ``ratios`` are the in-band energy concentrations
    (computed only when ``return_ratios``).
    """
    import scipy.linalg as sla

    if not 0 < nw < m / 2:
        raise ValueError(f"need 0 < NW < M/2, got NW={nw}, M={m}")
    w_bin = nw / m
    n = np.arange(m)
    diag = ((m - 1 - 2 * n) / 2.0) ** 2 * np.cos(2 * np.pi * w_bin)
    off = n[1:] * (m - n[1:]) / 2.0
    vals, vecs = sla.eigh_tridiagonal(
        diag, off, select="i", select_range=(m - k_max, m - 1)
    )
    windows = vecs.T[::-1]
    # sign conventions (scipy): even orders sum positive, odd orders start
    # with a positive slope
    fix_even = windows[::2].sum(axis=1) < 0
    for i, f in enumerate(fix_even):
        if f:
            windows[2 * i] *= -1
    thresh = max(1e-7, 1.0 / m)
    for i, wlp in enumerate(windows[1::2]):
        if wlp[wlp * wlp > thresh][0] < 0:
            windows[2 * i + 1] *= -1
    if not return_ratios:
        return windows, None
    # concentration via the sinc kernel quadratic form
    dn = n[:, None] - n[None, :]
    with np.errstate(invalid="ignore", divide="ignore"):
        kern = np.sin(2 * np.pi * w_bin * dn) / (np.pi * dn)
    kern[np.arange(m), np.arange(m)] = 2 * w_bin
    ratios = np.einsum("km,mn,kn->k", windows, kern, windows)
    return windows, ratios


def multitaper_psd(
    x,
    *,
    nw: float = 4.0,
    k_tapers: int | None = None,
    nfft: int | None = None,
    fs: float = 1.0,
    scaling: str = "density",
) -> torch.Tensor:
    """Thomson multitaper PSD: mean of ``k`` DPSS-tapered periodograms
    (the low-variance, low-leakage estimator Welch averaging cannot reach
    for short records). The tapers come from :func:`dpss_windows` on the
    host; the ``k`` tapered copies go through one batched ``torch.fft.rfft``."""
    x = _real32(x)
    xp = x if x.dim() == 2 else x[None, :]
    t = xp.shape[-1]
    n = nfft or t
    k = k_tapers or max(1, int(2 * nw) - 1)
    tapers, _ = dpss_windows(t, nw, k)
    xf = xp - xp.mean(dim=-1, keepdim=True)
    seg = xf[:, None, :] * torch.from_numpy(tapers.astype(np.float32)).to(xp.device)  # (C, K, T)
    s = torch.fft.rfft(seg, n=n if n > t else None, dim=-1)
    p = (s.abs() ** 2).mean(dim=-2)
    if scaling == "density":
        p = p / fs
    elif scaling != "spectrum":
        raise ValueError(f"unknown scaling {scaling!r}")
    out = p * _one_sided_scale(n, str(p.device))
    return out if x.dim() == 2 else out[0]


__all__ = [
    "FFT_METHODS",
    "XLA_FFT_MAX_N",
    "HILBERT_BLOCKED_MIN_T",
    "HILBERT_XLA_MAX_T",
    "fft",
    "ifft",
    "rfft",
    "irfft",
    "spectral_window",
    "stft",
    "istft",
    "power_spectrum",
    "welch",
    "periodogram",
    "csd",
    "coherence",
    "spectrogram",
    "tone_power",
    "hilbert",
    "design_hilbert_fir",
    "hilbert_fir",
    "envelope",
    "czt",
    "zoomfft",
    "hilbert2",
    "get_window",
    "check_cola",
    "check_nola",
    "czt_points",
    "CZT",
    "ZoomFFT",
    "dpss_windows",
    "multitaper_psd",
]
