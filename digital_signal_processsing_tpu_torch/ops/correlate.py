"""Cross-/auto-correlation and convolution over the last axis, the port of
``digital_signal_processsing_tpu/ops/correlate.py``.

Semantics follow ``scipy.signal.correlate``/``convolve``. Three routes, as
in the reference:

- ``direct`` (and ``direct_gauss`` for complex inputs): correlation as a
  causal FIR with the reversed template, ``fir.fir_direct`` — one
  ``conv1d`` in IEEE float32 a product (the reference's banded conv, which
  it leaves to XLA outside any Pallas kernel);
- the FFT route: one padded power-of-two ``torch.fft`` round trip (cuFFT
  on the card) for every engine name the reference accepts;
- ``oaconvolve``/``convolve``: ``fir.fir_filter``'s ``auto``, the fused
  overlap-save kernels B8 and B9 on the card.

``auto`` keeps the reference's rule for the direct route (a 1-D template of
at most ``DIRECT_MAX_TAPS`` on a stream of at least ``DIRECT_MIN_STREAM``
and 8x the template). Complex signals are ``complex64`` inside; the planar
``(real, imag)`` interface of ``correlate_complex`` is the reference's.
The reference's ``optimization_barrier`` fences guard an XLA-TPU
miscompile and have no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.dispatch import record_choice
from .fft import _check_fft_method, as_signal, as_signal_like

MODES = ("full", "same", "valid")

# The reference's direct-vs-FFT crossover for correlate/correlate_complex,
# measured on its TPU (direct 5.0x the FFT at 128 taps on (64, 1M), the FFT
# ahead at 4096). Kept as the port's rule; the H100's own crossover at the
# radar shape is an open question in ROADMAP.md.
DIRECT_MAX_TAPS = 2048
DIRECT_MIN_STREAM = 65536


def _resolve_corr_method(method: str, ta: int, tv: int, v_ndim: int) -> str:
    """'direct' | 'direct_gauss' | the FFT-engine name.

    The direct path needs a single (1-D) template; the FFT path also
    accepts batched templates.
    """
    if method in ("direct", "direct_gauss"):
        if v_ndim != 1:
            raise ValueError(
                f"method={method!r} needs a 1-D template, got ndim={v_ndim}"
            )
        return method
    if (
        method == "auto"
        and v_ndim == 1
        and tv <= DIRECT_MAX_TAPS
        and ta >= DIRECT_MIN_STREAM
        and ta >= 8 * tv
    ):
        return "direct"
    return method


def _pow2(n: int) -> int:
    return 1 << int(np.ceil(np.log2(max(n, 2))))


def _rows(a: torch.Tensor, n: int) -> torch.Tensor:
    """(..., ta) -> (rows, n) float32, zero-padded on the right."""
    ta = a.shape[-1]
    return F.pad(a.to(torch.float32).reshape(-1, ta), (0, n - ta))


def _reversed(v: torch.Tensor, device) -> torch.Tensor:
    return v.to(device=device, dtype=torch.float32).flip(-1)


def _direct_full_real(a: torch.Tensor, v, n: int) -> torch.Tensor:
    """Full correlation as the causal FIR of the right-padded stream with
    the reversed template: conv(a_pad, v[::-1])[t] = sum_m v[m] a[t-tv+1+m]."""
    from .fir import fir_direct

    full = fir_direct(_rows(a, n), _reversed(v, a.device))
    return full.reshape(a.shape[:-1] + (n,))


def _direct_full_complex(ar, ai, vr, vi, n: int, gauss: bool):
    """Full complex correlation with h = reversed conj(v), planar.

    Four real products (yr = ar*hr - ai*hi, yi = ar*hi + ai*hr) as two
    convolutions of the stacked I and Q rows, or with ``gauss`` three
    (m1 = ar*hr, m2 = ai*hi, m3 = (ar+ai)*(hr+hi); yr = m1 - m2,
    yi = m3 - m1 - m2), whose last-ulp rounding can differ.
    """
    from .fir import fir_direct

    batch = ar.shape[:-1]
    r2, i2 = _rows(ar, n), _rows(ai, n)
    hr = _reversed(vr, r2.device)
    hi = -_reversed(vi, r2.device)
    if gauss:
        m1 = fir_direct(r2, hr)
        m2 = fir_direct(i2, hi)
        m3 = fir_direct(r2 + i2, hr + hi)
        fr, fi = m1 - m2, m3 - m1 - m2
    else:
        c = r2.shape[0]
        x2 = torch.cat([r2, i2], 0)
        yh_r = fir_direct(x2, hr)  # [ar*hr ; ai*hr]
        yh_i = fir_direct(x2, hi)  # [ar*hi ; ai*hi]
        fr, fi = yh_r[:c] - yh_i[c:], yh_i[:c] + yh_r[c:]
    return fr.reshape(batch + (n,)), fi.reshape(batch + (n,))


def _cut(full: torch.Tensor, mode: str, ta: int, tv: int) -> torch.Tensor:
    if mode == "full":
        return full
    if mode == "same":
        start = (tv - 1) // 2
        return full[..., start : start + ta]
    return full[..., tv - 1 : ta]


def correlate(a, v, mode: str = "full", *, method: str = "auto") -> torch.Tensor:
    """Correlate ``a`` with template ``v`` along the last axis.

    Real float32; leading axes of ``a`` are batch. Output lengths follow
    scipy.signal.correlate: full = Ta+Tv-1, same = Ta (centered),
    valid = Ta-Tv+1 (requires Ta >= Tv). ``method``: ``auto``, ``direct``
    or an FFT engine name (all ``torch.fft``).
    """
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; options {MODES}")
    a = as_signal(a)
    v = as_signal_like(v, a)
    ta = a.shape[-1]
    tv = v.shape[-1]
    if mode == "valid" and ta < tv:
        raise ValueError(f"valid mode needs len(a) >= len(v), got {ta} < {tv}")
    n = ta + tv - 1
    nfft = _pow2(n)
    method = _resolve_corr_method(method, ta, tv, v.dim())
    if method == "direct_gauss":
        raise ValueError(
            "method='direct_gauss' is the complex 3-multiplication "
            "identity — real correlate has no cross products; use 'direct'"
        )
    if method == "direct":
        record_choice("correlate", "direct")
        full = _direct_full_real(a, v, n)
    else:
        _check_fft_method(method)
        record_choice("correlate", "fft")
        fa = torch.fft.rfft(a.to(torch.float32), n=nfft)
        fv = torch.fft.rfft(_reversed(v, a.device), n=nfft)
        full = torch.fft.irfft(fa * fv, n=nfft)[..., :n]
    return _cut(full, mode, ta, tv)


def correlate_complex(
    ar,
    ai,
    vr,
    vi,
    mode: str = "full",
    *,
    method: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Complex correlation y[k] = sum_n a[n+k] conj(v[n]), planar I/Q.

    The I/Q matched-filter primitive (scipy.signal.correlate semantics for
    complex inputs): ``direct`` (two convolutions), ``direct_gauss`` (three)
    or one complex ``torch.fft`` round trip. Leading axes of ``a`` batch;
    returns (real, imag) float32.
    """
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; options {MODES}")
    ar = as_signal(ar)
    ai, vr, vi = (as_signal_like(t, ar) for t in (ai, vr, vi))
    ta = ar.shape[-1]
    tv = vr.shape[-1]
    if mode == "valid" and ta < tv:
        raise ValueError(f"valid mode needs len(a) >= len(v), got {ta} < {tv}")
    n = ta + tv - 1
    nfft = _pow2(n)
    method = _resolve_corr_method(method, ta, tv, vr.dim())
    if method in ("direct", "direct_gauss"):
        record_choice("correlate_complex", method)
        fr, fi = _direct_full_complex(ar, ai, vr, vi, n, gauss=method == "direct_gauss")
    else:
        _check_fft_method(method)
        record_choice("correlate_complex", "fft")
        dev = ar.device
        # correlation = convolution with the reversed conjugated template
        za = torch.complex(ar.to(torch.float32), ai.to(dev, torch.float32))
        zv = torch.complex(_reversed(vr, dev), -_reversed(vi, dev))
        y = torch.fft.ifft(torch.fft.fft(za, n=nfft) * torch.fft.fft(zv, n=nfft))[..., :n]
        fr, fi = y.real, y.imag
    return _cut(fr, mode, ta, tv), _cut(fi, mode, ta, tv)


def autocorrelate(x, maxlag: int, *, normalize: bool = True, method: str = "auto") -> torch.Tensor:
    """Autocorrelation r[k] = sum_n x[n] x[n+k] for k in [0, maxlag].

    ``normalize=True`` divides by r[0] (unit lag-0). Batched over leading
    axes; maxlag must be < the time length.
    """
    x = as_signal(x)
    t = x.shape[-1]
    if not 0 <= maxlag < t:
        raise ValueError(f"need 0 <= maxlag < {t}, got {maxlag}")
    nfft = _pow2(2 * t - 1)
    _check_fft_method(method)
    f = torch.fft.rfft(x.to(torch.float32), n=nfft)
    r = torch.fft.irfft(f.real**2 + f.imag**2, n=nfft)[..., : maxlag + 1]
    if normalize:
        r = r / torch.clamp(r[..., :1], min=1e-30)
    return r


def fftconvolve(a, v, mode: str = "full", *, method: str = "auto") -> torch.Tensor:
    """Convolve ``a`` with ``v`` along the last axis via one padded DFT
    round trip (scipy.signal.fftconvolve, real inputs): correlation with
    the flipped template. ``same`` is centered on ``a`` like scipy."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; options {MODES}")
    a = as_signal(a)
    v = as_signal_like(v, a)
    full = correlate(a, v.flip(-1), mode="full", method=method)
    ta, tv = a.shape[-1], v.shape[-1]
    if mode == "valid" and ta < tv:
        raise ValueError(f"valid mode needs len(a) >= len(v), got {ta} < {tv}")
    return _cut(full, mode, ta, tv)


def oaconvolve(a, v, mode: str = "full", *, method: str = "auto") -> torch.Tensor:
    """Overlap-save convolution for long streams with a short kernel
    (scipy.signal.oaconvolve's role).

    Routes through :func:`ops.fir.fir_filter`'s ``auto``: the fused
    overlap-save kernels on the card (B8, or B9 past B8's transform).
    Falls back to :func:`fftconvolve` when the kernel is more than half the
    stream (and past 16384 taps). ``method`` is passed to that fallback.
    """
    from .fir import fir_filter

    a = as_signal(a)
    v = as_signal_like(v, a)
    ta, tv = a.shape[-1], v.shape[-1]
    if tv > max(ta // 2, 16384):
        return fftconvolve(a, v, mode, method=method)
    xp = a if a.dim() == 2 else a[None, :]
    full = fir_filter(F.pad(xp.to(torch.float32), (0, tv - 1)), v)
    if a.dim() != 2:
        full = full[0]
    if mode == "valid" and ta < tv:
        raise ValueError(f"valid mode needs len(a) >= len(v), got {ta} < {tv}")
    return _cut(full, mode, ta, tv)


def convolve(a, v, mode: str = "full", *, method: str = "auto") -> torch.Tensor:
    """scipy.signal.convolve-compatible front door: the overlap-save engine
    (:func:`oaconvolve`), or the one-shot DFT (:func:`fftconvolve`) with
    ``method='fft'``."""
    if method == "fft":
        return fftconvolve(a, v, mode)
    return oaconvolve(a, v, mode, method=method)


def find_delay(a, v) -> torch.Tensor:
    """Lag (samples) at which template ``v`` best aligns inside ``a``.

    argmax of the full cross-correlation, shifted so that 0 means
    "v starts at a[0]"; positive means v occurs later in a.
    """
    full = correlate(a, v, mode="full")
    return torch.argmax(full, dim=-1) - (v.shape[-1] - 1)


def correlation_lags(in1_len: int, in2_len: int, mode: str = "full"):
    """Lag index array matching :func:`correlate`'s output
    (scipy.signal.correlation_lags); host NumPy."""
    if mode == "full":
        return np.arange(-in2_len + 1, in1_len)
    if mode == "same":
        lags = np.arange(-in2_len + 1, in1_len)
        mid = lags.size // 2
        bound = in1_len // 2
        if in1_len % 2 == 0:
            return lags[mid - bound : mid + bound]
        return lags[mid - bound : mid + bound + 1]
    if mode == "valid":
        bound = in1_len - in2_len
        return np.arange(bound + 1) if bound >= 0 else np.arange(bound, 1)
    raise ValueError(f"unknown mode {mode!r}")


def vectorstrength(events, period):
    """Vector strength of events relative to (an array of) periods
    (scipy.signal.vectorstrength): resultant length and angle of the
    events mapped to phase circles. Runs on ``events``' device."""
    events = as_signal(events).to(torch.float32)
    per = torch.as_tensor(period, dtype=torch.float32).to(events.device)
    scalar = per.dim() == 0
    per = torch.atleast_1d(per)
    ang = 2.0 * np.pi * events[None, :] / per[:, None]
    re = torch.cos(ang).mean(-1)
    im = torch.sin(ang).mean(-1)
    strength = torch.sqrt(re * re + im * im)
    phase = torch.atan2(im, re)
    if scalar:
        return strength[0], phase[0]
    return strength, phase


def choose_conv_method(in1, in2, mode: str = "full"):
    """Pick 'fft' or 'direct' (scipy.signal.choose_conv_method).

    Mirrors what :func:`convolve`'s ``auto`` does: ``direct`` up to
    ``fir.FIR_FFT_CROSSOVER`` taps, ``fft`` (the fused overlap-save
    kernels) beyond. The port's crossover, measured on an H100, is 0, so
    the answer is ``fft`` for every kernel (the reference's TPU crossover
    answers ``direct`` below 3900 taps).
    """
    from . import fir as _fir

    n1 = in1 if isinstance(in1, int) else np.shape(in1)[-1]
    n2 = in2 if isinstance(in2, int) else np.shape(in2)[-1]
    k = min(n1, n2)
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    return "fft" if k >= _fir.FIR_FFT_CROSSOVER else "direct"


def gcc_phat(
    a,
    b,
    *,
    max_lag: int | None = None,
    method: str = "auto",
    eps: float = 1e-12,
) -> torch.Tensor:
    """Generalized cross-correlation with PHAT weighting.

    The cross spectrum ``Fa * conj(Fb)`` is magnitude-normalized per bin
    (phase transform), which whitens channel coloring so the correlation
    collapses to a band-limited impulse at the true delay. Returns ``cc`` of
    shape (..., 2*max_lag + 1) over lags [-max_lag, max_lag];
    ``cc[..., max_lag + d]`` peaks when ``a`` is ``b`` delayed by ``d``
    samples. ``max_lag`` defaults to min(len(a), len(b)) - 1.
    """
    a = as_signal(a)
    b = as_signal_like(b, a)
    ta, tb = a.shape[-1], b.shape[-1]
    if max_lag is None:
        max_lag = min(ta, tb) - 1
    n = ta + tb - 1
    nfft = _pow2(n)
    if not 0 < max_lag < nfft // 2:
        raise ValueError(f"max_lag must be in [1, {nfft // 2 - 1}], got {max_lag}")
    _check_fft_method(method)
    fa = torch.fft.rfft(a.to(torch.float32), n=nfft)
    fb = torch.fft.rfft(b.to(torch.float32), n=nfft)
    r = fa * fb.conj()
    r = r / torch.clamp(r.abs(), min=eps)
    cc = torch.fft.irfft(r, n=nfft)
    return torch.cat([cc[..., nfft - max_lag :], cc[..., : max_lag + 1]], dim=-1)


def find_delay_phat(a, b, *, max_lag: int | None = None):
    """Sub-sample delay of ``a`` relative to ``b`` via GCC-PHAT + 3-point
    parabolic interpolation. Returns a float32 tensor (batch shape of the
    broadcast inputs)."""
    cc = gcc_phat(a, b, max_lag=max_lag)
    m = (cc.shape[-1] - 1) // 2
    k = torch.argmax(cc, dim=-1)
    kc = torch.clamp(k, 1, cc.shape[-1] - 2)
    ym = torch.gather(cc, -1, (kc - 1)[..., None])[..., 0]
    y0 = torch.gather(cc, -1, kc[..., None])[..., 0]
    yp = torch.gather(cc, -1, (kc + 1)[..., None])[..., 0]
    denom = ym - 2.0 * y0 + yp
    safe = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    delta = torch.where(denom == 0.0, torch.zeros_like(denom), 0.5 * (ym - yp) / safe)
    delta = torch.clamp(delta, -0.5, 0.5)
    return (kc - m).to(torch.float32) + delta


__all__ = [
    "correlate",
    "correlate_complex",
    "autocorrelate",
    "convolve",
    "fftconvolve",
    "oaconvolve",
    "find_delay",
    "gcc_phat",
    "find_delay_phat",
    "MODES",
    "DIRECT_MAX_TAPS",
    "DIRECT_MIN_STREAM",
    "correlation_lags",
    "vectorstrength",
    "choose_conv_method",
]
