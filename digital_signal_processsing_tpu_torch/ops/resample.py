"""Polyphase resampling: decimate / interpolate / rational resample, upfirdn, FFT.

Counterpart of ``digital_signal_processsing_tpu/ops/resample.py``. Conventions match
``ops/fir.py``: planar ``(channels, time)`` float32, causal. The decimating
FIR is one strided ``conv1d`` (``fir.causal_conv``), output m at input
``m * q`` and ``t // q`` outputs, as the reference's; the interpolating FIR
is one ``conv_transpose1d`` (``fir.interp_conv``). Both run in IEEE float32.
``upfirdn`` is one of the two over the right-padded stream, then a strided
slice; the reference's banded tap matrix served its TPU and is not carried
over. ``resample_fft`` runs on ``torch.fft``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .fir import _as_planar, _taps_on, causal_conv, design_lowpass, interp_conv


def decimate(
    x: torch.Tensor,
    factor: int,
    *,
    taps=None,
    taps_per_phase: int = 8,
    ftype: str = "fir",
) -> torch.Tensor:
    """Anti-aliased downsampling by an integer factor.

    ``ftype='fir'``: polyphase FIR, a windowed-sinc lowpass at 0.8/factor
    Nyquist with ``taps_per_phase * factor`` taps unless ``taps`` is given:
    ``y[m] = sum_j h[j] x[m*factor - j]``, ``t // factor`` outputs.
    ``ftype='iir'``: the zero-phase Chebyshev-I cascade of
    ``ops.iir.decimate_iir`` (scipy.signal.decimate's default); ``taps`` and
    ``taps_per_phase`` are FIR-only.
    """
    if factor < 1:
        raise ValueError(f"factor must be >= 1, got {factor}")
    if ftype == "iir":
        if taps is not None:
            raise ValueError("taps is only meaningful with ftype='fir'")
        from .iir import decimate_iir

        return decimate_iir(x, factor)
    if ftype != "fir":
        raise ValueError(f"ftype must be 'fir' or 'iir', got {ftype!r}")
    xp, squeeze = _as_planar(x)
    if factor == 1:
        y = xp.to(torch.float32)
        return y[0] if squeeze else y
    if taps is None:
        taps = design_lowpass(taps_per_phase * factor, 0.8 / factor)
    y = causal_conv(xp, _taps_on(taps, xp.device), stride=factor)
    return y[0] if squeeze else y


def interpolate(
    x: torch.Tensor,
    factor: int,
    *,
    taps=None,
    taps_per_phase: int = 8,
) -> torch.Tensor:
    """Anti-imaged upsampling by an integer factor (polyphase zero-stuff)."""
    if factor < 1:
        raise ValueError(f"factor must be >= 1, got {factor}")
    xp, squeeze = _as_planar(x)
    if factor == 1:
        y = xp.to(torch.float32)
        return y[0] if squeeze else y
    if taps is None:
        # gain `factor` compensates the zero-stuffing energy loss
        taps = design_lowpass(taps_per_phase * factor, 0.8 / factor) * factor
    y = interp_conv(xp, _taps_on(taps, xp.device), up=factor)
    return y[0] if squeeze else y


def resample_poly(
    x: torch.Tensor,
    up: int,
    down: int,
    *,
    taps=None,
    taps_per_phase: int = 8,
) -> torch.Tensor:
    """Rational-rate resample by up/down with ONE combined filter.

    scipy.signal.resample_poly semantics as in the reference: one lowpass at
    min(1/up, 1/down) of Nyquist, gain ``up``, applied once.
    """
    if up < 1 or down < 1:
        raise ValueError(f"up/down must be >= 1, got {up}/{down}")
    g = np.gcd(up, down)
    up, down = up // g, down // g
    xp, squeeze = _as_planar(x)
    xp = xp.to(torch.float32)
    if up == 1 and down == 1:
        return xp[0] if squeeze else xp
    q = max(up, down)
    if taps is None:
        taps = design_lowpass(taps_per_phase * q, 0.8 / q)
    h = _taps_on(taps, xp.device)
    if up > 1:
        y = interp_conv(xp, h * up, up=up)
        if down > 1:
            y = y[:, ::down]  # the combined filter already anti-aliased
    else:
        y = causal_conv(xp, h, stride=down)
    return y[0] if squeeze else y


def resample_fft(x: torch.Tensor, num: int) -> torch.Tensor:
    """Fourier-domain resampling to exactly ``num`` samples (scipy.signal.resample,
    real input, no window).

    Truncates or zero-extends the one-sided spectrum with scipy's
    Nyquist-bin bookkeeping (doubled when downsampling drops its conjugate
    half, halved when upsampling splits it). Treats the signal as periodic,
    as scipy does; streams take :func:`resample_poly` or the Farrow stage.
    """
    if num < 1:
        raise ValueError(f"num must be >= 1, got {num}")
    xp, squeeze = _as_planar(x)
    c, t = xp.shape
    spec = torch.fft.rfft(xp.to(torch.float32), dim=-1)
    n = min(num, t)
    nyq = n // 2 + 1
    out = spec.new_zeros((c, num // 2 + 1))
    out[:, :nyq] = spec[:, :nyq]
    if n % 2 == 0:
        if num < t:
            out[:, n // 2] *= 2.0
        elif num > t:
            out[:, n // 2] *= 0.5
    y = torch.fft.irfft(out, n=num, dim=-1) * (num / t)
    return y[0] if squeeze else y


def upfirdn(h, x: torch.Tensor, up: int = 1, down: int = 1) -> torch.Tensor:
    """Zero-stuff by ``up``, FIR filter by ``h``, keep every ``down``-th sample
    (scipy.signal.upfirdn's semantics and output length, (t-1)*up + k samples
    before the decimation)."""
    if up < 1 or down < 1:
        raise ValueError(f"up/down must be >= 1, got {up}/{down}")
    if np.ndim(h) != 1:
        raise ValueError(f"h must be 1-D taps, got shape {np.shape(h)}")
    xp, squeeze = _as_planar(x)
    taps = _taps_on(h, xp.device)
    t, k = xp.shape[-1], taps.shape[0]
    n_full = (t - 1) * up + k  # the full convolution of the zero-stuffed stream
    # right-pad so that the causal FIR covers the full convolution's tail
    extra = -(-(k - 1) // up) if up > 1 else k - 1
    xpad = F.pad(xp.to(torch.float32), (0, extra))
    y = interp_conv(xpad, taps, up=up) if up > 1 else causal_conv(xpad, taps)
    y = y[..., :n_full][..., ::down]
    return y[0] if squeeze else y


__all__ = ["decimate", "interpolate", "resample_poly", "resample_fft", "upfirdn"]
