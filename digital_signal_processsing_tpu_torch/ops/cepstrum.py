"""Cepstral analysis: real/complex cepstrum and inverses, the port of
``digital_signal_processsing_tpu/ops/cepstrum.py``.

Classic homomorphic DSP (echo detection, pitch tracking). The spectra are
``torch.fft`` on the input's device; the public API takes and returns real
tensors plus the standard ``ndelay`` integer (matlab ``rceps``/``cceps``
conventions). :func:`unwrap` is ``numpy.unwrap`` along the last axis
(discontinuity pi, period 2 pi), which torch lacks.
"""

from __future__ import annotations

import math

import torch

from .fft import _real32


def unwrap(p: torch.Tensor) -> torch.Tensor:
    """Phase unwrap along the last axis, ``numpy.unwrap(p, axis=-1)``.

    Each jump larger than pi between neighbours is brought into
    [-pi, pi) by adding a multiple of 2 pi (a jump of exactly -pi after a
    positive difference becomes +pi, as NumPy does); the corrections
    accumulate along the axis.
    """
    dd = p[..., 1:] - p[..., :-1]
    ddmod = torch.remainder(dd + math.pi, 2.0 * math.pi) - math.pi
    ddmod = torch.where((ddmod == -math.pi) & (dd > 0), torch.full_like(ddmod, math.pi), ddmod)
    correct = torch.where(dd.abs() < math.pi, torch.zeros_like(dd), ddmod - dd)
    out = p.clone()
    out[..., 1:] += torch.cumsum(correct, dim=-1)
    return out


def real_cepstrum(x) -> torch.Tensor:
    """c = irfft(log |rfft(x)|) over the last axis (matlab ``rceps``)."""
    xf = _real32(x)
    n = xf.shape[-1]
    spec = torch.fft.rfft(xf, dim=-1)
    logmag = torch.log(torch.clamp(spec.abs(), min=1e-30))
    return torch.fft.irfft(logmag, n=n, dim=-1)


def complex_cepstrum(x) -> tuple[torch.Tensor, torch.Tensor]:
    """Complex cepstrum with linear-phase removal (matlab ``cceps``).

    Returns ``(cepstrum, ndelay)``: the phase is unwrapped, the linear
    trend (circular delay of ``ndelay`` samples, int32) removed so the log
    spectrum is continuous and the cepstrum real. Invert with
    :func:`inverse_complex_cepstrum`.
    """
    xf = _real32(x)
    n = xf.shape[-1]
    spec = torch.fft.fft(xf, dim=-1)
    phase = unwrap(torch.angle(spec))
    center = (n + 1) // 2
    # at n = 1 the centre bin is past the end: the reference's gather clamps it to n - 1
    ndelay = torch.round(phase[..., min(center, n - 1)] * (n / (2.0 * math.pi * center)))
    k = torch.arange(n, dtype=torch.float32, device=xf.device)
    phase = phase - 2.0 * math.pi * ndelay[..., None] * k / n
    logspec = torch.complex(torch.log(torch.clamp(spec.abs(), min=1e-30)), phase)
    ceps = torch.fft.ifft(logspec, dim=-1).real
    return ceps, ndelay.to(torch.int32)


def inverse_complex_cepstrum(ceps, ndelay) -> torch.Tensor:
    """Invert :func:`complex_cepstrum` (matlab ``icceps``): restore the
    linear phase and exponentiate back to the signal."""
    cf = _real32(ceps)
    n = cf.shape[-1]
    logspec = torch.fft.fft(cf, dim=-1)
    k = torch.arange(n, dtype=torch.float32, device=cf.device)
    nd = torch.as_tensor(ndelay).to(device=cf.device, dtype=torch.float32)
    lin = 2.0 * math.pi * nd[..., None] * k / n
    logspec = logspec + torch.complex(torch.zeros_like(lin), lin)
    return torch.fft.ifft(torch.exp(logspec), dim=-1).real


def cepstral_pitch(x, *, fs: float = 1.0, n_lifter: int = 32) -> torch.Tensor:
    """Pitch estimate from the real cepstrum's dominant quefrency peak
    (the classic Noll method); ``n_lifter`` low quefrencies are excluded
    to skip the spectral-envelope region. Returns Hz (given ``fs``)."""
    c = real_cepstrum(x)
    n = c.shape[-1]
    region = c[..., n_lifter : n // 2]
    q = torch.argmax(region, dim=-1) + n_lifter
    return fs / q.to(torch.float32)


__all__ = [
    "unwrap",
    "real_cepstrum",
    "complex_cepstrum",
    "inverse_complex_cepstrum",
    "cepstral_pitch",
]
