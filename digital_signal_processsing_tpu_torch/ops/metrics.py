"""Single-tone purity instruments: THD, SINAD, SNR, SFDR, ENOB.

The ADC and RF test-bench metrics (IEEE 1241 style): one windowed power
spectrum of a tone-dominated record, the fundamental and its harmonics
integrated over the window's leakage width, everything else counted as
noise; harmonics past Nyquist fold back as on a real converter. One rFFT and
masked reductions on the record's device, no host round trip until a caller
reads a number (the reference package's ``ops/metrics.py``).

The windowed record is float32 as in the reference; its transform and the
masked sums are float64. The noise is a difference of sums (total less the
fundamental), and for an int16 tone it sits some 1e-10 below the total: a
float32 sum does not resolve it, and a float32 transform's own rounding
(about 1e-14 of the total) moves it by 1e-3 dB between two FFT libraries.
"""

from __future__ import annotations

import torch

from ..utils.device import as_tensor
from .fft import spectral_window

__all__ = ["tone_metrics", "thd", "sinad", "snr_tone", "sfdr", "enob"]


def _db(r: torch.Tensor) -> torch.Tensor:
    return 10.0 * torch.log10(torch.clamp(r, min=1e-30))


def tone_metrics(
    x,
    *,
    window: str = "hann",
    n_harmonics: int = 6,
    leak: int = 3,
    dc_guard: int = 5,
    device="cuda",
) -> dict:
    """All purity metrics of a tone-dominated 1-D record in one pass.

    Returns a dict of 0-d float32 tensors, computed in float64: ``f0``
    (cycles/sample), ``fund_db`` (dB, arbitrary reference), ``thd_db`` (dBc,
    harmonics 2..n against the
    fundamental), ``snr_db`` (fundamental against the noise without the
    harmonics), ``sinad_db`` (against everything else), ``sfdr_db`` (against
    the largest spur, harmonics included) and ``enob`` ((SINAD - 1.76) / 6.02).

    Each component integrates ``2 * leak + 1`` bins around its line; the first
    ``dc_guard`` bins are left out everywhere.
    """
    xf = as_tensor(x, device).to(torch.float32)
    if xf.dim() != 1:
        raise ValueError(f"tone_metrics expects a 1-D record, got {tuple(xf.shape)}")
    n = xf.shape[0]
    w = torch.from_numpy(spectral_window(window, n)).to(xf.device)
    p = torch.abs(torch.fft.rfft((xf * w).to(torch.float64))) ** 2
    nb = p.shape[0]
    bins = torch.arange(nb, device=xf.device)
    guard = bins < dc_guard
    zero = torch.zeros((), dtype=p.dtype, device=p.device)

    def line_mask(k):
        return (torch.abs(bins - k) <= leak) & ~guard

    k0 = torch.argmax(torch.where(guard, -torch.inf, p))
    fund_mask = line_mask(k0)
    p_fund = torch.sum(torch.where(fund_mask, p, zero))

    harm_mask = torch.zeros(nb, dtype=torch.bool, device=xf.device)
    for h in range(2, n_harmonics + 1):
        kh = (h * k0) % n
        kh = torch.where(kh > n // 2, n - kh, kh)  # fold past Nyquist
        harm_mask = harm_mask | line_mask(kh)
    harm_mask = harm_mask & ~fund_mask
    p_harm = torch.sum(torch.where(harm_mask, p, zero))

    p_total = torch.sum(torch.where(guard, zero, p))
    p_noise = torch.clamp(p_total - p_fund - p_harm, min=1e-30)
    p_nad = torch.clamp(p_total - p_fund, min=1e-30)

    # the largest spur: the leak window around the biggest bin off the fundamental
    ks = torch.argmax(torch.where(fund_mask | guard, -torch.inf, p))
    p_spur = torch.sum(torch.where(line_mask(ks) & ~fund_mask, p, zero))

    sinad_db = _db(p_fund / p_nad)
    out = {
        "f0": k0.to(torch.float64) / n,
        "fund_db": _db(p_fund),
        "thd_db": _db(p_harm / p_fund),
        "snr_db": _db(p_fund / p_noise),
        "sinad_db": sinad_db,
        "sfdr_db": _db(p_fund / torch.clamp(p_spur, min=1e-30)),
        "enob": (sinad_db - 1.76) / 6.02,
    }
    return {k: v.to(torch.float32) for k, v in out.items()}


def thd(x, **kw) -> float:
    """Total harmonic distortion in dBc (negative for clean signals)."""
    return float(tone_metrics(x, **kw)["thd_db"])


def sinad(x, **kw) -> float:
    """Signal to noise-and-distortion ratio in dB."""
    return float(tone_metrics(x, **kw)["sinad_db"])


def snr_tone(x, **kw) -> float:
    """Tone SNR in dB (harmonics left out of the noise)."""
    return float(tone_metrics(x, **kw)["snr_db"])


def sfdr(x, **kw) -> float:
    """Spurious-free dynamic range in dB."""
    return float(tone_metrics(x, **kw)["sfdr_db"])


def enob(x, **kw) -> float:
    """Effective number of bits: (SINAD - 1.76 dB) / 6.02."""
    return float(tone_metrics(x, **kw)["enob"])
