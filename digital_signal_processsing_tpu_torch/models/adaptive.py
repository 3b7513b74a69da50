"""The frequency-tracking notch: remove a narrowband interferer that wanders.

Counterpart of the serving part of
``digital_signal_processsing_tpu/models/adaptive.py``. The notch adapts a
frame at a time: each frame's dominant tone comes from a Hann-windowed
``rfft`` peak refined by parabolic interpolation, a notch row is designed for
it, and the rows run through ``sosfilt_tv_frames`` (B18 on the card).
Tracking latency is one frame; once locked the rejection matches a
sample-by-sample loop.

Not ported yet: the block-LMS trainer (``AdaptiveFir``, ``lms_train_step``,
``identify_system``), its sharded step, and the sample-recursive ``nlms`` and
``rls``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import iir
from ..ops.fft import rfft, spectral_window
from ..utils.layout import overlapping_frames


def estimate_tone_frequency(x: torch.Tensor, frame_len: int, *,
                            nfft: int | None = None) -> torch.Tensor:
    """Per-frame dominant-tone frequency in Nyquist units, ``(..., F)`` float32.

    Hann-windowed ``rfft`` magnitude peak (DC and Nyquist excluded), refined
    by parabolic interpolation on the log magnitude.
    """
    if nfft is None:
        nfft = frame_len
    nframes = max(0, x.shape[-1] // frame_len)
    fr = overlapping_frames(x.to(torch.float32), nframes, frame_len, frame_len)
    w = torch.from_numpy(spectral_window("hann", frame_len)).to(x.device)
    spec = torch.abs(rfft(fr * w, n=nfft, axis=-1))
    k = torch.argmax(spec[..., 1:-1], dim=-1) + 1
    logm = torch.log(torch.clamp(spec, min=1e-20))
    km1 = torch.gather(logm, -1, (k - 1)[..., None])[..., 0]
    k0 = torch.gather(logm, -1, k[..., None])[..., 0]
    kp1 = torch.gather(logm, -1, (k + 1)[..., None])[..., 0]
    denom = km1 - 2.0 * k0 + kp1
    safe = torch.where(torch.abs(denom) > 1e-12, denom, torch.ones_like(denom))
    delta = torch.where(torch.abs(denom) > 1e-12, 0.5 * (km1 - kp1) / safe, torch.zeros_like(denom))
    delta = torch.clamp(delta, -0.5, 0.5)
    return (k.to(torch.float32) + delta) * (2.0 / nfft)


def notch_rows(w0: torch.Tensor, q: float) -> torch.Tensor:
    """scipy-layout notch rows ``(..., 6)``, one a frequency of ``w0`` (Nyquist
    units), -3 dB bandwidth ``w0 / q`` (scipy's ``iirnotch``)."""
    om = np.pi * w0.to(torch.float32)
    gain = 1.0 / (1.0 + torch.tan(om / (2.0 * q)))
    c = torch.cos(om)
    one = torch.ones_like(gain)
    return torch.stack(
        [gain, -2.0 * gain * c, gain, one, -2.0 * gain * c, 2.0 * gain - 1.0], -1
    )


def tracking_notch(x: torch.Tensor, frame_len: int, *,
                   q: float = 30.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Remove a frequency-wandering narrowband interferer: ``(cleaned, freqs)``.

    Estimates the dominant tone of each ``frame_len`` block and applies that
    frame's notch through the time-varying SOS kernel (B18 inside the
    reference's frames envelope). ``freqs``: the per-frame estimates in
    Nyquist units. The tail past the last whole frame takes the last frame's
    notch.
    """
    n = x.shape[-1]
    nf = n // frame_len
    if nf == 0:
        raise ValueError(f"signal shorter than one frame ({n} < {frame_len})")
    w0 = estimate_tone_frequency(x[..., : nf * frame_len], frame_len)
    rows = notch_rows(w0, q)  # (..., F, 6)
    pad_frames = -(-n // frame_len) - nf
    if pad_frames:
        rows = torch.cat([rows, rows[..., -1:, :].expand(rows.shape[:-2] + (pad_frames, 6))], -2)
    return iir.sosfilt_tv_frames(rows[None], x, frame_len), w0


__all__ = ["estimate_tone_frequency", "notch_rows", "tracking_notch"]
