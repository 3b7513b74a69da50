"""Gain control and conditioning: AGC, DC blocker, soft clipper, dB, detrend.

Counterpart of ``digital_signal_processsing_tpu/ops/gain.py``. ``dc_block``
and ``agc`` run on the first-order recurrence :func:`ops.iir.iir_first_order`
(B10 on the card from PALLAS_IIR_MIN_T samples); the rest is elementwise
PyTorch. Float32 over the last axis.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .iir import iir_first_order


def dc_block(x: torch.Tensor, pole: float = 0.995) -> torch.Tensor:
    """One-pole DC blocker: y[n] = x[n] - x[n-1] + pole*y[n-1].

    About unity gain in the passband, a null at DC; ``pole`` in (0, 1), closer
    to 1 is a lower cutoff.
    """
    xf = x.to(torch.float32)
    prev = F.pad(xf[..., :-1], (1, 0))
    return iir_first_order(xf - prev, float(pole))


def agc(
    x: torch.Tensor,
    *,
    target: float = 0.5,
    attack: float = 0.01,
    floor: float = 1e-6,
) -> torch.Tensor:
    """Feedforward automatic gain control over the last axis.

    The envelope |x| is smoothed by a one-pole tracker with coefficient
    ``1 - attack``, debiased for its zero start (its mass at sample n is
    1 - (1-attack)^(n+1)), and the output is x scaled toward ``target``;
    ``floor`` bounds the gain in silence.
    """
    if not 0.0 < attack < 1.0:
        raise ValueError(f"attack must be in (0,1), got {attack}")
    xf = x.to(torch.float32)
    env = iir_first_order(torch.abs(xf), 1.0 - attack, b=attack)
    n = torch.arange(xf.shape[-1], dtype=torch.float32, device=xf.device)
    env = env / (1.0 - torch.pow(1.0 - attack, n + 1.0))
    return xf * (target / torch.clamp(env, min=floor))


def soft_clip(x: torch.Tensor, limit: float = 1.0) -> torch.Tensor:
    """tanh soft limiter scaled so |y| < limit; about linear for |x| << limit."""
    return torch.tanh(x.to(torch.float32) / limit) * limit


def db(x: torch.Tensor, floor_db: float = -200.0) -> torch.Tensor:
    """Amplitude -> 20*log10(|x|), floored for zeros."""
    a = torch.abs(x.to(torch.float32))
    return torch.clamp(20.0 * torch.log10(torch.clamp(a, min=1e-30)), min=floor_db)


def detrend(x: torch.Tensor, *, type: str = "linear") -> torch.Tensor:
    """Remove a constant or least-squares linear trend over the last axis
    (scipy.signal.detrend semantics), by the closed-form normal equations on
    centered time indices."""
    xf = x.to(torch.float32)
    mean = torch.mean(xf, dim=-1, keepdim=True)
    if type == "constant":
        return xf - mean
    if type != "linear":
        raise ValueError(f"type must be 'linear' or 'constant', got {type!r}")
    t = xf.shape[-1]
    n = torch.arange(t, dtype=torch.float32, device=xf.device) - (t - 1) / 2.0
    centered = np.arange(t) - (t - 1) / 2.0
    slope = torch.sum(xf * n, dim=-1, keepdim=True) / float(centered @ centered)
    return xf - mean - slope * n


__all__ = ["dc_block", "agc", "soft_clip", "db", "detrend"]
