"""Demodulators: FM (quadrature discriminator), AM envelope, frequency translation.

Counterpart of ``digital_signal_processsing_tpu/ops/demod.py``, in plain
PyTorch ops: the reference has no Pallas kernel here (XLA fused them).
Complex baseband is planar ``(channels, time)`` complex64.

The reference's floor semantics are kept: ``jnp.mod`` and
``jnp.floor_divide`` floor, so this module uses ``torch.remainder`` and
``torch.div(..., rounding_mode="floor")`` (``torch.fmod`` and truncating
division differ for negative sample offsets, which ``chain_stream_chunk``
passes). ``torch.round`` rounds half to even, as ``jnp.round`` does.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.device import resolve_device


def _to_c64(x: torch.Tensor) -> torch.Tensor:
    if x.is_complex():
        return x.to(torch.complex64)
    xf = x.to(torch.float32)
    return torch.complex(xf, torch.zeros_like(xf))


def fm_demodulate(iq: torch.Tensor, gain: float = 1.0) -> torch.Tensor:
    """Quadrature discriminator: angle(z[n] * conj(z[n-1])) * gain.

    The first output sample is 0: the previous sample before the start is
    zero, and atan2(0, 0) = 0.
    """
    z = _to_c64(iq)
    prev = torch.nn.functional.pad(z[..., :-1], (1, 0))
    d = z * torch.conj(prev)
    return torch.atan2(d.imag, d.real).to(torch.float32) * gain


def am_demodulate(iq: torch.Tensor) -> torch.Tensor:
    """Envelope detector: |z| with the DC carrier removed per channel."""
    env = torch.abs(_to_c64(iq)).to(torch.float32)
    return env - torch.mean(env, dim=-1, keepdim=True)


def _frac_mul_int(f: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """frac(f * n) computed exactly in float32, for an integer tensor n.

    The reference's 12-bit limb split: every partial product fits 24 bits,
    so each is exact in float32; the integer-valued terms drop. Max error
    about 2^-23 cycles. Each operation is its own PyTorch op, in the
    reference's order.
    """
    two12, two24, two36 = 4096.0, 16777216.0, 68719476736.0
    f32 = f.to(torch.float32)
    k1 = torch.round(f32 * two12)
    r1 = f32 - k1 / two12
    k2 = torch.round(r1 * two24)
    r2 = r1 - k2 / two24
    k3 = torch.round(r2 * two36)
    k1 = torch.remainder(k1, two12)  # only frac survives: reduce before multiplying
    n0 = torch.remainder(n, 4096).to(torch.float32)
    n1 = torch.remainder(torch.div(n, 4096, rounding_mode="floor"), 4096).to(torch.float32)
    n2 = torch.remainder(torch.div(n, 4096 * 4096, rounding_mode="floor"), 4096).to(torch.float32)

    def fr(x):
        return x - torch.floor(x)

    s = (
        fr(k1 * n0 / two12)
        + fr(k2 * n1 / two12)
        + k2 * n0 / two24
        + fr(k3 * n2 / two12)
        + k3 * n1 / two24
        + k3 * n0 / two36
    )
    return fr(s)


def oscillator_bank(freqs, t: int, t0=0, *, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of -2*pi*f*(t0 + n) for a bank of LOs, (C, t) float32 each.

    The phase is exact at any offset (< 5e-6 rad, the reference's bound):
    frac(f*(t0+n)) = frac(frac(f*t0) + frac(f*n)), each by ``_frac_mul_int``.
    ``freqs`` on a device sets it; otherwise ``device`` does, the card by
    default. ``t0`` is an int or an integer tensor, and may be negative.
    """
    if isinstance(freqs, torch.Tensor):
        dev = freqs.device
        f = freqs.to(torch.float32)
    else:
        dev = resolve_device("cuda" if device is None else device)
        f = torch.from_numpy(np.asarray(freqs, np.float32)).to(dev)
    f = torch.atleast_1d(f)[:, None]
    if isinstance(t0, torch.Tensor):
        n_t0 = t0.to(device=dev, dtype=torch.int64)
    else:
        n_t0 = torch.full((), int(t0), dtype=torch.int64, device=dev)
    p0 = _frac_mul_int(f, n_t0)
    pn = _frac_mul_int(f, torch.arange(t, dtype=torch.int64, device=dev)[None, :])
    p = p0 + pn
    theta = -2.0 * math.pi * (p - torch.floor(p))
    return torch.cos(theta), torch.sin(theta)


def frequency_translate(x: torch.Tensor, freq_norm) -> torch.Tensor:
    """Mix a signal down/up by freq (cycles/sample): x * exp(-2*pi*i*f*n)."""
    t = x.shape[-1]
    if isinstance(freq_norm, torch.Tensor):
        fr = freq_norm.to(device=x.device, dtype=torch.float32).reshape(-1)
    else:
        fr = torch.from_numpy(np.asarray(freq_norm, np.float32).reshape(-1)).to(x.device)
    if x.dim() == 1 and fr.shape[0] != 1:
        raise ValueError(
            f"a 1-D signal takes one frequency, got {fr.shape[0]}; "
            "pass a (channels, time) signal for per-channel mixing"
        )
    c, s = oscillator_bank(fr, t)
    lo = torch.complex(c, s)
    lo = lo[0] if x.dim() == 1 else lo
    return _to_c64(x) * lo


def fm_modulate(msg: torch.Tensor, deviation: float = 0.5) -> torch.Tensor:
    """Inverse of fm_demodulate (for test loopback): z = exp(i*cumsum(msg*dev))."""
    phase = torch.cumsum(msg.to(torch.float32) * deviation, dim=-1)
    return torch.complex(torch.cos(phase), torch.sin(phase))


__all__ = [
    "fm_demodulate",
    "am_demodulate",
    "oscillator_bank",
    "frequency_translate",
    "fm_modulate",
]
