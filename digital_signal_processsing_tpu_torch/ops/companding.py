"""G.711 companding codecs (mu-law, A-law) and continuous mu compression.

The telephony byte codecs: 8-bit G.711 streams in, int16 PCM through the
framework, G.711 back out. Exact ITU G.711 integer semantics (the Sun
Microsystems g711.c algorithm), written as int32 tensor arithmetic: the
branch ladders of g711.c become sums of comparisons and masked selects, so a
call is a few elementwise passes on whatever device the tensor is on, and the
bits are the reference package's (``digital_signal_processsing_tpu/ops/
companding.py``). ``mu_compress``/``mu_expand`` are the float pair ML
pipelines use for 8-bit targets.

Input that is not a tensor goes to ``device`` (the card by default).
"""

from __future__ import annotations

import math

import torch

from ..utils.device import as_tensor

__all__ = [
    "mulaw_encode",
    "mulaw_decode",
    "alaw_encode",
    "alaw_decode",
    "mu_compress",
    "mu_expand",
]

_BIAS = 0x84  # 132, the mu-law bias
_CLIP = 32635
_ALAW_SEG_END = (0x1F, 0x3F, 0x7F, 0xFF, 0x1FF, 0x3FF, 0x7FF, 0xFFF)


def _int32(x, device) -> torch.Tensor:
    return as_tensor(x, device).to(torch.int32)


def mulaw_encode(x, *, device="cuda") -> torch.Tensor:
    """int16 linear PCM -> uint8 mu-law (ITU G.711, g711.c semantics)."""
    v = _int32(x, device)
    sign = v < 0
    mag = torch.clamp(torch.where(sign, -v, v), max=_CLIP) + _BIAS
    # exponent = bit position of mag's MSB above bit 7, in 0..7
    exp = torch.zeros_like(mag)
    for k in range(1, 8):
        exp = exp + (mag >= (1 << (7 + k))).to(torch.int32)
    mant = (mag >> (exp + 3)) & 0xF
    byte = ~((sign.to(torch.int32) << 7) | (exp << 4) | mant) & 0xFF
    return byte.to(torch.uint8)


def mulaw_decode(c, *, device="cuda") -> torch.Tensor:
    """uint8 mu-law -> int16 linear PCM (exact g711.c ulaw2linear)."""
    u = (~_int32(c, device)) & 0xFF
    t = (((u & 0xF) << 3) + _BIAS) << ((u >> 4) & 0x7)
    out = torch.where((u & 0x80) != 0, _BIAS - t, t - _BIAS)
    return out.to(torch.int16)


def alaw_encode(x, *, device="cuda") -> torch.Tensor:
    """int16 linear PCM -> uint8 A-law (ITU G.711, g711.c semantics).

    The 16-bit input is arithmetic-shifted to the spec's 13-bit domain; the
    even-bit inversion (XOR 0x55) is folded into the mask.
    """
    v = _int32(x, device) >> 3
    neg = v < 0
    mask = torch.where(neg, 0x55, 0xD5)
    pcm = torch.where(neg, -v - 1, v)
    seg = torch.zeros_like(pcm)
    for end in _ALAW_SEG_END:
        seg = seg + (pcm > end).to(torch.int32)
    shift = torch.where(seg < 2, torch.ones_like(seg), seg)
    aval = (torch.clamp(seg, max=7) << 4) | ((pcm >> shift) & 0xF)
    byte = torch.where(seg >= 8, torch.full_like(aval, 0x7F), aval) ^ mask
    return byte.to(torch.uint8)


def alaw_decode(c, *, device="cuda") -> torch.Tensor:
    """uint8 A-law -> int16 linear PCM (exact g711.c alaw2linear)."""
    a = _int32(c, device) ^ 0x55
    t = (a & 0xF) << 4
    seg = (a & 0x70) >> 4
    t = torch.where(seg == 0, t + 8, (t + 0x108) << torch.clamp(seg - 1, min=0))
    out = torch.where((a & 0x80) != 0, t, -t)
    return out.to(torch.int16)


def mu_compress(x, *, mu: float = 255.0, device="cuda") -> torch.Tensor:
    """Continuous mu-law compression of float in [-1, 1]:
    sign(x) * log1p(mu |x|) / log1p(mu), float32."""
    if mu <= 0:
        raise ValueError(f"mu must be > 0, got {mu}")
    xf = as_tensor(x, device).to(torch.float32)
    return torch.sign(xf) * torch.log1p(mu * torch.abs(xf)) / math.log1p(mu)


def mu_expand(y, *, mu: float = 255.0, device="cuda") -> torch.Tensor:
    """Inverse of :func:`mu_compress`."""
    if mu <= 0:
        raise ValueError(f"mu must be > 0, got {mu}")
    yf = as_tensor(y, device).to(torch.float32)
    return torch.sign(yf) * torch.expm1(torch.abs(yf) * math.log1p(mu)) / mu
