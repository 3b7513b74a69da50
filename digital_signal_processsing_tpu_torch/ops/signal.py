"""Signal generators: tones, chirps, noise, square and sawtooth waves, pulses.

Each periodic generator takes its phase from the exact fractional multiply of
``ops/demod.py`` (``_frac_mul_int``), so the phase stays accurate at any
stream offset, as in the reference package (``digital_signal_processsing_tpu/
ops/signal.py``). Generators of a length make their tensors on ``device``
(the card by default); generators of a time tensor keep its device.
``max_len_seq`` is a host-side bit-serial recurrence, as in the reference.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.device import as_tensor, resolve_device
from .demod import _frac_mul_int

__all__ = [
    "tone",
    "chirp",
    "white_noise",
    "square",
    "sawtooth",
    "gausspulse",
    "sweep_poly",
    "unit_impulse",
    "max_len_seq",
]


def _cycles(freq, t: int, t0, dev: torch.device) -> torch.Tensor:
    """frac(f * (t0 + n)) as the reference forms it: (1, t) float32 (not reduced)."""
    f = torch.as_tensor(freq, dtype=torch.float32, device=dev).reshape(1, 1)
    p0 = _frac_mul_int(f, torch.as_tensor(t0, dtype=torch.int32, device=dev))
    pn = _frac_mul_int(f, torch.arange(t, dtype=torch.int32, device=dev)[None, :])
    return p0 + pn


def tone(freq, t: int, *, amplitude: float = 1.0, phase: float = 0.0, t0=0,
         device="cuda") -> torch.Tensor:
    """amplitude * sin(2 pi f (t0 + n) + phase), float32 (t,).

    The phase comes from the exact fractional multiply: accurate for any
    offset that fits int32.
    """
    dev = resolve_device(device)
    theta = 2.0 * math.pi * _cycles(freq, t, t0, dev) + phase
    return (amplitude * torch.sin(theta))[0]


def chirp(f0: float, f1: float, t: int, *, amplitude: float = 1.0, device="cuda") -> torch.Tensor:
    """Linear chirp sweeping f0 -> f1 cycles/sample over t samples.

    Instantaneous frequency f(n) = f0 + (f1 - f0) n / t; the phase is its
    integral 2 pi (f0 n + (f1 - f0) n^2 / (2t)). The linear term uses the exact
    fractional multiply; the quadratic term is float32 (phase error about
    |f1 - f0| t 2^-25 cycles). ``t <= 0`` gives an empty tensor, as the
    reference's does.
    """
    dev = resolve_device(device)
    if t <= 0:
        return torch.zeros(0, dtype=torch.float32, device=dev)
    n = torch.arange(t, dtype=torch.float32, device=dev)
    a = torch.as_tensor(f0, dtype=torch.float32, device=dev).reshape(1, 1)
    p_lin = _frac_mul_int(a, torch.arange(t, dtype=torch.int32, device=dev)[None, :])[0]
    k = (f1 - f0) / (2.0 * t)
    p_quad = k * (n * n)
    p_quad = p_quad - torch.floor(p_quad)
    ph = p_lin + p_quad
    return amplitude * torch.sin(2.0 * math.pi * (ph - torch.floor(ph)))


def white_noise(t: int, *, amplitude: float = 1.0, seed: int = 0, device="cuda") -> torch.Tensor:
    """Gaussian white noise, float32 (t,), from a ``torch.Generator`` seeded by
    ``seed`` on ``device``. The reference draws from ``jax.random``: the same
    seed gives other numbers of the same distribution."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    return amplitude * torch.randn(t, generator=gen, dtype=torch.float32, device=dev)


def square(freq, t: int, *, duty: float = 0.5, t0=0, device="cuda") -> torch.Tensor:
    """Square wave: +1 for the first ``duty`` of each cycle, -1 after
    (scipy.signal.square on the phase 2 pi freq n), exact fractional phase."""
    dev = resolve_device(device)
    frac = _cycles(freq, t, t0, dev)[0]
    frac = frac - torch.floor(frac)
    return torch.where(frac < duty, 1.0, -1.0).to(torch.float32)


def sawtooth(freq, t: int, *, width: float = 1.0, t0=0, device="cuda") -> torch.Tensor:
    """Sawtooth/triangle wave (scipy.signal.sawtooth): rises -1 -> 1 over the
    first ``width`` of each cycle and falls back over the rest."""
    if not 0.0 <= width <= 1.0:
        raise ValueError(f"width must be in [0, 1], got {width}")
    dev = resolve_device(device)
    frac = _cycles(freq, t, t0, dev)[0]
    frac = frac - torch.floor(frac)
    rise = -1.0 + 2.0 * frac / max(width, 1e-30)
    fall = 1.0 - 2.0 * (frac - width) / max(1.0 - width, 1e-30)
    return torch.where(frac < width, rise, fall).to(torch.float32)


def gausspulse(t, *, fc: float = 1000.0, bw: float = 0.5, bwr: float = -6.0,
               device="cuda") -> torch.Tensor:
    """Gaussian-modulated sinusoid (scipy.signal.gausspulse): a cosine at ``fc``
    Hz under a Gaussian envelope whose fractional bandwidth ``bw`` is measured
    at ``bwr`` dB. ``t`` in seconds, any shape."""
    if fc < 0 or bw <= 0 or bwr >= 0:
        raise ValueError(f"need fc >= 0, bw > 0, bwr < 0; got {fc}, {bw}, {bwr}")
    ref = float(np.power(10.0, bwr / 20.0))
    a = -((np.pi * fc * bw) ** 2) / (4.0 * np.log(ref))
    tf = as_tensor(t, device).to(torch.float32)
    return torch.exp(-float(a) * tf * tf) * torch.cos(2.0 * math.pi * fc * tf)


def sweep_poly(t, poly, phi: float = 0.0, *, device="cuda") -> torch.Tensor:
    """Frequency sweep following a polynomial f(t) (scipy.signal.sweep_poly):
    the phase is the exact antiderivative, evaluated by Horner's rule in float32."""
    c = np.atleast_1d(np.asarray(poly, np.float64))
    integ = np.concatenate([c / np.arange(c.size, 0, -1), [0.0]]).astype(np.float32)
    tf = as_tensor(t, device).to(torch.float32)
    phase = torch.zeros_like(tf)
    for coef in integ:  # jnp.polyval's order: y = y * t + c
        phase = phase * tf + float(coef)
    return torch.cos(2.0 * math.pi * phase + float(np.float32(np.pi * phi / 180.0)))


def unit_impulse(shape, idx=None, dtype=torch.float32, *, device="cuda") -> torch.Tensor:
    """Unit impulse (scipy.signal.unit_impulse): 1 at ``idx`` (default 0;
    ``"mid"`` the centre), 0 elsewhere."""
    shape = (shape,) if np.ndim(shape) == 0 else tuple(shape)
    if idx is None:
        idx = (0,) * len(shape)
    elif isinstance(idx, str) and idx == "mid":
        idx = tuple(s // 2 for s in shape)
    elif np.ndim(idx) == 0:
        idx = (idx,) * len(shape)
    if not isinstance(dtype, torch.dtype):  # a NumPy or Python type; float64 is the
        dtype = torch.from_numpy(np.zeros(0, dtype)).dtype  # reference's float32
        dtype = torch.float32 if dtype == torch.float64 else dtype
    out = torch.zeros(shape, dtype=dtype, device=resolve_device(device))
    out[tuple(idx)] = 1
    return out


_DEFAULT_TAPS = {
    2: [1], 3: [2], 4: [3], 5: [3], 6: [5], 7: [6], 8: [7, 6, 1],
    9: [5], 10: [7], 11: [9], 12: [11, 10, 4], 13: [12, 11, 8],
    14: [13, 12, 2], 15: [14], 16: [15, 13, 4], 17: [14], 18: [11],
    19: [18, 17, 14], 20: [17], 21: [19], 22: [21], 23: [18],
    24: [23, 22, 17], 25: [22], 26: [25, 24, 20], 27: [26, 25, 22],
    28: [25], 29: [27], 30: [29, 28, 7], 31: [28], 32: [31, 30, 10],
}


def max_len_seq(nbits: int, state=None, length: int | None = None, taps=None):
    """Maximum-length pseudorandom sequence by an LFSR (scipy.signal.max_len_seq):
    ``(seq, final_state)``, NumPy int8 0/1. Host-side: a bit-serial recurrence,
    a design-time artifact like filter taps."""
    if taps is None:
        if nbits not in _DEFAULT_TAPS:
            raise ValueError(f"nbits must be in 2..32 without taps, got {nbits}")
        taps = _DEFAULT_TAPS[nbits]
    taps = np.unique(np.asarray(taps, int))[::-1]
    if np.any(taps < 0) or np.any(taps > nbits - 1):
        raise ValueError("taps must be in [0, nbits)")
    n_out = (1 << nbits) - 1 if length is None else int(length)
    if state is None:
        st = np.ones(nbits, np.int8)
    else:
        st = np.asarray(state, np.int8).copy()
        if st.size != nbits or not np.any(st):
            raise ValueError("state must be nbits long and not all zero")
    # scipy's register convention: emit state[0], feedback = state[0] xor the
    # tap states, shift left, feedback enters at the top
    seq = np.empty(n_out, np.int8)
    for i in range(n_out):
        fb = st[0]
        seq[i] = fb
        for tp in taps:
            fb ^= st[tp]
        st[:-1] = st[1:]
        st[-1] = fb
    return seq, st
