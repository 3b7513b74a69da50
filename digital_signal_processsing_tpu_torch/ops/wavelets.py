"""Continuous wavelet transform and unevenly sampled spectra.

``cwt`` (scipy.signal.cwt semantics, removed from scipy in 1.15; the oracle is
the reference package's ``ops/wavelets.py``) is a centered "same" correlation
of the stream with each width's conjugate wavelet. Here it is an FFT bank:
one ``rfft`` of the padded stream, the W kernel spectra, and one batched
``irfft``. The reference's lane-blocked MXU convolution (``_bank_conv_blocked``)
is a TPU spelling of the same sums and is not ported. ``lombscargle`` is dense
trig products over (frequencies, samples) in IEEE float32. The wavelet
generators are host-side NumPy design functions.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import as_tensor
from .fir import ieee_fp32_matmul

__all__ = ["ricker", "morlet2", "cwt", "lombscargle"]


def ricker(points: int, a: float) -> np.ndarray:
    """Ricker (mexican-hat) wavelet (scipy.signal.ricker), float64."""
    A = 2.0 / (np.sqrt(3.0 * a) * np.pi**0.25)
    vec = np.arange(points) - (points - 1.0) / 2.0
    xsq = vec**2
    mod = 1.0 - xsq / a**2
    return (A * mod * np.exp(-xsq / (2.0 * a**2))).astype(np.float64)


def morlet2(points: int, s: float, w: float = 5.0) -> np.ndarray:
    """Complex Morlet wavelet normalised for :func:`cwt` (scipy.signal.morlet2)."""
    x = (np.arange(points) - (points - 1.0) / 2.0) / s
    return (np.exp(1j * w * x) * np.exp(-0.5 * x**2) * np.pi**-0.25 * s**-0.5).astype(np.complex128)


def _correlate_same_bank(xb: torch.Tensor, kernels: list) -> torch.Tensor:
    """Centered 'same' correlation of (C, n) float32 with each real kernel: (C, W, n).

    Each kernel of length L sits in a row of the longest length at offset
    ``lmax // 2 - L // 2``, which keeps every kernel's own centering (the
    extra sample of an even kernel before); the stream is padded by
    ``lmax // 2`` before and ``(lmax - 1) // 2`` after, and output t is
    sum_j row[j] ext[t + j]: the circular correlation of the spectra, whose
    length leaves no sum wrapping. The kernels' spectra are taken in float64
    on the stream's device.
    """
    c, n = xb.shape
    lmax = max(k.size for k in kernels)
    bank = np.zeros((len(kernels), lmax), np.float64)
    for i, k in enumerate(kernels):
        off = lmax // 2 - k.size // 2
        bank[i, off : off + k.size] = k
    ext = torch.nn.functional.pad(xb, (lmax // 2, (lmax - 1) // 2))
    nfft = 1 << max(0, (ext.shape[-1] - 1).bit_length())
    spec_x = torch.fft.rfft(ext, nfft)
    spec_k = torch.fft.rfft(torch.from_numpy(bank).to(xb.device), nfft).to(torch.complex64)
    y = torch.fft.irfft(spec_x[:, None, :] * torch.conj(spec_k)[None], nfft)
    return y[..., :n]


def cwt(data, wavelet, widths, *, dtype=None, w: float | None = None, device="cuda") -> torch.Tensor:
    """Continuous wavelet transform (scipy.signal.cwt semantics): ``(..., W, n)``.

    ``wavelet(length, width)`` is called on the host for each width with
    ``length = min(10 * width, n)`` (``w`` passed on as a third argument where
    given, morlet2's centre frequency); the stream is correlated with the
    conjugate wavelet. A complex wavelet gives complex64 output (its real and
    imaginary kernels through the same bank).
    """
    xf = as_tensor(data, device).to(torch.float32)
    n = xf.shape[-1]
    batch = tuple(xf.shape[:-1])
    xb = xf.reshape(-1, n)
    kernels = []
    for width in np.atleast_1d(widths):
        length = int(min(10 * float(width), n))
        wv = wavelet(length, float(width)) if w is None else wavelet(length, float(width), w)
        kernels.append(np.conj(np.asarray(wv)))
    out = _correlate_same_bank(xb, [np.real(k).astype(np.float64) for k in kernels])
    if any(np.iscomplexobj(k) for k in kernels):
        out = torch.complex(out, _correlate_same_bank(
            xb, [np.imag(k).astype(np.float64) for k in kernels]))
    if dtype is not None:
        if not isinstance(dtype, torch.dtype):
            dtype = torch.from_numpy(np.zeros(0, dtype)).dtype
        out = out.to(dtype)
    return out.reshape(batch + tuple(out.shape[-2:]))


def lombscargle(x, y, freqs, *, precenter: bool = False, normalize: bool = False,
                device="cuda") -> torch.Tensor:
    """Lomb-Scargle periodogram of unevenly sampled data (scipy.signal.lombscargle,
    the tau-shifted form). ``x``: sample times (n,); ``y``: values (n,);
    ``freqs``: angular frequencies (f,). Dense (f, n) trig products, float32."""
    x = as_tensor(x, device).to(torch.float32)
    y = as_tensor(y, x.device).to(x.device, torch.float32)
    freqs = as_tensor(freqs, x.device).to(x.device, torch.float32)
    if precenter:
        y = y - torch.mean(y)
    arg = freqs[:, None] * x[None, :]  # (f, n)
    s2 = torch.sum(torch.sin(2.0 * arg), -1)
    c2 = torch.sum(torch.cos(2.0 * arg), -1)
    tau_arg = 0.5 * torch.atan2(s2, c2)  # omega * tau
    carg = torch.cos(arg - tau_arg[:, None])
    sarg = torch.sin(arg - tau_arg[:, None])
    with ieee_fp32_matmul():
        cy = carg @ y
        sy = sarg @ y
    cc = torch.sum(carg * carg, -1)
    ss = torch.sum(sarg * sarg, -1)
    pgram = 0.5 * (cy * cy / cc + sy * sy / ss)
    if normalize:
        pgram = pgram * (2.0 / torch.sum(y * y))
    return pgram
