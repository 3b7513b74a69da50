"""The part of the FFT stage that LPC analysis and the tracking notch need.

Counterpart of three pieces of ``digital_signal_processsing_tpu/ops/fft.py``:

- :func:`rfft`, which the reference leaves to XLA, as ``torch.fft.rfft``;
- :func:`spectral_window` and :func:`get_window` with the window helpers
  they reach (``_chebwin``, ``_taylor``, ``_kbd``, :func:`dpss_windows`),
  NumPy-only copies of the reference's (float64 on the host, as there).

The rest of the reference's ``fft.py`` (stft, welch, hilbert, czt, the
multitaper PSD) is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch


def rfft(a: torch.Tensor, n: int | None = None, axis: int = -1) -> torch.Tensor:
    """One-sided FFT of a real tensor (``numpy.fft.rfft`` semantics)."""
    return torch.fft.rfft(a, n=n, dim=axis)


def spectral_window(window: str | tuple, nfft: int) -> np.ndarray:
    """PERIODIC analysis window (the scipy.signal spectral convention —
    np.hanning's symmetric form biases every PSD bin ~0.3%).

    The classic four ("hann"/"sqrt_hann"/"hamming"/"rect") are computed
    directly; any other name or ``(name, param)`` spec goes through
    :func:`get_window`'s full family (fftbins form), so the spectral ops
    accept every scipy window spec.
    """
    k = np.arange(nfft)
    if window == "hann":
        return (0.5 - 0.5 * np.cos(2 * np.pi * k / nfft)).astype(np.float32)
    if window == "sqrt_hann":
        # analysis*synthesis = hann, which overlap-adds to a constant at
        # hop = nfft/2: the WOLA perfect-reconstruction pair
        return np.sqrt(0.5 - 0.5 * np.cos(2 * np.pi * k / nfft)).astype(
            np.float32
        )
    if window == "hamming":
        return (0.54 - 0.46 * np.cos(2 * np.pi * k / nfft)).astype(np.float32)
    if window == "rect":
        return np.ones(nfft, np.float32)
    return get_window(window, nfft, fftbins=True).astype(np.float32)


def get_window(window, Nx: int, fftbins: bool = True) -> np.ndarray:
    """Window factory (scipy.signal.get_window): string name or
    ``(name, param)``; ``fftbins=True`` gives the PERIODIC form used for
    spectral analysis, ``False`` the symmetric filter-design form."""
    if isinstance(window, (tuple, list)):
        name, *params = window
    else:
        name, params = window, []
    if Nx < 1:
        raise ValueError(f"Nx must be >= 1, got {Nx}")
    m = Nx + 1 if fftbins else Nx
    n = np.arange(m, dtype=np.float64)
    if m > 1:
        t = 2.0 * np.pi * n / (m - 1)
    else:
        t = np.zeros(1)

    def cos_sum(coefs):
        w = np.zeros(m)
        for k, c in enumerate(coefs):
            w += c * np.cos(k * t) * (-1.0) ** k
        return w

    name = {"hanning": "hann", "rect": "boxcar", "rectangular": "boxcar"}.get(
        name, name
    )
    if name == "boxcar":
        w = np.ones(m)
    elif name in ("triang",):
        # scipy triang is NOT bartlett: no zero endpoints
        k = np.arange(1, (m + 1) // 2 + 1)
        if m % 2 == 0:
            half = (2 * k - 1) / m
            w = np.concatenate([half, half[::-1]])
        else:
            half = 2 * k / (m + 1)
            w = np.concatenate([half, half[-2::-1]])
    elif name == "bartlett":
        w = 1.0 - np.abs(2.0 * n / (m - 1) - 1.0) if m > 1 else np.ones(1)
    elif name == "hann":
        w = cos_sum([0.5, 0.5])
    elif name == "hamming":
        w = cos_sum([0.54, 0.46])
    elif name == "blackman":
        w = cos_sum([0.42, 0.5, 0.08])
    elif name == "blackmanharris":
        w = cos_sum([0.35875, 0.48829, 0.14128, 0.01168])
    elif name == "nuttall":
        w = cos_sum([0.3635819, 0.4891775, 0.1365995, 0.0106411])
    elif name == "flattop":
        w = cos_sum(
            [0.21557895, 0.41663158, 0.277263158, 0.083578947, 0.006947368]
        )
    elif name == "barthann":
        frac = np.abs(n / (m - 1) - 0.5) if m > 1 else np.zeros(1)
        w = 0.62 - 0.48 * frac + 0.38 * np.cos(2 * np.pi * frac)
    elif name == "bohman":
        frac = np.abs(2.0 * n / (m - 1) - 1.0) if m > 1 else np.zeros(1)
        w = (1 - frac) * np.cos(np.pi * frac) + np.sin(np.pi * frac) / np.pi
        w[0] = w[-1] = 0.0
    elif name == "parzen":
        # scipy's parzen scales by m/2 (not m-1) with the split at (m-1)/4
        nn = np.arange(-(m - 1) / 2.0, (m - 1) / 2.0 + 0.5, 1.0)
        an = np.abs(nn) / (m / 2.0)
        w = np.where(
            np.abs(nn) <= (m - 1) / 4.0,
            1.0 - 6.0 * an**2 + 6.0 * an**3,
            2.0 * (1.0 - an) ** 3,
        )
    elif name == "cosine":
        w = np.sin(np.pi * (n + 0.5) / m)
    elif name == "lanczos":
        w = np.sinc(2.0 * n / (m - 1) - 1.0) if m > 1 else np.ones(1)
    elif name == "kaiser":
        if not params:
            raise ValueError("kaiser window needs a beta parameter")
        w = np.kaiser(m, params[0])
    elif name == "gaussian":
        if not params:
            raise ValueError("gaussian window needs a std parameter")
        w = np.exp(-0.5 * ((n - (m - 1) / 2.0) / params[0]) ** 2)
    elif name == "exponential":
        # scipy's parameter order is (center, tau) — the single-param
        # spelling sets the CENTER; pass (None, tau) for a decay scale
        center = params[0] if len(params) >= 1 else None
        tau = params[1] if len(params) >= 2 else 1.0
        if not fftbins and center is not None:
            raise ValueError("symmetric exponential requires center=None")
        if center is None:
            center = (m - 1) / 2.0
        w = np.exp(-np.abs(n - center) / tau)
    elif name == "tukey":
        alpha = params[0] if params else 0.5
        if alpha <= 0:
            w = np.ones(m)
        elif alpha >= 1:
            w = cos_sum([0.5, 0.5])
        else:
            w = np.ones(m)
            width = int(np.floor(alpha * (m - 1) / 2.0))
            idx = np.arange(width + 1)
            edge = 0.5 * (
                1 + np.cos(np.pi * (2.0 * idx / (alpha * (m - 1)) - 1.0))
            )
            w[: width + 1] = edge
            w[m - width - 1 :] = edge[::-1]
    elif name == "general_cosine":
        if not params:
            raise ValueError("general_cosine needs a coefficient sequence")
        w = cos_sum(np.asarray(params[0], np.float64))
    elif name == "general_hamming":
        if not params:
            raise ValueError("general_hamming needs alpha")
        alpha = float(params[0])
        w = cos_sum([alpha, 1.0 - alpha])
    elif name == "general_gaussian":
        if len(params) < 2:
            raise ValueError("general_gaussian needs (p, sigma)")
        pw, sig = float(params[0]), float(params[1])
        w = np.exp(-0.5 * np.abs((n - (m - 1) / 2.0) / sig) ** (2 * pw))
    elif name == "chebwin":
        if not params:
            raise ValueError("chebwin needs an attenuation in dB")
        w = _chebwin(m, float(params[0]))
    elif name == "taylor":
        nbar = int(params[0]) if len(params) >= 1 else 4
        sll = float(params[1]) if len(params) >= 2 else 30.0
        norm = bool(params[2]) if len(params) >= 3 else True
        w = _taylor(m, nbar, sll, norm)
    elif name == "dpss":
        if not params:
            raise ValueError("dpss needs a half-bandwidth parameter NW")
        nw_ = float(params[0])
        w = dpss_windows(m, nw_, 1)[0][0]
        # scipy's 'approximate' norm: max-normalize, with an even-length
        # half-sample correction M^2/(M^2 + NW)
        w = w / np.max(np.abs(w))
        if m % 2 == 0:
            w = w * (m * m / (m * m + nw_))
    elif name == "kaiser_bessel_derived":
        if not params:
            raise ValueError("kaiser_bessel_derived needs beta")
        if fftbins:
            raise ValueError(
                "Kaiser-Bessel Derived windows are only defined for "
                "symmetric shapes"
            )
        w = _kbd(m, float(params[0]))
    else:
        raise ValueError(f"unknown window {name!r}")
    if fftbins:
        w = w[:-1]
    return w.astype(np.float64)


def _chebwin(m: int, at: float) -> np.ndarray:
    """Dolph-Chebyshev window (scipy.signal.windows.chebwin): inverse DFT
    of the equiripple Chebyshev spectrum."""
    if m == 1:
        return np.ones(1)
    order = m - 1.0
    beta = np.cosh(1.0 / order * np.arccosh(10 ** (abs(at) / 20.0)))
    k = np.arange(m)
    x = beta * np.cos(np.pi * k / m)
    # Chebyshev polynomial T_order evaluated off [-1, 1] without overflow;
    # T_n(-x) = (-1)^n T_n(x) supplies the sign for x < -1
    p = np.zeros(m)
    big = np.abs(x) > 1
    p[big] = np.cosh(order * np.arccosh(np.abs(x[big])))
    p[big & (x < 0)] *= (-1.0) ** (int(order) % 2)
    p[~big] = np.cos(order * np.arccos(x[~big]))
    if m % 2:
        wr = np.real(np.fft.fft(p))
        half = (m + 1) // 2
        wr = wr[:half]
        w = np.concatenate([wr[:0:-1], wr])
    else:
        p_ = p * np.exp(1j * np.pi / m * np.arange(m))
        wr = np.real(np.fft.fft(p_))
        half = m // 2 + 1
        wr = wr[1:half]
        w = np.concatenate([wr[::-1], wr])
    return w / np.max(w)


def _taylor(
    m: int, nbar: int, sll: float, norm: bool
) -> np.ndarray:
    """Taylor window (scipy.signal.windows.taylor semantics)."""
    if m == 1:
        return np.ones(1)
    b = 10.0 ** (sll / 20.0)
    a = np.arccosh(b) / np.pi
    s2 = nbar**2 / (a**2 + (nbar - 0.5) ** 2)
    ma = np.arange(1, nbar)
    fm = np.empty(nbar - 1)
    signs = np.empty_like(ma, float)
    signs[::2] = 1.0
    signs[1::2] = -1.0
    m2 = ma**2
    for mi, _ in enumerate(ma):
        numer = signs[mi] * np.prod(
            1 - m2[mi] / s2 / (a**2 + (ma - 0.5) ** 2)
        )
        denom = 2 * np.prod(1 - m2[mi] / m2[:mi]) * np.prod(
            1 - m2[mi] / m2[mi + 1 :]
        )
        fm[mi] = numer / denom

    def get(n_):
        return 1 + 2 * np.dot(
            fm, np.cos(2 * np.pi * ma[:, None] * (n_ - m / 2.0 + 0.5) / m)
        )
    w = get(np.arange(m))
    if norm:
        w = w / get((m - 1) / 2.0)
    return w


def _kbd(m: int, beta: float) -> np.ndarray:
    """Kaiser-Bessel derived window (symmetric only)."""
    if m % 2:
        raise ValueError("kaiser_bessel_derived requires an even length")
    kw = np.kaiser(m // 2 + 1, beta)
    csum = np.cumsum(kw)
    half = np.sqrt(csum[:-1] / csum[-1])
    return np.concatenate([half, half[::-1]])


def dpss_windows(
    m: int, nw: float, k_max: int, *, return_ratios: bool = False
):
    """Discrete prolate spheroidal (Slepian) sequences — the first
    ``k_max`` maximally band-concentrated windows (scipy.signal.windows.dpss
    semantics: tridiagonal eigenvector formulation, even windows
    positive-mean, odd windows positive-initial-slope).

    Returns ``(windows, ratios)`` with ``windows`` of shape
    ``(k_max, m)``; ``ratios`` are the in-band energy concentrations
    (computed only when ``return_ratios``).
    """
    import scipy.linalg as sla

    if not 0 < nw < m / 2:
        raise ValueError(f"need 0 < NW < M/2, got NW={nw}, M={m}")
    w_bin = nw / m
    n = np.arange(m)
    diag = ((m - 1 - 2 * n) / 2.0) ** 2 * np.cos(2 * np.pi * w_bin)
    off = n[1:] * (m - n[1:]) / 2.0
    vals, vecs = sla.eigh_tridiagonal(
        diag, off, select="i", select_range=(m - k_max, m - 1)
    )
    windows = vecs.T[::-1]
    # sign conventions (scipy): even orders sum positive, odd orders start
    # with a positive slope
    fix_even = windows[::2].sum(axis=1) < 0
    for i, f in enumerate(fix_even):
        if f:
            windows[2 * i] *= -1
    thresh = max(1e-7, 1.0 / m)
    for i, wlp in enumerate(windows[1::2]):
        if wlp[wlp * wlp > thresh][0] < 0:
            windows[2 * i + 1] *= -1
    if not return_ratios:
        return windows, None
    # concentration via the sinc kernel quadratic form
    dn = n[:, None] - n[None, :]
    with np.errstate(invalid="ignore", divide="ignore"):
        kern = np.sin(2 * np.pi * w_bin * dn) / (np.pi * dn)
    kern[np.arange(m), np.arange(m)] = 2 * w_bin
    ratios = np.einsum("km,mn,kn->k", windows, kern, windows)
    return windows, ratios


__all__ = ["rfft", "spectral_window", "get_window", "dpss_windows"]
