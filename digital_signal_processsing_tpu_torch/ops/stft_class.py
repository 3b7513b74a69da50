"""ShortTimeFFT — scipy's canonical sliding-window STFT API, the port of
``digital_signal_processsing_tpu/ops/stft_class.py``.

The class form of the STFT surface (scipy.signal.ShortTimeFFT): explicit
window/hop/fs bookkeeping, signal-edge covering slices, exact inversion
through the canonical dual window, and the fft modes. The windows and their
duals are host float64 (copies of the reference's code); the framing is
``Tensor.unfold`` of the padded signal and the DFT ``torch.fft`` on the
signal's device, all slices in one call.

Conventions (scipy's, as the reference pins them): slice ``p`` windows
``x[p*hop - m_num_mid : ... + m_num]``; the default ``phase_shift=0``
multiplies bin ``q`` by ``exp(2j pi q (m_num_mid + phase_shift)/mfft)``
(``None`` = no factor); ``p_min = -((m_num - m_num_mid - 1) // hop)``;
``p_max(n) = (n - 1 + m_num_mid) // hop + 1``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.layout import overlapping_frames
from .fft import as_signal


def _calc_dual_canonical_window(win: np.ndarray, hop: int) -> np.ndarray:
    """Canonical dual window of the (painless-case) STFT frame."""
    w2 = win.real**2 + win.imag**2
    dd = w2.copy()
    for p_ in range(hop, len(win), hop):
        dd[p_:] += w2[:-p_]
        dd[:-p_] += w2[p_:]
    if not np.all(dd > 0):
        raise ValueError(
            "short-time Fourier transform not invertible: the windows do "
            "not cover every sample (zero in the frame diagonal)"
        )
    return win / dd


def closest_STFT_dual_window(
    win: np.ndarray, hop: int, desired_dual=None, *, scaled: bool = True
):
    """The dual window of ``(win, hop)`` closest to ``desired_dual``
    (scipy.signal.closest_STFT_dual_window): per-residue-class
    least-squares correction of the canonical dual; returns
    ``(dual, alpha)``."""
    win = np.asarray(win)
    if desired_dual is None:
        desired_dual = np.ones_like(win)
    desired_dual = np.asarray(desired_dual)
    if win.ndim != 1 or win.shape != desired_dual.shape:
        raise ValueError("win and desired_dual must be equal-length 1-D")
    if not (np.all(np.isfinite(win)) and np.all(np.isfinite(desired_dual))):
        raise ValueError("windows must have finite entries")
    if not (1 <= hop <= len(win)) or int(hop) != hop:
        raise ValueError(f"hop must be an integer in [1, {len(win)}]")
    w_d = _calc_dual_canonical_window(win, hop)
    wdd = np.conjugate(win) * desired_dual
    q_d = wdd.copy()
    for k_ in range(hop, len(win), hop):
        q_d[k_:] += wdd[:-k_]
        q_d[:-k_] += wdd[k_:]
    q_d = w_d * q_d
    if not scaled:
        return w_d + desired_dual - q_d, 1.0
    numerator = np.conjugate(q_d).T @ w_d
    denominator = q_d.T.real @ q_d.real + q_d.T.imag @ q_d.imag
    if not (abs(numerator) > 0 and denominator > np.finfo(float).resolution):
        raise ValueError(
            "scaling factor numerically unstable; use scaled=False"
        )
    alpha = numerator / denominator
    return w_d + alpha * (desired_dual - q_d), alpha


def _framed_fft(xp: torch.Tensor, win: torch.Tensor, hop: int, mfft: int, mode: str,
                n_slices: int) -> torch.Tensor:
    """(C, padded_n) -> (C, f_pts, n_slices) complex batched DFT."""
    m_num = win.shape[0]
    seg = overlapping_frames(xp, n_slices, hop, m_num) * win  # (C, P, m)
    if mode == "onesided":
        spec = torch.fft.rfft(seg, n=mfft, dim=-1)
    else:
        spec = torch.fft.fft(seg, n=mfft, dim=-1)
        if mode == "centered":
            spec = torch.fft.fftshift(spec, dim=-1)
    return spec.transpose(-1, -2)  # (C, f, P)


def _pad_index(n: int, left: int, right: int, mode: str, device) -> torch.Tensor:
    """Source index of each padded position, ``numpy.pad``'s ``edge`` or
    ``reflect`` at any pad width (reflection repeats past one length)."""
    i = torch.arange(-left, n + right, device=device)
    if mode == "edge" or n == 1:
        return i.clamp(0, n - 1)
    period = 2 * (n - 1)
    i = torch.remainder(i, period)
    return torch.where(i >= n, period - i, i)


def _pad(xb: torch.Tensor, left: int, right: int, padding: str) -> torch.Tensor:
    if padding == "zeros":
        return F.pad(xb, (left, right))
    n = xb.shape[-1]
    if padding == "edge":
        return xb[:, _pad_index(n, left, right, "edge", xb.device)]
    refl = xb[:, _pad_index(n, left, right, "reflect", xb.device)]
    if padding == "even":
        return refl
    # odd: 2*edge - reflect
    return 2.0 * xb[:, _pad_index(n, left, right, "edge", xb.device)] - refl


class ShortTimeFFT:
    """scipy.signal.ShortTimeFFT-compatible sliding-window STFT.

    Supports ``fft_mode`` 'onesided'/'twosided'/'centered',
    ``phase_shift`` int or None, ``scale_to`` 'magnitude'/'psd', and
    stft ``padding`` 'zeros'/'edge'/'even'/'odd'.
    """

    def __init__(
        self,
        win,
        hop: int,
        fs: float,
        *,
        fft_mode: str = "onesided",
        mfft: int | None = None,
        phase_shift: int | None = 0,
        scale_to: str | None = None,
    ):
        self.win = np.asarray(win, np.float64).copy()
        if self.win.ndim != 1 or self.win.size < 1:
            raise ValueError("win must be a non-empty 1-D array")
        if int(hop) != hop or hop < 1:
            raise ValueError(f"hop must be a positive integer, got {hop}")
        self.hop = int(hop)
        self.fs = float(fs)
        if fft_mode not in ("onesided", "twosided", "centered"):
            raise ValueError(f"unsupported fft_mode {fft_mode!r}")
        self.fft_mode = fft_mode
        self.mfft = int(mfft) if mfft is not None else self.win.size
        if self.mfft < self.win.size:
            raise ValueError("mfft must be >= len(win)")
        if phase_shift is not None and not (
            -self.mfft < phase_shift < self.mfft
        ):
            raise ValueError("phase_shift must be in (-mfft, mfft) or None")
        self.phase_shift = phase_shift
        self.scaling = None
        self._dual_win = None
        if scale_to is not None:
            self.scale_to(scale_to)

    @classmethod
    def from_window(
        cls, win_param, fs: float, nperseg: int, noverlap: int, **kwargs
    ):
        """Build from a window NAME + nperseg/noverlap (scipy's
        from_window): symmetric window, hop = nperseg - noverlap."""
        from .fft import get_window

        win = get_window(win_param, nperseg, fftbins=True)
        return cls(win, nperseg - noverlap, fs, **kwargs)

    # geometry ------------------------------------------------------------
    @property
    def m_num(self) -> int:
        return self.win.size

    @property
    def m_num_mid(self) -> int:
        return self.m_num // 2

    @property
    def f_pts(self) -> int:
        return self.mfft // 2 + 1 if self.fft_mode == "onesided" else self.mfft

    @property
    def f(self) -> np.ndarray:
        if self.fft_mode == "onesided":
            return np.fft.rfftfreq(self.mfft, 1.0 / self.fs)
        freqs = np.fft.fftfreq(self.mfft, 1.0 / self.fs)
        return np.fft.fftshift(freqs) if self.fft_mode == "centered" else freqs

    @property
    def T(self) -> float:
        return 1.0 / self.fs

    @property
    def delta_t(self) -> float:
        return self.hop / self.fs

    @property
    def delta_f(self) -> float:
        return self.fs / self.mfft

    @property
    def p_min(self) -> int:
        # first slice whose window still overlaps the signal start
        return -((self.m_num - self.m_num_mid - 1) // self.hop)

    @property
    def k_min(self) -> int:
        return self.p_min * self.hop - self.m_num_mid

    def p_max(self, n: int) -> int:
        return (n - 1 + self.m_num_mid) // self.hop + 1

    def k_max(self, n: int) -> int:
        return (self.p_max(n) - 1) * self.hop + self.m_num - self.m_num_mid

    def p_num(self, n: int) -> int:
        return self.p_max(n) - self.p_min

    def t(self, n: int, p0: int | None = None, p1: int | None = None):
        p0 = self.p_min if p0 is None else p0
        p1 = self.p_max(n) if p1 is None else p1
        return np.arange(p0, p1) * self.delta_t

    # duality -------------------------------------------------------------
    @property
    def dual_win(self) -> np.ndarray:
        if self._dual_win is None:
            self._dual_win = _calc_dual_canonical_window(self.win, self.hop)
        return self._dual_win

    @property
    def invertible(self) -> bool:
        try:
            _ = self.dual_win
            return True
        except ValueError:
            return False

    def scale_to(self, scaling: str):
        """Rescale the window pair for 'magnitude' or 'psd' readout
        (scipy semantics: the analysis window absorbs the factor, the
        dual the reciprocal)."""
        if scaling not in ("magnitude", "psd"):
            raise ValueError("scaling must be 'magnitude' or 'psd'")
        if self.scaling == scaling:
            return
        if self.scaling is not None:
            raise ValueError("window already scaled; build a new instance")
        if scaling == "magnitude":
            fac = 1.0 / abs(self.win.sum())
        else:
            fac = 1.0 / np.sqrt(self.fs * np.sum(self.win**2))
        dual = self.dual_win  # materialize before rescale
        self.win = self.win * fac
        self._dual_win = dual / fac
        self.scaling = scaling

    # transforms ----------------------------------------------------------
    def _phase_factor(self):
        if self.phase_shift is None:
            return None
        q = np.arange(self.f_pts)
        if self.fft_mode == "centered":
            q = q - self.mfft // 2
        shift = self.m_num_mid + self.phase_shift
        return np.exp(2j * np.pi * q * shift / self.mfft)

    def stft(self, x, p0=None, p1=None, *, padding: str = "zeros", axis=-1):
        """Complex STFT ``(..., f_pts, p1-p0)`` over slices
        ``[p0, p1)`` (defaults cover the whole signal, ``p_min`` to
        ``p_max``), complex64 on ``x``'s device."""
        xj = torch.movedim(as_signal(x).to(torch.float32), axis, -1)
        n = xj.shape[-1]
        if n < self.m_num - self.m_num_mid:
            raise ValueError(f"signal too short ({n} samples)")
        p0 = self.p_min if p0 is None else int(p0)
        p1 = self.p_max(n) if p1 is None else int(p1)
        if p1 <= p0:
            raise ValueError(f"need p0 < p1, got {p0}, {p1}")
        if padding not in ("zeros", "edge", "even", "odd"):
            raise ValueError(f"unknown padding {padding!r}")
        left = self.m_num_mid - p0 * self.hop
        right = max(
            0, (p1 - 1) * self.hop - self.m_num_mid + self.m_num - n
        ) + self.hop * 2
        batch = xj.shape[:-1]
        xp = _pad(xj.reshape((-1, n)), max(0, left), right, padding)
        if left < 0:  # slices that start inside the signal
            xp = xp[:, -left:]
        win = torch.from_numpy(self.win.astype(np.float32)).to(xp.device)
        spec = _framed_fft(xp, win, self.hop, self.mfft, self.fft_mode, p1 - p0)
        fac = self._phase_factor()
        if fac is not None:
            spec = spec * torch.from_numpy(fac.astype(np.complex64)).to(spec.device)[:, None]
        return spec.reshape(batch + spec.shape[-2:])

    def spectrogram(self, x, **kwargs):
        """|STFT|^2 (scipy's ShortTimeFFT.spectrogram)."""
        s = self.stft(x, **kwargs)
        return s.real**2 + s.imag**2

    def istft(self, S, k0: int = 0, k1: int | None = None):
        """Invert :meth:`stft` via the canonical dual window; returns
        samples ``[k0, k1)`` (defaults to the maximal exactly-covered
        range)."""
        S = as_signal(S)
        if S.dim() < 2:
            raise ValueError("S must have at least (f_pts, slices) axes")
        q_pts, n_slices = S.shape[-2], S.shape[-1]
        if q_pts != self.f_pts:
            raise ValueError(f"expected {self.f_pts} frequency rows")
        fac = self._phase_factor()
        if fac is not None:
            S = S * torch.from_numpy(np.conj(fac).astype(np.complex64)).to(S.device)[:, None]
        if self.fft_mode == "onesided":
            segs = torch.fft.irfft(S, n=self.mfft, dim=-2)
        else:
            if self.fft_mode == "centered":
                S = torch.fft.ifftshift(S, dim=-2)
            segs = torch.fft.ifft(S, dim=-2).real
        segs = segs.transpose(-2, -1)[..., : self.m_num]  # (..., P, m)
        segs = segs * torch.from_numpy(self.dual_win.astype(np.float32)).to(segs.device)
        # overlap-add on the hop grid: m_num <= r*hop parts, no scatter
        r = -(-self.m_num // self.hop)
        pad_m = r * self.hop - self.m_num
        if pad_m:
            segs = F.pad(segs, (0, pad_m))
        batch = segs.shape[:-2]
        sb = segs.reshape((-1, n_slices, r, self.hop))
        out = sb.new_zeros((sb.shape[0], n_slices + r - 1, self.hop))
        for i in range(r):
            out[:, i : i + n_slices, :] += sb[:, :, i, :]
        y = out.reshape(sb.shape[0], -1)
        # sample k of the signal sits at position k - (p_min*hop - mid)
        offset = -(self.p_min * self.hop - self.m_num_mid)
        if k1 is None:
            k1 = (n_slices - 1 + self.p_min) * self.hop - self.m_num_mid + self.m_num
            k1 = min(k1, y.shape[-1] - offset)
        y = y[:, offset + k0 : offset + k1]
        return y.reshape(batch + (y.shape[-1],))


__all__ = ["ShortTimeFFT", "closest_STFT_dual_window"]
