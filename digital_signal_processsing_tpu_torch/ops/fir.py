"""General FIR filtering: the direct (conv1d) and overlap-save (FFT) routes.

Counterpart of ``digital_signal_processsing_tpu/ops/fir.py`` for the parts
the receiver chain uses. Layout as in the reference: planar ``(channels,
time)`` float32 (or a 1-D ``(time,)`` signal), causal,
``y[t] = sum_j h[j] * x[t - j]`` with zeros before t=0.

- ``fir_direct``: one ``conv1d`` with the taps flipped and k-1 zeros on the
  left, in IEEE float32 (never TF32). The reference leaves this convolution
  to XLA, outside any Pallas kernel; its lane blocking and row fold only
  served XLA's TPU compiler and are not carried over.
- ``fir_overlap_save``: block FFT convolution with ``torch.fft``.
- ``fir_filter``: the ``auto`` crossover between them and the fused
  overlap-save kernels B8 and B9 (``ops/fft_mxu.py``), with the reference's
  method names and ``record_choice`` names.

The NumPy tap designers (windowed sinc, root-raised cosine, least squares,
Parks-McClellan, frequency sampling, Savitzky-Golay, Kaiser's estimates,
``firwin``, minimum phase) are copies of the reference's host float64 code;
their taps are NumPy arrays in both packages. ``savgol_filter`` runs on the
signal's device through :func:`causal_conv`.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.dispatch import record_choice
from ..utils.layout import cdiv, overlapping_frames


def _as_planar(x: torch.Tensor) -> tuple[torch.Tensor, bool]:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(x).__name__}")
    if x.dim() == 1:
        return x[None, :], True
    if x.dim() == 2:
        return x, False
    raise ValueError(f"expected (time,) or (channels, time), got shape {tuple(x.shape)}")


def _taps_on(taps, device: torch.device) -> torch.Tensor:
    """The taps as a 1-D float32 tensor on ``device``.

    NumPy and CPU taps are copied there; taps on another card are refused.
    """
    if isinstance(taps, torch.Tensor):
        if taps.device.type != "cpu" and taps.device != device:
            raise ValueError(f"taps on {taps.device}, signal on {device}")
        h = taps.to(device=device, dtype=torch.float32)
    else:
        h = torch.from_numpy(np.asarray(taps, np.float32)).to(device)
    if h.dim() != 1 or h.numel() < 1:
        raise ValueError(f"taps must be a non-empty 1-D vector, got shape {tuple(h.shape)}")
    return h


@contextlib.contextmanager
def ieee_fp32_conv():
    """Run cuDNN float32 convolutions in IEEE float32 inside the block.

    cuDNN runs float32 convolutions in TF32 by default, about three decimal
    digits. The setting is restored on exit, never changed globally. Newer
    PyTorch spells it ``torch.backends.cudnn.conv.fp32_precision``; older
    releases ``torch.backends.cudnn.allow_tf32``.
    """
    cudnn = torch.backends.cudnn
    conv = getattr(cudnn, "conv", None)
    if conv is not None and hasattr(conv, "fp32_precision"):
        saved = conv.fp32_precision
        conv.fp32_precision = "ieee"
        try:
            yield
        finally:
            conv.fp32_precision = saved
    else:
        saved = cudnn.allow_tf32
        cudnn.allow_tf32 = False
        try:
            yield
        finally:
            cudnn.allow_tf32 = saved


@contextlib.contextmanager
def ieee_fp32_matmul():
    """Run float32 matrix products on the card in IEEE float32 inside the block.

    PyTorch's default already is IEEE float32, but a caller may have turned
    TF32 on (``torch.set_float32_matmul_precision``); the products that stand
    for the reference's ``Precision.HIGHEST`` matmuls pin it. Restored on
    exit. Newer PyTorch spells it ``torch.backends.cuda.matmul.fp32_precision``;
    older releases ``allow_tf32``.
    """
    matmul = torch.backends.cuda.matmul
    attr, value = ("fp32_precision", "ieee") if hasattr(matmul, "fp32_precision") else ("allow_tf32", False)
    saved = getattr(matmul, attr)
    setattr(matmul, attr, value)
    try:
        yield
    finally:
        setattr(matmul, attr, saved)


def causal_conv(xp: torch.Tensor, taps: torch.Tensor, *, stride: int = 1) -> torch.Tensor:
    """``y[m] = sum_j h[j] x[m*stride - j]``: (c, t) -> (c, t // stride).

    The reference's ``blocked_causal_conv`` as one strided ``conv1d``. With
    k-1 zeros on the left, output m of the convolution sits at input
    ``m * stride``, so the polyphase phase is the reference's; ``conv1d``
    gives ``ceil(t / stride)`` outputs and the reference ``t // stride``.
    """
    c, t = xp.shape
    m = t // stride
    if m == 0:
        return xp.new_zeros((c, 0), dtype=torch.float32)
    k = taps.shape[0]
    x3 = F.pad(xp.to(torch.float32).unsqueeze(1), (k - 1, 0))
    with ieee_fp32_conv():
        y = F.conv1d(x3, taps.flip(0).view(1, 1, k), stride=stride)
    return y[:, 0, :m]


def interp_conv(xp: torch.Tensor, taps: torch.Tensor, *, up: int) -> torch.Tensor:
    """``y[n] = sum_m h[n - m*up] x[m]``: zero-stuff by ``up``, then the causal FIR.

    The reference's ``blocked_interp_conv`` as one ``conv_transpose1d``;
    (c, t) -> (c, t * up).
    """
    c, t = xp.shape
    if t == 0:
        return xp.new_zeros((c, 0), dtype=torch.float32)
    k = taps.shape[0]
    with ieee_fp32_conv():
        y = F.conv_transpose1d(xp.to(torch.float32).unsqueeze(1), taps.view(1, 1, k), stride=up)
    y = y[:, 0, : t * up]
    if y.shape[-1] < t * up:  # k < up: the outputs past (t-1)*up + k are zeros
        y = F.pad(y, (0, t * up - y.shape[-1]))
    return y


def fir_direct(x: torch.Tensor, taps) -> torch.Tensor:
    """Causal direct-form FIR of a (channels, time) or (time,) float signal."""
    xp, squeeze = _as_planar(x)
    y = causal_conv(xp, _taps_on(taps, xp.device))
    return y[0] if squeeze else y


def _pick_block(k: int) -> int:
    return max(256, 1 << int(np.ceil(np.log2(8 * max(k, 2)))))


def _next_pow2_overlap(k: int) -> int:
    # extra room beyond L for the k-1 overlap, rounded so nfft stays pow2-ish
    return 1 << int(np.ceil(np.log2(max(k, 2))))


def fir_overlap_save(x: torch.Tensor, taps, *, block: int | None = None) -> torch.Tensor:
    """Causal FIR via overlap-save block FFT convolution (``torch.fft``).

    Each length-``nfft`` segment overlaps its predecessor by k-1 samples;
    the first k-1 outputs of each block wrap around and are discarded. Zero
    left-padding gives the causal start.
    """
    xp, squeeze = _as_planar(x)
    c, t = xp.shape
    h = _taps_on(taps, xp.device)
    k = h.shape[0]
    L = block or _pick_block(k)
    nfft = L + _next_pow2_overlap(k)
    y = overlap_save_frames(xp, torch.fft.rfft(h, n=nfft), k, L, nfft)
    return y[0] if squeeze else y


def overlap_save_frames(
    xp: torch.Tensor, h_half: torch.Tensor, k: int, block: int, nfft: int
) -> torch.Tensor:
    """Overlap-save with ``torch.fft`` given the taps' half spectrum ``h_half``.

    Segment i covers [i*block - (k-1), i*block - (k-1) + nfft) of the signal
    (zeros outside it) and keeps its outputs k-1 .. k-1+block.
    """
    c, t = xp.shape
    if t == 0:
        return xp.new_zeros((c, 0), dtype=torch.float32)
    nblocks = cdiv(t, block)
    pad_r = nblocks * block - t + (nfft - block - (k - 1))
    xpad = F.pad(xp.to(torch.float32), (k - 1, pad_r))
    segs = overlapping_frames(xpad, nblocks, block, nfft)  # (c, nblocks, nfft)
    Y = torch.fft.irfft(torch.fft.rfft(segs, dim=-1) * h_half, n=nfft, dim=-1)
    return Y[:, :, k - 1 : k - 1 + block].reshape(c, nblocks * block)[:, :t]


# Taps above which `auto` leaves the direct conv1d for the fused overlap-save
# kernels. Measured on an H100 (chip_smoke.py phase 5, 16 x 2^22 float32,
# PERF.md): since B8 holds its points in registers, it beats conv1d in IEEE
# fp32 at every filter measured, from one tap (0.21 against 0.61 ms; B8's
# nfft is 256 up to 32 taps) to 8193 (about 300x), so `auto` never takes
# the direct route; ``method="direct"`` still does. (The reference's 3900
# was measured on a TPU v5e.)
FIR_FFT_CROSSOVER = 0


def fir_filter(x: torch.Tensor, taps, *, method: str = "auto", response=None) -> torch.Tensor:
    """Causal FIR with the direct / overlap-save crossover.

    ``auto`` takes ``direct`` up to FIR_FFT_CROSSOVER taps (none on the
    H100's measurement) and ``overlap_save_fused`` beyond: B8 while its transform fits one block's
    shared memory, then B9, then the plain ``overlap_save_mxu`` past B9's
    envelope. ``response`` is an ``fft_mxu.TapResponse`` computed once for
    these taps (a ``DspChain`` keeps one), so the call computes no spectrum
    of the taps; without it the fused route computes one per call.
    """
    from .fft_mxu import overlap_save_fused, overlap_save_mxu, pick_fused_block

    k = int(taps.shape[0])
    if method == "auto":
        method = "direct" if k <= FIR_FFT_CROSSOVER else "overlap_save_fused"
    record_choice("fir_filter", method)
    if method == "direct":
        return fir_direct(x, taps)
    if method == "overlap_save":
        return fir_overlap_save(x, taps)
    if method == "overlap_save_mxu":
        return overlap_save_mxu(x, taps, block=_pick_block(k))
    if method == "overlap_save_fused":
        block = pick_fused_block(k)
        if block is None:
            return overlap_save_mxu(x, taps, block=_pick_block(k))
        return overlap_save_fused(x, taps, block=block, response=response)
    raise ValueError(f"unknown FIR method {method!r}")


def _get_window(window: str | tuple, num_taps: int) -> np.ndarray:
    """Window by name; ("kaiser", beta) for the parameterized Kaiser."""
    if isinstance(window, tuple):
        name, *params = window
        if name == "kaiser":
            return np.kaiser(num_taps, float(params[0]))
        raise ValueError(f"unknown parameterized window {name!r}")
    if window == "hamming":
        return np.hamming(num_taps)
    if window == "hann":
        return np.hanning(num_taps)
    if window == "blackman":
        return np.blackman(num_taps)
    if window == "rect":
        return np.ones(num_taps)
    raise ValueError(f"unknown window {window!r}")


def kaiser_beta(attenuation_db: float) -> float:
    """Kaiser beta for a target stopband attenuation (Kaiser's formula)."""
    a = attenuation_db
    if a > 50:
        return 0.1102 * (a - 8.7)
    if a >= 21:
        return 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21)
    return 0.0


def kaiser_num_taps(attenuation_db: float, transition_width: float) -> int:
    """Tap-count estimate for attenuation (dB) and transition width (Nyquist
    units), from Kaiser's empirical formula; returned odd (highpass-safe)."""
    if not 0.0 < transition_width < 1.0:
        raise ValueError(f"transition width must be in (0,1), got {transition_width}")
    n = int(np.ceil((attenuation_db - 7.95) / (2.285 * np.pi * transition_width))) + 1
    return n + 1 - n % 2


def _sinc_kernel(num_taps: int, cutoff: float, window) -> np.ndarray:
    if not 0.0 < cutoff < 1.0:
        raise ValueError(f"cutoff must be in (0,1) of Nyquist, got {cutoff}")
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    return np.sinc(cutoff * n) * cutoff * _get_window(window, num_taps)


def design_lowpass(
    num_taps: int, cutoff: float, *, window: str | tuple = "hamming"
) -> np.ndarray:
    """Windowed-sinc lowpass taps; cutoff in normalized (0, 1) Nyquist units.

    Unity gain at DC. ``window`` accepts "hamming"/"hann"/"blackman"/"rect"
    or ("kaiser", beta).
    """
    h = _sinc_kernel(num_taps, cutoff, window)
    return (h / h.sum()).astype(np.float32)


def _require_odd(num_taps: int, kind: str) -> None:
    if num_taps % 2 == 0:
        raise ValueError(
            f"{kind} needs odd num_taps (a type-I center tap), got {num_taps}"
        )


def design_highpass(
    num_taps: int, cutoff: float, *, window: str | tuple = "hamming"
) -> np.ndarray:
    """Windowed-sinc highpass by spectral inversion; unity gain at Nyquist."""
    _require_odd(num_taps, "highpass")
    h = -design_lowpass(num_taps, cutoff, window=window)
    h[(num_taps - 1) // 2] += 1.0
    # normalize Nyquist gain |sum h[n] (-1)^n| to 1
    g = float(np.abs((h * (-1.0) ** np.arange(num_taps)).sum()))
    return (h / g).astype(np.float32)


def design_bandpass(
    num_taps: int, low: float, high: float, *, window: str | tuple = "hamming"
) -> np.ndarray:
    """Windowed-sinc bandpass; unity gain at the band center."""
    if not 0.0 < low < high < 1.0:
        raise ValueError(f"need 0 < low < high < 1 (Nyquist units), got {low}, {high}")
    h = _sinc_kernel(num_taps, high, window) - _sinc_kernel(num_taps, low, window)
    fc = 0.5 * (low + high)
    n = np.arange(num_taps)
    g = np.abs((h * np.exp(-1j * np.pi * fc * n)).sum())
    return (h / g).astype(np.float32)


def design_bandstop(
    num_taps: int, low: float, high: float, *, window: str | tuple = "hamming"
) -> np.ndarray:
    """Windowed-sinc bandstop (notch): lowpass(low) + highpass(high)."""
    _require_odd(num_taps, "bandstop")
    if not 0.0 < low < high < 1.0:
        raise ValueError(f"need 0 < low < high < 1 (Nyquist units), got {low}, {high}")
    h = _sinc_kernel(num_taps, low, window) - _sinc_kernel(num_taps, high, window)
    h[(num_taps - 1) // 2] += 1.0
    return (h / h.sum()).astype(np.float32)  # unity DC gain


def box_taps(window: int) -> np.ndarray:
    """The moving average as an FIR: k equal taps (ties the two API families)."""
    return np.full(window, 1.0 / window, dtype=np.float32)


def design_rrc(num_taps: int, beta: float, sps: int) -> np.ndarray:
    """Root-raised-cosine pulse (unit energy), ``sps`` samples per symbol.

    ``beta``: excess bandwidth (rolloff) in (0, 1]. The cascade of two of
    these (transmit shaping + receive matched filter) is the raised-cosine
    Nyquist pulse: zero ISI at symbol spacings, unit gain at the center —
    pinned by tests/test_modem.py. Odd ``num_taps`` keeps the peak on a
    sample. Closed form with the standard removable singularities at t = 0
    and |t| = 1/(4 beta) evaluated by their limits.
    """
    _require_odd(num_taps, "rrc")
    if not 0.0 < beta <= 1.0:
        raise ValueError(f"beta must be in (0, 1], got {beta}")
    if sps < 2:
        raise ValueError(f"need sps >= 2, got {sps}")
    t = (np.arange(num_taps, dtype=np.float64) - (num_taps - 1) / 2) / sps
    h = np.empty_like(t)
    zero = np.isclose(t, 0.0)
    sing = np.isclose(np.abs(4.0 * beta * t), 1.0)
    rest = ~(zero | sing)
    h[zero] = 1.0 + beta * (4.0 / np.pi - 1.0)
    if sing.any():
        u = np.pi / (4.0 * beta)
        h[sing] = (beta / np.sqrt(2.0)) * (
            (1.0 + 2.0 / np.pi) * np.sin(u) + (1.0 - 2.0 / np.pi) * np.cos(u)
        )
    tr = t[rest]
    h[rest] = (
        np.sin(np.pi * tr * (1.0 - beta))
        + 4.0 * beta * tr * np.cos(np.pi * tr * (1.0 + beta))
    ) / (np.pi * tr * (1.0 - (4.0 * beta * tr) ** 2))
    return (h / np.sqrt(np.sum(h * h))).astype(np.float32)


def design_firls(
    num_taps: int,
    bands,
    desired,
    *,
    weights=None,
) -> np.ndarray:
    """Weighted least-squares linear-phase FIR (scipy.signal.firls semantics).

    ``bands``: flat band-edge pairs in (0, 1) Nyquist units covering the
    regions that matter; ``desired``: amplitude at each band edge (linear
    between edges); ``weights``: one weight per band. Type-I only (odd
    ``num_taps``). The normal equations use closed-form integrals of
    cos products over the bands — no frequency grid, no iteration.
    Validated against scipy.signal.firls in tests/test_design_spectral.py.
    """
    if num_taps % 2 == 0:
        raise ValueError(f"firls needs odd num_taps (type I), got {num_taps}")
    bands = np.asarray(bands, np.float64).reshape(-1, 2)
    desired = np.asarray(desired, np.float64).reshape(-1, 2)
    if bands.shape[0] != desired.shape[0]:
        raise ValueError("desired needs one amplitude per band edge")
    if np.any(bands[:, 0] >= bands[:, 1]) or np.any(bands < 0) or np.any(bands > 1):
        raise ValueError(f"band edges must satisfy 0 <= f1 < f2 <= 1: {bands}")
    w = np.ones(bands.shape[0]) if weights is None else np.asarray(weights, np.float64)
    m = (num_taps - 1) // 2

    def int_cos(k, f1, f2):
        # integral of cos(pi f k) over [f1, f2]
        if k == 0:
            return f2 - f1
        u = np.pi * k
        return (np.sin(u * f2) - np.sin(u * f1)) / u

    def int_fcos(k, f1, f2):
        # integral of f * cos(pi f k) over [f1, f2]
        if k == 0:
            return (f2**2 - f1**2) / 2.0
        u = np.pi * k
        return (
            np.cos(u * f2) - np.cos(u * f1)
        ) / u**2 + (f2 * np.sin(u * f2) - f1 * np.sin(u * f1)) / u

    q = np.zeros((m + 1, m + 1))
    b = np.zeros(m + 1)
    for (f1, f2), (d1, d2), wb in zip(bands, desired, w):
        slope = (d2 - d1) / (f2 - f1)
        c0 = d1 - slope * f1  # D(f) = c0 + slope * f
        for i in range(m + 1):
            b[i] += wb * (
                c0 * int_cos(i, f1, f2) + slope * int_fcos(i, f1, f2)
            )
            for j in range(i, m + 1):
                v = 0.5 * wb * (int_cos(i - j, f1, f2) + int_cos(i + j, f1, f2))
                q[i, j] += v
                if i != j:
                    q[j, i] += v
    a = np.linalg.solve(q, b)
    h = np.concatenate([a[:0:-1] / 2.0, [a[0]], a[1:] / 2.0])
    return h.astype(np.float32)


def _type1_amplitude(h: np.ndarray, freqs: np.ndarray) -> np.ndarray:
    """Zero-phase amplitude A(f) of odd-length linear-phase taps."""
    m = (h.size - 1) // 2
    a = np.concatenate([[h[m]], 2.0 * h[m + 1 :]])
    return np.cos(np.pi * np.outer(freqs, np.arange(m + 1))) @ a


def design_remez(
    num_taps: int,
    bands,
    desired,
    *,
    weights=None,
    grid_density: int = 16,
    max_iterations: int = 250,
) -> np.ndarray:
    """True minimax (Parks-McClellan) linear-phase FIR via Remez exchange.

    ``bands``: flat band-edge pairs in [0, 1] Nyquist units; ``desired``:
    ONE amplitude per band (scipy.signal.remez semantics, with scipy's
    [0, 0.5]-of-fs edges rescaled to Nyquist units); ``weights``: one
    relative error weight per band. Type-I only (odd ``num_taps``).

    The exchange iterates the optimal-alternation characterization exactly
    (Chebyshev/barycentric interpolation over x = cos(pi f), candidate
    extrema from the dense grid, alternation-preserving trimming) rather
    than approximating it with Lawson reweighting — converged max ripple
    matches scipy.signal.remez to ~1e-6 across the spec grid in
    tests/test_design_spectral.py. Barycentric weights are computed in the
    log domain so tap counts in the hundreds don't underflow the
    prod(x_k - x_j) terms.
    """
    if num_taps % 2 == 0:
        raise ValueError(f"design_remez needs odd num_taps (type I), got {num_taps}")
    bands = np.asarray(bands, np.float64).reshape(-1, 2)
    desired = np.asarray(desired, np.float64).ravel()
    if desired.size != bands.shape[0]:
        raise ValueError(
            f"desired needs one amplitude per band: {desired.size} values for "
            f"{bands.shape[0]} bands"
        )
    if np.any(bands[:, 0] >= bands[:, 1]) or np.any(bands < 0) or np.any(bands > 1):
        raise ValueError(f"band edges must satisfy 0 <= f1 < f2 <= 1: {bands}")
    if np.any(bands.ravel()[1:] < bands.ravel()[:-1]):
        raise ValueError(f"bands must be sorted and non-overlapping: {bands}")
    w_bands = (
        np.ones(bands.shape[0])
        if weights is None
        else np.asarray(weights, np.float64).ravel()
    )
    if w_bands.size != bands.shape[0]:
        raise ValueError("weights needs one value per band")

    m = (num_taps - 1) // 2
    r = m + 2  # number of alternation extrema

    # dense grid: points proportional to band width, edges always included
    total_w = float(np.sum(bands[:, 1] - bands[:, 0]))
    grid_f, grid_d, grid_w, grid_band = [], [], [], []
    for bi, ((f1, f2), d, wb) in enumerate(zip(bands, desired, w_bands)):
        npts = max(int(round(grid_density * (m + 1) * (f2 - f1) / total_w)), 8)
        f = np.linspace(f1, f2, npts)
        grid_f.append(f)
        grid_d.append(np.full(npts, d))
        grid_w.append(np.full(npts, wb))
        grid_band.append(np.full(npts, bi))
    grid_f = np.concatenate(grid_f)
    grid_d = np.concatenate(grid_d)
    grid_w = np.concatenate(grid_w)
    grid_band = np.concatenate(grid_band)
    # dedupe any coincident band edges
    keep = np.concatenate([[True], np.diff(grid_f) > 1e-12])
    grid_f, grid_d, grid_w = grid_f[keep], grid_d[keep], grid_w[keep]
    grid_band = grid_band[keep]
    L = grid_f.size
    # per-band [start, end] index ranges: extremum detection must not span
    # the gap between bands, and every band edge is an extremum candidate
    seg_bounds = [
        (int(np.argmax(grid_band == bi)), int(L - 1 - np.argmax(grid_band[::-1] == bi)))
        for bi in range(bands.shape[0])
    ]
    if L < r:
        raise ValueError(
            f"grid of {L} points cannot hold {r} alternations; raise "
            f"grid_density or widen the bands"
        )
    grid_x = np.cos(np.pi * grid_f)

    # initial extrema: uniform over the grid
    ext = np.round(np.linspace(0, L - 1, r)).astype(np.int64)

    def _bary_weights(x):
        # d_k = 1/prod_{j!=k}(x_k - x_j), computed as sign * exp(log) and
        # normalized (only ratios matter) so hundreds of factors don't
        # underflow float64
        diff = x[:, None] - x[None, :]
        np.fill_diagonal(diff, 1.0)
        sign = np.prod(np.sign(diff), axis=1)
        logs = -np.sum(np.log(np.abs(diff)), axis=1)
        return sign * np.exp(logs - logs.max())

    last_delta = None
    for _ in range(max_iterations):
        x_e = grid_x[ext]
        d_e = grid_d[ext]
        w_e = grid_w[ext]
        gamma = _bary_weights(x_e)
        alt = (-1.0) ** np.arange(r)
        delta = float(np.sum(gamma * d_e) / np.sum(gamma * alt / w_e))
        # interpolation points: first r-1 extrema, value D - (-1)^k d/W
        c = d_e[:-1] - alt[:-1] * delta / w_e[:-1]
        # barycentric weights for the r-1 subset: beta_k = d_k*(x_k - x_last)
        beta = gamma[:-1] * (x_e[:-1] - x_e[-1])

        # A(f) on the whole grid via barycentric interpolation
        dx = grid_x[:, None] - x_e[None, :-1]
        hit = np.isclose(dx, 0.0, atol=1e-14)
        dx_safe = np.where(hit, 1.0, dx)
        num = np.sum(beta * c / dx_safe, axis=1)
        den = np.sum(beta / dx_safe, axis=1)
        amp = num / den
        row_hit = hit.any(axis=1)
        if row_hit.any():
            amp[row_hit] = c[np.argmax(hit[row_hit], axis=1)]
        err = grid_w * (amp - grid_d)

        # candidate extrema per band: interior local maxima of |err| plus
        # both band edges (extrema of the optimal solution sit at edges)
        e = err
        cand_list: list[int] = []
        for s, t in seg_bounds:
            cand_list.append(s)
            for i in range(s + 1, t):
                if abs(e[i]) >= abs(e[i - 1]) and abs(e[i]) >= abs(e[i + 1]):
                    cand_list.append(i)
            if t > s:
                cand_list.append(t)
        cand = np.unique(cand_list)
        # collapse consecutive same-sign candidates to the largest |err|
        sel: list[int] = []
        for i in cand:
            if sel and np.sign(e[i]) == np.sign(e[sel[-1]]):
                if abs(e[i]) > abs(e[sel[-1]]):
                    sel[-1] = int(i)
            else:
                sel.append(int(i))
        # trim to exactly r alternations, dropping the weakest endpoint(s)
        while len(sel) > r:
            if len(sel) - r == 1:
                # drop whichever endpoint is weaker (keeps alternation)
                if abs(e[sel[0]]) <= abs(e[sel[-1]]):
                    sel.pop(0)
                else:
                    sel.pop()
            else:
                # drop the globally weakest extremum and its weaker neighbor
                k = int(np.argmin(np.abs(e[sel])))
                if k == 0:
                    sel.pop(0)
                elif k == len(sel) - 1:
                    sel.pop()
                else:
                    nb = k - 1 if abs(e[sel[k - 1]]) < abs(e[sel[k + 1]]) else k + 1
                    for idx in sorted((k, nb), reverse=True):
                        sel.pop(idx)
        if len(sel) < r:
            # degenerate spec (grid too coarse for the alternation count)
            break
        new_ext = np.asarray(sel, np.int64)
        converged = np.array_equal(new_ext, ext) or (
            last_delta is not None
            and abs(abs(delta) - last_delta) <= 1e-14 + 1e-9 * abs(delta)
            and np.max(np.abs(err)) - abs(delta) <= 1e-9 * max(abs(delta), 1e-12)
        )
        ext = new_ext
        last_delta = abs(delta)
        if converged:
            break

    # final coefficients: evaluate A at num_taps uniform points, inverse DFT
    x_e = grid_x[ext]
    d_e = grid_d[ext]
    w_e = grid_w[ext]
    gamma = _bary_weights(x_e)
    alt = (-1.0) ** np.arange(r)
    delta = float(np.sum(gamma * d_e) / np.sum(gamma * alt / w_e))
    c = d_e[:-1] - alt[:-1] * delta / w_e[:-1]
    beta = gamma[:-1] * (x_e[:-1] - x_e[-1])

    # DFT sampling points omega_k = 2 pi k / N -> f_k = 2k/N Nyquist units,
    # folded into [0, 1] (A is even and 2-periodic in f)
    fs = 2.0 * np.arange(num_taps, dtype=np.float64) / num_taps
    xs = np.cos(np.pi * np.minimum(fs, 2.0 - fs))
    dx = xs[:, None] - x_e[None, :-1]
    hit = np.isclose(dx, 0.0, atol=1e-14)
    dx_safe = np.where(hit, 1.0, dx)
    amp = np.sum(beta * c / dx_safe, axis=1) / np.sum(beta / dx_safe, axis=1)
    row_hit = hit.any(axis=1)
    if row_hit.any():
        amp[row_hit] = c[np.argmax(hit[row_hit], axis=1)]
    # type-I synthesis: h[m+n] = h[m-n] = (1/N) sum_k A_k cos(2 pi k n / N)
    n = np.arange(m + 1)
    k = np.arange(num_taps)
    half = (amp[None, :] * np.cos(2.0 * np.pi * np.outer(n, k) / num_taps)).sum(
        axis=1
    ) / num_taps
    h = np.concatenate([half[:0:-1], half])
    return h.astype(np.float32)


def design_equiripple(
    num_taps: int,
    bands,
    desired,
    *,
    iterations: int = 60,
    segments: int = 24,
) -> np.ndarray:
    """Equiripple FIR design (per-edge ``desired``, firls-style signature).

    Constant-per-band specs (d1 == d2 for every band — the common case)
    route to :func:`design_remez`, the true minimax exchange. Sloped
    (linear-desired) bands fall back to Lawson-iterated least squares —
    each band subdivided into ``segments`` constant-weight pieces, the
    weighted LS design re-solved with weights scaled by each piece's peak
    error (~1.3x optimal ripple); the Remez alternation theorem doesn't
    directly cover sloped desired, so the fallback stays.
    Type-I (odd taps) like design_firls.
    """
    bands = np.asarray(bands, np.float64).reshape(-1, 2)
    desired = np.asarray(desired, np.float64).reshape(-1, 2)
    if np.all(desired[:, 0] == desired[:, 1]):
        return design_remez(num_taps, bands.ravel(), desired[:, 0])
    sub_b, sub_d = [], []
    for (f1, f2), (d1, d2) in zip(bands, desired):
        edges = np.linspace(f1, f2, segments + 1)
        dvals = np.interp(edges, [f1, f2], [d1, d2])
        for i in range(segments):
            sub_b.append([edges[i], edges[i + 1]])
            sub_d.append([dvals[i], dvals[i + 1]])
    sub_b = np.asarray(sub_b)
    sub_d = np.asarray(sub_d)
    w = np.ones(len(sub_b))
    h = design_firls(num_taps, sub_b.ravel(), sub_d.ravel())
    for _ in range(iterations):
        h = design_firls(num_taps, sub_b.ravel(), sub_d.ravel(), weights=w)
        errs = np.empty(len(sub_b))
        for i, ((f1, f2), (d1, d2)) in enumerate(zip(sub_b, sub_d)):
            f = np.linspace(f1, f2, 16)
            amp = _type1_amplitude(h.astype(np.float64), f)
            errs[i] = np.max(np.abs(amp - np.interp(f, [f1, f2], [d1, d2])))
        w = np.maximum(w * errs / errs.max(), 1e-6)
        w = w / w.max()
    return h.astype(np.float32)


def _symmetric_window(window: str, n: int) -> np.ndarray:
    """SYMMETRIC design window (filter-design convention; the spectral ops
    use the periodic form in ops/fft.spectral_window)."""
    if n == 1:
        return np.ones(1)
    k = np.arange(n, dtype=np.float64)
    if window == "hamming":
        return 0.54 - 0.46 * np.cos(2 * np.pi * k / (n - 1))
    if window == "hann":
        return 0.5 - 0.5 * np.cos(2 * np.pi * k / (n - 1))
    if window == "blackman":
        return (
            0.42
            - 0.5 * np.cos(2 * np.pi * k / (n - 1))
            + 0.08 * np.cos(4 * np.pi * k / (n - 1))
        )
    if window == "rect":
        return np.ones(n)
    raise ValueError(f"unknown design window {window!r}")


def design_firwin2(
    num_taps: int,
    freq,
    gain,
    *,
    nfreqs: int | None = None,
    window: str = "hamming",
) -> np.ndarray:
    """Frequency-sampling FIR design (scipy.signal.firwin2 semantics).

    ``freq``: increasing points in [0, 1] Nyquist units starting at 0 and
    ending at 1; ``gain``: desired amplitude at each point (linear between
    them). The desired response is interpolated onto a fine half-spectrum
    grid, given the linear phase of a centered type-I/II filter, inverse-
    transformed, and windowed. Matches scipy.signal.firwin2 across the
    tests' spec grid (tests/test_design_spectral.py).
    """
    freq = np.asarray(freq, np.float64)
    gain = np.asarray(gain, np.float64)
    if freq.shape != gain.shape or freq.ndim != 1 or freq.size < 2:
        raise ValueError("freq and gain must be equal-length 1-D, size >= 2")
    if freq[0] != 0.0 or freq[-1] != 1.0 or np.any(np.diff(freq) < 0):
        raise ValueError("freq must increase from 0.0 to 1.0")
    if num_taps % 2 == 0 and gain[-1] != 0.0:
        raise ValueError("even num_taps (type II) forces zero gain at Nyquist")
    if nfreqs is None:
        nfreqs = 1 + 2 ** int(np.ceil(np.log2(max(num_taps, 2))))
    # scipy nudges exact duplicate interior points apart by an eps so the
    # interpolation sees a step; accept them the same way
    eps = np.finfo(np.float64).eps
    f = freq.copy()
    for i in range(1, f.size):
        if f[i] <= f[i - 1]:
            f[i] = f[i - 1] + eps * nfreqs
    x = np.linspace(0.0, 1.0, nfreqs)
    fx = np.interp(x, f, gain)
    # linear phase of the (num_taps-1)/2-sample-centered impulse response
    shift = np.exp(-(num_taps - 1) / 2.0 * 1j * np.pi * x)
    h_full = np.fft.irfft(fx * shift)
    return (h_full[:num_taps] * _symmetric_window(window, num_taps)).astype(
        np.float32
    )


def design_savgol(
    window_length: int, polyorder: int, *, deriv: int = 0, delta: float = 1.0
) -> np.ndarray:
    """Savitzky-Golay coefficients (scipy.signal.savgol_coeffs, pos=center).

    Least-squares projection onto degree-``polyorder`` polynomials over a
    centered window: solve the Vandermonde normal system once, host-side
    float64. Returned in scipy's convolution orientation (apply as
    correlation with the REVERSED array, which :func:`savgol_filter` does).
    """
    if window_length <= polyorder:
        raise ValueError(
            f"window_length {window_length} must exceed polyorder {polyorder}"
        )
    if window_length % 2 == 0:
        raise ValueError(f"window_length must be odd, got {window_length}")
    if deriv > polyorder:
        return np.zeros(window_length, np.float64)
    half = window_length // 2
    pos = np.arange(-half, half + 1, dtype=np.float64)
    # A[i, j] = pos[j] ** i; coeffs = row `deriv` of pinv(A^T) scaled
    a = pos[None, :] ** np.arange(polyorder + 1, dtype=np.float64)[:, None]
    y = np.zeros(polyorder + 1)
    y[deriv] = float(math.factorial(deriv)) / (delta**deriv)
    coeffs, *_ = np.linalg.lstsq(a.T, np.eye(window_length), rcond=None)
    c = coeffs.T @ y
    return c[::-1]  # scipy's conv orientation


def _centered_fir(ext: torch.Tensor, c: np.ndarray) -> torch.Tensor:
    """Centered correlation y[t] = sum_m c[m] ext[t+m] over a pre-padded
    (channels, time) stream with half-window halos on both sides."""
    wl = c.shape[0]
    taps = torch.from_numpy(np.ascontiguousarray(c[::-1], np.float32)).to(ext.device)
    y = causal_conv(ext, taps)
    t = ext.shape[-1] - (wl - 1)
    return y[..., wl - 1 : wl - 1 + t]


_SAVGOL_MODES = ("mirror", "nearest", "wrap", "constant")


def _savgol_pad(xf: torch.Tensor, half: int, mode: str) -> torch.Tensor:
    """``xf`` (channels, time) with ``half`` samples on both sides, as ``jnp.pad`` /
    ``np.pad`` in mode "reflect", "edge", "wrap" or "constant": the reflection or the
    wrap repeats as often as the pad needs, so any pad suits any length
    (``F.pad``'s reflect and circular refuse a pad of the length or more)."""
    t = xf.shape[-1]
    if mode == "constant":
        return F.pad(xf, (half, half))
    i = np.arange(-half, t + half)
    if mode == "nearest":
        i = np.clip(i, 0, t - 1)
    elif mode == "wrap":
        i = i % t
    elif t == 1:  # mirror of one sample: the sample
        i = np.zeros_like(i)
    else:  # mirror about the edge samples: period 2 (t - 1)
        i = i % (2 * (t - 1))
        i = np.where(i >= t, 2 * (t - 1) - i, i)
    return xf[..., torch.from_numpy(i).to(xf.device)]


def savgol_filter(
    x: torch.Tensor,
    window_length: int,
    polyorder: int,
    *,
    deriv: int = 0,
    delta: float = 1.0,
    mode: str = "interp",
) -> torch.Tensor:
    """Savitzky-Golay smoothing of a (channels, time) or (time,) signal on its device.

    The interior is one centered FIR with the projection coefficients
    (:func:`causal_conv`, IEEE float32); ``mode="interp"`` (scipy's default)
    replaces each edge with the polynomial fitted to the first/last window
    evaluated at the edge positions, a fixed (half, window) matrix. Other
    modes pad: "mirror", "nearest", "wrap", "constant" (zero), as
    scipy.signal.savgol_filter. The reference spells the interior as a
    lane-blocked matrix product for its TPU; the function is the same.
    """
    xp, squeeze = _as_planar(x)
    cc = design_savgol(window_length, polyorder, deriv=deriv, delta=delta)
    c = cc[::-1]  # correlation orientation: y[t] = sum_m c[m] x[t-half+m]
    half = window_length // 2
    xf = xp.to(torch.float32)
    if mode == "interp":
        if xp.shape[-1] <= window_length:
            raise ValueError("mode='interp' needs time > window_length; use another mode")
        y = _centered_fir(F.pad(xf, (half, half)), c)
        # edge fit: values = (V_eval @ pinv(V_fit)) @ x[:window]
        pos = np.arange(window_length, dtype=np.float64)
        pf = np.linalg.pinv(pos[:, None] ** np.arange(polyorder + 1)[None, :])
        dscale = np.array([
            float(math.factorial(i)) / float(math.factorial(i - deriv)) / delta**deriv
            if i >= deriv else 0.0
            for i in range(polyorder + 1)
        ])

        def edge(pe: np.ndarray) -> torch.Tensor:
            # d-th derivative of sum_i a_i p^i at p: sum_{i>=d} a_i i!/(i-d)! p^(i-d)
            ve = np.zeros((half, polyorder + 1))
            for i in range(deriv, polyorder + 1):
                ve[:, i] = dscale[i] * pe ** (i - deriv)
            return torch.from_numpy((ve @ pf).astype(np.float32)).to(xf.device)

        if half:
            with ieee_fp32_matmul():  # a caller's TF32 would leave 1e-4 at the edges
                y[..., :half] = torch.einsum(
                    "hw,cw->ch", edge(np.arange(half, dtype=np.float64)), xf[..., :window_length])
                y[..., -half:] = torch.einsum(
                    "hw,cw->ch",
                    edge(np.arange(window_length - half, window_length, dtype=np.float64)),
                    xf[..., -window_length:],
                )
    else:
        if mode not in _SAVGOL_MODES:
            raise ValueError(f"unknown mode {mode!r}")
        y = _centered_fir(_savgol_pad(xf, half, mode), c)
    return y[0] if squeeze else y


def kaiserord(ripple_db: float, width: float) -> tuple[int, float]:
    """(num_taps, beta) for a Kaiser-window FIR meeting ``ripple_db`` of
    stopband attenuation with a ``width``-wide transition (Nyquist units) —
    scipy.signal.kaiserord's (numtaps, beta) contract over the existing
    :func:`kaiser_beta`/:func:`kaiser_num_taps` estimates.
    """
    ripple_db = abs(float(ripple_db))
    if ripple_db < 8:
        raise ValueError(
            "ripple below 8 dB is outside Kaiser's formula (scipy raises too)"
        )
    if not 0.0 < width < 1.0:
        raise ValueError(f"width must be in (0,1) Nyquist units, got {width}")
    n = int(np.ceil((ripple_db - 7.95) / (2.285 * np.pi * width))) + 1
    return n, kaiser_beta(ripple_db)


def minimum_phase(h: np.ndarray, *, n_fft: int | None = None) -> np.ndarray:
    """Minimum-phase spectral factor of a linear-phase FIR (homomorphic
    method, scipy.signal.minimum_phase semantics: half-length output).

    Folds the cepstrum of log|H| so all zeros move inside the unit circle
    while |H| is preserved (sqrt in magnitude at half length). Host-side
    float64; the big FFT is a one-time design cost like the rest of the
    tap designers.
    """
    h = np.asarray(h, np.float64)
    if h.ndim != 1 or h.size < 3:
        raise ValueError(f"h must be 1-D with >= 3 taps, got shape {h.shape}")
    if n_fft is None:
        n_fft = 1 << int(np.ceil(np.log2(2 * (h.size - 1) / 0.01)))
    if n_fft < h.size:
        raise ValueError(f"n_fft {n_fft} < len(h) {h.size}")
    # HALF log magnitude: the half-length result's magnitude is sqrt|H|,
    # so cascading it twice reproduces the original response
    spec = np.abs(np.fft.fft(h, n_fft))
    spec += 1e-7 * spec[spec > 0].min()  # homomorphic-safe floor
    logmag = 0.5 * np.log(spec)
    # fold + TRUNCATE the cepstrum at half the filter length (smooths the
    # factorization like scipy's homomorphic variant)
    cep = np.real(np.fft.ifft(logmag))
    win = np.zeros(n_fft)
    win[0] = 1.0
    stop = (h.size + 1) // 2
    win[1:stop] = 2.0
    h_min = np.real(np.fft.ifft(np.exp(np.fft.fft(cep * win))))
    n_out = h.size // 2 + h.size % 2
    return h_min[:n_out].astype(np.float64)


def deconvolve(signal, divisor) -> tuple[np.ndarray, np.ndarray]:
    """(quotient, remainder) polynomial long division so that
    ``signal = convolve(divisor, quotient) + remainder``
    (scipy.signal.deconvolve; host-side float64 — it is the inverse-design
    step, not a stream op).
    """
    num = np.atleast_1d(np.asarray(signal, np.float64))
    den = np.atleast_1d(np.asarray(divisor, np.float64))
    if den[0] == 0.0:
        raise ValueError("divisor[0] must be nonzero")
    if num.size < den.size:
        return np.array([0.0]), num.copy()
    nq = num.size - den.size + 1
    q = np.zeros(nq)
    r = num.copy()
    for i in range(nq):
        q[i] = r[i] / den[0]
        r[i : i + den.size] -= q[i] * den
    return q, r


def firwin(
    numtaps: int,
    cutoff,
    *,
    window: str | tuple = "hamming",
    pass_zero=True,
    scale: bool = True,
    fs: float = 2.0,
) -> np.ndarray:
    """scipy.signal.firwin-compatible multiband window-method design.

    Generalizes the ``design_lowpass/highpass/bandpass/bandstop`` family
    to arbitrary band stacks: ``cutoff`` is a scalar or ascending band-edge
    list in the units of ``fs``; ``pass_zero`` a bool or one of
    'lowpass'/'highpass'/'bandpass'/'bandstop'. Windows go through
    :func:`~.fft.get_window` (symmetric form) so the full window family is
    accepted.
    """
    from .fft import get_window as _gw

    cutoff = np.atleast_1d(np.asarray(cutoff, np.float64)) / (fs / 2.0)
    if cutoff.ndim > 1:
        raise ValueError("cutoff must be 1-D")
    if cutoff.size == 0:
        raise ValueError("at least one cutoff frequency is required")
    if np.any(cutoff <= 0) or np.any(cutoff >= 1):
        raise ValueError("cutoffs must be strictly inside (0, fs/2)")
    if np.any(np.diff(cutoff) <= 0):
        raise ValueError("cutoffs must be strictly increasing")
    if isinstance(pass_zero, str):
        if pass_zero in ("bandstop", "lowpass"):
            pass_zero = True
        elif pass_zero in ("bandpass", "highpass"):
            pass_zero = False
        else:
            raise ValueError(f"invalid pass_zero {pass_zero!r}")
    pass_nyquist = bool(cutoff.size & 1) ^ bool(pass_zero)
    if pass_nyquist and numtaps % 2 == 0:
        raise ValueError(
            "even numtaps has a zero at Nyquist; use odd numtaps for a "
            "filter passing fs/2"
        )
    if pass_zero:
        cutoff = np.concatenate([[0.0], cutoff])
    if pass_nyquist:
        cutoff = np.concatenate([cutoff, [1.0]])
    bands = cutoff.reshape(-1, 2)
    m = np.arange(numtaps) - (numtaps - 1) / 2.0
    h = np.zeros(numtaps)
    for left, right in bands:
        h += right * np.sinc(right * m) - left * np.sinc(left * m)
    win = (
        _get_window(window, numtaps)
        if isinstance(window, str) and window == "rect"
        else np.asarray(_gw(window, numtaps, fftbins=False))
    )
    h *= win
    if scale:
        left, right = bands[0]
        if left == 0.0:
            scale_f = 0.0
        elif right == 1.0:
            scale_f = 1.0
        else:
            scale_f = 0.5 * (left + right)
        h /= np.sum(h * np.cos(np.pi * m * scale_f))
    return h


def firwin_2d(
    hsize,
    window,
    *,
    fc=None,
    fs: float = 2.0,
    circular: bool = False,
    pass_zero=True,
) -> np.ndarray:
    """Separable (or circularly symmetric) 2-D window-method FIR design
    (scipy.signal.firwin_2d); pair with ``ops.twod.convolve2d``."""
    if len(hsize) != 2:
        raise ValueError("hsize must be a 2-element tuple or list")
    if fc is None:
        raise ValueError("cutoff frequency fc is required")
    if circular:
        n_r = max(hsize[0], hsize[1]) * 8
        win_r = firwin(n_r, fc, window=window, fs=fs, pass_zero=pass_zero)
        f1, f2 = np.meshgrid(
            np.linspace(-1, 1, hsize[0]), np.linspace(-1, 1, hsize[1])
        )
        r = np.sqrt(f1**2 + f2**2)
        return np.interp(r, np.linspace(0, 1, n_r), win_r)
    if len(window) != 2 or isinstance(window, str):
        raise ValueError("window must be a 2-element tuple or list")
    row = firwin(hsize[0], fc, window=window[0], fs=fs, pass_zero=pass_zero)
    col = firwin(hsize[1], fc, window=window[1], fs=fs, pass_zero=pass_zero)
    return np.outer(row, col)


def kaiser_atten(numtaps: int, width: float) -> float:
    """Attenuation (dB) of a Kaiser-window FIR with ``numtaps`` taps and
    transition width ``width`` (Nyquist units) — the inverse of
    :func:`kaiser_num_taps` (scipy.signal.kaiser_atten)."""
    return 2.285 * (numtaps - 1) * np.pi * width + 7.95


__all__ = [
    "FIR_FFT_CROSSOVER",
    "ieee_fp32_conv",
    "ieee_fp32_matmul",
    "causal_conv",
    "interp_conv",
    "fir_direct",
    "fir_overlap_save",
    "overlap_save_frames",
    "fir_filter",
    "design_lowpass",
    "kaiser_beta",
    "kaiser_num_taps",
    "box_taps",
    "design_highpass",
    "design_bandpass",
    "design_bandstop",
    "design_rrc",
    "design_firls",
    "design_remez",
    "design_equiripple",
    "design_firwin2",
    "design_savgol",
    "savgol_filter",
    "kaiserord",
    "minimum_phase",
    "deconvolve",
    "firwin",
    "firwin_2d",
    "kaiser_atten",
]
