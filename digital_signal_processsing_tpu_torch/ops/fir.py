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

The NumPy tap designers the chain uses are copied from the reference.
"""

from __future__ import annotations

import contextlib

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
# PERF.md): conv1d in IEEE fp32 is faster at 3, 5 and 7 taps, ties B8 at 9
# (1.00 ms each; B8's nfft is 256 up to 32 taps) and grows about 0.028 ms a
# tap beyond, so B8 wins at every longer filter measured, 101x at k=8193.
# (The reference's 3900 was measured on a TPU v5e.)
FIR_FFT_CROSSOVER = 8


def fir_filter(x: torch.Tensor, taps, *, method: str = "auto", response=None) -> torch.Tensor:
    """Causal FIR with the direct / overlap-save crossover.

    ``auto`` takes ``direct`` up to FIR_FFT_CROSSOVER taps and
    ``overlap_save_fused`` beyond: B8 while its transform fits one block's
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


def box_taps(window: int) -> np.ndarray:
    """The moving average as an FIR: k equal taps (ties the two API families)."""
    return np.full(window, 1.0 / window, dtype=np.float32)


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
]
