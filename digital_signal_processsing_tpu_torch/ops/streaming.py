"""Stateful streaming: the moving average, the FIR and the STFT, chunk by chunk.

Counterpart of the moving-average and FIR parts of
``digital_signal_processsing_tpu/ops/streaming.py``. The averager's state
is the raw halo, the last ``window * channels`` samples seen (zeros at
stream start, the zeroed prefix of gpu_utils.h:112-114 carried through
time); on every chunk length the windowed kernel (B1) runs with that halo
as its seed, and halos too large for it take the two-pass path over tail +
chunk, bit-exact with one shot. The FIR's state is the last ``taps - 1``
input samples of each channel; each chunk runs ``fir_direct`` over tail +
chunk, so chunks of any length give one shot's output up to float32
rounding. The streaming STFT carries the last ``nfft - hop`` inputs, the
WOLA synthesis the not yet complete ``nfft - hop`` outputs (the
reference's ``StftState``/``IstftState``); every ``*_state_from_jax``
continues a stream that the reference package started.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.layout import validate_window
from .fir import fir_direct
from .pallas_scan import moving_average_two_pass, windowed_averager, windowed_supported


@dataclasses.dataclass
class MovingAverageState:
    """Carry for the streaming averager: the last window*channels raw samples."""

    tail: torch.Tensor  # (window*channels,) int16, on the stream's device


def moving_average_init(window: int, channels: int = 1, *, device="cuda") -> MovingAverageState:
    validate_window(window)
    if channels < 1:
        raise ValueError(f"channels must be >= 1, got {channels}")
    dev = resolve_device(device)
    return MovingAverageState(tail=torch.zeros(window * channels, dtype=torch.int16, device=dev))


def state_from_jax(tail: np.ndarray, *, device="cuda") -> MovingAverageState:
    """The state of the reference package's streaming averager, carried over.

    ``tail`` is ``np.asarray(state.tail)`` of a
    ``digital_signal_processsing_tpu.ops.streaming.MovingAverageState``: the
    same window*channels raw samples, so the stream continues here exactly.
    """
    tail = np.asarray(tail)
    if tail.dtype != np.int16 or tail.ndim != 1:
        raise ValueError(f"expected a flat int16 tail, got {tail.dtype} {tail.shape}")
    dev = resolve_device(device)
    return MovingAverageState(tail=torch.from_numpy(tail.copy()).to(dev))


def moving_average_chunk(
    state: MovingAverageState,
    x: torch.Tensor,
    window: int,
    channels: int = 1,
) -> tuple[MovingAverageState, torch.Tensor]:
    """One chunk of the causal moving average (any whole-frame length).

    Returns the new state and the chunk's output, on ``x``'s device.
    """
    halo = window * channels
    if state.tail.numel() != halo:
        raise ValueError(
            f"state holds {state.tail.numel()} samples, expected window*channels={halo}"
        )
    n = x.numel()
    if windowed_supported(window, channels):
        out = windowed_averager(x, window, channels, seed=state.tail)
    else:
        out = moving_average_two_pass(torch.cat([state.tail, x]), window, channels)[halo:]
    # clone: the state must not keep the whole chunk alive through a view
    new_tail = x[n - halo :].clone() if n >= halo else torch.cat([state.tail[n:], x])
    return MovingAverageState(tail=new_tail), out


@dataclasses.dataclass
class FirState:
    """Carry for the streaming FIR: the last taps-1 input samples of each channel."""

    tail: torch.Tensor  # (channels, taps-1) float32, on the stream's device


def fir_init(num_taps: int, channels: int = 1, *, device="cuda") -> FirState:
    """Zero state for :func:`fir_chunk` on ``device`` (the card by default)."""
    if num_taps < 1 or channels < 1:
        raise ValueError(f"need num_taps >= 1 and channels >= 1, got {num_taps}, {channels}")
    dev = resolve_device(device)
    return FirState(tail=torch.zeros((channels, num_taps - 1), dtype=torch.float32, device=dev))


def fir_state_from_jax(tail, *, device="cuda") -> FirState:
    """The state of the reference package's ``fir_chunk``, carried over.

    ``tail`` is ``np.asarray(state.tail)`` of a
    ``digital_signal_processsing_tpu.ops.streaming.FirState``, the
    (channels, taps-1) float32 inputs last seen; the stream continues here.
    """
    tail = np.asarray(tail)
    if tail.dtype != np.float32 or tail.ndim != 2:
        raise ValueError(f"expected a float32 (channels, taps-1) tail, got {tail.dtype} {tail.shape}")
    return FirState(tail=torch.from_numpy(tail.copy()).to(resolve_device(device)))


def fir_chunk(state: FirState, x: torch.Tensor, taps) -> tuple[FirState, torch.Tensor]:
    """One chunk of a causal FIR over (channels, n) or (n,) float32: (new state, y).

    The chunk's output is the one-shot output of the concatenated stream at
    these samples, up to float32 rounding; a chunk may be of any length,
    shorter than the taps too.
    """
    k = int(np.shape(taps)[0])
    if state.tail.shape[-1] != k - 1:
        raise ValueError(f"state holds {state.tail.shape[-1]} samples a channel, taps need {k - 1}")
    if x.device != state.tail.device:
        raise ValueError(f"x on {x.device}, state on {state.tail.device}")
    squeeze = x.dim() == 1
    xp = x[None, :] if squeeze else x
    if k == 1:
        return state, fir_direct(x, taps)
    ext = torch.cat([state.tail, xp.to(torch.float32)], dim=-1)
    y = fir_direct(ext, taps)[..., k - 1 :]
    new_tail = ext[..., ext.shape[-1] - (k - 1) :].clone()
    return FirState(tail=new_tail), (y[0] if squeeze else y)


# --- streaming STFT / WOLA synthesis -------------------------------------------


def _float_tail(tail, what: str, device) -> torch.Tensor:
    tail = np.asarray(tail)
    if tail.dtype != np.float32 or tail.ndim != 2:
        raise ValueError(f"expected a float32 (channels, n) {what}, got {tail.dtype} {tail.shape}")
    return torch.from_numpy(tail.copy()).to(resolve_device(device))


def _hop_divides(nfft: int, hop: int, what: str) -> None:
    if hop < 1 or nfft % hop != 0:
        raise ValueError(f"streaming {what} needs hop | nfft, got {hop}/{nfft}")


@dataclasses.dataclass
class StftState:
    """Carry for streaming analysis: the last nfft-hop input samples.

    Zero at stream start, so the streamed frame sequence equals the
    one-shot :func:`ops.fft.stft` of the stream PREFIXED with nfft-hop
    zeros (the standard real-time priming); dropping the first
    ``nfft//hop - 1`` frames recovers exact unprimed one-shot parity.
    """

    tail: torch.Tensor  # (channels, nfft - hop) float32, on the stream's device


def stft_init(nfft: int, hop: int, channels: int = 1, *, device="cuda") -> StftState:
    """Zero state for :func:`stft_chunk` on ``device`` (the card by default)."""
    _hop_divides(nfft, hop, "stft")
    return StftState(tail=torch.zeros((channels, nfft - hop), dtype=torch.float32,
                                      device=resolve_device(device)))


def stft_state_from_jax(tail, *, device="cuda") -> StftState:
    """The state of the reference package's ``stft_chunk``, carried over.

    ``tail`` is ``np.asarray(state.tail)`` of a
    ``digital_signal_processsing_tpu.ops.streaming.StftState``.
    """
    return StftState(tail=_float_tail(tail, "tail", device))


def stft_chunk(
    state: StftState,
    x: torch.Tensor,
    *,
    nfft: int = 1024,
    hop: int = 512,
    window: str = "sqrt_hann",
    method: str = "auto",
) -> tuple[StftState, torch.Tensor]:
    """One chunk of the streaming STFT: (channels, L) -> (channels,
    L//hop, nfft//2+1), L a nonzero multiple of hop, on ``x``'s device.
    """
    from .fft import stft

    squeeze = x.dim() == 1
    xp = (x[None, :] if squeeze else x).to(torch.float32)
    L = xp.shape[-1]
    if L % hop != 0 or L == 0:
        raise ValueError(
            f"chunk length {L} must be a nonzero multiple of hop {hop}"
        )
    if state.tail.shape[-1] != nfft - hop:
        raise ValueError(f"state holds {state.tail.shape[-1]} samples a channel, need {nfft - hop}")
    ext = torch.cat([state.tail, xp], dim=-1)
    out = stft(ext, nfft=nfft, hop=hop, window=window, method=method)
    return StftState(tail=ext[..., L:].clone()), (out[0] if squeeze else out)


@dataclasses.dataclass
class IstftState:
    """Carry for streaming WOLA synthesis: the not-yet-complete OLA tail
    (nfft - hop samples)."""

    tail: torch.Tensor  # (channels, nfft - hop) float32, on the stream's device


def istft_init(nfft: int, hop: int, channels: int = 1, *, device="cuda") -> IstftState:
    """Zero state for :func:`istft_chunk` on ``device`` (the card by default)."""
    _hop_divides(nfft, hop, "istft")
    return IstftState(tail=torch.zeros((channels, nfft - hop), dtype=torch.float32,
                                       device=resolve_device(device)))


def istft_state_from_jax(tail, *, device="cuda") -> IstftState:
    """The state of the reference package's ``istft_chunk``, carried over.

    ``tail`` is ``np.asarray(state.tail)`` of a
    ``digital_signal_processsing_tpu.ops.streaming.IstftState``.
    """
    return IstftState(tail=_float_tail(tail, "tail", device))


def istft_chunk(
    state: IstftState,
    s: torch.Tensor,
    *,
    nfft: int = 1024,
    hop: int = 512,
    window: str = "sqrt_hann",
    method: str = "auto",
) -> tuple[IstftState, torch.Tensor]:
    """One chunk of WOLA synthesis: (channels, f, nfft//2+1) frames ->
    (channels, f*hop) fully-summed output samples.

    Concatenated chunk outputs + a final :func:`istft_flush` equal the
    one-shot :func:`ops.fft.istft` of the concatenated frames. With
    ``window='sqrt_hann'``, ``hop = nfft//2`` frames from
    :func:`stft_chunk`, the round trip reconstructs the input delayed by
    nfft - hop samples (the WOLA pipeline latency).
    """
    from .fft import _overlap_add, _check_fft_method, _window_on

    _hop_divides(nfft, hop, "istft")
    _check_fft_method(method)
    squeeze = s.dim() == 2
    sp = s[None] if squeeze else s
    f = sp.shape[1]
    if f < 1:
        raise ValueError("need at least one frame per chunk")
    if state.tail.shape[-1] != nfft - hop:
        raise ValueError(f"state holds {state.tail.shape[-1]} samples a channel, need {nfft - hop}")
    frames = torch.fft.irfft(sp, n=nfft, dim=-1) * _window_on(window, nfft, str(sp.device))
    flat = _overlap_add(frames, hop)
    flat[:, : nfft - hop] += state.tail
    out = flat[:, : f * hop]
    return IstftState(tail=flat[:, f * hop :].clone()), (out[0] if squeeze else out)


def istft_flush(state: IstftState) -> torch.Tensor:
    """The final nfft-hop OLA tail after the last chunk."""
    return state.tail


__all__ = [
    "StftState",
    "stft_init",
    "stft_chunk",
    "stft_state_from_jax",
    "IstftState",
    "istft_init",
    "istft_chunk",
    "istft_flush",
    "istft_state_from_jax",
    "FirState",
    "fir_init",
    "fir_chunk",
    "fir_state_from_jax",
    "MovingAverageState",
    "moving_average_init",
    "moving_average_chunk",
    "state_from_jax",
]
