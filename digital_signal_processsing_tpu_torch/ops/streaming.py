"""Stateful streaming moving average: chunk by chunk, bit-exact with one shot.

Counterpart of the moving-average part of
``digital_signal_processsing_tpu/ops/streaming.py``. The state is the raw
halo, the last ``window * channels`` samples seen (zeros at stream start,
the zeroed prefix of gpu_utils.h:112-114 carried through time). On every
chunk length the windowed kernel (B1) runs with that halo as its seed;
halos too large for it take the two-pass path over tail + chunk.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.layout import validate_window
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


__all__ = [
    "MovingAverageState",
    "moving_average_init",
    "moving_average_chunk",
    "state_from_jax",
]
