"""Shape arithmetic shared by the wrappers and the kernels' launch geometry."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .numerics import MAX_EXACT_WINDOW


def round_up(x: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``x``."""
    return ((x + m - 1) // m) * m


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def interleaved_frames(num_samples: int, channels: int) -> int:
    """Number of complete interleaved frames in a flat stream."""
    if channels <= 0:
        raise ValueError(f"channels must be positive, got {channels}")
    if num_samples % channels != 0:
        raise ValueError(
            f"stream length {num_samples} is not a multiple of channels {channels}"
        )
    return num_samples // channels


def validate_window(window: int, max_window: int | None = None) -> None:
    bound = MAX_EXACT_WINDOW if max_window is None else max_window
    if not (1 <= window <= bound):
        raise ValueError(
            f"window must be in [1, {bound}] for exact int32 modular scans, "
            f"got {window}"
        )


def overlapping_frames(x: torch.Tensor, num_frames: int, hop: int, frame_len: int) -> torch.Tensor:
    """Overlapping frames of the last axis: frame i = x[..., i*hop : i*hop + frame_len].

    The reference's padding contract: a last axis shorter than
    ``(num_frames + ceil(frame_len / hop) - 1) * hop`` is zero-padded to
    that length first. The frames are ``Tensor.unfold`` of the (padded)
    input, a view with no copy when no padding is needed.
    """
    need = (num_frames + cdiv(frame_len, hop) - 1) * hop
    if x.shape[-1] < need:
        x = F.pad(x, (0, need - x.shape[-1]))
    return x.unfold(-1, frame_len, hop)[..., :num_frames, :]


def as_numpy_int16(x) -> np.ndarray:
    """``x`` as a host int16 array (a tensor is copied off its device); raises on
    any other dtype."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.asarray(x)
    if x.dtype != np.int16:
        raise TypeError(f"expected int16 samples, got {x.dtype}")
    return x


__all__ = [
    "round_up", "cdiv", "interleaved_frames", "validate_window", "overlapping_frames",
    "as_numpy_int16",
]
