"""Golden CPU models: the semantic ground truth for every averager path.

The reference defines correctness by its serial CPU sliding-sum averager
(profilable_moving_averager.cpp:14-37): int16 interleaved samples, int64
per-channel running sums, C-style truncating division by the *full* window
even during ramp-up (the first ``window`` frames divide the sum of the
samples available so far by ``window``; the GPU variants get the same
semantics from a zeroed halo prefix, gpu_utils.h:112-114).

NumPy only, so it runs wherever the port runs:

- :func:`moving_average_golden_loop`, a literal frame-by-frame sliding-sum
  loop mirroring the reference's ramp-up and steady-state phases; O(N)
  Python, for small test vectors;
- :func:`moving_average_golden`, vectorized (int64 cumsum and shifted
  difference), held equal to the loop by the tests; the oracle for every
  kernel parity check.
"""

from __future__ import annotations

import numpy as np

from ..utils.numerics import trunc_div


def _validate(samples: np.ndarray, window: int, channels: int) -> None:
    if samples.ndim != 1:
        raise ValueError(f"expected flat interleaved stream, got shape {samples.shape}")
    if channels < 1:
        raise ValueError(f"channels must be >= 1, got {channels}")
    if samples.size % channels != 0:
        raise ValueError(
            f"stream length {samples.size} not a multiple of channels {channels}"
        )
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def moving_average_golden(
    samples: np.ndarray, window: int, channels: int = 1
) -> np.ndarray:
    """Vectorized golden causal moving average over an interleaved stream.

    out[f, c] = trunc( sum(x[max(f-window+1,0)..f, c]) / window )

    int64 accumulation, division by the full ``window`` during ramp-up,
    truncation toward zero, int16 output.
    """
    samples = np.asarray(samples)
    _validate(samples, window, channels)
    frames = samples.size // channels
    x = samples.reshape(frames, channels).astype(np.int64)
    csum = np.cumsum(x, axis=0)
    wsum = csum.copy()
    if window < frames:
        wsum[window:] -= csum[:-window]
    return trunc_div(wsum, window).astype(np.int16).reshape(-1)


def moving_average_golden_loop(
    samples: np.ndarray, window: int, channels: int = 1
) -> np.ndarray:
    """Literal sliding-sum loop (ramp-up then steady state); test-sized only."""
    samples = np.asarray(samples)
    _validate(samples, window, channels)
    frames = samples.size // channels
    x = samples.reshape(frames, channels).astype(np.int64)
    out = np.zeros((frames, channels), dtype=np.int16)
    sums = [0] * channels

    def tdiv(s: int) -> int:  # C-style truncation on plain Python ints
        q = abs(s) // window
        return q if s >= 0 else -q

    # Ramp-up: running sum of the first `window` frames, divided by the FULL
    # window (profilable_moving_averager.cpp:19-25).
    for f in range(min(window, frames)):
        for c in range(channels):
            sums[c] += int(x[f, c])
            out[f, c] = np.int16(tdiv(sums[c]))
    # Steady state: slide the window (cpp:27-35).
    for f in range(window, frames):
        for c in range(channels):
            sums[c] += int(x[f, c]) - int(x[f - window, c])
            out[f, c] = np.int16(tdiv(sums[c]))
    return out.reshape(-1)


def cumsum_per_channel_golden(samples: np.ndarray, channels: int = 1) -> np.ndarray:
    """Per-channel inclusive prefix sum over an interleaved stream, int64."""
    samples = np.asarray(samples)
    _validate(samples, 1, channels)
    frames = samples.size // channels
    x = samples.reshape(frames, channels).astype(np.int64)
    return np.cumsum(x, axis=0).reshape(-1)
