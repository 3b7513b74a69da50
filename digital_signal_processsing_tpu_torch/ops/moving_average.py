"""Public moving-average API: one function, its routes behind ``method``.

Counterpart of ``digital_signal_processsing_tpu/ops/moving_average.py``.

Methods:
- ``auto``      the windowed kernel (B1) while the halo k*C fits it, else
                the two-pass path (B4 and a plain difference)
- ``windowed``  the same routes, named
- ``golden``    the NumPy oracle (host; for tests and debugging)

The reference package's other methods (``scan``, ``scan_hillis``,
``scan_mxu``, ``direct``, ``xla_scan``, ``xla_direct``) are not ported yet
and raise. Every route is bit-exact against the golden model for
window <= 65535, on any channel count.
"""

from __future__ import annotations

import torch

from ..golden import moving_average_golden
from ..utils.dispatch import record_choice
from ..utils.layout import validate_window
from ..utils.numerics import MAX_EXACT_WINDOW  # noqa: F401 (public re-export)
from .pallas_scan import (
    moving_average_two_pass,
    packed_supported,
    windowed_averager,
    windowed_averager_packed,
    windowed_supported,
)

METHODS = ("auto", "windowed", "golden")
_NOT_PORTED = ("scan", "scan_hillis", "scan_mxu", "direct", "xla_scan", "xla_direct")


def moving_average(
    x: torch.Tensor,
    window: int,
    channels: int = 1,
    *,
    method: str = "auto",
) -> torch.Tensor:
    """Causal multi-channel moving average of a flat interleaved int16 stream.

    out[f, c] = trunc(sum(x[max(f-window+1,0)..f, c]) / window), frames
    interleaved as in the source stream, bit-exact with the reference CPU
    model (profilable_moving_averager.cpp:14-37). Runs on ``x``'s device.

    **Packed transport**: an int32 ``x`` is the little-endian pair view of
    the int16 stream (``x16.view(torch.int32)``, as io.dataset's
    ``packed=True`` loader emits it) and the packed view of the output is
    returned.
    """
    if channels < 1:
        raise ValueError(f"channels must be >= 1, got {channels}")
    if method in _NOT_PORTED:
        raise ValueError(
            f"method {method!r} is not ported to PyTorch yet (ROADMAP.md queue 1 "
            f"item 2; kernels B3 and B5 in queue 2); use one of {METHODS}"
        )
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; options {METHODS}")
    validate_window(window)
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"x must be a torch.Tensor, got {type(x).__name__}")
    if x.dtype == torch.int32:
        return _moving_average_packed(x, window, channels, method=method)
    if x.dtype != torch.int16:
        raise TypeError(f"expected int16 samples (or their int32 pair view), got {x.dtype}")
    if x.numel() % channels != 0:
        raise ValueError(
            f"stream length {x.numel()} not a multiple of channels {channels}"
        )
    if method == "golden":
        record_choice("moving_average", "golden")
        want = moving_average_golden(x.cpu().numpy(), window, channels)
        return torch.from_numpy(want).to(x.device)
    if windowed_supported(window, channels):
        record_choice("moving_average", "windowed")
        return windowed_averager(x, window, channels)
    # bit-exact, but a different cost class: keep it observable
    record_choice("moving_average", "windowed:two_pass_fallback")
    return moving_average_two_pass(x, window, channels)


def _moving_average_packed(x32: torch.Tensor, window: int, channels: int, *, method: str):
    """Dispatch for int32 pair-view input (see moving_average)."""
    if method not in ("auto", "windowed"):
        raise ValueError(
            f"packed (int32 pair-view) input supports method='auto'/'windowed', "
            f"got {method!r}"
        )
    n32 = x32.numel()
    if (2 * n32) % channels != 0:
        raise ValueError(
            f"packed stream of {n32} pairs not a multiple of channels {channels}"
        )
    if packed_supported(window, channels):
        record_choice("moving_average", "windowed_packed")
        return windowed_averager_packed(x32, window, channels)
    record_choice("moving_average", "windowed:two_pass_fallback")
    x16 = x32.view(torch.int16)
    return moving_average_two_pass(x16, window, channels).view(torch.int32)


__all__ = ["moving_average", "METHODS", "MAX_EXACT_WINDOW"]
