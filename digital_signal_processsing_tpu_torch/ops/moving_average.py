"""Public moving-average API: one function, its routes behind ``method``.

Counterpart of ``digital_signal_processsing_tpu/ops/moving_average.py``,
with the same methods and the same ``record_choice`` names:

- ``auto``         the windowed kernel (B1) while the halo k*C fits it, else
                   the two-pass path (B4 and a plain difference)
- ``windowed``     the same routes, named
- ``scan``         the carried scan averager (B3), Blelloch in-tile scan
- ``scan_hillis``  the same, Hillis-Steele stride-doubling in-tile scan
- ``scan_mxu``     the same, in-tile scan on the tensor cores (C | 16)
- ``direct``       k shifted adds (B5), window <= 256
- ``xla_scan``     the plain PyTorch cumsum anchor (no kernel)
- ``xla_direct``   the plain PyTorch shifted-add anchor (no kernel)
- ``golden``       the NumPy oracle (host; for tests and debugging)

The ``scan*`` methods take B3 while its buffers fit (``scan_supported``)
and the two-pass route beyond, recorded as ``"<method>:two_pass_fallback"``.
Every route is bit-exact against the golden model for window <= 65535.
"""

from __future__ import annotations

import functools

import torch

from ..golden import moving_average_golden
from ..utils.dispatch import record_choice
from ..utils.layout import validate_window
from ..utils.numerics import MAX_EXACT_WINDOW  # noqa: F401 (public re-export)
from .direct_xla import moving_average_reduce_window
from .pallas_direct import MAX_DIRECT_WINDOW, direct_averager
from .pallas_scan import (
    moving_average_two_pass,
    packed_supported,
    scan_averager,
    scan_supported,
    windowed_averager,
    windowed_averager_packed,
    windowed_supported,
)
from .scan_xla import moving_average_xla

METHODS = (
    "auto",
    "windowed",
    "scan",
    "scan_hillis",
    "scan_mxu",
    "direct",
    "xla_scan",
    "xla_direct",
    "golden",
)
SCAN_METHOD_VARIANTS = {"scan": "blelloch", "scan_hillis": "hillis_steele", "scan_mxu": "mxu"}
# methods whose kernel takes a tile size: the sweep's tile axis and the CLI's block size
TILED_METHODS = ("windowed", "scan", "scan_hillis", "scan_mxu", "direct")
LANES = 128  # samples in a row of the reference package's tile


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
    if method in SCAN_METHOD_VARIANTS:
        variant = SCAN_METHOD_VARIANTS[method]
        if not scan_supported(window, channels, variant):  # raises for a C mxu refuses
            # bit-exact, but a different cost class: keep it observable
            record_choice("moving_average", f"{method}:two_pass_fallback")
            return moving_average_two_pass(x, window, channels)
        record_choice("moving_average", method)
        return scan_averager(x, window, channels, variant=variant)
    if method == "direct":
        if window > MAX_DIRECT_WINDOW:
            raise ValueError(
                f"direct method supports window <= {MAX_DIRECT_WINDOW}; "
                f"use method='scan' for window={window}"
            )
        record_choice("moving_average", "direct")
        return direct_averager(x, window, channels)
    if method == "xla_scan":
        record_choice("moving_average", "xla_scan")
        return moving_average_xla(x, window, channels)
    if method == "xla_direct":
        record_choice("moving_average", "xla_direct")
        return moving_average_reduce_window(x, window, channels)
    if windowed_supported(window, channels):
        record_choice("moving_average", "windowed")
        return windowed_averager(x, window, channels)
    # bit-exact, but a different cost class: keep it observable
    record_choice("moving_average", "windowed:two_pass_fallback")
    return moving_average_two_pass(x, window, channels)


def kernel_fn(method: str, window: int, channels: int, tile_rows: int | None = None):
    """x -> y for a ``moving_average`` method; a tiled method's kernel wrapper itself.

    A tiled method (TILED_METHODS) calls its kernel's wrapper directly, with
    a tile of ``tile_rows * 128`` samples when ``tile_rows`` is given, as
    the reference package's sweep and CLI call its Pallas entry points.
    """
    kw = {"window": window, "channels": channels}
    if method not in TILED_METHODS:
        return functools.partial(moving_average, method=method, **kw)
    if tile_rows:
        kw["tile_samples"] = tile_rows * LANES
    if method == "windowed":
        return functools.partial(windowed_averager, **kw)
    if method == "direct":
        return functools.partial(direct_averager, **kw)
    return functools.partial(scan_averager, variant=SCAN_METHOD_VARIANTS[method], **kw)


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


__all__ = [
    "moving_average",
    "kernel_fn",
    "METHODS",
    "SCAN_METHOD_VARIANTS",
    "TILED_METHODS",
    "MAX_EXACT_WINDOW",
]
