"""Plain PyTorch versions of the averager kernels: the correctness anchor.

Counterpart of ``digital_signal_processsing_tpu/ops/scan_xla.py``. A causal
box filter is a windowed difference of the per-channel inclusive prefix sum
at frame stride ``window`` (hillis_steele_averager.cu:87-100):

    out[f, c] = trunc((cum[f, c] - cum[f - k, c]) / k)        (cum[<0] = 0)

Here the prefix is an int64 ``torch.cumsum`` per channel, the reference's
own widening. These functions launch no kernel of this package: the
wrappers in ``pallas_scan.py`` run them for CPU tensors, and the chip smoke
holds each CUDA kernel against them on the card. :func:`moving_average_xla`
is also the ``xla_scan`` method of ``moving_average``, as its namesake is in
the reference package.
"""

from __future__ import annotations

import torch

from ..utils.numerics import trunc_div, wrap_int32


def channel_cumsum(x: torch.Tensor, channels: int) -> torch.Tensor:
    """int64 inclusive prefix of each channel over frames, as (channels, frames).

    One 1-D cumsum per channel: on CUDA a 1-D scan is a single device-wide
    scan, while a scan along dim 0 of (frames, channels) took seconds at
    64M samples on an H100 (PERF.md).
    """
    planar = x.reshape(-1, channels).t().contiguous()
    return torch.stack([torch.cumsum(row, dim=0, dtype=torch.int64) for row in planar])


def moving_average_xla(x: torch.Tensor, window: int, channels: int = 1) -> torch.Tensor:
    """Causal moving average of a flat interleaved int16 stream (int64 sums).

    The ``xla_scan`` anchor, and the plain version of the windowed kernels
    (B1, and B2 on the int16 view) and of the scan averager (B3). Bit-exact
    with ``golden.moving_average_golden``.
    """
    csum = channel_cumsum(x, channels)
    wsum = csum.clone()
    if window < csum.shape[1]:
        wsum[:, window:] -= csum[:, :-window]
    return trunc_div(wsum, window).to(torch.int16).t().reshape(-1)


def cumsum_ref(x: torch.Tensor, channels: int = 1) -> torch.Tensor:
    """Per-channel inclusive prefix sum, int32 modular, interleaved in and out.

    The plain version of the cumsum kernel (B4): an int64 cumsum reduced
    mod 2^32, which is what int32 wraparound gives.
    """
    return wrap_int32(channel_cumsum(x, channels)).t().reshape(-1)


def cumsum_interleaved_xla(x: torch.Tensor, channels: int = 1) -> torch.Tensor:
    """Per-channel int32 modular prefix sum, interleaved in and out (the scan
    oracle, the reference's name for :func:`cumsum_ref`)."""
    return cumsum_ref(x, channels)


def windowed_difference(cum: torch.Tensor, window: int, channels: int = 1) -> torch.Tensor:
    """Second pass of the two-pass averager: ``trunc((cum[i] - cum[i-kC]) / k)``.

    ``cum`` is the int32 modular per-channel prefix. The difference is taken
    in int64 and reduced mod 2^32, where it is the true window sum for
    k <= 65535; the result is int16.
    """
    halo = window * channels
    wsum = cum.to(torch.int64)
    if halo < cum.numel():
        wsum[halo:] -= cum[:-halo]
    return trunc_div(wrap_int32(wsum), window).to(torch.int16)


__all__ = [
    "channel_cumsum", "moving_average_xla", "cumsum_ref", "cumsum_interleaved_xla",
    "windowed_difference",
]
