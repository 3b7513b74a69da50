"""Time-sharded moving average and cumsum: the carry tree and the halo over ranks.

Counterpart of ``digital_signal_processsing_tpu/parallel/sharded_scan.py``.
Each rank holds a contiguous time block of the interleaved stream (whole
frames, the same length on every rank) and returns its block of the output.

``method='windowed'`` (default): the windowed kernel (B1) needs no global
cumsum, only the ``window * channels`` raw samples before its shard, so the
one exchange is a right shift of each shard's trailing samples (rank 0
receives zeros: the causal zero halo). ``halo_impl`` picks how they move:
``ppermute`` (``dist.batch_isend_irecv``), ``pallas_ring`` (the ring put
kernel, B6) or ``fused_ring`` (B7: the put overlapped with the interior
blocks). Outside B1's envelope (``windowed_supported``) the method becomes
``scan``, as in the reference.

``method='scan'``: the reference's carry decomposition.

1. each rank takes the per-channel int32 modular cumsum of its block (B4,
   or the plain version with ``use_pallas=False``);
2. the per-channel block totals combine into each rank's exclusive prefix:
   ``carry_impl='ladder'``, ceil(log2 D) strided shifts (the reference's
   recursive carry tree lifted onto the ranks), or ``'allgather'``;
3. the cumsum's trailing ``window * channels`` values go one rank right
   (``ppermute``, or B6 with ``pallas_ring``), and the window sum is the
   difference of prefixes, exact mod 2^32 for k <= 65535.

An int32 shard is the packed little-endian pair view of the int16 stream:
the windowed route then exchanges pair words and runs B2 seeded.
"""

from __future__ import annotations

import torch

from ..ops.pallas_scan import (
    cumsum,
    packed_seed_words,
    packed_supported,
    windowed_averager,
    windowed_averager_packed,
    windowed_supported,
)
from ..ops.scan_xla import cumsum_ref, windowed_difference
from ..utils.dispatch import record_choice
from ..utils.layout import validate_window
from ..utils.numerics import MAX_EXACT_WINDOW, wrap_int32
from .mesh import TIME_AXIS, Mesh, all_gather, shift_right
from .ring_pallas import fused_ring_windowed_shard, ring_shift_right_shard

HALO_IMPLS = ("ppermute", "pallas_ring", "fused_ring")
CARRY_IMPLS = ("ladder", "allgather")


def _local_cumsum(xs: torch.Tensor, channels: int, use_pallas: bool) -> torch.Tensor:
    return cumsum(xs, channels) if use_pallas else cumsum_ref(xs, channels)


def _check_carry_impl(impl: str) -> None:
    if impl not in CARRY_IMPLS:
        raise ValueError(f"unknown carry_impl {impl!r}; options {CARRY_IMPLS}")


def _carry_exclusive(totals: torch.Tensor, mesh: Mesh, impl: str = "ladder") -> torch.Tensor:
    """Exclusive per-channel prefix of the ranks' block totals, int32 modular.

    ``ladder``: shifts by strides 1, 2, 4, ... each add the partial sums of
    the rank that far left (missing sources deliver zeros), giving the
    inclusive prefix in ceil(log2 D) dependent steps; less the rank's own
    total, the exclusive one. ``allgather``: one round, then the sum of the
    ranks before this one.
    """
    _check_carry_impl(impl)
    if impl == "allgather":
        gathered = all_gather(totals, mesh, TIME_AXIS)
        acc = torch.zeros_like(totals, dtype=torch.int64)
        for part in gathered[: mesh.t]:
            acc += part.to(torch.int64)
        return wrap_int32(acc)
    acc = totals
    shift = 1
    while shift < mesh.n_time:
        recv = shift_right(acc, mesh, TIME_AXIS, stride=shift)
        acc = wrap_int32(acc.to(torch.int64) + recv.to(torch.int64))
        shift *= 2
    return wrap_int32(acc.to(torch.int64) - totals.to(torch.int64))


def _carried_cumsum(xs: torch.Tensor, channels: int, mesh: Mesh, use_pallas: bool,
                    carry_impl: str) -> torch.Tensor:
    """This shard's block of the global per-channel int32 modular cumsum."""
    cum = _local_cumsum(xs, channels, use_pallas)
    carry = _carry_exclusive(cum[cum.numel() - channels :], mesh, carry_impl)
    return wrap_int32(cum.view(-1, channels).to(torch.int64) + carry.to(torch.int64)).view(-1)


def _halo(tail: torch.Tensor, mesh: Mesh, halo_impl: str) -> torch.Tensor:
    """The left neighbour's ``tail`` (zeros on rank 0)."""
    if halo_impl == "pallas_ring":
        return ring_shift_right_shard(tail, mesh)
    return shift_right(tail, mesh)


def _shard_body(xs: torch.Tensor, *, window: int, channels: int, mesh: Mesh, use_pallas: bool,
                halo_impl: str, carry_impl: str) -> torch.Tensor:
    halo = window * channels
    cum = _carried_cumsum(xs, channels, mesh, use_pallas, carry_impl)
    left = _halo(cum[cum.numel() - halo :], mesh, halo_impl)
    return windowed_difference(torch.cat([left, cum]), window, channels)[halo:]


def _shard_body_windowed(xs: torch.Tensor, *, window: int, channels: int, mesh: Mesh,
                         halo_impl: str) -> torch.Tensor:
    halo = window * channels
    left = _halo(xs[xs.numel() - halo :], mesh, halo_impl)
    return windowed_averager(xs, window, channels, seed=left)


def sharded_moving_average(
    x: torch.Tensor,
    window: int,
    channels: int = 1,
    *,
    mesh: Mesh,
    use_pallas: bool = True,
    halo_impl: str = "ppermute",
    method: str = "windowed",
    carry_impl: str = "ladder",
) -> torch.Tensor:
    """Causal moving average of this rank's time block of an interleaved stream.

    ``x``: this rank's shard (int16, or the int32 pair view), whole frames,
    the same length on every rank of the time axis, and at least one halo
    (``window * channels`` samples) long. Bit-exact against the golden
    model for window <= 65535. ``use_pallas=False`` takes the plain
    ``scan`` decomposition (no kernel).
    """
    validate_window(window, MAX_EXACT_WINDOW)
    if halo_impl not in HALO_IMPLS:
        raise ValueError(f"unknown halo_impl {halo_impl!r}; options {HALO_IMPLS}")
    if not isinstance(x, torch.Tensor) or x.dim() != 1:
        raise ValueError("x must be this rank's 1-D shard of the interleaved stream")
    ndev = mesh.n_time
    if x.dtype == torch.int32:
        return _sharded_moving_average_packed(x, window, channels, mesh=mesh, method=method,
                                              halo_impl=halo_impl)
    if x.dtype != torch.int16:
        raise TypeError(f"x must be int16 (or its int32 pair view), got {x.dtype}")
    n_loc = x.numel()
    if channels < 1 or n_loc % channels:
        raise ValueError(
            f"stream length {n_loc * ndev} must divide into {ndev} shards of whole "
            f"frames of {channels} channels"
        )
    if window * channels > n_loc:
        raise ValueError(
            f"window*channels = {window * channels} exceeds one shard ({n_loc}); "
            "halo exchange is single-hop"
        )
    if method == "windowed" and not use_pallas:
        method = "scan"  # the explicit opt-out of the kernels
    if method == "windowed":
        if windowed_supported(window, channels):
            if halo_impl == "fused_ring":
                record_choice("sharded_moving_average", "fused_ring")
                return fused_ring_windowed_shard(x, window, channels, mesh)
            record_choice("sharded_moving_average", "windowed")
            return _shard_body_windowed(x, window=window, channels=channels, mesh=mesh,
                                        halo_impl=halo_impl)
        method = "scan"  # outside the windowed kernel's envelope
    if method != "scan":
        raise ValueError(f"unknown method {method!r}; options: windowed, scan")
    _check_carry_impl(carry_impl)
    record_choice("sharded_moving_average", "scan")
    return _shard_body(x, window=window, channels=channels, mesh=mesh, use_pallas=use_pallas,
                       halo_impl=halo_impl, carry_impl=carry_impl)


def _sharded_moving_average_packed(x32: torch.Tensor, window: int, channels: int, *,
                                   mesh: Mesh, method: str, halo_impl: str) -> torch.Tensor:
    """Packed pair-view route (windowed only): pair-word halos into B2.

    The halo moves by B6 with ``halo_impl='pallas_ring'``, else by
    ``ppermute`` (B7 takes int16 shards).
    """
    if method != "windowed":
        raise ValueError(
            f"packed (int32 pair-view) input supports method='windowed', got {method!r}"
        )
    ndev = mesh.n_time
    n_loc = x32.numel()
    if channels < 1 or (2 * n_loc) % channels:
        raise ValueError(
            f"packed stream of {n_loc * ndev} pairs must divide into {ndev} shards "
            f"of whole frames of {channels} channels"
        )
    if not packed_supported(window, channels) or n_loc < packed_seed_words(window, channels):
        raise ValueError(
            f"packed sharded path needs packed_supported(window={window}, "
            f"channels={channels}) and a single-hop halo (shard {n_loc} pairs >= halo "
            f"{packed_seed_words(window, channels)}); unpack and use the int16 path instead"
        )
    words = packed_seed_words(window, channels)
    left = _halo(x32[n_loc - words :], mesh, halo_impl)
    record_choice("sharded_moving_average", "windowed_packed")
    return windowed_averager_packed(x32, window, channels, seed=left)


def sharded_cumsum(
    x: torch.Tensor,
    channels: int = 1,
    *,
    mesh: Mesh,
    use_pallas: bool = True,
    carry_impl: str = "ladder",
) -> torch.Tensor:
    """This rank's block of the per-channel int32 modular cumsum of the stream."""
    _check_carry_impl(carry_impl)
    if x.dim() != 1 or channels < 1 or x.numel() % channels:
        raise ValueError(f"shard of shape {tuple(x.shape)} is not whole frames of {channels} channels")
    return _carried_cumsum(x, channels, mesh, use_pallas, carry_impl)


__all__ = ["HALO_IMPLS", "CARRY_IMPLS", "sharded_moving_average", "sharded_cumsum"]
