"""Wrappers of the averager's CUDA kernels (``csrc/``), with their geometry.

Counterpart of ``digital_signal_processsing_tpu/ops/pallas_scan.py``:

- :func:`windowed_averager`        B1, ``csrc/windowed.cu``
- :func:`windowed_averager_packed` B2, ``csrc/windowed.cu`` on int32 pair words
- :func:`cumsum`                   B4, ``csrc/cumsum.cu`` (three launches)
- :func:`moving_average_two_pass`  B4, then the difference in plain PyTorch

Each wrapper takes its plain version (``scan_xla.py``) for a tensor on the
CPU. For a CUDA tensor it builds the kernels if needed (``_build.py``),
launches, and adds one to its ``launches`` count; it raises if the build or
the launch fails, and never falls back to the plain version.

The tile geometry (frames per block, segments of the in-block scan, shared
memory) is computed here, in Python, so the CPU tests reach it.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import _build
from ..utils.layout import cdiv, validate_window
from .scan_xla import cumsum_ref, moving_average_ref, windowed_difference

# Output samples a block owns (rounded up to whole frames).
TILE_SAMPLES = 8192
THREADS = 256  # dsp::kThreads in csrc/block_prefix.cuh
# Bound on the in-block scan's work items (segments x channels).
SEG_ITEMS = 4096
# Dynamic shared memory one block may use on the H100 (227 KB).
SMEM_MAX = 232448
# Shared memory of one H100 SM (228 KB); each resident block also holds 1 KB.
SMEM_PER_SM = 233472
# The windowed kernels' buffer (halo k*C plus tile, 4 bytes a sample) grows
# with the halo. Measured at 64M samples, C=2 and C=16 (PERF.md), they beat
# the two-pass route while two blocks fit on an SM and lose from the first
# window at which only one does, so that is where `windowed` switches route.
WINDOWED_SMEM_MAX = SMEM_PER_SM // 2 - 1024


@dataclasses.dataclass(frozen=True)
class TileGeometry:
    """Launch geometry shared by the kernels of ``csrc/``.

    A block loads ``lead_frames`` of halo and ``tile_frames`` of tile into
    shared memory as uint32, and scans it per channel in ``segs`` segments
    of ``seg_frames`` frames; a scratch of ``segs * channels`` words holds
    the segment sums.
    """

    channels: int
    lead_frames: int
    tile_frames: int
    seg_frames: int
    segs: int

    @property
    def tile_samples(self) -> int:
        return self.tile_frames * self.channels

    @property
    def smem_bytes(self) -> int:
        frames = self.lead_frames + self.tile_frames
        return 4 * (frames + self.segs) * self.channels

    def blocks(self, n: int) -> int:
        return cdiv(n, self.tile_samples)


def tile_geometry(lead_frames: int, channels: int, *, even: bool = False) -> TileGeometry:
    """Geometry for a tile of about TILE_SAMPLES with ``lead_frames`` of halo.

    ``even`` keeps the tile an even number of samples (B2 moves pairs).
    The segment length is odd so that one warp's segment starts fall on
    distinct shared-memory banks.
    """
    tf = cdiv(TILE_SAMPLES, channels)
    if even and (tf * channels) % 2:
        tf += 1
    nf = lead_frames + tf
    target = max(1, min(THREADS, SEG_ITEMS // channels))
    r = cdiv(nf, target) | 1
    return TileGeometry(channels, lead_frames, tf, r, cdiv(nf, r))


def windowed_geometry(window: int, channels: int) -> TileGeometry:
    return tile_geometry(window, channels)


def packed_geometry(window: int, channels: int) -> TileGeometry:
    # B2 reads whole words, so the halo is rounded up to an even sample count
    # by loading one frame more when k*C is odd; that frame is outside every
    # window and only pads the buffer.
    lead = window if (window * channels) % 2 == 0 else window + 1
    return tile_geometry(lead, channels, even=True)


def cumsum_geometry(channels: int) -> TileGeometry:
    return tile_geometry(0, channels)


def windowed_supported(window: int, channels: int) -> bool:
    """True iff B1 takes this configuration: any C, while two blocks fit on an SM."""
    return (
        channels >= 1
        and 1 <= window
        and windowed_geometry(window, channels).smem_bytes <= WINDOWED_SMEM_MAX
    )


def packed_supported(window: int, channels: int) -> bool:
    """True iff B2 takes this configuration (as B1, with its even buffer)."""
    return (
        channels >= 1
        and 1 <= window
        and packed_geometry(window, channels).smem_bytes <= WINDOWED_SMEM_MAX
    )


def cumsum_supported(channels: int) -> bool:
    """True iff B4 takes this channel count (one tile must fit in shared memory)."""
    return channels >= 1 and cumsum_geometry(channels).smem_bytes <= SMEM_MAX


def _on_cuda(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"tensors must be on 'cuda' or 'cpu', got {x.device}")


def _check_stream(x, dtype: torch.dtype, channels: int, name: str, samples: int) -> None:
    """Checks the kernels rely on: a dense 1-D tensor of whole frames.

    The kernels load single elements (2 or 4 bytes), so any element-aligned
    view, a streaming tail included, is aligned enough.
    """
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(x).__name__}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if x.dim() != 1:
        raise ValueError(f"{name} must be a flat interleaved stream, got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if channels < 1:
        raise ValueError(f"channels must be >= 1, got {channels}")
    if samples % channels != 0:
        raise ValueError(f"stream length {samples} not a multiple of channels {channels}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def windowed_averager(
    x: torch.Tensor,
    window: int,
    channels: int = 1,
    *,
    seed: torch.Tensor | None = None,
) -> torch.Tensor:
    """Causal moving average of an interleaved int16 stream (B1).

    ``seed``: the ``window * channels`` int16 samples that precede ``x`` in
    the stream (the streaming state's tail); without it the positions
    before the start read zero, the golden model's ramp-up. Needs
    ``windowed_supported(window, channels)``.
    """
    validate_window(window)
    _check_stream(x, torch.int16, channels, "x", x.numel())
    halo = window * channels
    if not windowed_supported(window, channels):
        raise ValueError(
            f"windowed kernel takes halos whose buffer leaves two blocks an SM, "
            f"got window*channels = {halo}; use moving_average_two_pass"
        )
    if seed is not None:
        _check_stream(seed, torch.int16, channels, "seed", seed.numel())
        if seed.numel() != halo or seed.device != x.device:
            raise ValueError(
                f"seed must hold the {halo} samples before x, on {x.device}; "
                f"got {seed.numel()} on {seed.device}"
            )
    if not _on_cuda(x):
        if seed is None:
            return moving_average_ref(x, window, channels)
        return moving_average_ref(torch.cat([seed, x]), window, channels)[halo:]
    return launch_windowed(x, window, channels, seed)


def launch_windowed(
    x: torch.Tensor, window: int, channels: int, seed: torch.Tensor | None = None
) -> torch.Tensor:
    """Launch B1 on a CUDA stream the caller has checked, at any halo that fits.

    :func:`windowed_averager` holds the buffer to WINDOWED_SMEM_MAX;
    ``chip_smoke.py`` also launches beyond it, to time B1 against the
    two-pass route on both sides of the bound. Raises if the buffer exceeds
    shared memory.
    """
    g = windowed_geometry(window, channels)
    if g.smem_bytes > SMEM_MAX:
        raise ValueError(f"windowed kernel needs {g.smem_bytes} bytes of shared memory")
    n = x.numel()
    y = torch.empty_like(x)
    if n == 0:
        return y
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.dsp_windowed_i16(
            x.data_ptr(), y.data_ptr(), None if seed is None else seed.data_ptr(),
            n, window, channels, g.lead_frames, g.tile_frames, g.seg_frames,
            g.segs, g.smem_bytes, _stream(x),
        )
    _build.check(err, "windowed_averager")
    windowed_averager.launches += 1
    return y


windowed_averager.launches = 0


def windowed_averager_packed(x32: torch.Tensor, window: int, channels: int = 2) -> torch.Tensor:
    """B1's function on the int32 little-endian pair view of the stream (B2).

    ``x32`` is ``x.view(torch.int32)`` of the int16 stream; the result is the
    same view of the int16 output, bit-exact with :func:`windowed_averager`
    on ``x32.view(torch.int16)``. Any channel count, odd included.
    """
    validate_window(window)
    _check_stream(x32, torch.int32, channels, "x32", 2 * x32.numel())
    if not packed_supported(window, channels):
        raise ValueError(
            f"packed kernel takes halos whose buffer leaves two blocks an SM, got "
            f"window*channels = {window * channels}; use moving_average_two_pass "
            "on the int16 view"
        )
    if not _on_cuda(x32):
        return moving_average_ref(x32.view(torch.int16), window, channels).view(torch.int32)
    n32 = x32.numel()
    y = torch.empty_like(x32)
    if n32 == 0:
        return y
    g = packed_geometry(window, channels)
    lib = _build.library()
    with torch.cuda.device(x32.device):
        err = lib.dsp_windowed_packed(
            x32.data_ptr(), y.data_ptr(), n32, window, channels, g.lead_frames,
            g.tile_frames, g.seg_frames, g.segs, g.smem_bytes, _stream(x32),
        )
    _build.check(err, "windowed_averager_packed")
    windowed_averager_packed.launches += 1
    return y


windowed_averager_packed.launches = 0


def cumsum(x: torch.Tensor, channels: int = 1) -> torch.Tensor:
    """Per-channel int32 modular inclusive prefix sum of an interleaved stream (B4)."""
    _check_stream(x, torch.int16, channels, "x", x.numel())
    if not cumsum_supported(channels):
        raise ValueError(f"cumsum kernel takes at most a tile's worth of channels, got {channels}")
    if not _on_cuda(x):
        return cumsum_ref(x, channels)
    n = x.numel()
    y = torch.empty(n, dtype=torch.int32, device=x.device)
    if n == 0:
        return y
    g = cumsum_geometry(channels)
    totals = torch.empty(g.blocks(n) * channels, dtype=torch.int32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.dsp_cumsum_i16(
            x.data_ptr(), y.data_ptr(), totals.data_ptr(), n, channels,
            g.tile_frames, g.seg_frames, g.segs, g.smem_bytes, _stream(x),
        )
    _build.check(err, "cumsum")
    cumsum.launches += 1
    return y


cumsum.launches = 0


def moving_average_two_pass(x: torch.Tensor, window: int, channels: int = 1) -> torch.Tensor:
    """Averager for halos beyond the windowed kernels: B4, then the difference.

    Pass 1 is the cumsum kernel (int32 modular); pass 2 the windowed
    difference and truncating division in plain PyTorch, as the reference
    package does it in XLA. Costs one int32 round trip through device memory
    more than the windowed kernel, but no work that grows with the window.
    """
    validate_window(window)
    return windowed_difference(cumsum(x, channels), window, channels)


KERNEL_WRAPPERS = (windowed_averager, windowed_averager_packed, cumsum)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


__all__ = [
    "TILE_SAMPLES",
    "WINDOWED_SMEM_MAX",
    "TileGeometry",
    "tile_geometry",
    "windowed_geometry",
    "packed_geometry",
    "cumsum_geometry",
    "windowed_supported",
    "packed_supported",
    "cumsum_supported",
    "windowed_averager",
    "launch_windowed",
    "windowed_averager_packed",
    "cumsum",
    "moving_average_two_pass",
    "KERNEL_WRAPPERS",
    "reset_launch_counts",
]
