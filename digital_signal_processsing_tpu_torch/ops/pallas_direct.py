"""Wrapper of the direct averager's CUDA kernel (B5, ``csrc/direct.cu``).

Counterpart of ``digital_signal_processsing_tpu/ops/pallas_direct.py``: the
window sum as ``k`` shifted adds, the reference's O(N*k) shared-memory
tiled averager (profilable_sm_averager.cu:14-45). Its work grows with the
window, so it takes windows up to MAX_DIRECT_WINDOW only.

For a tensor on the CPU the wrapper takes its plain version,
``direct_xla.moving_average_reduce_window``; for a CUDA tensor it launches
the kernel, adds one to ``direct_averager.launches``, and raises if the
build or the launch fails.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from .. import _build
from ..utils.layout import cdiv, validate_window
from .direct_xla import moving_average_reduce_window
from .pallas_scan import SMEM_MAX, TILE_SAMPLES, _check_stream, _on_cuda, _stream

# Beyond this window the O(k) direct kernel loses to the scans; the
# reference package guards its API at the same bound.
MAX_DIRECT_WINDOW = 256
# csrc/direct.cu: the consecutive frames of one channel a thread sums (its
# run), and a run's int32 words in a channel's plane, padded by two so that a
# warp's runs fall on distinct banks.
RUN = 16
RUN_WORDS = RUN + 2


@dataclasses.dataclass(frozen=True)
class DirectGeometry:
    """Launch geometry of B5: a tile of ``tile_frames`` frames (whole runs),
    staged with the ``window - 1`` frames before it and RUN after it, a plane
    a channel of int32 padded by two words a run; then the interleaved int16
    results padded by one word a run; then the raw interleaved stream of the
    next tile, 16-byte chunks from the aligned sample below its halo."""

    window: int
    channels: int
    tile_frames: int

    @property
    def tile_samples(self) -> int:
        return self.tile_frames * self.channels

    @property
    def runs(self) -> int:
        return self.tile_frames // RUN

    @property
    def plane_words(self) -> int:
        return cdiv(self.window - 1 + self.tile_frames + RUN, RUN) * RUN_WORDS

    @property
    def in_words(self) -> int:
        return 4 * cdiv(self.channels * self.plane_words, 4)

    @property
    def out_words(self) -> int:
        return 4 * cdiv(self.tile_samples // 2 + self.runs, 4)

    @property
    def raw_words(self) -> int:
        return 4 * (cdiv((self.window - 1 + self.tile_frames + RUN) * self.channels, 8) + 1)

    @property
    def smem_bytes(self) -> int:
        return 4 * (self.in_words + self.out_words + self.raw_words)

    def blocks(self, n: int) -> int:
        return cdiv(n, self.tile_samples)


def direct_geometry(window: int, channels: int, tile_samples: int | None = None) -> DirectGeometry:
    tf = cdiv(TILE_SAMPLES if tile_samples is None else tile_samples, channels)
    return DirectGeometry(window, channels, RUN * cdiv(tf, RUN))


def direct_supported(window: int, channels: int, tile_samples: int | None = None) -> bool:
    """True iff B5 takes this configuration: k <= 256 and its tile fits shared memory."""
    return (
        channels >= 1
        and 1 <= window <= MAX_DIRECT_WINDOW
        and direct_geometry(window, channels, tile_samples).smem_bytes <= SMEM_MAX
    )


def direct_averager(
    x: torch.Tensor, window: int, channels: int = 1, *, tile_samples: int | None = None
) -> torch.Tensor:
    """Causal moving average of an interleaved int16 stream by k shifted adds (B5).

    Bit-exact with the golden model; ``window <= MAX_DIRECT_WINDOW``.
    """
    validate_window(window, MAX_DIRECT_WINDOW)
    _check_stream(x, torch.int16, channels, "x", x.numel())
    g = direct_geometry(window, channels, tile_samples)
    if not direct_supported(window, channels, tile_samples):
        raise ValueError(
            f"direct kernel needs {g.smem_bytes} bytes of shared memory for "
            f"window*channels = {window * channels}; at most {SMEM_MAX}"
        )
    if not _on_cuda(x):
        return moving_average_reduce_window(x, window, channels)
    n = x.numel()
    y = torch.empty_like(x)
    if n == 0:
        return y
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.dsp_direct_i16(
            x.data_ptr(), y.data_ptr(), n, window, channels, g.tile_frames, g.plane_words,
            g.in_words, g.smem_bytes, _stream(x),
        )
    _build.check(err, "direct_averager")
    direct_averager.launches += 1
    return y


direct_averager.launches = 0


def direct_kernel_attrs(window: int, channels: int = 2) -> tuple:
    """What the compiler gave B5's kernel for ``channels``, and its blocks an SM
    at ``window`` (the card only): (registers a thread, local bytes a thread,
    shared bytes a block, blocks an SM)."""
    g = direct_geometry(window, channels)
    lib = _build.library()
    out = (ctypes.c_int64 * 4)()
    _build.check(lib.dsp_direct_attrs(channels, g.smem_bytes, ctypes.addressof(out)),
                 "direct_kernel_attrs")
    return tuple(out)

__all__ = [
    "MAX_DIRECT_WINDOW",
    "DirectGeometry",
    "direct_geometry",
    "direct_supported",
    "direct_averager",
    "direct_kernel_attrs",
]
