"""Wrappers of the averager's CUDA kernels (``csrc/``), with their geometry.

Counterpart of ``digital_signal_processsing_tpu/ops/pallas_scan.py``:

- :func:`windowed_averager`        B1, ``csrc/windowed.cu`` (B3's span kernel of
  ``csrc/run_tile.cuh`` with the Hillis-Steele scan, seeded, over any range
  of tiles)
- :func:`windowed_averager_packed` B2, ``csrc/windowed.cu``: B1's launch over the
  int16 view of the int32 pair words (the same bytes), counted as B2
- :func:`scan_averager`            B3, ``csrc/scan.cu`` (three in-tile scans, each thread's
  samples in registers, two block barriers a tile; three in the generic
  kernel for C outside 1, 2, 4, 8, 16)
- :func:`cumsum`                   B4, ``csrc/cumsum.cu`` (one launch and a memset: B3's
  tile in registers for C in 1, 2, 4, 8, 16, a tile of whole frames in shared
  memory for any other C, the carry by a decoupled look-back over tiles)
- :func:`moving_average_two_pass`  B4, then the difference in plain PyTorch

Each wrapper takes its plain version (``scan_xla.py``) for a tensor on the
CPU. For a CUDA tensor it builds the kernels if needed (``_build.py``),
launches, and adds one to its ``launches`` count (B3 keeps one count per
variant); it raises if the build or the launch fails, and never falls back
to the plain version.

The tile geometry (rings, spans, shared memory; B4's generic tiles and
segments) is computed here, in Python, so the CPU tests reach it. B1's and
B3's tile is always 8192 samples; B3's ``tile_samples`` only bounds the
window, as the reference's ``tile_rows`` does, and B1's selects nothing (the
reference's windowed kernel grows its tile to hold the halo).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from .. import _build
from ..utils.layout import cdiv, round_up, validate_window
from .scan_xla import cumsum_ref, moving_average_xla, windowed_difference

# Output samples a block owns (rounded up to whole frames).
TILE_SAMPLES = 8192
THREADS = 256  # dsp::kThreads in csrc/block_prefix.cuh
# Bound on the in-block scan's work items (segments x channels).
SEG_ITEMS = 4096
# Dynamic shared memory one block may use on the H100 (227 KB).
SMEM_MAX = 232448
# Shared memory of one H100 SM (228 KB); each resident block also holds 1 KB.
SMEM_PER_SM = 233472
# The rings of the span kernels (B1, B2, B3) grow with the halo k*C. Each
# beats the two-pass route wherever its ring fits shared memory, one block an
# SM included (chip_smoke.py phase 5 times both sides of TWO_BLOCKS_SMEM_MAX,
# which leaves two blocks an SM): `windowed`, the int32 pair view (B2, B1's
# launch) and `scan*` take their kernel up to WINDOWED_SMEM_MAX.
TWO_BLOCKS_SMEM_MAX = SMEM_PER_SM // 2 - 1024
WINDOWED_SMEM_MAX = SMEM_MAX


@dataclasses.dataclass(frozen=True)
class TileGeometry:
    """Launch geometry of B4's generic kernel (``csrc/cumsum.cu``).

    A block loads ``tile_frames`` frames into shared memory as uint32 and
    scans them per channel in ``segs`` segments of ``seg_frames`` frames
    (``csrc/block_prefix.cuh``); a scratch of ``segs * channels`` words holds
    the segment sums.
    """

    channels: int
    tile_frames: int
    seg_frames: int
    segs: int

    @property
    def tile_samples(self) -> int:
        return self.tile_frames * self.channels

    @property
    def smem_bytes(self) -> int:
        return 4 * (self.tile_frames + self.segs) * self.channels

    def blocks(self, n: int) -> int:
        return cdiv(n, self.tile_samples)


def cumsum_geometry(channels: int) -> TileGeometry:
    """B4's generic kernel's tile (C outside SCAN_NATIVE_C): about TILE_SAMPLES
    of whole frames in shared memory, scanned in segments. The segment length
    is odd so that one warp's segment starts fall on distinct shared-memory
    banks."""
    tf = cdiv(TILE_SAMPLES, channels)
    target = max(1, min(THREADS, SEG_ITEMS // channels))
    r = cdiv(tf, target) | 1
    return TileGeometry(channels, tf, r, cdiv(tf, r))


def cumsum_kernel_c(channels: int) -> int:
    """B4's instance for ``channels`` (``csrc/cumsum.cu``): C itself for C in
    SCAN_NATIVE_C (B3's tile of runs in registers), else 0 (the generic kernel)."""
    return channels if channels in SCAN_NATIVE_C else 0


def cumsum_tile_samples(channels: int) -> int:
    """Samples of one of B4's tiles: B3's 8192, or the generic kernel's whole frames."""
    if cumsum_kernel_c(channels):
        return THREADS * SCAN_RUN * SCAN_RUNS
    return cumsum_geometry(channels).tile_samples


def cumsum_status_words(n: int, channels: int) -> int:
    """int64 words of B4's scratch for an n-sample stream: the ticket, then one
    status word a tile and channel."""
    return 1 + cdiv(n, cumsum_tile_samples(channels)) * channels


def packed_supported(window: int, channels: int) -> bool:
    """True iff B2 takes this configuration: B2 is B1's launch, so B1's bound."""
    return windowed_supported(window, channels)


def cumsum_supported(channels: int) -> bool:
    """True iff B4 takes this channel count: C in SCAN_NATIVE_C, or one tile of
    whole frames (the generic kernel's) fits shared memory, about 29000 channels."""
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

    Any element-aligned view is taken, a streaming tail of ``serve.py``
    included. B1 and B3 load and store 16 bytes a run only where x and y are
    both 16-byte aligned, and otherwise a sample at a time; B4's instances
    load 16 bytes a run where x is aligned and store two 16-byte words a run
    where y is, each independently, and otherwise go a sample at a time; B2
    is B1's launch on the int16 view, so a pair view whose word offset is not
    a multiple of 4 goes a sample at a time; B4's generic kernel and B5 load
    single elements. The samples read and
    the sums taken are the same either way, so an aligned and a misaligned
    view give the same result.
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
    tile_samples: int | None = None,
) -> torch.Tensor:
    """Causal moving average of an interleaved int16 stream (B1).

    ``seed``: the ``window * channels`` int16 samples that precede ``x`` in
    the stream (the streaming state's tail); without it the positions
    before the start read zero, the golden model's ramp-up. Needs
    ``windowed_supported(window, channels)``; ``tile_samples`` selects
    nothing (B1's tile is 8192 samples).
    """
    validate_window(window)
    _check_stream(x, torch.int16, channels, "x", x.numel())
    halo = window * channels
    if not windowed_supported(window, channels, tile_samples):
        raise ValueError(
            f"windowed kernel takes halos whose ring fits shared memory, "
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
            return moving_average_xla(x, window, channels)
        return moving_average_xla(torch.cat([seed, x]), window, channels)[halo:]
    return launch_windowed(x, window, channels, seed)


def launch_windowed(
    x: torch.Tensor,
    window: int,
    channels: int,
    seed: torch.Tensor | None = None,
    span_tiles: int | None = None,
) -> torch.Tensor:
    """Launch B1 on a CUDA stream the caller has checked, at any halo that fits.

    :func:`windowed_averager` holds the ring to WINDOWED_SMEM_MAX;
    ``chip_smoke.py`` also times spans of ``span_tiles`` tiles (None: one
    wave of resident blocks). Raises if the ring exceeds shared memory.
    """
    g = windowed_geometry(window, channels)
    if g.smem_bytes > SMEM_MAX:
        raise ValueError(f"windowed kernel needs {g.smem_bytes} bytes of shared memory")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        err = launch_windowed_range(
            x, y, window, channels, None if seed is None else seed.data_ptr(), 0,
            g.tiles(x.numel()), _stream(x), span_tiles,
        )
    _build.check(err, "windowed_averager")
    windowed_averager.launches += 1
    return y


def launch_windowed_range(
    x: torch.Tensor,
    y: torch.Tensor,
    window: int,
    channels: int,
    seed: int | None,
    begin: int,
    end: int,
    stream: int,
    span_tiles: int | None = None,
) -> int:
    """One launch of B1 over tiles ``[begin, end)`` of ``x`` into ``y`` (tile t
    owns outputs [t * 8192, (t + 1) * 8192)) on ``stream``: its CUDA error code.

    ``seed``: the data pointer of the ``window * channels`` samples before
    ``x``, or None for zeros. Spans of ``span_tiles`` tiles, by default one
    wave of the kernel's resident blocks over the range. The caller counts
    the launch.
    """
    g = windowed_geometry(window, channels)
    if span_tiles is None:
        span_tiles = g.range_span(end - begin, _resident(x.device, g))
    return _build.library().dsp_windowed_i16_range(
        x.data_ptr(), y.data_ptr(), seed, x.numel(), window, channels, g.kernel_c, g.nrun,
        begin, end, span_tiles, g.smem_bytes, stream,
    )


windowed_averager.launches = 0


def packed_seed_words(window: int, channels: int) -> int:
    """Words of B2's seed: the ``lead * channels`` samples before the stream as
    int32 pair words, ``lead`` = ``window``, or ``window + 1`` where k*C is odd
    (a whole word more; its first C samples lie outside every window)."""
    lead = window + (window * channels) % 2
    return lead * channels // 2


def windowed_averager_packed(
    x32: torch.Tensor, window: int, channels: int = 2, *, seed: torch.Tensor | None = None
) -> torch.Tensor:
    """B1's function on the int32 little-endian pair view of the stream (B2).

    ``x32`` is ``x.view(torch.int32)`` of the int16 stream; the result is the
    same view of the int16 output, bit-exact with :func:`windowed_averager`
    on ``x32.view(torch.int16)``. Any channel count, odd included. ``seed``:
    the ``packed_seed_words(window, channels)`` int32 words before ``x32`` in
    the stream (a shard's halo), or None for zeros.

    On the card a pair word is two adjacent samples at the same address, so
    B2 is one launch of B1's span kernel over ``x32.view(torch.int16)`` into
    the int16 view of its output, seeded from the last ``window * channels``
    samples of the seed's int16 view: no copy, no unpack pass, no allocation
    but the output. It counts as B2, not B1.
    """
    validate_window(window)
    _check_stream(x32, torch.int32, channels, "x32", 2 * x32.numel())
    if not packed_supported(window, channels):
        raise ValueError(
            f"packed kernel takes halos whose ring fits shared memory, got "
            f"window*channels = {window * channels}; use moving_average_two_pass "
            "on the int16 view"
        )
    words = packed_seed_words(window, channels)
    if seed is not None:
        if (seed.dtype != torch.int32 or seed.dim() != 1 or not seed.is_contiguous()
                or seed.numel() != words or seed.device != x32.device):
            raise ValueError(
                f"seed must be the {words} contiguous int32 words before x32, on "
                f"{x32.device}; got {seed.dtype}{tuple(seed.shape)} on {seed.device}"
            )
    x16 = x32.view(torch.int16)
    if not _on_cuda(x32):
        if seed is None:
            return moving_average_xla(x16, window, channels).view(torch.int32)
        ext = torch.cat([seed.view(torch.int16), x16])
        return moving_average_xla(ext, window, channels)[2 * words :].view(torch.int32)
    y = torch.empty_like(x32)
    if x32.numel() == 0:
        return y
    # B1 reads the window * channels samples before the stream: skip the seed's
    # first C samples where it holds a whole word more
    skip = 2 * words - window * channels
    seed_ptr = None if seed is None else seed.data_ptr() + 2 * skip
    with torch.cuda.device(x32.device):
        err = launch_windowed_range(
            x16, y.view(torch.int16), window, channels, seed_ptr, 0,
            windowed_geometry(window, channels).tiles(x16.numel()), _stream(x32),
        )
    _build.check(err, "windowed_averager_packed")
    windowed_averager_packed.launches += 1
    return y


windowed_averager_packed.launches = 0


# B3's in-tile scans, and their codes in csrc/scan.cu (dsp::b3::ScanVariant)
SCAN_VARIANTS = {"blelloch": 0, "hillis_steele": 1, "mxu": 2}
# the reference cumsum's variants: its in-tile scans, and "fused", its MXU lane passes
CUMSUM_VARIANTS = ("fused", *SCAN_VARIANTS)
TC_ROW = 16  # the reference's tensor-core row: mxu takes C dividing 16, as the JAX kernel does
SCAN_RUN = 8  # samples a run: one 16-byte vector of int16
SCAN_RUNS = 4  # runs a thread (dsp::runs::kNQ): 32 samples, 8192 a tile
SCAN_NATIVE_C = (1, 2, 4, 8, 16)  # channel counts with an instance of their own


@dataclasses.dataclass(frozen=True)
class ScanGeometry:
    """Launch geometry of B3 (``csrc/scan.cu``).

    A block of THREADS threads walks a span of tiles of the interleaved
    stream in order; each thread holds SCAN_RUNS runs of SCAN_RUN samples in
    registers. C in SCAN_NATIVE_C has an instance of its own (``kernel_c`` =
    C); any other C takes the generic kernel (``kernel_c`` = 0). Shared
    memory holds a ring of the last ``nrun`` runs' absolute prefixes (every
    cum[i - H] a tile reads) and the 8 warps' totals, or, in the generic
    kernel, the ring skewed by a word every 32 and one carry a channel.
    """

    window: int
    channels: int
    variant: str

    @property
    def kernel_c(self) -> int:
        return self.channels if self.channels in SCAN_NATIVE_C else 0

    @property
    def tile_samples(self) -> int:
        return THREADS * SCAN_RUN * SCAN_RUNS

    @property
    def halo(self) -> int:
        return self.window * self.channels

    @property
    def seed_tiles(self) -> int:
        """Tiles a block scans before its span, to reach H samples back."""
        return cdiv(self.halo, self.tile_samples)

    @property
    def nrun(self) -> int:
        """Runs in the ring: a tile and ceil(H / 8) + 1 more, a multiple of 32."""
        return round_up(self.tile_samples // SCAN_RUN + cdiv(self.halo, SCAN_RUN) + 1, 32)

    @property
    def smem_bytes(self) -> int:
        ring = SCAN_RUN * self.nrun
        if self.kernel_c:
            return 4 * (ring + (THREADS // 32) * self.channels)
        return 4 * (ring + ring // 32 + self.channels)

    def tiles(self, n: int) -> int:
        """Tiles of an n-sample stream."""
        return cdiv(n, self.tile_samples)

    def span_tiles(self, n: int, resident: int) -> int:
        """Tiles a block walks: one wave of ``resident`` blocks (the card's SMs
        times the kernel's blocks an SM) covers the stream."""
        return self.range_span(self.tiles(n), resident)

    @staticmethod
    def range_span(tiles: int, resident: int) -> int:
        """Tiles a block walks so that one wave of ``resident`` blocks covers
        ``tiles`` tiles."""
        return cdiv(tiles, max(1, min(tiles, resident)))


# B1's in-tile scan: the fastest of B3's three on the H100 (PERF.md)
WINDOWED_VARIANT = "hillis_steele"


@dataclasses.dataclass(frozen=True)
class WindowedGeometry(ScanGeometry):
    """Launch geometry of B1 (``csrc/windowed.cu``): B3's tiles, ring, spans
    and channel instances (``csrc/run_tile.cuh``) with the Hillis-Steele scan;
    a launch covers any range of tiles, each span seeded from x or the seed."""

    variant: str = WINDOWED_VARIANT


def windowed_geometry(window: int, channels: int, tile_samples: int | None = None) -> WindowedGeometry:
    """B1's geometry; ``tile_samples`` (the reference's ``tile_rows``) selects nothing."""
    return WindowedGeometry(window, channels)


def windowed_supported(window: int, channels: int, tile_samples: int | None = None) -> bool:
    """True iff B1 takes this configuration: any C, while its ring fits
    WINDOWED_SMEM_MAX."""
    return (
        channels >= 1
        and 1 <= window
        and windowed_geometry(window, channels).smem_bytes <= WINDOWED_SMEM_MAX
    )


def _check_scan_variant(variant: str, channels: int) -> None:
    if variant not in SCAN_VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; options {sorted(SCAN_VARIANTS)}")
    if channels < 1:
        raise ValueError(f"channels must be >= 1, got {channels}")
    if variant == "mxu" and TC_ROW % channels != 0:
        raise ValueError(
            f"the tensor-core scan needs channels dividing its {TC_ROW}-sample rows, "
            f"got {channels}; use method='scan' (any channel count)"
        )


def scan_geometry(
    window: int, channels: int, variant: str = "blelloch", tile_samples: int | None = None
) -> ScanGeometry:
    """B3's geometry. Its tile is 8192 samples whatever ``tile_samples``
    says: an explicit tile smaller than the halo raises, as
    the reference's ``tile_rows`` does, and selects nothing else. The
    kernel's ring reaches any halo that fits.
    """
    _check_scan_variant(variant, channels)
    if tile_samples is not None and window > cdiv(tile_samples, channels):
        raise ValueError(
            f"window*channels = {window * channels} exceeds one tile "
            f"({tile_samples} samples); raise tile_samples"
        )
    return ScanGeometry(window, channels, variant)


def scan_supported(
    window: int, channels: int, variant: str = "blelloch", tile_samples: int | None = None
) -> bool:
    """True iff B3 takes this configuration: its ring fits WINDOWED_SMEM_MAX.

    ``variant`` must be known and, for ``mxu``, take the channel count.
    """
    _check_scan_variant(variant, channels)
    if window < 1 or (tile_samples is not None and window > cdiv(tile_samples, channels)):
        return False
    return scan_geometry(window, channels, variant, tile_samples).smem_bytes <= WINDOWED_SMEM_MAX


def scan_averager(
    x: torch.Tensor,
    window: int,
    channels: int = 1,
    *,
    variant: str = "blelloch",
    tile_samples: int | None = None,
) -> torch.Tensor:
    """Causal moving average of an interleaved int16 stream by a carried scan (B3).

    ``variant`` is the in-tile scan: ``blelloch``, ``hillis_steele`` or
    ``mxu`` (the tensor cores; channels must divide 16). Bit-exact with
    :func:`windowed_averager`. Needs ``scan_supported(window, channels,
    variant, tile_samples)``.
    """
    validate_window(window)
    _check_stream(x, torch.int16, channels, "x", x.numel())
    if scan_geometry(window, channels, variant, tile_samples).smem_bytes > WINDOWED_SMEM_MAX:
        raise ValueError(
            f"scan kernel takes halos whose ring fits shared memory, got "
            f"window*channels = {window * channels}; use moving_average_two_pass"
        )
    if not _on_cuda(x):
        return moving_average_xla(x, window, channels)
    return launch_scan(x, window, channels, variant, tile_samples)


def launch_scan(
    x: torch.Tensor,
    window: int,
    channels: int,
    variant: str = "blelloch",
    tile_samples: int | None = None,
) -> torch.Tensor:
    """Launch B3 on a CUDA stream the caller has checked, at any halo that fits.

    ``chip_smoke.py`` times it against the two-pass route on both sides of
    two blocks an SM. Raises if the ring exceeds shared memory.
    """
    g = scan_geometry(window, channels, variant, tile_samples)
    if g.smem_bytes > SMEM_MAX:
        raise ValueError(f"scan kernel needs {g.smem_bytes} bytes of shared memory")
    n = x.numel()
    y = torch.empty_like(x)
    if n == 0:
        return y
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.dsp_scan_i16(
            x.data_ptr(), y.data_ptr(), n, window, channels, SCAN_VARIANTS[variant], g.kernel_c,
            g.nrun, g.span_tiles(n, _resident(x.device, g)), g.smem_bytes, _stream(x),
        )
    _build.check(err, f"scan_averager[{variant}]")
    scan_averager.launches[variant] += 1
    return y


scan_averager.launches = dict.fromkeys(SCAN_VARIANTS, 0)  # by variant


@functools.lru_cache(maxsize=None)
def _kernel_attrs(device: int | None, windowed: bool, variant: str, kernel_c: int,
                  smem_bytes: int) -> tuple:
    """B1's (``windowed``) or B3's kernel attributes: as :func:`scan_kernel_attrs`."""
    lib = _build.library()
    out = (ctypes.c_int64 * 4)()
    with torch.cuda.device(device):
        if windowed:
            err = lib.dsp_windowed_attrs(kernel_c, smem_bytes, ctypes.addressof(out))
        else:
            err = lib.dsp_scan_attrs(SCAN_VARIANTS[variant], kernel_c, smem_bytes,
                                     ctypes.addressof(out))
        _build.check(err, "windowed_kernel_attrs" if windowed else "scan_kernel_attrs")
    return tuple(out)


def _attrs_of(device: int | None, g: ScanGeometry) -> tuple:
    return _kernel_attrs(device, isinstance(g, WindowedGeometry), g.variant, g.kernel_c,
                         g.smem_bytes)


def _resident(device: torch.device, g: ScanGeometry) -> int:
    """Blocks of g's kernel the card holds at once: its SMs times blocks an SM."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * _attrs_of(device.index, g)[3]


def scan_kernel_attrs(window: int, channels: int = 2, variant: str = "blelloch") -> tuple:
    """What the compiler gave B3's kernel for ``variant`` and ``channels``, and its
    blocks an SM at ``window`` (the card only): (registers a thread, local bytes a
    thread, shared bytes a block, blocks an SM). The launch sizes its spans by
    the last."""
    return _attrs_of(torch.cuda.current_device(), scan_geometry(window, channels, variant))


def windowed_kernel_attrs(window: int, channels: int = 2) -> tuple:
    """What the compiler gave B1's kernel for ``channels``, and its blocks an SM
    at ``window`` (the card only): as :func:`scan_kernel_attrs`."""
    return _attrs_of(torch.cuda.current_device(), windowed_geometry(window, channels))


def cumsum(x: torch.Tensor, channels: int = 1, *, variant: str = "fused") -> torch.Tensor:
    """Per-channel int32 modular inclusive prefix sum of an interleaved stream (B4).

    One launch after a memset of its scratch (``cumsum_status_words``): every
    tile publishes its per-channel totals and looks back over its
    predecessors for its carry, so the stream is read once. Needs
    ``cumsum_supported(channels)``. ``variant`` takes the reference's names
    (:data:`CUMSUM_VARIANTS`), which pick its in-tile scan; every one runs
    B4 here, bit-identical, as the modular sum is exact in any order.
    """
    if variant not in CUMSUM_VARIANTS:  # the reference's refusal and message
        raise ValueError(f"unknown variant {variant!r}; options {sorted(SCAN_VARIANTS)}")
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
    rec = torch.empty(cumsum_status_words(n, channels), dtype=torch.int64, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.dsp_cumsum_i16(
            x.data_ptr(), y.data_ptr(), rec.data_ptr(), n, channels, cumsum_kernel_c(channels),
            g.tile_frames, g.seg_frames, g.segs, g.smem_bytes, _stream(x),
        )
    _build.check(err, "cumsum")
    cumsum.launches += 1
    return y


cumsum.launches = 0


def cumsum_kernel_attrs(channels: int) -> tuple:
    """What the compiler gave B4's kernel for ``channels`` (the card only):
    (registers a thread, local bytes a thread, shared bytes a block, blocks an SM)."""
    kernel_c = cumsum_kernel_c(channels)
    smem = 0 if kernel_c else cumsum_geometry(channels).smem_bytes
    out = (ctypes.c_int64 * 4)()
    with torch.cuda.device(torch.cuda.current_device()):
        err = _build.library().dsp_cumsum_attrs(kernel_c, smem, ctypes.addressof(out))
    _build.check(err, "cumsum_kernel_attrs")
    return tuple(out)


def moving_average_two_pass(
    x: torch.Tensor, window: int, channels: int = 1, *, variant: str = "blelloch"
) -> torch.Tensor:
    """Averager for halos beyond the windowed kernels: B4, then the difference.

    Pass 1 is the cumsum kernel (int32 modular); pass 2 the windowed
    difference and truncating division in plain PyTorch, as the reference
    package does it in XLA. Costs one int32 round trip through device memory
    more than the windowed kernel, but no work that grows with the window.
    ``variant`` is the reference's cumsum variant (:data:`CUMSUM_VARIANTS`;
    any other raises its ``ValueError``): every one runs B4, so the outputs
    are bit-identical, the cumsum being exact.
    """
    validate_window(window)
    return windowed_difference(cumsum(x, channels, variant=variant), window, channels)


__all__ = [
    "TILE_SAMPLES",
    "TWO_BLOCKS_SMEM_MAX",
    "SCAN_VARIANTS",
    "CUMSUM_VARIANTS",
    "WINDOWED_SMEM_MAX",
    "TileGeometry",
    "ScanGeometry",
    "WindowedGeometry",
    "windowed_geometry",
    "cumsum_geometry",
    "cumsum_kernel_c",
    "cumsum_tile_samples",
    "cumsum_status_words",
    "cumsum_kernel_attrs",
    "scan_geometry",
    "windowed_supported",
    "packed_supported",
    "cumsum_supported",
    "scan_supported",
    "windowed_averager",
    "launch_windowed",
    "launch_windowed_range",
    "windowed_kernel_attrs",
    "packed_seed_words",
    "windowed_averager_packed",
    "scan_averager",
    "launch_scan",
    "scan_kernel_attrs",
    "cumsum",
    "moving_average_two_pass",
]
