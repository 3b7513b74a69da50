"""The CUDA kernels' block algorithm, emulated in NumPy with the wrappers' geometry.

The kernels of ``digital_signal_processsing_tpu_torch/csrc`` only run on a
card. Their arithmetic is kept testable here: each function below does what
the kernel's blocks do with the geometry that ``ops/pallas_scan.py`` passes
to the launch, and must give the golden result bit for bit. B1 is
``csrc/run_tile.cuh``'s span kernel (``tests/test_torch_scan.py``'s
``emulate_scan`` with B1's geometry: each span's seed tiles from x or the
seed, every thread's runs of 8 and their 16-byte or sample-by-sample loads
and stores, the Hillis-Steele levels, the ring, any range of tiles); B2 and
B4 load the halo and tile into shared memory and form a per-channel prefix
by segments in uint32.
"""

import numpy as np
import pytest
import torch

from digital_signal_processsing_tpu_torch.golden import (
    cumsum_per_channel_golden,
    moving_average_golden,
)
from digital_signal_processsing_tpu_torch.ops import pallas_scan as ps
from tests.conftest import make_interleaved
from tests.test_torch_scan import H100_SMS, emulate_scan


def block_prefix(buf: np.ndarray, g: ps.TileGeometry, nf: int, carry=None) -> np.ndarray:
    """segment_sums, segment_offsets and segment_apply of block_prefix.cuh."""
    c = g.channels
    rows = np.zeros((g.segs * g.seg_frames, c), np.uint32)
    assert g.segs * g.seg_frames >= nf > (g.segs - 1) * g.seg_frames
    rows[:nf] = buf.reshape(nf, c)
    segs = rows.reshape(g.segs, g.seg_frames, c)
    seg_sums = segs.sum(axis=1, dtype=np.uint32)
    offsets = np.cumsum(seg_sums, axis=0, dtype=np.uint32) - seg_sums
    if carry is not None:
        offsets = offsets + carry
    prefix = np.cumsum(segs, axis=1, dtype=np.uint32) + offsets[:, None, :]
    return prefix.reshape(-1, c)[:nf].reshape(-1), seg_sums.sum(axis=0, dtype=np.uint32)


def widen(v: np.ndarray) -> np.ndarray:
    return v.astype(np.int32).view(np.uint32)


def emulate_windowed(x, window, channels, *, seed=None, packed=False, resident=4 * H100_SMS,
                     **launch):
    """B1's launch (``launch``: emulate_scan's range, span, alignment and
    counts), or B2's blocks with ``packed``."""
    if not packed:
        g = ps.windowed_geometry(window, channels)
        return emulate_scan(x, window, channels, None, g=g, seed=seed, resident=resident, **launch)
    g = ps.packed_geometry(window, channels)
    n, tile = x.size, g.tile_samples
    halo, lead = window * channels, g.lead_frames * channels
    out = np.empty(n, np.int16)
    for b in range(g.blocks(n)):
        t0 = b * tile
        idx = np.arange(t0 - lead, t0 + tile)
        assert (t0 - lead) % 2 == 0 and idx.size % 2 == 0  # word loads: the buffer starts on a word
        buf = np.zeros(idx.size, np.uint32)
        inside = (idx >= 0) & (idx < n)
        buf[inside] = widen(x[idx[inside]])
        if seed is not None:
            before = (idx < 0) & (idx >= -halo)
            buf[before] = widen(seed[halo + idx[before]])
        p, _ = block_prefix(buf, g, g.lead_frames + g.tile_frames)
        t = np.arange(min(tile, n - t0))
        wsum = (p[lead + t] - p[lead + t - halo]).view(np.int32).astype(np.int64)
        q = np.where(wsum >= 0, wsum // window, -((-wsum) // window))
        out[t0 + t] = q.astype(np.int16)
    return out


def emulate_cumsum(x, channels):
    g = ps.cumsum_geometry(channels)
    n, tile, blocks = x.size, g.tile_samples, g.blocks(x.size)
    tiles = np.zeros(blocks * tile, np.uint32)
    tiles[:n] = widen(x)
    totals = np.stack(
        [block_prefix(tiles[b * tile : (b + 1) * tile], g, g.tile_frames)[1] for b in range(blocks)]
    )
    carry = np.cumsum(totals, axis=0, dtype=np.uint32) - totals  # cumsum_carry_kernel
    out = np.concatenate(
        [
            block_prefix(tiles[b * tile : (b + 1) * tile], g, g.tile_frames, carry[b])[0]
            for b in range(blocks)
        ]
    )
    return out[:n].view(np.int32)


@pytest.mark.parametrize(
    "window,channels,frames",
    [(1, 1, 20000), (16, 2, 9000), (1024, 2, 12289), (1024, 16, 1500), (16384, 1, 30001),
     (7, 3, 5000), (100, 5, 4000), (3, 128, 200), (1, 4096, 3),
     (10118, 2, 9000), (1070, 16, 1500)],  # the largest buffers B2 takes at C=2 and 16
)
def test_windowed_block_algorithm(rng, window, channels, frames):
    x = make_interleaved(rng, frames, channels)
    want = moving_average_golden(x, window, channels)
    np.testing.assert_array_equal(emulate_windowed(x, window, channels), want)
    np.testing.assert_array_equal(emulate_windowed(x, window, channels, resident=2), want)  # spans
    if x.size % 2 == 0:
        np.testing.assert_array_equal(emulate_windowed(x, window, channels, packed=True), want)


@pytest.mark.parametrize("window,channels", [(1024, 2), (5, 3), (16384, 1)])
def test_windowed_block_algorithm_seeded(rng, window, channels):
    x = make_interleaved(rng, window + 20000, channels)
    cut = (window + 3000) * channels
    seed = x[cut - window * channels : cut]
    want = moving_average_golden(x, window, channels)[cut:]
    for resident in (2, 4 * H100_SMS):  # spans of several tiles, and of one
        got = emulate_windowed(x[cut:], window, channels, seed=seed, resident=resident)
        np.testing.assert_array_equal(got, want)


def test_windowed_block_algorithm_int16_min():
    x = np.full(40000, -32768, np.int16)
    for window, channels in [(16384, 1), (1024, 16), (99, 2), (1, 5)]:
        np.testing.assert_array_equal(
            emulate_windowed(x, window, channels), moving_average_golden(x, window, channels)
        )
        seed = np.full(window * channels, -32768, np.int16)
        np.testing.assert_array_equal(
            emulate_windowed(x, window, channels, seed=seed, resident=2),
            moving_average_golden(np.concatenate([seed, x]), window, channels)[seed.size :],
        )


@pytest.mark.parametrize(
    "window,channels,frames",
    [(1, 1, 8 * 2048 + 7), (16, 2, 4099), (1024, 2, 12289), (7, 3, 5461), (100, 5, 3277),
     (33, 16, 1025), (3000, 1, 20001)],
)
def test_windowed_runs_and_edges(rng, window, channels, frames):
    """B1's loads and stores: 16 bytes a run inside the stream, run by run and
    sample by sample at its ragged end and before it, every access of a
    misaligned view (x or y off the 16-byte grid) sample by sample; the same
    output either way. The plain wrapper takes the misaligned view too."""
    x = make_interleaved(rng, frames, channels)
    want = moving_average_golden(x, window, channels)
    aligned, misaligned = {}, {}
    np.testing.assert_array_equal(emulate_windowed(x, window, channels, resident=2, stats=aligned), want)
    np.testing.assert_array_equal(
        emulate_windowed(x, window, channels, resident=2, aligned=False, stats=misaligned), want)
    assert aligned["vector loads"] and aligned["scalar loads"] and aligned["vector stores"]
    assert misaligned["vector loads"] == misaligned["vector stores"] == 0
    buf = np.concatenate([np.zeros(1, np.int16), x])  # a view one sample off the grid
    view = torch.from_numpy(buf)[1:]
    assert view.data_ptr() % 16 != 0
    np.testing.assert_array_equal(ps.windowed_averager(view, window, channels).numpy(), want)


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("window,channels,frames", [(1024, 2, 20000), (3000, 3, 9000), (5, 16, 5000)])
def test_windowed_range_split(rng, window, channels, frames, seeded):
    """The range entry: tiles [0, b) and [b, tiles) as two launches give the
    one launch's output at every tile boundary b, seeded and not; a launch
    starting at a tile whose window lies inside the stream reads nothing
    before it."""
    x = make_interleaved(rng, frames, channels)
    h = window * channels
    seed = make_interleaved(rng, window, channels) if seeded else None
    ext = x if seed is None else np.concatenate([seed, x])
    want = moving_average_golden(ext, window, channels)[ext.size - x.size :]
    g = ps.windowed_geometry(window, channels)
    tiles = g.tiles(x.size)
    for b in range(tiles + 1):
        out = np.zeros(x.size, np.int16)
        written = np.zeros(x.size, np.int64)
        for rng_ in ((0, b), (b, tiles)):
            if rng_[0] < rng_[1]:
                stats = {}
                emulate_windowed(x, window, channels, seed=seed, resident=3, tile_range=rng_,
                                 out=out, written=written, stats=stats)
                if rng_[0] * g.tile_samples >= h:
                    assert stats["least_lo"] >= 0  # no read before the stream
        np.testing.assert_array_equal(written, 1)
        np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("channels", [1, 2, 3, 5, 16])
def test_windowed_channels_and_extremes(rng, channels):
    """Any C (3 and 5 take the generic kernel), k = 1, a halo longer than a
    tile, the largest halo B1 takes, and every window sum at int16's min and max."""
    largest = largest_window(channels)
    for window in (1, 8192 // channels + 3, largest):
        frames = 2 * window + 9000 // channels
        for x in (make_interleaved(rng, frames, channels),
                  np.full(frames * channels, 32767, np.int16),
                  np.full(frames * channels, -32768, np.int16)):
            want = moving_average_golden(x, window, channels)
            np.testing.assert_array_equal(emulate_windowed(x, window, channels, resident=3), want)


@pytest.mark.parametrize("channels,frames", [(1, 50001), (2, 20000), (3, 9000), (16, 3000)])
def test_cumsum_block_algorithm(rng, channels, frames):
    x = make_interleaved(rng, frames, channels)
    want = cumsum_per_channel_golden(x, channels).astype(np.int32)
    np.testing.assert_array_equal(emulate_cumsum(x, channels), want)


def test_cumsum_block_algorithm_wraps():
    x = np.full(3 * ps.TILE_SAMPLES * 11, 32767, np.int16)
    want = cumsum_per_channel_golden(x, 1).astype(np.int32)
    np.testing.assert_array_equal(emulate_cumsum(x, 1), want)


def largest_window(channels: int) -> int:
    """Largest window B1 takes at this channel count (0 if none), by bisection."""
    lo, hi = 0, 65535
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if ps.windowed_supported(mid, channels):
            lo = mid
        else:
            hi = mid - 1
    return lo


@pytest.mark.parametrize("channels", [1, 2, 3, 5, 16, 17, 64, 128, 1000, 4096, 8191, 16384])
def test_geometry_fits_the_card(channels):
    largest = largest_window(channels)
    for window in sorted({1, 2, 7, 64, largest} - {0}):
        for g, even in [
            (ps.packed_geometry(window, channels), True),
            (ps.cumsum_geometry(channels), False),
        ]:
            nf = g.lead_frames + g.tile_frames
            assert g.seg_frames % 2 == 1
            assert (g.segs - 1) * g.seg_frames < nf <= g.segs * g.seg_frames
            assert g.segs * channels <= max(ps.SEG_ITEMS, channels)
            assert g.tile_samples >= ps.TILE_SAMPLES
            if even:
                assert g.tile_samples % 2 == 0 and (g.lead_frames * channels) % 2 == 0
                assert g.lead_frames >= window
        g = ps.windowed_geometry(window, channels)
        assert g.tile_samples == 8192 and g.kernel_c == (channels if channels in ps.SCAN_NATIVE_C else 0)
        assert g.nrun % 32 == 0 and g.nrun >= g.tile_samples // 8 + -(-g.halo // 8) + 1
        assert g.seed_tiles * g.tile_samples >= g.halo
        if window <= largest:  # B1 takes every window up to its largest
            assert ps.windowed_supported(window, channels)
            assert g.smem_bytes <= ps.WINDOWED_SMEM_MAX <= ps.SMEM_MAX
            assert g.smem_bytes + 1024 <= ps.SMEM_PER_SM  # at least one block an SM
        else:
            assert not ps.windowed_supported(window, channels)
        assert ps.cumsum_supported(channels)
    assert largest == 65535 or not ps.windowed_supported(largest + 1, channels)


def test_halo_bound():
    # B1 takes every halo whose ring fits shared memory (one block an SM
    # included: chip_smoke.py phase 5 times both sides against two-pass);
    # B2 keeps its two-blocks bound (PERF.md)
    for c, k in [(1, 49656), (2, 24828), (3, 16040), (16, 3103)]:
        assert ps.windowed_supported(k, c)
        assert not ps.windowed_supported(k + 1, c)
    assert ps.windowed_supported(10119, 2) and ps.windowed_supported(1071, 16)
    assert ps.packed_supported(10118, 2) and not ps.packed_supported(10119, 2)
    assert not ps.windowed_supported(65535, 1)
    assert not ps.windowed_supported(0, 1)
