"""The CUDA kernels' block algorithm, emulated in NumPy with the wrappers' geometry.

The kernels of ``digital_signal_processsing_tpu_torch/csrc`` only run on a
card. Their arithmetic is kept testable here: each function below does what
one kernel block does (load the halo and tile, per-channel prefix by
segments in uint32, difference or carry) with the geometry that
``ops/pallas_scan.py`` passes to the launch, and must give the golden
result bit for bit.
"""

import numpy as np
import pytest

from digital_signal_processsing_tpu_torch.golden import (
    cumsum_per_channel_golden,
    moving_average_golden,
)
from digital_signal_processsing_tpu_torch.ops import pallas_scan as ps
from tests.conftest import make_interleaved


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


def emulate_windowed(x, window, channels, *, seed=None, packed=False):
    g = ps.packed_geometry(window, channels) if packed else ps.windowed_geometry(window, channels)
    n, tile = x.size, g.tile_samples
    halo, lead = window * channels, g.lead_frames * channels
    out = np.empty(n, np.int16)
    for b in range(g.blocks(n)):
        t0 = b * tile
        idx = np.arange(t0 - lead, t0 + tile)
        if packed:  # word loads: the buffer starts on a word
            assert (t0 - lead) % 2 == 0 and idx.size % 2 == 0
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
     (10118, 2, 9000), (1070, 16, 1500)],  # the largest buffers B1 takes at C=2 and 16
)
def test_windowed_block_algorithm(rng, window, channels, frames):
    x = make_interleaved(rng, frames, channels)
    want = moving_average_golden(x, window, channels)
    np.testing.assert_array_equal(emulate_windowed(x, window, channels), want)
    if x.size % 2 == 0:
        np.testing.assert_array_equal(emulate_windowed(x, window, channels, packed=True), want)


@pytest.mark.parametrize("window,channels", [(1024, 2), (5, 3), (16384, 1)])
def test_windowed_block_algorithm_seeded(rng, window, channels):
    x = make_interleaved(rng, window + 20000, channels)
    cut = (window + 3000) * channels
    seed = x[cut - window * channels : cut]
    got = emulate_windowed(x[cut:], window, channels, seed=seed)
    np.testing.assert_array_equal(got, moving_average_golden(x, window, channels)[cut:])


def test_windowed_block_algorithm_int16_min():
    x = np.full(40000, -32768, np.int16)
    for window, channels in [(16384, 1), (1024, 16), (99, 2)]:
        np.testing.assert_array_equal(
            emulate_windowed(x, window, channels), moving_average_golden(x, window, channels)
        )


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
            (ps.windowed_geometry(window, channels), False),
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
        if window <= largest:  # B1 takes every window up to its largest
            assert ps.windowed_supported(window, channels)
            assert ps.windowed_geometry(window, channels).smem_bytes <= ps.TWO_BLOCKS_SMEM_MAX
            assert 2 * (ps.windowed_geometry(window, channels).smem_bytes + 1024) <= ps.SMEM_PER_SM
        else:
            assert not ps.windowed_supported(window, channels)
        assert ps.cumsum_supported(channels)
    assert largest == 65535 or not ps.windowed_supported(largest + 1, channels)


def test_halo_bound():
    # the route switches where a second block no longer fits on an SM,
    # measured on the H100 at C=2 and C=16 (PERF.md)
    assert ps.windowed_supported(10118, 2)
    assert not ps.windowed_supported(10119, 2)
    assert ps.windowed_supported(1070, 16)
    assert not ps.windowed_supported(1071, 16)
    assert ps.packed_supported(10118, 2) and not ps.packed_supported(10119, 2)
    assert not ps.windowed_supported(65535, 1)
    assert not ps.windowed_supported(0, 1)
