"""B7's launches and B2's seeded blocks, emulated in NumPy at the wrappers' geometry.

``fused_ring_windowed_shard`` runs B1's spans over one shard in the
launches ``ring_pallas.fused_ring_launches`` gives a rank: where a halo
arrives (every rank but rank 0), one launch of ``ring_windowed_kernel``
whose block 0 puts the shard's tail (every rank but the last) and whose
blocks run the interior tiles unseeded, then, behind the stream's wait for
the left neighbour's put, one block over the head tiles seeded from the
received halo; on rank 0 one launch with the head, unseeded, in its last
block. Each launch below does what ``csrc/ring.cu``'s does
(``tests/test_torch_scan.py``'s ``emulate_scan`` with B1's geometry: spans
of tiles over the launch's range, each span first scanning the H samples
before it); every output must be written exactly once, the head tiles must
be exactly those whose window reaches before the shard, no span of the
interior may read before the shard, and the shards together must give the
golden result bit for bit. The same for B2 seeded with the pair words
before its stream, the sharded packed route (B1's launch on their int16
view).
"""

import numpy as np
import pytest
import torch

from digital_signal_processsing_tpu_torch.golden import moving_average_golden
from digital_signal_processsing_tpu_torch.ops import pallas_scan as ps
from digital_signal_processsing_tpu_torch.parallel.ring_pallas import (
    fused_ring_launches,
    fused_ring_split,
    ring_roles,
)
from tests.conftest import make_interleaved
from tests.test_torch_geometry import emulate_windowed
from tests.test_torch_scan import emulate_scan


def emulate_fused_ring(shards, window, channels, tile_samples, resident=3):
    """Every rank's launches; returns the outputs and each rank's split.
    ``resident`` blocks a wave: spans of several tiles where a range is long."""
    halo = window * channels
    outs, splits = [], []
    for d, xs in enumerate(shards):
        g, head, tiles = fused_ring_split(xs.size, window, channels, tile_samples)
        left, right = ring_roles(len(shards), d)
        launches = fused_ring_launches(xs.size, window, channels, resident, left=left,
                                       right=right, tile_samples=tile_samples)
        # the put in the first launch's block 0; with a halo, the head alone in the
        # last launch, behind the wait; without, one launch
        assert [ln.put for ln in launches] == [right] + [False] * (len(launches) - 1)
        assert len(launches) == (1 if not left else 2 if head < tiles or right else 1)
        assert [ln.head_tiles for ln in launches][-1] == head
        assert all(ln.head_tiles == 0 for ln in launches[:-1])
        y = np.zeros(xs.size, np.int16)
        writes = np.zeros(xs.size, np.int64)
        launch = dict(g=g, out=y, written=writes)
        seed = shards[d - 1][-halo:] if left else None  # the put's payload; rank 0: none
        for ln in launches:
            begin, end = ln.interior
            if begin < end:  # the interior: B1's spans, no seed read
                stats = {}
                emulate_scan(xs, window, channels, None, tile_range=(begin, end),
                             span=ln.span_tiles, stats=stats, **launch)
                assert stats["least_lo"] >= 0  # no span reads before the shard
            if ln.head_tiles:  # the last block: the head tiles as one span
                stats = {}
                emulate_scan(xs, window, channels, None, seed=seed, tile_range=(0, ln.head_tiles),
                             span=ln.head_tiles, stats=stats, **launch)
                assert stats["least_lo"] < 0  # the head's windows reach before the shard
        np.testing.assert_array_equal(writes, 1)  # every output written exactly once
        assert head == sum(1 for t in range(tiles) if t * g.tile_samples < halo)
        outs.append(y)
        splits.append((head, tiles))
    return np.concatenate(outs), splits


@pytest.mark.parametrize("tile_samples", [None, 256])
@pytest.mark.parametrize(
    "window,channels,shard_frames",
    [
        (1, 1, 5000), (16, 2, 4100), (1024, 2, 9000), (16, 16, 700), (1000, 1, 20000),
        (1024, 2, 1024),  # k*C equals the shard
        (16, 2, 100),  # a shard shorter than one tile
        (3, 3, 4097),
    ],
)
def test_fused_ring_split(rng, window, channels, shard_frames, tile_samples):
    # tile_samples (the reference's tile_rows) selects nothing: B1's tile is 8192
    assert ps.windowed_supported(window, channels, tile_samples)
    x = make_interleaved(rng, 4 * shard_frames, channels)
    shards = np.split(x, 4)
    got, splits = emulate_fused_ring(shards, window, channels, tile_samples)
    np.testing.assert_array_equal(got, moving_average_golden(x, window, channels))
    assert splits[0] == splits[-1]  # equal shards: one split on every rank


def test_fused_ring_split_counts():
    # 8192-sample tiles at k=1024, C=2: the halo of 2048 samples reaches into
    # tile 0 only; a 64M stream in 4 shards has 2048 tiles a shard
    g, head, tiles = fused_ring_split(16 * 2**20, 1024, 2)
    assert g.tile_samples == 8192 and (head, tiles) == (1, 2048)
    assert fused_ring_split(2048, 1024, 2)[1:] == (1, 1)  # the whole shard is the head
    assert fused_ring_split(100000, 20000, 1, 256)[1:] == (3, 13)  # a halo over three tiles
    x = make_interleaved(np.random.default_rng(5), 4 * 30000, 1)
    got, splits = emulate_fused_ring(np.split(x, 4), 20000, 1, None)
    assert splits[0] == (3, 4)
    np.testing.assert_array_equal(got, moving_average_golden(x, 20000, 1))


def emulate_packed_seeded(x, window, channels, seed):
    """B2 seeded: B1's launch over the int16 view of the words, from the last H
    samples of the seed's (``packed_seed_words`` words, a frame more where k*C
    is odd)."""
    assert seed.size == 2 * ps.packed_seed_words(window, channels) and x.size % 2 == 0
    return emulate_windowed(x, window, channels, seed=seed, packed=True, resident=3)


@pytest.mark.parametrize("window,channels", [(700, 2), (16, 3), (1, 1), (15, 3), (1023, 2)])
def test_packed_seeded_block_algorithm(rng, window, channels):
    """B2 with the pair words before its stream: one shard of a packed stream."""
    frames = 3000 + (3000 * channels) % 2  # an even sample count
    x = make_interleaved(rng, 2 * frames, channels)
    words = ps.packed_seed_words(window, channels)
    head, tail = x[: frames * channels], x[frames * channels :]
    seed = head[head.size - 2 * words :]
    got = emulate_packed_seeded(tail, window, channels, seed)
    want = moving_average_golden(x, window, channels)[frames * channels :]
    np.testing.assert_array_equal(got, want)
    plain = ps.windowed_averager_packed(
        torch.from_numpy(tail.copy()).view(torch.int32), window, channels,
        seed=torch.from_numpy(seed.copy()).view(torch.int32),
    )
    np.testing.assert_array_equal(plain.view(torch.int16).numpy(), want)


def test_packed_seed_refusals():
    x = torch.zeros(64, dtype=torch.int32)
    with pytest.raises(ValueError, match="seed must be"):
        ps.windowed_averager_packed(x, 16, 2, seed=torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="seed must be"):
        ps.windowed_averager_packed(x, 16, 2, seed=torch.zeros(16, dtype=torch.int16))
