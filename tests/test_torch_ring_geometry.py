"""B7's two launches and B2's seeded blocks, emulated in NumPy at the wrappers' geometry.

``fused_ring_windowed_shard`` runs B1 over one shard in two launches of
``dsp_windowed_i16_range``: the interior blocks unseeded while the halo is
in flight, then the head blocks seeded from the received halo (zeros on
rank 0). Each block below does what a block of ``csrc/windowed.cu`` does
(``tests/test_torch_geometry.py``'s ``block_prefix``) with the split that
``ring_pallas.fused_ring_split`` gives; every output must be written exactly
once, the head blocks must be exactly those whose window reaches before the
shard, no interior block may read before the shard, and the shards together
must give the golden result bit for bit. The same for B2 seeded with the
pair words before its stream, the sharded packed route.
"""

import numpy as np
import pytest
import torch

from digital_signal_processsing_tpu_torch.golden import moving_average_golden
from digital_signal_processsing_tpu_torch.ops import pallas_scan as ps
from digital_signal_processsing_tpu_torch.parallel.ring_pallas import fused_ring_split
from tests.conftest import make_interleaved
from tests.test_torch_geometry import block_prefix, widen


def emulate_block(x, seed, g, window, b, y, writes, reads_before):
    """One block of windowed_kernel at grid offset b (the launch's block0 + blockIdx.x)."""
    n, tile, c = x.size, g.tile_samples, g.channels
    halo, lead = window * c, g.lead_frames * c
    t0 = b * tile
    idx = np.arange(t0 - lead, t0 + tile)
    buf = np.zeros(idx.size, np.uint32)
    inside = (idx >= 0) & (idx < n)
    buf[inside] = widen(x[idx[inside]])
    before = (idx < 0) & (idx >= -halo)
    reads_before[b] = bool(before.any())
    if seed is not None:
        buf[before] = widen(seed[halo + idx[before]])
    p, _ = block_prefix(buf, g, g.lead_frames + g.tile_frames)
    t = np.arange(min(tile, n - t0))
    wsum = (p[lead + t] - p[lead + t - halo]).view(np.int32).astype(np.int64)
    y[t0 + t] = np.where(wsum >= 0, wsum // window, -((-wsum) // window)).astype(np.int16)
    writes[t0 + t] += 1


def emulate_fused_ring(shards, window, channels, tile_samples):
    """Every rank's two launches; returns the outputs and each rank's split."""
    halo = window * channels
    outs, splits = [], []
    for d, xs in enumerate(shards):
        g, head, blocks = fused_ring_split(xs.size, window, channels, tile_samples)
        y = np.zeros(xs.size, np.int16)
        writes = np.zeros(xs.size, np.int64)
        reads_before = {}
        for b in range(head, blocks):  # interior launch, no seed
            emulate_block(xs, None, g, window, b, y, writes, reads_before)
        seed = shards[d - 1][-halo:] if d > 0 else None  # the put's payload; rank 0: null
        for b in range(head):
            emulate_block(xs, seed, g, window, b, y, writes, reads_before)
        np.testing.assert_array_equal(writes, 1)  # every output written exactly once
        assert not any(reads_before[b] for b in range(head, blocks))
        assert all(reads_before[b] for b in range(head))  # head = windows reaching before
        assert head == sum(1 for b in range(blocks) if b * g.tile_samples < halo)
        outs.append(y)
        splits.append((head, blocks))
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
    assert ps.windowed_supported(window, channels, tile_samples)
    x = make_interleaved(rng, 4 * shard_frames, channels)
    shards = np.split(x, 4)
    got, splits = emulate_fused_ring(shards, window, channels, tile_samples)
    np.testing.assert_array_equal(got, moving_average_golden(x, window, channels))
    assert splits[0] == splits[-1]  # equal shards: one split on every rank


def test_fused_ring_split_counts():
    # 8192-sample tiles (TILE_SAMPLES) at k=1024, C=2: the halo of 2048 samples
    # reaches into block 0 only; a 64M stream in 4 shards has 2048 blocks a shard
    g, head, blocks = fused_ring_split(16 * 2**20, 1024, 2)
    assert g.tile_samples == ps.TILE_SAMPLES and (head, blocks) == (1, 2048)
    assert fused_ring_split(2048, 1024, 2)[1:] == (1, 1)  # the whole shard is the head
    g, head, blocks = fused_ring_split(4096, 1000, 1, 256)
    assert (head, blocks) == (4, 16)


def emulate_packed_seeded(x, window, channels, seed):
    """B2's blocks: word loads, the seed's words before the stream (its lead)."""
    g = ps.packed_geometry(window, channels)
    n, tile = x.size, g.tile_samples
    halo, lead = window * channels, g.lead_frames * channels
    assert seed.size == lead and lead % 2 == 0 and tile % 2 == 0
    out = np.empty(n, np.int16)
    for b in range(g.blocks(n)):
        t0 = b * tile
        idx = np.arange(t0 - lead, t0 + tile)
        buf = np.zeros(idx.size, np.uint32)
        inside = (idx >= 0) & (idx < n)
        buf[inside] = widen(x[idx[inside]])
        before = idx < 0  # start >= -lead: every position before the stream is seeded
        buf[before] = widen(seed[lead + idx[before]])
        p, _ = block_prefix(buf, g, g.lead_frames + g.tile_frames)
        t = np.arange(min(tile, n - t0))
        wsum = (p[lead + t] - p[lead + t - halo]).view(np.int32).astype(np.int64)
        out[t0 + t] = np.where(wsum >= 0, wsum // window, -((-wsum) // window))
    return out


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
