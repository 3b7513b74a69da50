"""The CUDA kernels' block algorithm, emulated in NumPy with the wrappers' geometry.

The kernels of ``digital_signal_processsing_tpu_torch/csrc`` only run on a
card. Their arithmetic is kept testable here: each function below does what
the kernel's blocks do with the geometry that ``ops/pallas_scan.py`` passes
to the launch, and must give the golden result bit for bit. B1 is
``csrc/run_tile.cuh``'s span kernel (``tests/test_torch_scan.py``'s
``emulate_scan`` with B1's geometry: each span's seed tiles from x or the
seed, every thread's runs of 8 and their 16-byte or sample-by-sample loads
and stores, the Hillis-Steele levels, the ring, any range of tiles); B2 is
B1's launch over the int16 view of the int32 pair words, seeded from the last
H samples of the pair-word seed. B4 (``emulate_cumsum``) is B3's tile from
carry 0 for C in 1, 2, 4, 8, 16 (``block_prefix.cuh``'s segments over a tile
of whole frames for any other C), and the carry between tiles by its
decoupled look-back: persistent
blocks taking tickets when ready, status words published and read back in
batches, tiles advancing in a shuffled order.
"""

import numpy as np
import pytest
import torch

from digital_signal_processsing_tpu.ops.pallas_scan import cumsum_pallas
from digital_signal_processsing_tpu_torch.golden import (
    cumsum_per_channel_golden,
    moving_average_golden,
)
from digital_signal_processsing_tpu_torch.ops import pallas_scan as ps
from tests.conftest import make_interleaved
from tests.test_torch_scan import H100_SMS, LANE, RUN, WARPS, emulate_scan, tile_prefix


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
    counts), or B2's with ``packed``: the same launch over the int16 view of
    the pair words ``x.view(np.int32)``, its ``seed`` the int16 view of the
    ``packed_seed_words`` words before them, of which the launch reads the
    last H samples (skipping the first C where k*C is odd)."""
    g = ps.windowed_geometry(window, channels)
    if packed:
        assert ps.packed_supported(window, channels) == ps.windowed_supported(window, channels)
        x = x.view(np.int32).view(np.int16)  # the words' int16 view: the same samples
        if seed is not None:
            words = ps.packed_seed_words(window, channels)
            assert seed.size == 2 * words and 0 <= 2 * words - g.halo < 2 * channels
            seed = seed.view(np.int32).view(np.int16)[2 * words - g.halo :]
    return emulate_scan(x, window, channels, None, g=g, seed=seed, resident=resident, **launch)


B4_BATCH = 8  # kBatch of csrc/cumsum.cu: status words a generic look-back loads at once
AGG, INCL = 1, 2  # the status words' flags (0: not yet published)


def b4_tile(x, t, channels, aligned, stats):
    """Tile t's in-tile prefix from carry 0 and its per-channel totals, as B4's block
    computes them: (prefix at each position, totals (C,), positions, each position's
    channel). Instances (C in 1, 2, 4, 8, 16): each thread's runs of 8, loaded 16 bytes
    at a time where the tile lies inside the stream and x is aligned, else run by run
    and sample by sample, stored as two 16-byte words a run where y is aligned; B3's
    Hillis-Steele tile (run_tile.cuh steps 2-4). Any other C: the tile of whole frames
    in shared memory, block_prefix.cuh's segments."""
    n = x.size
    if ps.cumsum_kernel_c(channels):
        tile = ps.cumsum_tile_samples(channels)
        assert tile == ps.THREADS * ps.SCAN_RUNS * RUN
        nq = ps.SCAN_RUNS
        run = (np.arange(WARPS)[:, None, None] * nq + np.arange(nq)[None, :, None]) * 32 + LANE
        pos = t * tile + run[..., None] * RUN + np.arange(RUN)
        p0 = t * tile + run * RUN
        whole = aligned and t * tile + tile <= n
        vec = whole | (aligned & (p0 + RUN <= n))
        assert (p0 % RUN == 0).all() and (p0[vec] + RUN <= n).all()
        stats["vector loads"] = stats.get("vector loads", 0) + int(vec.sum())
        stats["scalar loads"] = stats.get("scalar loads", 0) + int((~vec & (p0 < n)).sum())
        stats["vector stores"] = stats.get("vector stores", 0) + int((aligned & (p0 + RUN <= n)).sum())
        v = np.where(pos < n, x[np.clip(pos, 0, n - 1)], 0).astype(np.int32).view(np.uint32)
        totals = np.zeros(channels, np.uint32)
        cum = tile_prefix(v, ps.scan_geometry(1, channels, "hillis_steele"), None, totals)
        return cum.ravel(), totals, pos.ravel(), pos.ravel() % channels
    g = ps.cumsum_geometry(channels)
    tile = g.tile_samples
    assert tile == ps.cumsum_tile_samples(channels) and g.smem_bytes <= ps.SMEM_MAX
    buf = np.zeros(tile, np.uint32)
    chunk = x[t * tile : (t + 1) * tile]
    buf[: chunk.size] = widen(chunk)
    stats["scalar loads"] = stats.get("scalar loads", 0) + chunk.size
    cum, totals = block_prefix(buf, g, g.tile_frames)
    pos = t * tile + np.arange(tile)
    return cum, totals, pos, np.arange(tile) % channels


def emulate_cumsum(x, channels, *, resident=4 * H100_SMS, order=0, aligned=True, stats=None):
    """B4's launch (csrc/cumsum.cu) over the wrapper's geometry: ``resident``
    persistent blocks, each taking the next ticket when it is ready to start a tile
    (tiles start in ticket order); the tile's prefix and totals (``b4_tile``); its
    totals published as each channel's status word (tile 0 as inclusive prefixes);
    then the look-back: for C in 1, 2, 4, 8, 16 the block's rounds (its threads read
    256 / C tiles of every open channel at once, spin on words not yet published,
    then at the round's barrier each channel sums its words up to the shallowest
    inclusive prefix), for any other C a thread a channel (B4_BATCH words read at
    once, walked newest first, spinning, adding aggregates until an inclusive
    prefix); the inclusive prefixes published; the tile stored with its carry.
    Every step of every block is one step of a scheduler that picks a block at
    random (``order`` seeds it), so tiles finish in shuffled orders. ``stats``
    counts loads, stores, spins, rounds, the aggregates the look-backs added and
    the depths at which they met an inclusive prefix."""
    n = x.size
    tile = ps.cumsum_tile_samples(channels)
    tiles = -(-n // tile)
    assert ps.cumsum_status_words(n, channels) == 1 + tiles * channels
    flag = np.zeros((tiles, channels), np.int64)
    val = np.zeros((tiles, channels), np.uint32)
    out = np.zeros(n, np.uint32)
    written = np.zeros(n, np.int64)
    stats = {} if stats is None else stats
    stats.setdefault("depths", set())
    ticket = [0]

    def read(t, c):
        return (INCL, 0) if t < 0 else (int(flag[t, c]), int(val[t, c]))

    def look_back(t, c, ex):
        acc, t1 = 0, t - 1
        while True:
            w = [read(t1 - k, c) for k in range(B4_BATCH)]  # in flight together
            yield
            for k in range(B4_BATCH):
                while w[k][0] == 0:
                    stats["spins"] = stats.get("spins", 0) + 1
                    yield
                    w[k] = read(t1 - k, c)
                acc = (acc + w[k][1]) % 2**32
                if w[k][0] == INCL:
                    stats["depths"].add(t - (t1 - k))
                    ex[c] = acc
                    return
                stats["aggregates"] = stats.get("aggregates", 0) + 1
            t1 -= B4_BATCH

    def block_rounds(t, ex):
        depth = ps.THREADS // channels  # tiles a round
        open_, r = set(range(channels)), 0
        while open_:
            stats["rounds"] = stats.get("rounds", 0) + 1
            at = {(c, j): t - 1 - j - r * depth for c in open_ for j in range(depth)}
            words = {k: read(pt, k[0]) for k, pt in at.items()}  # in flight together
            yield
            while any(w[0] == 0 for w in words.values()):  # each thread spins on its own
                stats["spins"] = stats.get("spins", 0) + sum(w[0] == 0 for w in words.values())
                yield
                words = {k: w if w[0] else read(at[k], k[0]) for k, w in words.items()}
            for c in sorted(open_):  # the round's barrier: every channel's shallowest inclusive
                incl = [j for j in range(depth) if words[c, j][0] == INCL]
                first = min(incl) if incl else depth
                ex[c] = (int(ex[c]) + sum(words[c, j][1] for j in range(min(first + 1, depth)))) % 2**32
                stats["aggregates"] = stats.get("aggregates", 0) + min(first, depth)
                if incl:
                    stats["depths"].add(first + 1 + r * depth)
                    open_.discard(c)
            r += 1

    def block():
        while True:
            t = ticket[0]
            ticket[0] += 1
            if t >= tiles:
                return
            yield  # the loads in flight
            cum, totals, pos, chan = b4_tile(x, t, channels, aligned, stats)
            flag[t], val[t] = (INCL if t == 0 else AGG), totals
            yield
            ex = np.zeros(channels, np.uint32)
            if t > 0 and ps.cumsum_kernel_c(channels):
                yield from block_rounds(t, ex)
                flag[t], val[t] = INCL, ex + totals
            elif t > 0:
                walks = [look_back(t, c, ex) for c in range(channels)]
                while walks:
                    walks = [w for w in walks if next(w, StopIteration) is not StopIteration]
                    if walks:
                        yield
                flag[t], val[t] = INCL, ex + totals
            yield
            keep = pos < n
            out[pos[keep]] = (cum + ex[chan])[keep]
            written[pos[keep]] += 1

    rng = np.random.default_rng(order)
    blocks = [block() for _ in range(min(resident, tiles))]
    steps = 0
    while blocks:
        i = int(rng.integers(len(blocks)))
        if next(blocks[i], StopIteration) is StopIteration:
            blocks.pop(i)
        steps += 1
        assert steps < 10_000_000, "the look-back did not end"
    assert (written == 1).all() and (flag == INCL).all()
    # the last tile's inclusive prefixes are the stream's per-channel totals
    assert np.array_equal(val[-1][np.arange(n - channels, n) % channels], out[n - channels :])
    return out.view(np.int32)


@pytest.mark.parametrize(
    "window,channels,frames",
    [(1, 1, 20000), (16, 2, 9000), (1024, 2, 12289), (1024, 16, 1500), (16384, 1, 30001),
     (7, 3, 5000), (100, 5, 4000), (3, 128, 200), (1, 4096, 3),
     (10118, 2, 9000), (1070, 16, 1500)],  # the largest windows of B2's former two-block bound
)
def test_windowed_block_algorithm(rng, window, channels, frames):
    x = make_interleaved(rng, frames, channels)
    want = moving_average_golden(x, window, channels)
    np.testing.assert_array_equal(emulate_windowed(x, window, channels), want)
    np.testing.assert_array_equal(emulate_windowed(x, window, channels, resident=2), want)  # spans
    if x.size % 2 == 0:
        np.testing.assert_array_equal(emulate_windowed(x, window, channels, packed=True), want)


@pytest.mark.parametrize(
    "window,channels,word_offset",
    [(5, 3, 0), (7, 3, 1), (1023, 5, 2), (15, 1, 1), (1024, 2, 1), (1024, 2, 2), (16, 16, 2),
     (3, 3, 3), (24828, 2, 1), (3103, 16, 2)],  # odd k*C (lead = k + 1), views off the grid
)
def test_packed_block_algorithm_seeded(rng, window, channels, word_offset):
    """B2 seeded: B1's launch over the words' int16 view from the seed's last H
    samples, at odd k*C (a seed of k + 1 frames) and on views whose word offset
    leaves them off the 16-byte grid (every access sample by sample); the plain
    wrapper on the same views."""
    words = ps.packed_seed_words(window, channels)
    frames = 2 * (window // 2 + 4100 // channels)  # an even sample count for every C
    x = make_interleaved(rng, 2 * words // channels + frames, channels)
    seed, body = x[: 2 * words], x[2 * words :]
    want = moving_average_golden(x, window, channels)[2 * words :]
    stats = {}
    aligned = word_offset % 4 == 0
    got = emulate_windowed(body, window, channels, seed=seed, packed=True, resident=3,
                           aligned=aligned, stats=stats)
    np.testing.assert_array_equal(got, want)
    assert bool(stats["vector loads"]) == aligned
    buf = torch.zeros(word_offset + body.size // 2, dtype=torch.int32)  # a view off the grid
    view = buf[word_offset:]
    view.copy_(torch.from_numpy(body.copy()).view(torch.int32))
    assert (view.data_ptr() % 16 == 0) == aligned
    plain = ps.windowed_averager_packed(view, window, channels,
                                        seed=torch.from_numpy(seed.copy()).view(torch.int32))
    np.testing.assert_array_equal(plain.view(torch.int16).numpy(), want)


@pytest.mark.parametrize("window,channels,words", [(16, 2, 16), (5, 3, 9), (1, 1, 1), (15, 3, 24),
                                                   (1023, 2, 1023), (700, 2, 700), (7, 16, 56)])
def test_packed_seed_words(window, channels, words):
    """The sharded packed route's halo: k*C samples as words, a frame more where k*C is odd."""
    assert ps.packed_seed_words(window, channels) == words


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


@pytest.mark.parametrize(
    "channels,frames",
    [(1, 50001), (2, 20000), (3, 9000), (16, 3000), (5, 7001), (17, 1001), (128, 300),
     (4099, 7), (20000, 3), (1, 8192), (16, 100), (8, 1)],  # one tile, partial tiles
)
def test_cumsum_block_algorithm(rng, channels, frames):
    x = make_interleaved(rng, frames, channels)
    want = cumsum_per_channel_golden(x, channels).astype(np.int32)
    got = emulate_cumsum(x, channels, resident=3)
    np.testing.assert_array_equal(got, want)
    if 128 % channels == 0:  # the channel counts the JAX kernel takes
        np.testing.assert_array_equal(got, np.asarray(cumsum_pallas(x, channels)))


@pytest.mark.parametrize("channels", [1, 3, 16])
def test_cumsum_block_algorithm_wraps(channels):
    x = np.full(3 * ps.TILE_SAMPLES * 11 // channels * channels, 32767, np.int16)
    want = cumsum_per_channel_golden(x, channels).astype(np.int32)
    np.testing.assert_array_equal(emulate_cumsum(x, channels, resident=5), want)
    if 128 % channels == 0:
        np.testing.assert_array_equal(want, np.asarray(cumsum_pallas(x, channels)))


@pytest.mark.parametrize(
    "channels,resident,deeper",
    [(1, 64, 0), (2, 7, 0), (16, 1, 0), (16, 64, 16), (8, 100, 32), (5, 33, B4_BATCH)],
)
def test_cumsum_look_back_in_any_order(rng, channels, resident, deeper):
    """120 tiles finishing in shuffled orders, one resident block to many: the same
    bits every time; with many blocks the look-backs meet inclusive prefixes at
    several depths, past a round of the block's loads (``deeper``: 256 / C tiles)
    or a batch of a generic thread's, add aggregates and spin on words not yet
    published."""
    x = make_interleaved(rng, 120 * 8192 // channels, channels)
    want = cumsum_per_channel_golden(x, channels).astype(np.int32)
    stats = {}
    for order in range(3):
        np.testing.assert_array_equal(
            emulate_cumsum(x, channels, resident=resident, order=order, stats=stats), want)
    if resident == 1:
        assert stats["depths"] == {1} and "spins" not in stats
    else:
        assert {1, 2, 3} <= stats["depths"] and stats["aggregates"] > 0 and stats["spins"] > 0
    if deeper:
        assert max(stats["depths"]) > deeper


@pytest.mark.parametrize("channels,frames", [(1, 8 * 4096 + 7), (2, 20003), (16, 1025), (3, 5461)])
def test_cumsum_runs_and_edges(rng, channels, frames):
    """B4's loads and stores: 16 bytes a run inside the stream, run by run and sample
    by sample at its ragged end, every load of a misaligned view sample by sample
    (the generic kernel's always); the same output either way. The plain wrapper
    takes the misaligned view too."""
    x = make_interleaved(rng, frames, channels)
    want = cumsum_per_channel_golden(x, channels).astype(np.int32)
    aligned, misaligned = {}, {}
    np.testing.assert_array_equal(emulate_cumsum(x, channels, resident=4, stats=aligned), want)
    np.testing.assert_array_equal(
        emulate_cumsum(x, channels, resident=4, aligned=False, stats=misaligned), want)
    if ps.cumsum_kernel_c(channels):
        assert aligned["vector loads"] and aligned["vector stores"]
        assert bool(aligned["scalar loads"]) == (x.size % RUN != 0)  # a partial run at the end
        assert misaligned["vector loads"] == misaligned["vector stores"] == 0
    else:
        assert "vector loads" not in aligned
    buf = np.concatenate([np.zeros(1, np.int16), x])
    view = torch.from_numpy(buf)[1:]
    assert view.data_ptr() % 16 != 0
    np.testing.assert_array_equal(ps.cumsum(view, channels).numpy(), want)


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
        g = ps.cumsum_geometry(channels)
        nf = g.tile_frames
        assert g.seg_frames % 2 == 1
        assert (g.segs - 1) * g.seg_frames < nf <= g.segs * g.seg_frames
        assert g.segs * channels <= max(ps.SEG_ITEMS, channels)
        assert g.tile_samples >= ps.TILE_SAMPLES
        # B2 is B1's launch: its seed holds the halo in whole words, at most a frame more
        words = ps.packed_seed_words(window, channels)
        assert 0 <= 2 * words - window * channels < 2 * channels
        assert ps.packed_supported(window, channels) == ps.windowed_supported(window, channels)
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
    # B2, B1's launch on the pair words' int16 view, takes the same bound
    for c, k in [(1, 49656), (2, 24828), (3, 16040), (16, 3103)]:
        assert ps.windowed_supported(k, c) and ps.packed_supported(k, c)
        assert not ps.windowed_supported(k + 1, c) and not ps.packed_supported(k + 1, c)
    assert ps.windowed_supported(10119, 2) and ps.windowed_supported(1071, 16)
    assert ps.packed_supported(10119, 2) and ps.packed_supported(1071, 16)
    assert not ps.windowed_supported(65535, 1)
    assert not ps.windowed_supported(0, 1)
