"""The port's direct averager (B5) and the two plain anchors against the JAX package.

``direct``, ``xla_scan`` and ``xla_direct`` go through the JAX package (the
direct Pallas kernel in interpret mode on the CPU) and through the port on
the CPU with the same NumPy input; bit-exact. ``emulate_direct`` does what
a block of ``csrc/direct.cu`` does, with the geometry
``ops/pallas_direct.py`` passes to the launch.
"""

import numpy as np
import pytest
import torch

from digital_signal_processsing_tpu.ops import moving_average as jax_moving_average
from digital_signal_processsing_tpu_torch.golden import moving_average_golden
from digital_signal_processsing_tpu_torch.ops import (
    MAX_DIRECT_WINDOW,
    direct_averager,
    moving_average,
    moving_average_reduce_window,
)
from digital_signal_processsing_tpu_torch.ops import pallas_direct as pd
from digital_signal_processsing_tpu_torch.utils import last_choice
from tests.conftest import make_interleaved

WINDOWS = [1, 3, 16, 500, 5000]
CHANNELS = [1, 2, 3, 16]


def port(x: np.ndarray, window: int, channels: int, method: str) -> np.ndarray:
    return moving_average(torch.from_numpy(x), window, channels, method=method).numpy()


@pytest.mark.parametrize("channels", CHANNELS)
@pytest.mark.parametrize("window", [w for w in WINDOWS if w <= MAX_DIRECT_WINDOW])
def test_direct_matches_jax(rng, window, channels):
    x = make_interleaved(rng, 1000, channels)
    got = port(x, window, channels, "direct")
    assert last_choice("moving_average") == "direct"
    np.testing.assert_array_equal(
        got, np.asarray(jax_moving_average(x, window, channels, method="direct"))
    )
    np.testing.assert_array_equal(got, moving_average_golden(x, window, channels))


@pytest.mark.parametrize("window", [w for w in WINDOWS if w > MAX_DIRECT_WINDOW] + [257])
def test_direct_refuses_large_windows_as_jax_does(rng, window):
    x = make_interleaved(rng, 100, 1)
    with pytest.raises(ValueError, match="direct method supports window <= 256") as port_err:
        port(x, window, 1, "direct")
    with pytest.raises(ValueError, match="direct") as jax_err:
        jax_moving_average(x, window, 1, method="direct")
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("method", ["xla_scan", "xla_direct"])
@pytest.mark.parametrize("channels", CHANNELS)
@pytest.mark.parametrize("window", WINDOWS)
def test_anchors_match_jax(rng, method, window, channels):
    x = make_interleaved(rng, 1000, channels)
    got = port(x, window, channels, method)
    assert last_choice("moving_average") == method
    np.testing.assert_array_equal(
        got, np.asarray(jax_moving_average(x, window, channels, method=method))
    )


@pytest.mark.parametrize("method", ["direct", "xla_direct", "xla_scan"])
@pytest.mark.parametrize("n", [1, 7, 127, 129, 32769])
def test_awkward_lengths(rng, method, n):
    x = rng.integers(-32768, 32768, size=n, dtype=np.int16)
    np.testing.assert_array_equal(port(x, 4, 1, method), moving_average_golden(x, 4, 1))


@pytest.mark.parametrize("method", ["direct", "xla_direct"])
def test_int16_min(method):
    x = np.full(50000, -32768, dtype=np.int16)
    want = moving_average_golden(x, 63, 1)
    np.testing.assert_array_equal(port(x, 63, 1, method), want)
    np.testing.assert_array_equal(np.asarray(jax_moving_average(x, 63, 1, method=method)), want)


def test_direct_checks(rng):
    x = torch.from_numpy(make_interleaved(rng, 100, 2))
    with pytest.raises(ValueError, match="256"):
        direct_averager(x, 300, 2)
    with pytest.raises(ValueError, match="shared memory"):
        direct_averager(torch.zeros(8192 * 4, dtype=torch.int16), 256, 8192)
    got = direct_averager(x, 9, 2, tile_samples=64).numpy()
    np.testing.assert_array_equal(got, moving_average_golden(x.numpy(), 9, 2))
    assert torch.equal(direct_averager(x, 9, 2), moving_average_reduce_window(x, 9, 2))


# ---- the block of csrc/direct.cu, in NumPy -------------------------------------


def _walk_word(u):
    """Value u of a run's walk in its plane (padded by two words a run)."""
    return (u // pd.RUN) * pd.RUN_WORDS + u % pd.RUN


def _run_sums(plane, q, k):
    """run_sums for runs q (an array) of one plane: (len(q), RUN) int64 sums, and
    the adds each output took. Pairs of values at even u, as the kernel loads them."""
    base = q * pd.RUN_WORDS
    acc = np.zeros((q.size, pd.RUN), np.int64)
    adds = np.zeros(pd.RUN, np.int64)

    def pair(u):
        assert u % 2 == 0 and _walk_word(u) % 2 == 0  # an aligned 8-byte load
        return plane[base + _walk_word(u)], plane[base + _walk_word(u) + 1]

    def add(lo, hi, v):
        acc[:, lo:hi] += v[:, None]
        adds[lo:hi] += 1

    if k >= pd.RUN:
        for u in range(0, pd.RUN, 2):  # head: value u to sums 0 .. u
            vx, vy = pair(u)
            add(0, u + 1, vx)
            add(0, u + 2, vy)
        for u in range(pd.RUN, k & ~1, 2):  # middle: every sum
            vx, vy = pair(u)
            add(0, pd.RUN, vx)
            add(0, pd.RUN, vy)
        t0 = 0
        if k & 1:  # the pair at k - 1: the middle's last value, then value k
            vx, vy = pair(k - 1)
            add(0, pd.RUN, vx)
            add(1, pd.RUN, vy)
            t0 = 1
        for tt in range(t0, pd.RUN - 1, 2):  # tail: value k + t to sums t + 1 ..
            vx, vy = pair(k + tt)
            add(tt + 1, pd.RUN, vx)
            add(tt + 2, pd.RUN, vy)
    else:
        r = np.arange(pd.RUN)
        for u in range(0, 2 * pd.RUN - 2, 2):  # every add predicated
            vx, vy = pair(u)
            for uu, v in ((u, vx), (u + 1, vy)):
                hit = (r <= uu) & (uu - r < k)
                acc[:, hit] += v[:, None]
                adds[hit] += 1
    return acc, adds


def _mean(acc, k):
    """mean_of: a multiply-high by ceil(2^32 / k), truncating toward zero."""
    assert np.abs(acc).max(initial=0) < 2**24
    if k == 1:
        return acc
    magic = ((1 << 32) + k - 1) // k
    q = (np.abs(acc) * magic) >> 32
    return np.where(acc < 0, -q, q)


def emulate_direct(x, window, channels, tile_samples=None):
    """Each block of csrc/direct.cu: the staged planes, every run's walk, the
    padded interleaved results and their stores, at DirectGeometry."""
    g = pd.direct_geometry(window, channels, tile_samples)
    n, c, k, tf = x.size, channels, window, g.tile_frames
    frames = n // c
    lead, span = k - 1, k - 1 + tf + pd.RUN
    assert tf % pd.RUN == 0 and _walk_word(span - 1) < g.plane_words
    assert g.in_words >= c * g.plane_words and g.out_words * 2 >= tf * c + 2 * g.runs
    assert g.in_words % 4 == 0 and g.out_words % 4 == 0  # the raw buffer 16-byte aligned
    assert g.smem_bytes == 4 * (g.in_words + g.out_words + g.raw_words)
    out = np.zeros(n, np.int16)
    written = np.zeros(n, np.int64)
    sentinel = np.iinfo(np.int64).min
    for b in range(g.blocks(n)):
        f0 = b * tf
        # the raw stream: 16-byte chunks from the aligned sample below the halo,
        # zeros outside the stream, within the raw buffer
        g0 = (f0 - lead) * c
        ga = g0 - g0 % 8
        chunks = -(-(g0 + span * c - ga) // 8)
        assert 8 * chunks <= 2 * g.raw_words
        gi = ga + np.arange(8 * chunks)
        raw = np.where((gi >= 0) & (gi < n), x[np.clip(gi, 0, n - 1)], 0)
        # each value to its channel's plane
        planes = np.full((c, g.plane_words), sentinel, np.int64)  # unstaged words poison the sums
        rel = np.arange(span * c) + (g0 - ga)
        fr, ch_of = np.divmod(np.arange(span * c), c)
        planes[ch_of, _walk_word(fr)] = raw[rel]
        outh = np.full(2 * g.out_words, sentinel, np.int64)
        q = np.arange(g.runs)
        for ch in range(c):
            acc, adds = _run_sums(planes[ch], q, k)
            assert (adds == k).all()  # every output: exactly k adds
            i = (q[:, None] * pd.RUN + np.arange(pd.RUN)) * c + ch
            outh[i + 2 * q[:, None]] = _mean(acc, k)
        count = (min(f0 + tf, frames) - f0) * c
        e = np.arange(count)
        chunk = e // 8
        word = 4 * chunk + 4 * chunk // (8 * c)  # the 16-byte store's first word, past its pads
        got = outh[2 * word + e % 8]
        assert np.array_equal(got, outh[e + 2 * (e // (pd.RUN * c))])
        assert (got != sentinel).all()
        out[f0 * c : f0 * c + count] = got.astype(np.int16)
        written[f0 * c : f0 * c + count] += 1
    assert (written == 1).all()
    return out


@pytest.mark.parametrize(
    "window,channels,frames,tile_samples",
    [(1, 1, 20000, None), (16, 2, 9000, None), (64, 3, 5001, 1000), (256, 16, 1500, None),
     (255, 1, 30000, 4096), (200, 5, 7, None)],
)
def test_direct_block_algorithm(rng, window, channels, frames, tile_samples):
    x = make_interleaved(rng, frames, channels)
    np.testing.assert_array_equal(
        emulate_direct(x, window, channels, tile_samples), moving_average_golden(x, window, channels)
    )


def test_direct_block_algorithm_int16_min():
    x = np.full(30000, -32768, np.int16)
    for window, channels in [(256, 1), (64, 16), (3, 2)]:
        np.testing.assert_array_equal(
            emulate_direct(x, window, channels), moving_average_golden(x, window, channels)
        )


@pytest.mark.parametrize("channels", [1, 2, 3, 16])
@pytest.mark.parametrize("window", [*range(1, pd.RUN + 2), 31, 33, 63, 64, 255, 256])
def test_direct_block_every_small_window(rng, window, channels):
    # k = 1..RUN+1 (the predicated walk and both tails), k mod RUN != 0, odd and
    # even k, over C = 1, 2, 3, 16 and a ragged last tile
    x = make_interleaved(rng, 700 + window, channels)
    np.testing.assert_array_equal(
        emulate_direct(x, window, channels, tile_samples=256 * channels),
        moving_average_golden(x, window, channels),
    )


@pytest.mark.parametrize("channels", [1, 2, 16])
@pytest.mark.parametrize("u", [0, 2, 14, 16, 40, 254, 270])
def test_direct_walk_reads_fall_on_32_banks(channels, u):
    # a warp's lanes, consecutive runs of one plane, read value u of their
    # walks with 8-byte loads: each half warp's 16 lanes cover the 32 banks;
    # their int16 results land on 32 distinct banks of the padded buffer
    g = pd.direct_geometry(256, channels)
    runs = np.arange(g.runs)
    for first in range(0, g.runs - 31, 32):
        q = runs[first : first + 32]
        word = q * pd.RUN_WORDS + _walk_word(u)
        for half in (word[:16], word[16:]):
            banks = np.concatenate([half % 32, (half + 1) % 32])
            assert len(set(banks)) == 32
        for r in range(pd.RUN):
            i = (q * pd.RUN + r) * channels + 1 % channels
            assert len(set(((i + 2 * q) // 2) % 32)) == 32


@pytest.mark.parametrize("channels", [1, 2, 3, 16, 64])
def test_direct_geometry_fits_the_card(channels):
    for window in (1, 64, MAX_DIRECT_WINDOW):
        g = pd.direct_geometry(window, channels)
        assert pd.direct_supported(window, channels)
        assert g.tile_samples >= pd.TILE_SAMPLES and g.smem_bytes <= pd.SMEM_MAX
    assert not pd.direct_supported(MAX_DIRECT_WINDOW + 1, channels)
