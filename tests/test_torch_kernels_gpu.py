"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Skipped without a CUDA device. On a machine with one (JAX is not needed):

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -q

``--noconftest`` keeps pytest from loading ``tests/conftest.py``, which sets
up JAX for the other tests.
"""

import numpy as np
import pytest
import torch

from digital_signal_processsing_tpu_torch.golden import moving_average_golden
from digital_signal_processsing_tpu_torch.ops import moving_average
from digital_signal_processsing_tpu_torch.ops import pallas_direct as pd
from digital_signal_processsing_tpu_torch.ops import pallas_scan as ps
from digital_signal_processsing_tpu_torch.ops.direct_xla import moving_average_reduce_window
from digital_signal_processsing_tpu_torch.ops.scan_xla import cumsum_ref, moving_average_xla
from digital_signal_processsing_tpu_torch.ops.streaming import (
    moving_average_chunk,
    moving_average_init,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def stream(dev, frames, channels, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(-32768, 32768, size=frames * channels, dtype=np.int16)
    return torch.from_numpy(x).to(dev)


@pytest.mark.parametrize("frames", [1, 127, 129, 20001])
@pytest.mark.parametrize("channels", [1, 2, 3, 16])
@pytest.mark.parametrize("window", [1, 16, 1024])
def test_windowed_matches_plain(dev, window, channels, frames):
    x = stream(dev, frames, channels)
    before = ps.windowed_averager.launches
    got = ps.windowed_averager(x, window, channels)
    assert ps.windowed_averager.launches == before + 1
    assert torch.equal(got, moving_average_xla(x, window, channels))


@pytest.mark.parametrize("frames", [2, 128, 130, 20002])
@pytest.mark.parametrize("channels", [1, 2, 3, 16])
@pytest.mark.parametrize("window", [1, 16, 1023])
def test_packed_matches_plain(dev, window, channels, frames):
    # B2 is one launch of B1's kernel on the int16 view, counted as B2 only
    x = stream(dev, frames, channels)
    b1, b2 = ps.windowed_averager.launches, ps.windowed_averager_packed.launches
    got = ps.windowed_averager_packed(x.view(torch.int32), window, channels)
    assert ps.windowed_averager_packed.launches == b2 + 1
    assert ps.windowed_averager.launches == b1
    assert torch.equal(got.view(torch.int16), moving_average_xla(x, window, channels))


@pytest.mark.parametrize("window,channels,word_offset", [(5, 3, 0), (1023, 3, 1), (15, 1, 2),
                                                         (7, 5, 3), (1024, 2, 1)])
def test_packed_seeded_odd_halo(dev, window, channels, word_offset):
    # seeded at odd k*C (a seed of k + 1 frames, the first skipped) and on views off
    # the 16-byte grid: one B2 launch, no B1 launch, bit-exact with plain
    words = ps.packed_seed_words(window, channels)
    frames = 2 * 20001
    x = stream(dev, 2 * words // channels + frames + 8, channels)
    x32 = x[: 2 * words + frames * channels + 8].view(torch.int32)
    seed, body = x32[:words], x32[words + word_offset : words + word_offset + frames * channels // 2]
    b1, b2 = ps.windowed_averager.launches, ps.windowed_averager_packed.launches
    got = ps.windowed_averager_packed(body, window, channels, seed=seed)
    assert ps.windowed_averager_packed.launches == b2 + 1
    assert ps.windowed_averager.launches == b1
    ext = torch.cat([seed.view(torch.int16), body.view(torch.int16)])
    want = moving_average_xla(ext, window, channels)[2 * words :]
    assert torch.equal(got.view(torch.int16), want)


@pytest.mark.parametrize("frames", [1, 127, 8193, 300001])
@pytest.mark.parametrize("channels", [1, 2, 3, 16])
def test_cumsum_matches_plain(dev, channels, frames):
    x = stream(dev, frames, channels)
    assert torch.equal(ps.cumsum(x, channels), cumsum_ref(x, channels))


@pytest.mark.parametrize("channels", [5, 17, 4099, 20000])
def test_cumsum_generic_channels(dev, channels):
    # the generic kernel: tiles of whole frames, one look-back thread a channel
    x = stream(dev, max(3, 2_000_000 // channels), channels)
    assert torch.equal(ps.cumsum(x, channels), cumsum_ref(x, channels))


def test_cumsum_largest_channels(dev):
    # the largest C B4 takes: the generic kernel's tile of one frame fills the
    # 227 KB a block may have
    c = 16384
    while ps.cumsum_supported(c + 1):
        c += 1
    x = stream(dev, 37, c)
    assert torch.equal(ps.cumsum(x, c), cumsum_ref(x, c))


@pytest.mark.parametrize("channels", [1, 3, 16])
def test_cumsum_views_and_repeats(dev, channels):
    # views 2 to 14 bytes off the 16-byte grid (sample-by-sample loads), and
    # repeated calls over far more tiles than resident blocks: bit-identical
    x = stream(dev, 300_001, channels)
    buf = torch.cat([torch.zeros(8, dtype=torch.int16, device=dev), x])
    for off in range(1, 8):
        view = buf[off : off + x.numel()]
        assert torch.equal(ps.cumsum(view, channels), cumsum_ref(view, channels)), off
    first = ps.cumsum(x, channels)
    assert torch.equal(first, cumsum_ref(x, channels))
    for _ in range(3):
        assert torch.equal(ps.cumsum(x, channels), first)


def test_cumsum_wraps_like_int32(dev):
    x = torch.full((1 << 20,), 32767, dtype=torch.int16, device=dev)
    want = (np.arange(1, (1 << 20) + 1, dtype=np.int64) * 32767).astype(np.int32)
    assert np.array_equal(ps.cumsum(x, 1).cpu().numpy(), want)


@pytest.mark.parametrize("window,channels", [(65535, 1), (65535, 16), (2000, 16)])
def test_two_pass_matches_plain(dev, window, channels):
    x = stream(dev, 70000, channels)
    got = ps.moving_average_two_pass(x, window, channels)
    assert torch.equal(got, moving_average_xla(x, window, channels))


@pytest.mark.parametrize("window,channels", [(65535, 1), (1024, 16), (3, 3)])
def test_int16_min(dev, window, channels):
    x = torch.full((100000 * channels,), -32768, dtype=torch.int16, device=dev)
    want = torch.from_numpy(moving_average_golden(x.cpu().numpy(), window, channels))
    assert torch.equal(moving_average(x, window, channels).cpu(), want)


@pytest.mark.parametrize("offset", [1, 3, 7])
@pytest.mark.parametrize("window,channels", [(1024, 2), (100, 3), (1, 1)])
def test_windowed_misaligned_views(dev, window, channels, offset):
    # a view off the 16-byte grid takes B1's loads sample by sample: the same output
    base = stream(dev, 70001 + offset, channels)
    x = base[offset * channels :]
    assert x.data_ptr() % 16 != 0
    assert torch.equal(ps.windowed_averager(x, window, channels), moving_average_xla(x, window, channels))


@pytest.mark.parametrize("seeded", [False, True])
def test_windowed_range_split(dev, seeded):
    # the range entry: tiles [0, b) and [b, tiles) in two launches, at every b
    window, channels = 3000, 3
    x = stream(dev, 9 * 8192 // 3 - 5, channels)
    seed = stream(dev, window, channels, seed=1) if seeded else None
    full = ps.windowed_averager(x, window, channels, seed=seed)
    tiles = ps.windowed_geometry(window, channels).tiles(x.numel())
    for b in range(1, tiles):
        y = torch.empty_like(x)
        for lo, hi in ((b, tiles), (0, b)):
            err = ps.launch_windowed_range(x, y, window, channels,
                                           None if seed is None else seed.data_ptr(), lo, hi,
                                           torch.cuda.current_stream().cuda_stream)
            assert err == 0
        assert torch.equal(y, full), b


def test_seeded_matches_suffix(dev):
    window, channels = 1024, 2
    x = stream(dev, 50000, channels)
    cut = 20000 * channels
    seed = x[cut - window * channels : cut]
    got = ps.windowed_averager(x[cut:], window, channels, seed=seed)
    assert torch.equal(got, moving_average_xla(x, window, channels)[cut:])


def test_streaming_on_the_card(dev):
    window, channels = 300, 2
    x = stream(dev, 100000, channels)
    state = moving_average_init(window, channels, device=dev)
    outs, i = [], 0
    for ln in [4096, 1000, 2, 0, 70000, 124902]:
        state, y = moving_average_chunk(state, x[i : i + ln], window, channels)
        outs.append(y)
        i += ln
    assert torch.equal(torch.cat(outs), moving_average_xla(x, window, channels))


def largest_scan_window(channels, variant):
    return max(k for k in range(1, 16385) if k * channels <= 16384 and ps.scan_supported(k, channels, variant))


SCAN_CASES = [(v, c) for v in ps.SCAN_VARIANTS for c in (1, 2, 3, 5, 8, 16, 32) if v != "mxu" or 16 % c == 0]


@pytest.mark.parametrize("frames", [1, 127, 129, 20001])
@pytest.mark.parametrize("window", [1, 16, 1024, "largest"])
@pytest.mark.parametrize("variant,channels", SCAN_CASES)
def test_scan_matches_plain(dev, variant, channels, window, frames):
    if window == "largest":
        window = largest_scan_window(channels, variant)
    if not ps.scan_supported(window, channels, variant):
        window = largest_scan_window(channels, variant)
    x = stream(dev, frames, channels)
    before = ps.scan_averager.launches[variant]
    got = ps.scan_averager(x, window, channels, variant=variant)
    assert ps.scan_averager.launches[variant] == before + 1
    assert torch.equal(got, moving_average_xla(x, window, channels))


@pytest.mark.parametrize("variant", list(ps.SCAN_VARIANTS))
@pytest.mark.parametrize("window,channels", [(1024, 2), (255, 16), (7, 1)])
def test_scan_spans_and_int16_min(dev, variant, window, channels):
    # many spans of many tiles (span boundaries fall inside windows), then INT16_MIN
    x = stream(dev, (1 << 20) + 3, channels)
    assert torch.equal(
        ps.scan_averager(x, window, channels, variant=variant), moving_average_xla(x, window, channels)
    )
    x = torch.full(((1 << 18) * channels,), -32768, dtype=torch.int16, device=dev)
    assert torch.equal(
        ps.scan_averager(x, window, channels, variant=variant), moving_average_xla(x, window, channels)
    )


@pytest.mark.parametrize("variant", ["blelloch", "hillis_steele"])
@pytest.mark.parametrize("window,channels", [(1024, 3), (3000, 3), (99, 17), (1, 6)])
def test_scan_generic_spans_and_int16_extremes(dev, variant, window, channels):
    # the generic kernel: spans of several tiles, then INT16_MIN and INT16_MAX
    x = stream(dev, (1 << 20) + 3, channels)
    assert torch.equal(
        ps.scan_averager(x, window, channels, variant=variant), moving_average_xla(x, window, channels)
    )
    for v in (-32768, 32767):
        x = torch.full(((1 << 18) * channels,), v, dtype=torch.int16, device=dev)
        assert torch.equal(
            ps.scan_averager(x, window, channels, variant=variant), moving_average_xla(x, window, channels)
        )


def test_scan_mxu_refuses_three_channels(dev):
    with pytest.raises(ValueError, match="16-sample rows"):
        ps.scan_averager(stream(dev, 100, 3), 4, 3, variant="mxu")


@pytest.mark.parametrize("method", ["scan", "scan_hillis", "scan_mxu"])
def test_scan_methods_route(dev, method):
    x = stream(dev, 30000, 16)
    assert torch.equal(moving_average(x, 65535, 16, method=method), moving_average_xla(x, 65535, 16))


def test_scan_kernel_attrs(dev):
    """Every B3 instance the wrapper picks holds the geometry's shared bytes and
    fits at least one block an SM at the largest ring ``scan_supported`` takes
    (its spans are sized by the blocks this reports); at the main path's
    k=1024, C=2, four."""
    for variant in ps.SCAN_VARIANTS:
        for channels in (1, 2, 3, 4, 8, 16):
            if variant == "mxu" and 16 % channels:
                continue
            for window in (1, 1024 // channels, largest_scan_window(channels, variant)):
                g = ps.scan_geometry(window, channels, variant)
                regs, local, smem, blocks = ps.scan_kernel_attrs(window, channels, variant)
                assert smem >= g.smem_bytes and blocks >= 1, (variant, channels, window)
                assert regs <= 80, (variant, channels, regs)
        assert ps.scan_kernel_attrs(1024, 2, variant)[3] == 4, variant


@pytest.mark.parametrize("frames", [1, 127, 129, 20001])
@pytest.mark.parametrize("channels", [1, 2, 3, 16])
@pytest.mark.parametrize("window", [1, 15, 16, 17, 64, 255, 256])
def test_direct_matches_plain(dev, window, channels, frames):
    x = stream(dev, frames, channels)
    before = pd.direct_averager.launches
    got = pd.direct_averager(x, window, channels)
    assert pd.direct_averager.launches == before + 1
    assert torch.equal(got, moving_average_reduce_window(x, window, channels))


@pytest.mark.parametrize("window,channels", [(256, 1), (64, 16), (3, 3)])
def test_direct_int16_min(dev, window, channels):
    x = torch.full((100000 * channels,), -32768, dtype=torch.int16, device=dev)
    want = torch.from_numpy(moving_average_golden(x.cpu().numpy(), window, channels))
    assert torch.equal(pd.direct_averager(x, window, channels).cpu(), want)


@pytest.mark.parametrize("tile_rows", [16, 64])
def test_tile_samples_matches_plain(dev, tile_rows):
    # the sweep's tile axis and the CLI's block size: tile_rows * 128 samples
    x = stream(dev, 100003, 2)
    tile = tile_rows * 128
    want = moving_average_xla(x, 255, 2)
    assert torch.equal(ps.windowed_averager(x, 255, 2, tile_samples=tile), want)
    for variant in ps.SCAN_VARIANTS:
        assert torch.equal(ps.scan_averager(x, 255, 2, variant=variant, tile_samples=tile), want)
    assert torch.equal(pd.direct_averager(x, 255, 2, tile_samples=tile), want)


def test_direct_kernel_attrs(dev):
    # no local memory: every index into a thread's sums folds to a constant
    for window in (1, 15, 64, 256):
        for channels in (1, 2, 3):
            regs, local, smem, blocks = pd.direct_kernel_attrs(window, channels)
            assert local == 0 and 0 < regs <= 255 and blocks >= 1
            assert smem >= pd.direct_geometry(window, channels).smem_bytes
