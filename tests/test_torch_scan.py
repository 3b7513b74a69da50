"""The port's scan averager (B3) against the JAX package, golden, and its block walk.

``scan``, ``scan_hillis`` and ``scan_mxu`` go through the JAX package (its
Pallas kernel in interpret mode on the CPU) and through the port on the
CPU (the plain version) with the same NumPy input; bit-exact. The JAX
kernel needs ``channels | 128``, so at C=3 the port is held to golden.

The CUDA kernel (``csrc/scan.cu``) runs only on a card; ``emulate_scan``
below does what its blocks do, span by span and tile by tile, with the
geometry ``ops/pallas_scan.py`` passes to the launch and each variant's
in-tile scan, and must give the golden result bit for bit.
"""

import functools

import numpy as np
import pytest
import torch

from digital_signal_processsing_tpu.ops import moving_average as jax_moving_average
from digital_signal_processsing_tpu_torch.golden import moving_average_golden
from digital_signal_processsing_tpu_torch.ops import moving_average, scan_averager
from digital_signal_processsing_tpu_torch.ops import pallas_scan as ps
from digital_signal_processsing_tpu_torch.utils import cdiv, last_choice
from tests.conftest import make_interleaved

SCAN_METHODS = ["scan", "scan_hillis", "scan_mxu"]
WINDOWS = [1, 3, 16, 500, 5000]
H100_SMS = 132


def port(x: np.ndarray, window: int, channels: int, method: str) -> np.ndarray:
    return moving_average(torch.from_numpy(x), window, channels, method=method).numpy()


def jax_or_golden(x: np.ndarray, window: int, channels: int, method: str) -> np.ndarray:
    """The JAX package's same method; golden where its kernel refuses C (C does not divide 128)."""
    if 128 % channels:
        return moving_average_golden(x, window, channels)
    return np.asarray(jax_moving_average(x, window, channels, method=method))


# ---- the port against the JAX package ---------------------------------------


@pytest.mark.parametrize("channels", [1, 2, 3, 16])
@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("method", ["scan", "scan_hillis"])
def test_scan_matches_jax(rng, method, window, channels):
    x = make_interleaved(rng, 3000 if channels < 16 else 700, channels)
    got = port(x, window, channels, method)
    np.testing.assert_array_equal(got, jax_or_golden(x, window, channels, method))
    np.testing.assert_array_equal(got, moving_average_golden(x, window, channels))


@pytest.mark.parametrize("channels", [1, 2, 4])
@pytest.mark.parametrize("window", WINDOWS)
def test_scan_mxu_matches_jax(rng, window, channels):
    x = make_interleaved(rng, 3000, channels)
    got = port(x, window, channels, "scan_mxu")
    np.testing.assert_array_equal(got, jax_or_golden(x, window, channels, "scan_mxu"))
    np.testing.assert_array_equal(got, moving_average_golden(x, window, channels))


@functools.cache
def awkward_stream() -> tuple[np.ndarray, np.ndarray]:
    """70000 samples and the JAX package's ``scan`` of them at k=4, C=1."""
    x = np.random.default_rng(0xD5B).integers(-32768, 32768, size=70000, dtype=np.int16)
    return x, np.asarray(jax_moving_average(x, 4, 1, method="scan"))


@pytest.mark.parametrize("n", [1, 7, 127, 128, 129, 32768, 32769, 70000])
def test_scan_awkward_lengths(n):
    # the lengths of the JAX package's own test, around its lane and tile
    # bounds; the average is causal, so the JAX output on the whole stream
    # holds the reference for every prefix
    x, want = awkward_stream()
    got = port(x[:n], 4, 1, "scan")
    np.testing.assert_array_equal(got, want[:n])
    np.testing.assert_array_equal(got, moving_average_golden(x[:n], 4, 1))


def test_scan_multi_tile_carry(rng):
    x = make_interleaved(rng, 60000, 2)  # several of the JAX kernel's tiles
    want = moving_average_golden(x, 700, 2)
    np.testing.assert_array_equal(port(x, 700, 2, "scan"), want)
    np.testing.assert_array_equal(np.asarray(jax_moving_average(x, 700, 2, method="scan")), want)
    np.testing.assert_array_equal(emulate_scan(x, 700, 2, "blelloch", sm_count=4), want)


@pytest.mark.parametrize("method", SCAN_METHODS)
def test_scan_int16_min(method):
    x = np.full(50000, -32768, dtype=np.int16)
    want = moving_average_golden(x, 1024, 1)
    np.testing.assert_array_equal(port(x, 1024, 1, method), want)
    np.testing.assert_array_equal(
        np.asarray(jax_moving_average(x, 1024, 1, method=method)), want
    )


@pytest.mark.parametrize(
    "method,window,channels,route",
    [
        ("scan", 16, 2, "scan"),
        ("scan_hillis", 1024, 2, "scan_hillis"),
        ("scan_mxu", 1024, 16, "scan_mxu:two_pass_fallback"),
        ("scan", 65535, 1, "scan:two_pass_fallback"),
        ("scan_hillis", 5000, 16, "scan_hillis:two_pass_fallback"),
        ("scan", 100, 3, "scan"),  # any channel count takes the kernel
    ],
)
def test_scan_route_names(rng, method, window, channels, route):
    x = make_interleaved(rng, 300, channels)
    got = port(x, window, channels, method)
    assert last_choice("moving_average") == route
    np.testing.assert_array_equal(got, moving_average_golden(x, window, channels))


def test_scan_mxu_refuses_channels_it_cannot_take(rng):
    x = torch.from_numpy(make_interleaved(rng, 100, 3))
    with pytest.raises(ValueError, match="dividing its 16-sample rows"):
        moving_average(x, 4, 3, method="scan_mxu")
    with pytest.raises(ValueError, match="dividing its 16-sample rows"):
        scan_averager(x, 4, 3, variant="mxu")
    with pytest.raises(ValueError, match="unknown variant"):
        scan_averager(x, 4, 3, variant="kogge_stone")


def test_scan_averager_checks(rng):
    x = torch.from_numpy(make_interleaved(rng, 100, 2))
    with pytest.raises(ValueError, match="two_pass"):
        scan_averager(x, 65535, 2)  # halo beyond the bound
    with pytest.raises(ValueError, match="exceeds one tile"):
        scan_averager(x, 300, 2, tile_samples=512)
    with pytest.raises(ValueError, match="65535"):
        scan_averager(x, 0, 2)
    # an explicit tile: the plain version on the CPU, the same answer
    got = scan_averager(x, 16, 2, tile_samples=2048).numpy()
    np.testing.assert_array_equal(got, moving_average_golden(x.numpy(), 16, 2))


# ---- the block walk of csrc/scan.cu, in NumPy --------------------------------


def tree_scan(a: np.ndarray, n: int, channels: int) -> None:
    """tree_scan of csrc/scan.cu, in place: up-sweep, inclusive down-sweep.

    One vectorised update per level: within a level the targets and the
    sources are disjoint, as the kernel's parallel threads need.
    """
    s = 1
    while s < n:
        w = np.arange((n // (2 * s)) * channels)
        j, c = np.divmod(w, channels)
        f = (j + 1) * 2 * s - 1
        a[f * channels + c] += a[(f - s) * channels + c]
        s *= 2
    s //= 2
    while s >= 1:
        w = np.arange(((n - s) // (2 * s)) * channels if n > s else 0)
        j, c = np.divmod(w, channels)
        f = (j + 1) * 2 * s + s - 1
        a[f * channels + c] += a[(f - s) * channels + c]
        s //= 2


def hillis_steele_scan(a: np.ndarray, channels: int) -> np.ndarray:
    b = a.copy()
    s = channels
    while s < a.size:
        b[:] = a
        b[s:] += a[:-s]
        a, b = b, a
        s *= 2
    return a


def tensor_core_scan(v: np.ndarray, channels: int) -> np.ndarray:
    """The 16 x 16 limb products, the rows' totals by tree_scan, the add back."""
    r16 = np.arange(ps.TC_ROW)
    u = ((r16[None, :] >= r16[:, None]) & ((r16[None, :] - r16[:, None]) % channels == 0))
    u = u.astype(np.int64)
    hi = (v.astype(np.int32) >> 8).astype(np.int8).astype(np.int64).reshape(-1, ps.TC_ROW)
    lo = (v.astype(np.int32) & 0xFF).astype(np.uint8).astype(np.int64).reshape(-1, ps.TC_ROW)
    assert (hi * 256 + lo == v.reshape(-1, ps.TC_ROW)).all()
    res = ((hi @ u) * 256 + lo @ u).astype(np.int32).view(np.uint32)
    rows = res.shape[0]
    rt = res[:, ps.TC_ROW - channels :].reshape(-1).copy()
    tree_scan(rt, rows, channels)
    rt = rt.reshape(rows, channels)
    res[1:] += rt[:-1][:, np.arange(ps.TC_ROW) % channels]
    return res.reshape(-1)


def tile_scan(v: np.ndarray, g: ps.ScanGeometry) -> np.ndarray:
    if g.variant == "mxu":
        return tensor_core_scan(v, g.channels)
    a = v.astype(np.int32).view(np.uint32)
    if g.variant == "hillis_steele":
        return hillis_steele_scan(a, g.channels)
    tree_scan(a, g.tile_frames, g.channels)
    return a


def emulate_scan(x, window, channels, variant, *, sm_count=H100_SMS, tile_samples=None):
    g = ps.scan_geometry(window, channels, variant, tile_samples)
    n, t, h = x.size, g.tile_samples, window * channels
    assert t >= h and t % channels == 0
    if variant == "mxu":
        assert t % ps.TC_ROW_BLOCK == 0
    tiles = cdiv(n, t)
    span = g.span_tiles(n, sm_count)
    out = np.zeros(n, np.int16)
    written = np.zeros(n, np.int64)
    lane = np.arange(t)
    for b in range(cdiv(tiles, span)):
        first, end = b * span, min(b * span + span, tiles)
        carry = np.zeros(channels, np.uint32)
        tail = None
        for tile in range(first - 1, end):  # tile first - 1 seeds the span
            t0 = tile * t
            lo = t0 + t - h if tile < first else t0
            gi = t0 + lane
            load = (gi >= lo) & (gi >= 0) & (gi < n)
            v = np.zeros(t, np.int16)
            v[load] = x[gi[load]]
            cum = tile_scan(v, g)
            if tile >= first:
                assert tail is not None
                keep = gi < n
                before = np.empty(t, np.uint32)
                before[h:] = cum[: t - h]
                before[:h] = tail - carry[np.arange(h) % channels]
                wsum = (cum - before).view(np.int32).astype(np.int64)
                q = np.where(wsum >= 0, wsum // window, -((-wsum) // window))
                out[gi[keep]] = q[keep].astype(np.int16)
                written[gi[keep]] += 1
            tail = cum[t - h :] + carry[np.arange(h) % channels]
            carry = carry + cum[t - channels :]
    assert (written == 1).all()
    return out


@pytest.mark.parametrize("variant", ["blelloch", "hillis_steele", "mxu"])
@pytest.mark.parametrize(
    "window,channels,frames,tile_samples,sms",
    [
        (1, 1, 9000, 512, 3),
        (16, 2, 5000, 1024, 2),
        (700, 2, 12000, None, 1),  # spans of several default tiles
        (255, 4, 3001, 1024, 5),  # a span boundary inside a window
        (1024, 16, 129, None, H100_SMS),  # one short tile
        (3, 1, 1, None, H100_SMS),
        (4000, 1, 9001, None, 2),  # halo-grown tile
    ],
)
def test_scan_block_walk(rng, variant, window, channels, frames, tile_samples, sms):
    x = make_interleaved(rng, frames, channels)
    got = emulate_scan(x, window, channels, variant, sm_count=sms, tile_samples=tile_samples)
    np.testing.assert_array_equal(got, moving_average_golden(x, window, channels))


@pytest.mark.parametrize("variant", ["blelloch", "hillis_steele"])
@pytest.mark.parametrize("window,channels", [(7, 3), (100, 5), (2, 17)])
def test_scan_block_walk_any_channels(rng, variant, window, channels):
    x = make_interleaved(rng, 2000, channels)
    got = emulate_scan(x, window, channels, variant, sm_count=3, tile_samples=600)
    np.testing.assert_array_equal(got, moving_average_golden(x, window, channels))


@pytest.mark.parametrize("variant", ["blelloch", "hillis_steele", "mxu"])
def test_scan_block_walk_int16_min(variant):
    x = np.full(40000, -32768, np.int16)
    for window, channels in [(8192, 1), (512, 16), (99, 2)]:
        np.testing.assert_array_equal(
            emulate_scan(x, window, channels, variant, sm_count=3),
            moving_average_golden(x, window, channels),
        )


@pytest.mark.parametrize("variant", ["blelloch", "hillis_steele", "mxu"])
@pytest.mark.parametrize("channels", [1, 2, 16])
def test_scan_block_walk_largest_halo(rng, variant, channels):
    # the largest window B3 takes, with spans of several halo-grown tiles
    window = largest_scan_window(channels, variant)
    x = make_interleaved(rng, 4 * window + 3, channels)
    got = emulate_scan(x, window, channels, variant, sm_count=2)
    np.testing.assert_array_equal(got, moving_average_golden(x, window, channels))


@pytest.mark.parametrize("n", [1, 5, 17, 64, 100, 1000])
@pytest.mark.parametrize("channels", [1, 2, 3])
def test_tree_scan_is_the_prefix(rng, n, channels):
    a = rng.integers(0, 2**32, size=n * channels, dtype=np.uint64).astype(np.uint32)
    want = np.cumsum(a.reshape(n, channels), axis=0, dtype=np.uint32).reshape(-1)
    tree_scan(a, n, channels)
    np.testing.assert_array_equal(a, want)


# ---- geometry ------------------------------------------------------------------


def largest_scan_window(channels: int, variant: str) -> int:
    lo, hi = 0, 65535
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if ps.scan_supported(mid, channels, variant):
            lo = mid
        else:
            hi = mid - 1
    return lo


@pytest.mark.parametrize("variant", ["blelloch", "hillis_steele", "mxu"])
@pytest.mark.parametrize("channels", [1, 2, 4, 16])
def test_scan_geometry_fits_the_card(variant, channels):
    largest = largest_scan_window(channels, variant)
    assert largest >= 1
    for window in sorted({1, 2, 64, largest}):
        g = ps.scan_geometry(window, channels, variant)
        assert g.tile_samples >= max(window * channels, ps.TILE_SAMPLES)
        assert g.smem_bytes <= ps.TWO_BLOCKS_SMEM_MAX
        assert g.blocks_per_sm >= 2
        if variant == "mxu":
            assert g.tile_samples % ps.TC_ROW_BLOCK == 0
        for n in (1, 10**6, 64 * 2**20):
            span = g.span_tiles(n, H100_SMS)
            blocks = cdiv(cdiv(n, g.tile_samples), span)
            assert 1 <= blocks <= H100_SMS * g.blocks_per_sm
    assert largest == 65535 or not ps.scan_supported(largest + 1, channels, variant)


def test_scan_halo_bound():
    # two blocks an SM, as B1 (chip_smoke.py phase 5 times both sides)
    for variant, c, k in [("blelloch", 2, 7231), ("hillis_steele", 2, 4820), ("mxu", 2, 5486)]:
        assert ps.scan_supported(k, c, variant)
        assert not ps.scan_supported(k + 1, c, variant)
    assert ps.scan_supported(1024, 2, "mxu") and not ps.scan_supported(1024, 16, "blelloch")
