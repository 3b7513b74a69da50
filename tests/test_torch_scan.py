"""The port's scan averager (B3) against the JAX package, golden, and its block walk.

``scan``, ``scan_hillis`` and ``scan_mxu`` go through the JAX package (its
Pallas kernel in interpret mode on the CPU) and through the port on the
CPU (the plain version) with the same NumPy input; bit-exact. The JAX
kernel needs ``channels | 128``, so at C=3 the port is held to golden.

The CUDA kernel (``csrc/scan.cu``) runs only on a card; ``emulate_scan``
below does what its blocks do, span by span and tile by tile, with the
geometry ``ops/pallas_scan.py`` passes to the launch: each thread's runs of
8 samples, the variant's in-run levels, its lane levels by emulated
shuffles (Brent-Kung, Kogge-Stone, or the tensor cores' m16n8k32 fragments
with their permuted columns and the rows' carries), the 8 warp totals, the
ring of absolute prefixes with its slots and the division by a multiply-high;
it must give the golden result bit for bit.
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
SCAN_VARIANTS = {"scan": "blelloch", "scan_hillis": "hillis_steele", "scan_mxu": "mxu"}
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
    np.testing.assert_array_equal(emulate_scan(x, 700, 2, "blelloch", resident=4), want)


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
        ("scan_mxu", 1024, 16, "scan_mxu"),  # a halo of 16384 samples: the ring takes it
        ("scan", 65535, 1, "scan:two_pass_fallback"),
        ("scan_hillis", 5000, 16, "scan_hillis:two_pass_fallback"),
        ("scan_mxu", 1280, 16, "scan_mxu"),  # past two blocks an SM: the ring still fits
        ("scan_hillis", 10237, 2, "scan_hillis"),
        ("scan_mxu", 3104, 16, "scan_mxu:two_pass_fallback"),  # past the largest ring
        ("scan", 24829, 2, "scan:two_pass_fallback"),
        ("scan", 5000, 3, "scan"),  # the generic kernel: a halo of 15000
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


# ---- the blocks of csrc/scan.cu, in NumPy ------------------------------------

WARPS = ps.THREADS // 32
RUN = ps.SCAN_RUN
LANE = np.arange(32)


def tree_scan(a: np.ndarray, n: int, channels: int) -> None:
    """Brent-Kung's inclusive up-sweep and down-sweep over the last axis, in place:
    ``a[..., f * channels + c]`` is frame f of channel c. csrc/scan.cu runs these
    levels over a run's frames (``bk_registers``) and over the 8 warp totals.

    One vectorised update per level: within a level the targets and the
    sources are disjoint, as the kernel's unrolled adds need.
    """
    s = 1
    while s < n:
        w = np.arange((n // (2 * s)) * channels)
        j, c = np.divmod(w, channels)
        f = (j + 1) * 2 * s - 1
        a[..., f * channels + c] += a[..., (f - s) * channels + c]
        s *= 2
    s //= 2
    while s >= 1:
        w = np.arange(((n - s) // (2 * s)) * channels if n > s else 0)
        j, c = np.divmod(w, channels)
        f = (j + 1) * 2 * s + s - 1
        a[..., f * channels + c] += a[..., (f - s) * channels + c]
        s //= 2


def shfl_up(x: np.ndarray, d: int) -> np.ndarray:
    """__shfl_up_sync over the last axis (32 lanes): lane l reads lane l - d,
    lanes below d read their own value."""
    out = x.copy()
    out[..., d:] = x[..., :-d]
    return out


def bk_lanes(x: np.ndarray, ph: int = 1) -> np.ndarray:
    """bk_lanes<PH>: Brent-Kung across the lanes of each phase by shuffles (lane l is
    element l // PH of phase l % PH), up-sweep then inclusive down-sweep."""
    e, n = LANE // ph, 32 // ph
    d = 1
    while d < n:
        x = np.where((e & (2 * d - 1)) == 2 * d - 1, x + shfl_up(x, d * ph), x)
        d *= 2
    d = n // 4
    while d >= 1:
        take = (((e + 1 - d) & (2 * d - 1)) == 0) & (e >= 3 * d - 1)
        x = np.where(take, x + shfl_up(x, d * ph), x)
        d //= 2
    return x


def ks_lanes(x: np.ndarray, start: int = 1) -> np.ndarray:
    """ks_lanes: stride doubling (Kogge-Stone) across the lanes from ``start``."""
    d = start
    while d < 32:
        x = np.where(LANE >= d, x + shfl_up(x, d), x)
        d *= 2
    return x


def u_fragment(ce: int) -> np.ndarray:
    """u_fragment for every lane and product: (4 nb, 32 lanes, 2 registers, 4 bytes),
    B's k row 4t + i as sample 8t + 4r + i, its column g as output 8(g >> 1) + 2nb + (g & 1)."""
    g, t = LANE >> 2, LANE & 3
    out = np.zeros((4, 32, 2, 4), np.int64)
    for nb in range(4):
        j = 8 * (g >> 1) + 2 * nb + (g & 1)
        for r in range(2):
            for i in range(4):
                s = 8 * t + 4 * r + i
                out[nb, :, r, i] = (j >= s) & ((j - s) % ce == 0)
    return out


def mma_k32(a_frag: np.ndarray, b_frag: np.ndarray) -> np.ndarray:
    """mma.sync m16n8k32 of one warp from its fragments (PTX ISA layouts): A (32 lanes,
    4 registers, 4 bytes), B (32 lanes, 2 registers, 4 bytes) -> D (32 lanes, 4)."""
    g, t = LANE >> 2, LANE & 3
    a = np.zeros((16, 32), np.int64)
    b = np.zeros((32, 8), np.int64)
    for i in range(4):
        a[g, 4 * t + i] = a_frag[:, 0, i]
        a[g + 8, 4 * t + i] = a_frag[:, 1, i]
        a[g, 16 + 4 * t + i] = a_frag[:, 2, i]
        a[g + 8, 16 + 4 * t + i] = a_frag[:, 3, i]
        b[4 * t + i, g] = b_frag[:, 0, i]
        b[16 + 4 * t + i, g] = b_frag[:, 1, i]
    d = a @ b
    return np.stack([d[g, 2 * t], d[g, 2 * t + 1], d[g + 8, 2 * t], d[g + 8, 2 * t + 1]], axis=1)


def row_products(v: np.ndarray, p: int, u: np.ndarray) -> None:
    """row_products: runs 2p (row g) and 2p + 1 (row g + 8) of each warp's lanes
    become their rows' per-channel prefix, by 4 products a limb. v: (warps, NQ, 32, 8)."""
    s = v.view(np.int32)
    hi = (s >> 8).astype(np.int64)  # the signed high byte
    lo = (s & 0xFF).astype(np.int64)
    for w in range(v.shape[0]):
        frags = {}
        for name, limb in (("hi", hi), ("lo", lo)):
            a0, a1 = limb[w, 2 * p], limb[w, 2 * p + 1]
            frags[name] = np.stack([a0[:, :4], a1[:, :4], a0[:, 4:], a1[:, 4:]], axis=1)
        for nb in range(4):
            dh = mma_k32(frags["hi"], u[nb])
            dl = mma_k32(frags["lo"], u[nb])
            d = (dh * 256 + dl).astype(np.int64)
            for e in range(2):
                v[w, 2 * p, :, 2 * nb + e] = d[:, e].astype(np.uint32)
                v[w, 2 * p + 1, :, 2 * nb + e] = d[:, 2 + e].astype(np.uint32)


def magic(window: int) -> int:
    """The multiplier dsp_scan_i16 passes: floor((2^64 - 1) / k) + 1."""
    return (2**64 - 1) // window + 1


def mean_of(wsum: np.ndarray, window: int) -> np.ndarray:
    """mean_of: trunc(s / k) as |s| times the multiplier, its high 64 bits, signed back."""
    s = wsum.view(np.int32).astype(np.int64)
    a = np.abs(s).astype(np.uint64)
    if window == 1:
        q = a
    else:
        m = magic(window)
        mh, ml = np.uint64(m >> 32), np.uint64(m & 0xFFFFFFFF)
        hi_part = a * mh  # < 2^64
        low_part = (a * ml) >> np.uint64(32)
        total = hi_part + low_part
        carry = (total < hi_part).astype(np.uint64)
        q = (total >> np.uint64(32)) + (carry << np.uint64(32))
    q = q.astype(np.int64)
    return np.where(s < 0, -q, q).astype(np.int16)


def tile_prefix(v: np.ndarray, g: ps.ScanGeometry, u, carry: np.ndarray) -> np.ndarray:
    """Steps 2-4 of a tile: v (warps, NQ, 32 lanes, 8) loaded samples as uint32 ->
    the absolute prefix; ``carry`` (C,) is advanced by the tile's totals. A run holds
    SL channels; at C = 16 the lanes of each parity (phase) hold one half of a frame."""
    ce, nq = g.channels, ps.SCAN_RUNS
    sl = min(ce, RUN)
    ph = ce // sl
    phase = LANE % ph
    if g.variant == "mxu":
        for p in range(nq // 2):
            row_products(v, p, u)
    off = np.zeros((WARPS, nq, 32, sl), np.uint32)
    wsum = np.zeros((WARPS, 32, sl), np.uint32)  # the lane's phase's channels
    for q in range(nq):
        if g.variant == "blelloch":
            tree_scan(v[:, q], RUN // sl, sl)  # the run's frames, each channel
        elif g.variant == "hillis_steele":
            for m in range(sl, RUN):
                v[:, q, :, m] += v[:, q, :, m - sl]
        for c in range(sl):
            if g.variant == "mxu":  # the row's total from its group's last lane of this phase
                own = v[:, q, (LANE & ~3) | (4 - ph) | phase, RUN - sl + c]
                incl = ks_lanes(own, 4)
            else:
                own = v[:, q, :, RUN - sl + c]
                incl = bk_lanes(own, ph) if g.variant == "blelloch" else ks_lanes(own, ph)
            off[:, q, :, c] = wsum[:, :, c] + incl - own
            wsum[:, :, c] += incl[:, 32 - ph + phase]
    wt = np.zeros((WARPS, ce), np.uint32)  # written by lanes < PH
    for lane in range(ph):
        wt[:, sl * lane : sl * lane + sl] = wsum[:, lane]
    incl = wt.copy()  # the 8 warp totals of every channel
    if g.variant == "blelloch":
        for c in range(ce):
            col = incl[:, c].copy()
            tree_scan(col, WARPS, 1)
            incl[:, c] = col
    elif g.variant == "hillis_steele":
        d = 1
        while d < WARPS:
            incl[d:] = incl[d:] + incl[:-d].copy()
            d *= 2
    else:
        incl = np.cumsum(incl, axis=0, dtype=np.uint32)
    chan = sl * phase[:, None] + np.arange(sl)[None, :]  # (32 lanes, SL): each lane's channels
    mine = (incl - wt)[:, chan]  # (warps, 32, SL)
    off += (carry[chan][None] + mine)[:, None]
    carry += incl[-1]
    return v + np.take_along_axis(off, (np.arange(RUN) % sl)[None, None, None, :].repeat(32, 2).repeat(nq, 1).repeat(WARPS, 0), axis=3)


def skew(r):
    """scan_generic_kernel's ring slot r: one word of skew every 32."""
    return r + (r >> 5)


K_ROWS = 4  # kRows: rows of a channel scanned together


def generic_rows(ring: np.ndarray, carry: np.ndarray, r0: int, c0: int, g: ps.ScanGeometry) -> None:
    """Step 2 of scan_generic_kernel, every channel at once (in the kernel warp
    c % 8 takes channel c; channels are independent): the channel's samples of
    the tile, C apart, in rows of 32 lanes, K_ROWS rows a step, each row's
    prefix across the lanes, the carry added, written back in place."""
    tile, rs, c = g.tile_samples, RUN * g.nrun, g.channels
    ch = np.arange(c)
    jc = np.where(ch >= c0, ch - c0, ch + c - c0)
    nc = np.where(jc < tile, -(-(tile - jc) // c), 0)
    step = (32 * c) % rs
    r = (r0 + jc[:, None] + c * LANE[None, :]) % rs  # (C, 32 lanes)
    for i0 in range(0, int(nc.max(initial=0)), 32 * K_ROWS):
        slots, vals = [], []
        for u in range(K_ROWS):
            slot = np.where(i0 + 32 * u + LANE[None, :] < nc[:, None], skew(r), -1)
            vals.append(np.where(slot >= 0, ring[np.maximum(slot, 0)], 0).astype(np.uint32))
            slots.append(slot)
            r = r + step
            r = np.where(r >= rs, r - rs, r)
        for slot, val in zip(slots, vals):
            incl = bk_lanes(val) if g.variant == "blelloch" else ks_lanes(val)
            ring[slot[slot >= 0]] = (carry[:, None] + incl)[slot >= 0]
            carry += incl[:, 31]


def emulate_scan(x, window, channels, variant, *, resident=4 * H100_SMS, g=None, seed=None,
                 tile_range=None, span=None, aligned=True, out=None, written=None, stats=None):
    """A launch of csrc/run_tile.cuh's span kernels: every block walks its seed
    tiles and its span through the ring, from the geometry the wrapper passes;
    ``resident`` is one wave of blocks (the card's SMs times the kernel's blocks
    an SM). C outside SCAN_NATIVE_C takes scan_generic_kernel: the raw samples
    through a flat, skewed ring, each channel scanned there in rows.

    B3 by default. B1 (``g`` a WindowedGeometry) takes the tiles ``tile_range``
    (all by default) in spans of ``span`` tiles (one wave over the range by
    default), and reads positions before the stream from ``seed`` (the H
    samples before it) where one is given. Each run loads and stores 16 bytes
    where the launch is ``aligned`` (x and y 16-byte aligned) and it lies inside
    the stream (every run of a tile wholly inside at once), else sample by
    sample: the emulation checks that a 16-byte access never leaves the stream
    or its 8-sample grid, and counts both kinds in ``stats``. Outputs go to
    ``out`` (written counted in ``written``), which it returns."""
    g = ps.scan_geometry(window, channels, variant) if g is None else g
    variant = g.variant
    n, nq = x.size, ps.SCAN_RUNS
    tile, h, nrun = g.tile_samples, g.halo, g.nrun
    generic = g.kernel_c == 0
    rs = RUN * nrun
    if generic:
        assert variant != "mxu" and g.smem_bytes == 4 * (rs + rs // 32 + channels)
    else:
        assert g.smem_bytes == 4 * (rs + WARPS * channels)
    assert nrun % 32 == 0 and nrun >= tile // RUN + -(-h // RUN) + 1 and g.seed_tiles * tile >= h
    assert seed is None or (isinstance(g, ps.WindowedGeometry) and seed.size == h)
    u = u_fragment(channels) if variant == "mxu" else None
    out = np.zeros(n, np.int16) if out is None else out
    written = np.zeros(n, np.int64) if written is None else written
    stats = {} if stats is None else stats
    begin, stop = (0, g.tiles(n)) if tile_range is None else tile_range
    assert 0 <= begin < stop <= g.tiles(n)
    span = g.range_span(stop - begin, resident) if span is None else span
    run = (np.arange(WARPS)[:, None, None] * nq + np.arange(nq)[None, :, None]) * 32 + LANE
    pos = run[..., None] * RUN + np.arange(RUN)  # (warps, NQ, 32, 8): sample of the tile
    assert np.array_equal(np.sort(pos.ravel()), np.arange(tile))
    ext = x if seed is None else np.concatenate([seed, x])  # sample p at ext[p + front]
    front = 0 if seed is None else h
    for b in range(cdiv(stop - begin, span)):
        first = begin + b * span
        end = min(first + span, stop)
        lo, base = first * tile - h, first - g.seed_tiles
        stats["least_lo"] = min(stats.get("least_lo", lo), lo)  # before clipping
        lo = lo if seed is not None else max(lo, 0)  # Span's first read
        vlo = max(lo, 0)  # a 16-byte load never reads before the stream
        carry = np.zeros(channels, np.uint32)
        # stale words must never be read
        ring = np.full(skew(rs) if generic else (RUN, nrun), 0xDEADBEEF, np.uint32)
        for t in range(base, end):
            p = t * tile + pos
            p0 = t * tile + run * RUN  # each run's first sample
            whole = aligned and vlo <= t * tile and t * tile + tile <= n
            vec = whole | (aligned & (p0 >= vlo) & (p0 + RUN <= n))
            assert (p0[vec] >= 0).all() and (p0[vec] + RUN <= n).all() and (p0 % RUN == 0).all()
            stats["vector loads"] = stats.get("vector loads", 0) + int(vec.sum())
            stats["scalar loads"] = stats.get("scalar loads", 0) + int((~vec).sum())
            ok = (p >= lo) & (p < n)
            assert (p[ok] >= -front).all()  # before the stream: inside the seed
            v = np.where(ok, ext[np.clip(p + front, 0, max(ext.size - 1, 0))], 0)
            v = v.astype(np.int32).view(np.uint32)
            r0 = ((t - base) * tile) % rs  # the slot of the tile's sample 0
            if generic:
                at = (r0 + pos) % rs
                ring[skew(at)] = v
                generic_rows(ring, carry, r0, (t * tile) % channels, g)
                cum = ring[skew(at)]
            else:
                cum = tile_prefix(v.copy(), g, u, carry)
                slots = ((t - base) * (tile // RUN) + run) % nrun
                for m in range(RUN):
                    ring[m, slots] = cum[..., m]
            if t < first:
                continue
            back = (t - base) * tile + pos - h
            assert (back >= 0).all()
            if generic:
                at = (r0 + pos) % rs
                slot = np.where(at >= h, at - h, at - h + rs)
                assert np.array_equal(slot, back % rs)
                before = ring[skew(slot)]
            else:
                hi = (r0 // RUN + run - (h >> 3)) % nrun
                m = np.arange(RUN)
                slot = np.where(m < (h & 7), (hi[..., None] - 1) % nrun, hi[..., None])
                word = (m - (h & 7)) % RUN
                assert np.array_equal(slot, (back >> 3) % nrun) and np.array_equal(word + 0 * back, back & 7)
                before = ring[word, slot]
            o = mean_of(cum - before, window)
            keep = p < n
            out[p[keep]] = o[keep]
            written[p[keep]] += 1
            store_vec = aligned & (p0 + RUN <= n)
            stats["vector stores"] = stats.get("vector stores", 0) + int(store_vec.sum())
    if tile_range is None:
        assert (written == 1).all()
    return out


@pytest.mark.parametrize("variant", ["blelloch", "hillis_steele", "mxu"])
@pytest.mark.parametrize(
    "window,channels,frames,resident",
    [
        (1, 1, 70000, 3),  # spans of 3 tiles
        (16, 2, 40000, 2),
        (700, 2, 30000, 2),  # spans of 4 tiles
        (255, 4, 20001, 5),  # spans of 2: a span boundary inside a window
        (1024, 16, 129, 4 * H100_SMS),  # one short tile
        (3, 1, 1, 4 * H100_SMS),
        (4000, 1, 9001, 2),  # a halo reaching into the tile before the span
        (20000, 1, 60001, 3),  # a halo of three seed tiles
    ],
)
def test_scan_block_walk(rng, variant, window, channels, frames, resident):
    x = make_interleaved(rng, frames, channels)
    got = emulate_scan(x, window, channels, variant, resident=resident)
    np.testing.assert_array_equal(got, moving_average_golden(x, window, channels))


@pytest.mark.parametrize("method", SCAN_METHODS)
@pytest.mark.parametrize("window,channels", [(1, 2), (1024, 2), (300, 4), (5000, 1), (64, 8), (33, 16)])
def test_scan_block_walk_matches_jax(rng, method, window, channels):
    # the JAX package's same method (its Pallas kernel in interpret mode) on the same input
    x = make_interleaved(rng, 20011, channels)
    got = emulate_scan(x, window, channels, SCAN_VARIANTS[method], resident=2)
    np.testing.assert_array_equal(got, jax_or_golden(x, window, channels, method))


@pytest.mark.parametrize("variant", ["blelloch", "hillis_steele"])
@pytest.mark.parametrize("window,channels", [(7, 3), (100, 5), (2, 17), (3000, 3), (40, 32)])
def test_scan_block_walk_any_channels(rng, variant, window, channels):
    # the generic kernel: spans of 2 tiles (3000 x 3: a halo of two seed tiles)
    x = make_interleaved(rng, 20000, channels)
    got = emulate_scan(x, window, channels, variant, resident=cdiv(20000 * channels, 2 * 8192))
    np.testing.assert_array_equal(got, moving_average_golden(x, window, channels))


@pytest.mark.parametrize("variant", ["blelloch", "hillis_steele", "mxu"])
def test_scan_block_walk_int16_min(variant):
    x = np.full(40000, -32768, np.int16)
    for window, channels in [(8192, 1), (512, 16), (99, 2)]:
        np.testing.assert_array_equal(
            emulate_scan(x, window, channels, variant, resident=3),
            moving_average_golden(x, window, channels),
        )


@pytest.mark.parametrize("variant", ["blelloch", "hillis_steele", "mxu"])
@pytest.mark.parametrize("channels", [1, 2, 16])
def test_scan_block_walk_largest_halo(rng, variant, channels):
    # the largest window B3 takes, with spans of several tiles
    window = largest_scan_window(channels, variant)
    x = make_interleaved(rng, 4 * window + 3, channels)
    got = emulate_scan(x, window, channels, variant, resident=2)
    np.testing.assert_array_equal(got, moving_average_golden(x, window, channels))


@pytest.mark.parametrize("variant", ["blelloch", "hillis_steele", "mxu"])
def test_scan_block_walk_int16_max_and_k1(variant):
    # every window sum at its most positive, and k = 1 (no division)
    x = np.full(30000, 32767, np.int16)
    generic = [(1, 5), (2000, 3)] if variant != "mxu" else []
    for window, channels in [(8192, 1), (1, 2), (1, 16), (4097, 4), *generic]:
        np.testing.assert_array_equal(
            emulate_scan(x, window, channels, variant, resident=3),
            moving_average_golden(x, window, channels),
        )


@pytest.mark.parametrize("n", [1, 5, 17, 64, 100, 1000])
@pytest.mark.parametrize("channels", [1, 2, 3])
def test_tree_scan_is_the_prefix(rng, n, channels):
    a = rng.integers(0, 2**32, size=n * channels, dtype=np.uint64).astype(np.uint32)
    want = np.cumsum(a.reshape(n, channels), axis=0, dtype=np.uint32).reshape(-1)
    tree_scan(a, n, channels)
    np.testing.assert_array_equal(a, want)


def test_lane_scans_are_the_prefix(rng):
    a = rng.integers(0, 2**32, size=(5, 32), dtype=np.uint64).astype(np.uint32)
    want = np.cumsum(a, axis=1, dtype=np.uint32)
    np.testing.assert_array_equal(bk_lanes(a), want)
    np.testing.assert_array_equal(ks_lanes(a), want)
    # from stride 4: the prefix over the groups of 4 lanes, each lane its group's value
    groups = np.repeat(a[:, ::4], 4, axis=1)
    np.testing.assert_array_equal(ks_lanes(groups, 4), np.repeat(np.cumsum(a[:, ::4], axis=1, dtype=np.uint32), 4, axis=1))


@pytest.mark.parametrize("ce", [1, 2, 4])
def test_mxu_fragments_hold_each_lanes_run(rng, ce):
    """The permuted A, B and D fragments: lane (g, t) loads samples 8t..8t+7 of rows g
    and g + 8 and gets back their per-channel prefix within the row of 32."""
    v = rng.integers(-32768, 32768, size=(1, 2, 32, RUN)).astype(np.int32).view(np.uint32)
    rows = v.view(np.int32).astype(np.int64).reshape(2, 8, 32)  # (run 2p + h, group g, 32 samples)
    got = v.copy()
    row_products(got, 0, u_fragment(ce))
    want = np.empty_like(rows)
    for c in range(ce):
        want[..., c::ce] = np.cumsum(rows[..., c::ce], axis=-1)
    np.testing.assert_array_equal(got.view(np.int32).astype(np.int64).reshape(2, 8, 32), want)


@pytest.mark.parametrize("channels", [3, 5, 6, 7, 12, 17, 24, 32, 33, 48])
def test_generic_ring_banks(channels):
    """scan_generic_kernel's skewed ring: a warp's runs of 8 (steps 1 and 3) on 32
    banks, the lanes' stride-C walk of a row (step 2) at most two to a bank where
    the row does not wrap round the ring (once a ring's length a channel)."""
    g = ps.scan_geometry(100, channels, "blelloch")
    rs = RUN * g.nrun
    assert rs % 256 == 0 and g.tile_samples % 256 == 0  # a warp's runs never wrap mid-warp
    for r0 in range(0, rs, g.tile_samples):
        for first_run in range(0, g.tile_samples // RUN, 32):
            for m in range(RUN):
                slots = (r0 + (first_run + LANE) * RUN + m) % rs
                assert np.bincount(skew(slots) % 32, minlength=32).max() == 1
    for start in range(0, rs - 31 * channels, 13):
        slots = start + channels * LANE
        assert np.bincount(skew(slots) % 32, minlength=32).max() <= 2


def test_magic_division_is_exact():
    sums = np.array([0, 1, -1, 2**31 - 65536, -(2**31 - 65536), 65535 * 32767, -65535 * 32768,
                     123456789, -987654321, 7, -7], np.int64)
    for window in (1, 2, 3, 7, 1000, 1023, 1024, 1025, 4095, 65521, 65535):
        got = mean_of(sums.astype(np.int32).view(np.uint32), window)
        want = np.where(sums >= 0, sums // window, -((-sums) // window)).astype(np.int16)
        np.testing.assert_array_equal(got, want)
        m = magic(window)
        for s in (2**31 - 1, 2**32 - 1, 65535 * 32768):  # the Python-int product, exactly
            assert (s * m) >> 64 == s // window


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
        assert g.tile_samples == ps.THREADS * ps.SCAN_RUN * ps.SCAN_RUNS == 8192
        assert g.kernel_c == (channels if channels in ps.SCAN_NATIVE_C else 0)
        assert g.nrun % 32 == 0 and g.nrun >= g.tile_samples // 8 + cdiv(g.halo, 8) + 1
        assert g.seed_tiles * g.tile_samples >= g.halo
        assert g.smem_bytes <= ps.WINDOWED_SMEM_MAX <= ps.SMEM_MAX
        assert ps.SMEM_PER_SM // (g.smem_bytes + 1024) >= 1  # at least one block an SM
        for resident in (2 * H100_SMS, 4 * H100_SMS):  # the launch bounds allow 3 or 4
            for n in (channels, 10**6 // channels * channels, 64 * 2**20):
                span = g.span_tiles(n, resident)
                assert 1 <= cdiv(g.tiles(n), span) <= resident
    # an explicit tile only bounds the window: it selects no other kernel
    assert ps.scan_geometry(1, channels, variant, tile_samples=1024) == ps.scan_geometry(1, channels, variant)
    assert largest == 65535 or not ps.scan_supported(largest + 1, channels, variant)


def test_scan_halo_bound():
    # while the ring fits shared memory, one block an SM included, as B1
    # (chip_smoke.py phase 5 times both sides of two blocks an SM): the ring
    # of 8192 + H samples and the warp totals
    for variant in ps.SCAN_VARIANTS:
        for c, k in [(1, 49656), (2, 24828), (4, 12414), (16, 3103)]:
            assert ps.scan_supported(k, c, variant)
            assert not ps.scan_supported(k + 1, c, variant)
            assert ps.scan_supported(k, c, variant) == ps.windowed_supported(k, c)
    for variant in ("blelloch", "hillis_steele"):  # the generic kernel: its skewed ring and C carries
        for c, k in [(3, 16040), (5, 9624), (17, 2830)]:
            assert ps.scan_supported(k, c, variant) and not ps.scan_supported(k + 1, c, variant)
    assert ps.scan_supported(6207, 8, "mxu") and not ps.scan_supported(6208, 8, "blelloch")
