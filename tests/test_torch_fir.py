"""The port's FIR routes and the fused overlap-save kernels (B8, B9) against the JAX package.

The same NumPy inputs go through the JAX package (its fused Pallas kernels in
interpret mode on the CPU) and the port on the CPU (the plain versions).
``emulate_b8`` and ``emulate_b9`` do what the blocks of
``csrc/fused_fir.cu`` and ``csrc/fused_fir3.cu`` do, with the geometry the
wrappers pass to the launch: segment addressing and the two-segment
packing; for B8 each thread's points in registers, every Stockham pass of
the plan with its in-register DFT, computed twiddles and the exchange
through padded shared memory between passes, the tap product fused
between the transforms and the inverse as the forward transform of the
conjugate; for B9 the padded shared-memory slots, every radix-4 pass,
radix-2 stage and twiddle, its index map, permuted spectrum and waves.

Tolerances, relative to max|y|:
- 1e-5 against the JAX fused kernel or the port's other FFT routes: the
  JAX package's own bound between its fused and composed paths
  (tests/test_fft_mxu.py:97); two float32 FFT convolutions differ by
  rounding of order 1e-7 of the output's scale;
- 1e-4 against a direct FIR: the JAX package's bound (test_fft_mxu.py:42),
  which covers the direct conv's float32 accumulation over up to 16385 taps
  (measured here up to 5e-6);
- 1e-5 against a float64 FIR for the emulations and the FFT routes.
"""

import numpy as np
import pytest
import torch

from digital_signal_processsing_tpu.ops import fft_mxu as jax_fft_mxu
from digital_signal_processsing_tpu.ops import fir as jax_fir
from digital_signal_processsing_tpu.utils.dispatch import last_choice as jax_last_choice
from digital_signal_processsing_tpu.utils.layout import overlapping_frames as jax_frames
from digital_signal_processsing_tpu_torch.ops import fft_mxu as fm
from digital_signal_processsing_tpu_torch.ops import fir
from digital_signal_processsing_tpu_torch.utils import last_choice, overlapping_frames

METHODS = ["direct", "overlap_save", "overlap_save_mxu", "overlap_save_fused"]



def signal(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def taps_of(rng, k):
    return (rng.normal(size=k) / np.sqrt(k)).astype(np.float32)


def fir64(x, h):
    """Causal FIR in float64, (c, t) or (t,), by an FFT of the whole signal.

    NumPy's FFT runs in one thread; ``np.convolve`` makes one BLAS call an
    output, which a threaded BLAS turns into a thread barrier an output and
    minutes on a loaded machine at 16384 taps.
    """
    x2 = np.atleast_2d(x).astype(np.float64)
    t = x2.shape[1]
    n = 1 << (t + h.size - 2).bit_length()  # >= t + k - 1: no wrap-around
    y = np.fft.irfft(np.fft.rfft(x2, n) * np.fft.rfft(h.astype(np.float64), n), n)[:, :t]
    return y if x.ndim == 2 else y[0]


def rel_err(got, want):
    scale = np.max(np.abs(want))
    return float(np.max(np.abs(got - want)) / scale) if scale else float(np.max(np.abs(got)))


def port(fn, x, *args, **kw):
    return fn(torch.from_numpy(x), *args, **kw).numpy()


# ---- utils.layout.overlapping_frames ---------------------------------------------


@pytest.mark.parametrize("t,frames,hop,frame_len", [(100, 5, 16, 40), (64, 4, 16, 16), (10, 3, 8, 20)])
def test_overlapping_frames_match_jax(rng, t, frames, hop, frame_len):
    x = signal(rng, (2, t))
    got = port(overlapping_frames, x, frames, hop, frame_len)
    np.testing.assert_array_equal(got, np.asarray(jax_frames(x, frames, hop, frame_len)))


# ---- fir_filter under every method -------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 33, 63, 257, 4097])
@pytest.mark.parametrize("method", METHODS)
def test_fir_filter_methods(rng, method, k):
    x = signal(rng, (3, 9000))
    h = taps_of(rng, k)
    got = port(fir.fir_filter, x, h, method=method)
    assert last_choice("fir_filter") == method
    want = fir64(x, h)
    tol = 1e-4 if method == "direct" else 1e-5
    assert got.shape == x.shape and rel_err(got, want) < tol


@pytest.mark.parametrize("method", METHODS)
def test_fir_filter_names_and_values_match_jax(rng, method):
    x = signal(rng, (2, 5000))
    h = taps_of(rng, 257)
    got = port(fir.fir_filter, x, h, method=method)
    want = np.asarray(jax_fir.fir_filter(x, h, method=method))
    assert last_choice("fir_filter") == jax_last_choice("fir_filter") == method
    assert rel_err(got, want) < 1e-4


def test_fir_direct_matches_jax(rng):
    x = signal(rng, (4, 20000))
    for k in (1, 7, 63, 257):
        h = taps_of(rng, k)
        # both float32 accumulations of the same products: a few ulps of max|y|
        assert rel_err(port(fir.fir_direct, x, h), np.asarray(jax_fir.fir_direct(x, h))) < 1e-5
        got1 = port(fir.fir_direct, x[1], h)
        assert got1.shape == (20000,) and rel_err(got1, fir64(x[1], h)) < 1e-5


@pytest.mark.parametrize("k", [8193, 16384, 16385])
def test_fir_filter_auto_long_taps(rng, k):
    x = signal(rng, (2, 100_000))
    h = taps_of(rng, k)
    got = port(fir.fir_filter, x, h)
    assert last_choice("fir_filter") == "overlap_save_fused"
    assert rel_err(got, fir64(x, h)) < 1e-5


def test_auto_routes_follow_the_crossover(rng):
    x = signal(rng, (1, 3000))
    cases = [(fir.FIR_FFT_CROSSOVER + 1, "overlap_save_fused")]
    if fir.FIR_FFT_CROSSOVER >= 1:  # the direct route's last tap count, where there is one
        cases.insert(0, (fir.FIR_FFT_CROSSOVER, "direct"))
    for k, route in cases:
        fir.fir_filter(torch.from_numpy(x), taps_of(rng, k))
        assert last_choice("fir_filter") == route
    fir.fir_filter(torch.from_numpy(x), taps_of(rng, 1), method="direct")
    assert last_choice("fir_filter") == "direct"


def test_unknown_method_and_bad_shapes(rng):
    x = torch.from_numpy(signal(rng, (2, 100)))
    with pytest.raises(ValueError, match="unknown FIR method"):
        fir.fir_filter(x, np.ones(3, np.float32), method="nope")
    with pytest.raises(ValueError, match=r"expected \(time,\) or \(channels, time\)"):
        fir.fir_direct(x[None], np.ones(3, np.float32))


def test_short_signals(rng):
    h = taps_of(rng, 8193)
    for t in (1, 2, 8192):
        x = signal(rng, (2, t))
        for method in METHODS:
            got = port(fir.fir_filter, x, h, method=method)
            assert got.shape == (2, t) and rel_err(got, fir64(x, h)) < 1e-4, (t, method)


# ---- overlap_save_fused against the JAX fused kernels --------------------------


def test_fused_b8_matches_jax_fused(rng):
    # the JAX test's block (tests/test_fft_mxu.py:95): nfft 32768 there, B8
    # with nfft 32768 > FUSED_MAX_NFFT is B9 here; block 8192 keeps it on B8
    x = signal(rng, (2, 30_000))
    h = (rng.normal(size=8193) / 91).astype(np.float32)
    want = np.asarray(jax_fft_mxu.overlap_save_fused(x, h, block=24448))
    assert fm.fused_geometry(8193, 24448).kernel == "B9"
    assert rel_err(port(fm.overlap_save_fused, x, h, block=24448), want) < 1e-5
    assert fm.fused_geometry(8193, 8192).kernel == "B8"
    assert rel_err(port(fm.overlap_save_fused, x, h, block=8192), want) < 1e-5


def test_fused_b9_matches_jax_fused3(rng):
    x = signal(rng, (2, 100_000))
    h = (rng.normal(size=16_384) / 128).astype(np.float32)
    want = np.asarray(jax_fft_mxu.overlap_save_fused(x, h, block=49_152))  # JAX's 3-factor kernel
    assert fm.fused_geometry(16_384, 49_152).kernel == "B9"
    assert rel_err(port(fm.overlap_save_fused, x, h, block=49_152), want) < 1e-5


def test_fused_cap_and_alignment():
    with pytest.raises(ValueError, match="no 3-factor split"):
        fm.overlap_save_fused(
            torch.zeros(3_000_000), np.ones(8192, np.float32), block=1_091_584
        )
    with pytest.raises(ValueError, match="multiple of 128"):
        fm.overlap_save_fused(torch.zeros(1000), np.ones(5, np.float32), block=1000)


def test_overlap_save_mxu_matches_jax(rng):
    x = signal(rng, (2, 50_000))
    for k, block in [(1025, 8192), (257, 2048)]:
        h = taps_of(rng, k)
        want = np.asarray(jax_fft_mxu.overlap_save_mxu(x, h, block=block))
        assert rel_err(port(fm.overlap_save_mxu, x, h, block=block), want) < 1e-5


def test_pick_factored_nfft_matches_jax():
    for n in (9000, 9216, 1, 128, 129):
        assert fm.pick_factored_nfft(n) == jax_fft_mxu.pick_factored_nfft(n)


def test_pick_fused_block_envelopes():
    # B8 while block >= nfft/2 at nfft <= FUSED_MAX_NFFT, then B9 likewise
    last_b8 = fm.FUSED_MAX_NFFT // 2 + 1
    last_b9 = fm.FUSED3_MAX_NFFT // 2 + 1
    for k in (1, 2, 63, 257, 3900, 3901, last_b8, last_b8 + 1, 65537, last_b9, last_b9 + 1):
        block = fm.pick_fused_block(k)
        if k > last_b9:
            assert block is None
            continue
        g = fm.fused_geometry(k, block)
        assert g.kernel == ("B8" if k <= last_b8 else "B9"), k
        assert block % 128 == 0 and block + k - 1 <= g.nfft and block >= g.nfft // 2
        assert g.smem_bytes <= fm.SMEM_MAX


def test_response_is_computed_once_for_the_chain_route(rng):
    k = 8193
    h = taps_of(rng, k)
    g = fm.fused_geometry(k, fm.pick_fused_block(k))
    r = fm.tap_response(torch.from_numpy(h), g, "cpu")
    x = signal(rng, (2, 20_000))
    a = port(fir.fir_filter, x, h, response=r)
    b = port(fir.fir_filter, x, h)
    np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="response is for"):
        fm.overlap_save_fused(torch.from_numpy(x), h, block=4096, response=r)


# ---- the blocks of csrc/fused_fir.cu and csrc/fused_fir3.cu, in NumPy ------------


bit_reverse = fm.bit_reverse


def slot(line, pos, m):
    """fft.cuh slot(): a pad after every 16 points and one after each line."""
    return line * fm.line_slots(m) + pos + (pos >> 4)


def radix2_stage(buf, logm, lines, tw, stride, s, forward):
    i = np.arange(lines << (logm - 1))
    b = i & ((1 << (logm - 1)) - 1)
    j = b & ((1 << s) - 1)
    line, base = i >> (logm - 1), ((b >> s) << (s + 1)) + j
    m = 1 << logm
    lo, hi = slot(line, base, m), slot(line, base + (1 << s), m)
    w = tw[(j << (logm - 1 - s)) * stride]
    u = buf[:, lo]
    if forward:
        v = buf[:, hi]
        buf[:, lo], buf[:, hi] = u + v, (u - v) * w
    else:
        v = buf[:, hi] * np.conj(w)
        buf[:, lo], buf[:, hi] = u + v, u - v


def radix4_pass(buf, logm, lines, tw, stride, t, forward):
    i = np.arange(lines << (logm - 2))
    u = i & ((1 << (logm - 2)) - 1)
    j = u & ((1 << t) - 1)
    line, base = i >> (logm - 2), ((u >> t) << (t + 2)) + j
    m, size = 1 << t, 1 << logm
    p = [slot(line, base + r * m, size) for r in range(4)]
    w4 = tw[(j << (logm - 2 - t)) * stride]
    w2 = tw[(j << (logm - 1 - t)) * stride]
    w4b = (w4 * np.complex64(-1j)).astype(np.complex64)  # W_4m^(j+m)
    x0, x1, x2, x3 = (buf[:, q] for q in p)
    if forward:
        a0, a1, a2, a3 = x0 + x2, x1 + x3, (x0 - x2) * w4, (x1 - x3) * w4b
        out = a0 + a1, (a0 - a1) * w2, a2 + a3, (a2 - a3) * w2
    else:
        v1, v3 = x1 * np.conj(w2), x3 * np.conj(w2)
        a0, a1, a2, a3 = x0 + v1, x0 - v1, x2 + v3, x2 - v3
        c2, c3 = a2 * np.conj(w4), a3 * np.conj(w4b)
        out = a0 + c2, a1 + c3, a0 - c2, a1 - c3
    for q, v in zip(p, out):
        buf[:, q] = v


def fft_dif(buf, logm, lines, tw, stride):
    s = logm - 1
    if logm & 1:
        radix2_stage(buf, logm, lines, tw, stride, s, True)
        s -= 1
    while s >= 1:
        radix4_pass(buf, logm, lines, tw, stride, s - 1, True)
        s -= 2


def ifft_dit(buf, logm, lines, tw, stride):
    t = 0
    while t + 1 < logm:
        radix4_pass(buf, logm, lines, tw, stride, t, False)
        t += 2
    if t < logm:
        radix2_stage(buf, logm, lines, tw, stride, t, False)


class Pairs:
    """The pairs of segments of a launch: rows 2p and 2p+1 of (channels, segments)."""

    def __init__(self, g, c, t, pairs):
        nb = g.segments(t)
        self.t, self.rows = t, c * nb
        r0 = 2 * pairs
        self.has_b = r0 + 1 < self.rows
        r1 = np.where(self.has_b, r0 + 1, r0)
        self.ch = (r0 // nb, r1 // nb)
        s = (r0 % nb, r1 % nb)
        self.first = tuple(si * g.block - (g.k - 1) for si in s)
        self.out = tuple(si * g.block for si in s)

    def load(self, x, n):
        """a + i*b of transform points n (per pair, per point); zeros off the signal."""
        vals = []
        for side in (0, 1):
            gi = self.first[side][:, None] + n[None, :]
            ok = (gi >= 0) & (gi < self.t)
            vals.append(np.where(ok, x[self.ch[side][:, None], np.clip(gi, 0, self.t - 1)], 0))
        vals[1] = np.where(self.has_b[:, None], vals[1], 0)
        return (vals[0] + 1j * vals[1]).astype(np.complex64)

    def store(self, y, written, v, kept):
        """Write v (per pair, per kept output index) to both segments of each pair."""
        for side, part in ((0, v.real), (1, v.imag)):
            o = self.out[side][:, None] + kept[None, :]
            m = o < self.t
            if side == 1:
                m &= self.has_b[:, None]
            ch = np.broadcast_to(self.ch[side][:, None], o.shape)
            y[ch[m], o[m]] = part[m]
            np.add.at(written, (ch[m], o[m]), 1)


def xslot(e):
    """csrc/fused_fir.cu xslot(): B8's exchange, a pad after every 16 points."""
    return e + (e >> 4)


COS_PI_16 = np.cos(np.pi * np.arange(17) / 16).astype(np.float32)  # cospi16() in float32


def w32(m):
    """W_32^m = exp(-2 pi i m / 32) from the kernel's float32 constants."""
    return np.complex64(COS_PI_16[m] - 1j * COS_PI_16[abs(8 - m)])


def dft_registers(a):
    """dft(): the R-point DFT over the last axis by radix-2 decimation in
    frequency, in place, output k left at position bitrev(k); natural order back."""
    a = a.astype(np.complex64)
    r = a.shape[-1]
    bits = r.bit_length() - 1
    for st in range(bits):
        h = r >> (st + 1)
        for base in range(0, r, 2 * h):
            for i in range(h):
                u, v = a[..., base + i].copy(), a[..., base + i + h].copy()
                a[..., base + i] = u + v
                a[..., base + i + h] = (u - v) * w32(i * (16 // h)) if i else u - v
    return a[..., bit_reverse(np.arange(r), bits)]


def twiddles(e, span, r):
    """twiddle(): W_span^(e q) for q < r, sincospif of the exact float32 argument
    2 e q / span at q = c < 4 and q = 4a (here float64 cos and sin rounded to
    float32), their product for the rest."""
    x1 = (2.0 * e / span).astype(np.float32)

    def exact(q):
        ang = np.pi * (x1.astype(np.float64) * q)
        return (np.cos(ang) - 1j * np.sin(ang)).astype(np.complex64)

    c = min(r, 4)
    w = np.empty(e.shape + (r,), np.complex64)
    for a in range(r // c):
        z = exact(c * a)
        for q in range(c):
            w[..., c * a + q] = exact(q) if a == 0 else z if q == 0 else z * exact(q)
    return w


def stockham(v, g, exchanges):
    """fft<LOG>(): the forward transform of each pair, v (pairs, T, P) with thread
    j's v[s] point j + s*T, natural order in and out, by the plan's passes; the
    points between passes go through the padded exchange, every slot written once."""
    n, p, t = g.nfft, g.points, g.pair_threads
    j = np.arange(t)
    ns = 1
    for step, r in enumerate(g.radices):
        last = step == len(g.radices) - 1
        q_of = p // r
        buf = np.full((v.shape[0], n + n // 16), np.nan, np.complex64)
        for q in range(q_of):
            b = j + q * t
            cols = q + q_of * np.arange(r)
            a = v[:, :, cols]
            if ns > 1:
                a = a * twiddles(b % ns, ns * r, r)
            out = dft_registers(a)
            if last:
                v[:, :, cols] = out
            else:
                d = (b // ns) * (ns * r) + b % ns
                buf[:, xslot(d[:, None] + ns * np.arange(r)[None, :])] = out
        if not last:
            assert not np.isnan(buf[:, xslot(np.arange(n))]).any()
            v = buf[:, xslot(j[:, None] + t * np.arange(p)[None, :])]
            exchanges.append(step)
        ns *= r
    return v


def emulate_b8(x, response):
    g = response.geometry
    c, t = x.shape
    n, p, threads = g.nfft, g.points, g.pair_threads
    assert g.threads == g.pairs_per_block * threads >= fm.B8_MIN_THREADS or g.pairs_per_block == 1
    assert g.smem_bytes == 8 * g.pairs_per_block * (n + n // 16)
    assert np.prod(g.radices) == n and max(g.radices) <= p
    pr = Pairs(g, c, t, np.arange(g.pairs(c, t)))
    pts = np.arange(threads)[:, None] + threads * np.arange(p)[None, :]  # thread j's points
    v = pr.load(x, pts.ravel()).reshape(-1, threads, p)
    exchanges = []
    v = stockham(v, g, exchanges)
    h = response.h_kernel.numpy()
    np.testing.assert_array_equal(h, response.h.numpy())  # natural order
    v = np.conj(v * h[pts]).astype(np.complex64)  # conj(X H): the inverse, forward
    v = stockham(v, g, exchanges)
    assert len(exchanges) == 2 * (len(g.radices) - 1)
    y, written = np.full((c, t), np.nan, np.float32), np.zeros((c, t), np.int64)
    o = pts.ravel() - (g.k - 1)
    keep = (o >= 0) & (o < g.block)
    vals = np.conj(v.reshape(v.shape[0], -1)[:, keep]) * np.float32(1.0 / n)  # (re, -im) / N
    pr.store(y, written, vals, o[keep])
    assert (written == 1).all()
    return y


def emulate_b9(x, response):
    g = response.geometry
    c, t = x.shape
    n1, n2, g1, g2, N = g.n1, g.n2, g.g1, g.g2, g.nfft
    l1, l2, lg1 = n1.bit_length() - 1, n2.bit_length() - 1, g1.bit_length() - 1
    tw = fm._twiddles(N, "cpu").numpy()
    hp = response.h_kernel.numpy()
    total = g.pairs(c, t)
    wave = min(total, g.wave_pairs)
    scratch = np.full((wave, N), np.nan, np.complex64)
    slots = g.smem_bytes // 8
    y, written = np.full((c, t), np.nan, np.float32), np.zeros((c, t), np.int64)
    e1 = np.arange(g1 << l1)
    e2 = np.arange(g2 << l2)
    for p0 in range(0, total, wave):
        pr = Pairs(g, c, t, np.arange(p0, min(total, p0 + wave)))
        w = len(pr.has_b)
        for bx in range(n2 // g1):  # fir3_columns
            i2_0 = bx * g1
            buf = np.zeros((w, slots), np.complex64)
            ln, i1 = e1 & (g1 - 1), e1 >> lg1
            buf[:, slot(ln, i1, n1)] = pr.load(x, i1 * n2 + i2_0 + ln)
            fft_dif(buf, l1, g1, tw, n2)
            pos = e1 >> lg1
            f1, i2 = bit_reverse(pos, l1), i2_0 + ln
            scratch[:w, f1 * n2 + i2] = buf[:, slot(ln, pos, n1)] * tw[i2 * f1]
        for bx in range(n1 // g2):  # fir3_rows
            f1_0 = bx * g2
            buf = np.zeros((w, slots), np.complex64)
            ln, i2 = e2 >> l2, e2 & (n2 - 1)
            rows = f1_0 * n2 + e2
            buf[:, slot(ln, i2, n2)] = scratch[:w, rows]
            fft_dif(buf, l2, g2, tw, n1)
            buf[:, slot(ln, i2, n2)] *= hp[rows]
            ifft_dit(buf, l2, g2, tw, n1)
            scratch[:w, rows] = buf[:, slot(ln, i2, n2)] * np.conj(tw[i2 * (f1_0 + ln)])
        for bx in range(n2 // g1):  # fir3_outputs
            i2_0 = bx * g1
            buf = np.zeros((w, slots), np.complex64)
            ln, pos = e1 & (g1 - 1), e1 >> lg1
            buf[:, slot(ln, pos, n1)] = scratch[:w, bit_reverse(pos, l1) * n2 + i2_0 + ln]
            ifft_dit(buf, l1, g1, tw, n2)
            i1 = e1 >> lg1
            n = i1 * n2 + i2_0 + ln
            keep = (n >= g.k - 1) & (n < g.k - 1 + g.block)
            v = buf[:, slot(ln[keep], i1[keep], n1)] * np.float32(1.0 / N)
            pr.store(y, written, v, n[keep] - (g.k - 1))
        scratch[:] = np.nan  # the next wave must not read this one's points
    assert (written == 1).all()
    return y


def response_for(h, block=None):
    k = h.size
    g = fm.fused_geometry(k, block or fm.pick_fused_block(k))
    return fm.tap_response(h, g, "cpu")


@pytest.mark.parametrize(
    "k,channels,t",
    [(1, 1, 1), (2, 3, 255), (63, 2, 4000), (100, 2, 5000), (200, 3, 7000), (257, 3, 7681),
     (600, 2, 20_000), (4097, 1, 12288), (8193, 2, 30_000), (8193, 3, 8192)],
)
def test_b8_block_algorithm(rng, k, channels, t):
    x, h = signal(rng, (channels, t)), taps_of(rng, k)
    r = response_for(h)
    assert r.geometry.kernel == "B8"
    got = emulate_b8(x, r)
    assert rel_err(got, fir64(x, h)) < 1e-5
    assert rel_err(got, port(fm.fused_fir, x, r)) < 1e-5  # the plain version


def test_b8_smallest_plan(rng):
    """nfft 128, which only a block of 128 at one tap reaches: 32 pairs a block."""
    x, h = signal(rng, (2, 1000)), taps_of(rng, 1)
    r = response_for(h, 128)
    assert r.geometry.nfft == 128 and r.geometry.pairs_per_block == 32
    got = emulate_b8(x, r)
    assert rel_err(got, fir64(x, h)) < 1e-5
    assert rel_err(got, port(fm.fused_fir, x, r)) < 1e-5


def test_b8_twiddles_are_accurate():
    """Every twiddle of the plans within 3 float32 ulp of exp(-2 pi i e / span)."""
    for log2n, (p, radices) in fm.B8_PLANS.items():
        ns = 1
        for r in radices:
            e = np.arange(ns)
            w = twiddles(e, ns * r, r).astype(np.complex128)
            want = np.exp(-2j * np.pi * e[:, None] * np.arange(r)[None, :] / (ns * r))
            assert np.abs(w - want).max() < 3 * 2.0**-24, (log2n, r)
            ns *= r


@pytest.mark.parametrize("log2n", sorted(fm.B8_PLANS))
def test_b8_exchange_banks(log2n):
    """B8's exchange: each half-warp's 8-byte writes and reads fall on distinct
    banks (16 of 8 bytes) at nfft 4096 and 16384, the main path's, and at most
    two-way on one bank for the other plans."""
    g = fm.FusedGeometry(k=2, block=1 << (log2n - 1), nfft=1 << log2n)
    n, p, t, slots = g.nfft, g.points, g.pair_threads, g.nfft + g.nfft // 16
    tid = np.arange(g.threads)
    gi, j = tid // t, tid % t
    worst = 1
    ns = 1
    for step, r in enumerate(g.radices):
        q_of = p // r
        accesses = []
        if step < len(g.radices) - 1:
            for q in range(q_of):
                b = j + q * t
                d = (b // ns) * (ns * r) + b % ns
                accesses += [gi * slots + xslot(d + k * ns) for k in range(r)]  # writes
            accesses += [gi * slots + xslot(j + s * t) for s in range(p)]  # reads
        for addr in accesses:
            for half in range(0, g.threads, 16):
                words = np.unique(addr[half : half + 16])
                worst = max(worst, np.bincount(words % 16).max())
        ns *= r
    assert worst <= (1 if log2n in (12, 14) else 2), worst


@pytest.mark.parametrize(
    "k,channels,t,block",
    [(8194, 2, 122_753, None), (16385, 3, 50_000, None), (300, 3, 70_001, 32384)],
)
def test_b9_block_algorithm(rng, monkeypatch, k, channels, t, block):
    x, h = signal(rng, (channels, t)), taps_of(rng, k)
    r = response_for(h, block)
    assert r.geometry.kernel == "B9"
    got = emulate_b9(x, r)
    assert rel_err(got, fir64(x, h)) < 1e-5
    assert rel_err(got, port(fm.fused_fir3, x, r)) < 1e-5
    # waves of one pair: the scratch is reused, each wave reads only its own points
    monkeypatch.setattr(fm, "FUSED3_SCRATCH_BYTES", 8 * r.geometry.nfft)
    assert r.geometry.wave_pairs == 1
    np.testing.assert_array_equal(emulate_b9(x, r), got)


def test_b9_index_map_and_permuted_response(rng):
    # the four-step pieces alone: H permuted to [f1][q] = H[f1 + n1*bitrev(q)],
    # every twiddle exponent i2*f1 an exact integer below N
    h = taps_of(rng, 9000)
    r = response_for(h)
    g = r.geometry
    f1, q = np.meshgrid(np.arange(g.n1), np.arange(g.n2), indexing="ij")
    f2 = bit_reverse(q, g.n2.bit_length() - 1)
    np.testing.assert_array_equal(r.h_kernel.numpy().reshape(g.n1, g.n2), r.h.numpy()[f1 + g.n1 * f2])
    assert (g.n2 - 1) * (g.n1 - 1) < g.nfft
    np.testing.assert_allclose(
        r.h.numpy(), np.fft.fft(h.astype(np.float64), g.nfft), rtol=0, atol=1e-6
    )


@pytest.mark.parametrize("nfft", [256, 16384, 1 << 15, 1 << 20])
def test_slots_fit_and_never_collide(nfft):
    g = fm.FusedGeometry(k=2, block=nfft // 2, nfft=nfft)
    if g.kernel == "B8":  # each pair's exchange, one pad after every 16 points
        pair, pos = np.meshgrid(np.arange(g.pairs_per_block), np.arange(nfft), indexing="ij")
        s = (pair * (nfft + nfft // 16) + xslot(pos)).ravel()
        assert np.unique(s).size == s.size and s.max() < g.smem_bytes // 8
    for lines, m in () if g.kernel == "B8" else ((g.g1, g.n1), (g.g2, g.n2)):
        line, pos = np.meshgrid(np.arange(lines), np.arange(m), indexing="ij")
        s = slot(line, pos, m).ravel()
        assert np.unique(s).size == s.size and s.max() < g.smem_bytes // 8
    assert g.smem_bytes <= fm.SMEM_MAX
