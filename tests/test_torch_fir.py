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
conjugate; for B9 each wave of equal size and its three launches: the
staging of x, the scratch and y through padded lines in shared memory,
each line's points in registers through its plan (the warp plans'
shuffle transpose, B8's shared-memory plans), the computed inter-step
twiddles W_N^(i2 f1), the taps' spectrum in the four-step layout and the
inverse as the forward transform of the conjugate.

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

import types

import numpy as np
import pytest
import torch

from digital_signal_processsing_tpu.ops import fft_mxu as jax_fft_mxu
from digital_signal_processsing_tpu.ops import fir as jax_fir
from digital_signal_processsing_tpu.utils.dispatch import last_choice as jax_last_choice
from digital_signal_processsing_tpu.utils.layout import overlapping_frames as jax_frames
from digital_signal_processsing_tpu_torch.ops import fft_mxu as fm
from digital_signal_processsing_tpu_torch.ops import fir
from digital_signal_processsing_tpu_torch.utils import cdiv, last_choice, overlapping_frames

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


def bit_reverse(i, bits):
    """Each of ``i`` with its low ``bits`` bits reversed (stockham.cuh brev)."""
    r = np.zeros_like(i)
    for b in range(bits):
        r |= ((i >> b) & 1) << (bits - 1 - b)
    return r


def xslot(e):
    """stockham.cuh xslot(): B8's exchange and B9's lines, a pad after every 16 points."""
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


def transpose_shfl(w, t, q_of):
    """stockham.cuh transpose_shfl(): w (..., T lanes, P); round h swaps lane bit h
    with bit h of t in register t*Q + q, one xor shuffle a register pair."""
    j = np.arange(t)
    h = 1
    while h < t:
        hi = ((j & h) != 0)[:, None]
        for c in range(w.shape[-1]):
            if (c // q_of) & h:
                continue
            c1 = c + h * q_of
            send = np.where(hi[:, 0], w[..., c], w[..., c1])
            got = send[..., j ^ h]
            w[..., c], w[..., c1] = np.where(hi[:, 0], got, w[..., c]), np.where(hi[:, 0], w[..., c1], got)
        h <<= 1
    return w


def warp_fft(v, m, p):
    """stockham.cuh warp_fft(): the M-point transform of each row of T lanes x P
    points, pass 1 a P-point DFT a lane, the shuffle transpose, pass 2 of radix T
    with the twiddles W_M^(b r) (b = j + qT); natural order in and out."""
    t = m // p
    if t == 1:
        return dft_registers(v) if p > 1 else v
    q_of = p // t
    a = dft_registers(v)
    w = np.empty_like(a)
    for tt in range(t):
        for q in range(q_of):
            w[..., tt * q_of + q] = a[..., tt + q * t]
    w = transpose_shfl(w, t, q_of)
    j = np.arange(t)
    for q in range(q_of):
        cols = q + q_of * np.arange(t)
        w[..., cols] = dft_registers(w[..., cols] * twiddles(j + q * t, m, t))
    return w


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


def line_fft(v, m):
    """line_fft<LOG>() of csrc/fused_fir3.cu: the forward transform of lines v
    (..., T, P) of m points, by the warp plan (shuffles) or B8's shared-memory plan."""
    p, radices = fm.B9_LINE_PLANS[m.bit_length() - 1]
    t = m // p
    if len(radices) == 2:
        assert radices == (p, t) and t <= 16
        return warp_fft(v.copy(), m, p)
    geo = types.SimpleNamespace(nfft=m, points=p, pair_threads=t, radices=radices)
    return stockham(v.reshape(-1, t, p).copy(), geo, []).reshape(v.shape)


def w_n(e, n):
    """w_n(): W_N^e from sincospif of the float32 product e * (2/N), which is exact
    (here float64 cos and sin of it, rounded to float32)."""
    arg = e.astype(np.float32) * np.float32(2.0 / n)
    assert np.array_equal(arg.astype(np.float64), e.astype(np.float64) * (2.0 / n))
    ang = np.pi * arg.astype(np.float64)
    return (np.cos(ang) - 1j * np.sin(ang)).astype(np.complex64)


def emulate_b9(x, response):
    """The three launches of each wave of csrc/fused_fir3.cu at the wrapper's geometry."""
    g = response.geometry
    c, t = x.shape
    n1, n2, N, G, R = g.n1, g.n2, g.nfft, g.g1, g.g2
    t1, t2 = fm.line_threads(n1), fm.line_threads(n2)
    p1, p2 = n1 // t1, n2 // t2
    stride = fm.line_slots(n1)
    assert g.column_threads == G * t1 and R * t2 == fm.B9_ROW_THREADS
    assert g.column_smem_bytes == 2 * 8 * G * stride  # a task's lines and the next task's
    hk = response.h_kernel.numpy().reshape(n1, n2)
    rot = (g.k - 1) % n2
    for first in (0, g.block, 5 * g.block):  # a task's runs of x and y: whole 32-byte sectors
        assert (first - (g.k - 1) + rot) % 8 == 0 and (rot - (g.k - 1)) % 8 == 0
    total = g.pairs(c, t)
    wave = g.wave(total)  # what the wrapper passes; the launcher splits by it
    waves = cdiv(total, wave)
    scratch = np.full((wave, N), np.nan, np.complex64)
    y, written = np.full((c, t), np.nan, np.float32), np.zeros((c, t), np.int64)
    e = np.arange(G * n1)  # the points a column block stages: line e % G, slot e // G
    ln, i1 = e % G, e // G
    lj = np.arange(G)[:, None, None], np.arange(t1)[None, :, None], np.arange(p1)[None, None, :]
    l_, j_, s_ = lj
    pos = j_ + s_ * t1  # thread (l, j)'s points of its line
    for w in range(waves):
        pairs = np.arange(w * total // waves, (w + 1) * total // waves)
        assert 0 < pairs.size <= wave
        pr, cnt = Pairs(g, c, t, pairs), pairs.size
        for bx in range(n2 // G):  # fir3_columns: tasks of G columns from (k - 1) mod n2 on
            cols = (bx * G + rot + ln) % n2
            buf = np.full((cnt, G * stride), np.nan, np.complex64)
            buf[:, ln * stride + xslot(i1)] = pr.load(x, i1 * n2 + cols)
            v = buf[:, l_ * stride + xslot(pos)]
            v = line_fft(v, n1) * w_n((bx * G + rot + l_) % n2 * pos, N)
            buf[:] = np.nan
            buf[:, l_ * stride + xslot(pos)] = v
            scratch[:cnt, i1 * n2 + cols] = buf[:, ln * stride + xslot(i1)]
        r_, jr, sr = np.arange(R)[:, None, None], np.arange(t2)[None, :, None], np.arange(p2)[None, None, :]
        for bx in range(n1 // R):  # fir3_rows
            f1 = bx * R + r_
            col = jr + sr * t2
            v = line_fft(scratch[:cnt, f1 * n2 + col], n2)
            v = np.conj(v * hk[f1, col]).astype(np.complex64)  # conj(X H)
            v = line_fft(v, n2) * w_n(col * f1, N)
            scratch[:cnt, f1 * n2 + col] = v
        for bx in range(n2 // G):  # fir3_outputs, the same tasks
            cols = (bx * G + rot + ln) % n2
            buf = np.full((cnt, G * stride), np.nan, np.complex64)
            buf[:, ln * stride + xslot(i1)] = scratch[:cnt, i1 * n2 + cols]
            v = line_fft(buf[:, l_ * stride + xslot(pos)], n1)
            buf[:] = np.nan
            buf[:, l_ * stride + xslot(pos)] = np.conj(v) * np.float32(1.0 / N)
            n = i1 * n2 + cols
            keep = (n >= g.k - 1) & (n < g.k - 1 + g.block)
            pr.store(y, written, buf[:, (ln * stride + xslot(i1))[keep]], n[keep] - (g.k - 1))
        scratch[:] = np.nan  # the next wave must not read this one's points
    assert not np.isnan(y).any() and (written == 1).all()
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


def test_b9_emulation_matches_jax_fused3(rng):
    # the JAX package's 3-factor kernel (interpret mode) on the same seeded input
    x = signal(rng, (2, 100_000))
    h = (rng.normal(size=16_384) / 128).astype(np.float32)
    want = np.asarray(jax_fft_mxu.overlap_save_fused(x, h, block=49_152))
    r = response_for(h, 49_152)
    assert r.geometry.kernel == "B9" and r.geometry.nfft == 1 << 16
    got = emulate_b9(x, r)
    assert rel_err(got, want) < 1e-5
    assert rel_err(got, fir64(x, h)) < 1e-5


def test_b9_index_map_and_permuted_response(rng):
    # the four-step pieces alone: H laid out [f1][f2] = H[f1 + n1*f2] (a transpose,
    # nothing bit-reversed), every twiddle exponent i2*f1 an exact integer below N
    h = taps_of(rng, 9000)
    r = response_for(h)
    g = r.geometry
    f1, f2 = np.meshgrid(np.arange(g.n1), np.arange(g.n2), indexing="ij")
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
    # B9: the column launches' lines and the row launch's exchanges, a line a stride
    for lines, m, smem in () if g.kernel == "B8" else (
        (g.g1, g.n1, g.column_smem_bytes), (g.g2, g.n2, g.row_smem_bytes - 16 * g.g2 * g.n2)
    ):
        line, pos = np.meshgrid(np.arange(lines), np.arange(m), indexing="ij")
        s = (line * fm.line_slots(m) + xslot(pos)).ravel()
        stages = 2 if smem == g.column_smem_bytes else 1
        if smem:  # (a warp plan's rows exchange by shuffles)
            assert np.unique(s).size == s.size and stages * (s.max() + 1) <= smem // 8
    assert g.smem_bytes <= fm.SMEM_MAX


@pytest.mark.parametrize("log2n", range(15, 21))
def test_b9_geometry_fits_the_card(log2n):
    """Every nfft B9 takes: threads, shared memory and registers of its launches fit an
    H100 SM at their launch bounds (128 registers a thread), and the waves are of equal
    size within the scratch."""
    nfft = 1 << log2n
    g = fm.FusedGeometry(k=2, block=nfft // 2, nfft=nfft)
    assert g.kernel == "B9" and g.n1 * g.n2 == nfft and g.n1 <= g.n2
    for m in (g.n1, g.n2):
        p, radices = fm.B9_LINE_PLANS[m.bit_length() - 1]
        assert np.prod(radices) == m and max(radices) <= p and m // p <= 64
    assert g.column_threads % 32 == 0 and 256 <= g.column_threads <= 512
    assert g.g1 >= 8 and (g.n2 // g.g1) * g.g1 == g.n2 and (g.n1 // g.g2) * g.g2 == g.n1
    blocks = 1 if g.column_threads > 256 else 2
    assert blocks * g.column_threads * 128 <= 65536  # the launch bounds' registers
    assert blocks * (g.column_smem_bytes + 1024) <= fm.SMEM_MAX
    assert 2 * (g.row_smem_bytes + 1024) <= fm.SMEM_MAX
    assert g.wave_pairs * 8 * nfft <= fm.FUSED3_SCRATCH_BYTES
    for pairs in (1, g.wave_pairs, g.wave_pairs + 1, 280, 10**4):
        waves = cdiv(pairs, g.wave_pairs)
        sizes = [(w + 1) * pairs // waves - w * pairs // waves for w in range(waves)]
        assert sum(sizes) == pairs and max(sizes) == g.wave(pairs) <= g.wave_pairs
        assert max(sizes) - min(sizes) <= 1  # no underfilled last wave


def test_b9_twiddles_are_accurate():
    """W_N^(i2 f1) for every i2 < n2, f1 < n1 at N = 2^15 .. 2^20: the float32 argument
    e * 2/N is exact and the twiddle within 1 float32 ulp of exp(-2 pi i e / N)."""
    for log2n in range(15, 21):
        g = fm.FusedGeometry(k=2, block=(1 << log2n) // 2, nfft=1 << log2n)
        e = (np.arange(g.n2)[:, None] * np.arange(g.n1)[None, :]).ravel()
        w = w_n(e, g.nfft).astype(np.complex128)  # asserts the exact argument
        want = np.exp(-2j * np.pi * e / g.nfft)
        assert np.abs(w - want).max() < 2.0**-24, log2n


def test_b9_staging_banks():
    """The column launches' staging at the main path's nfft 131072 (256-point columns,
    16 a block): each half-warp's 8-byte writes of a run of 16 samples, the reads into
    the lines' registers and the twiddled writes fall on 16 distinct banks."""
    g = fm.FusedGeometry(k=8194, block=122880, nfft=1 << 17)
    G, t1, stride = g.g1, fm.line_threads(g.n1), fm.line_slots(g.n1)
    tid = np.arange(g.column_threads)
    worst = 1
    for u in range(g.n1 // t1):
        e = tid + u * g.column_threads
        staged = (e % G) * stride + xslot(e // G)
        held = (tid // t1) * stride + xslot(tid % t1 + u * t1)
        for addr in (staged, held):
            for half in range(0, tid.size, 16):
                worst = max(worst, np.bincount(addr[half : half + 16] % 16).max())
    assert worst == 1


