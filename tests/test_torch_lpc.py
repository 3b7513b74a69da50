"""The port's LPC analysis and synthesis (B22, and B18 through ``factored``) and its
FFT windows against the JAX package.

The same NumPy inputs go through the JAX package and through the port on the
CPU, where B22 and B18 take their plain versions. Goldens, as in
tests/test_lpc.py: scipy's ``solve_toeplitz`` for Levinson and the float64
sequential loop ``lpc_synthesis_ref`` for synthesis.

Tolerances: the reference's own, 1e-3 of max|y| against float64 for order 8,
5e-3 for order 12 (float32 frame-parallel association amplified by resonant
poles), 1e-4 between engines; the factored engine within max(64 x the
sequential float32 error, 1e-5). Against the JAX package: 1e-4 of max|y|
for the synthesis engines (the two packages sum their scans over frames in
another order), 1e-4 for the polynomials, the windows bit for bit.
"""

import numpy as np
import pytest
import scipy.linalg as sla
from scipy.signal import lfilter as splf
import torch

from digital_signal_processsing_tpu.ops import fft as jax_fft
from digital_signal_processsing_tpu.ops import lpc as jax_lpc
from digital_signal_processsing_tpu_torch.ops import fft, lpc
from digital_signal_processsing_tpu_torch.utils import last_choice

F32 = np.float32


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(scope="module")
def colored():
    rng = np.random.default_rng(0)
    return splf([1.0], [1, -1.2, 0.7], rng.standard_normal(4480)).astype(F32)


def poly_rows(rng, frames, order, radius, lo=0.0, hi=np.pi):
    rows = []
    for _ in range(frames):
        poles = radius * np.exp(1j * rng.uniform(lo, hi, order // 2))
        rows.append(np.poly(np.concatenate([poles, poles.conj()])).real)
    return np.stack(rows, 0).astype(F32)


# --- windows ------------------------------------------------------------------------

WINDOWS = [
    "boxcar", "rect", "rectangular", "triang", "bartlett", "hann", "hanning", "hamming",
    "blackman", "blackmanharris", "nuttall", "flattop", "barthann", "bohman", "parzen", "cosine",
    "lanczos", ("kaiser", 8.6), ("gaussian", 7.0), ("exponential", None, 3.0), ("tukey", 0.3),
    ("tukey", 0.0), ("tukey", 1.0), ("general_cosine", [0.5, 0.3, 0.2]), ("general_hamming", 0.6),
    ("general_gaussian", 1.5, 7.0), ("chebwin", 80.0), ("taylor", 4, 30.0), ("dpss", 3.0),
]


@pytest.mark.parametrize("n", [1, 16, 33])
@pytest.mark.parametrize("window", WINDOWS, ids=str)
def test_get_window_matches_jax(window, n):
    for fftbins in (True, False):
        try:
            want = jax_fft.get_window(window, n, fftbins=fftbins)
        except ValueError:  # e.g. dpss shorter than 2 NW: refused by both
            with pytest.raises(ValueError):
                fft.get_window(window, n, fftbins=fftbins)
            continue
        got = fft.get_window(window, n, fftbins=fftbins)
        assert got.dtype == want.dtype, (window, n, fftbins)
        assert np.array_equal(got, want, equal_nan=True), (window, n, fftbins)


@pytest.mark.parametrize("window", ["hann", "sqrt_hann", "hamming", "rect", *WINDOWS], ids=str)
def test_spectral_window_matches_jax(window):
    for n in (16, 33):
        want = jax_fft.spectral_window(window, n)
        got = fft.spectral_window(window, n)
        assert got.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("window, n, fftbins", [
    ("nope", 8, True), (("kaiser",), 8, True), (("gaussian",), 8, True), ("hann", 0, True),
    (("kaiser_bessel_derived", 4.0), 8, True), (("kaiser_bessel_derived", 4.0), 7, False),
    (("exponential", 2.0, 1.0), 8, False), (("dpss",), 8, True), (("chebwin",), 8, True),
])
def test_window_refusals_match_jax(window, n, fftbins):
    with pytest.raises(ValueError):
        jax_fft.get_window(window, n, fftbins=fftbins)
    with pytest.raises(ValueError):
        fft.get_window(window, n, fftbins=fftbins)


def test_kbd_and_rfft():
    assert np.array_equal(fft.get_window(("kaiser_bessel_derived", 4.0), 16, fftbins=False),
                          jax_fft.get_window(("kaiser_bessel_derived", 4.0), 16, fftbins=False))
    x = np.random.default_rng(0).standard_normal((3, 100)).astype(F32)
    for n in (None, 64, 256):
        want = np.asarray(jax_fft.rfft(x, n=n))
        got = fft.rfft(t(x), n=n).numpy()
        assert np.abs(got - want).max() < 1e-4 * np.abs(want).max()


# --- analysis ---------------------------------------------------------------------------


def test_levinson_matches_toeplitz_and_jax(colored):
    p = 12
    sig = np.asarray(colored, np.float64)
    r = np.array([np.dot(sig[: sig.size - k], sig[k:]) for k in range(p + 1)])
    a_ref = np.concatenate([[1.0], sla.solve_toeplitz((r[:-1], r[:-1]), -r[1:])])
    a, k, err = lpc.levinson(t(r[None]))
    assert np.max(np.abs(a.numpy()[0] - a_ref)) < 1e-3
    assert err.numpy()[0] > 0 and np.all(np.abs(k.numpy()) < 1.0)
    aj, kj, ej = (np.asarray(v) for v in jax_lpc.levinson(r[None]))
    assert np.abs(a.numpy() - aj).max() < 1e-4 and np.abs(k.numpy() - kj).max() < 1e-4
    assert abs(err.numpy()[0] - ej[0]) < 1e-5 * ej[0]


def test_levinson_scale_invariant_batched(colored):
    p = 8
    sig = np.asarray(colored, np.float64)
    r = np.array([np.dot(sig[: sig.size - k], sig[k:]) for k in range(p + 1)])
    a, _, err = lpc.levinson(t(np.stack([r, 3.0 * r], 0).astype(F32)))
    assert np.allclose(a.numpy()[0], a.numpy()[1], atol=1e-5)
    assert np.allclose(err.numpy()[1], 3.0 * err.numpy()[0], rtol=1e-5)


@pytest.mark.parametrize("window, hop", [("hamming", None), ("hann", 80), ("rect", None),
                                         (None, 200)])
def test_lpc_analysis_matches_jax(colored, window, hop):
    x = np.stack([colored, colored[::-1].copy()])
    want_r = np.asarray(jax_lpc.frame_autocorr(x, 10, 160, hop=hop, window=window))
    got_r = lpc.frame_autocorr(t(x), 10, 160, hop=hop, window=window).numpy()
    assert rel(got_r, want_r) < 1e-5
    aj, gj = (np.asarray(v) for v in jax_lpc.lpc(x, 10, 160, hop=hop, window=window))
    a, g = lpc.lpc(t(x), 10, 160, hop=hop, window=window)
    assert np.abs(a.numpy() - aj).max() < 1e-4
    assert rel(g.numpy(), gj) < 1e-4


def test_ar_psd_matches_jax_and_analytic_ar2():
    import scipy.signal as sps

    rng = np.random.default_rng(0)
    r, th = 0.95, 2 * np.pi * 0.12
    a_true = np.array([1.0, -2 * r * np.cos(th), r * r])
    x = sps.lfilter([1.0], a_true, rng.standard_normal(1 << 16)).astype(F32)
    f, psd = lpc.ar_psd(t(x), 2, nfft=2048)
    psd = psd.numpy()
    fj, pj = jax_lpc.ar_psd(x, 2, nfft=2048)
    assert np.array_equal(f, np.asarray(fj)) and rel(psd, np.asarray(pj)) < 1e-4
    assert abs(f[np.argmax(psd)] - 0.12) < 2e-3
    w = 2 * np.pi * f
    a_w = a_true[0] + a_true[1] * np.exp(-1j * w) + a_true[2] * np.exp(-2j * w)
    ratio = psd / (1.0 / np.abs(a_w) ** 2)
    assert ratio.max() / ratio.min() < 1.2
    _, psd2 = lpc.ar_psd(t(x), 2, nfft=256, frame_len=4096)
    _, pj2 = jax_lpc.ar_psd(x, 2, nfft=256, frame_len=4096)
    assert psd2.shape == ((1 << 16) // 4096, 129) and rel(psd2.numpy(), np.asarray(pj2)) < 1e-4


# --- synthesis ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def order12():
    """tests/test_lpc.py's order-12 set, and the JAX package's refine and scan on it."""
    rng = np.random.default_rng(5)
    nf, fl, order = 9, 64, 12
    a = poly_rows(rng, nf, order, 0.8)
    gain = rng.uniform(0.5, 2.0, nf).astype(F32)
    e = rng.standard_normal(nf * fl).astype(F32)
    jax = {m: np.asarray(jax_lpc.lpc_synthesis(a, gain, e, fl, method=m)) for m in ("refine", "scan")}
    return a, gain, e, fl, jax_lpc.lpc_synthesis_ref(a, gain, e, fl), jax


@pytest.mark.parametrize("method", ["auto", "refine", "pallas", "scan"])
def test_synthesis_methods_match_golden_and_jax(order12, method):
    a, gain, e, fl, ref, jax = order12
    got = lpc.lpc_synthesis(t(a), t(gain), t(e), fl, method=method).numpy()
    assert rel(got, ref) < 5e-3
    assert np.array_equal(lpc.lpc_synthesis_ref(t(a), t(gain), t(e), fl), ref)
    if method in ("auto", "refine"):
        assert rel(got, jax["refine"]) < 1e-4
    else:
        # the compose: the two packages' scans over frames associate apart,
        # inside the reference's envelope against float64
        assert rel(got, jax["scan"]) < 5e-3


def test_engines_agree(order12):
    a, gain, e, fl, ref, _ = order12
    y_scan = lpc.lpc_synthesis(t(a), t(gain), t(e), fl, method="scan").numpy()
    y_pal = lpc.lpc_synthesis(t(a), t(gain), t(e), fl, method="pallas").numpy()
    assert rel(y_pal, y_scan) < 1e-4
    with pytest.raises(ValueError, match="multiple of"):
        lpc.lpc_synthesis(t(a), t(gain), t(e[: 9 * 60]), 60, method="pallas")
    with pytest.raises(ValueError, match="multiple of"):
        lpc.lpc_synthesis(t(a), t(gain), t(e[: 9 * 60]), 60, method="refine")
    with pytest.raises(ValueError, match="unknown method"):
        lpc.lpc_synthesis(t(a), t(gain), t(e), fl, method="warp")


def test_synthesis_matches_sequential_golden_batched():
    rng = np.random.default_rng(1)
    nf, fl, order = 7, 96, 8
    a = poly_rows(rng, nf, order, 0.85)
    gain = rng.uniform(0.5, 2.0, nf).astype(F32)
    e = rng.standard_normal(nf * fl).astype(F32)
    ref = lpc.lpc_synthesis_ref(a, gain, e, fl)
    got = lpc.lpc_synthesis(t(a), t(gain), t(e), fl).numpy()
    assert rel(got, ref) < 1e-3
    got_b = lpc.lpc_synthesis(t(np.stack([a, a])), t(np.stack([gain, 0.5 * gain])),
                              t(np.stack([e, e])), fl).numpy()
    assert np.allclose(got_b[0], got, atol=1e-5)
    assert np.allclose(got_b[1], 0.5 * got, atol=1e-4)


def test_odd_frame_length_takes_the_scan_spelling_like_jax():
    rng = np.random.default_rng(2)
    nf, fl, order = 6, 100, 10
    a = poly_rows(rng, nf, order, 0.8)
    gain = rng.uniform(0.5, 2.0, nf).astype(F32)
    e = rng.standard_normal(nf * fl).astype(F32)
    want = np.asarray(jax_lpc.lpc_synthesis(a, gain, e, fl))
    got = lpc.lpc_synthesis(t(a), t(gain), t(e), fl).numpy()
    assert rel(got, want) < 1e-4
    assert rel(got, lpc.lpc_synthesis_ref(a, gain, e, fl)) < 1e-3


def test_residual_resynthesis_reconstructs(colored):
    x = colored
    order, fl = 10, 160
    a, _ = lpc.lpc(t(x), order, fl)
    a = a.numpy()
    nf = a.shape[0]
    resid = np.zeros(nf * fl)
    hist = np.zeros(order)
    for f in range(nf):
        for j in range(fl):
            i = f * fl + j
            resid[i] = x[i] + np.dot(a[f, 1:], hist)
            hist = np.concatenate([[x[i]], hist[:-1]])
    recon = lpc.lpc_synthesis(t(a), torch.ones(nf), t(resid.astype(F32)), fl).numpy()
    assert np.max(np.abs(recon - x[: nf * fl])) / np.max(np.abs(x)) < 1e-3


def test_refine_beats_compose_at_resonant_poles():
    rng = np.random.default_rng(9)
    nf, fl, order = 6, 64, 8
    a = poly_rows(rng, nf, order, 0.8, 0.3, 2.8)
    gain = rng.uniform(0.8, 1.2, nf).astype(F32)
    e = rng.standard_normal(nf * fl).astype(F32)
    ref = lpc.lpc_synthesis_ref(a, gain, e, fl)
    err_ref = rel(lpc.lpc_synthesis(t(a), t(gain), t(e), fl, method="refine").numpy(), ref)
    err_comp = rel(lpc.lpc_synthesis(t(a), t(gain), t(e), fl, method="pallas").numpy(), ref)
    assert err_ref < 1e-4 and err_comp > err_ref


def seq_f32(a, gain, e, frame_len):
    a, g, e = (np.asarray(v, F32) for v in (a, gain, e))
    p = a.shape[-1] - 1
    y = np.zeros(a.shape[0] * frame_len, F32)
    hist = np.zeros(p, F32)
    for f in range(a.shape[0]):
        for j in range(frame_len):
            i = f * frame_len + j
            v = F32(g[f] * e[i] - np.dot(a[f, 1:], hist))
            hist = np.concatenate([[v], hist[:-1]]).astype(F32)
            y[i] = v
    return y


@pytest.mark.parametrize("radius", [0.95, 0.98, 0.995, 0.999])
def test_factored_resonant_sweep(radius):
    rng = np.random.default_rng(int(radius * 1000))
    order, fl, nf = 6, 128, 8
    poles = radius * np.exp(1j * np.array([0.4, 1.3, 2.2]))
    row = np.poly(np.concatenate([poles, poles.conj()])).real
    a = np.tile(row, (nf, 1)).astype(F32)
    gain = np.ones(nf, F32)
    e = rng.standard_normal(nf * fl).astype(F32)
    ref = lpc.lpc_synthesis_ref(a, gain, e, fl)
    err_fact = rel(lpc.lpc_synthesis(t(a), t(gain), t(e), fl, method="factored").numpy(), ref)
    err_seq32 = rel(seq_f32(a, gain, e, fl), ref)
    assert err_fact < max(err_seq32 * 64, 1e-5), (radius, err_fact, err_seq32)
    auto = lpc.lpc_synthesis(t(a), t(gain), t(e), fl)
    assert last_choice("lpc_synthesis") == "factored"
    assert rel(auto.numpy(), ref) < max(err_seq32 * 64, 1e-5)
    if radius >= 0.98:
        err_refine = rel(lpc.lpc_synthesis(t(a), t(gain), t(e), fl, method="refine").numpy(), ref)
        assert err_fact < err_refine / 100, (radius, err_fact, err_refine)


def test_factored_matches_jax():
    rng = np.random.default_rng(3)
    fl, nf = 128, 4
    poles = 0.995 * np.exp(1j * np.array([0.5, 1.9]))
    row = np.poly(np.concatenate([poles, poles.conj()])).real
    a = np.tile(row, (nf, 1)).astype(F32)
    gain = np.ones(nf, F32)
    e = rng.standard_normal(nf * fl).astype(F32)
    want = np.asarray(jax_lpc.lpc_synthesis(a, gain, e, fl, method="factored"))
    got = lpc.lpc_synthesis(t(a), t(gain), t(e), fl, method="factored").numpy()
    assert rel(got, want) < 1e-5
    sos, maxr = lpc.lpc_to_sections(a[:1])
    sos_j, maxr_j = jax_lpc.lpc_to_sections(a[:1])
    assert np.array_equal(sos, sos_j) and maxr == maxr_j == pytest.approx(0.995, abs=1e-6)
    # frame-varying coefficients stay off the factored route
    a_var = a.copy()
    a_var[1, 1] *= 0.999
    assert lpc._constant_frame_row(a_var) is None


def test_auto_factors_once(monkeypatch):
    """The reference's auto factors a frame-constant resonant set twice; the port once."""
    calls = []
    real = lpc.lpc_to_sections

    def counted(a):
        calls.append(np.shape(a))
        return real(a)

    monkeypatch.setattr(lpc, "lpc_to_sections", counted)
    rng = np.random.default_rng(4)
    fl, nf = 64, 6
    poles = 0.99 * np.exp(1j * np.array([0.7, 2.0]))
    a = np.tile(np.poly(np.concatenate([poles, poles.conj()])).real, (nf, 1)).astype(F32)
    e = t(rng.standard_normal(nf * fl).astype(F32))
    lpc.lpc_synthesis(t(a), torch.ones(nf), e, fl)
    assert len(calls) == 1 and calls[0] == (1, 5)
    calls.clear()
    lpc.lpc_synthesis(t(a), torch.ones(nf), e, fl, method="factored")
    assert len(calls) == 1
    calls.clear()
    damped = poly_rows(rng, nf, 4, 0.5)
    lpc.lpc_synthesis(t(damped), torch.ones(nf), e, fl)  # frame-varying: no factoring
    assert calls == []


def test_vocoder_matches_jax_with_the_same_excitation(colored):
    x = colored
    e = np.random.default_rng(6).standard_normal(x.size).astype(F32)
    want = np.asarray(jax_lpc.lpc_vocoder(x, 10, 100, excitation=e))
    got = lpc.lpc_vocoder(t(x), 10, 100, excitation=t(e)).numpy()
    assert rel(got, want) < 1e-4


def test_vocoder_keeps_spectral_tilt(colored):
    x = colored
    y = lpc.lpc_vocoder(t(x), 10, 160).numpy()
    assert np.isfinite(y).all() and y.shape == ((x.size // 160) * 160,)

    def bandpow(sig, lo, hi):
        s = np.abs(np.fft.rfft(sig)) ** 2
        f = np.linspace(0, 0.5, s.size)
        return s[(f >= lo) & (f < hi)].mean()

    tilt_x = bandpow(x, 0.0, 0.1) / bandpow(x, 0.3, 0.5)
    tilt_y = bandpow(y, 0.0, 0.1) / bandpow(y, 0.3, 0.5)
    assert 0.1 * tilt_x < tilt_y < 10 * tilt_x


def test_synth_pass_refusals():
    z = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="for 4 frames"):
        lpc.lpc_synth_pass(torch.zeros(5, 3), z, torch.zeros(4, 8))
    with pytest.raises(ValueError, match="float32"):
        lpc.lpc_synth_pass(z.double(), z, torch.zeros(4, 8))


# --- B22 emulated block by block (csrc/lpc.cu) ----------------------------------------------

# kFrames, kChunk, kRow, kStages, kMaxUnrolled of csrc/lpc.cu
B22_FRAMES, B22_CHUNK, B22_ROW, B22_STAGES, B22_UNROLLED = 128, 32, 36, 3, 32


def _mul(a, b):
    return (np.asarray(a, F32) * np.asarray(b, F32)).astype(F32)


def emulate_b22(a_f, s0, e, *, keep_y=True, aligned=True, stats=None):
    """B22's blocks as csrc/lpc.cu runs them, in NumPy float32 in the kernel's order.

    A block holds kFrames frames, a thread each. Chunk c of every frame (kChunk
    samples) is staged into stage c % kStages (rows of kRow floats) by the
    thread's copies of piece q = tid % 8: 16 bytes where the rows lie on the
    16-byte grid (``aligned`` and L % 4 == 0) and the piece is whole, else 4
    bytes a sample; chunk c + 1 is staged while c is computed and c - 1 stored.
    The stages start as NaN, so a stale word that reached an output would show.
    Orders up to 32 keep the history as a ring of P registers: step j of a
    chunk reads h[i] at hr[(j - 1 - i) % P] and writes hr[j % P]; a whole chunk
    ends with the ring rotated by kChunk mod P back to h[i] = hr[P - 1 - i]; the
    last chunk guards its steps and the end state is read out of the ring by
    its count. Orders past 32 keep a circular row, h[i] at hist[(pos + i) % p].
    ``keep_y=False`` is the state-only entry: nothing is stored.
    """
    frames, length = e.shape
    p = a_f.shape[1]
    vec = aligned and length % 4 == 0
    stats = {} if stats is None else stats
    y = np.full_like(e, np.nan) if keep_y else None
    z = np.zeros_like(s0)
    nch = -(-length // B22_CHUNK)

    def count(key, k):
        stats[key] = stats.get(key, 0) + k

    for f0 in range(0, frames, B22_FRAMES):
        nb = min(B22_FRAMES, frames - f0)
        fr = slice(f0, f0 + nb)
        stages = np.full((B22_STAGES, B22_FRAMES, B22_ROW), np.nan, F32)

        def load(st, t0, cnt):
            for q in range(B22_CHUNK // 4):
                lo = 4 * q
                if vec and lo + 4 <= cnt:
                    stages[st, :nb, lo : lo + 4] = e[fr, t0 + lo : t0 + lo + 4]
                    count("vector copies", nb)
                else:
                    for i in range(min(4, max(cnt - lo, 0))):
                        stages[st, :nb, lo + i] = e[fr, t0 + lo + i]
                        count("scalar copies", nb)

        def store(st, t0, cnt):
            for q in range(B22_CHUNK // 4):
                lo = 4 * q
                if vec and lo + 4 <= cnt:
                    y[fr, t0 + lo : t0 + lo + 4] = stages[st, :nb, lo : lo + 4]
                    count("vector stores", nb)
                else:
                    for i in range(min(4, max(cnt - lo, 0))):
                        y[fr, t0 + lo + i] = stages[st, :nb, lo + i]
                        count("scalar stores", nb)

        a = a_f[fr]
        if p <= B22_UNROLLED:
            hr = np.empty((nb, p), F32)
            hr[:, p - 1 - np.arange(p)] = s0[fr]
        else:
            hist, pos = s0[fr].copy(), 0
        load(0, 0, min(length, B22_CHUNK))
        cur = 0
        for c in range(nch):
            t0 = c * B22_CHUNK
            if c + 1 < nch:
                load((cur + 1) % B22_STAGES, t0 + B22_CHUNK, min(B22_CHUNK, length - t0 - B22_CHUNK))
            if c > 0 and keep_y:
                store((cur - 1) % B22_STAGES, t0 - B22_CHUNK, B22_CHUNK)
            row = stages[cur, :nb]
            cnt = min(B22_CHUNK, length - t0)
            if p <= B22_UNROLLED:
                last = c + 1 == nch
                for j in range(B22_CHUNK):
                    if last and j >= cnt:
                        count("guarded steps", 1)
                        continue
                    acc = row[:, j].copy()
                    for i in range(p):
                        acc = (acc - _mul(a[:, i], hr[:, (j - 1 - i) % p])).astype(F32)
                    hr[:, j % p] = acc
                    row[:, j] = acc
                if not last:
                    hr = hr[:, (np.arange(p) + B22_CHUNK) % p]
                    count("rotations", 1)
            else:
                for j in range(cnt):
                    acc = row[:, j].copy()
                    for i in range(p):
                        acc = (acc - _mul(a[:, i], hist[:, (pos + i) % p])).astype(F32)
                    pos = p - 1 if pos == 0 else pos - 1
                    hist[:, pos] = acc
                    row[:, j] = acc
            cur = (cur + 1) % B22_STAGES
        if keep_y:
            t0 = (nch - 1) * B22_CHUNK
            store((cur - 1) % B22_STAGES, t0, length - t0)
        if p <= B22_UNROLLED:
            cnt = length - (nch - 1) * B22_CHUNK
            for m in range(p):
                z[fr, (cnt - 1 - m) % p] = hr[:, m]
        else:
            z[fr] = hist[:, (pos + np.arange(p)) % p]
    return y, z


def b22_case(p, length, frames, seed=0):
    rng = np.random.default_rng(seed * 1000 + p)
    a_f = (0.9 / p * rng.uniform(-1, 1, (frames, p))).astype(F32)
    s0 = rng.standard_normal((frames, p)).astype(F32)
    e = rng.standard_normal((frames, length)).astype(F32)
    return a_f, s0, e


@pytest.mark.parametrize("p", [1, 2, 12, 32, 40])
@pytest.mark.parametrize("length,frames", [(256, 129), (100, 300), (33, 7), (8, 128), (70, 1)])
def test_b22_block_algorithm(p, length, frames):
    """The staging ring, the history unrolled by p with its rotation at whole chunks
    (a remainder when 32 % p != 0), the guarded last chunk (L not a multiple of the
    chunk), frames not a multiple of the block: bit for bit the plain version; the
    state-only entry's end state bit for bit the full pass's."""
    a_f, s0, e = b22_case(p, length, frames)
    stats = {}
    y, z = emulate_b22(a_f, s0, e, stats=stats)
    yp, zp = lpc._lpc_pass_plain(t(a_f), t(s0), t(e))
    assert np.array_equal(y, yp.numpy()) and np.array_equal(z, zp.numpy())
    _, zs = emulate_b22(a_f, s0, e, keep_y=False)
    assert np.array_equal(zs, z)
    assert np.array_equal(lpc.lpc_synth_state(t(a_f), t(s0), t(e)).numpy(), z)
    chunks = -(-length // B22_CHUNK)
    if p <= B22_UNROLLED:
        assert stats.get("rotations", 0) == -(-frames // B22_FRAMES) * (chunks - 1)
        assert stats.get("guarded steps", 0) == -(-frames // B22_FRAMES) * (chunks * B22_CHUNK - length)
    assert bool(stats.get("vector copies")) == (length % 4 == 0 and length >= 4)


@pytest.mark.parametrize("length", [256, 100])
def test_b22_rows_off_the_grid(length):
    """Rows off the 16-byte grid go 4 bytes a sample, with the same bits."""
    a_f, s0, e = b22_case(12, length, 130, seed=3)
    aligned, misaligned = {}, {}
    y, z = emulate_b22(a_f, s0, e, stats=aligned)
    y2, z2 = emulate_b22(a_f, s0, e, aligned=False, stats=misaligned)
    assert np.array_equal(y, y2) and np.array_equal(z, z2)
    assert aligned["vector copies"] and aligned["vector stores"]
    assert "vector copies" not in misaligned and "vector stores" not in misaligned


@pytest.mark.parametrize("method,state_passes", [("refine", 2), ("pallas", 1)])
def test_refine_and_pallas_take_the_state_only_entry(order12, monkeypatch, method, state_passes):
    """Every pass whose y is thrown away is the state-only entry (B22 writes only the
    end state); one full pass; the result within the existing tolerances of the JAX
    package's and of float64."""
    a, gain, e, fl, ref, jax = order12
    calls = {"state": 0, "pass": 0}
    real_state, real_pass = lpc.lpc_synth_state, lpc.lpc_synth_pass

    def state(*args):
        calls["state"] += 1
        return real_state(*args)

    def full(*args):
        calls["pass"] += 1
        return real_pass(*args)

    monkeypatch.setattr(lpc, "lpc_synth_state", state)
    monkeypatch.setattr(lpc, "lpc_synth_pass", full)
    got = lpc.lpc_synthesis(t(a), t(gain), t(e), fl, method=method).numpy()
    assert calls == {"state": state_passes, "pass": 1}
    assert rel(got, ref) < 5e-3
    assert rel(got, jax["refine"] if method == "refine" else jax["scan"]) < (1e-4 if method == "refine" else 5e-3)
