"""The port's spectral surface (``ops/fft.py``, the streaming STFT/ISTFT,
``ops/cepstrum.py``, ``ops/stft_class.py``) against the JAX package and scipy.

The same seeded NumPy inputs go through the JAX package and the port
(``torch.fft`` on the CPU), and where scipy has the function, through scipy
in float64.

Tolerances (each relative to max|want|):

- 1e-5 (``TOL``), the default: float32 transforms of a few thousand points
  err about 1e-7 to 1e-6 of the output;
- ``method="mxu"``: the port computes it with ``torch.fft``; the JAX
  package's DFT matmuls can err more than its ``xla`` FFT against float64
  (ROADMAP H3, about 1e-5 on its TPU), so the port is held to the JAX
  ``mxu`` result within the larger of ``TOL`` and twice that error as
  measured on the test's own input (``mxu_tol``). On the CPU it measured
  1.6e-7 (stft, nfft 512) and 2.5e-7 (istft against ``xla``), so ``TOL``
  holds; and within ``TOL`` of float64. The chirp-z transform takes the same
  rule against scipy's float64 ``czt``;
- the FIR Hilbert transformer: the port (overlap-save ``torch.fft``) and
  the JAX package (a direct convolution) within ``TOL``; against scipy's
  exact analytic signal it is an approximation, not compared;
- the complex cepstrum: the phase is unwrapped, so the inputs are smooth
  (decaying, echoed) signals whose spectra stay away from zeros; 1e-4 of
  max|c| against the JAX package and float64, the log of a float32 spectrum
  amplifying its rounding by the inverse of its smallest magnitude.
"""

import importlib

import numpy as np
import pytest
import scipy.signal as sps
import torch

from digital_signal_processsing_tpu.ops import cepstrum as jcep
from digital_signal_processsing_tpu.ops import fft as jfft
from digital_signal_processsing_tpu.ops import stft_class as jsc
from digital_signal_processsing_tpu.ops import streaming as jstream
from digital_signal_processsing_tpu_torch.ops import cepstrum as tcep
from digital_signal_processsing_tpu_torch.ops import stft_class as tsc
from digital_signal_processsing_tpu_torch.ops import streaming as tstream
from digital_signal_processsing_tpu_torch.utils import last_choice

tfft = importlib.import_module("digital_signal_processsing_tpu_torch.ops.fft")

TOL = 1e-5
CEPS_TOL = 1e-4
T = 4096


def rel(got, want) -> float:
    got = got.resolve_conj().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = want.resolve_conj().numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    got, want = got.astype(np.complex128), want.astype(np.complex128)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def t_(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def sig():
    r = np.random.default_rng(1801)
    return r.standard_normal((2, T)).astype(np.float32), r.standard_normal((2, T)).astype(np.float32)


def frames64(x, nfft, hop, w, detrend=False):
    n = (x.shape[-1] - nfft) // hop + 1
    idx = np.arange(n)[:, None] * hop + np.arange(nfft)[None, :]
    seg = x.astype(np.float64)[..., idx]
    if detrend:
        seg = seg - seg.mean(-1, keepdims=True)
    return np.fft.rfft(seg * w, axis=-1)


def mxu_tol(jax_out, want64) -> float:
    return max(TOL, 2.0 * rel(jax_out, want64))


def test_fft_wrappers(sig):
    x = sig[0]
    for name, arg in (("fft", x), ("rfft", x), ("ifft", x), ("irfft", np.fft.rfft(x).astype(np.complex64))):
        got = getattr(tfft, name)(t_(arg), n=1000)
        want64 = getattr(np.fft, name)(arg.astype(np.complex128 if arg.dtype.kind == "c" else np.float64), n=1000)
        assert rel(got, want64) < TOL, name
        assert rel(got, getattr(jfft, name)(arg, n=1000)) < TOL, name


@pytest.mark.parametrize(
    "nfft,hop,window,detrend",
    [(512, 128, "hann", False), (256, 100, "sqrt_hann", True), (300, 75, ("kaiser", 8.0), False)],
)
def test_stft_matches_jax_and_float64(sig, nfft, hop, window, detrend):
    x = sig[0]
    w = tfft.spectral_window(window, nfft).astype(np.float64)
    want64 = frames64(x, nfft, hop, w, detrend)
    got = tfft.stft(t_(x), nfft=nfft, hop=hop, window=window, detrend_segments=detrend)
    assert got.dtype == torch.complex64
    assert rel(got, want64) < TOL
    assert rel(got, jfft.stft(x, nfft=nfft, hop=hop, window=window, detrend_segments=detrend)) < TOL
    one = tfft.stft(t_(x[0]), nfft=nfft, hop=hop, window=window, detrend_segments=detrend)
    assert rel(one, got[0]) == 0.0


def test_stft_mxu_within_the_reference_engines_error(sig):
    """The port's method='mxu' (torch.fft) against the JAX package's mxu
    (its dense framed DFT matmuls) on the CPU."""
    x = sig[0]
    w = tfft.spectral_window("hann", 512).astype(np.float64)
    want64 = frames64(x, 512, 128, w)
    j = jfft.stft(x, nfft=512, hop=128, method="mxu")
    got = tfft.stft(t_(x), nfft=512, hop=128, method="mxu")
    assert rel(got, want64) < TOL
    assert rel(got, j) < mxu_tol(j, want64)
    s = np.asarray(jfft.stft(x, nfft=512, hop=256, window="sqrt_hann"))
    ji = jfft.istft(s, nfft=512, hop=256, method="mxu")
    want = jfft.istft(s, nfft=512, hop=256)
    got = tfft.istft(t_(s), nfft=512, hop=256, method="mxu")
    assert rel(got, want) < TOL
    assert rel(got, ji) < mxu_tol(ji, want)


@pytest.mark.parametrize("nfft,hop", [(512, 256), (256, 64)])
def test_istft_round_trip(sig, nfft, hop):
    x = sig[0]
    s = tfft.stft(t_(x), nfft=nfft, hop=hop, window="sqrt_hann")
    y = tfft.istft(s, nfft=nfft, hop=hop, window="sqrt_hann")
    assert rel(y, jfft.istft(s.numpy(), nfft=nfft, hop=hop, window="sqrt_hann")) < TOL
    gain = nfft / (2 * hop)  # sqrt-hann pair overlap-adds to nfft/(2 hop)
    inner = slice(nfft, y.shape[-1] - nfft)
    assert rel(y[:, inner].numpy() / gain, x[:, inner]) < TOL
    assert tfft.istft(s[0], nfft=nfft, hop=hop).shape == (y.shape[-1],)


@pytest.mark.parametrize("scaling", ["density", "spectrum"])
def test_psd_family(sig, scaling):
    x, y = sig
    kw = dict(nfft=256, window="hann", fs=8000.0, scaling=scaling)
    got = tfft.welch(t_(x), **kw)
    ref = sps.welch(x.astype(np.float64), fs=8000.0, nperseg=256, noverlap=128, window="hann",
                    detrend=False, scaling=scaling)[1]
    assert rel(got, ref) < TOL
    assert rel(got, jfft.welch(x, **kw)) < TOL
    got = tfft.welch(t_(x), detrend_segments=True, hop=64, **kw)
    ref = sps.welch(x.astype(np.float64), fs=8000.0, nperseg=256, noverlap=192, window="hann",
                    detrend="constant", scaling=scaling)[1]
    assert rel(got, ref) < TOL
    got = tfft.csd(t_(x), t_(y), **kw)
    ref = sps.csd(x.astype(np.float64), y.astype(np.float64), fs=8000.0, nperseg=256, noverlap=128,
                  window="hann", detrend=False, scaling=scaling)[1]
    assert got.dtype == torch.complex64 and rel(got, ref) < TOL
    assert rel(got, jfft.csd(x, y, **kw)) < TOL
    got = tfft.periodogram(t_(x), fs=8000.0, nfft=5000, window="hann", scaling=scaling)
    ref = sps.periodogram(x.astype(np.float64), fs=8000.0, nfft=5000, window="hann", scaling=scaling)[1]
    assert rel(got, ref) < TOL
    assert rel(got, jfft.periodogram(x, fs=8000.0, nfft=5000, window="hann", scaling=scaling)) < TOL
    assert rel(tfft.periodogram(t_(x[0]), scaling=scaling), jfft.periodogram(x[0], scaling=scaling)) < TOL


def test_coherence_spectrogram_power(sig):
    x, y = sig
    mix = (0.6 * x + 0.4 * y).astype(np.float32)
    got = tfft.coherence(t_(x), t_(mix), nfft=256)
    ref = sps.coherence(x.astype(np.float64), mix.astype(np.float64), nperseg=256, noverlap=128,
                        window="hann", detrend=False)[1]
    assert got.dtype == torch.float32 and rel(got, ref) < TOL
    assert rel(got, jfft.coherence(x, mix, nfft=256)) < TOL
    got = tfft.spectrogram(t_(x), nfft=256, hop=64)
    assert rel(got, jfft.spectrogram(x, nfft=256, hop=64)) < TOL
    w = tfft.spectral_window("hann", 256).astype(np.float64)
    assert rel(got, np.abs(frames64(x, 256, 64, w)) ** 2) < TOL
    got = tfft.power_spectrum(t_(x), nfft=256)
    assert rel(got, jfft.power_spectrum(x, nfft=256)) < TOL
    assert rel(got, (np.abs(frames64(x, 256, 256, 1.0)) ** 2).mean(-2)) < TOL


def test_tone_power(sig):
    n = np.arange(T)
    x = (1.5 * np.sin(2 * np.pi * 0.1234567 * n) + 0.1 * sig[0]).astype(np.float32)
    f = np.array([0.1234567, 0.3, 0.01], np.float32)
    got = tfft.tone_power(t_(x), f)
    ph = 2 * np.pi * np.outer(f.astype(np.float64), n)
    want64 = 2 * ((x.astype(np.float64) @ np.cos(ph).T / T) ** 2 + (x.astype(np.float64) @ np.sin(ph).T / T) ** 2)
    assert got.shape == (2, 3) and rel(got, want64) < TOL
    assert rel(got, jfft.tone_power(x, f)) < TOL
    assert abs(got[0, 0].item() - 1.125) < 0.02  # amplitude^2 / 2


def test_hilbert_routes(sig):
    x = sig[0]
    for t in (T, T - 1):  # even and odd lengths: the Nyquist bin
        got = tfft.hilbert(t_(x[:, :t]), method="fft")
        assert last_choice("hilbert") == "fft" and got.dtype == torch.complex64
        assert rel(got, sps.hilbert(x[:, :t].astype(np.float64), axis=-1)) < TOL
        assert rel(got, jfft.hilbert(x[:, :t], method="fft")) < TOL
    got = tfft.hilbert(t_(x), method="auto")
    assert last_choice("hilbert") == "fft"
    got = tfft.hilbert(t_(x), method="fir", num_taps=65)
    assert last_choice("hilbert") == "fir"
    assert rel(got, jfft.hilbert(x, method="fir", num_taps=65)) < TOL
    assert rel(tfft.envelope(t_(x[0])), jfft.envelope(x[0])) < TOL


def test_hilbert_fir_past_two_rows(sig):
    """t > 2*row_len: the JAX package folds the stream into overlapping
    rows; the port filters it whole. Same function."""
    x = sig[0]
    want = jfft.hilbert_fir(x, num_taps=129, row_len=1000)
    got = tfft.hilbert_fir(t_(x), num_taps=129, row_len=1000)
    assert rel(got, want) < TOL
    assert rel(got, tfft.hilbert_fir(t_(x), num_taps=129)) < TOL
    assert rel(tfft.hilbert_fir(t_(x[0]), num_taps=129, row_len=1000), want[0]) < TOL
    np.testing.assert_array_equal(tfft.design_hilbert_fir(129), jfft.design_hilbert_fir(129))


def test_hilbert_auto_takes_fir_from_the_threshold(monkeypatch):
    monkeypatch.setattr(tfft, "HILBERT_BLOCKED_MIN_T", 1000)
    tfft.hilbert(torch.zeros(1000), num_taps=33)
    assert last_choice("hilbert") == "fir"
    tfft.hilbert(torch.zeros(999), num_taps=33)
    assert last_choice("hilbert") == "fft"


@pytest.mark.parametrize("t,m,route", [(1000, 300, "matmul"), (4097, 3000, "bluestein")])
def test_czt_routes(sig, t, m, route):
    x = sig[0][0, :t]
    w, a = np.exp(-0.013j), 0.99 * np.exp(0.3j)
    want64 = sps.czt(x.astype(np.float64), m, w, a)
    got = tfft.czt(t_(x), m, w, a)
    assert last_choice("czt") == route and got.dtype == torch.complex64
    jw = jfft.czt(x, m, complex(w), complex(a))
    tol = max(TOL, 2 * rel(jw, want64))
    assert rel(got, want64) < tol
    assert rel(got, jw) < tol
    z = (x + 1j * sig[1][0, :t]).astype(np.complex64)
    got = tfft.czt(t_(z), m, w, a)
    assert rel(got, sps.czt(z.astype(np.complex128), m, w, a)) < tol


def test_zoom_and_plans(sig):
    x = sig[0][0, :1000]
    got = tfft.zoomfft(t_(x), [0.1, 0.3], 200)
    assert rel(got, sps.zoom_fft(x.astype(np.float64), [0.1, 0.3], 200)) < TOL
    assert rel(got, jfft.zoomfft(x, [0.1, 0.3], 200)) < TOL
    assert rel(tfft.zoomfft(t_(x), 0.5), sps.zoom_fft(x.astype(np.float64), 0.5)) < TOL
    plan = tfft.ZoomFFT(1000, [0.1, 0.3], 200)
    assert rel(plan(t_(x)), got) < TOL
    xs = np.stack([x, 2 * x], 0).T.copy()  # transform along axis 0
    c = tfft.CZT(1000, 64)
    assert rel(c(t_(xs), axis=0), sps.CZT(1000, 64)(xs.astype(np.float64), axis=0)) < TOL
    np.testing.assert_allclose(c.points(), sps.CZT(1000, 64).points(), rtol=1e-12)
    np.testing.assert_allclose(tfft.czt_points(16, 0.9, 1.1), sps.czt_points(16, 0.9, 1.1), rtol=1e-12)
    np.testing.assert_array_equal(tfft.czt_points(16, 0.9, 1.1), jfft.czt_points(16, 0.9, 1.1))
    assert rel(c(t_(xs), axis=0), jfft.CZT(1000, 64)(xs, axis=0)) < TOL
    assert rel(plan(t_(x)), jfft.ZoomFFT(1000, [0.1, 0.3], 200)(x)) < TOL
    for part_t, part_j in zip(tfft._czt_chirp(50, 20, 0.99 * np.exp(-0.1j), 1.01 + 0.2j),
                              jfft._czt_chirp(50, 20, 0.99 * np.exp(-0.1j), 1.01 + 0.2j)):
        np.testing.assert_array_equal(part_t, part_j)
    assert (tfft.FFT_METHODS, tfft.XLA_FFT_MAX_N, tfft.HILBERT_BLOCKED_MIN_T, tfft.HILBERT_XLA_MAX_T) == (
        jfft.FFT_METHODS, jfft.XLA_FFT_MAX_N, jfft.HILBERT_BLOCKED_MIN_T, jfft.HILBERT_XLA_MAX_T)
    assert rel(tfft.czt(t_(x)), np.fft.fft(x.astype(np.float64))) < TOL


def test_hilbert2(sig):
    x = sig[0].reshape(2, 64, 64)[0]
    got = tfft.hilbert2(t_(x))
    assert rel(got, sps.hilbert2(x.astype(np.float64))) < TOL
    assert rel(got, jfft.hilbert2(x)) < TOL
    assert rel(tfft.hilbert2(t_(x), n=(70, 33)), jfft.hilbert2(x, n=(70, 33))) < TOL


def test_wola_checks():
    for window, nperseg, noverlap in (("hann", 256, 128), ("hann", 256, 100), ("boxcar", 64, 0),
                                      (("kaiser", 6.0), 128, 96), ("hamming", 100, 75)):
        assert tfft.check_cola(window, nperseg, noverlap) == bool(sps.check_COLA(window, nperseg, noverlap))
        assert tfft.check_nola(window, nperseg, noverlap) == bool(sps.check_NOLA(window, nperseg, noverlap))
        assert tfft.check_cola(window, nperseg, noverlap) == jfft.check_cola(window, nperseg, noverlap)
        assert tfft.check_nola(window, nperseg, noverlap) == jfft.check_nola(window, nperseg, noverlap)
    w = np.zeros(64)
    w[:8] = 1.0
    assert not tfft.check_nola(w, 64, 32) and not sps.check_NOLA(w, 64, 32)


def test_multitaper_psd(sig):
    x = sig[0]
    for kw in (dict(), dict(nw=2.5, k_tapers=3, nfft=5000, fs=100.0, scaling="spectrum")):
        got = tfft.multitaper_psd(t_(x), **kw)
        assert rel(got, jfft.multitaper_psd(x, **kw)) < TOL
    tapers, _ = tfft.dpss_windows(T, 4.0, 7)
    xm = x.astype(np.float64) - x.mean(-1, keepdims=True)
    want64 = (np.abs(np.fft.rfft(xm[:, None, :] * tapers, axis=-1)) ** 2).mean(-2)
    want64[:, 1:-1] *= 2
    assert rel(tfft.multitaper_psd(t_(x)), want64) < TOL


def test_spectral_refusals():
    x = torch.zeros(2, 1024)
    cases = [
        lambda: tfft.stft(x, hop=0),
        lambda: tfft.stft(x, method="cufft"),
        lambda: tfft.istft(torch.zeros(2, 3, 257, dtype=torch.complex64), nfft=512, hop=200),
        lambda: tfft.welch(x, scaling="power"),
        lambda: tfft.welch(x, hop=0),
        lambda: tfft.periodogram(x, nfft=100),
        lambda: tfft.hilbert(x, method="xla"),
        lambda: tfft.design_hilbert_fir(64),
        lambda: tfft.czt(x, 0),
        lambda: tfft.zoomfft(x, [0.5, 0.1]),
        lambda: tfft.hilbert2(torch.zeros(8)),
        lambda: tfft.hilbert2(torch.zeros(8, 8), n=(0, 4)),
        lambda: tfft.check_cola("hann", 64, 64),
        lambda: tfft.check_nola(np.ones(10), 64, 0),
        lambda: tfft.multitaper_psd(x, scaling="power"),
        lambda: tstream.stft_init(512, 200, device="cpu"),
        lambda: tstream.istft_init(512, 0, device="cpu"),
        lambda: tstream.stft_chunk(tstream.stft_init(512, 256, 2, device="cpu"), torch.zeros(2, 100),
                                   nfft=512, hop=256),
    ]
    for case in cases:
        with pytest.raises(ValueError):
            case()


# --- streaming STFT / ISTFT -------------------------------------------------------

CHUNKS = (0, 256, 1024, 1280, 3072, T)


def test_stft_chunks_match_primed_one_shot_and_jax(sig):
    x = sig[0]
    st = tstream.stft_init(512, 256, 2, device="cpu")
    jst = jstream.stft_init(512, 256, 2)
    outs, jouts = [], []
    for a, b in zip(CHUNKS[:-1], CHUNKS[1:]):
        st, s = tstream.stft_chunk(st, t_(x[:, a:b]), nfft=512, hop=256)
        jst, js = jstream.stft_chunk(jst, x[:, a:b], nfft=512, hop=256)
        outs.append(s)
        jouts.append(np.asarray(js))
        np.testing.assert_array_equal(st.tail.numpy(), np.asarray(jst.tail))
    got = torch.cat(outs, 1)
    primed = np.concatenate([np.zeros((2, 256), np.float32), x], -1)
    one = tfft.stft(t_(primed), nfft=512, hop=256, window="sqrt_hann")
    assert rel(got, one) == 0.0
    assert rel(got, np.concatenate(jouts, 1)) < TOL


def test_istft_chunks_and_flush_match_one_shot(sig):
    x = sig[0]
    s = tfft.stft(t_(x), nfft=512, hop=128, window="sqrt_hann")
    one = tfft.istft(s, nfft=512, hop=128)
    st = tstream.istft_init(512, 128, 2, device="cpu")
    jst = jstream.istft_init(512, 128, 2)
    outs, jouts = [], []
    for a, b in ((0, 1), (1, 7), (7, s.shape[1])):
        st, y = tstream.istft_chunk(st, s[:, a:b], nfft=512, hop=128)
        jst, jy = jstream.istft_chunk(jst, s[:, a:b].numpy(), nfft=512, hop=128)
        outs.append(y)
        jouts.append(np.asarray(jy))
    got = torch.cat(outs + [tstream.istft_flush(st)], -1)
    assert rel(got, one) < TOL
    assert rel(got, np.concatenate(jouts + [np.asarray(jstream.istft_flush(jst))], -1)) < TOL


def test_streams_started_in_jax_continue_in_the_port(sig):
    x = sig[0]
    jst = jstream.stft_init(512, 256, 2)
    jst, head = jstream.stft_chunk(jst, x[:, :1280], nfft=512, hop=256)
    st = tstream.stft_state_from_jax(np.asarray(jst.tail), device="cpu")
    st, rest = tstream.stft_chunk(st, t_(x[:, 1280:]), nfft=512, hop=256)
    primed = np.concatenate([np.zeros((2, 256), np.float32), x], -1)
    want = tfft.stft(t_(primed), nfft=512, hop=256, window="sqrt_hann")
    assert rel(torch.cat([t_(np.asarray(head)), rest], 1), want) < TOL
    s = want.numpy()
    ist = jstream.istft_init(512, 256, 2)
    ist, y0 = jstream.istft_chunk(ist, s[:, :5], nfft=512, hop=256)
    pst = tstream.istft_state_from_jax(np.asarray(ist.tail), device="cpu")
    pst, y1 = tstream.istft_chunk(pst, t_(s[:, 5:]), nfft=512, hop=256)
    got = np.concatenate([np.asarray(y0), y1.numpy(), tstream.istft_flush(pst).numpy()], -1)
    assert rel(got, tfft.istft(want, nfft=512, hop=256)) < TOL
    with pytest.raises(ValueError):
        tstream.stft_state_from_jax(np.zeros(256, np.float32), device="cpu")


# --- cepstrum ------------------------------------------------------------------


def test_unwrap_matches_numpy():
    r = np.random.default_rng(7)
    for dtype in (np.float64, np.float32):
        p = np.cumsum(r.uniform(-4, 4, size=(3, 500)), -1).astype(dtype)
        np.testing.assert_allclose(tcep.unwrap(t_(p)).numpy(), np.unwrap(p, axis=-1),
                                   rtol=0, atol=1e-9 if dtype == np.float64 else 1e-3)
    # differences of exactly +-pi and the -pi boundary after a positive jump
    p = np.array([0.0, np.pi, 0.0, -np.pi, 2 * np.pi, 3 * np.pi + 0.1, -3.0])
    np.testing.assert_array_equal(tcep.unwrap(t_(p)).numpy(), np.unwrap(p))


def smooth_signals():
    n = np.arange(512)
    base = 0.9 ** n * np.cos(0.3 * n)
    x = base.copy()
    x[40:] += 0.5 * base[:-40]  # an echo at 40 samples
    return np.stack([x, np.roll(x, 3)]).astype(np.float32)


def test_cepstra():
    x = smooth_signals()
    got = tcep.real_cepstrum(t_(x))
    want64 = np.fft.irfft(np.log(np.abs(np.fft.rfft(x.astype(np.float64)))), n=512)
    assert rel(got, want64) < CEPS_TOL
    assert rel(got, jcep.real_cepstrum(x)) < CEPS_TOL
    c, nd = tcep.complex_cepstrum(t_(x))
    jc, jnd = jcep.complex_cepstrum(x)
    assert nd.dtype == torch.int32 and np.array_equal(nd.numpy(), np.asarray(jnd))
    assert rel(c, jc) < CEPS_TOL
    back = tcep.inverse_complex_cepstrum(c, nd)
    assert rel(back, x) < CEPS_TOL
    assert rel(back, jcep.inverse_complex_cepstrum(np.asarray(jc), np.asarray(jnd))) < CEPS_TOL


def test_cepstral_pitch():
    fs, f0 = 16000.0, 200.0
    x = np.zeros(4096)
    x[::80] = 1.0  # a glottal pulse train at 200 Hz through a decaying resonance
    x = np.convolve(x, 0.9 ** np.arange(40) * np.cos(0.4 * np.arange(40)))[:4096]
    x = (x + 1e-3 * np.random.default_rng(5).standard_normal(4096)).astype(np.float32)
    got = tcep.cepstral_pitch(t_(x), fs=fs)
    assert got.item() == pytest.approx(f0, rel=0.01)
    assert got.item() == float(jcep.cepstral_pitch(x, fs=fs))


# --- ShortTimeFFT -------------------------------------------------------------------

CONFIGS = [
    (8, 3, 20, "onesided", 0),
    (7, 3, 20, "onesided", 0),
    (16, 4, 100, "twosided", 0),
    (16, 5, 64, "centered", 0),
    (8, 3, 50, "onesided", None),
    (8, 3, 50, "onesided", 2),
    (16, 2, 40, "onesided", 0),
]


@pytest.mark.parametrize("wlen,hop,n,mode,ps", CONFIGS, ids=str)
def test_short_time_fft_matches_scipy_and_jax(wlen, hop, n, mode, ps):
    w = sps.get_window("hann", wlen, fftbins=True)
    ref = sps.ShortTimeFFT(w, hop=hop, fs=10.0, fft_mode=mode, phase_shift=ps)
    mine = tsc.ShortTimeFFT(w, hop, 10.0, fft_mode=mode, phase_shift=ps)
    jm = jsc.ShortTimeFFT(w, hop, 10.0, fft_mode=mode, phase_shift=ps)
    assert (mine.p_min, mine.p_max(n), mine.k_min, mine.k_max(n)) == (
        ref.p_min, ref.p_max(n), ref.k_min, ref.k_max(n))
    np.testing.assert_allclose(mine.f, ref.f)
    np.testing.assert_allclose(mine.t(n), ref.t(n))
    np.testing.assert_allclose(mine.dual_win, ref.dual_win)
    x = np.random.default_rng(0).standard_normal((2, n)).astype(np.float32)
    s = mine.stft(t_(x))
    assert rel(s, ref.stft(x.astype(np.float64))) < TOL
    assert rel(s, jm.stft(x)) < TOL
    assert rel(mine.istft(s, k1=n), x) < TOL
    assert rel(mine.istft(s, k1=n), jm.istft(np.asarray(jm.stft(x)), k1=n)) < TOL
    assert rel(mine.spectrogram(t_(x)), ref.spectrogram(x.astype(np.float64))) < TOL


def test_short_time_fft_paddings_slices_scalings():
    w = sps.get_window("hann", 16, fftbins=True)
    x = np.random.default_rng(3).standard_normal(100).astype(np.float32)
    ref = sps.ShortTimeFFT(w, hop=4, fs=10.0)
    mine = tsc.ShortTimeFFT(w, 4, 10.0)
    for pad in ("zeros", "edge", "even", "odd"):
        assert rel(mine.stft(t_(x), padding=pad), ref.stft(x.astype(np.float64), padding=pad)) < TOL
    # slices that start inside the signal (p0 * hop > m_num_mid): scipy's
    # framing; the JAX package pads no left edge there and differs
    for p0, p1 in ((0, 10), (5, 12), (-1, 3)):
        assert rel(mine.stft(t_(x), p0=p0, p1=p1), ref.stft(x.astype(np.float64), p0=p0, p1=p1)) < TOL
    assert rel(mine.stft(t_(x), p0=0, p1=10), jsc.ShortTimeFFT(w, 4, 10.0).stft(x, p0=0, p1=10)) < TOL
    xa = np.stack([x, -x], 1)  # time on axis 0: (batch, f, slices) as in the JAX package
    got = mine.stft(t_(xa), axis=0)
    assert rel(got, jsc.ShortTimeFFT(w, 4, 10.0).stft(xa, axis=0)) < TOL
    assert rel(got[1], ref.stft(-x.astype(np.float64))) < TOL
    for scaling in ("magnitude", "psd"):
        r = sps.ShortTimeFFT(w, hop=4, fs=10.0, scale_to=scaling)
        m = tsc.ShortTimeFFT(w, 4, 10.0, scale_to=scaling)
        assert rel(m.stft(t_(x)), r.stft(x.astype(np.float64))) < TOL
        assert rel(m.istft(m.stft(t_(x)), k1=100), x) < TOL
    m = tsc.ShortTimeFFT.from_window("hann", 10.0, 16, 12)
    r = sps.ShortTimeFFT.from_window("hann", 10.0, 16, 12)
    assert rel(m.stft(t_(x)), r.stft(x.astype(np.float64))) < TOL


def test_closest_dual_window_and_refusals():
    w = sps.get_window("hann", 16, fftbins=True)
    for scaled in (True, False):
        d, a = tsc.closest_STFT_dual_window(w, 4, scaled=scaled)
        dr, ar = sps.closest_STFT_dual_window(w, 4, scaled=scaled)
        np.testing.assert_allclose(d, dr, rtol=1e-10, atol=1e-12)
        assert a == pytest.approx(ar)
        dj, aj = jsc.closest_STFT_dual_window(w, 4, scaled=scaled)
        np.testing.assert_array_equal(d, dj)
        assert a == aj
    for case in (
        lambda: tsc.ShortTimeFFT(np.ones((2, 2)), 1, 1.0),
        lambda: tsc.ShortTimeFFT(w, 0, 1.0),
        lambda: tsc.ShortTimeFFT(w, 4, 1.0, fft_mode="half"),
        lambda: tsc.ShortTimeFFT(w, 4, 1.0, mfft=8),
        lambda: tsc.ShortTimeFFT(w, 4, 1.0).stft(torch.zeros(100), p0=5, p1=5),
        lambda: tsc.ShortTimeFFT(w, 4, 1.0).stft(torch.zeros(100), padding="wrap"),
        lambda: tsc.ShortTimeFFT(w, 4, 1.0).istft(torch.zeros(5, 3, dtype=torch.complex64)),
        lambda: tsc.ShortTimeFFT(w, 32, 1.0).dual_win,
        lambda: tsc.closest_STFT_dual_window(w, 0),
    ):
        with pytest.raises(ValueError):
            case()
    assert not tsc.ShortTimeFFT(w, 32, 1.0).invertible
