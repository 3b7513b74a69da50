"""The port's correlation and convolution (``ops/correlate.py``) against the
JAX package and scipy.

The same seeded NumPy inputs go through the JAX package, the port (on the
CPU: ``conv1d`` in IEEE float32 for ``direct``, ``torch.fft`` for the FFT
route, ``fir_filter``'s plain overlap-save for ``oaconvolve``) and scipy in
float64.

Tolerance: 1e-5 of max|y| (``TOL``) for every route. The JAX package's
``mxu`` engine measured about 2e-7 of max|y| against float64 on the CPU at
these sizes, below ``TOL``, so it takes the same bound (``mxu_tol``: twice
its measured error where that were larger). ``direct_gauss`` recombines
intermediates of twice the size, which rounds differently from the
four-product spelling in the last bits, well inside ``TOL``.
"""

import importlib

import numpy as np
import pytest
import scipy.signal as sps
import torch

from digital_signal_processsing_tpu.ops import correlate as jcor
from digital_signal_processsing_tpu_torch.ops import fir
from digital_signal_processsing_tpu_torch.utils import last_choice

tcor = importlib.import_module("digital_signal_processsing_tpu_torch.ops.correlate")

TOL = 1e-5
LONG = tcor.DIRECT_MIN_STREAM  # the shortest stream auto sends to the direct route


def rel(got, want) -> float:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = want.numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got.astype(np.float64) - want).max() / max(np.abs(want).max(), 1e-30))


def t_(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def mxu_tol(jax_out, want64) -> float:
    return max(TOL, 2.0 * rel(jax_out, want64))


@pytest.fixture(scope="module")
def data():
    r = np.random.default_rng(1802)
    return {
        "a": r.standard_normal((2, 3000)).astype(np.float32),
        "v": r.standard_normal(77).astype(np.float32),
        "ai": r.standard_normal((2, 3000)).astype(np.float32),
        "vi": r.standard_normal(77).astype(np.float32),
        "long": r.standard_normal((2, LONG)).astype(np.float32),
        "long_i": r.standard_normal((2, LONG)).astype(np.float32),
    }


def scipy_rows(fn, a, v, mode):
    return np.stack([fn(row, v, mode=mode) for row in a])


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
@pytest.mark.parametrize("method", ["auto", "direct", "xla", "mxu"])
def test_correlate(data, mode, method):
    a, v = data["a"], data["v"]
    want64 = scipy_rows(sps.correlate, a.astype(np.float64), v.astype(np.float64), mode)
    got = tcor.correlate(t_(a), t_(v), mode, method=method)
    assert last_choice("correlate") == ("direct" if method == "direct" else "fft")
    j = jcor.correlate(a, v, mode, method=method)
    assert rel(got, want64) < TOL
    assert rel(got, j) < mxu_tol(j, want64)
    assert rel(tcor.correlate(t_(a[0]), t_(v), mode, method=method), got[0].numpy()) < TOL


def test_correlate_auto_takes_direct_on_long_streams(data):
    a, v = data["long"], data["v"]
    got = tcor.correlate(t_(a), t_(v), "same")
    assert last_choice("correlate") == "direct"
    want64 = scipy_rows(sps.correlate, a.astype(np.float64), v.astype(np.float64), "same")
    assert rel(got, want64) < TOL
    assert rel(got, jcor.correlate(a, v, "same")) < TOL
    # a batched template stays on the FFT route
    vb = np.stack([v, -v])
    got = tcor.correlate(t_(a[:, :4000]), t_(vb), "full")
    assert last_choice("correlate") == "fft"
    assert rel(got, jcor.correlate(a[:, :4000], vb, "full")) < TOL


@pytest.mark.parametrize("method", ["direct", "direct_gauss", "xla", "mxu"])
@pytest.mark.parametrize("mode", ["full", "valid"])
def test_correlate_complex(data, method, mode):
    ar, ai, vr, vi = data["a"], data["ai"], data["v"], data["vi"]
    z = ar.astype(np.float64) + 1j * ai
    tz = vr.astype(np.float64) + 1j * vi
    want64 = np.stack([sps.correlate(row, tz, mode=mode) for row in z])
    gr, gi = tcor.correlate_complex(t_(ar), t_(ai), t_(vr), t_(vi), mode, method=method)
    assert last_choice("correlate_complex") == (method if method.startswith("direct") else "fft")
    jr, ji = jcor.correlate_complex(ar, ai, vr, vi, mode, method=method)
    assert rel(gr, want64.real) < TOL and rel(gi, want64.imag) < TOL
    assert rel(gr, jr) < mxu_tol(jr, want64.real) and rel(gi, ji) < mxu_tol(ji, want64.imag)


def test_correlate_complex_auto_direct_at_the_radar_shape(data):
    """auto takes the direct route on a long stream with a short template
    (the radar matched filter's shape, cut to the CPU)."""
    ar, ai = data["long"], data["long_i"]
    vr, vi = data["v"][:32], data["vi"][:32]
    gr, gi = tcor.correlate_complex(t_(ar), t_(ai), t_(vr), t_(vi), "valid")
    assert last_choice("correlate_complex") == "direct"
    jr, ji = jcor.correlate_complex(ar, ai, vr, vi, "valid")
    assert rel(gr, jr) < TOL and rel(gi, ji) < TOL
    z = ar[0, :5000].astype(np.float64) + 1j * ai[0, :5000]
    want = sps.correlate(z, vr.astype(np.float64) + 1j * vi, mode="valid")
    assert rel(gr[0, : want.size], want.real) < TOL and rel(gi[0, : want.size], want.imag) < TOL


def test_autocorrelate(data):
    x = data["a"]
    for normalize in (True, False):
        for method in ("auto", "mxu"):
            got = tcor.autocorrelate(t_(x), 200, normalize=normalize, method=method)
            j = jcor.autocorrelate(x, 200, normalize=normalize, method=method)
            want = np.stack([sps.correlate(r, r, mode="full")[2999:3200] for r in x.astype(np.float64)])
            if normalize:
                want = want / want[:, :1]
            assert rel(got, want) < TOL and rel(got, j) < mxu_tol(j, want)


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
def test_convolutions(data, mode):
    a, v = data["a"], data["v"]
    want64 = scipy_rows(sps.fftconvolve, a.astype(np.float64), v.astype(np.float64), mode)
    got = tcor.fftconvolve(t_(a), t_(v), mode)
    assert rel(got, want64) < TOL and rel(got, jcor.fftconvolve(a, v, mode)) < TOL
    got = tcor.oaconvolve(t_(a), t_(v), mode)
    assert last_choice("fir_filter") == "overlap_save_fused"
    assert rel(got, want64) < TOL and rel(got, jcor.oaconvolve(a, v, mode)) < TOL
    assert rel(tcor.oaconvolve(t_(a[0]), t_(v), mode), want64[0]) < TOL
    assert rel(tcor.convolve(t_(a), t_(v), mode), want64) < TOL
    assert rel(tcor.convolve(t_(a), t_(v), mode, method="fft"), want64) < TOL
    assert rel(tcor.convolve(t_(a), t_(v), mode), jcor.convolve(a, v, mode)) < TOL


def test_oaconvolve_falls_back_to_one_fft_for_long_kernels(data):
    a = data["a"][:, :1000]
    v = np.random.default_rng(4).standard_normal(600).astype(np.float32)  # > half the stream
    got = tcor.oaconvolve(t_(a), t_(v), "same")
    want64 = scipy_rows(sps.oaconvolve, a.astype(np.float64), v.astype(np.float64), "same")
    assert rel(got, want64) < TOL and rel(got, jcor.oaconvolve(a, v, "same")) < TOL


def test_delays_lags_and_strength(data):
    a = data["a"][0]
    v = a[1234:1234 + 77].copy()
    assert int(tcor.find_delay(t_(a), t_(v))) == 1234 == int(jcor.find_delay(a, v))
    for mode in ("full", "same", "valid"):
        for n1, n2 in ((100, 7), (101, 7), (7, 100)):
            np.testing.assert_array_equal(tcor.correlation_lags(n1, n2, mode),
                                          sps.correlation_lags(n1, n2, mode))
            np.testing.assert_array_equal(tcor.correlation_lags(n1, n2, mode),
                                          jcor.correlation_lags(n1, n2, mode))
    assert (tcor.MODES, tcor.DIRECT_MAX_TAPS, tcor.DIRECT_MIN_STREAM) == (
        jcor.MODES, jcor.DIRECT_MAX_TAPS, jcor.DIRECT_MIN_STREAM)
    events = np.sort(np.random.default_rng(6).uniform(0, 10, 300)).astype(np.float32)
    for period in (0.7, np.array([0.5, 1.3, 2.0])):
        s, p = tcor.vectorstrength(t_(events), period)
        rs, rp = sps.vectorstrength(events.astype(np.float64), period)
        np.testing.assert_allclose(s.numpy(), rs, atol=1e-5)
        np.testing.assert_allclose(p.numpy(), rp, atol=1e-4)
        js, jp = jcor.vectorstrength(events, period)
        np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-5)


def test_choose_conv_method_mirrors_the_ports_crossover():
    """The port's fir.FIR_FFT_CROSSOVER (0, measured on an H100) sends every
    kernel to the fused overlap-save route, so the answer is 'fft' where the
    reference, with its TPU crossover of 3900, answers 'direct'."""
    assert fir.FIR_FFT_CROSSOVER == 0
    for k in (1, 77, 3899, 5000):
        assert tcor.choose_conv_method(np.zeros(10000), np.zeros(k)) == "fft"
        assert tcor.choose_conv_method(10000, k) == "fft"
    assert jcor.choose_conv_method(np.zeros(10000), np.zeros(77)) == "direct"


def test_gcc_phat_and_sub_sample_delay(data):
    b = data["a"][:, :2048]
    a = np.roll(b, 17, axis=-1)
    a[:, :17] = 0
    for max_lag in (None, 50):
        got = tcor.gcc_phat(t_(a), t_(b), max_lag=max_lag)
        j = jcor.gcc_phat(a, b, max_lag=max_lag)
        assert rel(got, j) < TOL
        m = (got.shape[-1] - 1) // 2
        assert (got.argmax(-1) - m).tolist() == [17, 17]
    d = tcor.find_delay_phat(t_(a), t_(b), max_lag=50)
    np.testing.assert_allclose(d.numpy(), np.asarray(jcor.find_delay_phat(a, b, max_lag=50)), atol=1e-4)
    assert np.allclose(d.numpy(), 17, atol=0.05)


def test_refusals(data):
    a, v = t_(data["a"]), t_(data["v"])
    cases = [
        lambda: tcor.correlate(a, v, "middle"),
        lambda: tcor.correlate(v, a[0], "valid"),
        lambda: tcor.correlate(a, v, method="direct_gauss"),
        lambda: tcor.correlate(a, torch.stack([v, v]), method="direct"),
        lambda: tcor.correlate(a, v, method="cufft"),
        lambda: tcor.correlate_complex(a, a, v, v, "middle"),
        lambda: tcor.correlate_complex(v, v, a[0], a[0], "valid"),
        lambda: tcor.correlate_complex(a, a, torch.stack([v, v]), torch.stack([v, v]),
                                       method="direct_gauss"),
        lambda: tcor.autocorrelate(a, 3000),
        lambda: tcor.fftconvolve(a, v, "middle"),
        lambda: tcor.fftconvolve(v, a[0], "valid"),
        lambda: tcor.oaconvolve(v[:10], v, "valid"),
        lambda: tcor.correlation_lags(10, 3, "middle"),
        lambda: tcor.choose_conv_method(10, 3, "middle"),
        lambda: tcor.gcc_phat(a, a, max_lag=0),
        lambda: tcor.gcc_phat(a, a, max_lag=4096),
    ]
    for case in cases:
        with pytest.raises(ValueError):
            case()
