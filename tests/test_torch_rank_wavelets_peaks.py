"""The rank filters, the wavelets and the peak finders of the port against the JAX
package on the same NumPy inputs (CPU).

Tolerances: medfilt, rank_filter and order_filter equal (an order statistic
picks a sample); wiener within 1e-5 of max|y| (two float32 box correlations,
conv1d against XLA's convolution); cwt (ricker, and complex morlet2) and
lombscargle within 1e-4 of max|y| (the port's cwt is an FFT bank, the
reference's a direct correlation); peak indices and properties equal (host
float64 on the same stream; the port's plateau and prominence walks are
vectorised, its noise percentiles slide).
"""

import numpy as np
import pytest
import scipy.signal as sps
import torch

from digital_signal_processsing_tpu.ops import peaks as jpk
from digital_signal_processsing_tpu.ops import rank as jrk
from digital_signal_processsing_tpu.ops import wavelets as jwv
from digital_signal_processsing_tpu_torch.ops import peaks as pk
from digital_signal_processsing_tpu_torch.ops import rank as rk
from digital_signal_processsing_tpu_torch.ops import wavelets as wv

WIENER_RTOL = 1e-5
WAVELET_RTOL = 1e-4


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want)
    g = got.resolve_conj().numpy()
    assert g.shape == want.shape and g.dtype == want.dtype, (g.shape, want.shape, g.dtype, want.dtype)
    return float(np.abs(g.astype(np.complex128) - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("shape", [(300,), (3, 257), (1, 1), (2, 4)])
@pytest.mark.parametrize("k", [1, 3, 7])
def test_medfilt_and_rank_filter_equal(shape, k, rng):
    x = rng.normal(size=shape).astype(np.float32)
    x[..., ::5] = 0.0  # ties with the zero padding
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(rk.medfilt(t, k).numpy(), np.asarray(jrk.medfilt(x, k)))
    for r in sorted({0, k // 2, k - 1}):
        np.testing.assert_array_equal(rk.rank_filter(t, k, r).numpy(),
                                      np.asarray(jrk.rank_filter(x, k, r)))


@pytest.mark.parametrize("mysize,noise", [(3, None), (5, None), (7, 0.3), (1, None)])
def test_wiener(mysize, noise, rng):
    x = (np.sin(np.arange(2 * 400) * 0.05).reshape(2, 400) + 0.3 * rng.normal(size=(2, 400)))
    x = x.astype(np.float32)
    assert _rel(rk.wiener(torch.from_numpy(x), mysize, noise), jrk.wiener(x, mysize, noise)) <= WIENER_RTOL
    assert _rel(rk.wiener(torch.from_numpy(x[0]), mysize, noise), jrk.wiener(x[0], mysize, noise)) <= WIENER_RTOL


@pytest.mark.parametrize("shape,domain,rank", [
    ((20, 30), np.ones((3, 3)), 4),
    ((20, 30), [[0, 1, 0], [1, 1, 1], [0, 1, 0]], 0),
    ((40,), np.ones(5), 2),
    ((6, 7, 8), np.ones((3, 1, 3)), 8),
])
def test_order_filter_equal(shape, domain, rank, rng):
    x = rng.normal(size=shape).astype(np.float32)
    got = rk.order_filter(torch.from_numpy(x), domain, rank)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jrk.order_filter(x, domain, rank)))
    np.testing.assert_array_equal(got.numpy(), sps.order_filter(x, np.asarray(domain), rank))


def test_rank_refusals():
    x = torch.zeros(10)
    for call in (lambda: rk.medfilt(x, 4), lambda: rk.rank_filter(x, 3, 3),
                 lambda: rk.wiener(x, 2), lambda: rk.order_filter(x, np.ones(4), 0),
                 lambda: rk.order_filter(x, np.ones((3, 3)), 0),
                 lambda: rk.order_filter(x, np.ones(3), 3)):
        with pytest.raises(ValueError):
            call()


@pytest.mark.parametrize("n", [1, 9, 100, 1000])
@pytest.mark.parametrize("wavelet,widths,w", [
    ("ricker", [1, 2, 3.5, 8, 20], None),
    ("morlet2", [1, 2, 5, 7], None),
    ("morlet2", [3, 6], 8.0),
])
def test_cwt(n, wavelet, widths, w, rng):
    x = rng.normal(size=(2, n)).astype(np.float32)
    got = wv.cwt(torch.from_numpy(x), getattr(wv, wavelet), widths, w=w)
    want = jwv.cwt(x, getattr(jwv, wavelet), widths, w=w)
    assert _rel(got, want) <= WAVELET_RTOL
    got1 = wv.cwt(x[0], getattr(wv, wavelet), widths, w=w, device="cpu")
    assert _rel(got1, jwv.cwt(x[0], getattr(jwv, wavelet), widths, w=w)) <= WAVELET_RTOL


def test_cwt_dtype_and_wavelets():
    np.testing.assert_allclose(wv.ricker(17, 2.5), jwv.ricker(17, 2.5), rtol=0, atol=0)
    np.testing.assert_allclose(wv.morlet2(17, 2.5, 6.0), jwv.morlet2(17, 2.5, 6.0), rtol=0, atol=0)
    got = wv.cwt(torch.ones(64), wv.ricker, [2, 4], dtype=np.float64)
    assert got.dtype == torch.float64 and got.shape == (2, 64)


@pytest.mark.parametrize("precenter,normalize", [(False, False), (True, False), (False, True),
                                                 (True, True)])
def test_lombscargle(precenter, normalize, rng):
    t = np.sort(rng.uniform(0, 100, 300)).astype(np.float32)
    y = (np.sin(1.3 * t) + 0.5 + 0.1 * rng.normal(size=300)).astype(np.float32)
    f = np.linspace(0.1, 5, 200).astype(np.float32)
    got = wv.lombscargle(torch.from_numpy(t), torch.from_numpy(y), torch.from_numpy(f),
                         precenter=precenter, normalize=normalize)
    want = jwv.lombscargle(t, y, f, precenter=precenter, normalize=normalize)
    assert _rel(got, want) <= WAVELET_RTOL


def _streams(rng):
    n = 3000
    walk = np.cumsum(rng.normal(size=n))
    plateaus = np.round(rng.normal(size=n) * 2) / 2
    t = np.arange(n)
    pulses = 0.05 * rng.normal(size=n)
    for p_ in (300, 900, 1500, 2200, 2800):
        pulses += np.exp(-0.5 * ((t - p_) / 12.0) ** 2) * (1 + p_ / 3000)
    return {"walk": walk, "plateaus": plateaus, "pulses": pulses}


@pytest.mark.parametrize("stream", ["walk", "plateaus", "pulses"])
@pytest.mark.parametrize("kw", [
    {}, dict(height=0.0), dict(threshold=0.1), dict(distance=20), dict(prominence=1.0),
    dict(height=0.2, threshold=0.01, distance=5, prominence=0.5),
])
def test_find_peaks_equal(stream, kw, rng):
    x = _streams(rng)[stream]
    got, gprops = pk.find_peaks(x, **kw)
    want, wprops = jpk.find_peaks(x, **kw)
    np.testing.assert_array_equal(got, want)
    assert set(gprops) == set(wprops)
    for key in gprops:
        np.testing.assert_array_equal(gprops[key], wprops[key])


@pytest.mark.parametrize("stream", ["walk", "plateaus", "pulses"])
@pytest.mark.parametrize("rel_height", [0.5, 1.0])
def test_prominences_widths_argrel_equal(stream, rel_height, rng):
    x = _streams(rng)[stream]
    peaks, _ = jpk.find_peaks(x)
    for got, want in zip(pk.peak_prominences(x, peaks), jpk.peak_prominences(x, peaks)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(pk.peak_widths(x, peaks, rel_height=rel_height),
                         jpk.peak_widths(x, peaks, rel_height=rel_height)):
        np.testing.assert_array_equal(got, want)
    for order in (1, 3):
        for name in ("argrelmax", "argrelmin"):
            np.testing.assert_array_equal(getattr(pk, name)(x, order=order)[0],
                                          getattr(jpk, name)(x, order=order)[0])
    np.testing.assert_array_equal(pk.peak_mask(torch.from_numpy(x[None]), height=0.1).numpy(),
                                  np.asarray(jpk.peak_mask(x[None].astype(np.float32), height=0.1)))


@pytest.mark.parametrize("n,m", [(500, 1), (500, 2), (500, 7), (300, 64), (3, 3)])
def test_sliding_percentile_is_numpys(n, m, rng):
    v = np.round(rng.normal(size=n), 1)  # ties
    for perc in (0.0, 10.0, 37.3, 50.0, 99.9, 100.0):
        want = np.array([np.percentile(v[k : k + m], perc) for k in range(n - m + 1)])
        np.testing.assert_array_equal(pk._sliding_percentile(v, m, perc), want)


@pytest.mark.parametrize("window_size", [None, 1, 2, 7, 8])
def test_find_peaks_cwt(window_size, rng):
    x = _streams(rng)["pulses"]
    widths = np.arange(4, 30, 3)
    got = pk.find_peaks_cwt(x, widths, window_size=window_size, device="cpu")
    want = jpk.find_peaks_cwt(x, widths, window_size=window_size)
    np.testing.assert_array_equal(got, want)
    for p_ in (300, 900, 1500, 2200, 2800):
        assert np.min(np.abs(got - p_)) <= 2
