"""The port's CIC filters, ``upfirdn`` and ``resample_fft`` against the JAX package.

The same NumPy inputs go through the JAX package and through the port on the
CPU (``cic_decimate`` through ``fir_filter``, whose fused route takes B8's
plain version here; ``cic_interpolate`` through ``upfirdn``). Tolerances:
the host designers (taps, gain, response, compensator) bit for bit;
filtered outputs within 1e-5 of max|y| of the JAX package and of the
float64 oracles (scipy's ``upfirdn`` and ``resample``, the int64
integrator-comb cascade), the bound of the port's float32 FIR routes;
integer CIC outputs of small integers without normalization exactly at the
direct route, where every product and sum is an integer below 2^24.
"""

import numpy as np
import pytest
import scipy.signal as sps
import torch

from digital_signal_processsing_tpu.ops import cic as jax_cic
from digital_signal_processsing_tpu.ops import resample as jax_resample
from digital_signal_processsing_tpu_torch.ops import cic, fir, resample
from digital_signal_processsing_tpu_torch.utils import last_choice

TOL = 1e-5


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def oracle_decimate(x, rate, n_stages, diff_delay):
    """Hogenauer's cascade in exact int64: integrators, decimation, combs."""
    acc = x.astype(np.int64)
    for _ in range(n_stages):
        acc = np.cumsum(acc, axis=-1)
    d = acc[..., ::rate]
    for _ in range(n_stages):
        shifted = np.concatenate([np.zeros(d.shape[:-1] + (diff_delay,), np.int64),
                                  d[..., :-diff_delay]], -1)
        d = d - shifted
    return d


STAGES = [(8, 4, 1), (4, 3, 2), (16, 2, 1), (5, 1, 1)]


@pytest.mark.parametrize("rate,n_stages,diff_delay", STAGES)
def test_host_helpers_match_jax(rate, n_stages, diff_delay):
    assert cic.cic_gain(rate, n_stages, diff_delay) == jax_cic.cic_gain(rate, n_stages, diff_delay)
    np.testing.assert_array_equal(cic.cic_taps(rate, n_stages, diff_delay),
                                  jax_cic.cic_taps(rate, n_stages, diff_delay))
    f = np.linspace(0.0, 0.5, 257)
    np.testing.assert_array_equal(cic.cic_response(f, rate, n_stages, diff_delay),
                                  jax_cic.cic_response(f, rate, n_stages, diff_delay))


@pytest.mark.parametrize("rate,n_stages,diff_delay", STAGES)
@pytest.mark.parametrize("method", ["auto", "direct", "overlap_save_fused"])
def test_decimate_matches_jax_and_the_oracle(rng, rate, n_stages, diff_delay, method):
    x = rng.integers(-8, 8, (3, 1000)).astype(np.float32)
    got = cic.cic_decimate(torch.from_numpy(x), rate, n_stages=n_stages, diff_delay=diff_delay,
                           normalize=False, method=method).numpy()
    want = np.asarray(jax_cic.cic_decimate(x, rate, n_stages=n_stages, diff_delay=diff_delay,
                                           normalize=False))
    ref = oracle_decimate(x, rate, n_stages, diff_delay)
    assert got.shape == ref.shape == (3, -(-1000 // rate))
    assert rel_err(got, want) < TOL and rel_err(got, ref) < TOL
    if method == "direct":
        np.testing.assert_array_equal(got, ref.astype(np.float32))


def test_decimate_routes_through_fir_filter(rng):
    x = torch.from_numpy(rng.standard_normal((2, 4096)).astype(np.float32))
    y = cic.cic_decimate(x, 8, n_stages=4)  # 29 taps, past FIR_FFT_CROSSOVER
    assert last_choice("fir_filter") == "overlap_save_fused"
    np.testing.assert_allclose(cic.cic_decimate(torch.ones(512), 8)[8:].numpy(), 1.0, atol=1e-5)
    assert y.shape == (2, 512)
    cic.cic_decimate(x, 2, n_stages=1)  # 2 taps
    assert last_choice("fir_filter") == ("direct" if 2 <= fir.FIR_FFT_CROSSOVER else "overlap_save_fused")


@pytest.mark.parametrize("rate,n_stages,diff_delay", [(8, 4, 1), (4, 3, 1), (8, 2, 2)])
@pytest.mark.parametrize("normalize", [True, False])
def test_interpolate_matches_jax_and_the_oracle(rng, rate, n_stages, diff_delay, normalize):
    x = rng.standard_normal((2, 300)).astype(np.float32)
    got = cic.cic_interpolate(torch.from_numpy(x), rate, n_stages=n_stages,
                              diff_delay=diff_delay, normalize=normalize).numpy()
    want = np.asarray(jax_cic.cic_interpolate(x, rate, n_stages=n_stages,
                                              diff_delay=diff_delay, normalize=normalize))
    h = cic.cic_taps(rate, n_stages, diff_delay).astype(np.float64)
    if normalize:
        h = h * rate / cic.cic_gain(rate, n_stages, diff_delay)
    ref = sps.upfirdn(h, x.astype(np.float64), up=rate, axis=-1)[:, : 300 * rate]
    assert got.shape == ref.shape == (2, 300 * rate)
    assert rel_err(got, want) < TOL and rel_err(got, ref) < TOL


@pytest.mark.parametrize("num_taps,rate,n_stages,passband,transition", [
    (31, 8, 4, 0.5, 0.2), (63, 16, 3, 0.4, 0.6), (21, 4, 2, 0.3, 0.1)])
def test_compensator_matches_jax(num_taps, rate, n_stages, passband, transition):
    got = cic.design_cic_compensator(num_taps, rate, n_stages=n_stages, passband=passband,
                                     transition=transition)
    want = jax_cic.design_cic_compensator(num_taps, rate, n_stages=n_stages, passband=passband,
                                          transition=transition)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_refusals_match_jax():
    calls = [
        lambda m: m.cic_gain(1),
        lambda m: m.cic_taps(4, 0),
        lambda m: m.cic_response([0.1], 4, 2, 0),
        lambda m: m.design_cic_compensator(31, 8, passband=1.2),
        lambda m: m.design_cic_compensator(31, 8, passband=0.5, transition=0.6),
    ]
    for call in calls:
        with pytest.raises(ValueError) as want:
            call(jax_cic)
        with pytest.raises(ValueError) as got:
            call(cic)
        assert str(got.value) == str(want.value)


# --- upfirdn and resample_fft --------------------------------------------------------


@pytest.mark.parametrize("taps,up,down", [
    (29, 8, 1), (29, 1, 8), (7, 3, 2), (2, 5, 1), (1, 1, 1), (16, 4, 3), (5, 1, 1)])
def test_upfirdn_matches_jax_and_scipy(rng, taps, up, down):
    h = rng.standard_normal(taps)
    x = rng.standard_normal((3, 257)).astype(np.float32)
    got = resample.upfirdn(h, torch.from_numpy(x), up, down).numpy()
    want = np.asarray(jax_resample.upfirdn(h, x, up, down))
    ref = sps.upfirdn(h.astype(np.float32).astype(np.float64), x.astype(np.float64), up, down,
                      axis=-1)
    assert got.shape == want.shape == ref.shape
    assert rel_err(got, want) < TOL and rel_err(got, ref) < TOL
    one = resample.upfirdn(h, torch.from_numpy(x[0]), up, down)
    assert one.shape == ref.shape[1:] and rel_err(one.numpy(), ref[0]) < TOL


def test_upfirdn_refusals():
    x = torch.zeros(2, 10)
    with pytest.raises(ValueError, match="up/down"):
        resample.upfirdn(np.ones(3), x, 0, 1)
    with pytest.raises(ValueError, match="1-D"):
        resample.upfirdn(np.ones((2, 3)), x)


@pytest.mark.parametrize("t,num", [(256, 100), (256, 101), (255, 100), (100, 256), (101, 257),
                                   (100, 100), (64, 1)])
def test_resample_fft_matches_jax_and_scipy(rng, t, num):
    x = rng.standard_normal((2, t)).astype(np.float32)
    got = resample.resample_fft(torch.from_numpy(x), num).numpy()
    want = np.asarray(jax_resample.resample_fft(x, num))
    ref = sps.resample(x.astype(np.float64), num, axis=-1)
    assert got.shape == want.shape == ref.shape == (2, num)
    assert rel_err(got, want) < TOL and rel_err(got, ref) < TOL
    with pytest.raises(ValueError, match="num"):
        resample.resample_fft(torch.from_numpy(x), 0)
