"""The port's FIR designers and ``savgol_filter`` against the JAX package's.

The designers are the same host float64 NumPy in both packages (the port
keeps its own copy): their taps are held to 1e-12 relative, and refusals
must raise the same exception with the same message. ``savgol_filter`` runs
on a tensor's device in the port (a float32 ``conv1d`` and the float32 edge
fit) and through a blocked float32 convolution in the JAX package: held to
1e-5 of max|y| against the JAX package and against scipy's float64
``savgol_filter`` (a float32 convolution of a window of at most 31 taps
rounds at about 1e-7 of its output).
"""

import numpy as np
import pytest
import scipy.signal as sps
import torch

from digital_signal_processsing_tpu.ops import fir as jax_fir
from digital_signal_processsing_tpu_torch.ops import fir

RTOL, TOL = 1e-12, 1e-5

CASES = {
    "lowpass": lambda m: m.design_lowpass(63, 0.3),
    "lowpass kaiser": lambda m: m.design_lowpass(64, 0.3, window=("kaiser", 6.0)),
    "highpass": lambda m: m.design_highpass(63, 0.4),
    "highpass blackman": lambda m: m.design_highpass(31, 0.6, window="blackman"),
    "bandpass": lambda m: m.design_bandpass(64, 0.2, 0.4),
    "bandstop": lambda m: m.design_bandstop(65, 0.2, 0.4, window="hann"),
    "rrc": lambda m: m.design_rrc(65, 0.35, 8),
    "rrc singular": lambda m: m.design_rrc(33, 0.25, 4),
    "firls": lambda m: m.design_firls(31, [0.0, 0.3, 0.4, 1.0], [1.0, 1.0, 0.0, 0.0]),
    "firls weighted slope": lambda m: m.design_firls(
        41, [0.0, 0.2, 0.3, 0.6, 0.7, 1.0], [0.0, 1.0, 1.0, 1.0, 0.0, 0.0], weights=[1, 2, 1]),
    "remez": lambda m: m.design_remez(201, [0.0, 0.1, 0.15, 1.0], [1.0, 0.0]),
    "remez bandpass weighted": lambda m: m.design_remez(
        51, [0.0, 0.2, 0.3, 0.5, 0.6, 1.0], [0.0, 1.0, 0.0], weights=[10.0, 1.0, 10.0]),
    "equiripple flat": lambda m: m.design_equiripple(41, [0.0, 0.3, 0.4, 1.0],
                                                     [1.0, 1.0, 0.0, 0.0]),
    "equiripple sloped": lambda m: m.design_equiripple(31, [0.0, 0.3, 0.4, 1.0],
                                                       [1.0, 0.5, 0.0, 0.0], iterations=5),
    "firwin2": lambda m: m.design_firwin2(63, [0.0, 0.3, 0.4, 1.0], [1.0, 1.0, 0.0, 0.0]),
    "firwin2 step": lambda m: m.design_firwin2(64, [0.0, 0.5, 0.5, 1.0], [1.0, 1.0, 0.0, 0.0],
                                               window="hann"),
    "savgol": lambda m: m.design_savgol(11, 3),
    "savgol deriv": lambda m: m.design_savgol(15, 4, deriv=2, delta=0.5),
    "savgol deriv past order": lambda m: m.design_savgol(7, 2, deriv=3),
    "kaiserord": lambda m: m.kaiserord(60.0, 0.05),
    "kaiser_beta": lambda m: [m.kaiser_beta(a) for a in (10.0, 30.0, 60.0)],
    "kaiser_num_taps": lambda m: m.kaiser_num_taps(60.0, 0.05),
    "kaiser_atten": lambda m: m.kaiser_atten(101, 0.05),
    "minimum_phase": lambda m: m.minimum_phase(sps.remez(31, [0, 0.15, 0.25, 0.5], [1, 0])),
    "deconvolve": lambda m: m.deconvolve(np.convolve([1.0, 2.0, 3.0], [0.5, 1.0, 4.0, 1.0]),
                                         [1.0, 2.0, 3.0]),
    "deconvolve short": lambda m: m.deconvolve([1.0, 2.0], [1.0, 2.0, 3.0]),
    "firwin": lambda m: m.firwin(51, 0.3),
    "firwin highpass fs": lambda m: m.firwin(51, 3000.0, pass_zero=False, fs=16000.0),
    "firwin multiband": lambda m: m.firwin(61, [0.2, 0.4, 0.6], window="blackmanharris"),
    "firwin bandstop rect": lambda m: m.firwin(41, [0.2, 0.5], pass_zero="bandstop",
                                               window="rect", scale=False),
    "firwin kaiser": lambda m: m.firwin(40, 0.25, window=("kaiser", 8.0)),
    "firwin_2d": lambda m: m.firwin_2d((7, 9), ("hamming", "hann"), fc=0.4),
    "firwin_2d circular": lambda m: m.firwin_2d((9, 9), "hamming", fc=0.4, circular=True),
    "box_taps": lambda m: m.box_taps(17),
}

REFUSALS = {
    "highpass even": lambda m: m.design_highpass(64, 0.3),
    "bandpass edges": lambda m: m.design_bandpass(63, 0.4, 0.2),
    "rrc beta": lambda m: m.design_rrc(65, 1.5, 8),
    "rrc sps": lambda m: m.design_rrc(65, 0.3, 1),
    "firls even": lambda m: m.design_firls(30, [0.0, 0.5], [1.0, 1.0]),
    "firls desired": lambda m: m.design_firls(31, [0.0, 0.5, 0.6, 1.0], [1.0, 1.0]),
    "remez even": lambda m: m.design_remez(30, [0.0, 0.1, 0.2, 1.0], [1.0, 0.0]),
    "remez desired": lambda m: m.design_remez(31, [0.0, 0.1, 0.2, 1.0], [1.0]),
    "remez unsorted": lambda m: m.design_remez(31, [0.0, 0.3, 0.2, 1.0], [1.0, 0.0]),
    "remez weights": lambda m: m.design_remez(31, [0.0, 0.1, 0.2, 1.0], [1.0, 0.0],
                                              weights=[1.0]),
    "firwin2 ends": lambda m: m.design_firwin2(31, [0.1, 1.0], [1.0, 0.0]),
    "firwin2 type II": lambda m: m.design_firwin2(30, [0.0, 1.0], [1.0, 1.0]),
    "savgol order": lambda m: m.design_savgol(5, 5),
    "savgol even": lambda m: m.design_savgol(6, 2),
    "kaiserord ripple": lambda m: m.kaiserord(5.0, 0.1),
    "minimum_phase short": lambda m: m.minimum_phase(np.ones(2)),
    "deconvolve zero": lambda m: m.deconvolve([1.0, 2.0], [0.0, 1.0]),
    "firwin empty": lambda m: m.firwin(31, []),
    "firwin order": lambda m: m.firwin(31, [0.4, 0.2]),
    "firwin nyquist": lambda m: m.firwin(30, 0.3, pass_zero=False),
    "firwin pass_zero": lambda m: m.firwin(31, 0.3, pass_zero="allpass"),
    "firwin_2d fc": lambda m: m.firwin_2d((7, 7), ("hamming", "hann")),
    "unknown window": lambda m: m.design_lowpass(31, 0.3, window="tukey"),
}


def assert_same(got, want):
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g, w)
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.shape == w.shape and g.dtype == w.dtype, (g.dtype, g.shape, w.dtype, w.shape)
    np.testing.assert_allclose(g, w, rtol=RTOL, atol=0.0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_designer_matches_jax(name):
    assert_same(CASES[name](fir), CASES[name](jax_fir))


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_designer_refusals_match_jax(name):
    with pytest.raises(Exception) as want:
        REFUSALS[name](jax_fir)
    with pytest.raises(want.type) as got:
        REFUSALS[name](fir)
    assert str(got.value) == str(want.value)


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("mode", ["interp", "mirror", "nearest", "wrap", "constant"])
@pytest.mark.parametrize("window,order,deriv", [(11, 3, 0), (31, 4, 1), (5, 2, 2)])
def test_savgol_filter_matches_jax_and_scipy(rng, mode, window, order, deriv):
    x = rng.normal(size=(3, 400)).astype(np.float32)
    got = fir.savgol_filter(torch.from_numpy(x), window, order, deriv=deriv, delta=0.5, mode=mode)
    want = np.asarray(jax_fir.savgol_filter(x, window, order, deriv=deriv, delta=0.5, mode=mode))
    want64 = sps.savgol_filter(x.astype(np.float64), window, order, deriv=deriv, delta=0.5,
                               mode=mode, axis=-1)
    assert got.dtype == torch.float32
    assert rel_err(got.numpy(), want) < TOL
    assert rel_err(got.numpy(), want64) < TOL
    # a 1-D signal stays 1-D (the CPU's conv1d takes another kernel for one
    # channel: a last-bit difference, 1e-6 of max|y|)
    one = fir.savgol_filter(torch.from_numpy(x[0]), window, order, deriv=deriv, delta=0.5,
                            mode=mode)
    assert one.shape == (400,) and rel_err(one.numpy(), got[0].numpy()) < 1e-6


@pytest.mark.parametrize("mode", ["mirror", "nearest", "wrap", "constant"])
@pytest.mark.parametrize("t,window", [(5, 11), (3, 7), (3, 11), (1, 7), (1, 11)])
def test_savgol_filter_short_inputs_match_jax_and_scipy(rng, mode, t, window):
    """Shorter than the half-window: the padding repeats its reflection or wrap,
    as ``jnp.pad`` and scipy do."""
    x = rng.normal(size=(2, t)).astype(np.float32)
    got = fir.savgol_filter(torch.from_numpy(x), window, 3, mode=mode)
    want = np.asarray(jax_fir.savgol_filter(x, window, 3, mode=mode))
    want64 = sps.savgol_filter(x.astype(np.float64), window, 3, mode=mode, axis=-1)
    assert got.shape == (2, t) and got.dtype == torch.float32
    assert rel_err(got.numpy(), want) < TOL
    assert rel_err(got.numpy(), want64) < TOL


def test_savgol_filter_refusals():
    x = torch.zeros(2, 11)
    with pytest.raises(ValueError, match="interp"):
        fir.savgol_filter(x, 11, 3)
    with pytest.raises(ValueError, match="unknown mode"):
        fir.savgol_filter(torch.zeros(2, 40), 11, 3, mode="reflect")
