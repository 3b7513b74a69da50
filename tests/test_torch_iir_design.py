"""The port's ``ops/iir_design.py`` against the JAX package's, function by function.

Both are the same host float64 NumPy (the port keeps its own copy), so every
result is held to 1e-12 relative (roots and polynomials come out of the same
``np.roots``/``np.poly`` calls; the margin only absorbs a different BLAS).
Refusals must raise the same exception with the same message.
"""

import numpy as np
import pytest
import scipy.signal as sps

from digital_signal_processsing_tpu.ops import iir_design as jax_design
from digital_signal_processsing_tpu_torch.ops import iir as port_iir
from digital_signal_processsing_tpu_torch.ops import iir_design

RTOL = 1e-12

B, A = sps.butter(3, 0.3)  # a (b, a) pair for the conversions
AB, AA = [1.0], [1.0, 1.4142135623730951, 1.0]  # an analog second-order lowpass
ZPK = (np.array([-1.0, -1.0]), np.array([0.5 + 0.3j, 0.5 - 0.3j]), 0.2)
AZPK = (np.array([], complex), np.array([-0.5 + 0.8j, -0.5 - 0.8j, -0.7]), 0.4)

CASES = {
    "iirfilter butter": lambda m: m.iirfilter(4, 0.2),
    "iirfilter cheby1 highpass": lambda m: m.iirfilter(5, 0.3, btype="highpass", ftype="cheby1",
                                                       rp=1.0),
    "iirfilter ellip bandpass": lambda m: m.iirfilter(3, [0.2, 0.5], btype="bandpass",
                                                      ftype="ellip", rp=0.5, rs=40.0),
    "iirfilter cheby2 bandstop": lambda m: m.iirfilter(4, [0.2, 0.4], btype="bandstop",
                                                       ftype="cheby2", rs=30.0),
    "iirfilter bessel": lambda m: m.iirfilter(4, 0.25, ftype="bessel"),
    "iirdesign ellip": lambda m: m.iirdesign(0.1, 0.15, 0.5, 60.0),
    "iirdesign cheby1 bandpass": lambda m: m.iirdesign([0.2, 0.5], [0.1, 0.6], 1.0, 40.0,
                                                       ftype="cheby1"),
    "iirdesign butter highpass": lambda m: m.iirdesign(0.3, 0.2, 1.0, 30.0, ftype="butter"),
    "iirdesign cheby2 bandstop": lambda m: m.iirdesign([0.1, 0.6], [0.2, 0.5], 1.0, 40.0,
                                                       ftype="cheby2"),
    "design_elliptic": lambda m: m.design_elliptic(4, 0.5, 40.0, 0.3),
    "design_bessel": lambda m: m.design_bessel(5, 0.2),
    "design_bessel mag bandpass": lambda m: m.design_bessel(4, [0.2, 0.4], btype="bandpass",
                                                           norm="mag"),
    "zpk2sos": lambda m: m.zpk2sos(*ZPK),
    "butter_zpk_proto": lambda m: m.butter_zpk_proto(5),
    "buttord lowpass": lambda m: m.buttord(0.2, 0.3, 1.0, 40.0),
    "cheb1ord highpass": lambda m: m.cheb1ord(0.3, 0.2, 1.0, 40.0),
    "cheb2ord bandpass": lambda m: m.cheb2ord([0.2, 0.5], [0.1, 0.6], 1.0, 40.0),
    "ellipord bandstop": lambda m: m.ellipord([0.1, 0.6], [0.2, 0.5], 1.0, 40.0),
    "iirnotch": lambda m: m.iirnotch(0.3, 30.0),
    "iirpeak": lambda m: m.iirpeak(0.3, 30.0),
    "iircomb notch": lambda m: m.iircomb(0.1, 30.0),
    "iircomb peak": lambda m: m.iircomb(0.1, 30.0, ftype="peak", pass_zero=True),
    "gammatone fir": lambda m: m.gammatone(0.2, "fir"),
    "gammatone iir": lambda m: m.gammatone(1000.0, "iir", fs=16000.0),
    "tf2zpk": lambda m: m.tf2zpk(B, A),
    "zpk2tf": lambda m: m.zpk2tf(*ZPK),
    "sos2tf": lambda m: m.sos2tf(sps.butter(4, 0.2, output="sos")),
    "sos2zpk": lambda m: m.sos2zpk(sps.butter(4, 0.2, output="sos")),
    "normalize": lambda m: m.normalize([2.0, 1.0], [4.0, 2.0, 1.0]),
    "bilinear": lambda m: m.bilinear(AB, AA, fs=3.0),
    "buttap": lambda m: m.buttap(4),
    "cheb1ap": lambda m: m.cheb1ap(4, 1.0),
    "cheb2ap": lambda m: m.cheb2ap(4, 40.0),
    "ellipap": lambda m: m.ellipap(4, 1.0, 40.0),
    "besselap": lambda m: m.besselap(4),
    "besselap delay": lambda m: m.besselap(4, "delay"),
    "lp2lp_zpk": lambda m: m.lp2lp_zpk(*AZPK, wo=2.0),
    "lp2hp_zpk": lambda m: m.lp2hp_zpk(*AZPK, wo=2.0),
    "lp2bp_zpk": lambda m: m.lp2bp_zpk(*AZPK, wo=2.0, bw=0.5),
    "lp2bs_zpk": lambda m: m.lp2bs_zpk(*AZPK, wo=2.0, bw=0.5),
    "bilinear_zpk": lambda m: m.bilinear_zpk(*AZPK, fs=4.0),
    "lp2lp": lambda m: m.lp2lp(AB, AA, wo=2.0),
    "lp2hp": lambda m: m.lp2hp(AB, AA, wo=2.0),
    "lp2bp": lambda m: m.lp2bp(AB, AA, wo=2.0, bw=0.5),
    "lp2bs": lambda m: m.lp2bs(AB, AA, wo=2.0, bw=0.5),
    "tf2sos": lambda m: m.tf2sos(B, A),
    "freqz_sos": lambda m: m.freqz_sos(sps.butter(4, 0.2, output="sos"), worN=64),
    "findfreqs": lambda m: m.findfreqs(AB, AA, 20),
    "findfreqs zp": lambda m: m.findfreqs(AZPK[0], AZPK[1], 20, kind="zp"),
    "freqs": lambda m: m.freqs(AB, AA, 50),
    "freqs grid": lambda m: m.freqs(AB, AA, np.linspace(0.1, 3.0, 7)),
    "freqs_zpk": lambda m: m.freqs_zpk(*AZPK, worN=50),
}

REFUSALS = {
    "order 0": lambda m: m.iirfilter(0, 0.2),
    "ftype": lambda m: m.iirfilter(4, 0.2, ftype="chebby"),
    "cheby1 without rp": lambda m: m.iirfilter(4, 0.2, ftype="cheby1"),
    "ellip without rs": lambda m: m.iirfilter(4, 0.2, ftype="ellip", rp=1.0),
    "Wn past Nyquist": lambda m: m.iirfilter(4, 1.2),
    "band order": lambda m: m.iirfilter(4, [0.5, 0.2], btype="bandpass"),
    "btype": lambda m: m.iirfilter(4, 0.2, btype="allpass"),
    "iirdesign ftype": lambda m: m.iirdesign(0.1, 0.2, 1.0, 40.0, ftype="bessel"),
    "bessel order": lambda m: m.design_bessel(40, 0.2),
    "bessel norm": lambda m: m.besselap(4, "width"),
    "notch frequency": lambda m: m.iirnotch(1.5, 30.0),
    "comb ftype": lambda m: m.iircomb(0.1, 30.0, ftype="band"),
    "gammatone ftype": lambda m: m.gammatone(0.2, "fft"),
    "tf2zpk a0": lambda m: m.tf2zpk([1.0], [0.0, 1.0]),
    "normalize a0": lambda m: m.normalize([1.0], [0.0, 1.0]),
    "findfreqs kind": lambda m: m.findfreqs(AB, AA, 20, kind="sos"),
}


def assert_same(got, want):
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g, w)
        return
    if isinstance(want, (int, np.integer)) and not isinstance(want, bool):
        assert got == want
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.shape == w.shape and g.dtype == w.dtype, (g.dtype, g.shape, w.dtype, w.shape)
    np.testing.assert_allclose(g, w, rtol=RTOL, atol=0.0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_design_matches_jax(name):
    assert_same(CASES[name](iir_design), CASES[name](jax_design))


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refusals_match_jax(name):
    with pytest.raises(Exception) as want:
        REFUSALS[name](jax_design)
    with pytest.raises(want.type) as got:
        REFUSALS[name](iir_design)
    assert str(got.value) == str(want.value)


def test_bad_coefficients_is_the_reference_warning_class():
    assert issubclass(iir_design.BadCoefficients, UserWarning)
    assert iir_design.BadCoefficients.__name__ == jax_design.BadCoefficients.__name__
    with pytest.warns(iir_design.BadCoefficients):
        import warnings

        warnings.warn("badly conditioned", iir_design.BadCoefficients)


def test_public_names_match_jax():
    public = {n for n in dir(jax_design) if not n.startswith("_") and n not in ("annotations", "np")}
    assert public <= set(dir(iir_design))
    assert iir_design.__all__ == jax_design.__all__


@pytest.mark.parametrize("order,rp", [(4, 1.0), (7, 0.5)])
@pytest.mark.parametrize("btype,cutoff", [("lowpass", 0.2), ("bandpass", (0.2, 0.45)),
                                          ("bandstop", (0.15, 0.5))])
def test_chebyshev_designers_go_through_iirfilter(order, rp, btype, cutoff):
    """``design_chebyshev1/2`` band types are iir_design.iirfilter, as in the reference."""
    from digital_signal_processsing_tpu.ops import iir as jax_iir

    np.testing.assert_array_equal(port_iir.design_chebyshev2(order, 40.0, cutoff, btype),
                                  jax_iir.design_chebyshev2(order, 40.0, cutoff, btype))
    np.testing.assert_array_equal(port_iir.design_chebyshev1(order, rp, cutoff, btype),
                                  jax_iir.design_chebyshev1(order, rp, cutoff, btype))
    if btype != "lowpass":
        np.testing.assert_array_equal(
            port_iir.design_chebyshev2(order, 40.0, cutoff, btype),
            iir_design.iirfilter(order, cutoff, btype=btype, ftype="cheby2", rs=40.0),
        )
